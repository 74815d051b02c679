"""HTTP model server over an exported artifact of the port.

Counterpart of ``dlsc_tpu/server.py`` for ``dlsc_tpu_torch.serving``
artifacts: a stdlib ThreadingHTTPServer over a micro-batching queue.
Concurrent requests are coalesced into the artifact's batch (padded to it,
so the device always sees one shape) and answered from one device call.

Endpoints:
  GET  /healthz       → the artifact manifest (batch, clip_samples, ...)
  POST /predict       → body: WAV bytes (8/16/24/32-bit PCM; decoded via
                        dlsc_tpu_torch.data.wav, resampled + peak-normalized
                        like training prep)
                        → {"probs": [...], "top": [[class, p], ...]}
  POST /predict_raw   → JSON {"pcm": [floats], "sample_rate": int}
                        → same response

Run: ``python -m dlsc_tpu_torch.scripts.serve +artifact=<dir> [+port=8000]``.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

from dlsc_tpu_torch.data import wav as W
from dlsc_tpu_torch.serving import load_exported


class MicroBatcher:
    """Coalesce concurrent single-clip requests into fixed-size batches.

    ``submit`` blocks the calling (request-handler) thread until its row of
    probabilities is ready. The batcher thread greedily drains the queue up
    to ``batch`` items, waiting at most ``window_ms`` for stragglers after
    the first item arrives; a lone request therefore pays ≤ window_ms extra
    latency while a burst shares one device call. ``batches`` counts the
    device calls made.
    """

    def __init__(self, serve_fn, batch: int, window_ms: float = 5.0,
                 timeout_s: float = 600.0):
        # timeout_s covers the first request's kernel build too (seconds of
        # nvcc); steady-state requests take milliseconds.
        self._serve = serve_fn
        self.batch = int(batch)
        self.batches = 0
        self.window_s = float(window_ms) / 1e3
        self.timeout_s = float(timeout_s)
        self._q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, wave: np.ndarray) -> np.ndarray:
        ev = threading.Event()
        slot: dict = {}
        self._q.put((np.asarray(wave, np.float32), ev, slot))
        if not ev.wait(self.timeout_s):
            raise TimeoutError("inference timed out")
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["probs"]

    def _loop(self) -> None:
        while True:
            items = [self._q.get()]  # block for the first request
            deadline = time.monotonic() + self.window_s
            while len(items) < self.batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    items.append(self._q.get(timeout=left))
                except queue.Empty:
                    break
            waves = np.stack([w for w, _, _ in items])
            n = waves.shape[0]
            if n < self.batch:
                waves = np.pad(waves, ((0, self.batch - n), (0, 0)))
            try:
                self.batches += 1
                probs = np.asarray(self._serve(waves))[:n]
                for row, (_, ev, slot) in zip(probs, items):
                    slot["probs"] = row
                    ev.set()
            except Exception as e:  # noqa: BLE001 — fail the requests, not the loop
                for _, ev, slot in items:
                    slot["error"] = f"{type(e).__name__}: {e}"
                    ev.set()


def _prep_clip(pcm: np.ndarray, sr: int, target_sr: int,
               clip_samples: int) -> np.ndarray:
    """Mono → resample → peak-normalize → pad/trim: the same standardization
    the training prep applies (data/prepare.py), so served clips see the
    distribution the model trained on."""
    x = W.to_mono(np.asarray(pcm, np.float32))
    if sr != target_sr:
        x = W.resample(x, sr, target_sr)
    x = W.peak_normalize(x)
    return np.pad(x, (0, max(clip_samples - len(x), 0)))[:clip_samples]


class ModelServer:
    """Loaded artifact + batcher + HTTP plumbing (see module docstring)."""

    def __init__(self, artifact: str | Path, *, device: str = "cuda",
                 window_ms: float = 5.0, top_k: int = 5):
        self.serve = load_exported(artifact, device=device)
        self.manifest = dict(self.serve.manifest)
        self.top_k = int(top_k)
        self.sample_rate = int(self.manifest.get("sample_rate", 44_100))
        self.clip_samples = int(self.manifest["clip_samples"])
        self.batcher = MicroBatcher(self.serve, int(self.manifest["batch"]),
                                    window_ms=window_ms)
        # warm up (kernel build, allocator) so the first request doesn't pay it
        self.batcher.submit(np.zeros((self.clip_samples,), np.float32))

    # -- request bodies → probs ------------------------------------------------
    def predict_wav_bytes(self, body: bytes) -> np.ndarray:
        pcm, sr = W.read_wav(io.BytesIO(body))
        return self.batcher.submit(
            _prep_clip(pcm, sr, self.sample_rate, self.clip_samples))

    def predict_raw(self, body: bytes) -> np.ndarray:
        req = json.loads(body)
        pcm = np.asarray(req["pcm"], np.float32)
        sr = int(req.get("sample_rate", self.sample_rate))
        return self.batcher.submit(
            _prep_clip(pcm, sr, self.sample_rate, self.clip_samples))

    def response(self, probs: np.ndarray) -> dict:
        order = np.argsort(probs)[::-1][: self.top_k]
        return {
            "probs": [float(p) for p in probs],
            "top": [[int(i), float(probs[i])] for i in order],
        }

    # -- HTTP ------------------------------------------------------------------
    def make_http_server(self, host: str = "127.0.0.1",
                         port: int = 8000) -> ThreadingHTTPServer:
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet by default
                pass

            def _send(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {"status": "ok",
                                     "manifest": server.manifest})
                else:
                    self._send(404, {"error": "unknown path"})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                try:
                    if self.path == "/predict":
                        probs = server.predict_wav_bytes(body)
                    elif self.path == "/predict_raw":
                        probs = server.predict_raw(body)
                    else:
                        self._send(404, {"error": "unknown path"})
                        return
                except Exception as e:  # noqa: BLE001 — surface to the client
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})
                    return
                self._send(200, server.response(probs))

        return ThreadingHTTPServer((host, port), Handler)
