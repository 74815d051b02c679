"""Driver of ``kind: serve`` traffic: an open loop of single-clip requests
into the port's ``server.MicroBatcher`` over an artifact exported with
``serving.export_model`` and loaded with ``serving.load_exported``, the path
``scripts/serve`` takes.

Set-up makes the weights from the seed, exports the model into the run's
``TMPDIR``, loads it, starts the batcher and warms it with ``warm_calls``
requests. The schedule (``inputs.arrivals``: round(rate · seconds) send
times, a Poisson process given its count) is fixed by the seed. A sender
process of its own (``loadgen.py``) writes each request's index when it is
due; in this process a thread reads them and hands each to one of
``clients`` handler threads, which submits the request to the batcher and
waits for its answer, as a server's request handlers do. A request's
latency runs from its due time until the answer is in its handler's hand,
so a stall delays the requests behind it too. A request unanswered
``late_s`` past the window's close has failed and counts as infinitely
late. The serve call that the batcher makes is wrapped here, to time it on
the host clock.

A traced run profiles the device's activity over the last
``profiled_seconds`` of the window; its host
numbers (batch fill, serve call time) come from the stretch before that.
Once every request is in, the reference computes each pool clip's
probabilities in f32 from the weights rounded to the served type, and every
answer is held to its clip's.
"""

from __future__ import annotations

import functools
import gc
import json
import os
import queue
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import checks, harness, inputs
from benchmark.drivers.train import port_model, port_pipeline
from benchmark.flops import token_counts
from benchmark.reference import features as feats
from benchmark.reference.vit import Reference

from dlsc_tpu_torch.server import MicroBatcher
from dlsc_tpu_torch.serving import export_model, load_exported

LOADGEN = Path(__file__).resolve().parents[1] / "loadgen.py"
START_S = 0.2   # from handing the sender its schedule to the window's start


def _sleep_until(t: float) -> None:
    left = t - time.monotonic()
    if left > 0:
        time.sleep(left)


def _gc_pause(pauses: list, state: dict, phase: str, info: dict) -> None:
    """A ``gc.callbacks`` entry: the length of each full collection."""
    if info["generation"] == 2:
        if phase == "start":
            state["t"] = time.monotonic()
        elif "t" in state:
            pauses.append(time.monotonic() - state.pop("t"))


def as_served(w: dict[str, torch.Tensor], dtype: str) -> dict[str, torch.Tensor]:
    """The seed's weights rounded to the type the configuration serves them
    in, held in f32: the reference computes in f32 from the weights a sound
    program of that type holds."""
    dt = getattr(torch, dtype)
    return {k: v.to(dt).float() for k, v in w.items()}


@torch.no_grad()
def reference_probs(cfg: dict, w: dict, pool: torch.Tensor, n_pad: int,
                    chunk: int = 16, prec: str = "f32") -> np.ndarray:
    """The reference's class probabilities of every pool clip: eval
    features, the model, softmax over its sigmoid outputs."""
    m = cfg["model"]
    ref = Reference(m, w, n_pad, prec)
    out = []
    for a in range(0, pool.shape[0], chunk):
        x = feats.features(pool[a:a + chunk], m["sample_rate"], cfg["pipeline"])
        out.append(torch.softmax(ref.forward(x, remat=False)[0], -1).cpu())
    return torch.cat(out).double().numpy()


def run(ctx) -> dict:
    cfg, tr, dev, seed = ctx.cell.config, ctx.cell.traffic, ctx.device, ctx.seed
    m = cfg["model"]
    sr, B, P = m["sample_rate"], tr["batch"], tr["pool_clips"]
    T = int(cfg["clip_seconds"] * sr)
    _, n_pad = token_counts(m, T)

    # ---- set-up: export, load, batcher, warm calls --------------------------------
    model = port_model({**m, "remat": False, "dropout": 0.0}, dev)
    model.load_state_dict(inputs.weights(m, seed, dev))
    art = tempfile.mkdtemp(prefix="serve_artifact_", dir=os.environ.get("TMPDIR"))
    try:
        export_model(model, port_pipeline(cfg), art, batch=B, clip_samples=T)
        del model
        serve = load_exported(art, device=dev)
    finally:
        shutil.rmtree(art, ignore_errors=True)
    serve = ctx.hooks.get("serve", lambda s: s)(serve)
    calls: list[tuple[float, float]] = []   # (start, seconds) of each serve call

    def timed(waves):
        t = time.monotonic()
        out = serve(waves)
        calls.append((t, time.monotonic() - t))
        return out

    batcher = MicroBatcher(timed, B, window_ms=tr["window_ms"],
                           timeout_s=ctx.seconds + tr["late_s"])
    pool = inputs.clips(P, T, sr, seed, dev).cpu().numpy()
    for j in range(tr["warm_calls"]):
        batcher.submit(pool[j % P])
    due = inputs.arrivals(tr["rate_per_s"], ctx.seconds, seed)
    which = inputs.request_clips(len(due), P, seed)
    n = len(due)
    answers = np.full((n, m["num_classes"]), np.nan)
    done = np.full(n, np.inf)    # completion time, time.monotonic()
    sent = np.full(n, np.nan)
    jobs: queue.SimpleQueue = queue.SimpleQueue()   # request indices; -1 ends a handler
    errors: list[str] = []

    def handle() -> None:
        while (j := jobs.get()) >= 0:
            sent[j] = time.monotonic()
            try:
                answers[j] = batcher.submit(pool[which[j]])
                done[j] = time.monotonic()
            except Exception as e:  # noqa: BLE001 — a failed request counts as infinitely late
                errors.append(repr(e))

    handlers = [threading.Thread(target=handle, daemon=True) for _ in range(tr["clients"])]
    for h in handlers:
        h.start()
    sender = subprocess.Popen([sys.executable, str(LOADGEN)], stdin=subprocess.PIPE,
                              stdout=subprocess.PIPE)
    harness.sync(dev)
    setup_s = time.perf_counter() - ctx.t_start
    setup_peak = harness.peak_bytes(dev, reset=True)

    # ---- the window: the sender process writes each request's index when it is due;
    # a handler thread submits it to the batcher and waits for the answer ---------------
    def receive() -> None:
        for line in sender.stdout:
            jobs.put(int(line))

    pauses: list[float] = []   # the collector's full (generation 2) passes
    on_gc = functools.partial(_gc_pause, pauses, {})
    gc.callbacks.append(on_gc)
    marks, trace = {}, None
    try:
        t0 = time.monotonic() + START_S
        sender.stdin.write((json.dumps({"t0": t0, "due": due.tolist()}) + "\n").encode())
        sender.stdin.close()
        receiver = threading.Thread(target=receive, daemon=True)
        receiver.start()
        _sleep_until(t0)
        marks["b0"] = batcher.batches
        if ctx.trace:   # the profiler records the window's end
            _sleep_until(t0 + ctx.seconds - tr["profiled_seconds"])
            prof = harness.profiler()
            prof.start()
            marks["prof"], marks["b1"] = time.monotonic(), batcher.batches
        _sleep_until(t0 + ctx.seconds)
        if ctx.trace:
            harness.sync(dev)
            prof.stop()
            trace = harness.trace_of(prof, time.monotonic() - marks["prof"])
        sender.wait(timeout=tr["late_s"])
        receiver.join(timeout=tr["late_s"])
    finally:
        gc.callbacks.remove(on_gc)
        if sender.poll() is None:
            sender.kill()
        sender.wait()
        sender.stdout.close()
        for _ in handlers:
            jobs.put(-1)
    for h in handlers:   # each ends once the requests before its -1 are answered
        h.join(timeout=max(0.0, t0 + ctx.seconds + tr["late_s"] - time.monotonic()))
    peak = harness.peak_bytes(dev)
    lat = (done - (t0 + due)) * 1e3
    ok = np.isfinite(lat)
    failed = int(n - ok.sum())
    p95 = statistics.quantiles(lat[ok].tolist() + [1e12] * failed, n=20)[-1] if n > 1 else 1e12
    late = (sent - (t0 + due))[np.isfinite(sent)] * 1e3
    ctx.log(f"handler lateness ms: median {np.median(late)!r}, p99 "
            f"{np.quantile(late, 0.99)!r}, max {late.max()!r}; requests {n}, failed {failed}"
            + (f", first error {errors[0]}" if errors else "")
            + f"; full collections {len(pauses)}, longest {max(pauses, default=0.0) * 1e3!r} ms")

    end = marks.get("prof", t0 + ctx.seconds)
    before = [s for t, s in calls if t0 <= t < end]
    answered = int(((done >= t0) & (done < end)).sum())
    batches = marks.get("b1", batcher.batches) - marks["b0"]
    host = {"serve_call_ms": 1e3 * sum(before) / len(before) if before else None,
            "batch_fill": answered / (batches * B) if batches else None,
            "requests": n, "batches": batches}

    # ---- every answer against its clip's reference -------------------------------------
    del batcher, serve
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = reference_probs(cfg, as_served(inputs.weights(m, seed, dev), m["dtype"]),
                          inputs.clips(P, T, sr, seed, dev), n_pad)
    readings = checks.serve_readings(answers[ok], which[ok], ref) if ok.any() else \
        {k: float("inf") for k in ctx.cell.limits}
    correct, compared = checks.judge(readings, ctx.cell.limits)
    return {
        "correct": correct and failed == 0,
        "attempted": n,
        "failed": failed,
        "metrics": {"serve_p95_ms": p95, "peak_mem_gib": peak / 2**30, "setup_s": setup_s},
        "host": host,
        "trace": trace,
        "checks": compared,
        "memory_peak_bytes": max(peak, setup_peak),
        "log": {"p50_ms": float(np.median(lat)),
                "p95_ms_by_third": [float(np.quantile(part, 0.95))
                                    for part in np.array_split(lat, 3)],
                **host},
    }
