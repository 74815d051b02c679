"""Classify audio files with the port, from a checkpoint or an exported artifact.

    python -m dlsc_tpu_torch.scripts.predict model=ast dataset.root=<shards> \
        +ckpt_path=<run>/checkpoints/epoch-... +files=[a.wav,b.wav] [+top_k=5]

    # deployment: an artifact of dlsc_tpu_torch.scripts.export, no config tree
    # or checkpoint involved
    python -m dlsc_tpu_torch.scripts.predict +artifact=exports/ast_torch \
        +files=[a.wav,b.wav] [+top_k=5]

The counterpart of ``scripts/predict.py``. Each WAV (any rate or channel
count) is standardized as the training data were, windowed to the training
clip length, run through the eval pipeline, the forward and a softmax, and
its top-k classes are printed with their probabilities. A file longer than
a clip is classified by half-overlapping windows whose probabilities are
averaged (``+long_audio=avg``, the default; ``+long_audio=truncate`` takes
the head window); a shorter one is zero-padded. The checkpoint mode takes
the clip length from the dataset's shards, the artifact mode from its
manifest. Both run on the device of ``trainer.accelerator`` (the GPU by
default; ``trainer.accelerator=cpu`` for the CPU).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from dlsc_tpu_torch.config import compose
from dlsc_tpu_torch.data import wav as W
from dlsc_tpu_torch.scripts import train as train_script
from dlsc_tpu_torch.serving import load_exported, make_infer
from dlsc_tpu_torch.train.checkpoint import restore_state
from dlsc_tpu_torch.train.loop import Trainer, build_from_cfg, resolve_device


def _print_results(files, probs, top_k: int) -> list[dict]:
    results = []
    for f, p in zip(files, probs):
        order = np.argsort(p)[::-1][:top_k]
        entry = {"file": str(f), "top_k": [(int(c), float(p[c])) for c in order]}
        results.append(entry)
        pretty = ", ".join(f"class {c}: {v:.3f}" for c, v in entry["top_k"])
        print(f"{f}: {pretty}")
    return results


def _windows(x: np.ndarray, clip_len: int, mode: str) -> list[np.ndarray]:
    """One standardized waveform → clip_len windows: 'avg', half-overlapping
    windows over the whole file, the last one right-aligned so that no tail
    is dropped; 'truncate', the head window. A short input zero-pads to one
    window either way."""
    if len(x) <= clip_len:
        return [np.pad(x, (0, clip_len - len(x)))]
    if mode == "truncate":
        return [x[:clip_len]]
    hop = max(clip_len // 2, 1)
    starts = list(range(0, len(x) - clip_len + 1, hop))
    if starts[-1] != len(x) - clip_len:
        starts.append(len(x) - clip_len)
    return [x[s:s + clip_len] for s in starts]


def _file_windows(files, sr: int, clip_len: int, mode: str) -> tuple[np.ndarray, list[int]]:
    """Standardize each file → (windows (W_total, clip_len) f32, windows per file)."""
    wins, counts = [], []
    for f in files:
        w = _windows(W.standardize(f, sr), clip_len, mode)
        wins.extend(w)
        counts.append(len(w))
    return np.stack(wins).astype(np.float32), counts


def _avg_by_file(win_probs: np.ndarray, counts: list[int]) -> np.ndarray:
    """Mean window probabilities per file."""
    out, i = [], 0
    for n in counts:
        out.append(win_probs[i:i + n].mean(axis=0))
        i += n
    return np.stack(out)


def predict_from_artifact(artifact: str, files: list, top_k: int, long_audio: str = "avg",
                          device: str | torch.device = "cuda") -> list[dict]:
    """Classify through an artifact of ``dlsc_tpu_torch.scripts.export``: the
    windows go through it in chunks of its batch, the last chunk padded."""
    serve = load_exported(artifact, device=device)
    man = serve.manifest
    batch, clip_len = int(man["batch"]), int(man["clip_samples"])
    sr = int(man.get("sample_rate", 44_100))
    wave, counts = _file_windows(files, sr, clip_len, long_audio)
    probs = []
    for i in range(0, wave.shape[0], batch):
        chunk = wave[i:i + batch]
        n = chunk.shape[0]
        if n < batch:
            chunk = np.pad(chunk, ((0, batch - n), (0, 0)))
        probs.append(np.asarray(serve(chunk))[:n])
    return _print_results(files, _avg_by_file(np.concatenate(probs), counts), top_k)


def main(argv: list[str] | None = None) -> list[dict]:
    config_path, config_name, overrides = train_script.parse_cli(
        list(argv if argv is not None else sys.argv[1:]))
    cfg = compose(config_path, config_name, overrides)
    files = cfg.select("files", default=None)
    ckpt = cfg.select("ckpt_path", default=None)
    artifact = cfg.select("artifact", default=None)
    if not files or not (ckpt or artifact):
        raise SystemExit("pass +files=[a.wav,...] and +ckpt_path=<dir> (or +artifact=<dir>)")
    top_k = int(cfg.select("top_k", default=5))
    long_audio = str(cfg.select("long_audio", default="avg"))
    if long_audio not in ("avg", "truncate"):
        raise SystemExit(f"long_audio={long_audio!r} must be avg|truncate")
    if artifact:
        device = resolve_device(cfg.select("trainer.accelerator", default="auto"))
        return predict_from_artifact(str(artifact), list(files), top_k, long_audio, device)

    datamodule = train_script.build_datamodule(cfg)
    built = build_from_cfg(cfg)
    trainer = Trainer(**cfg.trainer.to_dict(), enable_checkpointing=False)
    state = trainer.init_state(built["model"], datamodule, built["optim_spec"],
                               built["sched_spec"])
    restore_state(ckpt, state)
    sr = int(cfg.select("dataset.sample_rate", default=44_100))
    wave, counts = _file_windows(files, sr, datamodule.clip_samples, long_audio)
    infer = make_infer(state.model.eval(), datamodule.pipeline)
    win_probs = infer(torch.from_numpy(wave).to(trainer.device)).float().cpu().numpy()
    return _print_results(files, _avg_by_file(win_probs, counts), top_k)


if __name__ == "__main__":
    main()
