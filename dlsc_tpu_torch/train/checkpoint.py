"""Checkpoints with the reference's best-k policy, on ``torch.save``.

The port's counterpart of ``dlsc_tpu/train/checkpoint.py`` (Orbax there).
Lightning ``ModelCheckpoint`` semantics: monitor a metric (``val/acc`` by
default), keep the top k checkpoints, name them from a template
(``epoch-{epoch:02d}-val_acc-{val/acc:.3f}``), keep a ``last`` one on
request, and resume. A checkpoint is a directory holding

- ``state.pt``: ``{"model": state dict, "optimizer": state dict, "step":
  int, "generator": the torch.Generator's state}``, every tensor on the
  CPU, read back with ``torch.load(weights_only=True)``, so a resumed run
  continues the same draws;
- ``ckpt_meta.json``: ``{"epoch": e, <monitor>: value}``, which the resume
  of the best-k ledger and ``latest_checkpoint`` read.

Under several ranks (``TrainState.parallel``) a checkpoint is the same
full state dict, gathered from the ranks' shares by every rank and written
by rank 0 (``Layout.full_state``); a restore reads it on every rank and
puts each rank's share back (``Layout.load_state``), whatever the number
of ranks that wrote it. The other ranks wait at a barrier until the files
are on disk.

``save_params`` writes a weights-only directory (``params.pt``);
``load_params`` reads the model weights of either kind of directory, of a
``.pt`` file, or of an ``.npz`` of a flattened Flax ``params`` tree
(``models/convert.py``), which is how a JAX-trained trunk warm-starts a run.
"""

from __future__ import annotations

import json
import re
import shutil
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from dlsc_tpu_torch.models.convert import params_from_npz
from dlsc_tpu_torch.parallel.data import is_writer

STATE_FILE = "state.pt"
PARAMS_FILE = "params.pt"
META_FILE = "ckpt_meta.json"


def _sanitize(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", name)


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def plain_state_dict(state) -> dict:
    """The checkpoint dict of a state whose model is whole on this process."""
    return {"model": _to_cpu(state.model.state_dict()),
            "optimizer": _to_cpu(state.optimizer.state_dict()),
            "step": int(state.step),
            "generator": state.generator.get_state()}


def load_plain_state_dict(state, ck: dict) -> None:
    state.model.load_state_dict(ck["model"])
    state.optimizer.load_state_dict(ck["optimizer"])   # moves moments to the params' device
    state.step = int(ck["step"])
    state.generator.set_state(ck["generator"])


def _state_dict(state) -> dict | None:
    """The full checkpoint dict on the writing rank, None on the others."""
    if state.parallel is not None:
        return state.parallel.full_state(state)
    return plain_state_dict(state)


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


class CheckpointManager:
    def __init__(
        self,
        dirpath: str | Path,
        monitor: str = "val/acc",
        mode: str = "max",
        save_top_k: int = 1,
        filename: str | None = None,
        save_last: bool = False,
        resume: bool = False,
    ):
        self.dirpath = Path(dirpath).absolute()
        self.dirpath.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        # Lightning-style name template; None → the same pattern derived
        # from the monitored metric
        self.filename = filename
        # Lightning ModelCheckpoint(save_last=True): also overwrite a 'last'
        # checkpoint every validated epoch, the crash-resume anchor
        self.save_last = save_last
        self._saved: list[tuple[float, Path]] = []
        self.write_seconds: list[float] = []   # wall time of each checkpoint write
        if resume:
            # continue the best-k ledger across a resumed run: re-read every
            # on-disk checkpoint's ckpt_meta.json but 'last'
            for meta in sorted(self.dirpath.glob(f"*/{META_FILE}")):
                if meta.parent.name == "last":
                    continue
                try:
                    v = json.loads(meta.read_text()).get(self.monitor)
                except (OSError, json.JSONDecodeError):
                    continue
                if v is not None:
                    self._saved.append((float(v), meta.parent))
            self._saved.sort(key=lambda t: t[0], reverse=(self.mode == "max"))

    def _format_name(self, epoch: int, metrics: dict, value: float) -> str:
        if not self.filename:
            return f"epoch-{epoch:02d}-{self.monitor.replace('/', '_')}-{value:.3f}"

        # expand "{key}" / "{key:fmt}" where key is "epoch" or a metric name
        # (metric names may hold "/", which str.format cannot address)
        def repl(m: re.Match) -> str:
            key, fmt = m.group(1), m.group(2) or ""
            if key == "epoch":
                v: Any = epoch
            elif key in metrics:
                v = metrics[key]
            elif key == self.monitor:
                v = value
            else:
                return m.group(0)
            return format(v, fmt)

        return re.sub(r"\{([^{}:]+)(?::([^{}]*))?\}", repl, self.filename)

    def _write(self, path: Path, state, meta: dict) -> None:
        t0 = time.perf_counter()
        sd = _state_dict(state)   # every rank: gathering may take collectives
        if sd is not None:
            if path.exists():
                shutil.rmtree(path)
            path.mkdir(parents=True)
            torch.save(sd, path / STATE_FILE)
            (path / META_FILE).write_text(json.dumps(meta))
        _barrier()
        self.write_seconds.append(time.perf_counter() - t0)

    # -- save ----------------------------------------------------------------
    def save(self, state, epoch: int, metrics: dict) -> Path | None:
        if self.save_top_k == 0:  # checkpointing disabled (save_top_k: 0)
            return None
        value = float(metrics.get(self.monitor, float("nan")))
        if np.isnan(value):
            return None
        # Lightning semantics: save_top_k=-1 keeps every checkpoint
        better = (
            self.save_top_k < 0
            or len(self._saved) < self.save_top_k
            or (self.mode == "max" and value > min(v for v, _ in self._saved))
            or (self.mode == "min" and value < max(v for v, _ in self._saved))
        )
        if not better:
            return None
        path = self.dirpath / _sanitize(self._format_name(epoch, metrics, value))
        self._write(path, state, {"epoch": epoch, self.monitor: value})
        self._saved.append((value, path))
        self._saved.sort(key=lambda t: t[0], reverse=(self.mode == "max"))
        while self.save_top_k > 0 and len(self._saved) > self.save_top_k:
            _, worst = self._saved.pop()
            if is_writer():
                shutil.rmtree(worst, ignore_errors=True)
        return path

    def save_last_ckpt(self, state, epoch: int, metrics: dict) -> Path:
        """Overwrite the ``last`` checkpoint: always the newest state, whatever
        the monitored metric; what ``auto_resume`` restores after a crash."""
        path = self.dirpath / "last"
        meta: dict = {"epoch": epoch}
        if metrics.get(self.monitor) is not None:
            meta[self.monitor] = float(metrics[self.monitor])
        self._write(path, state, meta)
        return path

    @property
    def best_path(self) -> Path | None:
        return self._saved[0][1] if self._saved else None

    @property
    def best_value(self) -> float | None:
        return self._saved[0][0] if self._saved else None


def restore_state(path: str | Path, state):
    """Load a checkpoint directory into ``state`` in place (weights,
    optimizer moments, step, generator) and return it."""
    ck = torch.load(Path(path) / STATE_FILE, map_location="cpu", weights_only=True)
    if state.parallel is not None:
        state.parallel.load_state(state, ck)
    else:
        load_plain_state_dict(state, ck)
    return state


def latest_checkpoint(dirpath: str | Path) -> Path | None:
    """Newest checkpoint under ``dirpath`` by saved epoch (``ckpt_meta.json``),
    for ``auto_resume``. A ``last`` checkpoint at the same epoch wins the
    tie, so a resume takes the true latest state over the same epoch's best-k
    snapshot."""
    best, best_key = None, (-1, 0)
    for meta in Path(dirpath).glob(f"*/{META_FILE}"):
        try:
            epoch = int(json.loads(meta.read_text()).get("epoch", -1))
        except (OSError, json.JSONDecodeError, TypeError, ValueError):
            continue
        key = (epoch, 1 if meta.parent.name == "last" else 0)
        if key > best_key:
            best_key, best = key, meta.parent
    return best


def save_params(path: str | Path, model: nn.Module, meta: dict | None = None) -> Path:
    """Save a weights-only directory (a pretrained-weight artifact)."""
    path = Path(path).absolute()
    if path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    torch.save({"model": _to_cpu(model.state_dict())}, path / PARAMS_FILE)
    if meta is not None:
        (path / META_FILE).write_text(json.dumps(meta))
    return path


def load_params(path: str | Path, model: nn.Module) -> dict[str, torch.Tensor]:
    """``model``'s state dict from ``path``: a checkpoint or ``save_params``
    directory, a ``.pt`` file of either's contents, or an ``.npz`` of a
    flattened Flax ``params`` tree. For ``+pretrained_path=``: weights only,
    the optimizer starts fresh."""
    path = Path(path)
    if path.suffix == ".npz":
        return params_from_npz(path, model)
    if path.is_dir():
        path = path / (STATE_FILE if (path / STATE_FILE).exists() else PARAMS_FILE)
    return torch.load(path, map_location="cpu", weights_only=True)["model"]
