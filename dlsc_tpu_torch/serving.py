"""Serving: the inference function, the artifact export and its loader.

Counterpart of ``dlsc_tpu/serving.py``. The JAX artifact is StableHLO plus
an Orbax checkpoint; the port's artifact is a directory with

- ``manifest.json``: the JAX manifest's keys (batch, clip_samples,
  platforms, num_classes, pipeline_mode, mesh) plus ``model_class``,
  ``model_kwargs`` and ``pipeline_kwargs``, enough to rebuild the module and
  the pipeline;
- ``state_dict.pt``: the model's state dict, floating-point entries in
  float32 and the others (BatchNorm's ``num_batches_tracked``) in their own
  dtype.

    serve = load_exported("exports/ast", device="cuda")
    probs = serve(wave)          # (B, clip_samples) → (B, C) numpy f32
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from dlsc_tpu_torch.data.pipeline import DevicePipeline, PipelineConfig
from dlsc_tpu_torch.models.cnn_esc50 import CNN_ESC50
from dlsc_tpu_torch.models.envnet_v2 import EnvNetV2
from dlsc_tpu_torch.models.leaf import LeafModel
from dlsc_tpu_torch.models.vit import ASTViT

# model_class in a manifest → the module that rebuilds it from model_kwargs
MODEL_CLASSES = {cls.__name__: cls for cls in (ASTViT, EnvNetV2, CNN_ESC50, LeafModel)}


def make_infer(model: torch.nn.Module,
               pipe: DevicePipeline) -> Callable[[torch.Tensor], torch.Tensor]:
    """``infer(wave) -> probs``: eval pipeline → forward (the mean over the
    crops for a multi-crop pipeline) → softmax, on the waveform's device
    (which must be the model's)."""

    def infer(wave: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return torch.softmax(pipe.forward_eval(model, pipe.eval_batch(wave)), dim=-1)

    return infer


def export_model(model: torch.nn.Module, pipe: DevicePipeline, out_dir: str | Path, *,
                 batch: int = 8, clip_samples: int = 220_500,
                 meta: dict[str, Any] | None = None) -> Path:
    """Write the artifact directory for ``make_infer(model, pipe)``."""
    if type(model).__name__ not in MODEL_CLASSES:
        raise ValueError(f"export_model: {type(model).__name__} is not one of "
                         f"{sorted(MODEL_CLASSES)}, which an artifact can rebuild")
    out_dir = Path(out_dir).absolute()
    out_dir.mkdir(parents=True, exist_ok=True)
    state = {k: v.detach().to("cpu", torch.float32 if v.is_floating_point() else v.dtype)
             for k, v in model.state_dict().items()}
    torch.save(state, out_dir / "state_dict.pt")
    manifest = {
        "batch": int(batch),
        "clip_samples": int(clip_samples),
        "platforms": ["cuda", "cpu"],
        "num_classes": int(pipe.cfg.num_classes),
        "pipeline_mode": pipe.cfg.mode,
        "mesh": None,  # single-device program
        "sample_rate": int(pipe.cfg.sample_rate),
        "format": "dlsc_tpu_torch/state_dict",
        "model_class": type(model).__name__,
        "model_kwargs": dict(model.config),
        "pipeline_kwargs": dataclasses.asdict(pipe.cfg),
        **(meta or {}),
    }
    (out_dir / "manifest.json").write_text(json.dumps(manifest, indent=1))
    return out_dir


def load_exported(art_dir: str | Path, device: str | torch.device = "cuda") -> Callable:
    """Load an artifact into ``serve(wave) -> probs`` on ``device``.

    The weights move to the device once, here. ``device="cuda"`` on a host
    without a usable GPU raises; it never continues on the CPU.
    ``serve.manifest`` carries the export metadata.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"load_exported: device {device} requested but "
                           "torch.cuda.is_available() is False")
    art_dir = Path(art_dir).absolute()
    manifest = json.loads((art_dir / "manifest.json").read_text())
    model = MODEL_CLASSES[manifest.get("model_class", "ASTViT")](**manifest["model_kwargs"])
    model.load_state_dict(torch.load(art_dir / "state_dict.pt", map_location="cpu",
                                     weights_only=True))
    model.to(device)
    pipe = DevicePipeline(PipelineConfig(**manifest["pipeline_kwargs"]))
    infer = make_infer(model, pipe)

    def serve(wave) -> np.ndarray:
        x = torch.as_tensor(np.asarray(wave)).to(device)
        return infer(x).float().cpu().numpy()

    serve.manifest = manifest
    serve.model = model
    serve.pipe = pipe
    return serve
