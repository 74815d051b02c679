"""``_target_`` instantiation onto the port's classes and factories.

The port's counterpart of ``dlsc_tpu/config/instantiate.py``: a
``_target_`` key names a dotted path, the other keys are keyword arguments,
nested nodes with their own ``_target_`` are instantiated first, and
``_partial_: true`` returns a ``functools.partial``. The table maps the
reference's targets (``src.models.*``, ``torch.optim.Adam``, ...) and the
JAX package's (``dlsc_tpu.*``, which ``configs/`` also names) onto
``dlsc_tpu_torch``. A ``dlsc_tpu.*`` target outside the table raises
``NotImplementedError`` and is never imported.
"""

from __future__ import annotations

import functools
import importlib
from typing import Any

from dlsc_tpu_torch.config.core import Config

_MODELS = "dlsc_tpu_torch.models."
_DATA = "dlsc_tpu_torch.data."
_OPTIM = "dlsc_tpu_torch.train.optim."
_LOSSES = "dlsc_tpu_torch.train.losses."
_HPO = "dlsc_tpu_torch.hpo."

# target → the port's target; each key also under its ``dlsc_tpu.*`` name
_PORTED: dict[str, str] = {
    "src.models.ast.ASTModel": _MODELS + "ast.ASTModel",
    "src.models.ast_small.ASTViTSmall": _MODELS + "ast_small.ASTViTSmall",
    "src.models.ast_mini.ASTMiniViT": _MODELS + "ast_mini.ASTMiniViT",
    "dlsc_tpu.models.ast.ASTModel": _MODELS + "ast.ASTModel",
    "dlsc_tpu.models.ast_small.ASTViTSmall": _MODELS + "ast_small.ASTViTSmall",
    "dlsc_tpu.models.ast_mini.ASTMiniViT": _MODELS + "ast_mini.ASTMiniViT",
    "dlsc_tpu.models.ast_moe.ASTMoE": _MODELS + "ast_moe.ASTMoE",
    "src.models.envnet_v2.EnvNetV2": _MODELS + "envnet_v2.EnvNetV2",
    "src.models.cnn_esc50.CNN_ESC50": _MODELS + "cnn_esc50.CNN_ESC50",
    "src.models.leaf.LeafModel": _MODELS + "leaf.LeafModel",
    "dlsc_tpu.models.envnet_v2.EnvNetV2": _MODELS + "envnet_v2.EnvNetV2",
    "dlsc_tpu.models.cnn_esc50.CNN_ESC50": _MODELS + "cnn_esc50.CNN_ESC50",
    "dlsc_tpu.models.leaf.LeafModel": _MODELS + "leaf.LeafModel",
    "src.datasets.esc50.ESC50DataModule": _DATA + "esc50.ESC50DataModule",
    "src.datasets.urbansound8k.UrbanSound8KDataModule": _DATA + "us8k.US8KDataModule",
    "dlsc_tpu.data.esc50.ESC50DataModule": _DATA + "esc50.ESC50DataModule",
    "dlsc_tpu.data.us8k.US8KDataModule": _DATA + "us8k.US8KDataModule",
    "torch.optim.Adam": _OPTIM + "adam",
    "torch.optim.AdamW": _OPTIM + "adamw",
    "torch.optim.SGD": _OPTIM + "sgd",
    "torch.optim.lr_scheduler.CosineAnnealingLR": _OPTIM + "cosine_annealing",
    "torch.optim.lr_scheduler.StepLR": _OPTIM + "step_lr",
    "torch.nn.CrossEntropyLoss": _LOSSES + "CrossEntropyLoss",
    "torch.nn.KLDivLoss": _LOSSES + "KLDivLoss",
    "optuna.samplers.TPESampler": _HPO + "tpe.TPESampler",
    "optuna.pruners.HyperbandPruner": _HPO + "hyperband.HyperbandPruner",
    "optuna.pruners.MedianPruner": _HPO + "pruners.MedianPruner",
    "dlsc_tpu.hpo.tpe.TPESampler": _HPO + "tpe.TPESampler",
    "dlsc_tpu.hpo.hyperband.HyperbandPruner": _HPO + "hyperband.HyperbandPruner",
    "dlsc_tpu.hpo.pruners.MedianPruner": _HPO + "pruners.MedianPruner",
}


def resolve_target(target: str) -> Any:
    """The port's object for ``target`` (after the table)."""
    target = _PORTED.get(target, target)
    if target.split(".")[0] == "dlsc_tpu":
        raise NotImplementedError(f"_target_ {target!r} names the JAX package and has no "
                                  "counterpart in dlsc_tpu_torch")
    module_name, _, attr = target.rpartition(".")
    if not module_name:
        raise ValueError(f"_target_ must be a dotted path, got {target!r}")
    mod = importlib.import_module(module_name)
    try:
        return getattr(mod, attr)
    except AttributeError as e:
        raise ImportError(f"{attr!r} not found in {module_name!r}") from e


def instantiate(cfg: Any, *args: Any, _recursive_: bool = True, **kwargs: Any) -> Any:
    """Instantiate an object from a ``_target_`` config node."""
    if isinstance(cfg, Config):
        cfg = cfg.to_dict()
    if not isinstance(cfg, dict):
        return cfg
    if "_target_" not in cfg:
        return {k: _maybe_instantiate(v) for k, v in cfg.items()} if _recursive_ else cfg
    cfg = dict(cfg)
    target = cfg.pop("_target_")
    partial = bool(cfg.pop("_partial_", False))
    cfg.pop("_recursive_", None)
    cfg.pop("_convert_", None)
    obj = resolve_target(target)
    call_kwargs = {k: _maybe_instantiate(v) if _recursive_ else v for k, v in cfg.items()}
    call_kwargs.update(kwargs)
    if partial:
        return functools.partial(obj, *args, **call_kwargs)
    return obj(*args, **call_kwargs)


def _maybe_instantiate(v: Any) -> Any:
    if isinstance(v, Config):
        v = v.to_dict()
    if isinstance(v, dict) and "_target_" in v:
        return instantiate(v)
    if isinstance(v, dict):
        return {k: _maybe_instantiate(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_maybe_instantiate(x) for x in v]
    return v
