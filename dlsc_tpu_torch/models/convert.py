"""JAX (Flax) parameters and batch statistics → the port's ``state_dict``.

``params_from_jax`` takes the Flax variables as nested dicts of numpy
arrays. For the AST family the module paths are the port's own, in either
block layout the JAX package writes:

- unrolled ``blocks_{i}`` (the ``ASTModel`` default);
- stacked ``blocks/block`` with a leading ``depth`` axis (``scan_blocks``).

The CNN families (EnvNet-v2, the spectrogram CNN, LEAF) carry Flax's auto
names (``_ConvBNRelu_{i}/Conv_0``, ``Conv_{i}``, ``BatchNorm_{i}``,
``Dense_{i}``, ``GaborConv1d_0``, ``PCEN_0``), which each model maps onto
its own keys (``flax_names``), and a ``batch_stats`` collection beside
``params``: BatchNorm's ``mean`` and ``var`` become ``running_mean`` and
``running_var``; the JAX tree has no ``num_batches_tracked``, which keeps
the model's own value. Their trunks are flattened in NHWC order, as the JAX
models flatten them, so ``Dense_0`` needs no permutation.

The moves: conv kernel HWIO → OIHW, WIO → OIW; Dense kernel (in, out) →
Linear weight (out, in); LayerNorm and BatchNorm ``scale`` → ``weight``. The qkv columns keep their
[q|k|v] order and the proj rows their concatenated-head order, which is
what the port's packed-qkv split and head merge expect. An MoE block's
``moe/router/kernel`` is a Dense kernel like any other; its stacked expert
tensors ``wi``, ``bi``, ``wo`` and ``bo`` keep their layout.

``params_from_npz`` reads that tree from an ``.npz`` of the flattened
``params`` collection (keys joined by ``/``, e.g.
``blocks_0/attn/qkv/kernel``), the form in which a JAX-trained trunk
reaches the port (``scripts/export.py +params_npz=``, the Trainer's
``pretrained_path``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn


def _leaf(name: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    if name == "kernel":
        if value.ndim == 4:                   # conv HWIO → OIHW
            return "weight", value.transpose(3, 2, 0, 1)
        if value.ndim == 3:                   # conv WIO → OIW
            return "weight", value.transpose(2, 1, 0)
        return "weight", value.T              # Dense (in, out) → (out, in)
    if name == "scale":
        return "weight", value
    return name, value


def _named(tree: Mapping[str, Any], names: Mapping[str, str]) -> dict[str, np.ndarray]:
    """A CNN family's leaves under the model's ``flax_names``."""
    sd = {}
    for path, value in _flatten(tree):
        key = "/".join(path)
        if key not in names:
            raise ValueError(f"JAX variable {key!r} has no counterpart in the model")
        sd[names[key]] = _leaf(path[-1], value)[1]
    return sd


def _flatten(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def params_from_jax(params_np: Mapping[str, Any], model: nn.Module) -> dict[str, torch.Tensor]:
    """Map Flax variables onto ``model``'s state_dict keys, each in the
    model's dtype for that key.

    ``params_np`` may be the ``params`` collection or the whole variables
    dict holding it (and, for a model with BatchNorm, ``batch_stats``).
    Raises unless every key and shape of ``model`` is matched exactly, but
    for ``num_batches_tracked``, which the JAX tree lacks.
    """
    want = model.state_dict()
    if hasattr(model, "flax_names"):
        names = model.flax_names()
        sd = _named(params_np.get("params", params_np), names)
        sd.update(_named(params_np.get("batch_stats", {}), names))
        sd.update({k: v.numpy() for k, v in want.items() if k.endswith("num_batches_tracked")})
        return _checked(sd, want)
    tree = params_np.get("params", params_np)
    sd: dict[str, np.ndarray] = {}
    for path, value in _flatten(tree):
        *mods, name = path
        if mods[:2] == ["blocks", "block"]:   # stacked: (depth, ...) per leaf
            key, _ = _leaf(name, value[0])
            for i in range(value.shape[0]):
                sd[".".join(["blocks", str(i), *mods[2:], key])] = _leaf(name, value[i])[1]
            continue
        if mods and mods[0].startswith("blocks_"):
            mods = ["blocks", mods[0].removeprefix("blocks_"), *mods[1:]]
        key, value = _leaf(name, value)
        sd[".".join([*mods, key])] = value
    return _checked(sd, want)


def _checked(sd: dict[str, np.ndarray], want: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    if set(sd) != set(want):
        raise ValueError(
            "JAX params do not match the model: missing "
            f"{sorted(set(want) - set(sd))[:8]}, unexpected "
            f"{sorted(set(sd) - set(want))[:8]}")
    out = {}
    for k, ref in want.items():
        if tuple(sd[k].shape) != tuple(ref.shape):
            raise ValueError(f"{k}: JAX shape {sd[k].shape} vs model {tuple(ref.shape)}")
        out[k] = torch.tensor(sd[k], dtype=ref.dtype)  # a copy, writable
    return out


def unflatten(npz: Mapping[str, np.ndarray]) -> dict:
    """``{"a/b/c": x}`` → ``{"a": {"b": {"c": x}}}``."""
    tree: dict = {}
    for key in npz.keys():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = npz[key]
    return tree


def params_from_npz(path: str | Path, model: nn.Module) -> dict[str, torch.Tensor]:
    """``params_from_jax`` of the flattened Flax tree in ``path``: the
    ``params`` collection, or the variables with ``params/`` and
    ``batch_stats/`` keys (a model with BatchNorm needs the latter)."""
    with np.load(str(path)) as npz:
        return params_from_jax(unflatten(npz), model)
