"""JAX (Flax) AST parameters → the port's ``state_dict``.

``params_from_jax`` takes the Flax parameter tree as nested dicts of numpy
arrays, in either block layout the JAX package writes:

- unrolled ``blocks_{i}`` (the ``ASTModel`` default);
- stacked ``blocks/block`` with a leading ``depth`` axis (``scan_blocks``).

The moves: conv kernel HWIO → OIHW; Dense kernel (in, out) → Linear weight
(out, in); LayerNorm ``scale`` → ``weight``. The qkv columns keep their
[q|k|v] order and the proj rows their concatenated-head order, which is
what the port's packed-qkv split and head merge expect. An MoE block's
``moe/router/kernel`` is a Dense kernel like any other; its stacked expert
tensors ``wi``, ``bi``, ``wo`` and ``bo`` keep their layout.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn


def _leaf(name: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    if name == "kernel":
        if value.ndim == 4:                   # conv HWIO → OIHW
            return "weight", value.transpose(3, 2, 0, 1)
        return "weight", value.T              # Dense (in, out) → (out, in)
    if name == "scale":
        return "weight", value
    return name, value


def _flatten(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def params_from_jax(params_np: Mapping[str, Any], model: nn.Module) -> dict[str, torch.Tensor]:
    """Map a Flax ``ASTViT`` parameter tree onto ``model``'s state_dict keys.

    ``params_np`` may be the ``params`` collection or the whole variables
    dict holding it. Raises unless every key and shape of ``model`` is
    matched exactly.
    """
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

    want = model.state_dict()
    if set(sd) != set(want):
        raise ValueError(
            "JAX params do not match the model: missing "
            f"{sorted(set(want) - set(sd))[:8]}, unexpected "
            f"{sorted(set(sd) - set(want))[:8]}")
    out = {}
    for k, ref in want.items():
        if tuple(sd[k].shape) != tuple(ref.shape):
            raise ValueError(f"{k}: JAX shape {sd[k].shape} vs model {tuple(ref.shape)}")
        out[k] = torch.tensor(sd[k], dtype=torch.float32)  # a copy, writable
    return out
