"""Int8 post-training quantisation for the serving path.

Counterpart of ``dlsc_tpu/ops/quant.py`` (:41-130). Two modes, both built
from the trained float weights with no calibration data:

- ``'w8a8'``: int8 weights and dynamic int8 activations, one scale per row
  (token), computed inside the forward (``int8_dot``);
- ``'w8'``: int8 weights only, activations kept in the compute dtype
  (``w8_dot``).

Weights are symmetric per output channel: ``scale_c = max |W_c| / 127``
(at least 1e-12 / 127), ``W_q = clip(round(W / scale_c), -127, 127)`` with
round half to even, as ``jnp.round``. The port keeps ``torch.nn.Linear``'s
layout, so a weight is (out, in) and the scale is per row, where the JAX
kernel is (in, out) and its scale per column; the values are the same. qkv's
rows stay in [q|k|v] order and proj's columns in concatenated-head order
(``models/vit.py``).

The JAX package computes these products with ``dot_general`` outside any
Pallas kernel, so the port does too: ``torch._int_mm`` (int8 × int8 →
int32) for ``w8a8`` and a float GEMM accumulating in f32 for ``w8``. On
CUDA, ``torch._int_mm`` takes a 2-D (M, K) row-major int8 lhs with M > 16
and K a multiple of 8, and an (K, N) rhs with N a multiple of 8; the
weight's transpose, a column-major view, is what it is given. A shape it
refuses raises; there is no float fallback. AST's products have at least
1664 rows at batch 1 and widths that are multiples of 64.
"""

from __future__ import annotations

import torch
from torch import nn

QUANT_MODES = ("w8a8", "w8")


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantisation of a Linear weight
    (out, in). Returns (``w_q`` int8 (out, in), ``scale`` f32 (out,)),
    ``w ≈ w_q * scale[:, None]``."""
    w = w.float()
    scale = w.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) / 127.0
    w_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return w_q, scale.squeeze(1)


def quantize_act(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-row int8 quantisation over the last axis.
    Returns (``x_q`` int8, ``scale`` f32 of shape ``x.shape[:-1] + (1,)``)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 127.0
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def w8_dot(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
           out_dtype: torch.dtype) -> torch.Tensor:
    """``x @ dequant(w_q).T`` for weight-only int8: ``x`` (..., K) in
    ``out_dtype``, ``w_q`` (N, K) int8 cast to ``out_dtype``, the products
    accumulated in f32, scaled per output channel in f32, then cast to
    ``out_dtype``. On CUDA a 16-bit product is one GEMM with an f32 output
    (``torch.mm(..., out_dtype=torch.float32)``); elsewhere the operands,
    exact in f32, are multiplied in f32."""
    K, N = x.shape[-1], w_q.shape[0]
    x2 = x.reshape(-1, K).to(out_dtype)
    w = w_q.to(out_dtype)
    if x2.is_cuda and out_dtype != torch.float32:
        acc = torch.mm(x2, w.t(), out_dtype=torch.float32)
    else:
        acc = torch.mm(x2.float(), w.float().t())
    return (acc * w_scale).to(out_dtype).reshape(*x.shape[:-1], N)


def int8_dot(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
             out_dtype: torch.dtype) -> torch.Tensor:
    """``x @ dequant(w_q).T`` as an int8 × int8 → int32 product: ``x`` (...,
    K) quantised per row (``quantize_act``), ``w_q`` (N, K) int8, the int32
    accumulator rescaled by the row scale and then the channel scale in
    f32, as ``dlsc_tpu/ops/quant.py:int8_dot``, and cast to ``out_dtype``."""
    K, N = x.shape[-1], w_q.shape[0]
    x_q, s = quantize_act(x.reshape(-1, K))
    acc = torch._int_mm(x_q, w_q.t())
    return (acc.float() * s * w_scale).to(out_dtype).reshape(*x.shape[:-1], N)


@torch.no_grad()
def materialize(model: nn.Module) -> nn.Module:
    """Fill every int8 buffer pair (``weight_q``, ``weight_scale``) of
    ``model`` from its layer's float weight, in place, and return ``model``.
    Raises if the model has none (it was not built with a ``quant`` mode)."""
    n = 0
    for m in model.modules():
        if isinstance(m, nn.Linear) and hasattr(m, "weight_q"):
            w_q, scale = quantize_weight(m.weight)
            m.weight_q.copy_(w_q)
            m.weight_scale.copy_(scale)
            n += 1
    if not n:
        raise ValueError(f"{type(model).__name__} has no int8 buffers: build it with "
                         f"quant in {QUANT_MODES}")
    return model
