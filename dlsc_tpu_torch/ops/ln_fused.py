"""Kernel K3: fused residual add + LayerNorm, forward and backward
(``csrc/ln_fused.cu``).

Counterpart of ``dlsc_tpu/ops/ln_fused.py`` (``fused_add_ln``: the forward
``fwd_kernel``, the backward ``bwd_kernel`` and their custom VJP). Over the
last axis d of x and delta (same shape and dtype; gamma and beta (d,) f32):

- forward: r = x + delta, summed in f32 and stored in x's dtype; mu and
  rsig = 1/sqrt(var + eps) of that unrounded f32 sum; y = (r - mu) * rsig *
  gamma + beta in x's dtype. In bf16 this differs from the unfused
  ``x + delta`` → LayerNorm by the rounding of r, which the statistics skip.
- backward, from the stored r, mu, rsig and the gradients dr (the skip
  path's) and dy: dx = dr + rsig * (dy*gamma - mean(dy*gamma) - xhat *
  mean(dy*gamma*xhat)), xhat = (r - mu) * rsig, which is the gradient of
  both x and delta; dgamma = sum(dy * xhat), dbeta = sum(dy) over the rows.

d is a multiple of 8 up to 1024 (16-byte row chunks, a row in one warp's
registers); any other d raises ``ValueError`` on every device. Any row
count >= 1 (the JAX kernel's rows % 8 is a TPU sublane grain).

- ``fused_add_ln_forward`` / ``fused_add_ln_backward`` launch the CUDA
  kernels for CUDA tensors and run ``add_ln_reference`` /
  ``add_ln_backward_reference`` for CPU tensors; they never fall back from
  one to the other.
- ``add_ln`` is the differentiable op (``torch.library`` custom op
  ``dlsc_tpu_torch::add_ln``): (r, y, mu, rsig), forward K3f, backward K3b;
  mu and rsig take no gradient. Being an op, a selective-checkpoint policy
  sees it as one call: remat ``attn_res`` does not keep its outputs, so a
  rematerialised block runs K3f again, as the JAX policy reruns the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from dlsc_tpu_torch import _kernels

EPS = 1e-6          # the LayerNorm epsilon of the ViT blocks
MAX_D = 1024
BWD_MAX_BLOCKS = 512   # the backward's grid (and dgamma/dbeta partial rows) at most
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

launches = 0      # forward kernel launches since the last reset (see reset_launches)
bwd_launches = 0  # backward kernel launches


def reset_launches() -> None:
    global launches, bwd_launches
    launches = 0
    bwd_launches = 0


def _lib() -> ctypes.CDLL:
    lib = _kernels.load("ln_fused")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dlsc_add_ln_fwd.argtypes = [p] * 8 + [i, i, f, i, p]
    lib.dlsc_add_ln_fwd.restype = i
    lib.dlsc_add_ln_bwd.argtypes = [p] * 9 + [i, i, i, i, p]
    lib.dlsc_add_ln_bwd.restype = i
    return lib


def _check_width(what: str, d: int) -> None:
    if d % 8 or not 8 <= d <= MAX_D:
        raise ValueError(f"{what}: the last axis must be a multiple of 8 up to {MAX_D}, got {d}")


def _check_params(what: str, x: torch.Tensor, weight: torch.Tensor) -> None:
    d = x.shape[-1]
    if weight.shape != (d,) or weight.dtype != torch.float32 or weight.device != x.device:
        raise ValueError(f"{what}: gamma/beta must be ({d},) float32 on {x.device}, got "
                         f"{tuple(weight.shape)} {weight.dtype} on {weight.device}")


def _check_kernel_operands(what: str, *ts: torch.Tensor) -> None:
    """What the CUDA kernels take: one card, contiguous, 16-byte aligned
    (they load 16-byte chunks), the row tensors in bf16/f32 alike."""
    if ts[0].device.type != "cuda" or any(t.device != ts[0].device for t in ts):
        raise ValueError(f"{what}: devices {[str(t.device) for t in ts]}")
    if ts[0].dtype not in _DTYPES or any(t.dtype != ts[0].dtype for t in ts):
        raise ValueError(f"{what}: the kernel takes bfloat16/float32 alike, got "
                         f"{[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what}: operands must be contiguous")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{what}: operands must start on a 16-byte boundary")


def add_ln_reference(x: torch.Tensor, delta: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Plain add + LayerNorm in f32 with the kernel's rounding points:
    (r, y in x's dtype; mu, rsig f32 of shape x.shape[:-1])."""
    rf = x.float() + delta.float()
    mu = rf.mean(-1)
    c = rf - mu[..., None]
    rsig = torch.rsqrt((c * c).mean(-1) + EPS)
    y = c * rsig[..., None] * weight + bias
    return rf.to(x.dtype), y.to(x.dtype), mu, rsig


def add_ln_backward_reference(r: torch.Tensor, mu: torch.Tensor, rsig: torch.Tensor,
                              weight: torch.Tensor, dr: torch.Tensor, dy: torch.Tensor
                              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward in f32 with the TPU kernel's formulas (``ln_fused.py:96-107``),
    x̂ rebuilt from the stored r: (dx in r's dtype, dgamma, dbeta f32)."""
    xhat = (r.float() - mu[..., None]) * rsig[..., None]
    dyf = dy.float()
    dyg = dyf * weight
    m1 = dyg.mean(-1, keepdim=True)
    m2 = (dyg * xhat).mean(-1, keepdim=True)
    dx = dr.float() + rsig[..., None] * (dyg - m1 - xhat * m2)
    d = r.shape[-1]
    return (dx.to(r.dtype), (dyf * xhat).reshape(-1, d).sum(0),
            dyf.reshape(-1, d).sum(0))


def fused_add_ln_forward(x: torch.Tensor, delta: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """(x, delta (..., d); gamma, beta (d,) f32) → (r, y, mu, rsig).

    CUDA tensors: kernel K3f. CPU tensors: ``add_ln_reference``.
    """
    if x.shape != delta.shape or x.dtype != delta.dtype or x.ndim < 1:
        raise ValueError(f"fused_add_ln_forward: x {tuple(x.shape)} {x.dtype}, delta "
                         f"{tuple(delta.shape)} {delta.dtype}")
    d = x.shape[-1]
    _check_width("fused_add_ln_forward", d)
    _check_params("fused_add_ln_forward", x, weight)
    _check_params("fused_add_ln_forward", x, bias)
    if x.numel() == 0:
        raise ValueError("fused_add_ln_forward: no rows")
    if x.device.type == "cpu":
        return add_ln_reference(x, delta, weight, bias)
    x, delta = x.contiguous(), delta.contiguous()
    _check_kernel_operands("fused_add_ln_forward", x, delta)
    _check_kernel_operands("fused_add_ln_forward", weight, bias)   # both float32
    rows = x.numel() // d
    r, y = torch.empty_like(x), torch.empty_like(x)
    mu, rsig = (torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
                for _ in range(2))
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.dlsc_add_ln_fwd(
            x.data_ptr(), delta.data_ptr(), weight.data_ptr(), bias.data_ptr(), r.data_ptr(),
            y.data_ptr(), mu.data_ptr(), rsig.data_ptr(), rows, d, EPS, _DTYPES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    _kernels.check(lib, err, "add + LayerNorm forward kernel")
    global launches
    launches += 1
    return r, y, mu, rsig


def backward_blocks(rows: int) -> int:
    """The backward kernel's grid: 8 rows in flight per block, at most
    ``BWD_MAX_BLOCKS`` blocks, fixed by the row count alone."""
    return min(-(-rows // 8), BWD_MAX_BLOCKS)


def fused_add_ln_backward(r: torch.Tensor, mu: torch.Tensor, rsig: torch.Tensor,
                          weight: torch.Tensor, dr: torch.Tensor, dy: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(stored r (..., d), mu, rsig (...) f32, gamma (d,) f32, dr, dy (..., d))
    → (dx, dgamma, dbeta); dx is the gradient of both x and delta.

    CUDA tensors: kernel K3b, whose per-block dgamma/dbeta partials are
    summed here. CPU tensors: ``add_ln_backward_reference``. ``dr`` and
    ``dy`` may be strided: they are made contiguous here.
    """
    d = r.shape[-1]
    _check_width("fused_add_ln_backward", d)
    _check_params("fused_add_ln_backward", r, weight)
    if dr.shape != r.shape or dy.shape != r.shape or mu.shape != r.shape[:-1] \
            or rsig.shape != r.shape[:-1]:
        raise ValueError(f"fused_add_ln_backward: dr {tuple(dr.shape)}, dy {tuple(dy.shape)}, "
                         f"mu {tuple(mu.shape)}, rsig {tuple(rsig.shape)} for r "
                         f"{tuple(r.shape)}")
    if r.device.type == "cpu":
        return add_ln_backward_reference(r, mu, rsig, weight, dr, dy)
    dr, dy = dr.contiguous(), dy.contiguous()
    _check_kernel_operands("fused_add_ln_backward", r, dr, dy)
    _check_kernel_operands("fused_add_ln_backward", mu, rsig, weight)   # all float32
    rows = r.numel() // d
    n_blocks = backward_blocks(rows)
    dx = torch.empty_like(r)
    dg_part, db_part = (torch.empty((n_blocks, d), dtype=torch.float32, device=r.device)
                        for _ in range(2))
    lib = _lib()
    with torch.cuda.device(r.device):
        err = lib.dlsc_add_ln_bwd(
            r.data_ptr(), mu.data_ptr(), rsig.data_ptr(), weight.data_ptr(), dr.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), dg_part.data_ptr(), db_part.data_ptr(), rows, d,
            n_blocks, _DTYPES[r.dtype], torch.cuda.current_stream().cuda_stream)
    _kernels.check(lib, err, "add + LayerNorm backward kernel")
    global bwd_launches
    bwd_launches += 1
    return dx, dg_part.sum(0), db_part.sum(0)


@torch.library.custom_op("dlsc_tpu_torch::add_ln", mutates_args=())
def add_ln(x: torch.Tensor, delta: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Differentiable fused add + LayerNorm: (r, y, mu, rsig), as
    ``fused_add_ln_forward``; its backward is ``fused_add_ln_backward``."""
    return fused_add_ln_forward(x, delta, weight, bias)


@add_ln.register_fake
def _(x, delta, weight, bias):
    stats = x.new_empty(x.shape[:-1], dtype=torch.float32)
    return torch.empty_like(x), torch.empty_like(x), stats, torch.empty_like(stats)


def _setup_context(ctx, inputs, output) -> None:
    _, _, weight, _ = inputs
    r, _, mu, rsig = output
    ctx.save_for_backward(r, mu, rsig, weight)
    ctx.mark_non_differentiable(mu, rsig)


def _backward(ctx, dr, dy, _dmu, _drsig):
    r, mu, rsig, weight = ctx.saved_tensors
    dx, dgamma, dbeta = fused_add_ln_backward(r, mu, rsig, weight, dr, dy)
    return dx, dx, dgamma, dbeta


add_ln.register_autograd(_backward, setup_context=_setup_context)
