"""Kernel K2, forward: masked multi-head attention (``csrc/attn_fwd.cu``).

Counterpart of the forward of ``dlsc_tpu/ops/attn_fast.py``
(``make_fast_mha`` → ``fwd_kernel``), with the same contract: q, k, v are
(B, H, N, dh) with q already multiplied by the softmax scale; keys at
positions >= ``n_real`` are masked; query rows >= ``n_real`` produce finite
values that callers ignore. It also returns lse = logsumexp of the masked
scores (natural log, f32) for the backward.

``fast_mha_forward`` launches the CUDA kernel for CUDA tensors and takes
``mha_forward_reference`` for CPU tensors; it never falls back from one to
the other. The backward kernel comes with the training step.
"""

from __future__ import annotations

import ctypes

import torch

from dlsc_tpu_torch import _kernels

HEAD_DIM = 64   # the kernel's head width
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

launches = 0    # kernel launches since the last reset (see reset_launches)


def reset_launches() -> None:
    global launches
    launches = 0


def _lib() -> ctypes.CDLL:
    lib = _kernels.load("attn_fwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dlsc_attn_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.dlsc_attn_fwd.restype = i
    return lib


def mha_forward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          n_real: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain attention in f32: (out in q's dtype, lse f32)."""
    N = q.shape[-2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if n_real < N:
        s = s.masked_fill(torch.arange(N, device=q.device) >= n_real, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return torch.matmul(p, v.float()).to(q.dtype), lse


def fast_mha_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     n_real: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked attention forward: (B, H, N, dh) ×3 → (out (B, H, N, dh), lse (B, H, N)).

    CUDA tensors: kernel K2 (dh 64, bfloat16 or float32). CPU tensors:
    ``mha_forward_reference``.
    """
    if q.shape != k.shape or q.shape != v.shape or q.ndim != 4:
        raise ValueError(f"fast_mha_forward: q/k/v shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, N, dh = q.shape
    if not 1 <= n_real <= N:
        raise ValueError(f"fast_mha_forward: n_real {n_real} not in [1, {N}]")
    if q.device.type == "cpu":
        return mha_forward_reference(q, k, v, n_real)
    if q.device.type != "cuda" or {k.device, v.device} != {q.device}:
        raise ValueError(f"fast_mha_forward: devices {q.device}, {k.device}, "
                         f"{v.device}")
    if dh != HEAD_DIM or q.dtype not in _DTYPES or {k.dtype, v.dtype} != {q.dtype}:
        raise ValueError(f"fast_mha_forward: the kernel takes head_dim "
                         f"{HEAD_DIM} in bfloat16/float32, got {dh} {q.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("fast_mha_forward: q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):  # the kernel loads 16-byte vectors
        raise ValueError("fast_mha_forward: q, k, v must start on a 16-byte boundary")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.dlsc_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B * H, N, dh, n_real, _DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _kernels.check(lib, err, "attention forward kernel")
    global launches
    launches += 1
    return out, lse
