"""Kernel K4: grouped matrix products over expert-sorted rows (``csrc/gmm.cu``).

Counterpart of ``dlsc_tpu/models/moe.py`` ``_grouped_matmul`` (:537-558)
and the megablox custom VJP it reaches on the TPU (``ops.py:22-109``). The
rows of ``lhs`` are sorted by group: group g owns ``group_sizes[g]``
consecutive rows, and ``group_sizes`` (E,) int32 sums to ``lhs.shape[0]``.
It lies on the tensors' device, and the kernels read it there: no wrapper
moves it to the host.

- ``gmm`` (K4a): out[rows of g] = lhs[rows of g] @ rhs[g], rhs (E, k, n),
  or @ rhs[g]^T with rhs (E, n, k) when ``transpose_rhs``; out in lhs's
  dtype, f32 sums.
- ``tgmm`` (K4b): out[g] = lhs[rows of g]^T @ grad[rows of g], (E, k, n);
  an empty group gives zeros.

Both launch their kernel for CUDA tensors (bf16 or f32) and run their plain
version, ``gmm_reference`` / ``tgmm_reference``, for CPU tensors; they never
fall back from one to the other. ``grouped_matmul`` is the differentiable
op (``torch.library`` custom op ``dlsc_tpu_torch::gmm``): forward ``gmm``;
backward dlhs = ``gmm(grad, rhs, transpose_rhs=True)`` and drhs =
``tgmm(lhs, grad)``, as megablox computes them. Being an op, a
selective-checkpoint policy sees it (``models/vit.py`` recomputes it under
``attn_res``).
"""

from __future__ import annotations

import ctypes

import torch

from dlsc_tpu_torch import _kernels

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

launches = 0        # K4a gmm launches since the last reset (see reset_launches)
tgmm_launches = 0   # K4b tgmm launches


def reset_launches() -> None:
    global launches, tgmm_launches
    launches = 0
    tgmm_launches = 0


def _lib() -> ctypes.CDLL:
    lib = _kernels.load("gmm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dlsc_gmm.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.dlsc_gmm.restype = i
    lib.dlsc_tgmm.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.dlsc_tgmm.restype = i
    return lib


def _check_sizes(what: str, lhs: torch.Tensor, group_sizes: torch.Tensor,
                 n_groups: int | None = None) -> None:
    if lhs.ndim != 2:
        raise ValueError(f"{what}: lhs must be 2-D, got {tuple(lhs.shape)}")
    if n_groups is None and group_sizes.ndim == 1:
        n_groups = group_sizes.shape[0]
    if group_sizes.dtype != torch.int32 or tuple(group_sizes.shape) != (n_groups,):
        raise ValueError(f"{what}: group_sizes must be ({n_groups},) int32, got "
                         f"{tuple(group_sizes.shape)} {group_sizes.dtype}")
    if group_sizes.device != lhs.device:
        raise ValueError(f"{what}: group_sizes on {group_sizes.device}, lhs on {lhs.device}")


def _check_cpu_sum(what: str, lhs: torch.Tensor, group_sizes: torch.Tensor) -> None:
    if int(group_sizes.sum()) != lhs.shape[0] or bool((group_sizes < 0).any()):
        raise ValueError(f"{what}: group_sizes {group_sizes.tolist()} must be >= 0 and sum "
                         f"to lhs's {lhs.shape[0]} rows")


def _check_kernel_operands(what: str, *ts: torch.Tensor) -> None:
    """What the kernels take: bf16/f32 alike, one card, contiguous, 16-byte
    aligned; in bf16 the matrix widths are multiples of 8 (16-byte loads)."""
    if ts[0].device.type != "cuda" or any(t.device != ts[0].device for t in ts):
        raise ValueError(f"{what}: devices {[str(t.device) for t in ts]}")
    if ts[0].dtype not in _DTYPES or any(t.dtype != ts[0].dtype for t in ts):
        raise ValueError(f"{what}: the kernel takes bfloat16/float32 operands of one "
                         f"dtype, got {[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what}: operands must be contiguous")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{what}: operands must start on a 16-byte boundary")
    if ts[0].dtype == torch.bfloat16 and any(t.shape[-1] % 8 for t in ts):
        raise ValueError(f"{what}: bfloat16 widths must be multiples of 8, got "
                         f"{[tuple(t.shape) for t in ts]}")


def gmm_reference(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
                  transpose_rhs: bool = False) -> torch.Tensor:
    """Plain grouped product: one f32 matmul per group, the result in lhs's
    dtype; rows past ``group_sizes.sum()`` are 0. Reads the sizes on the
    host (a sync on the card: this is the oracle, not the path)."""
    n = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    parts, start = [], 0
    for g, size in enumerate(group_sizes.tolist()):
        w = rhs[g].float()
        parts.append(lhs[start:start + size].float() @ (w.T if transpose_rhs else w))
        start += size
    parts.append(lhs.new_zeros((lhs.shape[0] - start, n), dtype=torch.float32))
    return torch.cat(parts).to(lhs.dtype)


def tgmm_reference(lhs: torch.Tensor, grad: torch.Tensor,
                   group_sizes: torch.Tensor) -> torch.Tensor:
    """Plain per-group lhs[rows of g]^T @ grad[rows of g]: (E, k, n) in
    lhs's dtype from f32 products; an empty group gives zeros."""
    outs, start = [], 0
    for size in group_sizes.tolist():
        rows = slice(start, start + size)
        outs.append(lhs[rows].float().T @ grad[rows].float())
        start += size
    return torch.stack(outs).to(lhs.dtype)


def gmm(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
        transpose_rhs: bool = False) -> torch.Tensor:
    """Grouped product (M, k) x (E, k, n) → (M, n) (see the module docstring).

    CUDA tensors: kernel K4a. CPU tensors: ``gmm_reference``, after checking
    that the sizes sum to M.
    """
    _check_sizes("gmm", lhs, group_sizes, rhs.shape[0])
    k, n = (rhs.shape[2], rhs.shape[1]) if transpose_rhs else rhs.shape[1:]
    if rhs.ndim != 3 or k != lhs.shape[1]:
        raise ValueError(f"gmm: lhs {tuple(lhs.shape)} and rhs {tuple(rhs.shape)} "
                         f"(transpose_rhs={transpose_rhs}) do not chain")
    if lhs.device.type == "cpu":
        _check_cpu_sum("gmm", lhs, group_sizes)
        return gmm_reference(lhs, rhs, group_sizes, transpose_rhs)
    _check_kernel_operands("gmm", lhs, rhs)
    group_sizes = group_sizes.contiguous()
    M, E = lhs.shape[0], rhs.shape[0]
    out = torch.empty((M, n), dtype=lhs.dtype, device=lhs.device)
    lib = _lib()
    with torch.cuda.device(lhs.device):
        err = lib.dlsc_gmm(lhs.data_ptr(), rhs.data_ptr(), group_sizes.data_ptr(),
                           out.data_ptr(), M, k, n, E, int(transpose_rhs), _DTYPES[lhs.dtype],
                           torch.cuda.current_stream().cuda_stream)
    _kernels.check(lib, err, "grouped matmul kernel")
    global launches
    launches += 1
    return out


def tgmm(lhs: torch.Tensor, grad: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """Per-group transposed product (M, k), (M, n) → (E, k, n) (see the module
    docstring). CUDA tensors: kernel K4b. CPU tensors: ``tgmm_reference``."""
    _check_sizes("tgmm", lhs, group_sizes)
    if grad.ndim != 2 or grad.shape[0] != lhs.shape[0]:
        raise ValueError(f"tgmm: lhs {tuple(lhs.shape)} and grad {tuple(grad.shape)} "
                         "must have the same rows")
    if lhs.device.type == "cpu":
        _check_cpu_sum("tgmm", lhs, group_sizes)
        return tgmm_reference(lhs, grad, group_sizes)
    _check_kernel_operands("tgmm", lhs, grad)
    group_sizes = group_sizes.contiguous()
    (M, k), n, E = lhs.shape, grad.shape[1], group_sizes.shape[0]
    out = torch.empty((E, k, n), dtype=lhs.dtype, device=lhs.device)
    lib = _lib()
    with torch.cuda.device(lhs.device):
        err = lib.dlsc_tgmm(lhs.data_ptr(), grad.data_ptr(), group_sizes.data_ptr(),
                            out.data_ptr(), M, k, n, E, _DTYPES[lhs.dtype],
                            torch.cuda.current_stream().cuda_stream)
    _kernels.check(lib, err, "grouped transposed matmul kernel")
    global tgmm_launches
    tgmm_launches += 1
    return out


@torch.library.custom_op("dlsc_tpu_torch::gmm", mutates_args=())
def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor,
                   group_sizes: torch.Tensor) -> torch.Tensor:
    """Differentiable grouped product ``gmm(lhs, rhs, group_sizes)``; its
    backward is K4a with the transposed rhs (dlhs) and K4b (drhs)."""
    return gmm(lhs, rhs, group_sizes)


@grouped_matmul.register_fake
def _(lhs, rhs, group_sizes):
    return lhs.new_empty((lhs.shape[0], rhs.shape[2]))


def _setup_context(ctx, inputs, output) -> None:
    ctx.save_for_backward(*inputs)


def _backward(ctx, grad):
    lhs, rhs, group_sizes = ctx.saved_tensors
    grad = grad.contiguous()
    dlhs = gmm(grad, rhs, group_sizes, transpose_rhs=True) if ctx.needs_input_grad[0] else None
    drhs = tgmm(lhs, grad, group_sizes).to(rhs.dtype) if ctx.needs_input_grad[1] else None
    return dlhs, drhs, None


grouped_matmul.register_autograd(_backward, setup_context=_setup_context)
