"""Kernel K2: masked multi-head attention, forward (``csrc/attn_fwd.cu``)
and backward (``csrc/attn_bwd.cu``).

Counterpart of ``dlsc_tpu/ops/attn_fast.py`` (``make_fast_mha``: the
forward ``fwd_kernel`` and the custom VJP's ``bwd_kernel``), with the same
contract: q, k, v are (B, H, N, dh) with q already multiplied by the softmax
scale; keys at positions >= ``n_real`` are masked; query rows >= ``n_real``
produce finite values that callers ignore. The forward also returns lse =
logsumexp of the masked scores (natural log, f32), which the backward reads
instead of recomputing the softmax's max and sum.

- ``fast_mha_forward`` / ``fast_mha_backward`` launch the CUDA kernels for
  CUDA tensors and take ``mha_forward_reference`` /
  ``mha_backward_reference`` for CPU tensors; they never fall back from one
  to the other.
- ``fast_mha_lse`` is the differentiable attention: an ``autograd.Function``
  whose forward is the ``torch.library`` custom op ``dlsc_tpu_torch::mha``
  (K2f; residuals q, k, v, out, lse) and whose backward is the op
  ``dlsc_tpu_torch::mha_bwd`` (K2b). The forward being an op, a
  selective-checkpoint policy sees it and can keep its outputs so that a
  rematerialised block does not run the forward kernel again
  (``models/vit.py``, ``attn_res``). ``fast_mha`` returns its ``out`` alone.
- Under ``torch.func.vmap`` (the vmapped HPO step, ``hpo/vmapped.py``) both
  ops fold the trial axis into the batch: (K, B, H, N, dh) → (K·B, H, N,
  dh), one launch of K2f and one of K2b for every trial; ``n_real`` is
  shared by the trials.
"""

from __future__ import annotations

import ctypes

import torch

from dlsc_tpu_torch import _kernels
from dlsc_tpu_torch.ops.trials import aligned, trial_major

HEAD_DIM = 64   # the kernel's head width
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# K2b bf16 (csrc/attn_bwd.cu, which uses the same numbers): rows of a TMA tile
# and of a consumer warpgroup, rows a CTA owns (2 consumer warpgroups and a
# producer warp), slots of the ring of streamed tiles; a block's shared memory
# (H100: 227 KB)
BWD_TILE, BWD_BLOCK, BWD_STAGES, BWD_THREADS = 64, 128, 3, 288
# K2f bf16 (csrc/attn_fwd.cu): the same tiles, CTA and threads; its K/V ring
FWD_TILE, FWD_BLOCK, FWD_STAGES, FWD_THREADS = 64, 128, 4, 288
SMEM_LIMIT = 232_448

launches = 0      # forward kernel launches since the last reset (see reset_launches)
bwd_launches = 0  # backward kernel launches (one per call: the dQ and dK/dV pair)


def reset_launches() -> None:
    global launches, bwd_launches
    launches = 0
    bwd_launches = 0


def _lib() -> ctypes.CDLL:
    lib = _kernels.load("attn_fwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dlsc_attn_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.dlsc_attn_fwd.restype = i
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _kernels.load("attn_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dlsc_attn_bwd.argtypes = [p] * 10 + [i] * 5 + [p]
    lib.dlsc_attn_bwd.restype = i
    return lib


def _check_qkv(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               n_real: int) -> None:
    if q.shape != k.shape or q.shape != v.shape or q.ndim != 4:
        raise ValueError(f"{what}: q/k/v shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not 1 <= n_real <= q.shape[2]:
        raise ValueError(f"{what}: n_real {n_real} not in [1, {q.shape[2]}]")


def _check_kernel_operands(what: str, q: torch.Tensor, *others: torch.Tensor) -> None:
    """What the CUDA kernels take: dh 64, bf16/f32 alike, one card,
    contiguous, 16-byte aligned (they load 16-byte vectors)."""
    ts = (q, *others)
    if q.device.type != "cuda" or any(t.device != q.device for t in ts):
        raise ValueError(f"{what}: devices {[str(t.device) for t in ts]}")
    if q.shape[-1] != HEAD_DIM or q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in ts):
        raise ValueError(f"{what}: the kernel takes head_dim {HEAD_DIM} in "
                         f"bfloat16/float32, got {q.shape[-1]} {[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what}: operands must be contiguous")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{what}: operands must start on a 16-byte boundary")


def mha_forward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          n_real: int, round_p: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain attention in f32: (out in q's dtype, lse f32).

    ``round_p`` rounds where the TPU forward rounds (``dlsc_tpu/ops/
    attn_fast.py:147-154``): P = exp(S - max) is cast to q's dtype before
    P·V, and the f32 product is divided by the f32 row sum of the unrounded
    P. Off (the default), P is normalised in f32 and never rounded."""
    N = q.shape[-2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if n_real < N:
        s = s.masked_fill(torch.arange(N, device=q.device) >= n_real, float("-inf"))
    if round_p:
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        out = torch.matmul(p.to(q.dtype).float(), v.float()) / l
        return out.to(q.dtype), (m + torch.log(l))[..., 0]
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return torch.matmul(p, v.float()).to(q.dtype), lse


def fast_mha_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     n_real: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked attention forward: (B, H, N, dh) ×3 → (out (B, H, N, dh), lse (B, H, N)).

    CUDA tensors: kernel K2f (dh 64, bfloat16 or float32; bf16 by wgmma on
    TMA-fed tiles, see ``_fwd_plan``). CPU tensors: ``mha_forward_reference``.
    """
    _check_qkv("fast_mha_forward", q, k, v, n_real)
    B, H, N, dh = q.shape
    if q.device.type == "cpu":
        return mha_forward_reference(q, k, v, n_real)
    _check_kernel_operands("fast_mha_forward", q, k, v)
    if q.dtype == torch.bfloat16:
        plan = _fwd_plan(B, H, N, n_real)
        if plan["smem"] > SMEM_LIMIT:
            raise ValueError(f"fast_mha_forward: shared memory {plan} over {SMEM_LIMIT}")
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


def _fwd_plan(B: int, H: int, N: int, n_real: int) -> dict:
    """The launch of K2f's bf16 kernel (``csrc/attn_fwd.cu`` computes the
    same by the same formulas): a grid of (N / 128 rounded up, B*H) CTAs of
    ``FWD_THREADS`` threads, each loading its 128 query rows once and
    streaming the ``key_tiles`` 64-key tiles below n_real (K and V) through a
    ring of ``stages`` slots. ``smem``: dynamic shared memory in bytes (1024
    of alignment slack, the Q tile, the ring, the mbarriers)."""
    tile_bytes = FWD_TILE * HEAD_DIM * 2
    return dict(
        threads=FWD_THREADS,
        grid=(-(-N // FWD_BLOCK), B * H),
        key_tiles=-(-n_real // FWD_TILE),
        stages=FWD_STAGES,
        smem=(1024 + FWD_BLOCK * HEAD_DIM * 2 + FWD_STAGES * 2 * tile_bytes
              + (1 + 2 * FWD_STAGES) * 8),
    )


def _bwd_plan(B: int, H: int, N: int, n_real: int) -> dict:
    """The launch of K2b's bf16 kernels (``csrc/attn_bwd.cu`` computes the
    same by the same formulas): both grids are (N / 128 rounded up, B*H) CTAs
    of ``BWD_THREADS`` threads; the dQ kernel streams the key tiles below
    n_real (``dq_key_tiles``), the dK/dV kernel every query tile
    (``dkv_query_tiles``), and ``dkv_zero_ctas`` of its CTAs hold keys that
    are all >= n_real, write zeros and load nothing. ``*_smem``: dynamic
    shared memory in bytes (1024 of alignment slack, the CTA's fixed tiles,
    the ring, D (dQ) or lse/D (dK/dV) rows, the mbarriers)."""
    blocks = -(-N // BWD_BLOCK)
    tile_bytes = BWD_TILE * HEAD_DIM * 2
    fixed = 1024 + 2 * BWD_BLOCK * HEAD_DIM * 2 + (1 + 2 * BWD_STAGES) * 8
    return dict(
        threads=BWD_THREADS,
        dq_grid=(blocks, B * H),
        dkv_grid=(blocks, B * H),
        dq_key_tiles=-(-n_real // BWD_TILE),
        dkv_query_tiles=-(-N // BWD_TILE),
        dkv_zero_ctas=(blocks - -(-n_real // BWD_BLOCK)) * B * H,
        dq_smem=fixed + BWD_STAGES * 2 * tile_bytes + BWD_BLOCK * 4,
        dkv_smem=fixed + BWD_STAGES * (2 * tile_bytes + 2 * BWD_TILE * 4),
    )


def mha_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                           n_real: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain attention backward in f32 with the TPU kernel's formulas
    (``attn_fast.py:219-251``): P = exp(S - lse); D = rowsum(dO*O);
    dS = P*(dP - D); dQ = dS K, dK = dS^T Q, dV = P^T dO. P and dS are
    rounded to the input type before their products, as there. Returns
    (dq, dk, dv) in q's dtype; dK and dV rows >= n_real are zero."""
    dt = q.dtype
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, out, do))
    N = q.shape[-2]
    s = torch.matmul(qf, kf.transpose(-1, -2))
    if n_real < N:
        s = s.masked_fill(torch.arange(N, device=q.device) >= n_real, float("-inf"))
    p = torch.exp(s - lse[..., None])
    d = (dof * of).sum(-1, keepdim=True)
    ds = (p * (torch.matmul(dof, vf.transpose(-1, -2)) - d)).to(dt).float()
    p = p.to(dt).float()
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dk[..., n_real:, :] = 0.0
    dv[..., n_real:, :] = 0.0
    return dq.to(dt), dk.to(dt), dv.to(dt)


def fast_mha_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                      n_real: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked attention backward from the forward's residuals: (q, k, v, out,
    dO (B, H, N, dh), lse (B, H, N) f32) → (dq, dk, dv) in the input type.

    CUDA tensors: kernel K2b (the dQ kernel, then the dK/dV kernel; bf16 by
    wgmma on TMA-fed tiles, see ``_bwd_plan``). CPU
    tensors: ``mha_backward_reference``. ``do`` may be strided: it is made
    contiguous here.
    """
    _check_qkv("fast_mha_backward", q, k, v, n_real)
    if out.shape != q.shape or do.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError(f"fast_mha_backward: out {tuple(out.shape)}, do "
                         f"{tuple(do.shape)}, lse {tuple(lse.shape)} for q {tuple(q.shape)}")
    if q.device.type == "cpu":
        return mha_backward_reference(q, k, v, out, lse, do, n_real)
    do = do.contiguous()
    _check_kernel_operands("fast_mha_backward", q, k, v, out, do)
    if lse.dtype != torch.float32 or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"fast_mha_backward: lse must be contiguous float32 on "
                         f"{q.device}, got {lse.dtype} on {lse.device}")
    B, H, N, dh = q.shape
    if q.dtype == torch.bfloat16:
        plan = _bwd_plan(B, H, N, n_real)
        if max(plan["dq_smem"], plan["dkv_smem"]) > SMEM_LIMIT:
            raise ValueError(f"fast_mha_backward: shared memory {plan} over {SMEM_LIMIT}")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        err = lib.dlsc_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B * H, N, dh, n_real, _DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _kernels.check(lib, err, "attention backward kernel")
    global bwd_launches
    bwd_launches += 1
    return dq, dk, dv


def _fold(*ts: torch.Tensor) -> list[torch.Tensor]:
    """(K, B, ...) → (K·B, ...): the trials as more batch rows."""
    return [aligned(t.reshape(-1, *t.shape[2:])) for t in ts]


@torch.library.custom_op("dlsc_tpu_torch::mha", mutates_args=())
def _mha_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            n_real: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward as an op: (out, lse), as ``fast_mha_forward``."""
    return fast_mha_forward(q, k, v, n_real)


@_mha_op.register_fake
def _(q, k, v, n_real):
    return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)


@_mha_op.register_vmap
def _(info, in_dims, q, k, v, n_real):
    K = info.batch_size
    q, k, v = trial_major(info, in_dims[:3], q, k, v)
    out, lse = _mha_op(*_fold(q, k, v), n_real)
    return (out.view(K, *q.shape[1:]), lse.view(K, *q.shape[1:4])), (0, 0)


@torch.library.custom_op("dlsc_tpu_torch::mha_bwd", mutates_args=())
def _mha_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                lse: torch.Tensor, do: torch.Tensor,
                n_real: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward as an op: (dq, dk, dv), as ``fast_mha_backward``."""
    return fast_mha_backward(q, k, v, out, lse, do, n_real)


@_mha_bwd_op.register_fake
def _(q, k, v, out, lse, do, n_real):
    return torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)


@_mha_bwd_op.register_vmap
def _(info, in_dims, q, k, v, out, lse, do, n_real):
    K = info.batch_size
    ts = trial_major(info, in_dims[:6], q, k, v, out, lse, do)
    grads = _mha_bwd_op(*_fold(*ts), n_real)
    return tuple(g.view(K, *ts[0].shape[1:]) for g in grads), (0, 0, 0)


class _Mha(torch.autograd.Function):
    """forward ``dlsc_tpu_torch::mha``, backward ``dlsc_tpu_torch::mha_bwd``.
    An ``autograd.Function`` with ``setup_context`` and a generated vmap
    rule composes with ``torch.func`` (``vmap(grad_and_value(...))``, the
    vmapped HPO step), where a custom op's ``register_autograd`` does not;
    under vmap each op's own rule folds the trials into the batch, so one
    launch serves every trial."""

    generate_vmap_rule = True

    @staticmethod
    def forward(q, k, v, n_real):
        return _mha_op(q, k, v, n_real)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, n_real = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.n_real = n_real
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        with torch.no_grad():
            dq, dk, dv = _mha_bwd_op(q, k, v, out, lse, dout, ctx.n_real)
        return dq, dk, dv, None


def fast_mha_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 n_real: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable masked attention: (out, lse), as ``fast_mha_forward``;
    its backward is ``fast_mha_backward``. lse takes no gradient."""
    return _Mha.apply(q, k, v, n_real)


def fast_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_real: int) -> torch.Tensor:
    """Differentiable masked attention output (see ``fast_mha_lse``)."""
    return fast_mha_lse(q, k, v, n_real)[0]
