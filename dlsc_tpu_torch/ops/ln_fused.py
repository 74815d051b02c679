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

d is a multiple of 8 up to 1024 (16-byte row chunks, at most 4 a lane);
any other d raises ``ValueError`` on every device. Any row
count >= 1 (the JAX kernel's rows % 8 is a TPU sublane grain).

K3b is a persistent grid of ``_bwd_plan(...)["grid"]`` CTAs that walk tiles
of ``tile_rows`` contiguous rows (CTA b the tiles ``_bwd_tiles(plan, b)``),
bulk-copied into a ring of shared-memory stages, and a second kernel that
sums the CTAs' dgamma / dbeta partials in a fixed order; ``csrc/ln_fused.cu``
computes the same plan and refuses any other launch.

- ``fused_add_ln_forward`` / ``fused_add_ln_backward`` launch the CUDA
  kernels for CUDA tensors and run ``add_ln_reference`` /
  ``add_ln_backward_reference`` for CPU tensors; they never fall back from
  one to the other.
- ``add_ln`` is the differentiable add + LN: an ``autograd.Function`` whose
  forward is the ``torch.library`` custom op ``dlsc_tpu_torch::add_ln``
  ((r, y, mu, rsig), K3f) and whose backward is the op
  ``dlsc_tpu_torch::add_ln_bwd`` (K3b); mu and rsig take no gradient. A
  selective-checkpoint policy sees the forward as one call: remat
  ``attn_res`` does not keep its outputs, so a rematerialised block runs K3f
  again, as the JAX policy reruns the kernel.
- Under ``torch.func.vmap`` (the vmapped HPO step): with gamma and beta
  shared by the trials the forward takes every trial's rows in one launch;
  with per-trial gamma and beta, (K, d), it launches once a trial, and so
  does the backward always, whose dgamma and dbeta are sums over one
  trial's rows ((K, d) out).

The LayerNorm alone, of the ViT blocks' bf16 stream (``models/vit.py``
``_layer_norm`` on CUDA bf16 inputs), is the same two kernels with the add
compiled out: ``layer_norm(x, weight, bias) -> y``, an ``autograd.Function``
over the ops ``dlsc_tpu_torch::ln`` ((y, mu, rsig); ``ln_forward``) and
``dlsc_tpu_torch::ln_bwd`` ((dx, dgamma, dbeta); ``ln_backward``), with the
same vmap rules. x is read once and y written once in x's dtype, with f32
statistics of x; the backward rebuilds xhat from x and writes dx once. Its
rounding points are those of ``F.layer_norm(x.float(), ...).to(x.dtype)``
and of that expression's autograd (y and dx each rounded once to x's dtype),
so only the order of the f32 sums differs; CPU tensors run that expression's
own ops (``ln_reference``, ``ln_backward_reference``), bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from dlsc_tpu_torch import _kernels
from dlsc_tpu_torch.ops.trials import aligned, trial_major

EPS = 1e-6          # the LayerNorm epsilon of the ViT blocks
MAX_D = 1024
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# K3b (csrc/ln_fused.cu, which uses the same numbers): consumer warps (and a
# producer warp), resident CTAs an SM, ring stages at most, the bytes of a
# stage aimed at; a block's shared memory (H100: 227 KB), of which each of the
# resident CTAs may use its share less the system's 1 KB; the mbarriers' bytes
BWD_WARPS, BWD_CTAS_PER_SM, BWD_MAX_STAGES, BWD_STAGE_TARGET = 4, 2, 4, 25 * 1024
BWD_THREADS = 32 * (BWD_WARPS + 1)
SMEM_LIMIT = 232_448
BWD_SMEM_BUDGET = SMEM_LIMIT // BWD_CTAS_PER_SM - 1024
BWD_BAR_BYTES = 16 * BWD_MAX_STAGES
REDUCE_SPLIT = 32   # warps of a summing CTA: warp w sums the CTAs w, w + 32, ...

launches = 0         # add + LN forward kernel launches since the last reset
bwd_launches = 0     # add + LN backward kernel launches
ln_launches = 0      # LN-alone forward launches
ln_bwd_launches = 0  # LN-alone backward launches


def reset_launches() -> None:
    global launches, bwd_launches, ln_launches, ln_bwd_launches
    launches = bwd_launches = ln_launches = ln_bwd_launches = 0


def _lib() -> ctypes.CDLL:
    lib = _kernels.load("ln_fused")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dlsc_add_ln_fwd.argtypes = [p] * 8 + [i, i, f, i, p]
    lib.dlsc_add_ln_fwd.restype = i
    lib.dlsc_add_ln_bwd.argtypes = [p] * 10 + [i] * 8 + [p]
    lib.dlsc_add_ln_bwd.restype = i
    lib.dlsc_ln_fwd.argtypes = [p] * 6 + [i, i, f, i, p]
    lib.dlsc_ln_fwd.restype = i
    lib.dlsc_ln_bwd.argtypes = [p] * 9 + [i] * 8 + [p]
    lib.dlsc_ln_bwd.restype = i
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


def _bwd_plan(rows: int, d: int, n_sm: int, elem: int = 2, add: bool = True) -> dict:
    """K3b's launch for ``rows`` rows of width ``d`` in ``elem``-byte elements
    on a card of ``n_sm`` SMs, with the add (``add``) or of the LayerNorm
    alone (``csrc/ln_fused.cu`` computes the same by the same formulas and
    refuses a launch whose numbers differ).

    A row takes ``lanes`` lanes (the fewest powers of two with at most 4
    16-byte chunks each: ``chunks``), so a consumer warp holds
    ``rows_per_warp`` = 32 / lanes rows at once; a tile holds a row for every
    slot of every consumer warp (times the ``BWD_STAGE_TARGET`` fit, at least
    once): ``tile_rows``, a multiple of 4, so that every tile's mu / rsig span
    starts on 16 bytes. A stage holds the tile's r, dy, dr (``streams`` 3; x
    and dy alone without the add: 2) and its mu, rsig;
    ``stages`` as many as the CTA's share of shared memory holds, at most
    ``BWD_MAX_STAGES``. The grid: ``BWD_CTAS_PER_SM`` CTAs an SM, never more
    than the tiles; ``workspace``: the CTAs' (2, grid, d) f32 partials;
    ``reduce_grid``: the summing kernel's CTAs (32 columns each, dgamma and
    dbeta)."""
    row_chunks = d // 8
    lanes = 1
    while lanes * 4 < row_chunks:
        lanes *= 2
    base = BWD_WARPS * (32 // lanes)
    streams = 3 if add else 2
    base_bytes = streams * base * d * elem + 8 * base
    k = max(1, BWD_STAGE_TARGET // base_bytes)
    stage_bytes = base_bytes * k
    stages = min(BWD_MAX_STAGES, (BWD_SMEM_BUDGET - BWD_BAR_BYTES) // stage_bytes)
    tiles = -(-rows // (base * k))
    grid = min(n_sm * BWD_CTAS_PER_SM, tiles)
    return dict(lanes=lanes, chunks=-(-row_chunks // lanes), rows_per_warp=32 // lanes,
                streams=streams, tile_rows=base * k, stage_bytes=stage_bytes, stages=stages,
                smem=BWD_BAR_BYTES + stages * stage_bytes, tiles=tiles, grid=grid,
                threads=BWD_THREADS, workspace=2 * grid * d, reduce_grid=(-(-d // 32), 2))


def _bwd_tiles(plan: dict, cta: int) -> range:
    """The tiles that CTA ``cta`` of K3b takes, in its order; tile t holds
    rows [t * tile_rows, min((t + 1) * tile_rows, rows))."""
    return range(cta, plan["tiles"], plan["grid"])


def fused_add_ln_backward(r: torch.Tensor, mu: torch.Tensor, rsig: torch.Tensor,
                          weight: torch.Tensor, dr: torch.Tensor, dy: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(stored r (..., d), mu, rsig (...) f32, gamma (d,) f32, dr, dy (..., d))
    → (dx, dgamma, dbeta); dx is the gradient of both x and delta.

    CUDA tensors: kernel K3b (launched as ``_bwd_plan`` says, with an f32
    workspace for its CTAs' dgamma / dbeta partials from the caching
    allocator; one launch counted for its two kernels). CPU tensors:
    ``add_ln_backward_reference``. ``dr`` and ``dy`` may be strided: they are
    made contiguous here.
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
    sms = torch.cuda.get_device_properties(r.device).multi_processor_count
    plan = _bwd_plan(rows, d, sms, r.element_size())
    dx = torch.empty_like(r)
    dgamma, dbeta = (torch.empty(d, dtype=torch.float32, device=r.device) for _ in range(2))
    workspace = torch.empty(plan["workspace"], dtype=torch.float32, device=r.device)
    lib = _lib()
    with torch.cuda.device(r.device):
        err = lib.dlsc_add_ln_bwd(
            r.data_ptr(), mu.data_ptr(), rsig.data_ptr(), weight.data_ptr(), dr.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
            workspace.data_ptr(), rows, d, _DTYPES[r.dtype], plan["grid"], plan["threads"],
            plan["smem"], plan["stages"], plan["tile_rows"],
            torch.cuda.current_stream().cuda_stream)
    _kernels.check(lib, err, "add + LayerNorm backward kernel")
    global bwd_launches
    bwd_launches += 1
    return dx, dgamma, dbeta


@torch.library.custom_op("dlsc_tpu_torch::add_ln", mutates_args=())
def _add_ln_op(x: torch.Tensor, delta: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """The forward as an op: (r, y, mu, rsig), as ``fused_add_ln_forward``."""
    return fused_add_ln_forward(x, delta, weight, bias)


@_add_ln_op.register_fake
def _(x, delta, weight, bias):
    stats = x.new_empty(x.shape[:-1], dtype=torch.float32)
    return torch.empty_like(x), torch.empty_like(x), stats, torch.empty_like(stats)


@_add_ln_op.register_vmap
def _(info, in_dims, x, delta, weight, bias):
    x, delta = trial_major(info, in_dims[:2], x, delta)
    if in_dims[2] is None and in_dims[3] is None:   # shared gamma, beta: one launch
        return _add_ln_op(x, delta, weight, bias), (0, 0, 0, 0)
    weight, bias = (aligned(t) for t in trial_major(info, in_dims[2:], weight, bias))
    outs = [_add_ln_op(x[i], delta[i], weight[i], bias[i]) for i in range(info.batch_size)]
    return tuple(torch.stack(o) for o in zip(*outs)), (0, 0, 0, 0)


@torch.library.custom_op("dlsc_tpu_torch::add_ln_bwd", mutates_args=())
def _add_ln_bwd_op(r: torch.Tensor, mu: torch.Tensor, rsig: torch.Tensor,
                   weight: torch.Tensor, dr: torch.Tensor,
                   dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward as an op: (dx, dgamma, dbeta), as ``fused_add_ln_backward``."""
    return fused_add_ln_backward(r, mu, rsig, weight, dr, dy)


@_add_ln_bwd_op.register_fake
def _(r, mu, rsig, weight, dr, dy):
    return torch.empty_like(r), torch.empty_like(weight), torch.empty_like(weight)


@_add_ln_bwd_op.register_vmap
def _(info, in_dims, r, mu, rsig, weight, dr, dy):
    # dgamma and dbeta are sums over one trial's rows: one launch a trial
    ts = trial_major(info, in_dims, r, mu, rsig, weight, dr, dy)
    ts[3] = aligned(ts[3])   # each trial's gamma on 16 bytes
    outs = [_add_ln_bwd_op(*(t[i] for t in ts)) for i in range(info.batch_size)]
    return tuple(torch.stack(o) for o in zip(*outs)), (0, 0, 0)


class _AddLn(torch.autograd.Function):
    """forward ``dlsc_tpu_torch::add_ln``, backward
    ``dlsc_tpu_torch::add_ln_bwd``; composes with ``torch.func`` (see
    ``ops/attn_fast.py`` ``_Mha``)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, delta, weight, bias):
        return _add_ln_op(x, delta, weight, bias)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, _, weight, _ = inputs
        r, _, mu, rsig = output
        ctx.save_for_backward(r, mu, rsig, weight)
        ctx.mark_non_differentiable(mu, rsig)

    @staticmethod
    def backward(ctx, dr, dy, _dmu, _drsig):
        r, mu, rsig, weight = ctx.saved_tensors
        with torch.no_grad():
            dx, dgamma, dbeta = _add_ln_bwd_op(r, mu, rsig, weight, dr, dy)
        return dx, dx, dgamma, dbeta


def add_ln(x: torch.Tensor, delta: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Differentiable fused add + LayerNorm: (r, y, mu, rsig), as
    ``fused_add_ln_forward``; its backward is ``fused_add_ln_backward``."""
    return _AddLn.apply(x, delta, weight, bias)


def ln_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain LayerNorm by the ops of ``F.layer_norm(x.float(), ...).to(x.dtype)``:
    (y in x's dtype; mu, rsig f32 of shape x.shape[:-1])."""
    y, mu, rsig = torch.native_layer_norm(x.float(), (x.shape[-1],), weight, bias, EPS)
    return y.to(x.dtype), mu.squeeze(-1), rsig.squeeze(-1)


def ln_backward_reference(x: torch.Tensor, mu: torch.Tensor, rsig: torch.Tensor,
                          weight: torch.Tensor, dy: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward by the ops of the autograd of ``ln_reference``'s
    expression (dy to f32, PyTorch's LN backward, dx to x's dtype): (dx,
    dgamma, dbeta f32). The bias slot takes ``weight``: the op reads it for
    dbeta's shape and dtype only."""
    dx, dgamma, dbeta = torch.ops.aten.native_layer_norm_backward(
        dy.float(), x.float(), (x.shape[-1],), mu[..., None], rsig[..., None], weight, weight,
        [True, True, True])
    return dx.to(x.dtype), dgamma, dbeta


def ln_forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(x (..., d); gamma, beta (d,) f32) → (y, mu, rsig).

    CUDA tensors: K3f without the add (x made contiguous where it is
    strided, such as the CLS rows ``x[:, 0]``). CPU tensors: ``ln_reference``.
    """
    if x.ndim < 1 or x.numel() == 0:
        raise ValueError(f"ln_forward: x {tuple(x.shape)} has no rows")
    d = x.shape[-1]
    _check_width("ln_forward", d)
    _check_params("ln_forward", x, weight)
    _check_params("ln_forward", x, bias)
    if x.device.type == "cpu":
        return ln_reference(x, weight, bias)
    x, weight, bias = aligned(x), aligned(weight), aligned(bias)
    _check_kernel_operands("ln_forward", x)
    _check_kernel_operands("ln_forward", weight, bias)   # both float32
    y = torch.empty_like(x)
    mu, rsig = (torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
                for _ in range(2))
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.dlsc_ln_fwd(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), mu.data_ptr(),
            rsig.data_ptr(), x.numel() // d, d, EPS, _DTYPES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    _kernels.check(lib, err, "LayerNorm forward kernel")
    global ln_launches
    ln_launches += 1
    return y, mu, rsig


def ln_backward(x: torch.Tensor, mu: torch.Tensor, rsig: torch.Tensor, weight: torch.Tensor,
                dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(x (..., d), mu, rsig (...) f32, gamma (d,) f32, dy (..., d)) → (dx,
    dgamma, dbeta).

    CUDA tensors: K3b without the dr stream (``_bwd_plan(..., add=False)``;
    one launch counted for its two kernels). CPU tensors:
    ``ln_backward_reference``. x and dy may be strided.
    """
    d = x.shape[-1]
    _check_width("ln_backward", d)
    _check_params("ln_backward", x, weight)
    if dy.shape != x.shape or mu.shape != x.shape[:-1] or rsig.shape != x.shape[:-1]:
        raise ValueError(f"ln_backward: dy {tuple(dy.shape)}, mu {tuple(mu.shape)}, rsig "
                         f"{tuple(rsig.shape)} for x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return ln_backward_reference(x, mu, rsig, weight, dy)
    x, dy, weight = aligned(x), aligned(dy), aligned(weight)
    _check_kernel_operands("ln_backward", x, dy)
    _check_kernel_operands("ln_backward", mu, rsig, weight)   # all float32
    rows = x.numel() // d
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = _bwd_plan(rows, d, sms, x.element_size(), add=False)
    dx = torch.empty_like(x)
    dgamma, dbeta = (torch.empty(d, dtype=torch.float32, device=x.device) for _ in range(2))
    workspace = torch.empty(plan["workspace"], dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.dlsc_ln_bwd(
            x.data_ptr(), mu.data_ptr(), rsig.data_ptr(), weight.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), workspace.data_ptr(), rows, d,
            _DTYPES[x.dtype], plan["grid"], plan["threads"], plan["smem"], plan["stages"],
            plan["tile_rows"], torch.cuda.current_stream().cuda_stream)
    _kernels.check(lib, err, "LayerNorm backward kernel")
    global ln_bwd_launches
    ln_bwd_launches += 1
    return dx, dgamma, dbeta


@torch.library.custom_op("dlsc_tpu_torch::ln", mutates_args=())
def _ln_op(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The LayerNorm alone as an op: (y, mu, rsig), as ``ln_forward``."""
    return ln_forward(x, weight, bias)


@_ln_op.register_fake
def _(x, weight, bias):
    _check_width("ln_forward", x.shape[-1])
    stats = x.new_empty(x.shape[:-1], dtype=torch.float32)
    return x.new_empty(x.shape), stats, torch.empty_like(stats)


@_ln_op.register_vmap
def _(info, in_dims, x, weight, bias):
    (x,) = trial_major(info, in_dims[:1], x)
    if in_dims[1] is None and in_dims[2] is None:   # shared gamma, beta: one launch
        return _ln_op(x, weight, bias), (0, 0, 0)
    weight, bias = (aligned(t) for t in trial_major(info, in_dims[1:], weight, bias))
    outs = [_ln_op(x[i], weight[i], bias[i]) for i in range(info.batch_size)]
    return tuple(torch.stack(o) for o in zip(*outs)), (0, 0, 0)


@torch.library.custom_op("dlsc_tpu_torch::ln_bwd", mutates_args=())
def _ln_bwd_op(x: torch.Tensor, mu: torch.Tensor, rsig: torch.Tensor, weight: torch.Tensor,
               dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The LayerNorm's backward as an op: (dx, dgamma, dbeta), as ``ln_backward``."""
    return ln_backward(x, mu, rsig, weight, dy)


@_ln_bwd_op.register_fake
def _(x, mu, rsig, weight, dy):
    return x.new_empty(x.shape), torch.empty_like(weight), torch.empty_like(weight)


@_ln_bwd_op.register_vmap
def _(info, in_dims, x, mu, rsig, weight, dy):
    # dgamma and dbeta are sums over one trial's rows: one launch a trial
    ts = trial_major(info, in_dims, x, mu, rsig, weight, dy)
    outs = [_ln_bwd_op(*(t[i] for t in ts)) for i in range(info.batch_size)]
    return tuple(torch.stack(o) for o in zip(*outs)), (0, 0, 0)


class _Ln(torch.autograd.Function):
    """forward ``dlsc_tpu_torch::ln``, backward ``dlsc_tpu_torch::ln_bwd``;
    composes with ``torch.func`` as ``_AddLn`` does."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, weight, bias):
        return _ln_op(x, weight, bias)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, weight, _ = inputs
        _, mu, rsig = output
        ctx.save_for_backward(x, mu, rsig, weight)
        ctx.mark_non_differentiable(mu, rsig)
        # y is the one differentiable output, so dy is never None; mu's and
        # rsig's gradients stay None instead of two zero fills a call
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, dy, _dmu, _drsig):
        x, mu, rsig, weight = ctx.saved_tensors
        with torch.no_grad():
            return _ln_bwd_op(x, mu, rsig, weight, dy)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Differentiable LayerNorm of x over its last axis (gamma, beta (d,) f32):
    y in x's dtype, as ``ln_forward``; its backward is ``ln_backward``."""
    return _Ln.apply(x, weight, bias)[0]
