"""Kernel K4: grouped matrix products over expert-sorted rows (``csrc/gmm.cu``).

Counterpart of ``dlsc_tpu/models/moe.py`` ``_grouped_matmul`` (:537-558)
and the megablox custom VJP it reaches on the TPU (``ops.py:22-109``). The
rows of ``lhs`` are sorted by group: group g owns ``group_sizes[g]``
consecutive rows, and ``group_sizes`` (E,) int32 sums to ``lhs.shape[0]``.
It lies on the tensors' device, and the kernels read it there: no wrapper
moves it to the host.

- ``gmm`` (K4a): out[rows of g] = lhs[rows of g] @ rhs[g], rhs (E, k, n),
  or @ rhs[g]^T with rhs (E, n, k) when ``transpose_rhs``; out in lhs's
  dtype, f32 sums. In bf16 a persistent wgmma kernel fed by a TMA ring:
  ``_gmm_plan`` is its launch, ``_row_tiles`` and ``_tile_walk`` mirror the
  tiles it computes and the order in which its CTAs visit them.
- ``tgmm`` (K4b): out[g] = lhs[rows of g]^T @ grad[rows of g], (E, k, n);
  an empty group gives zeros. In bf16 a persistent wgmma kernel over row
  slices of at most ``slice_rows`` rows, then a kernel that sums the f32
  partial tiles of each group of several slices in slice order:
  ``_tgmm_plan`` is the launch, ``_slices`` and ``_tile_walk`` mirror the
  slices and the units' order, ``_tgmm_sliced`` the arithmetic.

Both launch their kernel for CUDA tensors (bf16 or f32) and run their plain
version, ``gmm_reference`` / ``tgmm_reference``, for CPU tensors; they never
fall back from one to the other. ``grouped_matmul`` is the differentiable
product: an ``autograd.Function`` whose forward is the ``torch.library``
custom op ``dlsc_tpu_torch::gmm`` (``gmm``) and whose backward is the op
``dlsc_tpu_torch::gmm_bwd``: dlhs = ``gmm(grad, rhs, transpose_rhs=True)``
and drhs = ``tgmm(lhs, grad)``, as megablox computes them. The forward
being an op, a selective-checkpoint policy sees it (``models/vit.py``
recomputes it under ``attn_res``). Under ``torch.func.vmap`` (the vmapped
HPO step) both fold K trials' E experts into K·E groups, their rows stacked
trial-major: one launch of each kernel for every trial (the bf16 kernels'
group table holds ``GMM_MAX_GROUPS``).
"""

from __future__ import annotations

import ctypes

import torch

from dlsc_tpu_torch import _kernels
from dlsc_tpu_torch.ops.trials import aligned, trial_major

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# K4a bf16 (csrc/gmm.cu, which uses the same numbers): an output tile's rows
# (2 consumer warpgroups of 64) and columns, a ring stage's depth, the ring's
# slots, threads (the consumers and a producer warp), the group table's
# capacity; a block's shared memory (H100: 227 KB)
GMM_TILE_M, GMM_TILE_N, GMM_TILE_K, GMM_STAGES, GMM_THREADS = 128, 128, 64, 5, 288
GMM_MAX_GROUPS = 256
SMEM_LIMIT = 232_448
# K4b bf16: units ((group, slice, output tile)) aimed at per SM, which sets
# the slice length; a stage's rows; the output rows of a summing CTA
TGMM_UNITS_PER_SM, TGMM_STAGE_ROWS, TGMM_REDUCE_ROWS = 4, 64, 8

launches = 0        # K4a gmm launches since the last reset (see reset_launches)
tgmm_launches = 0   # K4b tgmm launches


def reset_launches() -> None:
    global launches, tgmm_launches
    launches = 0
    tgmm_launches = 0


def _lib() -> ctypes.CDLL:
    lib = _kernels.load("gmm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dlsc_gmm.argtypes = [p, p, p, p] + [i] * 10 + [p]
    lib.dlsc_gmm.restype = i
    lib.dlsc_tgmm.argtypes = [p, p, p, p, p] + [i] * 11 + [p]
    lib.dlsc_tgmm.restype = i
    return lib


def _gmm_plan(M: int, K: int, N: int, E: int, transpose_rhs: bool, sms: int = 132) -> dict:
    """The launch of K4a's bf16 kernel (``csrc/gmm.cu`` computes the same by
    the same formulas and refuses a launch whose numbers differ): a
    persistent grid of one CTA per SM (``sms``), never more than the tiles
    there can be, ``max_tiles`` = (at most ceil(M/128) + E row tiles) x
    ``col_tiles``; ``k_steps`` ring stages per tile, each a 128-row lhs box
    and the rhs[g] tile (``rhs_boxes``: one 128-row K-major box with
    ``transpose_rhs``, else two 64-column MN-major panels). ``smem``: 1024
    of alignment slack, the ring, the staged output tile, the ring's
    mbarriers and the group table."""
    col_tiles = -(-N // GMM_TILE_N)
    max_tiles = (-(-M // GMM_TILE_M) + E) * col_tiles
    stage_bytes = 2 * GMM_TILE_K * (GMM_TILE_M + GMM_TILE_N)
    return dict(
        grid=min(sms, max_tiles),
        threads=GMM_THREADS,
        stages=GMM_STAGES,
        smem=(1024 + GMM_STAGES * stage_bytes + 2 * GMM_TILE_M * GMM_TILE_N
              + 2 * GMM_STAGES * 8 + 2 * (GMM_MAX_GROUPS + 1) * 4),
        col_tiles=col_tiles,
        max_tiles=max_tiles,
        k_steps=-(-K // GMM_TILE_K),
        rhs_boxes=1 if transpose_rhs else 2,
    )


def _row_tiles(sizes, tile: int = GMM_TILE_M) -> list[tuple[int, int, int]]:
    """K4a's row tiles as its bf16 kernel finds them, in its order: (group,
    first row, end row), each within one group and at most ``tile`` rows.
    The kernel's group table holds each group's first tile and first row
    (negative sizes read as 0); row tile t takes the group whose tiles hold
    t, carried forward from the last tile (a CTA visits its row tiles in
    increasing order), so an empty group is stepped over."""
    tstart, rstart = [0], [0]
    for size in sizes:
        size = max(int(size), 0)
        tstart.append(tstart[-1] + -(-size // tile))
        rstart.append(rstart[-1] + size)
    tiles, g = [], 0
    for t in range(tstart[-1]):
        while tstart[g + 1] <= t:
            g += 1
        row0 = rstart[g] + (t - tstart[g]) * tile
        tiles.append((g, row0, min(rstart[g + 1], row0 + tile)))
    return tiles


def _tile_walk(n_row_tiles: int, col_tiles: int, grid: int) -> list[list[tuple[int, int]]]:
    """The persistent schedule: CTA b computes tiles b, b + grid, ... of the
    n_row_tiles x col_tiles (row tile, column tile) pairs, columns fastest."""
    total = n_row_tiles * col_tiles
    return [[divmod(t, col_tiles) for t in range(b, total, grid)] for b in range(grid)]


def _tgmm_plan(M: int, K: int, N: int, E: int, sms: int = 132) -> dict:
    """The launch of K4b's bf16 kernels (``csrc/gmm.cu`` computes the same by
    the same formulas and refuses a launch whose numbers differ). Each
    group's rows are cut into slices of at most ``slice_rows`` (a multiple
    of the 64-row stage, from M, K, N and the SM count only: the units,
    (group, slice, output tile) with ``tiles`` 128 x 128 tiles a group,
    number about ``TGMM_UNITS_PER_SM`` times the SMs); there are at most
    ``slots`` = ceil(M / slice_rows) + E slices. A persistent grid of one
    CTA per SM, never more than the units there can be; ``workspace``: the
    f32 floats of every slice's partial tiles; ``reduce_grid``: the second
    kernel's CTAs, one per 8 rows of a tile of a group. ``smem`` is K4a's:
    the ring (per stage two 64 x 64 lhs boxes and two grad panels), the
    staged output tile, the mbarriers and the group table."""
    k_tiles, n_tiles = -(-K // GMM_TILE_M), -(-N // GMM_TILE_N)
    tiles = k_tiles * n_tiles
    want = -(-M * tiles // (TGMM_UNITS_PER_SM * sms))
    slice_rows = max(TGMM_STAGE_ROWS, -(-want // TGMM_STAGE_ROWS) * TGMM_STAGE_ROWS)
    slots = -(-M // slice_rows) + E
    return dict(
        grid=min(sms, slots * tiles),
        threads=GMM_THREADS,
        stages=GMM_STAGES,
        smem=_gmm_plan(M, K, N, E, False, sms)["smem"],
        slice_rows=slice_rows,
        slots=slots,
        k_tiles=k_tiles,
        n_tiles=n_tiles,
        tiles=tiles,
        max_units=slots * tiles,
        workspace=slots * tiles * GMM_TILE_M * GMM_TILE_N,
        reduce_grid=(tiles * GMM_TILE_M // TGMM_REDUCE_ROWS, E),
    )


def _slices(sizes, slice_rows: int, M: int | None = None) -> list[tuple[int, int, int]]:
    """K4b's row slices as its bf16 kernel finds them, in its order: (group,
    first row, end row), each within one group; a group of s rows has n =
    ceil(s / slice_rows) slices of ceil(s / n) rows rounded up to the
    64-row stage, the last one shorter. Negative sizes read as 0 and rows
    past ``M`` (default: the sizes' sum) are cut, as the kernel's group
    table does."""
    M = sum(max(int(s), 0) for s in sizes) if M is None else M
    out, start = [], 0
    for g, size in enumerate(sizes):
        size = min(max(int(size), 0), M - start)
        if size:
            per = -(-size // -(-size // slice_rows))   # ceil(size / n), n slices
            length = -(-per // TGMM_STAGE_ROWS) * TGMM_STAGE_ROWS
            out += [(g, r, min(r + length, start + size))
                    for r in range(start, start + size, length)]
        start += size
    return out


def _tgmm_sliced(lhs: torch.Tensor, grad: torch.Tensor, group_sizes: torch.Tensor,
                 slice_rows: int) -> torch.Tensor:
    """K4b bf16's arithmetic in torch: each group's slices' f32 partial
    products added in slice order from zero (a group of one slice: its
    product; an empty group: zeros), the result in lhs's dtype. (Inside a
    slice the kernel's order over rows is its own.)"""
    out = lhs.new_zeros((group_sizes.shape[0], lhs.shape[1], grad.shape[1]),
                        dtype=torch.float32)
    for g, r0, r1 in _slices(group_sizes.tolist(), slice_rows, lhs.shape[0]):
        out[g] += lhs[r0:r1].float().T @ grad[r0:r1].float()
    return out.to(lhs.dtype)


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

    CUDA tensors: kernel K4a (bf16: launched as ``_gmm_plan`` says, at most
    ``GMM_MAX_GROUPS`` groups; rows past the sizes' sum are not written).
    CPU tensors: ``gmm_reference``, after checking that the sizes sum to M.
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
    if M == 0:
        return out
    launch = (0, 0, 0, 0)   # the f32 kernel's grid is its own
    if lhs.dtype == torch.bfloat16:
        if E > GMM_MAX_GROUPS:
            raise ValueError(f"gmm: {E} groups, the kernel's table holds {GMM_MAX_GROUPS}")
        sms = torch.cuda.get_device_properties(lhs.device).multi_processor_count
        plan = _gmm_plan(M, k, n, E, transpose_rhs, sms)
        if plan["smem"] > SMEM_LIMIT:
            raise ValueError(f"gmm: shared memory {plan['smem']} over {SMEM_LIMIT}")
        launch = (plan["grid"], plan["threads"], plan["smem"], plan["stages"])
    lib = _lib()
    with torch.cuda.device(lhs.device):
        err = lib.dlsc_gmm(lhs.data_ptr(), rhs.data_ptr(), group_sizes.data_ptr(),
                           out.data_ptr(), M, k, n, E, int(transpose_rhs), _DTYPES[lhs.dtype],
                           *launch, torch.cuda.current_stream().cuda_stream)
    _kernels.check(lib, err, "grouped matmul kernel")
    global launches
    launches += 1
    return out


def tgmm(lhs: torch.Tensor, grad: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """Per-group transposed product (M, k), (M, n) → (E, k, n) (see the module
    docstring). CUDA tensors: kernel K4b (bf16: launched as ``_tgmm_plan``
    says, at most ``GMM_MAX_GROUPS`` groups, with an f32 workspace from the
    caching allocator; one launch counted for its two kernels). CPU
    tensors: ``tgmm_reference``."""
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
    launch, workspace = (0,) * 6, None   # the f32 kernel's grid is its own
    if lhs.dtype == torch.bfloat16:
        if E > GMM_MAX_GROUPS:
            raise ValueError(f"tgmm: {E} groups, the kernel's table holds {GMM_MAX_GROUPS}")
        sms = torch.cuda.get_device_properties(lhs.device).multi_processor_count
        plan = _tgmm_plan(M, k, n, E, sms)
        if plan["smem"] > SMEM_LIMIT:
            raise ValueError(f"tgmm: shared memory {plan['smem']} over {SMEM_LIMIT}")
        launch = (plan["grid"], plan["threads"], plan["smem"], plan["stages"],
                  plan["slice_rows"], plan["slots"])
        workspace = torch.empty(plan["workspace"], dtype=torch.float32, device=lhs.device)
    lib = _lib()
    with torch.cuda.device(lhs.device):
        err = lib.dlsc_tgmm(lhs.data_ptr(), grad.data_ptr(), group_sizes.data_ptr(),
                            out.data_ptr(), 0 if workspace is None else workspace.data_ptr(),
                            M, k, n, E, _DTYPES[lhs.dtype], *launch,
                            torch.cuda.current_stream().cuda_stream)
    _kernels.check(lib, err, "grouped transposed matmul kernel")
    global tgmm_launches
    tgmm_launches += 1
    return out


def _fold_groups(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor):
    """K trials' problems as one: their rows stacked trial-major (each
    trial's sorted by its groups, so group e of trial i is group i·E + e),
    their E experts as K·E groups."""
    return tuple(aligned(t) for t in (lhs.reshape(-1, lhs.shape[-1]),
                                       rhs.reshape(-1, *rhs.shape[2:]), group_sizes.reshape(-1)))


@torch.library.custom_op("dlsc_tpu_torch::gmm", mutates_args=())
def _gmm_op(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """The forward as an op: ``gmm(lhs, rhs, group_sizes)``."""
    return gmm(lhs, rhs, group_sizes)


@_gmm_op.register_fake
def _(lhs, rhs, group_sizes):
    return lhs.new_empty((lhs.shape[0], rhs.shape[2]))


@_gmm_op.register_vmap
def _(info, in_dims, lhs, rhs, group_sizes):
    lhs, rhs, group_sizes = trial_major(info, in_dims, lhs, rhs, group_sizes)
    out = _gmm_op(*_fold_groups(lhs, rhs, group_sizes))
    return out.view(info.batch_size, lhs.shape[1], -1), 0


@torch.library.custom_op("dlsc_tpu_torch::gmm_bwd", mutates_args=())
def _gmm_bwd_op(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
                grad: torch.Tensor, need_dlhs: bool,
                need_drhs: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward as an op: (dlhs = K4a with the transposed rhs, drhs =
    K4b), each an empty tensor where its ``need_*`` is False."""
    grad = grad.contiguous()
    dlhs = gmm(grad, rhs, group_sizes, transpose_rhs=True) if need_dlhs else grad.new_empty(0)
    drhs = tgmm(lhs, grad, group_sizes).to(rhs.dtype) if need_drhs else rhs.new_empty(0)
    return dlhs, drhs


@_gmm_bwd_op.register_fake
def _(lhs, rhs, group_sizes, grad, need_dlhs, need_drhs):
    return (torch.empty_like(lhs) if need_dlhs else grad.new_empty(0),
            torch.empty_like(rhs) if need_drhs else rhs.new_empty(0))


@_gmm_bwd_op.register_vmap
def _(info, in_dims, lhs, rhs, group_sizes, grad, need_dlhs, need_drhs):
    K = info.batch_size
    lhs, rhs, group_sizes, grad = trial_major(info, in_dims[:4], lhs, rhs, group_sizes, grad)
    flhs, frhs, fgs = _fold_groups(lhs, rhs, group_sizes)
    dlhs, drhs = _gmm_bwd_op(flhs, frhs, fgs, grad.reshape(-1, grad.shape[-1]),
                             need_dlhs, need_drhs)
    return ((dlhs.view(K, *lhs.shape[1:]) if need_dlhs else dlhs,
             drhs.view(K, *rhs.shape[1:]) if need_drhs else drhs),
            (0 if need_dlhs else None, 0 if need_drhs else None))


class _GroupedMatmul(torch.autograd.Function):
    """forward ``dlsc_tpu_torch::gmm``, backward ``dlsc_tpu_torch::gmm_bwd``;
    composes with ``torch.func`` (see ``ops/attn_fast.py`` ``_Mha``)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(lhs, rhs, group_sizes):
        return _gmm_op(lhs, rhs, group_sizes)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, grad):
        lhs, rhs, group_sizes = ctx.saved_tensors
        need_dlhs, need_drhs = ctx.needs_input_grad[:2]
        with torch.no_grad():
            dlhs, drhs = _gmm_bwd_op(lhs, rhs, group_sizes, grad, need_dlhs, need_drhs)
        return dlhs if need_dlhs else None, drhs if need_drhs else None, None


def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor,
                   group_sizes: torch.Tensor) -> torch.Tensor:
    """Differentiable grouped product ``gmm(lhs, rhs, group_sizes)``; its
    backward is K4a with the transposed rhs (dlhs) and K4b (drhs)."""
    return _GroupedMatmul.apply(lhs, rhs, group_sizes)
