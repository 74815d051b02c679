"""Dropout from a counter-based draw: each element's keep bit is a hash of
(seed, block, site, its index in the unsplit tensor), so that any split of
the tensor (a rank's rows, a microbatch, a head group, a slice of hidden
units or of experts, a trial of the vmapped HPO step) computes only its own
elements and gets the bits that the one-process step gets.

The hash is Philox4x32-10 (Salmon et al., SC'11; the generator of cuRAND
and of PyTorch's CUDA RNG):

- key: the 64-bit seed (a step's ``dropout_seed``, or a trial's under the
  vmapped HPO step, ``trial_seeds``), low word first;
- counter: (q low, q high, block, site), q = g >> 2, g the element's flat
  index in the unsplit tensor (row-major); the element takes word g & 3;
- keep iff word < floor(keep · 2^32), keep = 1 - rate in f32; a kept entry
  becomes x / keep, computed in f32 (f64 for f64 x) and rounded to x's dtype.

JAX draws its dropout masks from threefry keys, also counter-based
(``dlsc_tpu/utils/runtime.py:44``); the two streams differ, and no test
compares masks across the packages.

``dropout`` is the differentiable op: its backward applies the same mask to
the gradient, drawn again (nothing is saved but the seed and the rate), as
the custom op ``dlsc_tpu_torch::dropout_draw``. A CUDA tensor launches the
kernel of ``csrc/dropout_draw.cu``, which computes the same words in
registers and is bit-equal to the plain version (int64 tensor arithmetic,
exact on every device) that a CPU tensor runs; there is no fallback from one
to the other. ``keep_mask`` writes the boolean mask alone.

Where an element sits in the unsplit tensor (``Draw``, ``dropout``'s
``dim`` and ``part``): a ``Draw`` carries the seed, the block and the batch
rows of this forward, (start, count, total) of a global batch; ``dim``
holds those rows (k entries a row when x folds more than the batch into
it), ``part`` = (d, i, n) says that dim d is the i-th of n equal parts.
``dropout_rows`` takes a row index instead (the ragged MoE's sorted rows).

Under ``torch.func.vmap`` the seed is a batched (K,) int64 tensor, one a
trial, and the rate may be batched too (``HyperDropout``); the op's vmap rule
takes all K trials in one launch. Seeds live on the host (a CPU tensor): the
kernel takes them by value, so drawing never waits for the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from dlsc_tpu_torch import _kernels
from dlsc_tpu_torch.ops.trials import trial_major

# Philox4x32 (Random123): the round multipliers and the key's Weyl increments
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
PHILOX_ROUNDS = 10
MASK32 = 0xFFFFFFFF
MAX_LEAD = 6        # leading dims the kernel takes (csrc/dropout_draw.cu)
MAX_TRIALS = 64     # seeds a launch (passed by value)
THREADS = 256       # a block of the kernel's grid-stride loop
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

Part = tuple[int, int, int]   # (dim, index, count): x's dim is part index of count
# the masks of a ViT block: attention probabilities, MLP (or experts') hidden
# units, MLP (or MoE) output; the CNN families number their layers' masks
SITE_ATTN, SITE_HIDDEN, SITE_OUT = 0, 1, 2

launches = 0   # kernel launches since the last reset (see reset_launches)


def reset_launches() -> None:
    global launches
    launches = 0


@dataclasses.dataclass(frozen=True)
class Draw:
    """The key of a forward's dropout masks: ``seed`` (an int, or an int64
    tensor: a trial's, batched under vmap), the ``block`` (a model's layer
    index) and, when the forward holds a share of a global batch, ``rows``
    = (start, count, total): its rows are [start, start + count) of
    ``total``. ``site`` (``dropout``'s argument) tells the masks of one
    block apart."""

    seed: int | torch.Tensor
    block: int = 0
    rows: tuple[int, int, int] | None = None


def make_draw(seed: int | torch.Tensor | None, rows: tuple[int, int] | None = None,
              batch: int | None = None, block: int = 0) -> Draw | None:
    """The ``Draw`` of ``block`` in a forward seeded by ``seed`` (None: no
    dropout); ``rows`` = (start, total) with ``batch`` rows here."""
    if seed is None:
        return None
    return Draw(seed, block, None if rows is None else (rows[0], batch, rows[1]))


def trial_seeds(seed: int, slots) -> torch.Tensor:
    """Each trial's 63-bit dropout seed from the step's ``seed`` and the
    trial's global slot index (never its position on a rank): a (K,) int64
    CPU tensor."""
    return torch.tensor([int(np.random.SeedSequence([int(seed), int(s)])
                             .generate_state(1, np.uint64)[0] >> 1) for s in slots],
                        dtype=torch.int64)


# ---- the plain version -----------------------------------------------------------------

def philox4x32(c0, c1, c2, c3, k0, k1, rounds: int = PHILOX_ROUNDS):
    """Philox4x32-R on int64 tensors (or ints) holding 32-bit words,
    broadcast together (on the first one's device): the four output words.
    A round's 32 x 32-bit products are taken in int64, where those past
    2^63 wrap: only their bit patterns are read. A word's bits above 32 may
    hold garbage between rounds where nothing multiplies it (XOR keeps the
    low 32 bits right); the two words a round multiplies are masked, and
    the others at the end. Every pass runs in place on preallocated
    buffers."""
    ts = [t for t in (c0, c1, c2, c3, k0, k1) if torch.is_tensor(t)]
    dev = ts[0].device
    shape = torch.broadcast_shapes(*(t.shape for t in ts))
    c = [torch.as_tensor(t, dtype=torch.int64, device=dev).expand(shape)
         for t in (c0, c1, c2, c3)]
    bufs = [torch.empty(shape, dtype=torch.int64, device=dev) for _ in range(4)]
    for i in range(rounds):
        if i:
            k0, k1 = (k0 + PHILOX_W0) & MASK32, (k1 + PHILOX_W1) & MASK32
        n0, n1, n2, n3 = bufs
        torch.mul(c[2], PHILOX_M1, out=n1)   # the full products (their low words:
        torch.mul(c[0], PHILOX_M0, out=n3)   # the new c1 and c3)
        torch.bitwise_right_shift(n1, 32, out=n0).bitwise_xor_(c[1]).bitwise_xor_(k0)
        torch.bitwise_right_shift(n3, 32, out=n2).bitwise_xor_(c[3]).bitwise_xor_(k1)
        n0.bitwise_and_(MASK32)               # multiplied in the next round
        n2.bitwise_and_(MASK32)
        bufs = c if i else [torch.empty_like(n0) for _ in range(4)]
        c = [n0, n1, n2, n3]
    c[1].bitwise_and_(MASK32)
    c[3].bitwise_and_(MASK32)
    return tuple(c)


def _row_bases(lead: tuple[int, ...], strides: list[int], base: int,
               row_ids: torch.Tensor | None, device) -> torch.Tensor:
    """The unsplit counter of each row's first element: (rows,), or (K,
    rows) for a batched row index."""
    if row_ids is not None:
        return base + row_ids.long() * strides[0]
    out = torch.full((), base, dtype=torch.int64, device=device)
    for size, stride in zip(lead, strides):
        out = out[..., None] + torch.arange(size, device=device) * stride
    return out.reshape(-1)


def _kept(seeds: torch.Tensor, thresholds: torch.Tensor, rowbase: torch.Tensor, cols: int,
          block: int, site: int) -> torch.Tensor:
    """(K, rows, cols) keep bits of the K trials' ``seeds`` (word below the
    trial's threshold) at the rows starting at counters ``rowbase``
    ((rows,) or (K, rows)). Rows that all start on a Philox block (the
    models' sites) take their words as they come; others pick each
    element's word out of the blocks they touch."""
    dev = rowbase.device
    aligned = not bool((rowbase & 3).any())
    slots = -(-cols // 4) if aligned else cols // 4 + 2
    q = (rowbase >> 2)[..., None] + torch.arange(slots, device=dev)   # (.., rows, slots)
    s = seeds.to(dev).reshape(-1, 1, 1)
    w = philox4x32(q & MASK32, (q >> 32) & MASK32, block, site, s & MASK32, (s >> 32) & MASK32)
    thr = thresholds.to(dev).reshape(-1, 1, 1)
    kept = torch.stack([wj < thr for wj in w], -1).flatten(-2)      # (K, rows, 4 slots)
    if aligned:
        return kept[..., :cols]
    col = ((rowbase & 3)[..., None] + torch.arange(cols, device=dev)).expand(
        kept.shape[:-1] + (cols,))
    return torch.gather(kept, -1, col)


def _thresholds(keep: torch.Tensor) -> torch.Tensor:
    """floor(keep · 2^32) as int64 (exact: keep is f32)."""
    return torch.floor(keep.double() * 2.0**32).long()


def _plain(mode: int, x: torch.Tensor, seeds: torch.Tensor, keep: torch.Tensor,
           block: int, site: int, strides: list[int], base: int,
           row_ids: torch.Tensor | None) -> torch.Tensor:
    """The draw on (K, *lead, cols) ``x`` for K trials (seeds (K,), keep
    (K,), row_ids (K, rows) or None): the dropped-out x (mode 1) or the
    boolean keep mask (mode 0)."""
    K, lead, cols = x.shape[0], tuple(x.shape[1:-1]), x.shape[-1]
    rowbase = _row_bases(lead, strides, base, row_ids, x.device)
    kept = _kept(seeds, _thresholds(keep), rowbase, cols, block, site).reshape(x.shape)
    if mode == 0:
        return kept
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    k = keep.to(x.device, ct).reshape((K,) + (1,) * (x.ndim - 1))
    return torch.where(kept, (x.to(ct) / k).to(x.dtype), torch.zeros((), dtype=x.dtype,
                                                                    device=x.device))


# ---- the kernel ------------------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    lib = _kernels.load("dropout_draw")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.dlsc_dropout_draw.argtypes = [i, p, p, i, i, i, p, p, ll, ll, p, p, p, f, i,
                                      ctypes.c_uint, ctypes.c_uint, i, p]
    lib.dlsc_dropout_draw.restype = i
    return lib


def _launch(mode: int, x: torch.Tensor, seeds: list[int], keep: torch.Tensor,
            block: int, site: int, strides: list[int], base: int,
            row_ids: torch.Tensor | None) -> torch.Tensor:
    """The kernel on (K, *lead, cols) CUDA ``x``: K / ``MAX_TRIALS`` launches."""
    if mode == 1 and x.dtype not in _DTYPES:
        raise ValueError(f"dropout_draw: the kernel takes bfloat16/float32, got {x.dtype}")
    lead, cols = tuple(x.shape[1:-1]), x.shape[-1]
    if not 1 <= len(lead) <= MAX_LEAD:
        raise ValueError(f"dropout_draw: 1 to {MAX_LEAD} leading dims, got {x.shape}")
    x = x.contiguous()
    out = torch.empty_like(x) if mode == 1 else torch.empty(x.shape, dtype=torch.bool,
                                                             device=x.device)
    K, per = x.shape[0], x[0].numel()
    keep_by_value = keep.device.type == "cpu"
    if not keep_by_value:
        keep = keep.to(torch.float32).contiguous()
    if row_ids is not None:
        row_ids = row_ids.to(x.device, torch.int64).contiguous()
    size = (ctypes.c_longlong * len(lead))(*lead)
    stride = (ctypes.c_longlong * len(lead))(*strides)
    rows = per // cols
    grid = max(1, min(-(-(min(K, MAX_TRIALS) * rows * (cols // 4 + 2)) // THREADS),
                      torch.cuda.get_device_properties(x.device).multi_processor_count * 16))
    lib = _lib()
    global launches
    with torch.cuda.device(x.device):
        for t0 in range(0, K, MAX_TRIALS):
            n = min(MAX_TRIALS, K - t0)
            seeds_c = (ctypes.c_longlong * n)(*seeds[t0:t0 + n])
            kv = keep[t0:t0 + n] if keep.numel() > 1 else keep.reshape(1)
            err = lib.dlsc_dropout_draw(
                mode, x[t0].data_ptr() if mode == 1 else None, out[t0].data_ptr(),
                _DTYPES[x.dtype] if mode == 1 else 1, n, len(lead), size, stride, base, cols,
                None if row_ids is None else row_ids[t0].data_ptr(), seeds_c,
                None if keep_by_value else kv.data_ptr(),
                float(kv[0]) if keep_by_value else 0.0,
                0 if keep_by_value or keep.numel() == 1 else 1, block, site, grid,
                torch.cuda.current_stream().cuda_stream)
            _kernels.check(lib, err, "dropout draw kernel")
            launches += 1
    return out


def _run(mode: int, x: torch.Tensor, seeds: torch.Tensor, keep: torch.Tensor, block: int,
         site: int, strides: list[int], base: int, row_ids: torch.Tensor | None
         ) -> torch.Tensor:
    """The draw on (K, ...) ``x`` with (K,) ``seeds`` (CPU) and (K,) or
    (1,) ``keep``: the kernel for a CUDA x, the plain version for a CPU x."""
    if seeds.device.type != "cpu":
        raise ValueError("dropout_draw: seeds live on the host (a CPU int64 tensor)")
    if x.device.type == "cpu":
        return _plain(mode, x, seeds, keep, block, site, strides, base, row_ids)
    if x.device.type != "cuda":
        raise ValueError(f"dropout_draw: no kernel for {x.device}")
    return _launch(mode, x, seeds.tolist(), keep, block, site, strides, base, row_ids)


# ---- the op, its vmap rule and its gradient ---------------------------------------------

@torch.library.custom_op("dlsc_tpu_torch::dropout_draw", mutates_args=())
def _dropout_op(x: torch.Tensor, seed: torch.Tensor, keep: torch.Tensor, block: int,
                site: int, strides: list[int], base: int,
                row_ids: torch.Tensor | None) -> torch.Tensor:
    """x / keep where kept, else 0: one trial (seed and keep of shape ())."""
    out = _run(1, x[None], seed.reshape(1), keep.reshape(1), block, site, strides, base,
               None if row_ids is None else row_ids[None])
    return out[0]


@_dropout_op.register_fake
def _(x, seed, keep, block, site, strides, base, row_ids):
    return torch.empty_like(x)


@_dropout_op.register_vmap
def _(info, in_dims, x, seed, keep, block, site, strides, base, row_ids):
    # every trial in one launch: its own seed and keep, the same geometry
    x, seed, keep = trial_major(info, in_dims[:3], x, seed, keep)
    if row_ids is not None:
        (row_ids,) = trial_major(info, in_dims[7:8], row_ids)
    out = _run(1, x, seed.reshape(-1), keep.reshape(-1), block, site, strides, base, row_ids)
    return out, 0


class _Dropout(torch.autograd.Function):
    """forward ``dlsc_tpu_torch::dropout_draw``; backward the same op on the
    gradient (the same mask, drawn again). Composes with ``torch.func``."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, seed, keep, block, site, strides, base, row_ids):
        return _dropout_op(x, seed, keep, block, site, strides, base, row_ids)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, seed, keep, block, site, strides, base, row_ids = inputs
        ctx.args = (block, site, strides, base)
        ctx.has_rows = row_ids is not None
        ctx.save_for_backward(seed, keep, *([row_ids] if ctx.has_rows else []))

    @staticmethod
    def backward(ctx, g):
        seed, keep, *rows = ctx.saved_tensors
        block, site, strides, base = ctx.args
        with torch.no_grad():
            dx = _dropout_op(g.contiguous(), seed, keep, block, site, strides, base,
                             rows[0] if ctx.has_rows else None)
        return dx, None, None, None, None, None, None, None


# ---- the model-facing functions ---------------------------------------------------------

def _seed_tensor(seed: int | torch.Tensor) -> torch.Tensor:
    return seed if torch.is_tensor(seed) else torch.tensor(int(seed), dtype=torch.int64)


def _keep(rate: float | torch.Tensor) -> torch.Tensor:
    """1 - rate in f32: a CPU scalar for a float rate (the kernel takes it by
    value), on the rate's device for a tensor rate."""
    if torch.is_tensor(rate):
        return (1.0 - rate).to(torch.float32)
    return torch.tensor(1.0 - float(rate), dtype=torch.float32)


def geometry(shape: tuple[int, ...], rows: tuple[int, int, int] | None = None, dim: int = 0,
             part: Part | None = None) -> tuple[list[int], int]:
    """(the unsplit strides of the leading dims, the counter of element 0)
    for a tensor of ``shape`` whose dim ``dim`` holds the forward's batch
    rows (``rows`` = (start, count, total), ``shape[dim] // count`` entries
    a row) and whose dim ``part[0]`` is part ``part[1]`` of ``part[2]``."""
    full, start = list(shape), [0] * len(shape)
    if rows is not None:
        first, count, total = rows
        k = shape[dim] // count
        full[dim], start[dim] = total * k, first * k
    if part is not None:
        d, i, n = part
        full[d], start[d] = shape[d] * n, start[d] + i * shape[d]
    strides = [math.prod(full[d + 1:]) for d in range(len(full))]
    return strides[:-1], sum(s * t for s, t in zip(start, strides))


def dropout(x: torch.Tensor, rate: float | torch.Tensor, draw: Draw | None, site: int,
            dim: int = 0, part: Part | None = None) -> torch.Tensor:
    """Inverted dropout of ``x`` at mask ``site`` of ``draw``'s block (no
    dropout when ``draw`` is None or a float ``rate`` is 0; a tensor rate
    always draws, a rate of 0 keeping every entry). ``dim`` and ``part``:
    where x sits in the unsplit tensor (the module docstring)."""
    if draw is None or (not torch.is_tensor(rate) and rate == 0.0):
        return x
    if x.ndim < 2:
        x2 = dropout(x[None], rate, draw, site, dim + 1, None if part is None
                     else (part[0] + 1, part[1], part[2]))
        return x2[0]
    strides, base = geometry(tuple(x.shape), draw.rows, dim, part)
    return _Dropout.apply(x, _seed_tensor(draw.seed), _keep(rate), draw.block, site,
                          strides, base, None)


def dropout_rows(x: torch.Tensor, rate: float | torch.Tensor, draw: Draw | None, site: int,
                 row_ids: torch.Tensor, width: int, col_start: int = 0) -> torch.Tensor:
    """Dropout of the rows of a (rows, cols) ``x`` whose row r is row
    ``row_ids[r]`` of an unsplit (·, ``width``) tensor, from its column
    ``col_start`` (the ragged MoE's sorted rows, a slice of their units)."""
    if draw is None or (not torch.is_tensor(rate) and rate == 0.0):
        return x
    return _Dropout.apply(x, _seed_tensor(draw.seed), _keep(rate), draw.block, site, [width],
                          col_start, row_ids)


def keep_mask(shape: tuple[int, ...], rate: float | torch.Tensor, seed: int | torch.Tensor,
              block: int, site: int, strides: list[int] | None = None, base: int = 0,
              row_ids: torch.Tensor | None = None,
              device: torch.device | str = "cpu") -> torch.Tensor:
    """The boolean keep mask of ``shape`` on ``device`` (the kernel on a
    card, the plain version on the CPU); ``strides`` and ``base`` default
    to an unsplit tensor of ``shape``."""
    if strides is None:
        strides, base = geometry(tuple(shape))
    x = torch.empty((1,) + tuple(shape), dtype=torch.uint8, device=device)   # never read
    seeds = _seed_tensor(seed).reshape(1)
    return _run(0, x, seeds, _keep(rate).reshape(1), block, site, strides, base,
                None if row_ids is None else row_ids[None])[0]
