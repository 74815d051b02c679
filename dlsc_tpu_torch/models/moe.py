"""Mixture-of-experts MLP, token-choice top-k with dropless ragged dispatch.

Counterpart of ``dlsc_tpu/models/moe.py``: ``MoeSpec`` (:51-141),
``as_moe_spec`` and ``MoeMlp`` on its ``dispatch='ragged'`` path (``__call__``
:180-244, ``_ragged`` :367-455). Only ``router='token'`` with
``dispatch='ragged'`` is ported; the ``einsum`` and ``scatter`` lowerings,
the expert-choice router and expert parallelism raise (ROADMAP M8).

Routing, as in the JAX package: a bias-free router in f32 → softmax →
top-k (``topk``, ``torch.topk`` by default) → the chosen gates renormalised
by ``max(sum, 1e-9)``. Pad tokens (>= ``n_real``) get no expert and are
left out of the aux means. The aux loss is returned pre-weighted: router
z-loss plus the load-balance loss over real tokens from the *first* choice.

Dispatch: the B·N·K (token, choice) pairs are sorted by expert with a stable
sort, pads given the virtual id E so that they sort to the tail, and the
sorted rows are cut statically at ``m_real = B·n_real·K``; the kernels mask
the ragged edge of each group, so no tile rounding is needed. ``group_sizes``
is counted in integers on the device (the JAX package sums a float32
one-hot, which is exact only below 2^24 rows; ``torch.bincount`` reads its
input's max to the host on the card, so the count compares ids instead).
The expert FFN is two ``grouped_matmul`` calls (kernel K4 on the card), the
per-row expert bias a one-hot product, GELU exact. The dispatch gather and
the combine have backward passes that are gathers too (``_GatherRows``,
``_CombineRows``, as ``_gather_rows`` / ``_combine_rows`` :561-611): the
autograd of an index would scatter-add bf16 rows with atomics, in an order
that changes from run to run.

Dropout (``dropout``) draws its masks from the generator it is given; the
blocks in ``models/vit.py`` seed one per block and step, so a
rematerialised block draws the same masks again.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from dlsc_tpu_torch.ops.gmm import grouped_matmul as gmm_op

#: train-metric names of the MoE stats, for ``MetricState.create(extras=...)``
MOE_METRICS = ("moe/drop_frac", "moe/util")

TopkFn = Callable[[torch.Tensor, int], tuple[torch.Tensor, torch.Tensor]]
GroupedMatmulFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MoeSpec:
    """The JAX ``MoeSpec`` fields and checks; see the module docstring for
    what is ported. ``capacity_factor`` and ``group_size`` only matter to
    the capacity lowerings and are kept so that a JAX config means the same."""

    n_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_weight: float = 1e-2       # load-balance loss weight (Switch)
    router_z_weight: float = 1e-3  # router logit z-loss weight (ST-MoE)
    router: str = "token"
    dispatch: str = "einsum"
    group_size: int = 256

    def __post_init__(self):
        if self.top_k < 1 or self.top_k > self.n_experts:
            raise ValueError(f"top_k={self.top_k} must be in [1, n_experts={self.n_experts}]")
        if self.dispatch not in ("scatter", "einsum", "ragged"):
            raise ValueError(f"dispatch={self.dispatch!r} must be 'scatter', 'einsum' or "
                             "'ragged'")
        if self.dispatch == "ragged" and self.router != "token":
            raise ValueError("dispatch='ragged' is dropless token-choice only — "
                             "expert-choice is capacity-based by construction")
        if self.router not in ("token", "expert"):
            raise ValueError(f"router={self.router!r} must be 'token' or 'expert'")
        if self.group_size < 1:
            raise ValueError(f"group_size={self.group_size} must be >= 1")
        if (self.router, self.dispatch) != ("token", "ragged"):
            raise NotImplementedError(
                f"router={self.router!r} with dispatch={self.dispatch!r} is not ported; only "
                "router='token' with dispatch='ragged' is (ROADMAP M8)")


def as_moe_spec(spec: MoeSpec | dict | None) -> MoeSpec | None:
    """A config's dict (or a spec, or None) as a ``MoeSpec``."""
    if spec is None or isinstance(spec, MoeSpec):
        return spec
    return MoeSpec(**dict(spec))


def topk_routes(gates: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The default router choice: the k largest gates, largest first."""
    return torch.topk(gates, k, dim=-1, sorted=True)


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout with masks from ``gen`` (no dropout when ``gen`` is
    None or ``rate`` is 0): kept entries are scaled by 1/(1 - rate). The
    uniform draws are f32 whatever x's dtype, so that a bf16 and an f32 run
    with the same generator drop the same entries."""
    if gen is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def _counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """How many of ``ids`` equal each of 0..n-1 (int64, on ids' device):
    integers, so exact at any row count, and no host sync."""
    return (ids.reshape(-1, 1) == torch.arange(n, device=ids.device)).sum(0)


def _one_hot(ids: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    return (ids[..., None] == torch.arange(n, device=ids.device)).to(dtype)


class _GatherRows(torch.autograd.Function):
    """xs[m] = x[tok[m]]. Backward: dx[t] = Σ_k g[inv[t, k]], the pairs past
    the kept rows (pads) reading an appended zero row."""

    @staticmethod
    def forward(ctx, x, tok, inv):
        ctx.save_for_backward(inv)
        return x[tok]

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        g_ext = torch.cat([g, g.new_zeros((1, g.shape[1]))])
        return g_ext[inv.clamp(max=g.shape[0])].sum(1), None, None


class _CombineRows(torch.autograd.Function):
    """y[t, k] = out[inv[t, k]], zero for the pairs past the kept rows.
    Backward: dout[m] = g[order[m]], the forward permutation."""

    @staticmethod
    def forward(ctx, out, inv, order):
        ctx.save_for_backward(order)
        ext = torch.cat([out, out.new_zeros((1, out.shape[1]))])
        return ext[inv.clamp(max=out.shape[0])]

    @staticmethod
    def backward(ctx, g):
        (order,) = ctx.saved_tensors
        return g.reshape(-1, g.shape[-1])[order], None, None


class MoeMlp(nn.Module):
    """Drop-in for the dense ``Mlp``: top-k routed expert FFNs.

    Parameters in the JAX layout: ``router.weight`` (E, D) (the Flax kernel
    transposed), ``wi`` (E, D, F), ``bi`` (E, F), ``wo`` (E, F, D), ``bo``
    (E, D), F = ratio · D. ``forward`` returns (y, aux, stats): y like x,
    the pre-weighted aux loss (f32 scalar) and the (drop_frac, util) pair.
    ``router_hook``, None unless set, is called on every forward with the
    router's f32 input and its logits, and computes nothing of the output
    (a check reads the logits' gradient through it).
    """

    def __init__(self, dim: int, spec: MoeSpec | dict, ratio: float = 4.0,
                 dropout: float = 0.0):
        super().__init__()
        self.spec = as_moe_spec(spec)
        self.rate = dropout
        E, F_ = self.spec.n_experts, int(dim * ratio)
        self.router = nn.Linear(dim, E, bias=False)
        self.wi = nn.Parameter(torch.empty(E, dim, F_))
        self.bi = nn.Parameter(torch.empty(E, F_))
        self.wo = nn.Parameter(torch.empty(E, F_, dim))
        self.bo = nn.Parameter(torch.empty(E, dim))
        self.router_hook: Callable[[torch.Tensor, torch.Tensor], None] | None = None

    def forward(self, x: torch.Tensor, n_real: int | None = None,
                grouped_matmul: GroupedMatmulFn = gmm_op, topk: TopkFn = topk_routes,
                gen: torch.Generator | None = None):
        B, N, D = x.shape
        E, K = self.spec.n_experts, self.spec.top_k
        n_real = N if n_real is None else min(n_real, N)
        T, nv, dt = B * N, B * n_real, x.dtype
        valid = torch.arange(N, device=x.device) < n_real            # (N,)

        # --- router (f32) and the aux losses over real tokens ---------------
        xf = x.float()
        logits = F.linear(xf, self.router.weight)                     # (B, N, E)
        if self.router_hook is not None:
            self.router_hook(xf, logits)
        gates = torch.softmax(logits, dim=-1)
        z2 = torch.logsumexp(logits, dim=-1).square() * valid
        aux = self.spec.router_z_weight * z2.sum() / nv
        topv, topi = topk(gates, K)                                   # (B, N, K)
        topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
        frac = _counts(topi[:, :n_real, 0], E).float() / nv           # first choice
        prob = (gates * valid[:, None]).sum((0, 1)) / nv
        aux = aux + self.spec.aux_weight * E * (frac * prob).sum()

        # --- sort (token, choice) pairs by expert, pads last ----------------
        m_real = nv * K
        e_flat = torch.where(valid[:, None], topi, E).reshape(T * K)
        order_full = torch.argsort(e_flat, stable=True)               # sorted → pair
        inv = torch.empty_like(order_full).scatter_(
            0, order_full, torch.arange(T * K, device=x.device)).view(T, K)
        order = order_full[:m_real]
        e_sorted = e_flat[order]
        group_sizes = _counts(e_sorted, E).to(torch.int32)            # sums to m_real

        # --- expert FFN on the sorted rows ----------------------------------
        xs = _GatherRows.apply(x.reshape(T, D), order // K, inv)     # (m_real, D)
        h = (grouped_matmul(xs, self.wi.to(dt), group_sizes)
             + _one_hot(e_sorted, E, dt) @ self.bi.to(dt))
        h = dropout(F.gelu(h), self.rate, gen)
        out = grouped_matmul(h, self.wo.to(dt), group_sizes)         # (m_real, D)

        # --- combine with the gates; bo in token space ----------------------
        wk = topv.to(dt) * valid[:, None].to(dt)                      # pads weigh 0
        y = (_CombineRows.apply(out, inv, order) * wk.reshape(T, K, 1)).sum(1)
        aw = (_one_hot(topi, E, dt) * wk[..., None]).sum(2)           # (B, N, E)
        y = y.reshape(B, N, D) + aw @ self.bo.to(dt)
        y = dropout(y, self.rate, gen)

        # --- stats: nothing is dropped; util is the routed load's entropy ---
        p = group_sizes.float() / group_sizes.sum().clamp_min(1).float()
        util = -(p * torch.log(p + 1e-9)).sum() / math.log(E)
        stats = torch.stack([torch.zeros_like(util), util])
        return y, aux, stats
