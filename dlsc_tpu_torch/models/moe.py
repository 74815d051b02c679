"""Mixture-of-experts MLP: token-choice top-k or expert-choice routing, with
the dropless ragged dispatch or the capacity dispatches.

Counterpart of ``dlsc_tpu/models/moe.py``: ``MoeSpec`` (:51-141),
``as_moe_spec`` and ``MoeMlp`` (``__call__`` :180-303, ``_sow_stats``
:305-314, ``_expert_choice`` :316-354, ``_ragged`` :367-455, ``_ffn``
:457-467). Every (router, dispatch) pair of the JAX ``MoeSpec`` runs;
expert parallelism waits for multi-GPU (ROADMAP M12).

Routing, as in the JAX package: a bias-free router in f32 → softmax, and
the z-loss over real tokens (pads, >= ``n_real``, are left out of every
aux mean). The aux loss is returned pre-weighted.

- ``router='token'``: top-k (``topk``, ``torch.topk`` by default) → the
  chosen gates renormalised by ``max(sum, 1e-9)``; plus the load-balance
  loss over real tokens from the *first* choice.
- ``router='expert'`` (``_expert_choice``): per routing group each expert
  takes its top-C tokens by gate (``topk`` again, over the group's tokens;
  pads score −1 and their one-hot rows are masked); the combine weights are
  the raw gates clipped at 0, with no renormalisation. No load-balance
  loss. ``moe/drop_frac`` is the share of real tokens no expert took.

``dispatch='ragged'`` (token-choice only): the B·N·K (token, choice) pairs
are sorted by expert with a stable sort, pads given the virtual id E so
that they sort to the tail, and the sorted rows are cut statically at
``m_real = B·n_real·K``; the kernels mask the ragged edge of each group, so
no tile rounding is needed. ``group_sizes`` is counted in integers on the
device (the JAX package sums a float32 one-hot, which is exact only below
2^24 rows; ``torch.bincount`` reads its input's max to the host on the
card, so the count compares ids instead). The expert FFN is two
``grouped_matmul`` calls (kernel K4 on the card), the per-row expert bias a
one-hot product, GELU exact. The dispatch gather and the combine have
backward passes that are gathers too (``_GatherRows``, ``_CombineRows``, as
``_gather_rows`` / ``_combine_rows`` :561-611): the autograd of an index
would scatter-add bf16 rows with atomics, in an order that changes from
run to run.

The capacity dispatches (``'einsum'``, ``'scatter'``; expert-choice always
takes ``'einsum'``'s products) route within groups of S tokens, S the
largest divisor of N at most ``group_size`` (``_group_size``), each expert
holding C = max(1, ceil(K·min(S, n_real)·int(100·cf) / (100·E))) slots a
group (``capacity``; ``int(100·cf)`` truncates as the JAX formula does).
Token-choice fills them stage-major: every first choice ranks before any
second, ties by token order; a choice past C is dropped (its weight 0, its
token rides the residual). ``'einsum'`` builds the (B, G, S, E, C) one-hot
dispatch and combine tensors and contracts them with ``torch.einsum``;
``'scatter'`` adds each kept row into its (group, expert, slot) of the
buffer with ``index_add`` and gathers it back. Both run the experts as two
batched products over the (E, B·G·C, ·) buffer (``_ffn``) and agree up to
the order of the K-term combine sum. No Pallas kernel is on these paths
in the JAX package (XLA einsums and scatters), and none here. Scatter is
reproducible bit for bit: each kept slot receives exactly one non-zero
row, and a dropped or pad row adds an exact zero (its weight and its
cotangent are 0), so the order of the atomic adds cannot change a sum, in
the forward nor in the gather's backward.

Dropout (``dropout``) draws its masks from the generator it is given; the
blocks in ``models/vit.py`` seed one per block and step, so a
rematerialised block draws the same masks again. On the ragged path the
routing index tensors, the gate weights and both grouped products' outputs
are tagged ``moe_res`` (``utils/remat.remat_tag``, ``moe.py:417-442``),
which remat ``attn_res_moe`` keeps: its backward reruns neither product's
forward nor the sort. The JAX package names the first product's output
(with its bias) but not the second's, which the gate weights' gradient
reads, so XLA reruns the second there (ROADMAP §3 D2); the gradients are
the same either way. The capacity paths name nothing ``moe_res``, in JAX
as here, so ``attn_res_moe`` keeps nothing more than ``attn_res`` there.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from dlsc_tpu_torch.ops.gmm import grouped_matmul as gmm_op
from dlsc_tpu_torch.utils.remat import remat_tag

#: train-metric names of the MoE stats, for ``MetricState.create(extras=...)``
MOE_METRICS = ("moe/drop_frac", "moe/util")

TopkFn = Callable[[torch.Tensor, int], tuple[torch.Tensor, torch.Tensor]]
GroupedMatmulFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MoeSpec:
    """The JAX ``MoeSpec`` fields and checks. ``capacity_factor`` and
    ``group_size`` only matter to the capacity dispatches and expert-choice."""

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


def as_moe_spec(spec: MoeSpec | dict | None) -> MoeSpec | None:
    """A config's dict (or a spec, or None) as a ``MoeSpec``."""
    if spec is None or isinstance(spec, MoeSpec):
        return spec
    return MoeSpec(**dict(spec))


def _group_size(n: int, cap: int) -> int:
    """Largest divisor of ``n`` that is <= ``cap`` (>= 1)."""
    for s in range(min(cap, n), 0, -1):
        if n % s == 0:
            return s
    return 1


def capacity(spec: MoeSpec, n: int, n_real: int) -> tuple[int, int, int]:
    """(S, G, C): the routing group's size, the groups per sequence of ``n``
    tokens and the slots per expert and group, as ``moe.py:189-192``
    computes them (``min(S, n_real)`` keeps a padded single group at the
    unpadded run's capacity)."""
    S = _group_size(n, spec.group_size)
    C = max(1, -(-spec.top_k * min(S, n_real) * int(100 * spec.capacity_factor)
                 // (100 * spec.n_experts)))
    return S, n // S, C


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
    """Drop-in for the dense ``Mlp``: routed expert FFNs.

    Parameters in the JAX layout: ``router.weight`` (E, D) (the Flax kernel
    transposed), ``wi`` (E, D, F), ``bi`` (E, F), ``wo`` (E, F, D), ``bo``
    (E, D), F = ratio · D. ``forward`` returns (y, aux, stats): y like x,
    the pre-weighted aux loss (f32 scalar) and the (drop_frac, util) pair
    (``_stats``). ``router_hook``, None unless set, is called on every
    forward with the router's f32 input and its logits; ``route_hook``
    likewise with the (B, N, E) f32 count of each token's kept dispatches
    to each expert. Neither computes anything of the output (checks read
    the logits' gradient and the routed tokens through them).
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
        self.route_hook: Callable[[torch.Tensor], None] | None = None

    def forward(self, x: torch.Tensor, n_real: int | None = None,
                grouped_matmul: GroupedMatmulFn = gmm_op, topk: TopkFn = topk_routes,
                gen: torch.Generator | None = None):
        B, N, D = x.shape
        E, K = self.spec.n_experts, self.spec.top_k
        n_real = N if n_real is None else min(n_real, N)
        nv = B * n_real
        valid = torch.arange(N, device=x.device) < n_real            # (N,)

        # --- router (f32) and the z-loss over real tokens -------------------
        xf = x.float()
        logits = F.linear(xf, self.router.weight)                     # (B, N, E)
        if self.router_hook is not None:
            self.router_hook(xf, logits)
        gates = torch.softmax(logits, dim=-1)
        z2 = torch.logsumexp(logits, dim=-1).square() * valid
        aux = self.spec.router_z_weight * z2.sum() / nv
        if self.spec.router == "expert":
            y, stats = self._expert_choice(x, gates, valid, n_real, topk, gen)
            return dropout(y, self.rate, gen), aux, stats

        # --- token-choice top-k and the load-balance loss -------------------
        topv, topi = topk(gates, K)                                   # (B, N, K)
        topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
        frac = _counts(topi[:, :n_real, 0], E).float() / nv           # first choice
        prob = (gates * valid[:, None]).sum((0, 1)) / nv
        aux = aux + self.spec.aux_weight * E * (frac * prob).sum()
        if self.spec.dispatch == "ragged":
            y, stats = self._ragged(x, topi, topv, valid, n_real, grouped_matmul, gen)
        else:
            y, stats = self._capacity(x, topi, topv, valid, n_real, gen)
        return dropout(y, self.rate, gen), aux, stats

    def _stats(self, drop_frac: torch.Tensor, load: torch.Tensor) -> torch.Tensor:
        """(drop_frac, util) as ``_sow_stats`` (``moe.py:305-314``): util is
        the normalised entropy of the dispatched per-expert load (1.0 =
        perfectly balanced)."""
        p = load / load.sum().clamp_min(1e-9)
        util = -(p * torch.log(p + 1e-9)).sum() / math.log(load.shape[0])
        return torch.stack([drop_frac, util]).float()

    def _report(self, kept: Callable[[], torch.Tensor]) -> None:
        if self.route_hook is not None:
            self.route_hook(kept())

    def _ragged(self, x, topi, topv, valid, n_real, grouped_matmul, gen):
        """Dropless dispatch on the grouped products (``moe.py:367-455``):
        nothing is dropped; util from the routed load."""
        B, N, D = x.shape
        E, K = self.spec.n_experts, self.spec.top_k
        T, dt = B * N, x.dtype
        # --- sort (token, choice) pairs by expert, pads last ----------------
        m_real = B * n_real * K
        with remat_tag("moe_res"):   # the routing index tensors
            e_flat = torch.where(valid[:, None], topi, E).reshape(T * K)
            order_full = torch.argsort(e_flat, stable=True)           # sorted → pair
            inv = torch.zeros_like(order_full).scatter(
                0, order_full, torch.arange(T * K, device=x.device)).view(T, K)
            order = order_full[:m_real]
            e_sorted = e_flat[order]
            group_sizes = _counts(e_sorted, E).to(torch.int32)        # sums to m_real
            tok = order // K

        # --- expert FFN on the sorted rows ----------------------------------
        xs = _GatherRows.apply(x.reshape(T, D), tok, inv)             # (m_real, D)
        wi, wo = self.wi.to(dt), self.wo.to(dt)
        with remat_tag("moe_res"):   # the first product, before its bias
            h = grouped_matmul(xs, wi, group_sizes)
        h = dropout(F.gelu(h + _one_hot(e_sorted, E, dt) @ self.bi.to(dt)), self.rate, gen)
        with remat_tag("moe_res"):
            out = grouped_matmul(h, wo, group_sizes)                  # (m_real, D)

        # --- combine with the gates; bo in token space ----------------------
        with remat_tag("moe_res"):
            wk = topv.to(dt) * valid[:, None].to(dt)                  # pads weigh 0
        y = (_CombineRows.apply(out, inv, order) * wk.reshape(T, K, 1)).sum(1)
        aw = (_one_hot(topi, E, dt) * wk[..., None]).sum(2)           # (B, N, E)
        y = y.reshape(B, N, D) + aw @ self.bo.to(dt)
        self._report(lambda: (_one_hot(topi, E, torch.float32).sum(2)
                              * valid[:, None].float()))
        return y, self._stats(torch.zeros((), device=x.device), group_sizes.float())

    def _capacity(self, x, topi, topv, valid, n_real, gen):
        """Token-choice on the capacity dispatches (``moe.py:246-300``)."""
        B, N, D = x.shape
        E, K = self.spec.n_experts, self.spec.top_k
        S, G, C = capacity(self.spec, N, n_real)
        dt = x.dtype
        # --- capacity positions per group, stage-major: all first choices
        # rank before any second, ties by token order ------------------------
        a4 = _one_hot(topi, E, torch.float32) * valid[:, None, None]  # (B, N, K, E)
        a4 = a4.reshape(B, G, S, K, E)
        pos = a4.transpose(2, 3).reshape(B, G, K * S, E).cumsum(2) - 1.0
        pos = (pos.reshape(B, G, K, S, E).transpose(2, 3) * a4).sum(-1)   # (B, G, S, K)
        keep = (pos < C).to(dt) * valid.reshape(G, S)[None, :, :, None].to(dt)
        pi = pos.clamp(0, C - 1).long()
        wk = topv.to(dt).reshape(B, G, S, K) * keep                  # combine weights
        keep32 = keep.float()
        stats = self._stats(1.0 - keep32.sum() / (K * B * n_real),
                            (a4 * keep32[..., None]).sum((0, 1, 2, 3)))
        self._report(lambda: (a4 * keep32[..., None]).sum(3).reshape(B, N, E))

        # --- dispatch → expert FFN → combine ---------------------------------
        xg = x.reshape(B, G, S, D)
        if self.spec.dispatch == "einsum":
            # one-hot products: (B, G, S, E, C) dispatch and combine tensors
            keep_e = _one_hot(topi, E, dt).reshape(B, G, S, K, E) * keep[..., None]
            oc = _one_hot(pi, C, dt) * keep[..., None]                # (B, G, S, K, C)
            disp = torch.einsum("bgske,bgskc->bgsec", keep_e, oc)
            buf = torch.einsum("bgsec,bgsd->ebgcd", disp, xg)
            out = self._ffn(buf.reshape(E, B * G * C, D), gen).view(E, B, G, C, D)
            comb = torch.einsum("bgske,bgskc,bgsk->bgsec", keep_e, oc, wk)
            y = torch.einsum("bgsec,ebgcd->bgsd", comb, out)
        else:
            # scatter-add of each kept row into its (expert, group, slot), a
            # gather back; dropped and pad rows add exact zeros at slot C - 1
            bg = torch.arange(B * G, device=x.device).view(B, G, 1, 1)
            slot = ((topi.reshape(B, G, S, K) * (B * G) + bg) * C + pi).reshape(-1)
            rows = (xg[:, :, :, None, :] * keep[..., None]).reshape(-1, D)
            buf = torch.zeros(E * B * G * C, D, dtype=dt, device=x.device).index_add(
                0, slot, rows)
            out = self._ffn(buf.view(E, B * G * C, D), gen).reshape(-1, D)
            y = (out[slot].view(B, G, S, K, D) * wk[..., None]).sum(3)
        return y.reshape(B, N, D), stats

    def _expert_choice(self, x, gates, valid, n_real, topk, gen):
        """Expert-choice (``moe.py:316-354``): per group each expert takes
        its top-C tokens by gate; dispatch and combine are one-hot products."""
        B, N, D = x.shape
        E = self.spec.n_experts
        S, G, C = capacity(self.spec, N, n_real)
        dt = x.dtype
        vmask = valid.reshape(G, S)
        # pads rank below every real token (gates are in (0, 1))
        scores = torch.where(vmask[None, :, None, :], gates.reshape(B, G, S, E).transpose(2, 3),
                             -1.0)                                    # (B, G, E, S)
        wv, ti = topk(scores, C)                                      # (B, G, E, C)
        # an all-pad group would still pick pads: zero their rows
        oh = _one_hot(ti, S, dt) * vmask[None, :, None, None, :].to(dt)   # (B, G, E, C, S)
        wv = wv.clamp_min(0.0).to(dt)
        buf = torch.einsum("bgecs,bgsd->ebgcd", oh, x.reshape(B, G, S, D))
        out = self._ffn(buf.reshape(E, B * G * C, D), gen).view(E, B, G, C, D)
        y = torch.einsum("bgecs,ebgcd->bgsd", oh * wv[..., None], out).reshape(B, N, D)
        # 'dropped' here: real tokens taken by no expert (they ride the
        # residual); the load is each expert's taken slots
        oh32 = oh.float()
        taken = oh32.sum((2, 3))                                      # (B, G, S)
        stats = self._stats(((taken <= 0) * vmask).sum() / (B * n_real),
                            oh32.sum((0, 1, 3, 4)))
        self._report(lambda: oh32.sum(3).transpose(2, 3).reshape(B, N, E))
        return y, stats

    def _ffn(self, buf: torch.Tensor, gen: torch.Generator | None) -> torch.Tensor:
        """The stacked experts over their (E, M, D) capacity rows
        (``moe.py:457-467``): two batched products, bias, exact GELU."""
        dt = buf.dtype
        h = torch.bmm(buf, self.wi.to(dt)) + self.bi.to(dt)[:, None]
        h = dropout(F.gelu(h), self.rate, gen)
        return torch.bmm(h, self.wo.to(dt)) + self.bo.to(dt)[:, None]
