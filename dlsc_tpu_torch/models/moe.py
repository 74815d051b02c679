"""Mixture-of-experts MLP: token-choice top-k or expert-choice routing, with
the dropless ragged dispatch or the capacity dispatches.

Counterpart of ``dlsc_tpu/models/moe.py``: ``MoeSpec`` (:51-141),
``as_moe_spec`` and ``MoeMlp`` (``__call__`` :180-303, ``_sow_stats``
:305-314, ``_expert_choice`` :316-354, ``_ragged`` :367-455, ``_ffn``
:457-467). Every (router, dispatch) pair of the JAX ``MoeSpec`` runs.
Under data parallelism (``group``) the aux loss's sums and the stats are
reduced over the ranks, so that they are the global batch's (the JAX step
computes them over the global batch); under expert parallelism
(``ep_group``, ``parallel/ep.py``) the capacity buffers cross ranks to
their experts (``_expert_parallel``); under tensor parallelism (``tp``, a
``parallel/tp.MoeSplit``) each rank holds a slice of every expert's hidden
units (``_tp_copy``, ``_tp_out``).

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

Dropout (``ops/dropout_draw.dropout``) is a counter-based draw keyed by the
block's ``Draw`` (the step's seed, the block, the forward's rows of the
global batch): a mask bit is a hash of (seed, block, site, the element's
index in the unsplit tensor), so a rematerialised block, a data-parallel
rank's rows, a microbatch, a rank's experts (``_expert_parallel``) or its
slice of the hidden units (tensor parallelism) draw the masks of the
one-process step. The ragged path draws its experts' masks in the sort
order directly: the counter of a sorted row's unit is its (token, choice,
unit) index in the unsplit (global batch, n_real, K, F) tensor, so no mask
depends on which rows share the batch or on the sort. On the ragged path the
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
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn
import torch.nn.functional as F
from torch import nn

from dlsc_tpu_torch.ops.dropout_draw import (SITE_HIDDEN, SITE_OUT, Draw, Part, dropout,
                                             dropout_rows)
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


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """An f32 scalar on ``like``'s device, filled there (no host-to-device
    copy, which a CUDA graph capture of the serving call refuses)."""
    return torch.full((), float(v), dtype=torch.float32, device=like.device)


def _counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """How many of ``ids`` equal each of 0..n-1 (int64, on ids' device):
    integers, so exact at any row count, and no host sync."""
    return (ids.reshape(-1, 1) == torch.arange(n, device=ids.device)).sum(0)


def _one_hot(ids: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    return (ids[..., None] == torch.arange(n, device=ids.device)).to(dtype)


class _GatherRows(torch.autograd.Function):
    """xs[m] = x[tok[m]]. Backward: dx[t] = Σ_k g[inv[t, k]], the pairs past
    the kept rows (pads) reading an appended zero row."""

    generate_vmap_rule = True   # torch.func (the vmapped HPO step)

    @staticmethod
    def forward(x, tok, inv):
        return x[tok]

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[2])

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        g_ext = torch.cat([g, g.new_zeros((1, g.shape[1]))])
        return g_ext[inv.clamp(max=g.shape[0])].sum(1), None, None


class _CombineRows(torch.autograd.Function):
    """y[t, k] = out[inv[t, k]], zero for the pairs past the kept rows.
    Backward: dout[m] = g[order[m]], the forward permutation."""

    generate_vmap_rule = True

    @staticmethod
    def forward(out, inv, order):
        ext = torch.cat([out, out.new_zeros((1, out.shape[1]))])
        return ext[inv.clamp(max=out.shape[0])]

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[2])

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
        # data parallelism (parallel/): the ranks whose rows make up the
        # global batch, over which the aux loss and the stats are reduced
        self.group: dist.ProcessGroup | None = None
        # expert parallelism (parallel/ep.py): the ranks that hold the other
        # experts; wi, bi, wo and bo then hold this rank's E / ep experts
        self.ep_group: dist.ProcessGroup | None = None
        # tensor parallelism (parallel/tp.py): a ``MoeSplit``; wi, bi and wo
        # then hold this rank's slice of every expert's hidden units
        self.tp = None

    def _global(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over ``group`` (autograd-aware), or ``t`` itself."""
        if self.group is None:
            return t
        return dist_nn.all_reduce(t, group=self.group)

    def _tp_copy(self, t: torch.Tensor) -> torch.Tensor:
        """The experts' input or the combine weights: under tensor
        parallelism their gradient, a partial sum through this rank's hidden
        units, is summed over the ranks, so that the router, the gates and
        the aux loss see the whole gradient once (the router's input is not
        passed through: its gradient is whole)."""
        return t if self.tp is None else self.tp.copy_in(t)

    def _tp_out(self, y: torch.Tensor) -> torch.Tensor:
        """The rank's partial output, summed over the tensor-parallel ranks."""
        return y if self.tp is None else self.tp.reduce_out(y)

    def _bias_out(self, dt: torch.dtype) -> torch.Tensor:
        """bo in ``dt``; divided by tp under tensor parallelism, so that the
        sum over the ranks adds it once (``pp_tp.py:162`` of the JAX package;
        the layout sums its gradient over the ranks)."""
        bo = self.bo.to(dt)
        return bo if self.tp is None else bo / self.tp.tp

    def _out_part(self) -> Part | None:
        """The rank's tokens of the (B, N, D) output under sequence
        parallelism."""
        return (1, self.tp.t, self.tp.tp) if self.tp is not None and self.tp.sp else None

    def _hidden_part(self) -> Part | None:
        """The rank's slice of the (E, rows, F) hidden units under tensor
        parallelism."""
        return None if self.tp is None else (2, self.tp.t, self.tp.tp)

    def forward(self, x: torch.Tensor, n_real: int | None = None,
                grouped_matmul: GroupedMatmulFn = gmm_op, topk: TopkFn = topk_routes,
                draw: Draw | None = None):
        if self.tp is not None:
            x = self.tp.gather(x)   # sequence parallelism: every rank routes every token
        B, N, D = x.shape
        E, K = self.spec.n_experts, self.spec.top_k
        n_real = N if n_real is None else min(n_real, N)
        valid = torch.arange(N, device=x.device) < n_real            # (N,)

        # --- router (f32) and the z-loss over real tokens -------------------
        xf = x.float()
        logits = self.router(xf)   # (B, N, E); a module call: FSDP's unit under FSDP + EP
        if self.router_hook is not None:
            self.router_hook(xf, logits)
        gates = torch.softmax(logits, dim=-1)
        z2 = (torch.logsumexp(logits, dim=-1).square() * valid).sum()
        if self.spec.router == "expert":
            z2, nv = self._global(torch.stack([z2, _scalar(B * n_real, z2)])).unbind()
            y, stats = self._expert_choice(x, gates, valid, n_real, topk, draw)
            return (dropout(self._tp_out(y), self.rate, draw, SITE_OUT, part=self._out_part()),
                    self.spec.router_z_weight * z2 / nv, stats)

        # --- token-choice top-k and the load-balance loss: the aux loss is a
        # product of means over the global batch, so its sums are reduced
        # over the data-parallel ranks first ----------------------------------
        topv, topi = topk(gates, K)                                   # (B, N, K)
        topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
        sums = self._global(torch.cat([
            torch.stack([z2, _scalar(B * n_real, z2)]),
            _counts(topi[:, :n_real, 0], E).float(),                  # first choice
            (gates * valid[:, None]).sum((0, 1))]))
        z2, nv, frac, prob = sums[0], sums[1], sums[2:2 + E] / sums[1], sums[2 + E:] / sums[1]
        aux = (self.spec.router_z_weight * z2 / nv
               + self.spec.aux_weight * E * (frac * prob).sum())
        if self.spec.dispatch == "ragged":
            y, stats = self._ragged(x, topi, topv, valid, n_real, grouped_matmul, draw)
        else:
            y, stats = self._capacity(x, topi, topv, valid, n_real, draw)
        return (dropout(self._tp_out(y), self.rate, draw, SITE_OUT, part=self._out_part()), aux,
                stats)

    @torch.no_grad()
    def _stats(self, dropped: torch.Tensor, pairs: float, load: torch.Tensor) -> torch.Tensor:
        """(drop_frac, util) as ``_sow_stats`` (``moe.py:305-314``):
        drop_frac = dropped / pairs; util is the normalised entropy of the
        dispatched per-expert load (1.0 = perfectly balanced). Over the
        global batch under data parallelism."""
        sums = torch.cat([torch.stack([dropped.float(), _scalar(pairs, dropped)]),
                          load.float()])
        if self.group is not None:
            dist.all_reduce(sums, group=self.group)
        drop_frac, load = sums[0] / sums[1], sums[2:]
        p = load / load.sum().clamp_min(1e-9)
        util = -(p * torch.log(p + 1e-9)).sum() / math.log(load.shape[0])
        return torch.stack([drop_frac, util]).float()

    def _report(self, kept: Callable[[], torch.Tensor]) -> None:
        if self.route_hook is not None:
            self.route_hook(kept())

    def _ragged(self, x, topi, topv, valid, n_real, grouped_matmul, draw):
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
        xs = _GatherRows.apply(self._tp_copy(x).reshape(T, D), tok, inv)   # (m_real, D)
        wi, wo = self.wi.to(dt), self.wo.to(dt)
        with remat_tag("moe_res"):   # the first product, before its bias
            h = grouped_matmul(xs, wi, group_sizes)
        # the masks are drawn in the sort order: a sorted row's counter is its
        # (token, choice) pair's row of the unsplit (global batch, n_real, K, F)
        # tensor, so no mask depends on the sort or on which rows share the batch
        h = F.gelu(h + _one_hot(e_sorted, E, dt) @ self.bi.to(dt))
        if draw is not None and self.rate != 0.0:
            first = 0 if draw.rows is None else draw.rows[0]
            pair = (order // (N * K) + first) * (n_real * K) + order % (N * K)
            F_ = h.shape[1]
            t, tp = (0, 1) if self.tp is None else (self.tp.t, self.tp.tp)
            h = dropout_rows(h, self.rate, draw, SITE_HIDDEN, pair, F_ * tp, t * F_)
        with remat_tag("moe_res"):
            out = grouped_matmul(h, wo, group_sizes)                  # (m_real, D)

        # --- combine with the gates; bo in token space ----------------------
        with remat_tag("moe_res"):
            wk = self._tp_copy(topv.to(dt) * valid[:, None].to(dt))   # pads weigh 0
        y = (_CombineRows.apply(out, inv, order) * wk.reshape(T, K, 1)).sum(1)
        aw = (_one_hot(topi, E, dt) * wk[..., None]).sum(2)           # (B, N, E)
        y = y.reshape(B, N, D) + aw @ self._bias_out(dt)
        self._report(lambda: (_one_hot(topi, E, torch.float32).sum(2)
                              * valid[:, None].float()))
        return y, self._stats(torch.zeros((), device=x.device), 1.0, group_sizes)

    def _capacity(self, x, topi, topv, valid, n_real, draw):
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
        wk = self._tp_copy(topv.to(dt).reshape(B, G, S, K) * keep)   # combine weights
        keep32 = keep.float()
        stats = self._stats(K * B * n_real - keep32.sum(), K * B * n_real,
                            (a4 * keep32[..., None]).sum((0, 1, 2, 3)))
        self._report(lambda: (a4 * keep32[..., None]).sum(3).reshape(B, N, E))

        # --- dispatch → expert FFN → combine ---------------------------------
        xg = self._tp_copy(x).reshape(B, G, S, D)
        if self.spec.dispatch == "einsum":
            # one-hot products: (B, G, S, E, C) dispatch and combine tensors
            keep_e = _one_hot(topi, E, dt).reshape(B, G, S, K, E) * keep[..., None]
            oc = _one_hot(pi, C, dt) * keep[..., None]                # (B, G, S, K, C)
            disp = torch.einsum("bgske,bgskc->bgsec", keep_e, oc)
            buf = torch.einsum("bgsec,bgsd->ebgcd", disp, xg)
            out = self._ffn(buf.reshape(E, B * G * C, D), draw).view(E, B, G, C, D)
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
            out = self._ffn(buf.view(E, B * G * C, D), draw).reshape(-1, D)
            y = (out[slot].view(B, G, S, K, D) * wk[..., None]).sum(3)
        return y.reshape(B, N, D), stats

    def _expert_choice(self, x, gates, valid, n_real, topk, draw):
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
        wv = self._tp_copy(wv.clamp_min(0.0).to(dt))
        buf = torch.einsum("bgecs,bgsd->ebgcd", oh, self._tp_copy(x).reshape(B, G, S, D))
        out = self._ffn(buf.reshape(E, B * G * C, D), draw).view(E, B, G, C, D)
        y = torch.einsum("bgecs,ebgcd->bgsd", oh * wv[..., None], out).reshape(B, N, D)
        # 'dropped' here: real tokens taken by no expert (they ride the
        # residual); the load is each expert's taken slots
        oh32 = oh.float()
        taken = oh32.sum((2, 3))                                      # (B, G, S)
        stats = self._stats(((taken <= 0) * vmask).sum(), B * n_real, oh32.sum((0, 1, 3, 4)))
        self._report(lambda: oh32.sum(3).transpose(2, 3).reshape(B, N, E))
        return y, stats

    def _ffn(self, buf: torch.Tensor, draw: Draw | None) -> torch.Tensor:
        """The stacked experts over their (E, M, D) capacity rows
        (``moe.py:457-467``): two batched products, bias, exact GELU. M is
        the batch's rows times G·C slots. Under expert parallelism the rows
        cross to their experts' ranks and back (``_expert_parallel``)."""
        if self.ep_group is not None:
            return _expert_parallel(self, buf, draw)
        return self._experts(buf, draw, self._hidden_part())

    def _experts(self, buf: torch.Tensor, draw: Draw | None, part: Part | None = None,
                 grad_scale: float = 1.0) -> torch.Tensor:
        """This module's experts on their (E_local, M, D) rows; dropout
        masks per (expert, row, unit), dim 1 holding the rows, ``part`` the
        rank's experts or hidden units. The experts' gradients are scaled by
        ``grad_scale`` (``_expert_parallel``)."""
        dt = buf.dtype
        wi, bi, wo = (w if grad_scale == 1.0 else _ScaleGrad.apply(w, grad_scale)
                      for w in (self.wi, self.bi, self.wo))
        bo = self._bias_out(dt)
        bo = bo if grad_scale == 1.0 else _ScaleGrad.apply(bo, grad_scale)
        h = torch.bmm(buf, wi.to(dt)) + bi.to(dt)[:, None]
        h = dropout(F.gelu(h), self.rate, draw, SITE_HIDDEN, dim=1, part=part)
        return torch.bmm(h, wo.to(dt)) + bo[:, None]


class _ScaleGrad(torch.autograd.Function):
    """Identity whose backward scales the gradient."""

    @staticmethod
    def forward(ctx, w, scale):
        ctx.scale = scale
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _expert_parallel(m: MoeMlp, buf: torch.Tensor, draw: Draw | None) -> torch.Tensor:
    """``m``'s experts on (E, M, D) capacity rows, E split over
    ``m.ep_group``: an all-to-all sends each rank the rows of its E / ep
    experts from every rank of the group, the local experts run on them, and
    a second all-to-all brings the outputs back (autograd-aware, so the
    backward runs the same exchanges in reverse). The group's ranks hold
    consecutive row shares of the batch (``parallel/ep.py``), so the rows a
    rank's experts see are the group's rows in order, which places their
    dropout masks' rows in the unsplit draw. A rank's experts collect
    the gradients of the rows of its whole group, each rank's loss being the
    mean over its own rows: they are scaled by 1 / ep, so that the experts'
    gradients, like every other parameter's, are then averaged over the
    ranks that hold the same copy (``parallel/ep.py``)."""
    ep, me = dist.get_world_size(m.ep_group), dist.get_rank(m.ep_group)
    E, M, D = buf.shape
    El = E // ep
    recv = dist_nn.all_to_all_single(torch.empty_like(buf), buf.contiguous(), group=m.ep_group)
    local = recv.view(ep, El, M, D).transpose(0, 1).reshape(El, ep * M, D)
    if draw is not None and draw.rows is not None:
        first, b, total = draw.rows
        draw = dataclasses.replace(draw, rows=(first - me * b, ep * b, total))
    out = m._experts(local, draw, (0, me, ep), 1.0 / ep)
    out = out.view(El, ep, M, D).transpose(0, 1).reshape(E, M, D)
    return dist_nn.all_to_all_single(torch.empty_like(out), out.contiguous(), group=m.ep_group)
