"""Plain AST ViT, dense or with token-choice MoE MLPs, in float32.

The architecture (Gong et al. 2021 on a DeiT trunk): a 16 x 16 patch embed
with stride ``patch_stride`` over the (128, frames) log-mel, tokens
row-major over (mel patches, time patches), a zero CLS token in front, the
first n positions of the 10-s positional table added; pre-LN blocks (eps
1e-6) with packed [q|k|v] attention, q scaled by dh^-0.5, softmax over the
n real tokens, the head merge and proj; an exact-erf GELU MLP, or the MoE
block: an f32 bias-free router, softmax gates, the top-k gates renormalised
by max(sum, 1e-9), each chosen expert's FFN (x·wi + bi, GELU, dropout,
·wo + bo) weighted by its gate; then the final LN, a linear head on the CLS
token and a sigmoid. The MoE aux loss is the z-loss (mean over real tokens
of logsumexp(logits)²) weighted by ``router_z_weight`` plus
``aux_weight`` · E · Σ_e frac_e · prob_e, frac_e the share of first choices
on expert e and prob_e the mean gate, over the whole batch.

Dropout masks are the counter-based ones of ``philox``: the MLP's hidden
units (site 1) and output (site 2) and the MoE output (site 2) at their
(batch row, token, unit) index in the (B, n_pad, ·) tensor of the padded
token layout, the experts' hidden units (site 1) at their (batch row, real
token, choice, unit) index in (B, n_real, top_k, F); block i keys block i.

``prec`` 'fp8' is the control: every product (patch embed, qkv, scores,
P·V, proj, MLP, router, experts, head) takes its operands rounded to
float8 e4m3 with a per-tensor scale, and its backward the incoming gradient
rounded to e5m2, the usual fp8 training recipe; the rest stays f32.

The model runs on ``x`` rows [row0, row0 + b) of a batch whose dropout rows
are global, block by block under ``torch.utils.checkpoint``, so that a
chunk's backward holds one block's attention scores at a time.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference import philox

LN_EPS = 1e-6
SITE_HIDDEN, SITE_OUT = 1, 2
E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2


def _q(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    s = x.detach().abs().amax().clamp_min(1e-30) / torch.finfo(dt).max
    return (x / s).to(dt).to(x.dtype) * s


def _sum_to(t: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    while t.ndim > len(shape):
        t = t.sum(0)
    for d, n in enumerate(shape):
        if n == 1 and t.shape[d] != 1:
            t = t.sum(d, keepdim=True)
    return t


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        aq, bq = _q(a, E4M3), _q(b, E4M3)
        ctx.save_for_backward(aq, bq)
        return torch.matmul(aq, bq)

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = _q(g, E5M2)
        return (_sum_to(torch.matmul(gq, bq.transpose(-1, -2)), aq.shape),
                _sum_to(torch.matmul(aq.transpose(-1, -2), gq), bq.shape))


class Reference:
    """The model of an AST config's ``model`` dict over ``params`` (f32,
    the port's names), computing products in ``prec``."""

    def __init__(self, model: dict, params: dict[str, torch.Tensor], n_pad: int,
                 prec: str = "f32"):
        if prec not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {prec!r}")
        self.m, self.p, self.n_pad, self.prec = model, params, n_pad, prec
        self.moe = model.get("moe")
        self.rate = float(model.get("dropout", 0.0))
        self.masks: dict = {}   # keep masks of the current step, kept for the recompute

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(a, b) if self.prec == "f32" else _Fp8Matmul.apply(a, b)

    def linear(self, x: torch.Tensor, name: str, bias: bool = True) -> torch.Tensor:
        y = self.mm(x, self.p[name + ".weight"].t())
        return y + self.p[name + ".bias"] if bias else y

    def ln(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.p[name + ".weight"], self.p[name + ".bias"],
                            LN_EPS)

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        m, p = self.m, self.p
        k, s = m["patch_size"], m["patch_stride"]
        patches = F.unfold(x[:, None], k, stride=s).transpose(1, 2)   # (b, L, k·k)
        w = p["patch_embed.weight"].reshape(m["emb_dim"], k * k)
        tok = self.mm(patches, w.t()) + p["patch_embed.bias"]
        b, n = tok.shape[0], tok.shape[1] + 1
        tok = torch.cat([p["cls_token"].expand(b, 1, -1), tok], 1)
        return tok + p["pos_embed"][:, :n]

    def _keep(self, i: int, site: int, seed: int, start: int, count: int, dev) -> torch.Tensor:
        key = (i, site, seed, start, count)
        if key not in self.masks:
            self.masks[key] = philox.keep_range(start, count, self.rate, i, site, seed, dev)
        return self.masks[key]

    def _drop(self, x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        return torch.where(keep, x / philox.keep_value(self.rate), torch.zeros_like(x))

    def _drop_tokens(self, x: torch.Tensor, i: int, site: int, row0: int, seed) -> torch.Tensor:
        """Dropout of (b, n, w) ``x``, rows [row0, row0 + b) of the (B, n_pad,
        w) tensor of the padded layout."""
        if seed is None or self.rate == 0.0:
            return x
        b, n, w = x.shape
        keep = self._keep(i, site, seed, row0 * self.n_pad * w, b * self.n_pad * w, x.device)
        return self._drop(x, keep.view(b, self.n_pad, w)[:, :n])

    def attention(self, h: torch.Tensor, i: int) -> torch.Tensor:
        b, n, D = h.shape
        H = self.m["num_heads"]
        dh = D // H
        qkv = self.linear(h, f"blocks.{i}.attn.qkv").view(b, n, 3, H, dh).permute(2, 0, 3, 1, 4)
        s = self.mm(qkv[0] * dh ** -0.5, qkv[1].transpose(-1, -2))
        o = self.mm(torch.softmax(s, -1), qkv[2])
        return self.linear(o.transpose(1, 2).reshape(b, n, D), f"blocks.{i}.attn.proj")

    def mlp(self, h: torch.Tensor, i: int, row0: int, seed) -> torch.Tensor:
        a = self._drop_tokens(F.gelu(self.linear(h, f"blocks.{i}.mlp.fc1")), i, SITE_HIDDEN,
                              row0, seed)
        return self._drop_tokens(self.linear(a, f"blocks.{i}.mlp.fc2"), i, SITE_OUT, row0, seed)

    def moe_mlp(self, h: torch.Tensor, i: int, row0: int, seed, frac: torch.Tensor | None,
                nv: float, route: torch.Tensor | None = None):
        """(output, this chunk's aux loss, (first-choice counts (E,), routes
        that differ from this model's own choice, routes compared, the
        routes taken (b, n, K))). The load-balance term takes ``frac``, the
        whole batch's first-choice shares (None: this chunk's own), and
        divides by ``nv`` real tokens. ``route`` (b' <= b rows of (n, K)
        experts) replays another run's choices for the chunk's first b'
        rows, its gates taken from this model's own softmax."""
        spec, p, pre = self.moe, self.p, f"blocks.{i}.moe."
        b, n, D = h.shape
        E, K = spec["n_experts"], spec["top_k"]
        logits = self.mm(h, p[pre + "router.weight"].t())
        gates = torch.softmax(logits, -1)
        z2 = torch.logsumexp(logits, -1).square().sum()
        own = torch.topk(gates, K, dim=-1).indices
        topi, flips, compared = own, own.new_zeros(()), 0
        if route is not None and len(route):
            r = route.to(own.device)
            topi = torch.cat([r, own[len(r):]])
            flips, compared = (own[:len(r)] != r).sum(), r.numel()
        topv = gates.gather(-1, topi)
        topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
        counts = (topi[..., 0].reshape(-1, 1) == torch.arange(E, device=h.device)).sum(0)
        share = counts.float() / counts.sum() if frac is None else frac
        aux = (spec["router_z_weight"] * z2
               + spec["aux_weight"] * E * (share * gates.sum((0, 1))).sum()) / nv
        T = b * n
        e_flat = topi.reshape(T * K)
        order = torch.argsort(e_flat, stable=True)                  # pairs by expert
        sizes = torch.bincount(e_flat, minlength=E).tolist()
        xs = h.reshape(T, D)[order // K]
        wi, bi, wo, bo = (p[pre + k] for k in ("wi", "bi", "wo", "bo"))
        cuts = [(e, a, a + c) for e, (a, c) in enumerate(zip(
            [sum(sizes[:e]) for e in range(E)], sizes)) if c]
        a = F.gelu(torch.cat([self.mm(xs[lo:hi], wi[e]) + bi[e] for e, lo, hi in cuts]))
        if seed is not None and self.rate:
            Fh = a.shape[-1]
            keep = self._keep(i, SITE_HIDDEN, seed, row0 * n * K * Fh, T * K * Fh, h.device)
            a = self._drop(a, keep.view(T * K, Fh)[order])
        out = torch.cat([self.mm(a[lo:hi], wo[e]) + bo[e] for e, lo, hi in cuts])
        pairs = out[torch.argsort(order)].view(T, K, D)              # back in pair order
        y = self._drop_tokens((topv.reshape(T, K, 1) * pairs).sum(1).view(b, n, D), i,
                              SITE_OUT, row0, seed)
        return y, aux, (counts, flips, compared, topi)

    def block(self, x: torch.Tensor, i: int, row0: int, seed, frac, nv, route=None):
        x = x + self.attention(self.ln(x, f"blocks.{i}.norm1"), i)
        h = self.ln(x, f"blocks.{i}.norm2")
        if self.moe:
            y, aux, info = self.moe_mlp(h, i, row0, seed, frac, nv, route)
            return x + y, aux, info
        return x + self.mlp(h, i, row0, seed), x.new_zeros(()), None

    def forward(self, x: torch.Tensor, row0: int = 0, seed: int | None = None,
                fracs: list | None = None, nv: float | None = None, remat: bool = True,
                routes: list | None = None):
        """(sigmoid outputs (b, C), the chunk's aux loss, each MoE block's
        ``moe_mlp`` routing record) for features ``x`` (b, 128, frames), rows
        [row0, row0 + b) of the batch. ``routes``: each MoE block's replayed
        choices for the batch's first rows ((B', n, K), ``moe_mlp``)."""
        h = self.embed(x)
        nv = float(h.shape[0] * h.shape[1]) if nv is None else nv
        aux, infos = h.new_zeros(()), []
        for i in range(self.m["depth"]):
            frac = None if fracs is None else fracs[i]
            route = None if routes is None else routes[i][row0:row0 + x.shape[0]]
            if remat and torch.is_grad_enabled():
                h, a, info = checkpoint(self.block, h, i, row0, seed, frac, nv, route,
                                        use_reentrant=False)
            else:
                h, a, info = self.block(h, i, row0, seed, frac, nv, route)
            aux = aux + a
            infos.append(info)
        cls = self.ln(h[:, 0], "norm")
        return torch.sigmoid(self.linear(cls, "head")), aux, infos


def soft_cross_entropy_sum(out: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Σ over rows of -Σ y · log(softmax(out) + 1e-8): the recipe's loss on
    the sigmoid outputs, summed (the caller divides by the batch)."""
    return -(y * torch.log(torch.softmax(out, -1) + 1e-8)).sum()
