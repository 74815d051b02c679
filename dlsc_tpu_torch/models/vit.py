"""AST ViT trunk, eval and train mode.

Counterpart of ``dlsc_tpu/models/vit.py`` ``ASTViT``:

- patch-embed conv over the (n_mels, T) log-mel with stride
  ``patch_size - overlap``, a CLS token, and the 10-s positional table
  sliced to N+1 tokens;
- tokens padded to the 128 grain once for the whole encoder, on every
  device, so that CPU and card run one token layout; attention masks keys
  >= n_real and the head reads only the CLS row, so pad rows never reach
  the output, and their gradients are exact zeros;
- pre-LN blocks (eps 1e-6, stats in f32) with packed qkv in [q|k|v] column
  order, the head-merge projection and an exact-erf GELU MLP;
- the final LN, the head in f32 on the CLS token, and the reference's
  sigmoid on the head output (kept, as the JAX package keeps it).

Parameters are float32; the encoder computes in ``dtype`` (bfloat16 for
AST-Base), casting each weight at use, as the Flax modules do, so the
parameter gradients come back in f32 through the casts. Attention is
``ops.attn_fast.fast_mha_lse``: kernels K2f and K2b on the card, the plain
versions on the CPU. ``forward(..., attention=...)`` takes another function
with the same contract, e.g. ``mha_forward_reference`` for a plain run
(autograd of plain ops) on the card.

Training: ``model.train()``, then the blocks are rematerialised when
``remat`` is set (``torch.utils.checkpoint``, non-reentrant), under one of
the JAX package's policies (``remat_kwargs``, ``vit.py:274-327``):

- ``'full'`` saves nothing: the backward reruns the whole block, K2f
  included;
- ``'attn_res'`` keeps each block's attention ``out`` and ``lse`` (the
  outputs of the ``dlsc_tpu_torch::mha`` op, by a selective-checkpoint
  policy): the backward recomputes LN1 → qkv → q, k, v but does not launch
  K2f again. Everything else reruns, the MoE's grouped products
  (``dlsc_tpu_torch::gmm``) included.

MoE blocks (``moe=``, ``models/moe.py``) replace the dense MLP with the
routed experts; ``forward(..., return_aux=True)`` then also returns the
sum over blocks of the pre-weighted aux losses and the block means of the
MoE stats, carried through the checkpoints as block outputs. Dropout
(``dropout``, the MLP's or the experts') draws its masks from a generator
that each block seeds from ``dropout_seed`` and its index at the point of
use, so the re-forward of a rematerialised block draws the same masks.
The other JAX policies (``dots``, ``attn_out``, ``attn_res_qkv``,
``attn_res_fc1``, ``attn_res_moe``) are not ported yet (ROADMAP §1 M3, M8).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (checkpoint, create_selective_checkpoint_contexts,
                                    noop_context_fn)

from dlsc_tpu_torch.models.moe import (MOE_METRICS, GroupedMatmulFn, MoeMlp, MoeSpec,
                                       TopkFn, as_moe_spec, dropout, topk_routes)
from dlsc_tpu_torch.ops.attn_fast import fast_mha_lse
from dlsc_tpu_torch.ops.gmm import grouped_matmul as gmm_op

PAD_GRAIN = 128  # token padding grain of the attention kernel's layout
LN_EPS = 1e-6

AttentionFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, int],
                       tuple[torch.Tensor, torch.Tensor]]

REMAT_POLICIES = ("full", "attn_res")


def _remat_context_fn(policy: str) -> Callable:
    """``context_fn`` of ``torch.utils.checkpoint`` for a remat policy."""
    if policy == "full":
        return noop_context_fn
    if policy == "attn_res":
        return functools.partial(create_selective_checkpoint_contexts,
                                 [torch.ops.dlsc_tpu_torch.mha.default])
    raise ValueError(f"remat_policy {policy!r} is not ported; known: {REMAT_POLICIES}")


def _as_dtype(dtype: torch.dtype | str) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LN with f32 statistics, output in the input's dtype (Flax LayerNorm)."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        LN_EPS).to(x.dtype)


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """Dense in the input's dtype (Flax Dense with ``dtype``)."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, n_real: int,
                attention: AttentionFn) -> torch.Tensor:
        B, N, D = x.shape
        H = self.num_heads
        dh = D // H
        qkv = _linear(x, self.qkv).view(B, N, 3, H, dh).permute(2, 0, 3, 1, 4)
        q = (qkv[0] * dh**-0.5).contiguous()  # pre-scaled, the kernel's contract
        out, _ = attention(q, qkv[1].contiguous(), qkv[2].contiguous(), n_real)
        return _linear(out.transpose(1, 2).reshape(B, N, D), self.proj)


class Mlp(nn.Module):
    def __init__(self, dim: int, ratio: float = 4.0, dropout: float = 0.0):
        super().__init__()
        self.rate = dropout
        self.fc1 = nn.Linear(dim, int(dim * ratio))
        self.fc2 = nn.Linear(int(dim * ratio), dim)

    def forward(self, x: torch.Tensor, gen: torch.Generator | None = None) -> torch.Tensor:
        h = dropout(F.gelu(_linear(x, self.fc1)), self.rate, gen)
        return dropout(_linear(h, self.fc2), self.rate, gen)


class Block(nn.Module):
    """Pre-LN block; the MLP is ``Mlp``, or ``MoeMlp`` (``self.moe``) when
    ``moe`` is given. ``forward`` returns (x, aux, stats), aux and stats
    None for a dense block; ``seed`` (None: no dropout) seeds the block's
    dropout generator."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dropout: float = 0.0, moe: MoeSpec | None = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        if moe is None:
            self.mlp = Mlp(dim, mlp_ratio, dropout)
        else:
            self.moe = MoeMlp(dim, moe, mlp_ratio, dropout)

    def forward(self, x: torch.Tensor, n_real: int, attention: AttentionFn,
                grouped_matmul: GroupedMatmulFn = gmm_op, topk: TopkFn = topk_routes,
                seed: int | None = None):
        gen = None if seed is None else torch.Generator(x.device).manual_seed(seed)
        x = x + self.attn(_layer_norm(x, self.norm1), n_real, attention)
        y = _layer_norm(x, self.norm2)
        if not hasattr(self, "moe"):
            return x + self.mlp(y, gen), None, None
        out, aux, stats = self.moe(y, n_real, grouped_matmul, topk, gen)
        return x + out, aux, stats


def _trunc_normal_(t: torch.Tensor, std: float, gen: torch.Generator | None) -> None:
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def _lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator | None) -> None:
    """Flax's default kernel init: truncated normal, variance 1/fan_in."""
    # 0.8796... is the std of a unit normal truncated to [-2, 2]
    _trunc_normal_(t, math.sqrt(1.0 / fan_in) / 0.87962566103423978, gen)


class ASTViT(nn.Module):
    """AST trunk; ``forward(features) -> sigmoid(head(CLS))`` of shape
    (B, num_classes) f32. ``features``: (B, n_mels, T) or (B, 1, n_mels, T).

    ``config`` holds the constructor arguments (dtype by name, the MoE spec
    as a dict), enough to rebuild the module for an exported artifact.
    ``remat`` and ``remat_policy`` act only in train mode with autograd on,
    ``dropout`` only in train mode. ``dropout`` defaults to 0, AST-Base's
    (the JAX ``ASTViT`` field defaults to 0.1; ``ASTModel`` and ``ASTMoE`` set it).
    """

    def __init__(self, num_classes: int = 50, emb_dim: int = 384, depth: int = 12,
                 num_heads: int = 6, patch_size: int = 16, patch_stride: int = 10,
                 overlap: int = 6, sample_rate: int = 44_100, f_dim: int = 128,
                 dtype: torch.dtype | str = torch.float32,
                 remat: bool = False, remat_policy: str = "full",
                 dropout: float = 0.0, moe: MoeSpec | dict | None = None,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        # The pos-embed grid is derived from (patch_size - overlap) while the
        # conv uses patch_stride; they must agree or positions are misassigned.
        if patch_stride != patch_size - overlap:
            raise ValueError(
                f"patch_stride ({patch_stride}) must equal patch_size - overlap "
                f"({patch_size - overlap}); the positional-embedding grid "
                "assumes it")
        _remat_context_fn(remat_policy)  # validates the policy
        dtype = _as_dtype(dtype)
        moe = as_moe_spec(moe)
        self.config = dict(
            num_classes=num_classes, emb_dim=emb_dim, depth=depth,
            num_heads=num_heads, patch_size=patch_size, patch_stride=patch_stride,
            overlap=overlap, sample_rate=sample_rate, f_dim=f_dim,
            dtype=str(dtype).removeprefix("torch."), remat=remat,
            remat_policy=remat_policy, dropout=dropout,
            moe=None if moe is None else dataclasses.asdict(moe))
        self.dtype = dtype
        self.dropout = dropout
        self.remat = remat
        self.remat_policy = remat_policy
        self.patch_stride = patch_stride
        t_dim = int(sample_rate * 10 / 160) + 1  # 10-s clip at hop 160
        self.grid_size = ((f_dim - patch_size) // patch_stride + 1,
                          (t_dim - patch_size) // patch_stride + 1)
        num_patches = self.grid_size[0] * self.grid_size[1]
        with torch.device("meta"):
            self.patch_embed = nn.Conv2d(1, emb_dim, patch_size, patch_stride)
            self.cls_token = nn.Parameter(torch.empty(1, 1, emb_dim))
            self.pos_embed = nn.Parameter(torch.empty(1, 1 + num_patches, emb_dim))
            self.blocks = nn.ModuleList(
                Block(emb_dim, num_heads, dropout=dropout, moe=moe) for _ in range(depth))
            self.norm = nn.LayerNorm(emb_dim, eps=LN_EPS)
            self.head = nn.Linear(emb_dim, num_classes)
        self.to_empty(device="cpu")
        self._init_weights(generator)
        if device is not None:
            self.to(device)
        self.eval()

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator | None) -> None:
        """Flax's inits: lecun-normal kernels (the experts' over their input
        axis, ``_expert_params``), zero biases, unit LN scales, zero CLS
        token, truncated-normal(0.02) positions."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                _lecun_normal_(m.weight, m.in_features, gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, MoeMlp):
                _lecun_normal_(m.wi, m.wi.shape[-2], gen)
                _lecun_normal_(m.wo, m.wo.shape[-2], gen)
                m.bi.zero_()
                m.bo.zero_()
            elif isinstance(m, nn.Conv2d):
                _lecun_normal_(m.weight, m.weight[0].numel(), gen)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        self.cls_token.zero_()
        _trunc_normal_(self.pos_embed, 0.02, gen)

    def embed(self, x: torch.Tensor) -> tuple[torch.Tensor, int]:
        """Patch embed + CLS + positions, padded to the 128 grain:
        (tokens (B, n_pad, D), n_real)."""
        if x.ndim == 4:
            x = x[:, 0]
        dt = self.dtype
        pe = self.patch_embed
        x = F.conv2d(x[:, None].to(dt), pe.weight.to(dt), pe.bias.to(dt),
                     stride=self.patch_stride)
        # (B, D, F', T') → tokens row-major over (F', T')
        x = x.flatten(2).transpose(1, 2)
        B, N, D = x.shape
        x = torch.cat([self.cls_token.to(dt).expand(B, 1, D), x], dim=1)
        x = x + self.pos_embed[:, :N + 1].to(dt)
        n_real = N + 1
        n_pad = -(-n_real // PAD_GRAIN) * PAD_GRAIN
        return F.pad(x, (0, 0, 0, n_pad - n_real)), n_real

    def finalize(self, x: torch.Tensor) -> torch.Tensor:
        """Final LN, the head in f32 on the CLS token, and the sigmoid."""
        cls = _layer_norm(x[:, 0], self.norm).float()
        return torch.sigmoid(F.linear(cls, self.head.weight, self.head.bias))

    def forward(self, x: torch.Tensor, attention: AttentionFn = fast_mha_lse,
                grouped_matmul: GroupedMatmulFn = gmm_op, topk: TopkFn = topk_routes,
                dropout_seed: int | None = None, return_aux: bool = False):
        """Sigmoid outputs (B, num_classes); with ``return_aux``, (outputs,
        aux, stats): the MoE blocks' summed aux loss (0.0 without MoE) and
        their mean ``MOE_METRICS`` stats ({} without MoE). ``attention``,
        ``grouped_matmul`` and ``topk`` replace the ops (plain versions for
        a reference run); ``dropout_seed`` seeds this call's dropout in
        train mode (drawn from torch's default generator when None)."""
        x, n_real = self.embed(x)
        remat = self.remat and self.training and torch.is_grad_enabled()
        context_fn = _remat_context_fn(self.remat_policy)
        seed = None
        if self.training and self.dropout > 0:
            seed = (int(torch.randint(2**62, ())) if dropout_seed is None
                    else int(dropout_seed))
        aux, stats = 0.0, []
        for i, blk in enumerate(self.blocks):
            args = (x, n_real, attention, grouped_matmul, topk,
                    None if seed is None else seed + i)
            if remat:
                x, a, s = checkpoint(blk, *args, use_reentrant=False, context_fn=context_fn)
            else:
                x, a, s = blk(*args)
            if a is not None:
                aux = aux + a
                stats.append(s)
        out = self.finalize(x)
        if not return_aux:
            return out
        means = dict(zip(MOE_METRICS, torch.stack(stats).mean(0).unbind())) if stats else {}
        return out, aux, means
