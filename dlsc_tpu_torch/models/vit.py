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
the JAX package's policies (``remat_kwargs``, ``vit.py:274-327``), each a
selective-checkpoint policy (``REMAT_POLICIES``) that keeps the outputs of
some ops and reruns the rest in the backward:

- ``'full'`` keeps nothing: the backward reruns the whole block, K2f
  included;
- ``'dots'`` keeps the outputs of the GEMMs without batch dims (``aten.mm``,
  ``aten.addmm``: every linear layer, the router, the MoE's bias products;
  not the ``bmm`` of dense attention): the backward reruns the elementwise
  ops and K2f;
- ``'attn_out'`` keeps the head-merged attention output, proj's input
  (``vit.py:141``): K2f reruns, as the splash kernel does under the JAX
  policy, since its backward needs q, k, v, out and lse;
- ``'attn_res'`` keeps each block's attention ``out`` and ``lse`` (the
  outputs of the ``dlsc_tpu_torch::mha`` op): the backward recomputes LN1 →
  qkv → q, k, v but does not launch K2f again;
- ``'attn_res_qkv'`` is ``'attn_res'`` plus the qkv GEMM's output
  (``vit.py:238-239`` names q, k and v): q, k and v rebuild from it by
  views, the scale and copies, and the qkv GEMM does not rerun;
- ``'attn_res_fc1'`` is ``'attn_res'`` plus fc1's GEMM output, before the
  GELU (``vit.py:636``): fc1 does not rerun;
- ``'attn_res_moe'`` is ``'attn_res'`` plus the MoE block's ``moe_res``
  (``models/moe.py``): the routing index tensors, the gate weights and the
  outputs of both ``dlsc_tpu_torch::gmm`` forwards, so the backward reruns
  neither grouped product's forward nor the sort.

The policies read the op and a tag that the module code sets around the
ops it names (``utils/remat.remat_tag``: ``'qkv'``, ``'attn_out'``, ``'fc1'``,
``'moe_res'``), only inside a checkpointed block (``_tagged``); elsewhere
the tags cost one shared no-op context. The recompute runs the same code,
so it sets the same tags and the policy sees the same op sequence in both
passes. Everything a policy does not keep reruns, the MoE's grouped
products included under every policy but ``'attn_res_moe'``.

MoE blocks (``moe=``, ``models/moe.py``) replace the dense MLP with the
routed experts; ``forward(..., return_aux=True)`` then also returns the
sum over blocks of the pre-weighted aux losses and the block means of the
MoE stats, carried through the checkpoints as block outputs. Dropout
(``dropout``, the MLP's or the experts') is a counter-based draw
(``ops/dropout_draw.py``) keyed by ``dropout_seed``, the block's index and
the mask's site, over the element's index in the unsplit tensor, so the
re-forward of a rematerialised block draws the same masks, and so does a
rank, a microbatch or a tensor-parallel slice of the one-process step.

Int8 serving (``quant``: ``'w8a8'`` or ``'w8'``, ``vit.py:210-271`` and
``:552-641``): qkv, proj, fc1 and fc2 compute through ``ops/quant.py``
(``int8_dot``: dynamic per-row int8 activations against int8 weights,
``torch._int_mm``; ``w8_dot``: int8 weights cast to the activation dtype,
f32 accumulation) from int8 buffers ``weight_q`` and ``weight_scale`` on
each of those layers, quantised from the float weights at construction and
by ``ops.quant.materialize`` after new weights are loaded. Inference only:
a forward in train mode raises, and so do an unknown mode and MoE blocks.
The attention stays on K2f and the patch embed and head in float.

``ln_fused`` (an argument, where the JAX package reads ``DLSC_LN_FUSED=1``,
``vit.py:648-659``) replaces each block's attention residual add and norm2,
dense and MoE blocks alike, by the fused op ``ops.ln_fused.add_ln``
(kernels K3f and K3b on the card, the plain versions on the CPU); the
parameters stay ``norm2.weight`` / ``norm2.bias``. In bf16 the fused path
takes norm2's statistics from the unrounded f32 sum, so it differs from the
unfused one by the rounding of the residual. The op is kept by no remat
policy: a rematerialised block runs K3f again.
``forward(..., add_ln=...)`` takes another function with its contract,
e.g. ``add_ln_reference`` for a plain run.

``attn_impl`` is the JAX package's choice of attention: ``'splash'`` (the
splash library kernel, or its shape-specialised fast path) and ``'flash'``
(the flash library kernel with segment ids) compute the same masked
attention on every row that reaches an output, so both run
``dlsc_tpu_torch::mha`` here; the flash path's 512-token pad grain
(``vit.py:529-530``) is a TPU block-size constraint that the port does not
carry over, and its pad rows (which attend pad keys there) are values that
nothing reads. ``'dense'`` is the JAX package's einsum branch
(``vit.py:132-140``), which it also takes in train mode whenever
``attn_dropout > 0`` (its kernels have no attention dropout): scores with
the pad keys masked, an f32 softmax, dropout on P under the block's
draw, then P·V (``dense_attention``, plain torch, as the JAX branch is
plain XLA).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts, noop_context_fn)

from dlsc_tpu_torch.models.layers import as_dtype, dtype_name, lecun_normal_, trunc_normal_
from dlsc_tpu_torch.models.moe import (MOE_METRICS, GroupedMatmulFn, MoeMlp, MoeSpec, TopkFn,
                                       as_moe_spec, topk_routes)
from dlsc_tpu_torch.ops.attn_fast import fast_mha_lse
from dlsc_tpu_torch.ops.dropout_draw import (SITE_ATTN, SITE_HIDDEN, SITE_OUT, Draw, Part,
                                             dropout, make_draw)
from dlsc_tpu_torch.ops.gmm import grouped_matmul as gmm_op
from dlsc_tpu_torch.ops.ln_fused import add_ln as add_ln_op
from dlsc_tpu_torch.ops.quant import QUANT_MODES, int8_dot, materialize, w8_dot
from dlsc_tpu_torch.utils.remat import current_tag, remat_tag, tagging

PAD_GRAIN = 128  # token padding grain of the attention kernel's layout
LN_EPS = 1e-6

AttentionFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, int],
                       tuple[torch.Tensor, torch.Tensor]]
# (x, delta, gamma, beta) -> (r, y, mu, rsig), as ops.ln_fused.add_ln
AddLnFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
                   tuple[torch.Tensor, ...]]

_MHA = torch.ops.dlsc_tpu_torch.mha.default
_GEMMS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})
# policy → (ops kept wherever they run, {tag: the ops kept under it, None for
# every op that is not a view}); 'full' keeps nothing
REMAT_POLICIES: dict[str, tuple[frozenset, dict] | None] = {
    "full": None,
    "dots": (_GEMMS, {}),
    "attn_out": (frozenset(), {"attn_out": None}),
    "attn_res": (frozenset({_MHA}), {}),
    "attn_res_qkv": (frozenset({_MHA}), {"qkv": _GEMMS}),
    "attn_res_fc1": (frozenset({_MHA}), {"fc1": _GEMMS}),
    "attn_res_moe": (frozenset({_MHA}), {"moe_res": None}),
}
# the JAX package's TPU kernels, both on dlsc_tpu_torch::mha, and its einsum branch
ATTN_IMPLS = ("splash", "flash", "dense")


def _remat_context_fn(policy: str) -> Callable:
    """``context_fn`` of ``torch.utils.checkpoint`` for a remat policy."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}; known: {tuple(REMAT_POLICIES)}")
    if REMAT_POLICIES[policy] is None:
        return noop_context_fn
    ops, tags = REMAT_POLICIES[policy]

    def keep(ctx, op, *args, **kwargs) -> CheckpointPolicy:
        tag = current_tag()
        kept = op in ops or (tag in tags and (op in tags[tag] if tags[tag] is not None
                                              else not op.is_view))
        return CheckpointPolicy.MUST_SAVE if kept else CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, keep)


def _tagged(blk: nn.Module, *args):
    """``blk(*args)`` with the remat tags on: the function that a checkpoint
    runs, in the forward and again in the recompute."""
    with tagging():
        return blk(*args)


def _check_attention(attn_impl: str, attn_dropout: float) -> None:
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r}; known: {ATTN_IMPLS}")
    if not 0.0 <= attn_dropout < 1.0:
        raise ValueError(f"attn_dropout {attn_dropout} is not in [0, 1)")


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_real: int,
                    rate: float = 0.0, draw: Draw | None = None,
                    part: Part | None = None) -> torch.Tensor:
    """Masked softmax attention on (B, H, N, dh), q pre-scaled: keys >=
    ``n_real`` masked, softmax in f32, P cast to q's dtype, dropout on P
    (``rate``, masks from ``draw``; none when ``draw`` is None; ``part``: the
    heads of a tensor-parallel rank, ``ops.dropout_draw.dropout``), then P·V."""
    s = torch.matmul(q, k.transpose(-1, -2))
    n = k.shape[2]
    if n_real < n:
        s = s.masked_fill(torch.arange(n, device=s.device) >= n_real, -1e30)
    p = dropout(torch.softmax(s.float(), dim=-1).to(q.dtype), rate, draw, SITE_ATTN,
                part=part)
    return torch.matmul(p, v)


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LN with f32 statistics, output in the input's dtype (Flax LayerNorm)."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        LN_EPS).to(x.dtype)


def _linear(x: torch.Tensor, layer: nn.Linear, quant: str | None = None) -> torch.Tensor:
    """Dense in the input's dtype (Flax Dense with ``dtype``); with ``quant``
    through the layer's int8 buffers (``_QDense``, ``vit.py:553-580``)."""
    if quant is None:
        return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))
    dot = int8_dot if quant == "w8a8" else w8_dot
    return dot(x, layer.weight_q, layer.weight_scale, x.dtype) + layer.bias.to(x.dtype)


def _quant_buffers(layer: nn.Linear) -> None:
    """The int8 weight and its per-output-channel scale, beside the float
    weight (``materialize`` fills them)."""
    layer.register_buffer("weight_q", torch.zeros(layer.weight.shape, dtype=torch.int8))
    layer.register_buffer("weight_scale", torch.zeros(layer.out_features))


class Attention(nn.Module):
    """Packed-qkv attention; ``impl`` 'dense' (or dropout in train mode:
    ``draw`` given and ``rate`` > 0) takes ``dense_attention``, any other
    the ``attention`` op. ``quant``: qkv and proj through int8. Tensor
    parallelism's subclass (``parallel/tp.py``) runs a rank's heads: it
    overrides ``project_in`` and ``project_out`` (the products and their
    collectives) and ``part``, the part of the unsplit attention
    probabilities whose dropout masks this module draws (None: all of
    them)."""

    part: Part | None = None

    def __init__(self, dim: int, num_heads: int, impl: str = "splash", rate: float = 0.0,
                 quant: str | None = None):
        super().__init__()
        self.num_heads = num_heads
        self.impl, self.rate, self.quant = impl, rate, quant
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        if quant:
            _quant_buffers(self.qkv)
            _quant_buffers(self.proj)

    def forward(self, x: torch.Tensor, n_real: int, attention: AttentionFn,
                draw: Draw | None = None) -> torch.Tensor:
        H = self.num_heads
        with remat_tag("qkv"):
            qkv = self.project_in(x)
        B, N, D3 = qkv.shape
        dh = D3 // (3 * H)
        qkv = qkv.view(B, N, 3, H, dh).permute(2, 0, 3, 1, 4)
        q = (qkv[0] * dh**-0.5).contiguous()  # pre-scaled, the kernel's contract
        if self.impl == "dense" or (draw is not None and self.rate > 0):
            out = dense_attention(q, qkv[1], qkv[2], n_real, self.rate, draw, self.part)
        else:
            out, _ = attention(q, qkv[1].contiguous(), qkv[2].contiguous(), n_real)
        with remat_tag("attn_out"):
            out = out.transpose(1, 2).reshape(B, N, H * dh)
        return self.project_out(out)

    def project_in(self, x: torch.Tensor) -> torch.Tensor:
        """The packed qkv product."""
        return _linear(x, self.qkv, self.quant)

    def project_out(self, x: torch.Tensor) -> torch.Tensor:
        """The output projection."""
        return _linear(x, self.proj, self.quant)


class Mlp(nn.Module):
    """fc1 → GELU → dropout → fc2 → dropout. With ``hyper`` the dropout
    rate is the f32 buffer ``hyper_rate`` (``HyperDropout``,
    ``dlsc_tpu/models/vit.py:582-615``): a trial's rate, which the vmapped
    HPO step stacks per trial, read as a tensor (see
    ``ops.dropout_draw.dropout``).
    Tensor parallelism's subclass (``parallel/tp.py``) overrides
    ``project_in`` and ``project_out`` and the parts of the unsplit hidden
    units (``hidden_part``) and output (``out_part``) whose dropout masks
    this module draws (None: all of them)."""

    hidden_part: Part | None = None
    out_part: Part | None = None

    def __init__(self, dim: int, ratio: float = 4.0, dropout: float = 0.0,
                 quant: str | None = None, hyper: bool = False):
        super().__init__()
        self.rate, self.quant = dropout, quant
        self.fc1 = nn.Linear(dim, int(dim * ratio))
        self.fc2 = nn.Linear(int(dim * ratio), dim)
        if quant:
            _quant_buffers(self.fc1)
            _quant_buffers(self.fc2)
        if hyper:
            self.register_buffer("hyper_rate", torch.tensor(float(dropout)))

    def forward(self, x: torch.Tensor, draw: Draw | None = None) -> torch.Tensor:
        rate = getattr(self, "hyper_rate", self.rate)
        with remat_tag("fc1"):
            h = self.project_in(x)
        h = dropout(F.gelu(h), rate, draw, SITE_HIDDEN, part=self.hidden_part)
        return dropout(self.project_out(h), rate, draw, SITE_OUT, part=self.out_part)

    def project_in(self, x: torch.Tensor) -> torch.Tensor:
        """fc1."""
        return _linear(x, self.fc1, self.quant)

    def project_out(self, x: torch.Tensor) -> torch.Tensor:
        """fc2."""
        return _linear(x, self.fc2, self.quant)


class Block(nn.Module):
    """Pre-LN block; the MLP is ``Mlp``, or ``MoeMlp`` (``self.moe``) when
    ``moe`` is given; with ``ln_fused`` the attention residual add and
    norm2 are one ``add_ln`` call. ``forward`` returns (x, aux, stats), aux
    and stats None for a dense block; ``draw`` (None: no dropout) keys the
    block's dropout masks."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dropout: float = 0.0, moe: MoeSpec | None = None, ln_fused: bool = False,
                 attn_impl: str = "splash", attn_dropout: float = 0.0,
                 quant: str | None = None, hyper_dropout: bool = False):
        super().__init__()
        self.ln_fused = ln_fused
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, attn_impl, attn_dropout, quant)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        if moe is None:
            self.mlp = Mlp(dim, mlp_ratio, dropout, quant, hyper_dropout)
        else:
            self.moe = MoeMlp(dim, moe, mlp_ratio, dropout)

    def forward(self, x: torch.Tensor, n_real: int, attention: AttentionFn,
                grouped_matmul: GroupedMatmulFn = gmm_op, topk: TopkFn = topk_routes,
                draw: Draw | None = None, add_ln: AddLnFn = add_ln_op):
        a = self.attn(_layer_norm(x, self.norm1), n_real, attention, draw)
        if self.ln_fused:
            x, y, _, _ = add_ln(x, a, self.norm2.weight, self.norm2.bias)
        else:
            x = x + a
            y = _layer_norm(x, self.norm2)
        if not hasattr(self, "moe"):
            return x + self.mlp(y, draw), None, None
        out, aux, stats = self.moe(y, n_real, grouped_matmul, topk, draw)
        return x + out, aux, stats


class ASTViT(nn.Module):
    """AST trunk; ``forward(features) -> sigmoid(head(CLS))`` of shape
    (B, num_classes) f32. ``features``: (B, n_mels, T) or (B, 1, n_mels, T).

    ``config`` holds the constructor arguments (dtype by name, the MoE spec
    as a dict), enough to rebuild the module for an exported artifact.
    ``remat`` and ``remat_policy`` act only in train mode with autograd on,
    ``dropout`` only in train mode. ``dropout`` defaults to 0, AST-Base's
    (the JAX ``ASTViT`` field defaults to 0.1; the model factories set it).
    ``ln_fused``, ``attn_impl`` and ``quant``: see the module docstring.
    ``hyper_dropout`` (the vmapped HPO's per-trial dropout) gives each dense
    block's MLP a ``hyper_rate`` buffer, its dropout rate as a tensor
    (``Mlp``), which draws masks in train mode even at rate 0; off, nothing
    changes.
    """

    def __init__(self, num_classes: int = 50, emb_dim: int = 384, depth: int = 12,
                 num_heads: int = 6, patch_size: int = 16, patch_stride: int = 10,
                 overlap: int = 6, sample_rate: int = 44_100, f_dim: int = 128,
                 dtype: torch.dtype | str = torch.float32,
                 remat: bool = False, remat_policy: str = "full",
                 dropout: float = 0.0, moe: MoeSpec | dict | None = None,
                 ln_fused: bool = False, attn_impl: str = "splash",
                 attn_dropout: float = 0.0, quant: str | None = None,
                 hyper_dropout: bool = False,
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
        _check_attention(attn_impl, attn_dropout)
        dtype = as_dtype(dtype)
        moe = as_moe_spec(moe)
        if quant not in (None, *QUANT_MODES):
            raise ValueError(f"unknown quant mode {quant!r} (supported: {QUANT_MODES})")
        if quant and moe is not None:
            raise ValueError("int8 quant mode does not support MoE blocks")
        self.config = dict(
            num_classes=num_classes, emb_dim=emb_dim, depth=depth,
            num_heads=num_heads, patch_size=patch_size, patch_stride=patch_stride,
            overlap=overlap, sample_rate=sample_rate, f_dim=f_dim,
            dtype=dtype_name(dtype), remat=remat,
            remat_policy=remat_policy, dropout=dropout,
            moe=None if moe is None else dataclasses.asdict(moe), ln_fused=ln_fused,
            attn_impl=attn_impl, attn_dropout=attn_dropout, quant=quant,
            hyper_dropout=hyper_dropout)
        self.dtype = dtype
        self.hyper_dropout = hyper_dropout
        self.quant = quant
        self.dropout = dropout
        self.attn_dropout = attn_dropout
        self.remat = remat
        self.remat_policy = remat_policy
        # sequence parallelism (parallel/tp.py) sets a ``TokenShard``, whose
        # scatter and gather cut the tokens between embed and the blocks and
        # join them before finalize (the JAX model's ``token_sharding``)
        self.token_shard = None
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
                Block(emb_dim, num_heads, dropout=dropout, moe=moe, ln_fused=ln_fused,
                      attn_impl=attn_impl, attn_dropout=attn_dropout, quant=quant,
                      hyper_dropout=hyper_dropout)
                for _ in range(depth))
            self.norm = nn.LayerNorm(emb_dim, eps=LN_EPS)
            self.head = nn.Linear(emb_dim, num_classes)
        self.to_empty(device="cpu")
        self._init_weights(generator)
        if quant:
            materialize(self)
        if device is not None:
            self.to(device)
        self.eval()

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator | None) -> None:
        """Flax's inits: lecun-normal kernels (the experts' over their input
        axis, ``_expert_params``), zero biases, unit LN scales, zero CLS
        token, truncated-normal(0.02) positions; a ``hyper_rate`` the
        configured dropout."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                lecun_normal_(m.weight, m.in_features, gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, MoeMlp):
                lecun_normal_(m.wi, m.wi.shape[-2], gen)
                lecun_normal_(m.wo, m.wo.shape[-2], gen)
                m.bi.zero_()
                m.bo.zero_()
            elif isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, m.weight[0].numel(), gen)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, Mlp) and hasattr(m, "hyper_rate"):
                m.hyper_rate.fill_(m.rate)
        self.cls_token.zero_()
        trunc_normal_(self.pos_embed, 0.02, gen)

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

    def dropout_seed(self, dropout_seed: int | torch.Tensor | None
                     ) -> int | torch.Tensor | None:
        """The step's dropout seed in train mode when something drops (drawn
        from torch's default generator when not given; a tensor, a trial's
        seed under the vmapped HPO step, as it is), else None."""
        if self.training and (self.hyper_dropout or self.dropout > 0 or self.attn_dropout > 0):
            if dropout_seed is None:
                return int(torch.randint(2**62, ()))
            return dropout_seed if torch.is_tensor(dropout_seed) else int(dropout_seed)
        return None

    def run_block(self, i: int, x: torch.Tensor, n_real: int, attention: AttentionFn,
                  grouped_matmul: GroupedMatmulFn, topk: TopkFn,
                  seed: int | torch.Tensor | None, add_ln: AddLnFn,
                  rows: tuple[int, int] | None):
        """Block ``i`` on x, rematerialised as the model is configured (train
        mode with autograd on); its dropout masks keyed by (seed, i) and x's
        rows of the global batch (``rows`` = (start, total))."""
        blk = self.blocks[i]
        args = (x, n_real, attention, grouped_matmul, topk,
                make_draw(seed, rows, x.shape[0], block=i), add_ln)
        if self.remat and self.training and torch.is_grad_enabled():
            return checkpoint(_tagged, blk, *args, use_reentrant=False,
                              context_fn=_remat_context_fn(self.remat_policy))
        return blk(*args)

    def forward(self, x: torch.Tensor, attention: AttentionFn = fast_mha_lse,
                grouped_matmul: GroupedMatmulFn = gmm_op, topk: TopkFn = topk_routes,
                dropout_seed: int | None = None, return_aux: bool = False,
                add_ln: AddLnFn = add_ln_op, rows: tuple[int, int] | None = None):
        """Sigmoid outputs (B, num_classes); with ``return_aux``, (outputs,
        aux, stats): the MoE blocks' summed aux loss (0.0 without MoE) and
        their mean ``MOE_METRICS`` stats ({} without MoE). ``attention``,
        ``grouped_matmul``, ``topk`` and ``add_ln`` (read with ``ln_fused``)
        replace the ops (plain versions for a reference run);
        ``dropout_seed`` seeds this call's dropout in train mode (drawn from
        torch's default generator when None). ``rows`` = (start, total):
        x is the rows [start, start + B) of a global batch of ``total``
        (a data-parallel rank's share, a microbatch), whose dropout masks
        it draws (``ops.dropout_draw.Draw``). Under sequence parallelism
        (``parallel/tp.py``) ``token_shard`` cuts the tokens between embed
        and the blocks and gathers them back before ``finalize``."""
        if self.quant and self.training:
            raise ValueError("quant mode is inference-only: call model.eval() first")
        x, n_real = self.embed(x)
        shard = self.token_shard
        if shard is not None:
            x = shard.scatter(x)
        seed = self.dropout_seed(dropout_seed)
        aux, stats = 0.0, []
        for i in range(len(self.blocks)):
            x, a, s = self.run_block(i, x, n_real, attention, grouped_matmul, topk, seed,
                                     add_ln, rows)
            if a is not None:
                aux = aux + a
                stats.append(s)
        if shard is not None:
            x = shard.gather(x)
        out = self.finalize(x)
        if not return_aux:
            return out
        means = dict(zip(MOE_METRICS, torch.stack(stats).mean(0).unbind())) if stats else {}
        return out, aux, means


def quantize_model(model: ASTViT, mode: str) -> ASTViT:
    """``model`` rebuilt in the int8 serving mode ``mode`` (remat off, eval
    mode) with its weights, the int8 buffers materialised from them, as
    ``scripts/export.py:86-113`` rebuilds a Flax model with ``quant``."""
    q = ASTViT(**{**model.config, "quant": mode, "remat": False})
    missing, unexpected = q.load_state_dict(model.state_dict(), strict=False)
    if unexpected or not all(k.endswith((".weight_q", ".weight_scale")) for k in missing):
        raise ValueError(f"quantize_model: state dict mismatch, missing {missing[:4]}, "
                         f"unexpected {unexpected[:4]}")
    return materialize(q.to(next(model.parameters()).device))
