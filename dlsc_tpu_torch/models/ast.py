"""AST-Base: the ViT-Base trunk on log-mel patches, and the timm/DeiT weight
import.

Counterpart of ``dlsc_tpu/models/ast.py``: ``ASTModel`` (the deit variant
name picks the trunk dims; explicit ``emb_dim``/``depth``/``num_heads``
override it; weights from a seeded init, ``generator``), and
``load_torch_vit`` with ``interpolate_pos_embed`` (:108-277), which map a
timm ViT/DeiT state dict onto the port's model with the reference's AST
recipe (reference src/models/ast.py:30-48):

- the RGB patch conv channel-meaned into the 1-channel conv;
- the CLS token copied; a distilled DeiT's dist token and its position
  dropped, ``head_dist.*`` ignored;
- the positional table's patch grid resized bilinearly to the audio grid,
  the CLS slot kept. ``F.interpolate(..., antialias=True)``, as
  ``jax.image.resize(..., "bilinear")`` antialiases by default: the two
  agree where the grid shrinks (a DeiT-384 table's 24 rows to AST's 12),
  where the reference's ``F.interpolate(align_corners=False)`` does not
  (ROADMAP §3);
- the blocks and the final norm copied: the port's keys are timm's;
- ``model.`` / ``module.`` key prefixes stripped; with ``strict`` a key
  that is neither taken nor a known discard (the classifier heads) raises;
  ``audit`` collects the conversion report of ``scripts/import_vit.py``.

The head stays as the model holds it (the reference re-initialises it for
the audio task). Nothing is downloaded: the state dict comes from a file on
disk (``dlsc_tpu_torch/scripts/import_vit.py``) or from memory.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from dlsc_tpu_torch.models.vit import ASTViT

# deit variant name → ViT trunk dims (emb_dim, depth, num_heads)
_DEIT_VARIANTS: dict[str, tuple[int, int, int]] = {
    "deit_tiny_patch16_224": (192, 12, 3),
    "deit_small_patch16_224": (384, 12, 6),
    "deit_base_patch16_224": (768, 12, 12),
    "deit_base_patch16_384": (768, 12, 12),
}


def ASTModel(
    num_classes: int = 50,
    sample_rate: int = 44_100,
    patch_size: int = 16,
    patch_stride: int = 10,
    overlap: int = 6,
    pretrained_model: str = "deit_base_patch16_384",
    emb_dim: int | None = None,
    depth: int | None = None,
    num_heads: int | None = None,
    dtype: torch.dtype | str = torch.bfloat16,
    remat: bool = True,               # ViT-Base at ~1650 tokens: remat blocks
    remat_policy: str = "attn_res",   # keep attention out + lse: the backward
                                      # does not rerun the forward kernel
    attn_impl: str = "splash",
    quant: str | None = None,
    ln_fused: bool = False,
    device: torch.device | str | None = None,
    generator: torch.Generator | None = None,
) -> ASTViT:
    """AST over a deit ViT trunk, with the arguments ``configs/model/ast.yaml``
    passes plus ``dtype``, the remat settings (the JAX defaults,
    ``dlsc_tpu/models/ast.py:56-60``), ``attn_impl``, the int8 serving mode
    ``quant`` (``'w8a8'``, ``'w8'``; inference only), ``ln_fused`` (see
    ``models/vit.py``), ``device`` and the init ``generator``."""
    var = _DEIT_VARIANTS.get(pretrained_model)
    if var is None and (emb_dim is None or depth is None or num_heads is None):
        raise ValueError(
            f"unknown pretrained_model {pretrained_model!r}; known variants: "
            f"{sorted(_DEIT_VARIANTS)} (or pass emb_dim/depth/num_heads "
            "explicitly)")
    v_emb, v_depth, v_heads = var if var is not None else (None, None, None)
    return ASTViT(
        num_classes=num_classes,
        emb_dim=v_emb if emb_dim is None else emb_dim,
        depth=v_depth if depth is None else depth,
        num_heads=v_heads if num_heads is None else num_heads,
        patch_size=patch_size,
        patch_stride=patch_stride,
        overlap=overlap,
        sample_rate=sample_rate,
        f_dim=128,
        dtype=dtype,
        remat=remat,
        remat_policy=remat_policy,
        attn_impl=attn_impl,
        quant=quant,
        ln_fused=ln_fused,
        device=device,
        generator=generator,
    )


def interpolate_pos_embed(pos_embed: np.ndarray, old_grid: tuple[int, int],
                          new_grid: tuple[int, int]) -> np.ndarray:
    """Bilinear 2-D resize of a (1, 1 + h·w, D) positional table's patch grid
    from ``old_grid`` to ``new_grid``, the CLS slot kept: half-pixel
    centres (``align_corners=False``) and, where an axis shrinks, the
    triangle kernel widened by the scale (``antialias=True``), as the JAX
    function's ``jax.image.resize``. f32 numpy in and out."""
    pos_embed = np.asarray(pos_embed, np.float32)
    cls, patch = pos_embed[:, :1], pos_embed[:, 1:]
    D = patch.shape[-1]
    grid = torch.from_numpy(np.ascontiguousarray(patch.reshape(1, *old_grid, D)))
    resized = F.interpolate(grid.permute(0, 3, 1, 2), size=tuple(new_grid), mode="bilinear",
                            align_corners=False, antialias=True)
    resized = resized.permute(0, 2, 3, 1).reshape(1, -1, D).numpy()
    return np.concatenate([cls, resized], axis=1)


# timm keys that a ViT/DeiT checkpoint carries and AST discards: the image
# classifier heads (reference src/models/ast.py:49 replaces the head)
_IGNORED_TIMM_KEYS = frozenset({
    "head.weight", "head.bias",
    "head_dist.weight", "head_dist.bias",
    "pre_logits.fc.weight", "pre_logits.fc.bias",
})
# per-block timm keys; the port's module names are timm's
_BLOCK_KEYS = ("norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.qkv.bias",
               "attn.proj.weight", "attn.proj.bias", "norm2.weight", "norm2.bias",
               "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias")


def load_torch_vit(state_dict: Mapping, model: ASTViT, strict: bool = True,
                   audit: dict | None = None) -> dict[str, torch.Tensor]:
    """``model``'s state dict with a timm ViT/DeiT ``state_dict`` mapped onto
    it by the AST recipe (see the module docstring); the entries the recipe
    does not set (the head, int8 buffers) are the model's own. Values may
    be tensors or numpy arrays. Raises ``KeyError`` for a missing key,
    ``ValueError`` for a non-square source grid, a shape mismatch or, with
    ``strict``, a key left over. ``audit``, when given, receives the
    conversion report: the source key count, the consumed, ignored and
    leftover keys, a note per transform, the target's entry count and its
    block layout."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    for prefix in ("model.", "module."):
        if sd and all(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items()}
    out = {k: v.detach().clone() for k, v in model.state_dict().items()}
    consumed: set[str] = set()

    def take(key: str) -> np.ndarray:
        if key not in sd:
            raise KeyError(f"timm state dict is missing {key!r} — not a ViT/DeiT layout? "
                           f"sample keys: {sorted(sd)[:6]}")
        consumed.add(key)
        return sd[key]

    def put(key: str, val: np.ndarray) -> None:
        if tuple(out[key].shape) != val.shape:
            raise ValueError(f"{key}: source shape {val.shape} vs model "
                             f"{tuple(out[key].shape)}")
        out[key] = torch.tensor(val, dtype=out[key].dtype)

    notes: list[str] = []
    w_src = take("patch_embed.proj.weight")
    w = w_src.mean(axis=1, keepdims=True)
    notes.append(f"patch_embed.proj.weight {w_src.shape} -> channel-mean over "
                 f"{w_src.shape[1]} input channels -> {w.shape} (reference "
                 "src/models/ast.py:30-33)")
    put("patch_embed.weight", w)
    put("patch_embed.bias", take("patch_embed.proj.bias"))
    put("cls_token", take("cls_token"))
    n_prefix = 1   # tokens ahead of the patch grid: [cls], or [cls, dist] (distilled)
    if "dist_token" in sd:
        consumed.add("dist_token")
        n_prefix = 2
    pe = take("pos_embed")
    old_n = pe.shape[1] - n_prefix
    old_side = int(round(old_n**0.5))
    if old_side * old_side != old_n:
        raise ValueError(f"pos_embed has {old_n} patch positions after {n_prefix} prefix "
                         "token(s) — not a square grid; non-square source grids are "
                         "unsupported")
    new_pos = interpolate_pos_embed(np.concatenate([pe[:, :1], pe[:, n_prefix:]], axis=1),
                                    (old_side, old_side), model.grid_size)
    notes.append(f"pos_embed {pe.shape} ({n_prefix} prefix token(s), {old_side}x{old_side} "
                 f"grid) -> bilinear 2-D interpolation -> {new_pos.shape} (audio grid "
                 f"{model.grid_size[0]}x{model.grid_size[1]}; reference "
                 "src/models/ast.py:42-48)")
    put("pos_embed", new_pos)
    for i in range(len(model.blocks)):
        for key in _BLOCK_KEYS:
            put(f"blocks.{i}.{key}", take(f"blocks.{i}.{key}"))
    put("norm.weight", take("norm.weight"))
    put("norm.bias", take("norm.bias"))

    leftover = set(sd) - consumed - _IGNORED_TIMM_KEYS
    if audit is not None:
        audit.update({
            "n_source_keys": len(sd),
            "consumed": sorted(consumed),
            "ignored": sorted(set(sd) & _IGNORED_TIMM_KEYS),
            "leftover": sorted(leftover),
            "notes": notes,
            "n_target_leaves": len(out),
            "layout": "unrolled",
        })
    if leftover and strict:
        raise ValueError(f"unconsumed keys in timm state dict (unexpected layout): "
                         f"{sorted(leftover)}")
    return out


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v)
