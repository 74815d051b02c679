"""AST-Base: the ViT-Base trunk on log-mel patches.

Counterpart of ``dlsc_tpu/models/ast.py`` ``ASTModel``: the deit variant
name picks the trunk dims; explicit ``emb_dim``/``depth``/``num_heads``
override it. No pretrained weights are loaded here: weights come from a
seeded init (``generator``) or from a JAX checkpoint through
``models.convert.params_from_jax``.
"""

from __future__ import annotations

import torch

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
    ln_fused: bool = False,
    device: torch.device | str | None = None,
    generator: torch.Generator | None = None,
) -> ASTViT:
    """AST over a deit ViT trunk, with the arguments ``configs/model/ast.yaml``
    passes plus ``dtype``, the remat settings (the JAX defaults,
    ``dlsc_tpu/models/ast.py:56-60``), ``attn_impl``, ``ln_fused`` (see
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
        ln_fused=ln_fused,
        device=device,
        generator=generator,
    )
