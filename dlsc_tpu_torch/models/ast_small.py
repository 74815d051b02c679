"""AST-Small: the from-scratch ViT (384 wide, 12 blocks, 6 heads) on log-mel
patches.

Counterpart of ``dlsc_tpu/models/ast_small.py`` ``ASTViTSmall``, with its
arguments and defaults (``ast_small.py:17-36``): patch 16 with stride 10 and
overlap 6 (``configs/model/ast_small.yaml`` passes stride 16, overlap 0:
689 tokens at 5 s, padded to 768), MLP dropout fixed at 0.1, bf16, remat
``attn_res``. ``attn_impl`` and ``attn_dropout`` as ``ASTViT`` takes them;
``ln_fused`` puts kernel K3 in every block. The int8 ``quant`` serving mode
waits for M11.
"""

from __future__ import annotations

import torch

from dlsc_tpu_torch.models.vit import ASTViT


def ASTViTSmall(
    num_classes: int = 50,
    sample_rate: int = 44_100,
    patch_size: int = 16,
    patch_stride: int = 10,
    overlap: int = 6,
    emb_dim: int = 384,
    depth: int = 12,
    num_heads: int = 6,
    f_dim: int = 128,
    dtype: torch.dtype | str = torch.bfloat16,
    attn_impl: str = "splash",
    attn_dropout: float = 0.0,
    remat: bool = True,
    remat_policy: str = "attn_res",
    ln_fused: bool = False,
    device: torch.device | str | None = None,
    generator: torch.Generator | None = None,
) -> ASTViT:
    """``ASTViT`` with the JAX ``ASTViTSmall``'s defaults plus ``ln_fused``,
    ``device`` and the init ``generator``."""
    return ASTViT(
        num_classes=num_classes,
        emb_dim=emb_dim,
        depth=depth,
        num_heads=num_heads,
        patch_size=patch_size,
        patch_stride=patch_stride,
        overlap=overlap,
        sample_rate=sample_rate,
        f_dim=f_dim,
        dropout=0.1,   # fixed, as in the JAX ASTViTSmall
        dtype=dtype,
        attn_impl=attn_impl,
        attn_dropout=attn_dropout,
        remat=remat,
        remat_policy=remat_policy,
        ln_fused=ln_fused,
        device=device,
        generator=generator,
    )
