"""AST-Mini: the from-scratch ViT (192 wide, 6 blocks, 3 heads) on log-mel
patches.

Counterpart of ``dlsc_tpu/models/ast_mini.py`` ``ASTMiniViT``, with its
arguments and defaults (``ast_mini.py:16-28``): patch 16, stride 10, overlap
6 (``configs/model/ast_mini.yaml`` keeps them: 1645 tokens at 5 s, padded to
1664), MLP dropout fixed at 0.1, bf16, no remat. ``ln_fused`` puts kernel K3
in every block. The int8 ``quant`` serving mode waits for M11.
"""

from __future__ import annotations

import torch

from dlsc_tpu_torch.models.vit import ASTViT


def ASTMiniViT(
    num_classes: int = 50,
    sample_rate: int = 44_100,
    patch_size: int = 16,
    patch_stride: int = 10,
    overlap: int = 6,
    emb_dim: int = 192,
    depth: int = 6,
    num_heads: int = 3,
    f_dim: int = 128,
    dtype: torch.dtype | str = torch.bfloat16,
    ln_fused: bool = False,
    device: torch.device | str | None = None,
    generator: torch.Generator | None = None,
) -> ASTViT:
    """``ASTViT`` with the JAX ``ASTMiniViT``'s defaults plus ``ln_fused``,
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
        dropout=0.1,   # fixed, as in the JAX ASTMiniViT
        dtype=dtype,
        ln_fused=ln_fused,
        device=device,
        generator=generator,
    )
