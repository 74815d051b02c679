"""AST-MoE: the AST-Small ViT trunk with mixture-of-experts MLPs.

Counterpart of ``dlsc_tpu/models/ast_moe.py`` ``ASTMoE``: the trunk of
AST-Small (patch 16, stride 16, 384 wide, 12 blocks, 6 heads) in which
every block's MLP is a top-k routed mixture of experts (``models/moe.py``),
dropless ragged dispatch on kernel K4. ``configs/model/ast_moe.yaml`` passes
its arguments. Only ``router='token'`` with ``dispatch='ragged'`` is ported:
any other pair raises, and ``router='expert'`` with ``dispatch='ragged'``
raises ``ValueError`` as ``MoeSpec`` does (the JAX ``ASTMoE`` rewrites it to
``einsum``, ``ast_moe.py:78``). ``attn_impl`` and ``attn_dropout`` are
taken as ``ASTViT`` takes them ('splash' and 'flash' both run K2; 'dense'
and attention dropout raise), and ``ln_fused`` puts kernel K3 in every
block; the mesh option ``expert_sharding`` waits for multi-GPU (M12).
"""

from __future__ import annotations

import torch

from dlsc_tpu_torch.models.moe import MoeSpec
from dlsc_tpu_torch.models.vit import ASTViT


def ASTMoE(
    num_classes: int = 50,
    sample_rate: int = 44_100,
    patch_size: int = 16,
    patch_stride: int = 16,
    overlap: int = 0,
    emb_dim: int = 384,
    depth: int = 12,
    num_heads: int = 6,
    f_dim: int = 128,
    n_experts: int = 8,
    top_k: int = 2,
    capacity_factor: float = 1.25,
    aux_weight: float = 1e-2,
    router_z_weight: float = 1e-3,
    router: str = "token",
    dispatch: str = "ragged",
    group_size: int = 256,
    dtype: torch.dtype | str = torch.bfloat16,
    attn_impl: str = "splash",
    attn_dropout: float = 0.0,
    remat: bool = True,
    remat_policy: str = "attn_res",
    ln_fused: bool = False,
    device: torch.device | str | None = None,
    generator: torch.Generator | None = None,
) -> ASTViT:
    """``ASTViT`` with an MoE spec in every block, with the JAX ``ASTMoE``'s
    defaults (dropout 0.1, remat ``attn_res``, bf16) plus ``ln_fused``,
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
        dtype=dtype,
        remat=remat,
        remat_policy=remat_policy,
        dropout=0.1,   # fixed, as in the JAX ASTMoE
        moe=MoeSpec(n_experts=n_experts, top_k=top_k, capacity_factor=capacity_factor,
                    aux_weight=aux_weight, router_z_weight=router_z_weight, router=router,
                    dispatch=dispatch, group_size=group_size),
        ln_fused=ln_fused,
        attn_impl=attn_impl,
        attn_dropout=attn_dropout,
        device=device,
        generator=generator,
    )
