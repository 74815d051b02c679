"""Model-FLOPs utilisation of the ViT train step.

Counterpart of ``dlsc_tpu/utils/mfu.py``, with two numbers so that the gap
between them shows:

- **useful**: matmul/conv FLOPs at the real token count (no pad rows, no
  remat recompute), with the standard backward multipliers: parameter
  matmuls x3 (forward, dW, dx), attention x3.5 (4·n²·D forward, 10·n²·D
  backward: the score recompute, dV, dP, dQ, dK);
- **hardware**: the FLOPs scheduled, at the padded token count, plus one
  re-forward of the per-block parameter matmuls when the blocks are
  rematerialised (``attn_res`` keeps the attention output and lse, so
  attention itself is not recomputed).

MoE blocks (AST-MoE) count, in place of the dense MLP, top_k × the two
expert products per real token plus the router (2·D·E per token): the
dropless dispatch runs the experts on the real tokens' rows only, so their
FLOPs are at n_real in both numbers. LN, GELU, softmax, the routing sort
and the gathers are in neither. ``peak_tflops`` is the card's
dense bf16 tensor-core peak, by ``torch.cuda.get_device_name``; an unknown
card raises rather than borrowing another card's peak.
"""

from __future__ import annotations

import dataclasses

from dlsc_tpu_torch.models.vit import PAD_GRAIN

# dense bf16 tensor-core TFLOP/s by the name the SXM part reports (NVIDIA data
# sheet, 700 W); the PCIe and NVL H100 parts have other peaks and raise
_PEAK_BF16_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.0}


def peak_tflops(device_name: str) -> float:
    """Dense bf16 peak TFLOP/s of the card named ``device_name``."""
    try:
        return _PEAK_BF16_TFLOPS[device_name]
    except KeyError:
        raise ValueError(f"no bf16 peak known for {device_name!r}; known: "
                         f"{list(_PEAK_BF16_TFLOPS)}") from None


@dataclasses.dataclass(frozen=True)
class StepFlops:
    """Per-sample FLOP totals for one optimizer step."""

    useful: float      # real tokens, forward + backward, no remat
    hardware: float    # padded tokens + remat re-forward
    fwd_useful: float  # real tokens, forward only (serving)


def vit_step_flops(*, n_real: int, n_pad: int, emb_dim: int, depth: int,
                   mlp_ratio: float = 4.0, patch_pixels: int = 16 * 16,
                   num_classes: int = 50, remat_refwd: bool = True,
                   moe_top_k: int = 0, n_experts: int = 0) -> StepFlops:
    """Per-sample matmul/conv FLOPs: patch embed ``(n-1)·patch_pixels·D·2``;
    per block qkv + proj ``4·D²·2`` per token, the MLP ``2·mlp_ratio·D²·2``
    per token (MoE, ``moe_top_k`` > 0: ``moe_top_k`` times that plus the
    router's ``2·D·n_experts``, at n_real) and attention ``4·n²·D``; the
    head ``D·num_classes·2``."""
    D = float(emb_dim)
    mlp_per_tok = 2.0 * mlp_ratio * D * D * 2.0
    if moe_top_k:
        mlp_per_tok = moe_top_k * mlp_per_tok + 2.0 * D * n_experts
    attn_mm_per_tok = 4.0 * D * D * 2.0

    def fwd(n: int) -> tuple[float, float]:
        patch = (n - 1) * patch_pixels * D * 2.0
        mlp_rows = n_real if moe_top_k else n
        return (patch + depth * (attn_mm_per_tok * n + mlp_per_tok * mlp_rows)
                + D * num_classes * 2.0, depth * 4.0 * float(n) * float(n) * D)

    p_real, a_real = fwd(n_real)
    p_pad, a_pad = fwd(n_pad)
    hardware = 3.0 * p_pad + 3.5 * a_pad
    if remat_refwd:
        hardware += depth * (attn_mm_per_tok * n_pad
                             + mlp_per_tok * (n_real if moe_top_k else n_pad))
    return StepFlops(useful=3.0 * p_real + 3.5 * a_real, hardware=hardware,
                     fwd_useful=p_real + a_real)


def ast_step_flops(model, n_real: int, n_pad: int) -> StepFlops:
    """``vit_step_flops`` with the dims of an ``ASTViT`` (its ``config``)."""
    c = model.config
    moe = c.get("moe") or {}
    return vit_step_flops(n_real=n_real, n_pad=n_pad, emb_dim=c["emb_dim"],
                          depth=c["depth"], patch_pixels=c["patch_size"] ** 2,
                          num_classes=c["num_classes"], remat_refwd=bool(c["remat"]),
                          moe_top_k=moe.get("top_k", 0), n_experts=moe.get("n_experts", 0))


def ast_token_counts(model, n_samples: int, hop: int = 160) -> tuple[int, int]:
    """(n_real, n_pad) for a waveform of ``n_samples`` samples: the mel
    frame count (centre padding), the patch grid, the CLS token, and the
    port's encoder-wide padding to ``PAD_GRAIN`` (1645 → 1664 for 5 s)."""
    c = model.config
    t_dim = n_samples // hop + 1
    step = c["patch_size"] - c["overlap"]
    f_tok = (c["f_dim"] - c["patch_size"]) // step + 1
    t_tok = (t_dim - c["patch_size"]) // step + 1
    n_real = f_tok * t_tok + 1
    return n_real, -(-n_real // PAD_GRAIN) * PAD_GRAIN
