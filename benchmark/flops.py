"""The yardstick's arithmetic: peaks of the card, the useful FLOPs of an AST
train step and the operations and bytes of the hand kernels.

The useful count is a frozen copy of the convention of the port's
``utils/mfu.py`` (``vit_step_flops``): matmul and conv FLOPs at the real
token count n_real, no pad rows and no remat recompute; parameter products
x3 (forward, dW, dx), attention 4·n²·D forward + 10·n²·D backward (the score
recompute, dV, dP, dQ, dK); an MoE block counts top_k x its two expert
products per real token plus the router (2·D·E per token) in place of the
dense MLP. LayerNorm, GELU, softmax, the routing sort and the gathers count
nothing. The same work counts the same whatever implements it.

A kernel's least time is the larger of its FLOPs over the bf16 peak and its
bytes over the HBM bandwidth, each input byte read once and each output
byte written once, at the shapes the algorithm needs (attention at n_real,
the grouped products at the real (token, choice) rows).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at 700 W: bf16 tensor-core FLOP/s and HBM3 bytes/s
PEAKS = {"NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12}}
BF16 = 2   # bytes an element
F32 = 4


def known(device_name: str) -> bool:
    """Whether the peaks of the card named ``device_name`` are known (a CPU
    run's numbers are never written under a device metric's name)."""
    return device_name in PEAKS


def peaks(device_name: str) -> dict:
    """The peaks of the card named ``device_name``; an unknown card raises
    rather than borrowing another card's."""
    try:
        return PEAKS[device_name]
    except KeyError:
        raise ValueError(f"no peaks known for {device_name!r}; known: {list(PEAKS)}") from None


def token_counts(model: dict, clip_samples: int, hop: int = 160, grain: int = 128
                 ) -> tuple[int, int]:
    """(n_real, n_pad) of an AST config's ``model`` dict for a clip of
    ``clip_samples`` samples: the centred mel frames, the patch grid, the
    CLS token; n_pad rounds up to the attention layout's grain."""
    frames = clip_samples // hop + 1
    step = model["patch_size"] - model["overlap"]
    f_tok = (model["f_dim"] - model["patch_size"]) // step + 1
    t_tok = (frames - model["patch_size"]) // step + 1
    n_real = f_tok * t_tok + 1
    return n_real, -(-n_real // grain) * grain


def step_flops_per_clip(model: dict, n_real: int) -> float:
    """Useful FLOPs of one clip's forward + backward (the module docstring)."""
    D = float(model["emb_dim"])
    depth = model["depth"]
    mlp = 2.0 * model.get("mlp_ratio", 4.0) * D * D * 2.0
    moe = model.get("moe")
    if moe:
        mlp = moe["top_k"] * mlp + 2.0 * D * moe["n_experts"]
    patch = (n_real - 1) * model["patch_size"] ** 2 * D * 2.0
    params = patch + depth * (4.0 * D * D * 2.0 + mlp) * n_real + D * model["num_classes"] * 2.0
    attn = depth * 4.0 * float(n_real) ** 2 * D
    return 3.0 * params + 3.5 * attn


def attention_work(model: dict, batch: int, n_real: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one step's attention kernels, forward and backward,
    over every block: forward Q·Kᵀ and P·V (4·n²·D a clip), backward the
    score recompute, dV, dP, dQ and dK (10·n²·D); bytes: the forward reads
    q, k, v and writes out and the f32 lse, the backward reads q, k, v, out,
    dout, lse and the f32 row sums and writes dq, dk, dv."""
    D, H = model["emb_dim"], model["num_heads"]
    act = batch * n_real * D * BF16
    row = batch * H * n_real * F32
    flops = model["depth"] * 14.0 * batch * float(n_real) ** 2 * D
    fwd_bytes = 3 * act + act + row
    bwd_bytes = 5 * act + 2 * row + 3 * act
    return flops, float(model["depth"] * (fwd_bytes + bwd_bytes))


def grouped_matmul_work(model: dict, batch: int, n_real: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one step's grouped expert products over every MoE
    block, at the m = batch·n_real·top_k real (token, choice) rows: the two
    forward products (m x D -> F, m x F -> D), their two input gradients and
    their two weight gradients, each 2·m·D·F FLOPs; bytes: each product's
    row operand and output once, and its (E, D, F) weight or weight
    gradient once, in bf16. A remat re-forward is not counted: the
    algorithm does not need it."""
    moe = model["moe"]
    D = model["emb_dim"]
    F = int(model.get("mlp_ratio", 4.0) * D)
    E = moe["n_experts"]
    m = batch * n_real * moe["top_k"]
    w = E * D * F * BF16
    # x·wi -> h; h·wo -> out; dout·woᵀ -> dh; dh·wiᵀ -> dx; xᵀ·dh -> dwi; hᵀ·dout -> dwo
    io = [(m * D, m * F), (m * F, m * D), (m * D, m * F), (m * F, m * D),
          (m * D + m * F, 0), (m * F + m * D, 0)]
    bytes_ = sum((a + b) * BF16 + w for a, b in io)
    return model["depth"] * 6 * 2.0 * m * D * F, float(model["depth"] * bytes_)


def least_seconds(flops: float, bytes_: float, device_name: str) -> float:
    """The least time the card could take for this work."""
    p = peaks(device_name)
    return max(flops / p["bf16_flops"], bytes_ / p["hbm_bytes"])
