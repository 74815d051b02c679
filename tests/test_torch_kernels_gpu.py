"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. This file imports
no jax, so it also runs where jax is not installed; the repository's
conftest.py does import jax, hence on the card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

Tolerances: K1 normalised error < 1e-4 (tests/test_mel_pallas.py's bar;
f32 FMA sums reach ~1e-6); K2f f32 1e-4 (summation order only), K2f bf16
2e-2 (P rounded to bf16 before P·V, out stored in bf16); K2b f32 1e-4 and
bf16 2e-2 normalised by the max |gradient| (the same reasons; the plain
version rounds P and dS where the kernel does), and two bf16 K2b calls
bit-identical; the small AST model in f32 through the kernels vs plain ops
1e-4 on its sigmoid outputs, and one f32 train step 1e-4 on the loss
(relative) and on each parameter's gradient (normalised); K4a/K4b f32 1e-5
normalised (summation order only), bf16 1e-2 (bf16 output rounding, f32
sums on both sides), two bf16 K4b calls bit-identical; K1 also at n_fft 256,
512 and 2048, and two calls bit-identical; K3f/K3b: r exact
in both types (both round one f32 sum), y, dx, dgamma and dbeta 1e-5
normalised in f32 (summation order only) and 1e-2 in bf16 (the outputs
stored in bf16), two K3b calls bit-identical, no K3 kernel spilling, and a
K3b launch other than ``_bwd_plan``'s refused; the small AST-Small train step with ``ln_fused`` through
K2 and K3 vs plain ops 1e-4, as the AST step. The vmap rules (the vmapped
HPO step): K2f and K2b fold K trials into one launch, each trial's
gradients within 1e-6 normalised of its own launch's (independent (b, h)
problems: equal in practice); K3 with per-trial gamma launches once a
trial, bit-equal to per-trial calls; K4a/K4b fold K trials' experts into
K·E groups, one launch each, against per-trial launches f32 1e-5 and bf16
1e-2 (K4b's row slices follow the folded rows); one vmapped runner step of
a small AST-Small with ``ln_fused`` launches K1 once, K2 once a block and
K3 once a block and trial. The dropout draw (``csrc/dropout_draw.cu``):
bit-equal to its plain version in f32 and bf16, unsplit, at a split's
offsets, in its keep-mask mode, on row-indexed (sorted) rows and under its
vmap rule (K trials in one launch, more than one launch past 64 trials).
One tensor-parallel step (2 ranks on the one card over gloo) of a small
AST-MoE in f32 against the one-process step: loss 1e-5 relative, gradients
1e-4 of their largest (the ranks sum partial expert outputs in another
order).
"""

import re

import numpy as np
import pytest
import torch

from dlsc_tpu_torch import _kernels
from dlsc_tpu_torch.data.pipeline import DevicePipeline, PipelineConfig
from dlsc_tpu_torch.models.ast import ASTModel
from dlsc_tpu_torch.models.vit import ASTViT
from dlsc_tpu_torch.ops import attn_fast as A
from dlsc_tpu_torch.ops import dropout_draw as DD
from dlsc_tpu_torch.ops import gmm as G
from dlsc_tpu_torch.ops import ln_fused as LN
from dlsc_tpu_torch.ops import mel as M
from dlsc_tpu_torch.ops import mel_kernel as MK
from dlsc_tpu_torch.train.losses import CrossEntropyLoss
from dlsc_tpu_torch.train.metrics import MetricState
from dlsc_tpu_torch.train.optim import sgd
from dlsc_tpu_torch.train.state import TrainState
from dlsc_tpu_torch.train.steps import make_train_step

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    # decided here, never at import, so every pytest worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _norm_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize("hop,win", [(160, 400), (512, 1024)])
@pytest.mark.parametrize("n", [220_500, 1_000])
def test_mel_kernel_matches_plain(hop, win, n, cuda_device):
    cfg = M.MelConfig(hop_length=hop, win_length=win)
    w = torch.from_numpy(
        (np.random.default_rng(n).standard_normal((3, n)) * 0.3).astype(np.float32)
    ).to(cuda_device)
    before = MK.launches
    got = MK.mel_power(w, cfg)
    torch.cuda.synchronize()
    assert MK.launches == before + 1
    want = M.mel_spectrogram(w, cfg)
    assert got.shape == want.shape
    assert _norm_err(got, want) < 1e-4


def _wave(b, n, seed, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal((b, n)) * 0.3).astype(np.float32)).to(device)


# n_fft 256 .. 2048 (the last radix 2, 4, 8, 2), a window shorter than n_fft
# and one as long
_FFT_CONFIGS = [M.MelConfig(n_fft=256, hop_length=80, win_length=200),
                M.MelConfig(n_fft=512, hop_length=160, win_length=400),
                M.MelConfig(),
                M.MelConfig(n_fft=2048, hop_length=512, win_length=2048)]


@pytest.mark.parametrize("cfg", _FFT_CONFIGS, ids=lambda c: f"n_fft{c.n_fft}")
@pytest.mark.parametrize("b,n", [(1, 44_100), (2, None)], ids=["batch1", "just_past_half"])
def test_mel_kernel_at_every_fft_size(cfg, b, n, cuda_device):
    """K1 at every n_fft it takes, at batch 1 and at a clip one sample past
    n_fft/2 (the shortest the reflect padding allows), against its plain
    version (normalised < 1e-4)."""
    w = _wave(b, cfg.n_fft // 2 + 1 if n is None else n, cfg.n_fft + b, cuda_device)
    got = MK.mel_power(w, cfg)
    want = M.mel_spectrogram(w, cfg)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert _norm_err(got, want) < 1e-4


@pytest.mark.parametrize("cfg", [_FFT_CONFIGS[2], M.MelConfig(hop_length=512, win_length=1024)])
def test_mel_kernel_is_deterministic(cfg, cuda_device):
    """Two K1 calls on the same clips give the same bits: each frame is
    one thread group's, each band summed in bin order."""
    w = _wave(8, 220_500, 9, cuda_device)
    assert torch.equal(MK.mel_power(w, cfg), MK.mel_power(w, cfg))


def test_mel_kernel_rejects_unsupported(cuda_device):
    w = _wave(2, 4_000, 0, cuda_device)
    for cfg in (M.MelConfig(n_fft=1000), M.MelConfig(n_mels=64), M.MelConfig(n_fft=4096)):
        with pytest.raises(ValueError, match="n_fft"):
            MK.mel_power(w, cfg)
    with pytest.raises(ValueError, match="reflect padding"):
        MK.mel_power(w[:, :512], M.MelConfig())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n,n_real", [(256, 256), (256, 200), (200, 131), (1664, 1645),
                                      (768, 768), (130, 130), (256, 40), (768, 689),
                                      (3328, 3301)])
def test_attention_kernel_matches_reference(dtype, tol, n, n_real, cuda_device):
    """Any N and n_real, including a ragged last query block and kv tile, a
    64-row query box wholly past N (130) and key tiles past n_real (256, 40)."""
    rng = np.random.default_rng(n + n_real)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, n, 64)).astype(np.float32))
               for _ in range(3))
    q, k, v = ((t * s).to(cuda_device, dtype) for t, s in ((q, 0.125), (k, 1), (v, 1)))
    before = A.launches
    out, lse = A.fast_mha_forward(q, k, v, n_real)
    torch.cuda.synchronize()
    assert A.launches == before + 1
    ref, ref_lse = A.mha_forward_reference(q.float(), k.float(), v.float(), n_real)
    assert (out.float() - ref)[:, :, :n_real].abs().max().item() <= tol
    assert (lse - ref_lse)[:, :, :n_real].abs().max().item() <= tol
    assert torch.isfinite(out).all()  # pad query rows too


@pytest.mark.parametrize("n,n_real", [(1664, 1645), (130, 130)])
def test_attention_forward_kernel_is_deterministic(n, n_real, cuda_device):
    """Two bf16 K2f calls on the same inputs give the same bits in out and
    lse: each row is owned by one CTA and summed in a fixed order."""
    g = torch.Generator(cuda_device).manual_seed(n + 1)
    q, k, v = (torch.randn(2, 3, n, 64, generator=g, device=cuda_device) for _ in range(3))
    q, k, v = (t.to(torch.bfloat16) for t in (q * 0.125, k, v))
    first = A.fast_mha_forward(q, k, v, n_real)
    second = A.fast_mha_forward(q, k, v, n_real)
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "lse"), first, second):
        assert torch.equal(a, b), name


def _hgmma_hmma(functions: dict, part: str) -> dict:
    """(HGMMA, HMMA) instruction counts of each SASS function whose name
    holds ``part``."""
    return {f: (text.count("HGMMA"), len(re.findall(r"\bHMMA\b", text)))
            for f, text in functions.items() if part in f}


def test_attention_forward_bf16_runs_on_wgmma(cuda_device):
    """The bf16 forward's SASS holds Hopper's warpgroup products (HGMMA)
    and no mma.sync (HMMA) left from the earlier design; needs cuobjdump."""
    counts = _hgmma_hmma(_kernels.sass_functions("attn_fwd"), "attn_fwd_bf16")
    assert len(counts) == 1
    assert all(hgmma > 0 and hmma == 0 for hgmma, hmma in counts.values()), counts


def test_attention_kernel_rejects_unsupported(cuda_device):
    q = torch.zeros(1, 2, 128, 32, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        A.fast_mha_forward(q, q, q, 100)
    q = torch.zeros(1, 2, 128, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="head_dim"):
        A.fast_mha_forward(q, q, q, 100)
    q = torch.zeros(2 * 128 * 64 + 1, device=cuda_device)[1:].view(1, 2, 128, 64)
    with pytest.raises(ValueError, match="16-byte"):
        A.fast_mha_forward(q, q, q, 100)


def test_small_ast_through_kernels_matches_plain(cuda_device):
    model = ASTModel(num_classes=7, emb_dim=128, depth=2, num_heads=2,
                     dtype=torch.float32, device=cuda_device,
                     generator=torch.Generator().manual_seed(0))
    w = torch.from_numpy(
        (np.random.default_rng(0).standard_normal((2, 44_100)) * 0.3).astype(np.float32)
    ).to(cuda_device)
    with torch.inference_mode():
        got = model(MK.ast_features(w))
        want = model(M.ast_normalize(M.log_mel_spectrogram(w)),
                     attention=A.mha_forward_reference)
    assert got.shape == (2, 7)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n,n_real", [(256, 256), (256, 200), (200, 131), (1664, 1645),
                                      (768, 768), (768, 689), (256, 40), (130, 130)])
def test_attention_backward_kernel_matches_reference(dtype, tol, n, n_real, cuda_device):
    """K2b from K2f's residuals, any N and n_real: dQ, dK, dV over rows <
    n_real against the plain version on the same inputs; dK/dV rows >=
    n_real exactly 0; one launch."""
    rng = np.random.default_rng(n * 7 + n_real)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 3, n, 64)).astype(np.float32))
                   for _ in range(4))
    q, k, v, do = ((t * s).to(cuda_device, dtype)
                   for t, s in ((q, 0.125), (k, 1), (v, 1), (do, 1)))
    out, lse = A.fast_mha_forward(q, k, v, n_real)
    before = A.bwd_launches
    got = A.fast_mha_backward(q, k, v, out, lse, do, n_real)
    torch.cuda.synchronize()
    assert A.bwd_launches == before + 1
    want = A.mha_backward_reference(q, k, v, out, lse, do, n_real)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == q.shape
        assert torch.isfinite(g).all(), name
        assert _norm_err(g[:, :, :n_real].float(), w[:, :, :n_real].float()) <= tol, name
    for g in got[1:]:
        assert (g[:, :, n_real:] == 0).all()


@pytest.mark.parametrize("n,n_real", [(1664, 1645), (130, 130)])
def test_attention_backward_kernel_is_deterministic(n, n_real, cuda_device):
    """Two bf16 K2b calls on the same inputs give the same bits in dQ, dK
    and dV: each output is owned by one CTA and summed in a fixed order,
    with no atomics."""
    g = torch.Generator(cuda_device).manual_seed(n)
    q, k, v, do = (torch.randn(2, 3, n, 64, generator=g, device=cuda_device) for _ in range(4))
    q, k, v, do = (t.to(torch.bfloat16) for t in (q * 0.125, k, v, do))
    out, lse = A.fast_mha_forward(q, k, v, n_real)
    first = A.fast_mha_backward(q, k, v, out, lse, do, n_real)
    second = A.fast_mha_backward(q, k, v, out, lse, do, n_real)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


def test_attention_backward_bf16_runs_on_wgmma(cuda_device):
    """The bf16 backward's SASS holds Hopper's warpgroup products (HGMMA)
    and no mma.sync (HMMA) left from the earlier design; needs cuobjdump
    (the CUDA toolkit's bin/, else Triton's backends/nvidia/bin/)."""
    sass = _kernels.sass("attn_bwd")
    assert "HGMMA" in sass
    assert " HMMA" not in sass


def test_fast_mha_gradient_matches_autograd_of_plain(cuda_device):
    g = torch.Generator().manual_seed(1)
    q, k, v, do = (torch.randn(2, 3, 384, 64, generator=g).to(cuda_device) for _ in range(4))
    q = q * 0.125
    t = [x.clone().requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(A.fast_mha(*t, 325), t, do)
    r = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(A.mha_forward_reference(*r, 325)[0], r, do)
    for a, b in zip(got, want):
        assert _norm_err(a, b) <= 1e-4


def test_small_ast_train_step_through_kernels_matches_plain(cuda_device):
    """One f32 step (SpecAugment + Mixup, the same draws, SGD with momentum
    so that the momentum buffer holds each parameter's gradient) through
    K1, K2f and K2b vs the same step with plain attention."""
    pipe = DevicePipeline(PipelineConfig(mode="ast", num_classes=7, time_mask=192,
                                         freq_mask=48, enable_mixup=True))
    rng = np.random.default_rng(0)
    wave = torch.from_numpy((rng.standard_normal((4, 44_100)) * 0.3).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 7, 4))
    draws = pipe.draw(4, 44_100, rng)
    results = []
    for attention in (None, A.mha_forward_reference):
        model = ASTModel(num_classes=7, emb_dim=128, depth=2, num_heads=2,
                         dtype=torch.float32, device=cuda_device,
                         generator=torch.Generator().manual_seed(0))
        state = TrainState.create(model, sgd(lr=0.1, momentum=0.9), None, 1)
        step = make_train_step(pipe, CrossEntropyLoss(), attention=attention)
        A.reset_launches()
        state, _, loss = step(state, MetricState.create(7, cuda_device), wave.to(cuda_device),
                              labels.to(cuda_device), draws)
        torch.cuda.synchronize()
        results.append((loss.item(), A.launches, A.bwd_launches,
                        [state.optimizer.state[p]["momentum_buffer"] for p in model.parameters()]))
    (l_k, f_k, b_k, g_k), (l_p, f_p, b_p, g_p) = results
    assert (f_k, b_k, f_p, b_p) == (2, 2, 0, 0)
    assert abs(l_k - l_p) <= 1e-4 * abs(l_p)
    for a, b in zip(g_k, g_p):
        if b.abs().max() > 0:
            assert _norm_err(a, b) <= 1e-4
        else:
            assert (a == 0).all()


# ---- K4: grouped matmul --------------------------------------------------------

# group sizes with an empty group, groups smaller than a 128-row tile, sizes
# that are no multiple of 8, and one group with most of the rows
_GROUP_SIZES = [(0, 37, 1, 300, 0, 93, 129, 200), (700, 0, 5, 55), (8, 8, 8, 8)]


def _gmm_inputs(sizes, k, n, dtype, device, seed):
    rng = np.random.default_rng(seed)
    m = sum(sizes)
    lhs = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    rhs = torch.from_numpy(rng.standard_normal((len(sizes), k, n)).astype(np.float32))
    gs = torch.tensor(sizes, dtype=torch.int32)
    return lhs.to(device, dtype), rhs.to(device, dtype), gs.to(device)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("sizes", _GROUP_SIZES)
@pytest.mark.parametrize("k,n", [(64, 96), (40, 136)])
def test_gmm_kernels_match_reference(dtype, tol, sizes, k, n, cuda_device):
    """K4a (both rhs layouts) and K4b against their plain versions; one
    launch each; an empty group's tgmm block is exactly 0."""
    lhs, rhs, gs = _gmm_inputs(sizes, k, n, dtype, cuda_device, sum(sizes) + k)
    before = (G.launches, G.tgmm_launches)
    got = G.gmm(lhs, rhs, gs)
    got_t = G.gmm(lhs, rhs.transpose(1, 2).contiguous(), gs, transpose_rhs=True)
    grad = got.float().sin().to(dtype)
    got_w = G.tgmm(lhs, grad, gs)
    torch.cuda.synchronize()
    assert (G.launches, G.tgmm_launches) == (before[0] + 2, before[1] + 1)
    want = G.gmm_reference(lhs, rhs, gs)
    assert got.dtype == dtype and got.shape == want.shape
    assert _norm_err(got.float(), want.float()) <= tol
    assert _norm_err(got_t.float(), want.float()) <= tol
    want_w = G.tgmm_reference(lhs, grad, gs)
    assert got_w.shape == want_w.shape == (len(sizes), k, n)
    assert _norm_err(got_w.float(), want_w.float()) <= tol
    for g, size in enumerate(sizes):
        if size == 0:
            assert (got_w[g] == 0).all()


# AST-MoE's widths (d 384, ff 1536) with empty first and last groups, and
# one group holding every row
_MOE_SIZES = [(0, 300, 1, 517, 129, 0), (947,)]


@pytest.mark.parametrize("sizes", _MOE_SIZES)
@pytest.mark.parametrize("k,n", [(384, 1536), (1536, 384)])
@pytest.mark.parametrize("transpose_rhs", [False, True])
def test_gmm_bf16_at_ast_moe_widths(sizes, k, n, transpose_rhs, cuda_device):
    """K4a bf16 in both rhs layouts at the MoE MLP's widths against its
    plain version (1e-2 normalised); rows past a group's end are never
    written into the next group's; two calls give the same bits."""
    lhs, rhs, gs = _gmm_inputs(sizes, k, n, torch.bfloat16, cuda_device, k + len(sizes))
    rhs = (rhs * k**-0.5).to(torch.bfloat16)
    if transpose_rhs:
        rhs = rhs.transpose(1, 2).contiguous()
    got = G.gmm(lhs, rhs, gs, transpose_rhs)
    again = G.gmm(lhs, rhs, gs, transpose_rhs)
    torch.cuda.synchronize()
    want = G.gmm_reference(lhs, rhs, gs, transpose_rhs)
    assert got.shape == want.shape == (sum(sizes), n)
    assert torch.isfinite(got).all()
    assert _norm_err(got.float(), want.float()) <= 1e-2
    assert torch.equal(got, again)


def test_gmm_bf16_runs_on_wgmma(cuda_device):
    """K4a's bf16 kernels (both rhs layouts) and K4b's hold HGMMA and no
    HMMA in their SASS."""
    functions = _kernels.sass_functions("gmm")
    k4a = {f: c for f, c in _hgmma_hmma(functions, "gmm_bf16_wgmma").items() if "tgmm" not in f}
    assert len(k4a) == 2
    assert all(hgmma > 0 and hmma == 0 for hgmma, hmma in k4a.values()), k4a
    k4b = _hgmma_hmma(functions, "tgmm_bf16_wgmma")
    assert len(k4b) == 1
    assert all(hgmma > 0 and hmma == 0 for hgmma, hmma in k4b.values()), k4b


# K4b at AST-MoE's widths: empty first and last groups, groups of fewer than
# 64 rows, M 947 (no multiple of 64); one group; one group over many slices;
# the skewed sizes of chip_smoke.py (88 192 rows, one expert with half)
_TGMM_SIZES = [(0, 300, 1, 517, 129, 0), (947,), (0, 20_000, 0, 37),
               (45_001, 0, 12_345, 9_999, 7_777, 6_543, 4_321, 2_206)]


@pytest.mark.parametrize("sizes", _TGMM_SIZES, ids=["ragged", "one", "many_slices", "skewed"])
@pytest.mark.parametrize("k,n", [(384, 1536), (1536, 384)])
def test_tgmm_bf16_at_ast_moe_widths(sizes, k, n, cuda_device):
    """K4b bf16 against its plain version (1e-2 normalised), one launch
    counted for its two kernels, an empty group exactly 0, two calls the
    same bits; the plan's slices (some groups span several) as the sizes
    say."""
    lhs, _, gs = _gmm_inputs(sizes, k, 8, torch.bfloat16, cuda_device, k + len(sizes))
    grad = _gmm_inputs(sizes, n, 8, torch.bfloat16, cuda_device, n)[0]
    before = G.tgmm_launches
    got = G.tgmm(lhs, grad, gs)
    again = G.tgmm(lhs, grad, gs)
    torch.cuda.synchronize()
    assert G.tgmm_launches == before + 2
    want = G.tgmm_reference(lhs, grad, gs)
    assert got.shape == want.shape == (len(sizes), k, n)
    assert torch.isfinite(got).all()
    assert _norm_err(got.float(), want.float()) <= 1e-2
    assert torch.equal(got, again)
    for g, size in enumerate(sizes):
        if size == 0:
            assert (got[g] == 0).all()
    plan = G._tgmm_plan(sum(sizes), k, n, len(sizes),
                        torch.cuda.get_device_properties(cuda_device).multi_processor_count)
    assert len(G._slices(sizes, plan["slice_rows"])) <= plan["slots"]


def test_grouped_matmul_gradient_matches_autograd_of_plain(cuda_device):
    lhs, rhs, gs = _gmm_inputs(_GROUP_SIZES[0], 64, 96, torch.float32, cuda_device, 5)
    grad = torch.randn(lhs.shape[0], 96, generator=torch.Generator().manual_seed(2)).to(cuda_device)
    a = [t.clone().requires_grad_() for t in (lhs, rhs)]
    got = torch.autograd.grad(G.grouped_matmul(*a, gs), a, grad)
    b = [t.clone().requires_grad_() for t in (lhs, rhs)]
    want = torch.autograd.grad(G.gmm_reference(*b, gs), b, grad)
    for x, y in zip(got, want):
        assert _norm_err(x, y) <= 1e-5


def test_gmm_kernel_rejects_unsupported(cuda_device):
    lhs, rhs, gs = _gmm_inputs((4, 4), 12, 16, torch.bfloat16, cuda_device, 0)
    with pytest.raises(ValueError, match="multiples of 8"):
        G.gmm(lhs, rhs, gs)
    with pytest.raises(ValueError, match="int32"):
        G.gmm(lhs, rhs, gs.long())
    with pytest.raises(ValueError, match="group_sizes on"):
        G.gmm(lhs, rhs, gs.cpu())


def test_small_ast_moe_train_step_through_kernels_matches_plain(cuda_device):
    """One f32 AST-MoE step (dropout 0.1, one seed) through K2f/K2b and
    K4a/K4b vs plain attention and plain grouped matmul, the plain run
    replaying the kernel run's router choices (a near-tie could otherwise
    flip a route): loss 1e-4 relative, gradients 1e-4 normalised; per step
    gmm 2 x depth forward + 2 x depth dlhs, tgmm 2 x depth."""
    pipe = DevicePipeline(PipelineConfig(mode="ast", num_classes=7, time_mask=192,
                                         freq_mask=48, enable_mixup=True))
    rng = np.random.default_rng(1)
    wave = torch.from_numpy((rng.standard_normal((4, 44_100)) * 0.3).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 7, 4))
    draws = pipe.draw(4, 44_100, rng)
    routes = []

    def record(gates, k):
        routes.append(torch.topk(gates, k, dim=-1))
        return routes[-1]

    def replay(gates, k):
        idx = routes[replay.calls][1]
        replay.calls += 1
        return gates.gather(-1, idx), idx

    replay.calls = 0
    results = []
    for plain in (False, True):
        model = ASTViT(num_classes=7, emb_dim=128, depth=2, num_heads=2, patch_size=16,
                       patch_stride=16, overlap=0, dropout=0.1, device=cuda_device,
                       moe=dict(n_experts=4, top_k=2, dispatch="ragged"),
                       generator=torch.Generator().manual_seed(0))
        state = TrainState.create(model, sgd(lr=0.1, momentum=0.9), None, 1)
        ops = (dict(attention=A.mha_forward_reference, grouped_matmul=G.gmm_reference,
                    topk=replay) if plain else dict(topk=record))
        step = make_train_step(pipe, CrossEntropyLoss(), **ops)
        G.reset_launches()
        state, _, loss = step(state, MetricState.create(7, cuda_device), wave.to(cuda_device),
                              labels.to(cuda_device), draws, 1234)
        torch.cuda.synchronize()
        results.append((loss.item(), G.launches, G.tgmm_launches,
                        [state.optimizer.state[p]["momentum_buffer"] for p in model.parameters()]))
    (l_k, gmm_k, tgmm_k, g_k), (l_p, gmm_p, tgmm_p, g_p) = results
    assert (gmm_k, tgmm_k, gmm_p, tgmm_p) == (8, 4, 0, 0)
    assert abs(l_k - l_p) <= 1e-4 * abs(l_p)
    for a, b in zip(g_k, g_p):
        if b.abs().max() > 0:
            assert _norm_err(a, b) <= 1e-4
        else:
            assert (a == 0).all()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("d", [192, 384, 768, 1024, 8])
@pytest.mark.parametrize("rows", [5003, 3, 1])
def test_add_ln_kernels_match_plain(dtype, tol, d, rows, cuda_device):
    """K3f and K3b against their plain versions on the same inputs: r
    exact, y/mu/rsig and dx/dgamma/dbeta within the bar, one launch each.
    5003 rows: a short last tile of K3b (no multiple of its 4, 8 or 16
    rows, nor of 4: the last stats are plain loads); 3 and 1 rows: one
    short tile, one CTA."""
    rng = np.random.default_rng(d + rows)
    x, delta, dr, dy = (torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32))
                        .to(cuda_device, dtype) for _ in range(4))
    gamma = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(np.float32)).to(
        cuda_device)
    beta = torch.from_numpy((0.1 * rng.standard_normal(d)).astype(np.float32)).to(cuda_device)
    LN.reset_launches()
    got = LN.fused_add_ln_forward(x, delta, gamma, beta)
    torch.cuda.synchronize()
    want = LN.add_ln_reference(x, delta, gamma, beta)
    assert torch.equal(got[0], want[0])
    for name, g, w in zip(("y", "mu", "rsig"), got[1:], want[1:]):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert _norm_err(g.float(), w.float()) <= tol, name
    r, _, mu, rsig = want
    got = LN.fused_add_ln_backward(r, mu, rsig, gamma, dr, dy)
    torch.cuda.synchronize()
    want = LN.add_ln_backward_reference(r, mu, rsig, gamma, dr, dy)
    for name, g, w in zip(("dx", "dgamma", "dbeta"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.isfinite(g).all(), name
        assert _norm_err(g.float(), w.float()) <= tol, name
    assert (LN.launches, LN.bwd_launches) == (1, 1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d,rows", [(192, 106_496), (384, 49_152), (768, 20_003)])
def test_add_ln_backward_is_deterministic(dtype, d, rows, cuda_device):
    """Two K3b calls give the same bits (dgamma / dbeta summed in a fixed
    order, no atomics), at the models' widths with every CTA walking many
    tiles (20 003: a short last tile)."""
    g = torch.Generator(cuda_device).manual_seed(d)
    r, dr, dy = (torch.randn(rows, d, generator=g, device=cuda_device).to(dtype)
                 for _ in range(3))
    mu, rsig = r.float().mean(-1), 1 + torch.rand(rows, generator=g, device=cuda_device)
    gamma = 1 + 0.1 * torch.randn(d, generator=g, device=cuda_device)
    a = LN.fused_add_ln_backward(r, mu, rsig, gamma, dr, dy)
    b = LN.fused_add_ln_backward(r, mu, rsig, gamma, dr, dy)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_add_ln_kernels_spill_nothing(cuda_device):
    """Every K3 kernel (each type and chunk count, and K3b's summing kernel)
    spills nothing (``-Xptxas -v``, a build flag of the library)."""
    log = _kernels.build_log("ln_fused")
    entries = re.findall(r"Compiling entry function '(\S+)'", log)
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores", log)]
    assert len(entries) == 17 and len(spills) >= len(entries) and not any(spills)


def test_add_ln_backward_refuses_another_plan(cuda_device):
    """The C entry point launches only ``_bwd_plan``'s grid and tiles."""
    rows, d = 4096, 384
    t = torch.zeros(rows, d, device=cuda_device, dtype=torch.bfloat16)
    f = torch.zeros(rows, device=cuda_device)
    w = torch.ones(d, device=cuda_device)
    plan = LN._bwd_plan(rows, d, torch.cuda.get_device_properties(cuda_device)
                        .multi_processor_count)
    ws = torch.empty(plan["workspace"] + 2 * d, device=cuda_device)
    lib = LN._lib()
    for bad in (dict(grid=plan["grid"] + 1), dict(tile_rows=plan["tile_rows"] * 2),
                dict(stages=plan["stages"] - 1)):
        p = {**plan, **bad}
        err = lib.dlsc_add_ln_bwd(t.data_ptr(), f.data_ptr(), f.data_ptr(), w.data_ptr(),
                                  t.data_ptr(), t.data_ptr(), t.data_ptr(), w.data_ptr(),
                                  w.data_ptr(), ws.data_ptr(), rows, d, 0, p["grid"],
                                  p["threads"], p["smem"], p["stages"], p["tile_rows"],
                                  torch.cuda.current_stream().cuda_stream)
        assert err != 0, bad


def test_add_ln_op_gradient_matches_autograd_of_plain(cuda_device):
    g = torch.Generator().manual_seed(2)
    x, delta, wr, wy = (torch.randn(4, 300, 384, generator=g).to(cuda_device) for _ in range(4))
    gamma, beta = (torch.randn(384, generator=g).to(cuda_device) for _ in range(2))
    grads = []
    for fn in (LN.add_ln, LN.add_ln_reference):
        t = [a.clone().requires_grad_() for a in (x, delta, gamma, beta)]
        r, y, _, _ = fn(*t)
        grads.append(torch.autograd.grad((r * wr).sum() + (y * wy).sum(), t))
    for a, b in zip(*grads):
        assert _norm_err(a, b) <= 1e-5


def test_add_ln_kernel_rejects_unsupported(cuda_device):
    w = torch.ones(100, device=cuda_device)
    x = torch.zeros(8, 100, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 8"):
        LN.fused_add_ln_forward(x, x, w, w)
    w = torch.ones(64, device=cuda_device)
    x = torch.zeros(8 * 64 + 1, device=cuda_device)[1:].view(8, 64)
    with pytest.raises(ValueError, match="16-byte"):
        LN.fused_add_ln_forward(x, x, w, w)
    x = torch.zeros(8, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16/float32"):
        LN.fused_add_ln_forward(x, x, w, w)


def test_small_ast_small_ln_fused_train_step_matches_plain(cuda_device):
    """One f32 AST-Small step with ``ln_fused`` (dropout 0.1, one seed,
    remat ``attn_res``) through K1, K2 and K3 vs the same step with plain
    attention and the plain add + LN: loss 1e-4 relative, gradients 1e-4
    normalised; K3f twice per block (forward and re-forward), K3b once."""
    from dlsc_tpu_torch.models.ast_small import ASTViTSmall

    pipe = DevicePipeline(PipelineConfig(mode="ast", num_classes=7, time_mask=192,
                                         freq_mask=48, enable_mixup=True))
    rng = np.random.default_rng(2)
    wave = torch.from_numpy((rng.standard_normal((4, 44_100)) * 0.3).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 7, 4))
    draws = pipe.draw(4, 44_100, rng)
    results = []
    for plain in (False, True):
        model = ASTViTSmall(num_classes=7, emb_dim=128, depth=2, num_heads=2, patch_stride=16,
                            overlap=0, dtype=torch.float32, ln_fused=True, device=cuda_device,
                            generator=torch.Generator().manual_seed(0))
        state = TrainState.create(model, sgd(lr=0.1, momentum=0.9), None, 1)
        ops = (dict(attention=A.mha_forward_reference, add_ln=LN.add_ln_reference)
               if plain else {})
        step = make_train_step(pipe, CrossEntropyLoss(), **ops)
        LN.reset_launches()
        state, _, loss = step(state, MetricState.create(7, cuda_device), wave.to(cuda_device),
                              labels.to(cuda_device), draws, 99)
        torch.cuda.synchronize()
        results.append((loss.item(), (LN.launches, LN.bwd_launches),
                        [state.optimizer.state[p]["momentum_buffer"] for p in model.parameters()]))
    (l_k, n_k, g_k), (l_p, n_p, g_p) = results
    assert n_k == (4, 2) and n_p == (0, 0)
    assert abs(l_k - l_p) <= 1e-4 * abs(l_p)
    for a, b in zip(g_k, g_p):
        if b.abs().max() > 0:
            assert _norm_err(a, b) <= 1e-4
        else:
            assert (a == 0).all()


# ---- the vmap rules: K trials in one launch (the vmapped HPO step) ---------------

def _vmapped_vs_per_trial(f, batched):
    """(vmap(grad_and_value(f)) over the trial axis, the same f called once
    a trial): their (values, grads)."""
    from torch.func import grad_and_value, vmap

    argnums = tuple(range(len(batched)))
    got_g, got_v = vmap(grad_and_value(f, argnums=argnums))(*batched)
    want = [grad_and_value(f, argnums=argnums)(*(b[i] for b in batched))
            for i in range(batched[0].shape[0])]
    return (got_v, got_g), (torch.stack([w[1] for w in want]),
                            tuple(torch.stack([w[0][j] for w in want]) for j in argnums))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_folds_the_trials_into_one_launch(dtype, cuda_device):
    """K2f and K2b under vmap: one launch each for K trials, each trial's
    results equal to its own launch's (the (b, h) problems are independent)."""
    gen = torch.Generator(cuda_device).manual_seed(3)
    K, B, H, N, n_real = 3, 2, 12, 1664, 1645
    q, k, v, cot = (torch.randn((K, B, H, N, 64), generator=gen, device=cuda_device,
                                dtype=dtype) for _ in range(4))
    A.reset_launches()
    got, want = _vmapped_vs_per_trial(
        lambda a, b, c, t: (A.fast_mha(a, b, c, n_real).float() * t.float()).sum(), (q, k, v, cot))
    torch.cuda.synchronize()
    assert (A.launches, A.bwd_launches) == (1 + K, 1 + K)
    for g, w in zip(got[1][:3], want[1][:3]):
        assert _norm_err(g.float(), w.float()) <= 1e-6


def test_add_ln_launches_once_a_trial_with_per_trial_gamma(cuda_device):
    gen = torch.Generator(cuda_device).manual_seed(4)
    K, R, D = 3, 2 * 1664, 768
    x, delta, cot = (torch.randn((K, R, D), generator=gen, device=cuda_device,
                                 dtype=torch.bfloat16) for _ in range(3))
    gamma, beta = (torch.randn((K, D), generator=gen, device=cuda_device) for _ in range(2))
    LN.reset_launches()
    got, want = _vmapped_vs_per_trial(
        lambda a, d, g, b, t: (LN.add_ln(a, d, g, b)[1].float() * t.float()).sum(),
        (x, delta, gamma, beta, cot))
    torch.cuda.synchronize()
    assert (LN.launches, LN.bwd_launches) == (2 * K, 2 * K)
    for g, w in zip(got[1][:4], want[1][:4]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
def test_grouped_matmul_folds_the_trials_into_one_launch(dtype, tol, cuda_device):
    """K4a and K4b under vmap: K trials' E experts as K·E groups, one launch
    of each kernel; each trial's results against its own launches (K4b's
    slices differ with the folded rows, so f32 1e-5 and bf16 1e-2)."""
    gen = torch.Generator(cuda_device).manual_seed(5)
    K, E, M, k, n = 2, 8, 4096, 384, 1536
    lhs, cot = (torch.randn((K, M, d), generator=gen, device=cuda_device, dtype=dtype)
                for d in (k, n))
    rhs = torch.randn((K, E, k, n), generator=gen, device=cuda_device, dtype=dtype) * 0.05
    gs = torch.tensor([[512] * 8, [0, 1000, 24, 0, 3000, 72, 0, 0]], dtype=torch.int32,
                      device=cuda_device)
    from torch.func import grad_and_value, vmap

    G.reset_launches()
    f = lambda a, b, s, t: (G.grouped_matmul(a, b, s).float() * t.float()).sum()  # noqa: E731
    got_g, _ = vmap(grad_and_value(f, argnums=(0, 1)))(lhs, rhs, gs, cot)
    torch.cuda.synchronize()
    assert (G.launches, G.tgmm_launches) == (2, 1)
    for i in range(K):
        want_g, _ = grad_and_value(f, argnums=(0, 1))(lhs[i], rhs[i], gs[i], cot[i])
        for g, w in zip(got_g, want_g):
            assert _norm_err(g[i].float(), w.float()) <= tol


def test_vmapped_runner_step_through_the_kernels(cuda_device, tmp_path):
    """One lockstep step of 2 trials of a small AST-Small (``ln_fused``) on
    the card: K1 once, K2f and K2b once a block, K3f and K3b once a block
    and trial; every trial's parameters move and stay finite."""
    from dlsc_tpu_torch import hpo
    from dlsc_tpu_torch.data.datamodule import ESC50DataModule
    from dlsc_tpu_torch.data.synthetic import make_synthetic_dataset
    from dlsc_tpu_torch.hpo.vmapped import TrialMetrics, VmappedTrialRunner

    make_synthetic_dataset(tmp_path / "d", num_classes=4, clips_per_class_per_fold=2,
                           clip_samples=16_000)
    dm = ESC50DataModule(root=str(tmp_path / "d"), num_classes=4, fold=0, val_split=0.2,
                         batch_size=4, preprocessing_mode="ast", is_spectrogram=True)
    depth = 2
    model = ASTViT(num_classes=4, emb_dim=192, depth=depth, num_heads=3, ln_fused=True,
                   dtype=torch.bfloat16, dropout=0.1)
    runner = VmappedTrialRunner(hpo.Study("g", tmp_path / "g.db", "maximize"), model,
                                dm.pipeline, dm, epochs=1, seed=0, device=cuda_device,
                                do_space={"low": 0.0, "high": 0.5})
    fns = runner._build_exec()
    st = fns["init_v"]([1, 2], [1e-3, 1e-4], [0, 0], [0.0, 0.3], [0, 0], [0, 0])
    before = st.flat.clone()
    batch = next(iter(dm.train_batches(epoch=0, seed=0)))
    MK.reset_launches(), A.reset_launches(), LN.reset_launches()
    fns["train"](st, TrialMetrics(2, 4, cuda_device), [0.0, 0.1], [1.0, 1.0], batch["wave"],
                 batch["label"])
    torch.cuda.synchronize()
    assert (MK.launches, A.launches, A.bwd_launches) == (1, depth, depth)
    assert (LN.launches, LN.bwd_launches) == (2 * depth, 2 * depth)
    assert torch.isfinite(st.flat).all() and ((st.flat - before).abs().amax(1) > 0).all()


@pytest.mark.parametrize("layout", ["ddp", "fsdp"])
def test_data_parallel_layouts_at_one_rank_over_nccl(layout, cuda_device, tmp_path):
    """DDP and FSDP (``dlsc_tpu_torch.parallel``) on a process group of one
    NCCL rank: one train step of a small ViT with ``ln_fused`` (f32) launches
    K2 and K3 through the layout and gives the one-process step's
    parameters within 1e-6 normalised (the same kernels on the same rows;
    the gradients cross an all-reduce or reduce-scatter of one rank)."""
    import torch.distributed as dist

    from dlsc_tpu_torch import parallel

    def run(par: bool):
        model = ASTViT(num_classes=5, emb_dim=128, depth=2, num_heads=2, dtype=torch.float32,
                       ln_fused=True, remat=True, remat_policy="attn_res", device=cuda_device,
                       generator=torch.Generator().manual_seed(0))
        lay = None
        if par:
            plan = parallel.MeshPlan(parallel.get_mesh(1, 1, "cuda"))
            lay = parallel.make_layout(model, plan, cuda_device, fsdp=layout == "fsdp")
        state = TrainState.create(model, sgd(lr=0.1), None, 1)
        state.parallel = lay
        pipe = DevicePipeline(PipelineConfig(mode="ast", num_classes=5, enable_mixup=True))
        rng = np.random.default_rng(0)
        wave = torch.from_numpy((rng.standard_normal((2, 44_100)) * 0.3).astype(np.float32))
        before = (A.launches, A.bwd_launches, LN.launches, LN.bwd_launches)
        _, _, loss = make_train_step(pipe, CrossEntropyLoss())(
            state, MetricState.create(5, cuda_device), wave.to(cuda_device),
            torch.tensor([1, 3], device=cuda_device), pipe.draw(2, 44_100, rng), 7)
        torch.cuda.synchronize()
        after = (A.launches, A.bwd_launches, LN.launches, LN.bwd_launches)
        full = (lay.full_state(state)["model"] if lay is not None
                else {k: v.detach().cpu() for k, v in model.state_dict().items()})
        return loss.item(), full, [b - a for a, b in zip(before, after)]

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        loss, got, launches = run(True)
    finally:
        dist.destroy_process_group()
    want_loss, want, _ = run(False)
    assert all(n > 0 for n in launches), launches
    assert loss == pytest.approx(want_loss, rel=1e-6)
    for k, v in want.items():
        if v.is_floating_point():
            assert _norm_err(got[k].float(), v.float()) < 1e-6 if v.abs().max() > 0 else \
                torch.equal(got[k], v), k


def _draw_pair(x, seeds, keep, strides, base, row_ids=None, mode=1):
    """(the kernel's, the plain version's) draw of (K, ...) ``x`` on the card."""
    args = (x, seeds, keep, 3, 2, strides, base, row_ids)
    return DD._run(mode, *args), DD._plain(mode, *args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_draw_kernel_is_bit_equal_to_plain(dtype, cuda_device):
    """Unsplit, a split's box (rows, heads, units at offsets), the keep mask
    and the sorted rows of the ragged MoE, at ragged widths."""
    g = torch.Generator(cuda_device).manual_seed(0)
    before = DD.launches
    for shape in ((3, 37, 129), (64, 6, 96, 96), (5, 1)):
        x = torch.randn(shape, generator=g, device=cuda_device).to(dtype)[None]
        strides, base = DD.geometry(shape)
        got, want = _draw_pair(x, torch.tensor([2**61 + 5]), torch.tensor([0.7]), strides, base)
        assert torch.equal(got, want), shape
        got, want = _draw_pair(x, torch.tensor([11]), torch.tensor([0.7]), strides, base, mode=0)
        assert torch.equal(got, want), shape
    full = (16, 12, 77, 40)
    x = torch.randn(full, generator=g, device=cuda_device).to(dtype)
    whole = DD.dropout(x, 0.25, DD.Draw(7, 4), 0)
    box = x[3:11, 6:12, :, 8:37].contiguous()
    strides, _ = DD.geometry(full)
    base = 3 * strides[0] + 6 * strides[1] + 8
    got = DD._run(1, box[None], torch.tensor([7]), torch.tensor([0.75]), 4, 0, strides, base,
                  None)[0]
    assert torch.equal(got, whole[3:11, 6:12, :, 8:37])
    rows = torch.randperm(5000, generator=g, device=cuda_device)[:3001]
    h = torch.randn(3001, 768, generator=g, device=cuda_device).to(dtype)
    got, want = _draw_pair(h[None], torch.tensor([3]), torch.tensor([0.9]), [1536], 768,
                           rows[None])
    assert torch.equal(got, want)
    assert DD.launches > before


def test_dropout_draw_vmap_rule_folds_the_trials(cuda_device):
    """K trials' seeds and per-trial rates (on the card) in one launch for
    K <= 64, two for 70; each trial equal to its own plain draw."""
    from torch.func import vmap

    for k, launches in ((4, 1), (70, 2)):
        xs = torch.randn(k, 8, 96, device=cuda_device, dtype=torch.bfloat16)
        seeds = DD.trial_seeds(1, range(k))
        rates = torch.linspace(0.0, 0.5, k, device=cuda_device)
        before = DD.launches
        out = vmap(lambda x, s, r: DD.dropout(x, r, DD.Draw(s, 2), 1), randomness="error")(
            xs, seeds, rates)
        assert DD.launches - before == launches
        for i in range(k):
            want = DD._plain(1, xs[i][None], seeds[i:i + 1], 1.0 - rates[i:i + 1], 2, 1,
                             *DD.geometry((8, 96)), None)[0]
            assert torch.equal(out[i], want), i


def _tp_moe_rank(seed: int) -> dict | None:
    """One rank of the two-rank TP test: a small AST-MoE step under TP 2
    (gloo, CUDA tensors, one card); rank 0 adds the one-process step."""
    import torch.distributed as dist

    from dlsc_tpu_torch import parallel
    from dlsc_tpu_torch.models.ast_moe import ASTMoE
    from dlsc_tpu_torch.parallel import tp
    from dlsc_tpu_torch.parallel.mesh import local_device

    dev = local_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def step(layout: bool):
        model = ASTMoE(num_classes=5, emb_dim=128, depth=2, num_heads=2, dtype=torch.float32,
                       device=dev, generator=torch.Generator().manual_seed(seed))
        lay = tp.tensor_parallel(model, parallel.get_mesh(2, 2, "cuda")) if layout else None
        state = TrainState.create(model, sgd(lr=1.0), None, 1)
        state.parallel = lay
        pipe = DevicePipeline(PipelineConfig(mode="ast", num_classes=5, enable_mixup=True))
        rng = np.random.default_rng(seed)
        wave = torch.from_numpy((rng.standard_normal((4, 44_100)) * 0.3).astype(np.float32))
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        before = lay.full_model_state() if lay is not None else before
        _, _, loss = make_train_step(pipe, CrossEntropyLoss())(
            state, MetricState.create(5, dev), wave.to(dev), torch.tensor([1, 3, 0, 2],
                                                                          device=dev),
            pipe.draw(4, 44_100, rng), seed + 1)
        after = lay.full_model_state() if lay is not None else {
            n: p.detach().cpu() for n, p in model.named_parameters()}
        grads = {n: (before[n].cpu() - after[n]).numpy() for n, _ in model.named_parameters()
                 if n in after}
        return loss.item(), grads

    loss, grads = step(True)
    if dist.get_rank() != 0:
        return None
    want_loss, want = step(False)
    return dict(loss=loss, want_loss=want_loss, grads=grads, want=want)


def test_two_rank_tp_moe_step_on_one_card(cuda_device):
    """AST-MoE (ragged: K4a/K4b at F/2) with tensor parallelism 2 on two ranks
    of the one card over gloo: one step equals the one-process step."""
    from dlsc_tpu_torch.parallel.mesh import spawn

    r = spawn(_tp_moe_rank, 2, 3, backend="gloo", device_type="cuda", device_ids=[0, 0],
              timeout_s=600)[0]
    assert r["loss"] == pytest.approx(r["want_loss"], rel=1e-5)
    for k, w in r["want"].items():
        assert k in r["grads"], k
        assert np.abs(r["grads"][k] - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-12), k
