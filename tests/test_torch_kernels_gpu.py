"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. This file imports
no jax, so it also runs where jax is not installed; the repository's
conftest.py does import jax, hence on the card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

Tolerances: K1 normalised error < 1e-4 (tests/test_mel_pallas.py's bar;
f32 FMA sums reach ~1e-6); K2f f32 1e-4 (summation order only), K2f bf16
2e-2 (P rounded to bf16 before P·V, out stored in bf16); K2b f32 1e-4 and
bf16 2e-2 normalised by the max |gradient| (the same reasons; the plain
version rounds P and dS where the kernel does); the small AST model in f32
through the kernels vs plain ops 1e-4 on its sigmoid outputs, and one f32
train step 1e-4 on the loss (relative) and on each parameter's gradient
(normalised); K4a/K4b f32 1e-5 normalised (summation order only), bf16
1e-2 (bf16 output rounding, f32 sums on both sides).
"""

import numpy as np
import pytest
import torch

from dlsc_tpu_torch.data.pipeline import DevicePipeline, PipelineConfig
from dlsc_tpu_torch.models.ast import ASTModel
from dlsc_tpu_torch.models.vit import ASTViT
from dlsc_tpu_torch.ops import attn_fast as A
from dlsc_tpu_torch.ops import gmm as G
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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n,n_real", [(256, 256), (256, 200), (200, 131), (1664, 1645)])
def test_attention_kernel_matches_reference(dtype, tol, n, n_real, cuda_device):
    """Any N and n_real, including a ragged last query block and kv tile."""
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
@pytest.mark.parametrize("n,n_real", [(256, 256), (256, 200), (200, 131), (1664, 1645)])
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
