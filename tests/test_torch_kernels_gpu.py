"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. This file imports
no jax, so it also runs where jax is not installed; the repository's
conftest.py does import jax, hence on the card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

Tolerances: K1 normalised error < 1e-4 (tests/test_mel_pallas.py's bar;
f32 FMA sums reach ~1e-6); K2 f32 1e-4 (summation order only), K2 bf16 2e-2
(P rounded to bf16 before P·V, out stored in bf16); the small AST model in
f32 through both kernels vs plain ops 1e-4 on its sigmoid outputs.
"""

import numpy as np
import pytest
import torch

from dlsc_tpu_torch.models.ast import ASTModel
from dlsc_tpu_torch.ops import attn_fast as A
from dlsc_tpu_torch.ops import mel as M
from dlsc_tpu_torch.ops import mel_kernel as MK

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
