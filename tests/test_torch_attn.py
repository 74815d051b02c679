"""Port parity: kernel K2's module (masked attention forward).

``mha_forward_reference`` — what a CPU tensor runs and the kernel's oracle
on the card — against the JAX shape-specialised Pallas kernel
(``make_fast_mha``, interpret mode) on the same numpy-seeded f32 inputs,
rows < n_real, at the 2e-5 of tests/test_attn_fast.py; its lse against a
float64 numpy logsumexp of the masked scores at 1e-5. The bf16 kernel's
launch plan (``_fwd_plan``) is checked at the shapes of ``_bwd_plan``'s test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlsc_tpu.ops.attn_fast import make_fast_mha
from dlsc_tpu_torch.ops import attn_fast as A

H, N, DH = 2, 256, 64


def _qkv(seed=0, b=1):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, H, N, DH)).astype(np.float32) for _ in range(3))
    return q * np.float32(DH**-0.5), k, v


@pytest.mark.parametrize("n_real", [N, 200])
def test_reference_matches_pallas_kernel(n_real):
    q, k, v = _qkv()
    kernel = make_fast_mha(H, N, DH, n_real, 128, 128, 128, "float32", interpret=True)
    want = np.asarray(kernel(jnp.asarray(q[0]), jnp.asarray(k[0]), jnp.asarray(v[0])))
    got, _ = A.mha_forward_reference(*(torch.from_numpy(t) for t in (q, k, v)), n_real)
    np.testing.assert_allclose(got[0, :, :n_real].numpy(), want[:, :n_real],
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n_real", [N, 200, 1])
def test_lse_matches_numpy_logsumexp(n_real):
    q, k, v = _qkv(seed=1)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k.astype(np.float64))
    s[..., n_real:] = -np.inf
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    _, lse = A.mha_forward_reference(*(torch.from_numpy(t) for t in (q, k, v)), n_real)
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_real", [N, 200])
def test_round_p_matches_pallas_kernel_bf16(n_real):
    """``round_p`` rounds P to bf16 before P·V where the TPU forward does
    (``p.astype(dtype)``, ``dlsc_tpu/ops/attn_fast.py:151``): against the
    Pallas kernel in bf16 (interpret mode) on the same bf16 inputs, within
    one bf16 rounding of the output (2^-8 of its max |value|); the default
    path is untouched by the keyword."""
    q, k, v = (torch.from_numpy(t).to(torch.bfloat16) for t in _qkv(seed=3))
    kernel = make_fast_mha(H, N, DH, n_real, 128, 128, 128, "bfloat16", interpret=True)
    want = np.asarray(kernel(*(jnp.asarray(t[0].float().numpy(), jnp.bfloat16)
                               for t in (q, k, v))).astype(jnp.float32))
    got, _ = A.mha_forward_reference(q, k, v, n_real, round_p=True)
    err = np.abs(got[0, :, :n_real].float().numpy() - want[:, :n_real]).max()
    assert err <= 2.0**-8 * np.abs(want[:, :n_real]).max()
    plain, plain_lse = A.mha_forward_reference(q, k, v, n_real)
    again, again_lse = A.mha_forward_reference(q, k, v, n_real, round_p=False)
    assert torch.equal(plain, again) and torch.equal(plain_lse, again_lse)
    rounded_lse = A.mha_forward_reference(q.float(), k.float(), v.float(), n_real,
                                          round_p=True)[1]
    np.testing.assert_allclose(rounded_lse.numpy(), plain_lse.numpy(), rtol=1e-5, atol=1e-5)


def test_cpu_tensor_takes_plain_path():
    A.reset_launches()
    q, k, v = (torch.from_numpy(t) for t in _qkv(seed=2, b=2))
    out, lse = A.fast_mha_forward(q, k, v, 200)
    ref, ref_lse = A.mha_forward_reference(q, k, v, 200)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    assert out.shape == (2, H, N, DH) and lse.shape == (2, H, N)
    assert A.launches == 0


def test_rejects_bad_arguments():
    q, k, v = (torch.from_numpy(t) for t in _qkv())
    with pytest.raises(ValueError, match="n_real"):
        A.fast_mha_forward(q, k, v, 0)
    with pytest.raises(ValueError, match="n_real"):
        A.fast_mha_forward(q, k, v, N + 1)
    with pytest.raises(ValueError, match="shapes"):
        A.fast_mha_forward(q, k[:, :, :128], v, 100)



# (B, H, N, n_real): the five main-path shapes (AST-Base, AST-MoE / AST-Small,
# AST-Mini, the 10-s sequence, n_real == N), then ragged ones
@pytest.mark.parametrize("B,H,N,n_real", [
    (64, 12, 1664, 1645),
    (64, 6, 768, 689),
    (64, 3, 1664, 1645),
    (8, 12, 3328, 3301),
    (8, 6, 768, 768),
    (2, 3, 200, 131),
    (2, 3, 130, 130),
    (2, 3, 256, 40),
])
def test_fwd_plan(B, H, N, n_real):
    plan = A._fwd_plan(B, H, N, n_real)
    assert plan["grid"] == (-(-N // 128), B * H)
    assert plan["threads"] == 288   # 2 consumer warpgroups and a producer warp
    assert plan["key_tiles"] == -(-n_real // 64)   # key tiles past n_real are never loaded
    assert (plan["key_tiles"] - 1) * 64 < n_real <= plan["key_tiles"] * 64
    assert 48 * 1024 < plan["smem"] <= A.SMEM_LIMIT == 227 * 1024
    # the Q tile and a ring of at least two 64-key K and V tiles
    assert plan["stages"] >= 2
    assert plan["smem"] >= 1024 + 128 * 128 + plan["stages"] * 2 * 64 * 128
