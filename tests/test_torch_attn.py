"""Port parity: kernel K2's module (masked attention forward).

``mha_forward_reference`` — what a CPU tensor runs and the kernel's oracle
on the card — against the JAX shape-specialised Pallas kernel
(``make_fast_mha``, interpret mode) on the same numpy-seeded f32 inputs,
rows < n_real, at the 2e-5 of tests/test_attn_fast.py; its lse against a
float64 numpy logsumexp of the masked scores at 1e-5.
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

