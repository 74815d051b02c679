"""Port parity: the fused residual add + LayerNorm (kernel K3's plain
version and the ``dlsc_tpu_torch::add_ln`` op) against the JAX package's
Pallas kernel ``dlsc_tpu.ops.ln_fused.fused_add_ln`` run in interpret mode
on the CPU.

Tolerances, each with its reason:

- r in f32: exact (both sides round one f32 sum to f32); in bf16 exact too
  (both round the same f32 sum to bf16);
- y in f32: 1e-5 absolute at unit-scale inputs (the same formula; the
  means are summed in another order);
- the four gradients in f32: 1e-5 normalised by the largest |gradient|
  (dgamma and dbeta are sums over every row: summation order only);
- y in bf16: one bf16 rounding step of |y| (2^-7 relative, at |y| up to ~4),
  since a last-bit difference in the f32 value can round either way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlsc_tpu.ops.ln_fused import fused_add_ln as jax_fused_add_ln
from dlsc_tpu_torch.ops import ln_fused as L


def _inputs(seed, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x, delta = (rng.standard_normal(shape).astype(dtype) for _ in range(2))
    gamma = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, delta, gamma, beta


def _jax_fused(x, delta, gamma, beta):
    return jax.jit(lambda *a: jax_fused_add_ln(*a, interpret=True))(
        *(jnp.asarray(t) for t in (x, delta, gamma, beta)))


@pytest.mark.parametrize("shape", [(64, 256), (48, 384), (4, 16, 192)])
def test_forward_matches_jax(shape):
    x, delta, gamma, beta = _inputs(0, shape)
    jr, jy = _jax_fused(x, delta, gamma, beta)
    r, y, mu, rsig = L.fused_add_ln_forward(*(torch.from_numpy(t) for t in (x, delta, gamma,
                                                                             beta)))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    assert mu.shape == rsig.shape == shape[:-1] and mu.dtype == rsig.dtype == torch.float32
    rf = x.astype(np.float64) + delta
    np.testing.assert_allclose(mu.numpy(), rf.mean(-1), atol=1e-6)
    np.testing.assert_allclose(rsig.numpy(), 1 / np.sqrt(rf.var(-1) + L.EPS), rtol=1e-5)


def test_gradients_match_jax():
    """All four gradients through the op (its plain backward on the CPU)
    against ``jax.grad`` of the Pallas kernel's custom VJP, with both r and
    y in the loss, as the model uses them (``tests/test_ln_fused.py``)."""
    rows, d = 64, 256
    x, delta, gamma, beta = _inputs(1, (rows, d))
    rng = np.random.default_rng(2)
    wr, wy = (rng.standard_normal((rows, d)).astype(np.float32) for _ in range(2))

    def jloss(*a):
        r, y = jax_fused_add_ln(*a, interpret=True)
        return jnp.sum(r * wr) + jnp.sum(y * wy)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(
        *(jnp.asarray(t) for t in (x, delta, gamma, beta)))
    ts = [torch.from_numpy(t).requires_grad_() for t in (x, delta, gamma, beta)]
    r, y, _, _ = L.add_ln(*ts)
    ((r * torch.from_numpy(wr)).sum() + (y * torch.from_numpy(wy)).sum()).backward()
    for t, w, name in zip(ts, want, ("dx", "ddelta", "dgamma", "dbeta")):
        w = np.asarray(w)
        err = np.abs(t.grad.numpy() - w).max() / np.abs(w).max()
        assert err < 1e-5, (name, err)


def test_backward_reference_is_the_autograd_of_the_forward():
    """In f32 the plain backward (from the stored r) equals autograd through
    the plain forward, with dx the gradient of both x and delta (1e-5
    normalised: the same function, rounded in another order)."""
    x, delta, gamma, beta = _inputs(3, (3, 5, 64))
    ts = [torch.from_numpy(t).requires_grad_() for t in (x, delta, gamma, beta)]
    rng = np.random.default_rng(4)
    dr, dy = (torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
              for _ in range(2))
    r, y, mu, rsig = L.add_ln_reference(*ts)
    torch.autograd.backward((r, y), (dr, dy))
    dx, dgamma, dbeta = L.add_ln_backward_reference(r.detach(), mu.detach(), rsig.detach(),
                                                    ts[2].detach(), dr, dy)
    for got, t in ((dx, ts[0]), (dx, ts[1]), (dgamma, ts[2]), (dbeta, ts[3])):
        assert ((got - t.grad).abs().max() / t.grad.abs().max()).item() < 1e-5


def test_bf16_matches_jax():
    x, delta, gamma, beta = _inputs(5, (4, 16, 256))
    xb, db = (torch.from_numpy(t).bfloat16() for t in (x, delta))
    jr, jy = _jax_fused(np.asarray(xb.float().numpy(), jnp.bfloat16),
                        np.asarray(db.float().numpy(), jnp.bfloat16), gamma, beta)
    r, y, _, _ = L.fused_add_ln_forward(xb, db, torch.from_numpy(gamma),
                                        torch.from_numpy(beta))
    assert r.dtype == y.dtype == torch.bfloat16 and np.asarray(jr).dtype == jnp.bfloat16
    np.testing.assert_array_equal(r.float().numpy(), np.asarray(jr, np.float32))
    jy = np.asarray(jy, np.float32)
    assert np.abs(y.float().numpy() - jy).max() <= 2**-7 * np.abs(jy).max()
    # the unrounded f32 sum feeds the statistics: not LN of the stored bf16 r
    y_unfused = torch.nn.functional.layer_norm(r.float(), (256,), torch.from_numpy(gamma),
                                               torch.from_numpy(beta), L.EPS)
    assert not torch.equal(y_unfused.bfloat16(), y)


@pytest.mark.parametrize("d", [4, 100, 1032])
def test_unsupported_width_raises(d):
    x = torch.zeros(8, d)
    w = torch.ones(d)
    with pytest.raises(ValueError, match="multiple of 8"):
        L.fused_add_ln_forward(x, x, w, w)
    with pytest.raises(ValueError, match="multiple of 8"):
        L.fused_add_ln_backward(x, x[:, 0], x[:, 0], w, x, x)


def test_any_row_count_and_no_launch_on_the_cpu():
    """Rows need not be a multiple of 8 (a TPU grain); CPU tensors take the
    plain version and count no launch."""
    x, delta, gamma, beta = _inputs(6, (7, 3, 24))
    L.reset_launches()
    r, y, _, _ = L.add_ln(*(torch.from_numpy(t) for t in (x, delta, gamma, beta)))
    assert r.shape == y.shape == (7, 3, 24)
    assert (L.launches, L.bwd_launches) == (0, 0)
    assert L.backward_blocks(7 * 3) == 3 and L.backward_blocks(10**6) == L.BWD_MAX_BLOCKS
