"""Port parity: the grouped matmul (K4's plain versions and its autograd)
against megablox ``gmm`` / ``tgmm`` run in interpret mode on the CPU, as
``tests/test_moe.py`` runs them.

Group sizes include an empty group and sizes that are not multiples of 8
(megablox needs only the row count to be a multiple of its 8-row tile).
Tolerance: f32, 1e-5 (summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.megablox import ops as megablox
from jax.experimental.pallas.ops.tpu.megablox.gmm import tgmm as megablox_tgmm

from dlsc_tpu_torch.ops import gmm as G

TILING = (8, 8, 8)
SIZES = [(16, 0, 27, 21), (3, 40, 0, 5, 0, 16)]


def _inputs(sizes, k=16, n=24, seed=0):
    rng = np.random.default_rng(seed)
    m = sum(sizes)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((len(sizes), k, n)).astype(np.float32),
            rng.standard_normal((m, n)).astype(np.float32),
            np.asarray(sizes, np.int32))


@pytest.mark.parametrize("transpose_rhs", [False, True])
@pytest.mark.parametrize("sizes", SIZES)
def test_gmm_matches_megablox(sizes, transpose_rhs):
    lhs, rhs, _, gs = _inputs(sizes)
    if transpose_rhs:
        rhs = np.ascontiguousarray(rhs.transpose(0, 2, 1))
    want = megablox.gmm(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(gs), jnp.float32,
                        TILING, None, None, transpose_rhs, True)
    got = G.gmm(torch.from_numpy(lhs), torch.from_numpy(rhs), torch.from_numpy(gs),
                transpose_rhs=transpose_rhs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sizes", SIZES)
def test_tgmm_matches_megablox(sizes):
    lhs, _, grad, gs = _inputs(sizes)
    want = megablox_tgmm(jnp.asarray(lhs).swapaxes(0, 1), jnp.asarray(grad), jnp.asarray(gs),
                         jnp.float32, TILING, None, None, None, True)
    got = G.tgmm(torch.from_numpy(lhs), torch.from_numpy(grad), torch.from_numpy(gs))
    assert got.shape == (len(sizes), 16, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for g, size in enumerate(sizes):
        if size == 0:
            assert (got[g] == 0).all()


def test_grouped_matmul_vjp_matches_megablox():
    """dlhs and drhs of the custom op against ``jax.vjp`` of megablox gmm
    (its custom VJP: gmm with the transposed rhs, and tgmm)."""
    lhs, rhs, grad, gs = _inputs(SIZES[0], seed=1)
    out, vjp = jax.vjp(lambda a, b: megablox.gmm(a, b, jnp.asarray(gs), jnp.float32, TILING,
                                                 None, None, False, True),
                       jnp.asarray(lhs), jnp.asarray(rhs))
    want_dlhs, want_drhs = vjp(jnp.asarray(grad))
    a, b = (torch.from_numpy(t).requires_grad_() for t in (lhs, rhs))
    got = G.grouped_matmul(a, b, torch.from_numpy(gs))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=1e-5, atol=1e-5)
    got.backward(torch.from_numpy(grad))
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(want_dlhs), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(want_drhs), rtol=1e-5, atol=1e-5)


def test_cpu_wrappers_run_the_plain_versions_and_check_their_input():
    """CPU tensors take the plain versions (no launch is counted); bad
    group sizes raise before anything runs."""
    lhs, rhs, grad, gs = (torch.from_numpy(t) for t in _inputs(SIZES[1]))
    G.reset_launches()
    assert torch.equal(G.gmm(lhs, rhs, gs), G.gmm_reference(lhs, rhs, gs))
    assert torch.equal(G.tgmm(lhs, grad, gs), G.tgmm_reference(lhs, grad, gs))
    assert (G.launches, G.tgmm_launches) == (0, 0)
    with pytest.raises(ValueError, match="sum"):
        G.gmm(lhs, rhs, gs + 1)
    with pytest.raises(ValueError, match="int32"):
        G.gmm(lhs, rhs, gs.long())
    with pytest.raises(ValueError, match="chain"):
        G.gmm(lhs, rhs, gs, transpose_rhs=True)
    with pytest.raises(ValueError, match="same rows"):
        G.tgmm(lhs, grad[1:], gs)
    # the plain version leaves rows past the groups at 0
    short = gs.clone()
    short[1] -= 4
    assert (G.gmm_reference(lhs, rhs, short)[-4:] == 0).all()
