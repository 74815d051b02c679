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
  since a last-bit difference in the f32 value can round either way;
- dgamma / dbeta summed as K3b sums them (``_mirror_bwd_sums``, a numpy
  mirror of its order: each thread's rows in walk order, a CTA's (warp, row
  slot) sums in order, the CTAs' partials in the summing kernel's order)
  against the plain backward and the Pallas kernel: 1e-6 normalised (f32
  sums of the same terms in other orders).
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
    # K3b's grid is fixed by the shape and the SM count: one tile, one CTA here
    plan = L._bwd_plan(7 * 3, 24, 132)
    assert (plan["tiles"], plan["grid"]) == (1, 1)
    assert L._bwd_plan(10**6, 24, 132)["grid"] == 132 * L.BWD_CTAS_PER_SM


def _fma(a, b, c):
    """a * b + c rounded once to f32, as the card's FFMA (the f64 product of
    two f32 values is exact)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c).astype(np.float32)


def _mirror_bwd_sums(r, mu, rsig, dy, plan):
    """dgamma, dbeta (f32) summed in K3b's order (``csrc/ln_fused.cu``): the
    thread of (CTA, warp, slot) adds dy * xhat and dy of its rows in walk
    order (its CTA's tiles, ``_bwd_tiles``; in a tile the row groups warp,
    warp + 4, ...; in a group row slot), with xhat = (r - mu) * rsig in f32;
    the CTA adds its (warp, slot) sums in that order; the summing kernel's
    warp s adds the CTAs s, s + 32, ... and its warp 0 the 32 sums in order."""
    rows, d = dy.shape
    R, rpw, W, grid = plan["tile_rows"], plan["rows_per_warp"], L.BWD_WARPS, plan["grid"]
    xh = (r - mu[:, None]) * rsig[:, None]
    zero = np.zeros(d, np.float32)
    parts = []
    for cta in range(grid):
        sums = []
        for w in range(W):
            for slot in range(rpw):
                pg, pb = zero.copy(), zero.copy()
                for t in L._bwd_tiles(plan, cta):
                    for grp in range(w, R // rpw, W):
                        row = t * R + grp * rpw + slot
                        if row < rows:
                            pg = _fma(dy[row], xh[row], pg)
                            pb = pb + dy[row]
                sums.append((pg, pb))
        cta_sum = sums[0]
        for pg, pb in sums[1:]:
            cta_sum = (cta_sum[0] + pg, cta_sum[1] + pb)
        parts.append(cta_sum)
    out = []
    for which in range(2):
        acc = []
        for s in range(L.REDUCE_SPLIT):
            a = zero.copy()
            for b in range(s, grid, L.REDUCE_SPLIT):
                a = a + parts[b][which]
            acc.append(a)
        total = acc[0]
        for a in acc[1:]:
            total = total + a
        out.append(total)
    return out


@pytest.mark.parametrize("rows,d,n_sm", [(1003, 384, 4), (517, 768, 3), (1001, 192, 2),
                                         (1, 384, 132), (37, 8, 1)])
def test_kernel_summation_order_matches_plain_backward(rows, d, n_sm):
    """K3b's dgamma / dbeta order (``_mirror_bwd_sums``) against the plain
    backward, at a few SMs so that every CTA walks several tiles and the last
    tile is short (1003 rows are 125 tiles of 8 and one of 3 rows)."""
    rng = np.random.default_rng(rows + d)
    x, delta, gamma, beta = _inputs(rows, (rows, d))
    dr, dy = (rng.standard_normal((rows, d)).astype(np.float32) for _ in range(2))
    r, _, mu, rsig = L.add_ln_reference(*(torch.from_numpy(t) for t in (x, delta, gamma, beta)))
    _, dgamma, dbeta = L.add_ln_backward_reference(r, mu, rsig, torch.from_numpy(gamma),
                                                   torch.from_numpy(dr), torch.from_numpy(dy))
    plan = L._bwd_plan(rows, d, n_sm)
    assert plan["grid"] == min(n_sm * L.BWD_CTAS_PER_SM, plan["tiles"])
    got = _mirror_bwd_sums(r.numpy(), mu.numpy(), rsig.numpy(), dy, plan)
    for g, w in zip(got, (dgamma.numpy(), dbeta.numpy())):
        assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max()


@pytest.mark.parametrize("rows,d", [(1000, 192), (256, 384)])
def test_kernel_summation_order_matches_jax(rows, d):
    """The same order against dgamma / dbeta of the Pallas kernel's VJP
    (interpret mode) for the same cotangents (dr, dy)."""
    rng = np.random.default_rng(d)
    x, delta, gamma, beta = _inputs(d, (rows, d))
    dr, dy = (rng.standard_normal((rows, d)).astype(np.float32) for _ in range(2))
    _, vjp = jax.vjp(lambda *a: jax_fused_add_ln(*a, interpret=True),
                     *(jnp.asarray(t) for t in (x, delta, gamma, beta)))
    _, _, jg, jb = vjp((jnp.asarray(dr), jnp.asarray(dy)))
    r, _, mu, rsig = L.add_ln_reference(*(torch.from_numpy(t) for t in (x, delta, gamma, beta)))
    got = _mirror_bwd_sums(r.numpy(), mu.numpy(), rsig.numpy(), dy, L._bwd_plan(rows, d, 3))
    for g, w in zip(got, (np.asarray(jg), np.asarray(jb))):
        assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max()


# ---- the LayerNorm alone (K3 with the add compiled out; models/vit.py _layer_norm) ----

def _expression(x, weight, bias):
    """``_layer_norm``'s plain expression: PyTorch's LN on an f32 copy."""
    return torch.nn.functional.layer_norm(x.float(), (x.shape[-1],), weight, bias,
                                          L.EPS).to(x.dtype)


def _ln_inputs(seed, shape, dtype):
    x, _, gamma, beta = _inputs(seed, shape)
    return torch.from_numpy(x).to(dtype), torch.from_numpy(gamma), torch.from_numpy(beta)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("strided", [False, True])
def test_layer_norm_is_the_expression_on_the_cpu(dtype, strided):
    """On the CPU ``layer_norm`` runs the expression's own ops: y and the
    gradients of x, gamma and beta equal the expression's and its autograd's
    bit for bit, in bf16 and f32, also on strided rows (the final norm's CLS
    rows ``x[:, 0]``); it counts no launch, and its backward is the
    ``ln_bwd`` op alone (no zero gradients made for mu and rsig)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func.overloadpacket))
            return func(*args, **(kwargs or {}))

    x, gamma, beta = _ln_inputs(7, (6, 5, 48), dtype)
    dy = torch.from_numpy(np.random.default_rng(8).standard_normal((6, 48) if strided else
                                                                     (6, 5, 48))).to(dtype)
    outs = []
    L.reset_launches()
    for fn in (L.layer_norm, _expression):
        leaves = [t.clone().requires_grad_() for t in (x, gamma, beta)]
        y = fn(leaves[0][:, 0] if strided else leaves[0], leaves[1], leaves[2])
        with Ops() as ops:
            y.backward(dy)
        if fn is L.layer_norm:
            assert ops.names.count("dlsc_tpu_torch.ln_bwd") == 1, ops.names
            assert "aten.zeros" not in ops.names, ops.names
        outs.append((y.detach(), *(t.grad for t in leaves)))
    for got, want, name in zip(*outs, ("y", "dx", "dgamma", "dbeta")):
        assert got.dtype == want.dtype and torch.equal(got, want), name
    assert (L.ln_launches, L.ln_bwd_launches, L.launches, L.bwd_launches) == (0, 0, 0, 0)


@pytest.mark.parametrize("shared", [True, False])
def test_layer_norm_vmap_matches_a_loop(shared, monkeypatch):
    """``torch.func.vmap`` of the LN's value and gradients over 3 trials,
    with gamma and beta shared or per trial (K, d) as the vmapped HPO stacks
    them, equals a loop over the trials bit for bit; the forward op runs
    once for all trials with shared gamma and beta, else once a trial, and
    the backward once a trial (dgamma and dbeta are one trial's sums)."""
    from torch.func import grad_and_value, vmap

    K = 3
    x, gamma, beta = _ln_inputs(9, (K, 10, 64), torch.bfloat16)
    gamma, beta = gamma + 0.1 * torch.arange(K)[:, None], beta.expand(K, 64).clone()
    cot = torch.from_numpy(np.random.default_rng(10).standard_normal((K, 10, 64))).bfloat16()
    if shared:
        gamma, beta = gamma[0], beta[0]
    calls = {"fwd": 0, "bwd": 0}
    for name, key in (("ln_forward", "fwd"), ("ln_backward", "bwd")):
        def counted(*a, _f=getattr(L, name), _k=key):
            calls[_k] += 1
            return _f(*a)
        monkeypatch.setattr(L, name, counted)
    f = lambda a, g, b, t: (L.layer_norm(a, g, b).float() * t.float()).sum()  # noqa: E731
    pd = None if shared else 0
    got_g, got_v = vmap(grad_and_value(f, argnums=(0, 1, 2)), in_dims=(0, pd, pd, 0))(
        x, gamma, beta, cot)
    assert calls == {"fwd": 1 if shared else K, "bwd": K}
    for i in range(K):
        p = (gamma, beta) if shared else (gamma[i], beta[i])
        want_g, want_v = grad_and_value(f, argnums=(0, 1, 2))(x[i], *p, cot[i])
        assert torch.equal(got_v[i], want_v)
        for g, w in zip(got_g, want_g):
            assert torch.equal(g[i], w)


@pytest.mark.parametrize("device,dtype,d,path", [
    ("cpu", torch.bfloat16, 64, "plain"), ("cpu", torch.float32, 64, "plain"),
    ("cuda", torch.bfloat16, 64, "kernel"), ("cuda", torch.float32, 64, "plain"),
    ("cuda", torch.bfloat16, 100, "raises")])
def test_layer_norm_site_takes_the_kernel_on_cuda_bf16_alone(device, dtype, d, path,
                                                            monkeypatch):
    """``models/vit.py`` ``_layer_norm`` takes ``ops.ln_fused.layer_norm`` for
    every CUDA bf16 stream, and keeps today's expression, bit for bit, for
    the CPU and f32 (CUDA tensors as fake tensors here: the op's fake shape,
    dtype and device). A CUDA bf16 width that the kernels do not take raises,
    as ``add_ln`` does, and never falls back to PyTorch's LN."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from dlsc_tpu_torch.models import vit

    seen = []
    monkeypatch.setattr(vit, "kernel_layer_norm",
                        lambda x, w, b: seen.append(x.shape) or L.layer_norm(x, w, b))
    if device == "cpu":
        ln = torch.nn.LayerNorm(d, eps=vit.LN_EPS)
        x = torch.from_numpy(np.random.default_rng(d).standard_normal((4, 3, d))).to(dtype)
        with torch.no_grad():
            ln.weight.uniform_(0.5, 1.5)
            ln.bias.uniform_(-0.5, 0.5)
        assert torch.equal(vit._layer_norm(x, ln), _expression(x, ln.weight, ln.bias))
    else:
        with FakeTensorMode(), torch.no_grad():   # no autograd graph on a card that is not here
            x = torch.empty(4, 3, d, device="cuda", dtype=dtype)
            ln = torch.nn.LayerNorm(d, eps=vit.LN_EPS, device="cuda")
            if path == "raises":
                with pytest.raises(ValueError, match="multiple of 8"):
                    vit._layer_norm(x, ln)
            else:
                y = vit._layer_norm(x, ln)
                assert (y.shape, y.dtype, y.device.type) == (x.shape, dtype, "cuda")
    assert seen == ([] if path == "plain" else [(4, 3, d)])
