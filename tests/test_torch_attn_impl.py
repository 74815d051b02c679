"""Port parity: the JAX package's two library attention kernels, K5 (the
generic splash path, ``dlsc_tpu/models/vit.py:349`` ``_splash_mha``) and K6
(``vit.py:518`` ``_flash_mha``, flash attention with segment ids), against
the port's ``dlsc_tpu_torch::mha`` op, which serves both ``attn_impl``
choices (its plain version on the CPU).

The JAX kernels run in interpret mode on the CPU: K5 with
``DLSC_ATTN_INTERPRET=1`` and ``DLSC_SPLASH_BLOCKS=128,128,128`` (a splash
knob forces the generic path, ``vit.py:377-383``), K6 under
``pltpu.force_tpu_interpret_mode()``. Shape (1, 2, 384, 64) f32, with
``n_real`` 300 (a column mask on K5, pad segments on K6) and ``n_real`` = N
(K5's FullMask, K6 unpadded). Forward and the gradients of q, k and v on
the real rows, from a loss over the real rows only (what the model reads):
1e-5 normalised by the largest |value| (f32 on both sides; the kernels sum
in blocks of 128, the plain version in one pass).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlsc_tpu.models import vit as jvit
from dlsc_tpu_torch.models.vit import ASTViT
from dlsc_tpu_torch.ops.attn_fast import fast_mha

SHAPE = (1, 2, 384, 64)
SCALE = SHAPE[-1] ** -0.5


def _inputs(n_real):
    rng = np.random.default_rng(n_real)
    return [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(4)]


def _jax_attention(fn, q, k, v, cot, n_real):
    """(out, dq, dk, dv) of ``fn`` from one VJP, the loss over real rows."""
    def loss(q, k, v):
        out = fn(q, k, v, sm_scale=SCALE, n_real=n_real)
        return jnp.sum(out[:, :, :n_real] * cot[:, :, :n_real]), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(t) for t in (q, k, v)))
    return [np.asarray(t) for t in (out, *grads)]


def _port_attention(q, k, v, cot, n_real):
    ts = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = fast_mha(ts[0] * SCALE, ts[1], ts[2], n_real)
    (out[:, :, :n_real] * torch.from_numpy(cot)[:, :, :n_real]).sum().backward()
    return [t.detach().numpy() for t in (out, *(t.grad for t in ts))]


def _assert_close(got, want, n_real):
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        g, w = g[:, :, :n_real], w[:, :, :n_real]
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err < 1e-5, (name, err)


@pytest.mark.parametrize("n_real", [300, 384])
def test_k5_generic_splash_matches_the_port(n_real, monkeypatch):
    monkeypatch.setenv("DLSC_ATTN_INTERPRET", "1")
    monkeypatch.setenv("DLSC_SPLASH_BLOCKS", "128,128,128")
    q, k, v, cot = _inputs(n_real)
    want = _jax_attention(jvit._splash_mha, q, k, v, cot, n_real)
    _assert_close(_port_attention(q, k, v, cot, n_real), want, n_real)


@pytest.mark.parametrize("n_real", [300, 384])
def test_k6_flash_matches_the_port(n_real):
    from jax.experimental.pallas import tpu as pltpu

    q, k, v, cot = _inputs(n_real)
    with pltpu.force_tpu_interpret_mode():
        want = _jax_attention(jvit._flash_mha, q, k, v, cot, n_real)
    _assert_close(_port_attention(q, k, v, cot, n_real), want, n_real)


def test_attn_impl_choices():
    """'splash' and 'flash' build the same model (both run the mha op) and
    are kept in the config; 'dense' (the einsum branch) gives the same
    outputs in eval mode; an unknown impl or a dropout rate out of [0, 1)
    raises."""
    kw = dict(num_classes=5, emb_dim=64, depth=1, num_heads=2, dtype=torch.float32)
    x = torch.randn(2, 128, 100, generator=torch.Generator().manual_seed(0))
    outs = []
    for impl in ("splash", "flash"):
        model = ASTViT(**kw, attn_impl=impl, generator=torch.Generator().manual_seed(1))
        assert model.config["attn_impl"] == impl
        with torch.no_grad():
            outs.append(model(x))
    assert torch.equal(*outs)
    dense = ASTViT(**kw, attn_impl="dense", attn_dropout=0.1,
                   generator=torch.Generator().manual_seed(1))
    assert dense.config["attn_impl"] == "dense"
    with torch.no_grad():
        torch.testing.assert_close(dense(x), outs[0], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="attn_impl"):
        ASTViT(**kw, attn_impl="ring")
    with pytest.raises(ValueError, match="attn_dropout"):
        ASTViT(**kw, attn_dropout=1.0)
