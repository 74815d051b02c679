"""Port parity: the ViT's dense attention branch (``attn_impl='dense'``,
and any attention-weight dropout in train mode), ``dlsc_tpu/models/vit.py``
:132-140, against the JAX ``ASTViT``'s einsum branch, which the JAX package
runs on the CPU for every ``attn_impl``.

A small ViT (emb 64, depth 2, heads 2, f32) on (2, 128, 100) features.
Tolerances: outputs in eval mode and in train mode at dropout 0 within
1e-5 (f32 on both sides; the port pads 109 tokens to 128 and masks the pad
keys, JAX runs them unpadded, so only the summation order differs);
with dropout, one seed gives bit-identical outputs and gradients, and
remat (which redraws the masks in the re-forward from the same seed)
gives the gradients of no remat within 1e-6 normalised.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlsc_tpu.models.vit import ASTViT as JaxASTViT
from dlsc_tpu_torch.models.convert import params_from_jax
from dlsc_tpu_torch.models.vit import ASTViT, dense_attention

KW = dict(num_classes=5, emb_dim=64, depth=2, num_heads=2, dtype=torch.float32)


def _features(seed=0):
    return np.random.default_rng(seed).standard_normal((2, 128, 100)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_vit():
    jm = JaxASTViT(num_classes=5, emb_dim=64, depth=2, num_heads=2, dtype=jnp.float32,
                   dropout=0.0, attn_impl="dense")
    x = _features()
    v = jax.jit(jm.init, static_argnames="train")({"params": jax.random.key(0)},
                                                   jnp.asarray(x), train=False)
    return jm, jax.tree_util.tree_map(np.asarray, v), x


@pytest.mark.parametrize("train", [False, True])
def test_dense_matches_jax(jax_vit, train):
    jm, v, x = jax_vit
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=train,
                                                    rngs={"dropout": jax.random.key(1)}))(
        v, jnp.asarray(x)))
    model = ASTViT(**KW, attn_impl="dense")
    model.load_state_dict(params_from_jax(v, model))
    model.train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(x), dropout_seed=0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_dense_attention_masks_pad_keys():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 8, 4, generator=g) for _ in range(3))
    out = dense_attention(q, k, v, n_real=5)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 5:], v2[:, :, 5:] = 100.0, -100.0          # pad keys carry anything
    torch.testing.assert_close(dense_attention(q, k2, v2, n_real=5), out, rtol=0, atol=0)
    p = torch.softmax(q @ k[:, :, :5].transpose(-1, -2), -1)
    torch.testing.assert_close(out, p @ v[:, :, :5], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("impl", ["dense", "splash"])
def test_attention_dropout_is_seeded_and_survives_remat(impl):
    """In train mode attention dropout takes the dense branch whatever the
    impl (the JAX kernels have none): one seed, one set of masks; another
    seed, others; the remat re-forward draws the same masks."""
    x = torch.from_numpy(_features(1))

    def run(seed, remat):
        model = ASTViT(**KW, attn_impl=impl, attn_dropout=0.3, remat=remat,
                       generator=torch.Generator().manual_seed(2)).train()
        out = model(x, dropout_seed=seed)
        out.square().sum().backward()
        return out.detach(), [p.grad for p in model.parameters()]

    a, ga = run(7, False)
    b, gb = run(7, False)
    c, _ = run(8, False)
    r, gr = run(7, True)
    assert torch.equal(a, b) and all(torch.equal(u, w) for u, w in zip(ga, gb))
    assert not torch.equal(a, c)
    torch.testing.assert_close(r, a, rtol=0, atol=1e-6)
    for u, w in zip(gr, ga):
        assert ((u - w).abs().max() / w.abs().max().clamp_min(1e-30)).item() < 1e-6
    with torch.no_grad():   # eval mode: no dropout, the impl's own path
        model = ASTViT(**KW, attn_impl=impl, attn_dropout=0.3,
                       generator=torch.Generator().manual_seed(2))
        plain = ASTViT(**KW, attn_impl=impl, generator=torch.Generator().manual_seed(2))
        torch.testing.assert_close(model(x), plain(x), rtol=0, atol=0)
