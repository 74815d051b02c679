"""Port parity: the AST model with weights converted from JAX.

A small ``ASTModel`` (emb 64, depth 2, heads 2, f32) is initialised in JAX
in both parameter layouts (unrolled ``blocks_{i}`` and scanned
``blocks/block``), converted with ``params_from_jax``, and both packages
run the same numpy-seeded 1-s features in eval mode. The JAX side runs
unpadded dense attention on the CPU; the port pads 325 tokens to 384 and
masks keys >= 325. Tolerance on the sigmoid outputs: 1e-4 relative, 1e-5
absolute (f32, summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlsc_tpu.models.ast import ASTModel as JaxASTModel
from dlsc_tpu_torch.models.ast import ASTModel
from dlsc_tpu_torch.models.convert import params_from_jax

SMALL = dict(num_classes=50, emb_dim=64, depth=2, num_heads=2)


def _features(seed=0, b=2, t=276):  # 276 frames = 1 s at hop 160
    return np.random.default_rng(seed).standard_normal((b, 128, t)).astype(np.float32)


def _jax_model_and_params(scan_blocks, feats):
    model = JaxASTModel(**SMALL, dtype=jnp.float32, scan_blocks=scan_blocks, remat=False)
    variables = model.init({"params": jax.random.key(0)}, jnp.asarray(feats), train=False)
    return model, variables, jax.tree_util.tree_map(np.asarray, variables["params"])


@pytest.mark.parametrize("scan_blocks", [False, True], ids=["unrolled", "stacked"])
def test_converted_model_matches_jax(scan_blocks):
    feats = _features()
    jmodel, variables, params = _jax_model_and_params(scan_blocks, feats)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(feats), train=False))

    model = ASTModel(**SMALL, dtype=torch.float32)
    model.load_state_dict(params_from_jax(params, model))
    tokens, n_real = model.embed(torch.from_numpy(feats))
    assert (tokens.shape[1], n_real) == (384, 325)  # 12 x 27 patches + CLS, 128 grain
    got = model(torch.from_numpy(feats)).detach().numpy()
    assert got.shape == want.shape == (2, 50)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_converter_rejects_a_mismatched_model():
    _, _, params = _jax_model_and_params(False, _features())
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(params, ASTModel(**dict(SMALL, depth=3), dtype=torch.float32))
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(params, ASTModel(**dict(SMALL, num_classes=7), dtype=torch.float32))


def test_seeded_init_is_reproducible_and_flax_scaled():
    a = ASTModel(**SMALL, generator=torch.Generator().manual_seed(3))
    b = ASTModel(**SMALL, generator=torch.Generator().manual_seed(3))
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    w = a.blocks[0].mlp.fc1.weight  # lecun normal: std 1/sqrt(fan_in)
    assert abs(w.std().item() * 64**0.5 - 1.0) < 0.1
    assert a.dtype == torch.bfloat16 and a.config["dtype"] == "bfloat16"


def test_stride_must_match_overlap():
    with pytest.raises(ValueError, match="patch_stride"):
        ASTModel(**SMALL, patch_stride=16, overlap=6)
