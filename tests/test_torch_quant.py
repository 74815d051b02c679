"""Int8 serving (``dlsc_tpu_torch/ops/quant.py`` and the ``quant`` mode of the
AST models) against the JAX package's ``dlsc_tpu/ops/quant.py`` on the CPU.

Tolerances, each with its reason:

- the int8 weights equal the JAX ``'quant'`` collection exactly and the
  scales are within 1 ulp (the same f32 max, division and round half to
  even);
- ``quantize_act`` exact; the int32 accumulator of ``int8_dot`` exact (an
  integer product); ``int8_dot`` and ``w8_dot`` outputs 1e-6 relative to
  their max (f32 rescale; f32 sums in another order for ``w8``);
- the quantised ViT forward in f32 (AST-Mini and AST-Small trunks at tiny
  widths, the same weights): ``w8`` within 1e-5 of JAX's (f32 summation
  order only); ``w8a8`` within 1e-4 of JAX's, where a near-tie of an
  activation between two int8 steps may round the other way in the other
  package and move that product by one step (measured here: no flip, 1e-7);
- each package's quantised forward against the f32 forward within
  ``tests/test_quant.py``'s bars, 0.05 for ``w8a8`` and 0.06 for ``w8``;
- an export → load round trip with ``+quant`` equal to the in-memory model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlsc_tpu.models.vit import ASTViT as JaxASTViT
from dlsc_tpu.ops import quant as JQ
from dlsc_tpu_torch.models.convert import params_from_jax
from dlsc_tpu_torch.models.vit import ASTViT, quantize_model
from dlsc_tpu_torch.ops import quant as Q
from dlsc_tpu_torch.scripts import export
from dlsc_tpu_torch.serving import load_exported

# AST-Mini's and AST-Small's trunks at tiny widths (their patch strides)
TRUNKS = {
    "ast_mini": dict(num_classes=7, emb_dim=64, depth=2, num_heads=4, patch_size=16,
                     patch_stride=10, overlap=6, sample_rate=4410, f_dim=64),
    "ast_small": dict(num_classes=7, emb_dim=96, depth=2, num_heads=6, patch_size=16,
                      patch_stride=16, overlap=0, sample_rate=4410, f_dim=64),
}
F32_BAR = {"w8a8": 0.05, "w8": 0.06}   # tests/test_quant.py's bars
JAX_BAR = {"w8a8": 1e-4, "w8": 1e-5}


def _x(batch=2, frames=276, mels=64):
    return np.random.default_rng(0).standard_normal((batch, mels, frames)).astype(np.float32)


def _pair(trunk: str, mode: str):
    """(JAX model, its variables with the quant collection, port model with
    the same float weights in ``mode``, the f32 JAX forward)."""
    kw = TRUNKS[trunk]
    x = jnp.asarray(_x())
    jmodel = JaxASTViT(**kw, dropout=0.0, dtype=jnp.float32)
    variables = jmodel.init({"params": jax.random.key(0)}, x, train=False)
    ref = np.asarray(jmodel.apply(variables, x, train=False))
    jq = JaxASTViT(**kw, dropout=0.0, dtype=jnp.float32, quant=mode)
    vq = JQ.materialize(jq, variables, x)
    model = ASTViT(**kw, dtype=torch.float32)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                 variables["params"]), model))
    return jq, vq, quantize_model(model, mode), ref


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32)).max())


@pytest.mark.parametrize("mode", ["w8a8", "w8"])
def test_int8_weights_equal_the_jax_collection(mode):
    _, vq, model, _ = _pair("ast_mini", mode)
    D = TRUNKS["ast_mini"]["emb_dim"]
    for i, blk in enumerate(model.blocks):
        jb = jax.tree_util.tree_map(lambda a: np.asarray(a)[i],   # the stacked layout
                                    vq["quant"]["blocks"]["block"])
        pairs = {"attn.qkv": (jb["attn"]["qkv"], (D, 3 * D)), "attn.proj": (jb["attn"]["proj"],
                                                                             (D, D)),
                 "mlp.fc1": (jb["mlp"]["fc1"], (D, 4 * D)), "mlp.fc2": (jb["mlp"]["fc2"],
                                                                       (4 * D, D))}
        for name, (jl, shape) in pairs.items():
            layer = blk.get_submodule(name)
            np.testing.assert_array_equal(layer.weight_q.numpy(),
                                          jl["kernel_q"].reshape(shape).T, err_msg=name)
            scale = jl["kernel_scale"].reshape(-1).astype(np.float32)
            assert _ulps(layer.weight_scale.numpy(), scale) <= 1, name


def test_quantize_and_dots_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((40, 64)).astype(np.float32)
    w = rng.standard_normal((96, 64)).astype(np.float32)     # (out, in)
    w_q, scale = Q.quantize_weight(torch.from_numpy(w))
    jw_q, jscale = JQ.quantize_weight(jnp.asarray(w.T))
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(jw_q).T)
    assert _ulps(scale.numpy(), np.asarray(jscale)) <= 1
    x_q, s = Q.quantize_act(torch.from_numpy(x))
    jx_q, js = JQ.quantize_act(jnp.asarray(x))
    np.testing.assert_array_equal(x_q.numpy(), np.asarray(jx_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    acc = torch._int_mm(x_q, w_q.t())
    jacc = jax.lax.dot_general(jx_q, jw_q, (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    for port, jax_dot in ((Q.int8_dot, JQ.int8_dot), (Q.w8_dot, JQ.w8_dot)):
        got = port(torch.from_numpy(x).view(4, 10, 64), w_q, scale, torch.float32).numpy()
        want = np.asarray(jax_dot(jnp.asarray(x).reshape(4, 10, 64), jw_q, jscale, jnp.float32))
        assert got.shape == want.shape == (4, 10, 96)
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-6, port.__name__


@pytest.mark.parametrize("trunk", sorted(TRUNKS))
@pytest.mark.parametrize("mode", ["w8a8", "w8"])
def test_quantized_forward_matches_jax(trunk, mode):
    jq, vq, model, ref = _pair(trunk, mode)
    x = _x()
    want = np.asarray(jq.apply(vq, jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    err = float(np.abs(got - want).max())
    print(f"{trunk} {mode}: port vs JAX {err:.2e}, vs f32 {np.abs(got - ref).max():.2e}")
    assert err < JAX_BAR[mode]
    assert np.abs(got - ref).max() < F32_BAR[mode]
    assert np.abs(want - ref).max() < F32_BAR[mode]


def test_refusals():
    kw = TRUNKS["ast_mini"]
    model = ASTViT(**kw, quant="w8a8").train()
    with pytest.raises(ValueError, match="inference-only"):
        model(torch.from_numpy(_x()))
    with pytest.raises(ValueError, match="unknown quant mode"):
        ASTViT(**kw, quant="int8")
    with pytest.raises(ValueError, match="MoE"):
        ASTViT(**kw, quant="w8", moe=dict(n_experts=4, top_k=2, dispatch="ragged"))
    with pytest.raises(ValueError, match="no int8 buffers"):
        Q.materialize(ASTViT(**kw))


def test_quant_rebuild_is_deterministic_in_the_weights():
    """``materialize`` after new weights are loaded gives the buffers a model
    built from those weights has."""
    kw = TRUNKS["ast_mini"]
    a = ASTViT(**kw, quant="w8", generator=torch.Generator().manual_seed(1))
    b = ASTViT(**kw, quant="w8", generator=torch.Generator().manual_seed(2))
    b.load_state_dict({k: v for k, v in a.state_dict().items() if "weight_q" not in k
                       and "weight_scale" not in k}, strict=False)
    Q.materialize(b)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka


@pytest.mark.parametrize("mode", ["w8a8", "w8"])
def test_export_quant_roundtrip(tmp_path, mode):
    """``export +quant`` → ``load_exported`` on the CPU: the int8 buffers come
    back as int8, the manifest names the mode, and the served
    probabilities equal those of the in-memory quantised model."""
    tiny = ["+model.emb_dim=64", "+model.depth=2", "+model.num_heads=2", "+dtype=float32",
            "dataset.num_classes=5", "+batch=2", "+clip_samples=16000", "+seed=3"]
    art = export.main(["model=ast_mini", f"+out={tmp_path / 'q'}", f"+quant={mode}", *tiny])
    serve = load_exported(art, device="cpu")
    assert serve.manifest["quant"] == mode and serve.model.quant == mode
    assert serve.model.blocks[0].mlp.fc1.weight_q.dtype == torch.int8
    float_art = export.main(["model=ast_mini", f"+out={tmp_path / 'f'}", *tiny])
    ref = load_exported(float_art, device="cpu")
    want = quantize_model(ref.model, mode)
    wave = (np.random.default_rng(1).standard_normal((2, 16_000)) * 0.3).astype(np.float32)
    probs = serve(wave)
    with torch.inference_mode():
        direct = torch.softmax(ref.pipe.forward_eval(want, ref.pipe.eval_batch(
            torch.from_numpy(wave))), dim=-1).numpy()
    np.testing.assert_array_equal(probs, direct)
    assert np.abs(probs - ref(wave)).max() < F32_BAR[mode]
    with pytest.raises(SystemExit, match="ViT family"):
        export.main(["model=cnn_esc50", f"+out={tmp_path / 'c'}", "+quant=w8", "+dtype=float32"])
    with pytest.raises(ValueError, match="MoE"):
        export.main(["model=ast_moe", f"+out={tmp_path / 'm'}", "+quant=w8", *tiny])
