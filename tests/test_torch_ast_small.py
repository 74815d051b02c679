"""Port parity: AST-Small and AST-Mini, with and without the fused residual
add + LayerNorm (``ln_fused``, kernel K3), against the JAX package on the
CPU.

- Both families (emb 64, depth 2, heads 2; AST-Small patch 16 stride 16,
  AST-Mini stride 10) in both JAX block layouts, carried across by
  ``params_from_jax``, against the JAX ``ASTViT`` with the family's fields
  and ``attn_impl='dense'``: sigmoid outputs in eval mode. For ``ln_fused``
  the JAX side runs its Pallas add + LN kernel in interpret mode
  (``DLSC_LN_FUSED=1`` with ``DLSC_ATTN_INTERPRET=1``, ``vit.py:739-741``);
  its row count must be a multiple of 8 there (a TPU grain), so the batch is
  8 and the clips are 1.3 s (AST-Small: 8 x 13 patches + CLS = 105 tokens)
  or 0.5 s (AST-Mini: 12 x 7 + 1 = 85); the port pads them to 128.
- Two SGD train steps of the small AST-Small with ``ln_fused`` (dropout 0,
  remat ``attn_res`` on the port's side) against the JAX ``make_train_step``
  under the same environment, on the same draws.
- A small AST-MoE with ``ln_fused``; the factories' defaults against the
  JAX factories'; remat and dropout replay with ``ln_fused`` (K3f runs in
  the forward and in each re-forward); export → load → serve of
  ``model=ast_small`` and ``model=ast_mini`` through ``scripts/export.py``.

Tolerances (f32 on both sides): sigmoid outputs 1e-4 relative, 1e-5
absolute, as ``tests/test_torch_ast.py``; the steps as
``tests/test_torch_train.py`` (loss 1e-5 relative, every parameter 2e-4
normalised by its largest change: the port pads the tokens to 128 and sums
in another order); remat against no remat 1e-6 normalised (the same ops
rerun).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlsc_tpu.data.pipeline import DevicePipeline as JaxPipeline
from dlsc_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
from dlsc_tpu.models.ast_mini import ASTMiniViT as JaxASTMiniViT
from dlsc_tpu.models.ast_small import ASTViTSmall as JaxASTViTSmall
from dlsc_tpu.models.moe import MoeSpec as JaxMoeSpec
from dlsc_tpu.models.moe import collect_moe_aux
from dlsc_tpu.models.vit import ASTViT as JaxASTViT
from dlsc_tpu.train import losses as JL
from dlsc_tpu.train import metrics as JM
from dlsc_tpu.train import optim as JO
from dlsc_tpu.train.state import TrainState as JaxTrainState
from dlsc_tpu.train.steps import make_train_step as jax_make_train_step
from dlsc_tpu_torch.data.pipeline import DevicePipeline, PipelineConfig
from dlsc_tpu_torch.models.ast_mini import ASTMiniViT
from dlsc_tpu_torch.models.ast_moe import ASTMoE
from dlsc_tpu_torch.models.ast_small import ASTViTSmall
from dlsc_tpu_torch.models.convert import params_from_jax
from dlsc_tpu_torch.models.vit import ASTViT
from dlsc_tpu_torch.ops import ln_fused as LN
from dlsc_tpu_torch.serving import load_exported, make_infer
from dlsc_tpu_torch.train import losses as L
from dlsc_tpu_torch.train import metrics as M
from dlsc_tpu_torch.train import optim as O
from dlsc_tpu_torch.train.state import TrainState
from dlsc_tpu_torch.train.steps import make_train_step
from tests.test_torch_augment import jax_pipeline_draws

SMALL = dict(num_classes=7, emb_dim=64, depth=2, num_heads=2)
# family: (port factory, JAX ASTViT fields, frames, tokens)
FAMILIES = {
    "ast_small": (ASTViTSmall, dict(patch_size=16, patch_stride=16, overlap=0), 208, 105),
    "ast_mini": (ASTMiniViT, dict(patch_size=16, patch_stride=10, overlap=6), 76, 85),
}
B = 8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _fused_env(monkeypatch, on: bool):
    if on:
        monkeypatch.setenv("DLSC_LN_FUSED", "1")
        monkeypatch.setenv("DLSC_ATTN_INTERPRET", "1")
    else:
        monkeypatch.delenv("DLSC_LN_FUSED", raising=False)


def _features(frames, seed=0):
    return np.random.default_rng(seed).standard_normal((B, 128, frames)).astype(np.float32)


@pytest.mark.parametrize("scan_blocks", [False, True], ids=["unrolled", "stacked"])
@pytest.mark.parametrize("ln_fused", [False, True], ids=["unfused", "ln_fused"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_model_matches_jax(family, ln_fused, scan_blocks, monkeypatch):
    factory, fields, frames, tokens = FAMILIES[family]
    _fused_env(monkeypatch, ln_fused)
    feats = _features(frames)
    jmodel = JaxASTViT(**SMALL, **fields, dtype=jnp.float32, attn_impl="dense",
                       scan_blocks=scan_blocks)
    variables = jax.jit(jmodel.init, static_argnames="train")(
        {"params": jax.random.key(0)}, jnp.asarray(feats), train=False)
    want = jax.jit(lambda v, f: jmodel.apply(v, f, train=False))(variables, jnp.asarray(feats))

    model = factory(**SMALL, **fields, dtype=torch.float32, ln_fused=ln_fused)
    model.load_state_dict(params_from_jax(_np(variables["params"]), model))
    assert model.embed(torch.from_numpy(feats))[1] == tokens
    calls = []
    real = LN.fused_add_ln_forward
    monkeypatch.setattr(LN, "fused_add_ln_forward", lambda *a: calls.append(1) or real(*a))
    with torch.no_grad():
        got = model(torch.from_numpy(feats)).numpy()
    assert len(calls) == (SMALL["depth"] if ln_fused else 0)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)


def test_factory_defaults_match_jax():
    """Every field the JAX factories set, at their defaults; the port's
    models carry ``ln_fused`` and ``attn_impl`` in their config."""
    for factory, jfactory in ((ASTViTSmall, JaxASTViTSmall), (ASTMiniViT, JaxASTMiniViT)):
        jm = jfactory()
        model = factory()
        for key in ("num_classes", "emb_dim", "depth", "num_heads", "patch_size",
                    "patch_stride", "overlap", "sample_rate", "f_dim", "dropout", "remat",
                    "remat_policy", "attn_impl", "attn_dropout"):
            assert model.config[key] == getattr(jm, key), (factory.__name__, key)
        assert model.config["dtype"] == jnp.dtype(jm.dtype).name == "bfloat16"
        assert model.config["ln_fused"] is False
        rebuilt = ASTViT(**model.config)
        assert rebuilt.config == model.config


@pytest.mark.parametrize("remat,policy,forwards", [(False, "full", 1), (True, "full", 2),
                                                   (True, "attn_res", 2)])
def test_remat_reruns_the_fused_op(remat, policy, forwards, monkeypatch):
    """At dropout 0.1 with one seed: gradients equal to no remat; the fused
    add + LN runs ``forwards`` times per block (``attn_res`` keeps only the
    attention op's outputs) and its backward once."""
    counts = {"fwd": 0, "bwd": 0}
    fwd, bwd = LN.fused_add_ln_forward, LN.fused_add_ln_backward

    def count(key, fn):
        return lambda *a: counts.__setitem__(key, counts[key] + 1) or fn(*a)

    monkeypatch.setattr(LN, "fused_add_ln_forward", count("fwd", fwd))
    monkeypatch.setattr(LN, "fused_add_ln_backward", count("bwd", bwd))
    feats = torch.from_numpy(_features(100, seed=3)[:2] * 0.1)
    grads = []
    for r, p in ((False, "full"), (remat, policy)):
        model = ASTViTSmall(**SMALL, patch_stride=16, overlap=0, dtype=torch.float32,
                            remat=r, remat_policy=p, ln_fused=True,
                            generator=torch.Generator().manual_seed(0)).train()
        counts.update(fwd=0, bwd=0)
        model(feats, dropout_seed=7).square().sum().backward()
        grads.append([q.grad for q in model.parameters()])
    assert (counts["fwd"], counts["bwd"]) == (forwards * SMALL["depth"], SMALL["depth"])
    for a, b in zip(*grads):
        assert ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item() < 1e-6


def test_train_steps_with_ln_fused_match_jax(monkeypatch):
    """Two SGD steps (momentum 0.9, clip 1.0, SpecAugment + Mixup on the
    rebuilt JAX draws), AST-Small's fields at dropout 0, ``ln_fused`` on
    both sides: the loss and every parameter."""
    _fused_env(monkeypatch, True)
    _, fields, frames, _ = FAMILIES["ast_small"]
    clip = 160 * (frames - 1)
    rng = np.random.default_rng(0)
    wave = (rng.standard_normal((B, clip)) * 0.3).astype(np.float32)
    labels = rng.integers(0, SMALL["num_classes"], B)
    kw = dict(mode="ast", num_classes=SMALL["num_classes"], time_mask=192, freq_mask=48,
              enable_mixup=True, mixup_alpha=0.5)
    jpipe, pipe = JaxPipeline(JaxPipelineConfig(**kw)), DevicePipeline(PipelineConfig(**kw))
    jmodel = JaxASTViT(**SMALL, **fields, dropout=0.0, dtype=jnp.float32, attn_impl="dense")
    variables = jax.jit(jmodel.init, static_argnames="train")(
        {"params": jax.random.key(0)}, jnp.zeros((B, 128, frames)), train=False)
    opt_kw = dict(lr=0.5, momentum=0.9)
    tx, _ = JO.build_optimizer(JO.sgd(**opt_kw), JO.cosine_annealing(T_max=4), 1, 1.0)
    jstate = JaxTrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                  batch_stats=None, tx=tx, rng=jax.random.key(5))
    model = ASTViT(**SMALL, **fields, dtype=torch.float32, remat=True, remat_policy="attn_res",
                   ln_fused=True)
    model.load_state_dict(params_from_jax(_np(jstate.params), model))
    state = TrainState.create(model, O.sgd(**opt_kw), O.cosine_annealing(T_max=4), 1,
                              gradient_clip_val=1.0)
    jstep = jax.jit(jax_make_train_step(jpipe, JL.CrossEntropyLoss()))
    step = make_train_step(pipe, L.CrossEntropyLoss())
    jms, ms = (JM.MetricState.create(SMALL["num_classes"]),
               M.MetricState.create(SMALL["num_classes"]))
    for _ in range(2):
        before = {k: v.clone() for k, v in model.state_dict().items()}
        k_pipe = jax.random.split(jstate.rng, 3)[1]   # dlsc_tpu/train/steps.py:49
        draws = jax_pipeline_draws(k_pipe, pipe.cfg, B, frames)
        jstate, jms, jloss = jstep(jstate, jms, jnp.asarray(wave), jnp.asarray(labels))
        state, ms, loss = step(state, ms, torch.from_numpy(wave), torch.from_numpy(labels),
                               draws)
        assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
        want = params_from_jax(_np(jstate.params), model)
        for name, p in model.state_dict().items():
            scale = (want[name] - before[name]).abs().max().clamp_min(1e-30)
            assert ((p - want[name]).abs().max() / scale).item() < 2e-4, name
        np.testing.assert_array_equal(ms.confmat.numpy(), np.asarray(jms.confmat))


def test_ast_moe_with_ln_fused_matches_jax(monkeypatch):
    """A small AST-MoE (4 experts, top-2, ragged) with the fused add + LN in
    every MoE block, eval mode: sigmoid outputs and the summed aux."""
    _fused_env(monkeypatch, True)
    _, fields, frames, tokens = FAMILIES["ast_small"]
    feats = _features(frames, seed=1)
    jmodel = JaxASTViT(**SMALL, **fields, dropout=0.0, dtype=jnp.float32, attn_impl="dense",
                       moe=JaxMoeSpec(n_experts=4, top_k=2, dispatch="ragged"))
    variables = jax.jit(jmodel.init, static_argnames="train")(
        {"params": jax.random.key(0)}, jnp.asarray(feats), train=False)
    want, mut = jax.jit(lambda v, f: jmodel.apply(v, f, train=False, mutable=["intermediates"]))(
        variables, jnp.asarray(feats))
    model = ASTMoE(**SMALL, n_experts=4, dtype=torch.float32, ln_fused=True)
    model.load_state_dict(params_from_jax(_np(variables["params"]), model))
    with torch.no_grad():
        got, aux, _ = model(torch.from_numpy(feats), return_aux=True)
    assert model.config["ln_fused"] and model.embed(torch.from_numpy(feats))[1] == tokens
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    assert aux.item() == pytest.approx(float(collect_moe_aux(mut["intermediates"])), rel=1e-5)


@pytest.mark.parametrize("family,extra", [
    ("ast_small", ["+model.ln_fused=true", "+model.attn_impl=flash"]),
    ("ast_mini", ["+model.ln_fused=true"])])
def test_export_cli(family, extra, tmp_path):
    from dlsc_tpu_torch.scripts import export

    clip = 44_100
    out = export.main([
        f"model={family}", f"+out={tmp_path / 'art'}", "dataset.num_classes=7",
        "+model.emb_dim=64", "+model.depth=2", "+model.num_heads=2", "+dtype=float32",
        "+batch=2", f"+clip_samples={clip}", *extra])
    serve = load_exported(out, device="cpu")
    kw = serve.manifest["model_kwargs"]
    assert serve.manifest["model"].endswith(FAMILIES[family][0].__name__)
    assert (kw["emb_dim"], kw["dropout"], kw["ln_fused"]) == (64, 0.1, True)
    assert kw["attn_impl"] == ("flash" if family == "ast_small" else "splash")
    assert kw["patch_stride"] == FAMILIES[family][1]["patch_stride"]
    w = np.random.default_rng(2).standard_normal((2, clip)).astype(np.float32)
    probs = serve(w)
    assert probs.shape == (2, 7) and np.isfinite(probs).all()
    np.testing.assert_array_equal(probs, make_infer(serve.model, serve.pipe)(
        torch.from_numpy(w)).numpy())
