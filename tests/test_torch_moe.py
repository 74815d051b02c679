"""Port parity: AST-MoE (token-choice top-k, dropless ragged dispatch)
against the JAX package on the CPU.

- ``MoeMlp`` vs JAX ``MoeMlp(dispatch='ragged')`` at B 2, N 16, D 8, E 4,
  K 2, with and without pad tokens (``n_real``): outputs, aux loss, stats,
  and the gradients of every parameter and of the input; JAX runs its
  ragged path through ``jax.lax.ragged_dot`` off the TPU.
- The small AST-MoE model in both JAX block layouts, carried across by
  ``params_from_jax``: sigmoid outputs and the summed aux. The JAX side
  routes all 137 tokens of a 1-s clip unpadded; the port pads them to 256
  and must keep the 119 pads out of routing and aux.
- One and two SGD train steps against the JAX ``make_train_step`` on the
  same draws (dropout 0): loss with the aux, parameters, metric extras.
- Dropout and remat: gradients with remat ``attn_res`` or ``full`` equal
  those without remat at dropout 0.1 and one seed; the masks keep ~90%.
- Export and load, and ``scripts/export.py model=ast_moe``.

Tolerances (f32 on both sides): the module 1e-5 (summation order only);
the model's sigmoid outputs 1e-4 relative, 1e-5 absolute, as
``tests/test_torch_ast.py``; the steps as ``tests/test_torch_train.py``
(loss 1e-5 relative, parameters 2e-4 normalised by their largest change);
remat against no remat 1e-6 normalised (the same ops rerun).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlsc_tpu.data.pipeline import DevicePipeline as JaxPipeline
from dlsc_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
from dlsc_tpu.models.moe import MOE_METRICS as JAX_MOE_METRICS
from dlsc_tpu.models.moe import MoeMlp as JaxMoeMlp
from dlsc_tpu.models.moe import MoeSpec as JaxMoeSpec
from dlsc_tpu.models.moe import collect_moe_aux, collect_moe_stats
from dlsc_tpu.models.vit import ASTViT as JaxASTViT
from dlsc_tpu.train import losses as JL
from dlsc_tpu.train import metrics as JM
from dlsc_tpu.train import optim as JO
from dlsc_tpu.train.state import TrainState as JaxTrainState
from dlsc_tpu.train.steps import make_train_step as jax_make_train_step
from dlsc_tpu_torch.data.pipeline import DevicePipeline, PipelineConfig
from dlsc_tpu_torch.models import moe as TM
from dlsc_tpu_torch.models.ast_moe import ASTMoE
from dlsc_tpu_torch.models.convert import params_from_jax
from dlsc_tpu_torch.models.vit import ASTViT
from dlsc_tpu_torch.ops.dropout_draw import Draw
from dlsc_tpu_torch.ops import gmm as G
from dlsc_tpu_torch.serving import export_model, load_exported, make_infer
from dlsc_tpu_torch.train import losses as L
from dlsc_tpu_torch.train import metrics as M
from dlsc_tpu_torch.train import optim as O
from dlsc_tpu_torch.train.state import TrainState
from dlsc_tpu_torch.train.steps import make_train_step
from dlsc_tpu_torch.utils import mfu
from tests.test_torch_augment import jax_pipeline_draws

SMALL = dict(num_classes=7, emb_dim=64, depth=2, num_heads=2, n_experts=4)
JAX_SMALL = dict(num_classes=7, emb_dim=64, depth=2, num_heads=2, patch_size=16,
                 patch_stride=16, overlap=0, dropout=0.0, dtype=jnp.float32, remat=False,
                 moe=JaxMoeSpec(n_experts=4, top_k=2, dispatch="ragged"))
CLIP, FRAMES, B = 44_100, 276, 4
N_TOKENS = 8 * 17 + 1   # 1-s clip, patch 16, stride 16: 8 x 17 patches and CLS


def _no_dropout_model():
    """The small AST-MoE at dropout 0 (``ASTMoE`` fixes it at 0.1, as JAX's)."""
    return ASTViT(num_classes=7, emb_dim=64, depth=2, num_heads=2, patch_size=16,
                  patch_stride=16, overlap=0, dtype=torch.float32,
                  moe=dict(n_experts=4, top_k=2, dispatch="ragged"))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---- the MoE MLP ----------------------------------------------------------------

@pytest.mark.parametrize("n_real", [None, 11])
def test_moe_mlp_matches_jax(n_real):
    Bm, N, D, E, K = 2, 16, 8, 4, 2
    rng = np.random.default_rng(5)
    x = rng.standard_normal((Bm, N, D)).astype(np.float32)
    cot = rng.standard_normal((Bm, N, D)).astype(np.float32)
    spec = JaxMoeSpec(n_experts=E, top_k=K, dispatch="ragged")
    jm = JaxMoeMlp(D, spec, ratio=2.0, n_real=n_real)
    params = _np(jax.jit(jm.init, static_argnames="train")(
        jax.random.key(3), jnp.asarray(x), train=False)["params"])
    params["bi"] = rng.standard_normal(params["bi"].shape).astype(np.float32)  # biases on
    params["bo"] = rng.standard_normal(params["bo"].shape).astype(np.float32)

    def jloss(p, xx):
        y, mut = jm.apply({"params": p}, xx, train=False, mutable=["intermediates"])
        aux = collect_moe_aux(mut["intermediates"])
        return jnp.sum(y * cot) + aux, (y, aux, collect_moe_stats(mut["intermediates"]))

    (_, (jy, jaux, jstats)), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))

    m = TM.MoeMlp(D, dataclasses.asdict(spec), ratio=2.0)
    m.load_state_dict({"router.weight": torch.from_numpy(params["router"]["kernel"].T.copy()),
                       **{k: torch.from_numpy(params[k].copy()) for k in ("wi", "bi", "wo", "bo")}})
    xt = torch.from_numpy(x).requires_grad_()
    y, aux, stats = m(xt, n_real)
    ((y * torch.from_numpy(cot)).sum() + aux).backward()

    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    assert aux.item() == pytest.approx(float(jaux), rel=1e-5)
    np.testing.assert_allclose(stats.numpy(), [float(jstats[k]) for k in TM.MOE_METRICS],
                               rtol=1e-5, atol=1e-6)
    if n_real is not None:
        assert (y[:, n_real:] == 0).all() and (xt.grad[:, n_real:] == 0).all()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m.router.weight.grad.numpy().T, np.asarray(jg["router"]["kernel"]),
                               rtol=1e-5, atol=1e-5)
    for k in ("wi", "bi", "wo", "bo"):
        np.testing.assert_allclose(getattr(m, k).grad.numpy(), np.asarray(jg[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_group_sizes_are_integer_counts_of_the_real_routes():
    """The sizes handed to the grouped matmul are int32 bincounts of the
    real tokens' expert choices (pads excluded), and the sorted rows are
    exactly the real (token, choice) pairs."""
    seen = []

    def recording_gmm(lhs, rhs, group_sizes):
        seen.append((lhs.shape[0], group_sizes.clone()))
        return G.gmm_reference(lhs, rhs, group_sizes)

    m = TM.MoeMlp(8, dict(n_experts=4, top_k=2, dispatch="ragged"), ratio=2.0)
    torch.nn.init.normal_(m.router.weight)
    for p in (m.wi, m.bi, m.wo, m.bo):
        torch.nn.init.normal_(p)
    x = torch.randn(3, 16, 8, generator=torch.Generator().manual_seed(0))
    routes = []

    def recording_topk(gates, k):
        routes.append(TM.topk_routes(gates, k))
        return routes[-1]

    m(x, 13, recording_gmm, recording_topk)
    topi = routes[0][1][:, :13].reshape(-1).numpy()
    want = np.bincount(topi, minlength=4)
    assert len(seen) == 2
    for rows, gs in seen:
        assert gs.dtype == torch.int32 and rows == 3 * 13 * 2
        np.testing.assert_array_equal(gs.numpy(), want)
    np.testing.assert_array_equal(TM._counts(torch.from_numpy(topi), 4).numpy(), want)


def test_moe_spec_validation():
    assert TM.as_moe_spec(dict(n_experts=4, dispatch="ragged")) == TM.MoeSpec(4, dispatch="ragged")
    assert TM.as_moe_spec(None) is None
    for kw in (dict(dispatch="einsum"), dict(dispatch="scatter"),
               dict(dispatch="einsum", router="expert")):
        assert TM.MoeSpec(4, **kw).dispatch == kw["dispatch"]
    # an explicit ragged + expert-choice raises, as the JAX MoeSpec does; the
    # ASTMoE rewrites it to einsum, as the JAX ASTMoE does
    with pytest.raises(ValueError, match="dropless token-choice"):
        TM.MoeSpec(4, dispatch="ragged", router="expert")
    assert ASTMoE(**SMALL, router="expert").config["moe"]["dispatch"] == "einsum"
    with pytest.raises(ValueError, match="top_k"):
        TM.MoeSpec(2, top_k=3, dispatch="ragged")


def test_dropout_masks():
    """About 90% kept at rate 0.1, kept entries scaled by 1/0.9; the same
    seed gives the same mask; no draw or rate 0: the identity."""
    x = torch.ones(200_000)
    y = TM.dropout(x, 0.1, Draw(1), 0)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 5e-3
    assert torch.allclose(y[kept], torch.tensor(1 / 0.9))
    assert torch.equal(y, TM.dropout(x, 0.1, Draw(1), 0))
    assert not torch.equal(y, TM.dropout(x, 0.1, Draw(2), 0))
    assert TM.dropout(x, 0.1, None, 0) is x and TM.dropout(x, 0.0, Draw(0), 0) is x


# ---- the model ------------------------------------------------------------------

def _features(seed=0, b=2):
    return np.random.default_rng(seed).standard_normal((b, 128, FRAMES)).astype(np.float32)


@pytest.mark.parametrize("scan_blocks", [False, True], ids=["unrolled", "stacked"])
def test_ast_moe_matches_jax(scan_blocks):
    feats = _features()
    jmodel = JaxASTViT(**JAX_SMALL, scan_blocks=scan_blocks)
    variables = jax.jit(jmodel.init, static_argnames="train")(
        {"params": jax.random.key(0)}, jnp.asarray(feats), train=False)
    want, mut = jax.jit(lambda v, f: jmodel.apply(v, f, train=False, mutable=["intermediates"]))(
        variables, jnp.asarray(feats))

    model = _no_dropout_model()
    model.load_state_dict(params_from_jax(_np(variables["params"]), model))
    tokens, n_real = model.embed(torch.from_numpy(feats))
    assert (tokens.shape[1], n_real) == (256, N_TOKENS)
    with torch.no_grad():
        got, aux, stats = model(torch.from_numpy(feats), return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    assert aux.item() == pytest.approx(float(collect_moe_aux(mut["intermediates"])), rel=1e-5)
    jstats = collect_moe_stats(mut["intermediates"])
    for k in TM.MOE_METRICS:
        assert stats[k].item() == pytest.approx(float(jstats[k]), rel=1e-5, abs=1e-6)


def test_ast_moe_defaults_and_config():
    model = ASTMoE(**SMALL)
    assert (model.remat, model.remat_policy, model.dropout) == (True, "attn_res", 0.1)
    assert model.dtype == torch.bfloat16 and model.config["moe"]["dispatch"] == "ragged"
    assert json.loads(json.dumps(model.config)) == model.config   # the artifact's manifest
    assert {"blocks.0.moe.router.weight", "blocks.0.moe.wi", "blocks.1.moe.bo"} <= set(
        model.state_dict())
    assert not any(".mlp." in k for k in model.state_dict())
    wi = model.blocks[0].moe.wi   # lecun normal over the expert's input axis
    assert abs(wi.std().item() * 64**0.5 - 1.0) < 0.1


def _grads(model, feats, seed):
    model.train()
    out, aux, _ = model(feats, dropout_seed=seed, return_aux=True)
    (out.square().sum() + aux).backward()
    return [p.grad.clone() for p in model.parameters()]


def test_dropout_and_remat_give_the_same_gradients():
    """At dropout 0.1 with one seed, remat ``attn_res`` and ``full`` rerun
    each block's forward in the backward: the masks drawn there must be the
    first forward's, so the gradients equal those without remat. Another
    seed draws other masks; eval mode draws none."""
    feats = torch.from_numpy(_features(3) * 0.1)
    runs = {}
    for remat, policy in ((False, "full"), (True, "attn_res"), (True, "full")):
        model = ASTMoE(**SMALL, dtype=torch.float32, remat=remat, remat_policy=policy,
                       generator=torch.Generator().manual_seed(0))
        runs[(remat, policy)] = _grads(model, feats, seed=11)
    want = runs[(False, "full")]
    for key, grads in runs.items():
        for a, b in zip(grads, want):
            assert ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item() < 1e-6, key
    other = _grads(model, feats, seed=12)
    assert any(not torch.equal(a, b) for a, b in zip(other, want))
    model.eval()
    with torch.no_grad():
        assert torch.equal(model(feats), model(feats, dropout_seed=99))


def test_expert_token_count_names_the_experts_without_gradient():
    """``chip_smoke.ExpertTokens`` (phases 10 and 26: the count of the kept
    routes whose outputs reach the loss, through each MoE layer's
    ``route_hook``, remat re-forward included): the experts it
    finds without such a token are exactly those whose zero-initialised
    biases get no gradient, as the last block's experts that no CLS token
    chose; at batch 1 some of them exist."""
    import chip_smoke

    model = ASTMoE(**SMALL, dtype=torch.float32, remat=True,
                   generator=torch.Generator().manual_seed(0))
    model.train()
    routed = chip_smoke.ExpertTokens(model, N_TOKENS)
    out, aux, _ = model(torch.from_numpy(_features(4, b=1)), dropout_seed=5, return_aux=True)
    (out.square().sum() + aux).backward()
    idle = routed.idle()
    assert idle and all(i == SMALL["depth"] - 1 for i, _ in idle)
    for i, blk in enumerate(model.blocks):
        for e in range(SMALL["n_experts"]):
            no_grad = not blk.moe.bi.grad[e].any() and not blk.moe.bo.grad[e].any()
            assert no_grad == ((i, e) in idle), (i, e)


def _router_run(remat: bool):
    """A tiny f32 AST-MoE forward and backward with ``chip_smoke.RouterTerms``
    installed: (terms, model, loss, every router call's (x, logits) of the
    forward, the count of reported gradients per block)."""
    import chip_smoke

    model = ASTMoE(**SMALL, dtype=torch.float32, remat=remat,
                   generator=torch.Generator().manual_seed(0))
    model.train()
    terms = chip_smoke.RouterTerms(model)
    reported = {}
    record = terms._backward

    def counted(i, x, g):
        reported[i] = reported.get(i, 0) + 1
        record(i, x, g)

    terms._backward = counted
    calls = []
    for moe in terms.layers.values():
        moe.router_hook = (lambda hook: lambda x, logits: (calls.append((x, logits)),
                                                           hook(x, logits)))(moe.router_hook)
    out, aux, _ = model(torch.from_numpy(_features(6)), dropout_seed=3, return_aux=True)
    loss = out.square().sum() + aux
    return terms, model, loss, calls, reported


@pytest.mark.parametrize("remat", [False, True])
def test_router_terms_match_autograd(remat):
    """Phase 11's router metric (``chip_smoke.RouterTerms``): the captured
    logits' gradient G and router input X give |G|^T |X| equal to its
    recomputation from autograd's own gradient of the logits, and G^T X the
    router weight's gradient; under remat the re-forward asks the router
    again, and exactly one call a block reports (1e-6 normalised: the same
    f32 sums in another order)."""
    terms, model, loss, calls, reported = _router_run(remat)
    first = calls[:len(terms.layers)]   # the forward's calls; a re-forward comes later
    routers = [moe.router.weight for moe in terms.layers.values()]
    # one backward (a remat region takes no second): autograd's own gradients
    # of the logits and of the router weights, the hooks reporting meanwhile
    want = torch.autograd.grad(loss, [logits for _, logits in first] + routers)
    want_g, want_w = want[:len(first)], want[len(first):]
    assert reported == {i: 1 for i in terms.layers}
    assert len(calls) == len(terms.layers) * (1 + remat)
    for i, (x, _), g, w in zip(terms.layers, first, want_g, want_w):
        x, g = x.reshape(-1, x.shape[-1]), g.reshape(-1, g.shape[-1])
        assert torch.equal(terms.x[i], x.detach())
        for got, want in ((terms.g[i].abs().T @ terms.x[i].abs(), g.abs().T @ x.abs()),
                          (terms.g[i].T @ terms.x[i], w)):
            assert ((got - want).abs().max() / want.abs().max()).item() < 1e-6
    terms.remove()
    assert all(moe.router_hook is None for moe in terms.layers.values())


def test_router_reading_is_the_error_over_the_terms_size():
    """``RouterTerms.scale`` is c max(|G|^T |X|) with c the clip factor the
    given gradient carries; ``router_err`` reads 0 between identical runs and
    eps / scale for an error eps planted in one entry."""
    import chip_smoke

    terms, model, loss, _, _ = _router_run(False)
    loss.backward()
    grads = {f"blocks.{i}.moe.router.weight": 0.25 * moe.router.weight.grad
             for i, moe in terms.layers.items()}   # clipped by 1/4
    scales = terms.scales(grads)
    for i in terms.layers:
        name = f"blocks.{i}.moe.router.weight"
        size = (terms.g[i].abs().T @ terms.x[i].abs()).max().item()
        assert scales[name] == pytest.approx(0.25 * size, rel=1e-6)
        grad = grads[name]
        assert chip_smoke.router_err(grad, grad.clone(), scales[name]) == 0.0
        eps = 1e-3 * grad.abs().max().item()
        planted = grad.clone()
        planted[1, 2] += eps
        assert chip_smoke.router_err(planted, grad, scales[name]) == pytest.approx(
            eps / scales[name], rel=1e-3)


# ---- the train step -------------------------------------------------------------

def test_train_step_matches_jax():
    """Two SGD steps (momentum 0.9, clip 1.0, SpecAugment + Mixup on the
    rebuilt JAX draws), dropout 0: loss including the aux, every parameter,
    the confusion matrix and the MoE metric extras."""
    rng = np.random.default_rng(0)
    wave = (rng.standard_normal((B, CLIP)) * 0.3).astype(np.float32)
    labels = rng.integers(0, SMALL["num_classes"], B)
    kw = dict(mode="ast", num_classes=SMALL["num_classes"], time_mask=192, freq_mask=48,
              enable_mixup=True, mixup_alpha=0.5)
    jpipe, pipe = JaxPipeline(JaxPipelineConfig(**kw)), DevicePipeline(PipelineConfig(**kw))
    jmodel = JaxASTViT(**JAX_SMALL)
    feats = jnp.zeros((B, 128, FRAMES), jnp.float32)   # init reads only the shape
    variables = jax.jit(jmodel.init, static_argnames="train")(
        {"params": jax.random.key(0)}, feats, train=False)
    opt_kw = dict(lr=0.5, momentum=0.9)
    tx, _ = JO.build_optimizer(JO.sgd(**opt_kw), JO.cosine_annealing(T_max=4), 1, 1.0)
    jstate = JaxTrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                  batch_stats=None, tx=tx, rng=jax.random.key(5))
    model = _no_dropout_model()
    model.load_state_dict(params_from_jax(_np(jstate.params), model))
    state = TrainState.create(model, O.sgd(**opt_kw), O.cosine_annealing(T_max=4), 1,
                              gradient_clip_val=1.0)
    jstep = jax.jit(jax_make_train_step(jpipe, JL.CrossEntropyLoss()))
    step = make_train_step(pipe, L.CrossEntropyLoss())
    C = SMALL["num_classes"]
    jms = JM.MetricState.create(C, extras=JAX_MOE_METRICS)
    ms = M.MetricState.create(C, extras=TM.MOE_METRICS)
    for _ in range(2):
        before = {k: v.clone() for k, v in model.state_dict().items()}
        k_pipe = jax.random.split(jstate.rng, 3)[1]   # dlsc_tpu/train/steps.py:49
        draws = jax_pipeline_draws(k_pipe, pipe.cfg, B, FRAMES)
        jstate, jms, jloss = jstep(jstate, jms, jnp.asarray(wave), jnp.asarray(labels))
        state, ms, loss = step(state, ms, torch.from_numpy(wave), torch.from_numpy(labels),
                               draws)
        assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
        want = params_from_jax(_np(jstate.params), model)
        for name, p in model.state_dict().items():
            scale = (want[name] - before[name]).abs().max().clamp_min(1e-30)
            assert ((p - want[name]).abs().max() / scale).item() < 2e-4, name
        np.testing.assert_array_equal(ms.confmat.numpy(), np.asarray(jms.confmat))
        for k in TM.MOE_METRICS:
            assert ms.extra_sums[k].item() == pytest.approx(float(jms.extra_sums[k]), rel=1e-5,
                                                            abs=1e-6)
    means = ms.extra_means()
    assert means["moe/drop_frac"].item() == 0.0 and 0.0 < means["moe/util"].item() <= 1.0


def test_metric_extras():
    ms = M.MetricState.create(3, extras=TM.MOE_METRICS)
    ms = ms.add_extras({"moe/util": torch.tensor(0.5), "other": torch.tensor(9.0)})
    ms = ms.update(torch.zeros(2, 3), torch.zeros(2, dtype=torch.long), torch.tensor(1.0))
    ms = ms.add_extras({"moe/util": torch.tensor(0.25), "moe/drop_frac": torch.tensor(0.0)})
    assert set(ms.extra_sums) == set(TM.MOE_METRICS)
    assert ms.extra_sums["moe/util"].item() == 0.75
    assert ms.extra_means()["moe/util"].item() == 0.75   # one batch counted
    plain = M.MetricState.create(3)
    assert plain.add_extras({"moe/util": torch.tensor(1.0)}) is plain
    assert plain.extra_means() == {}


def test_moe_step_flops():
    """Useful FLOPs of an MoE block: top_k x the two expert products per
    real token plus the router, in place of the dense MLP."""
    kw = dict(n_real=689, n_pad=768, emb_dim=384, depth=12, num_classes=50)
    dense = mfu.vit_step_flops(**kw, patch_pixels=256)
    moe = mfu.vit_step_flops(**kw, patch_pixels=256, moe_top_k=2, n_experts=8)
    D = 384.0
    per_tok = 12 * ((2 - 1) * 8 * D * D * 2 + 2 * D * 8)   # one more MLP, plus the router
    assert moe.useful - dense.useful == pytest.approx(3 * 689 * per_tok)
    assert moe.fwd_useful - dense.fwd_useful == pytest.approx(689 * per_tok)
    model = ASTMoE(**SMALL)
    assert mfu.ast_step_flops(model, 137, 256).useful == mfu.vit_step_flops(
        n_real=137, n_pad=256, emb_dim=64, depth=2, num_classes=7, patch_pixels=256,
        moe_top_k=2, n_experts=4).useful
    assert mfu.ast_token_counts(model, 220_500) == (689, 768)   # AST-MoE's patch grid


# ---- export ---------------------------------------------------------------------

def test_export_roundtrip(tmp_path):
    model = ASTMoE(**SMALL, dtype=torch.float32, generator=torch.Generator().manual_seed(2))
    pipe = DevicePipeline(PipelineConfig(mode="ast", num_classes=SMALL["num_classes"]))
    art = export_model(model, pipe, tmp_path / "art", batch=2, clip_samples=CLIP)
    serve = load_exported(art, device="cpu")
    assert serve.manifest["model_kwargs"]["moe"]["n_experts"] == 4
    w = np.random.default_rng(1).standard_normal((2, CLIP)).astype(np.float32)
    got = serve(w)
    np.testing.assert_array_equal(got, make_infer(model, pipe)(torch.from_numpy(w)).numpy())
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)


def test_export_cli_ast_moe(tmp_path):
    from dlsc_tpu_torch.scripts import export

    out = export.main([
        "model=ast_moe", f"+out={tmp_path / 'art'}", "dataset.num_classes=7",
        "+model.emb_dim=64", "+model.depth=2", "+model.num_heads=2", "model.n_experts=4",
        "+dtype=float32", "+batch=2", f"+clip_samples={CLIP}"])
    serve = load_exported(out, device="cpu")
    kw = serve.manifest["model_kwargs"]
    assert (kw["moe"]["n_experts"], kw["moe"]["top_k"], kw["dropout"]) == (4, 2, 0.1)
    assert serve.manifest["model"].endswith("ast_moe.ASTMoE")
    probs = serve(np.random.default_rng(2).standard_normal((2, CLIP)).astype(np.float32))
    assert probs.shape == (2, 7) and np.isfinite(probs).all()
