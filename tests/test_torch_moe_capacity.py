"""Port parity: AST-MoE's capacity dispatches (``einsum``, ``scatter``) and
the expert-choice router against the JAX package on the CPU.

- ``MoeMlp`` vs JAX ``MoeMlp`` at B 2, N 32, D 8, E 4, K 2, ``group_size`` 8
  (4 routing groups): token-choice on ``einsum`` and ``scatter`` and
  expert-choice, with and without pad tokens (``n_real`` 27), at capacity
  factors 1.0 (tokens drop), 1.15 and 1.29 (``int(100·cf)`` truncates);
  outputs, aux loss, both stats, and the gradients of every parameter and
  of the input.
- The capacity formula, group size and the two lowerings against each other.
- Expert-choice at full capacity equals the dense FFN
  (``tests/test_moe.py:193``'s counterpart); under remat ``attn_res_moe``
  the capacity paths keep nothing more than under ``attn_res`` (equal
  gradients).
- The small AST-MoE built from ``configs/model/ast_moe.yaml`` with
  ``model.router=expert`` (``dispatch: ragged`` rewritten to ``einsum``, as
  the JAX ``ASTMoE`` does) against the JAX model, and one SGD step at
  dropout 0. JAX pads tokens only on TPU while the port always pads to 128,
  so the model runs one routing group (``group_size`` >= the padded N):
  there ``min(S, n_real)`` gives both the same capacity (ROADMAP §3).

Tolerances (f32 on both sides): the module 1e-5 (summation order only);
einsum against scatter 1e-6 (the same products, the K-term combine sum in
another order); the model's sigmoid outputs 1e-4 relative, 1e-5 absolute,
and the step as ``tests/test_torch_moe.py`` (loss 1e-5 relative,
parameters 2e-4 normalised by their largest change).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlsc_tpu.models.ast_moe import ASTMoE as JaxASTMoE
from dlsc_tpu.models.moe import MoeMlp as JaxMoeMlp
from dlsc_tpu.models.moe import MoeSpec as JaxMoeSpec
from dlsc_tpu.models.moe import collect_moe_aux, collect_moe_stats
from dlsc_tpu.models.vit import ASTViT as JaxASTViT
from dlsc_tpu.train import losses as JL
from dlsc_tpu.train import optim as JO
from dlsc_tpu.train.state import TrainState as JaxTrainState
from dlsc_tpu.train.steps import make_train_step as jax_make_train_step
from dlsc_tpu_torch.config import compose
from dlsc_tpu_torch.data.pipeline import DevicePipeline, PipelineConfig
from dlsc_tpu_torch.models import moe as TM
from dlsc_tpu_torch.models.ast_moe import ASTMoE
from dlsc_tpu_torch.models.convert import params_from_jax
from dlsc_tpu_torch.models.vit import ASTViT
from dlsc_tpu_torch.train import losses as L
from dlsc_tpu_torch.train import metrics as M
from dlsc_tpu_torch.train import optim as O
from dlsc_tpu_torch.train.state import TrainState
from dlsc_tpu_torch.train.steps import make_train_step
from dlsc_tpu_torch.scripts.train import CONFIG_DIR
from dlsc_tpu.data.pipeline import DevicePipeline as JaxPipeline
from dlsc_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
from dlsc_tpu.train import metrics as JM
from tests.test_torch_augment import jax_pipeline_draws

Bm, N, D, E, K, GROUP = 2, 32, 8, 4, 2, 8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _module_inputs(seed: int = 5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bm, N, D)).astype(np.float32)
    cot = rng.standard_normal((Bm, N, D)).astype(np.float32)
    return rng, x, cot


def _port_mlp(spec_kw: dict, params: dict) -> TM.MoeMlp:
    m = TM.MoeMlp(D, spec_kw, ratio=2.0)
    m.load_state_dict({"router.weight": torch.from_numpy(params["router"]["kernel"].T.copy()),
                       **{k: torch.from_numpy(np.asarray(params[k]).copy())
                          for k in ("wi", "bi", "wo", "bo")}})
    return m


def _port_run(m: TM.MoeMlp, x: np.ndarray, cot: np.ndarray, n_real):
    xt = torch.from_numpy(x).requires_grad_()
    y, aux, stats = m(xt, n_real)
    ((y * torch.from_numpy(cot)).sum() + aux).backward()
    grads = {k: getattr(m, k).grad.numpy() for k in ("wi", "bi", "wo", "bo")}
    grads["router"] = m.router.weight.grad.numpy().T
    return y.detach().numpy(), aux.item(), stats.numpy(), xt.grad.numpy(), grads


# ---- the MoE MLP against JAX ------------------------------------------------------

@pytest.mark.parametrize("cf", [1.0, 1.15, 1.29])
@pytest.mark.parametrize("n_real", [None, 27])
@pytest.mark.parametrize("route", ["einsum", "scatter", "expert"])
def test_moe_mlp_capacity_matches_jax(route, n_real, cf):
    rng, x, cot = _module_inputs()
    spec_kw = dict(n_experts=E, top_k=K, capacity_factor=cf, group_size=GROUP,
                   router="expert" if route == "expert" else "token",
                   dispatch="einsum" if route == "expert" else route)
    spec = JaxMoeSpec(**spec_kw)
    jm = JaxMoeMlp(D, spec, ratio=2.0, n_real=n_real)
    F_ = 2 * D   # the parameters made in numpy (no JAX init to compile), biases on

    def draw(*shape, fan_in=1):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    params = {"router": {"kernel": draw(D, E, fan_in=D)}, "wi": draw(E, D, F_, fan_in=D),
              "bi": draw(E, F_), "wo": draw(E, F_, D, fan_in=F_), "bo": draw(E, D)}

    def jloss(p, xx):
        y, mut = jm.apply({"params": p}, xx, train=False, mutable=["intermediates"])
        aux = collect_moe_aux(mut["intermediates"])
        return jnp.sum(y * cot) + aux, (y, aux, collect_moe_stats(mut["intermediates"]))

    (_, (jy, jaux, jstats)), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))

    y, aux, stats, gx, grads = _port_run(_port_mlp(dataclasses.asdict(spec), params), x, cot,
                                         n_real)
    np.testing.assert_allclose(y, np.asarray(jy), rtol=1e-5, atol=1e-5)
    assert aux == pytest.approx(float(jaux), rel=1e-5)
    np.testing.assert_allclose(stats, [float(jstats[k]) for k in TM.MOE_METRICS],
                               rtol=1e-5, atol=1e-6)
    if cf == 1.0 and route != "expert":
        assert stats[0] > 0   # tokens dropped at capacity
    if n_real is not None:
        assert (y[:, n_real:] == 0).all() and (gx[:, n_real:] == 0).all()
    np.testing.assert_allclose(gx, np.asarray(jgx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grads["router"], np.asarray(jg["router"]["kernel"]),
                               rtol=1e-5, atol=1e-5)
    for k in ("wi", "bi", "wo", "bo"):
        np.testing.assert_allclose(grads[k], np.asarray(jg[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("cf,want", [(1.0, 4), (1.15, 5), (1.29, 6), (2.0, 8)])
def test_capacity_formula(cf, want):
    """C = max(1, ceil(K·min(S, n_real)·int(100·cf) / (100·E))) per group of
    S, S the largest divisor of N at most ``group_size``."""
    spec = TM.MoeSpec(E, top_k=K, capacity_factor=cf, group_size=GROUP)
    assert TM.capacity(spec, N, N) == (8, 4, want)
    assert TM.capacity(spec, N, 27) == (8, 4, want)
    assert TM.capacity(spec, N, 3) == (8, 4, max(1, -(-K * 3 * int(100 * cf) // (100 * E))))
    # int(100 * 1.15) is 114: 114 slots where ceil(K·S·cf/E) would give 115
    one = TM.MoeSpec(1, top_k=1, capacity_factor=1.15, group_size=100)
    assert TM.capacity(one, 100, 100) == (100, 1, 114)
    assert TM._group_size(768, 256) == 256 and TM._group_size(689, 256) == 53
    assert TM._group_size(137, 256) == 137 and TM._group_size(7, 1) == 1


@pytest.mark.parametrize("n_real", [None, 27])
@pytest.mark.parametrize("cf", [1.0, 1.29])
def test_einsum_equals_scatter(cf, n_real):
    """The two token-choice capacity lowerings share the routing, so they
    give the same outputs, aux, stats and gradients (1e-6 normalised by the
    largest value)."""
    rng, x, cot = _module_inputs(7)
    runs = []
    for dispatch in ("einsum", "scatter"):
        m = TM.MoeMlp(D, dict(n_experts=E, top_k=K, capacity_factor=cf, group_size=GROUP,
                              dispatch=dispatch), ratio=2.0)
        torch.manual_seed(0)
        for p in m.parameters():
            torch.nn.init.normal_(p)
        runs.append(_port_run(m, x, cot, n_real))
    (y0, a0, s0, g0, p0), (y1, a1, s1, g1, p1) = runs

    def err(a, b):
        return np.abs(a - b).max() / np.abs(b).max()

    assert err(y0, y1) < 1e-6 and err(g0, g1) < 1e-6
    assert a0 == a1
    np.testing.assert_array_equal(s0, s1)
    for k in p0:
        assert err(p0[k], p1[k]) < 1e-6, k


def test_expert_choice_equals_dense_at_full_capacity():
    """With C == S (capacity_factor = E/K) every expert takes every token;
    identical experts and gates summing to 1 give the plain FFN."""
    torch.manual_seed(11)
    x = torch.randn(2, 16, 32)
    m = TM.MoeMlp(32, dict(n_experts=4, top_k=2, capacity_factor=2.0, router="expert",
                           dispatch="einsum"), ratio=2.0)
    for p in m.parameters():
        torch.nn.init.normal_(p, std=0.2)
    with torch.no_grad():
        for w in (m.wi, m.bi, m.wo, m.bo):
            w.copy_(w[:1].expand_as(w))
        y, _, stats = m(x)
    ref = torch.nn.functional.gelu(x @ m.wi[0] + m.bi[0]) @ m.wo[0] + m.bo[0]
    torch.testing.assert_close(y, ref, atol=2e-5, rtol=1e-5)
    assert stats[0].item() == 0.0 and stats[1].item() == pytest.approx(1.0)


@pytest.mark.parametrize("route", ["ragged", "einsum", "scatter", "expert"])
def test_route_hook_counts_the_kept_dispatches(route):
    """``route_hook`` sees each token's kept dispatches per expert: K a real
    token on the dropless path, at most K on the capacity paths (the load
    behind ``moe/util``), none for a pad; expert-choice: C a (group, expert)."""
    x = torch.randn(Bm, N, D, generator=torch.Generator().manual_seed(2))
    spec = dict(n_experts=E, top_k=K, capacity_factor=1.0, group_size=GROUP,
                router="expert" if route == "expert" else "token",
                dispatch="einsum" if route == "expert" else route)
    m = TM.MoeMlp(D, spec, ratio=2.0)
    for p in m.parameters():
        torch.nn.init.normal_(p)
    seen = []
    m.route_hook = seen.append
    m(x, 27)
    (kept,) = seen
    assert kept.shape == (Bm, N, E) and (kept[:, 27:] == 0).all()
    per_token = kept[:, :27].sum(-1)
    if route == "ragged":
        assert (per_token == K).all()
    elif route == "expert":
        S, G, C = TM.capacity(m.spec, N, 27)
        per_expert = kept.reshape(Bm, G, S, E).sum(2)
        assert (per_expert[:, :3] == C).all() and (per_expert[:, 3] == 3).all()
    else:
        assert (per_token <= K).all() and (per_token < K).any()


def test_moe_spec_takes_every_jax_pair():
    for router, dispatch in (("token", "ragged"), ("token", "einsum"), ("token", "scatter"),
                             ("expert", "einsum"), ("expert", "scatter")):
        assert TM.MoeSpec(4, router=router, dispatch=dispatch).dispatch == dispatch
    for kw, match in ((dict(dispatch="ragged", router="expert"), "dropless token-choice"),
                      (dict(dispatch="magic"), "dispatch"), (dict(router="oracle"), "router"),
                      (dict(group_size=0), "group_size"), (dict(top_k=5), "top_k")):
        with pytest.raises(ValueError, match=match):
            TM.MoeSpec(4, **kw)
    with pytest.raises(NotImplementedError, match="M12"):
        ASTMoE(emb_dim=32, depth=1, num_heads=2, n_experts=4, expert_sharding=object())


@pytest.mark.parametrize("route", ["einsum", "scatter", "expert"])
def test_capacity_paths_keep_nothing_more_under_attn_res_moe(route):
    """The capacity paths tag nothing ``moe_res`` (as in JAX), so remat
    ``attn_res_moe`` keeps what ``attn_res`` keeps and the gradients are
    equal, bit for bit, at dropout 0.1 with one seed."""
    feats = torch.from_numpy(
        np.random.default_rng(3).standard_normal((2, 128, FRAMES)).astype(np.float32) * 0.1)
    moe = dict(router="expert" if route == "expert" else "token",
               dispatch="einsum" if route == "expert" else route)
    grads = []
    for policy in ("attn_res", "attn_res_moe"):
        model = ASTMoE(num_classes=7, **SMALL, **moe, dtype=torch.float32, remat=True,
                       remat_policy=policy, generator=torch.Generator().manual_seed(0))
        model.train()
        out, aux, _ = model(feats, dropout_seed=11, return_aux=True)
        (out.square().sum() + aux).backward()
        grads.append([p.grad for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


# ---- the model: AST-MoE with router=expert from its config ------------------------

FEATS_B, FRAMES = 2, 276   # 1-s clips: 8 x 17 patches and CLS = 137 tokens, 256 padded
SMALL = dict(emb_dim=32, depth=2, num_heads=2, n_experts=4, group_size=256)


def _yaml_model_kw() -> dict:
    cfg = compose(str(CONFIG_DIR), "training", ["model=ast_moe", "model.router=expert"])
    kw = cfg.model.to_dict()
    for k in ("_target_", "dataset_overrides"):
        kw.pop(k)
    assert (kw["router"], kw["dispatch"]) == ("expert", "ragged")
    return {**kw, "num_classes": 7, **SMALL}


def test_ast_moe_expert_router_from_config_matches_jax():
    kw = _yaml_model_kw()
    feats = np.random.default_rng(0).standard_normal((FEATS_B, 128, FRAMES)).astype(np.float32)
    jmodel = JaxASTMoE(**kw, dtype=jnp.float32, remat=False)
    variables = jax.jit(jmodel.init, static_argnames="train")(
        {"params": jax.random.key(0)}, jnp.asarray(feats), train=False)
    want, mut = jax.jit(lambda v, f: jmodel.apply(v, f, train=False, mutable=["intermediates"]))(
        variables, jnp.asarray(feats))

    model = ASTMoE(**kw, dtype=torch.float32, remat=False)
    assert model.config["moe"]["dispatch"] == "einsum"
    model.load_state_dict(params_from_jax(_np(variables["params"]), model))
    tokens, n_real = model.embed(torch.from_numpy(feats))
    assert (tokens.shape[1], n_real) == (256, 137)
    assert TM.capacity(TM.as_moe_spec(model.config["moe"]), 256, 137)[2] == \
        TM.capacity(TM.as_moe_spec(model.config["moe"]), 137, 137)[2]
    with torch.no_grad():
        got, aux, stats = model(torch.from_numpy(feats), return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    assert aux.item() == pytest.approx(float(collect_moe_aux(mut["intermediates"])), rel=1e-5)
    jstats = collect_moe_stats(mut["intermediates"])
    for k in TM.MOE_METRICS:
        assert stats[k].item() == pytest.approx(float(jstats[k]), rel=1e-5, abs=1e-6)


def test_ast_moe_expert_router_train_step_matches_jax():
    """One SGD step (momentum 0.9, clip 1.0; no SpecAugment or Mixup, which
    ``tests/test_torch_moe.py`` covers) at dropout 0 through the
    expert-choice model: loss with the aux, every parameter, and the MoE
    metric extras."""
    b, clip, C = 4, 44_100, 7
    rng = np.random.default_rng(1)
    wave = (rng.standard_normal((b, clip)) * 0.3).astype(np.float32)
    labels = rng.integers(0, C, b)
    pkw = dict(mode="ast", num_classes=C, time_mask=0, freq_mask=0, enable_mixup=False)
    jpipe, pipe = JaxPipeline(JaxPipelineConfig(**pkw)), DevicePipeline(PipelineConfig(**pkw))
    moe = dict(n_experts=4, top_k=2, router="expert", dispatch="einsum", group_size=256)
    arch = dict(num_classes=C, emb_dim=32, depth=2, num_heads=2, patch_size=16,
                patch_stride=16, overlap=0, dropout=0.0)
    jmodel = JaxASTViT(**arch, dtype=jnp.float32, remat=False, moe=JaxMoeSpec(**moe))
    variables = jax.jit(jmodel.init, static_argnames="train")(
        {"params": jax.random.key(0)}, jnp.zeros((b, 128, FRAMES), jnp.float32), train=False)
    opt_kw = dict(lr=0.5, momentum=0.9)
    tx, _ = JO.build_optimizer(JO.sgd(**opt_kw), JO.cosine_annealing(T_max=4), 1, 1.0)
    jstate = JaxTrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                  batch_stats=None, tx=tx, rng=jax.random.key(5))
    model = ASTViT(**arch, dtype=torch.float32, moe=moe)
    model.load_state_dict(params_from_jax(_np(jstate.params), model))
    state = TrainState.create(model, O.sgd(**opt_kw), O.cosine_annealing(T_max=4), 1,
                              gradient_clip_val=1.0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    draws = jax_pipeline_draws(jax.random.split(jstate.rng, 3)[1], pipe.cfg, b, FRAMES)
    jms = JM.MetricState.create(C, extras=TM.MOE_METRICS)
    jstate, jms, jloss = jax.jit(jax_make_train_step(jpipe, JL.CrossEntropyLoss()))(
        jstate, jms, jnp.asarray(wave), jnp.asarray(labels))
    ms = M.MetricState.create(C, extras=TM.MOE_METRICS)
    state, ms, loss = make_train_step(pipe, L.CrossEntropyLoss())(
        state, ms, torch.from_numpy(wave), torch.from_numpy(labels), draws)
    assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    want = params_from_jax(_np(jstate.params), model)
    for name, p in model.state_dict().items():
        scale = (want[name] - before[name]).abs().max().clamp_min(1e-30)
        assert ((p - want[name]).abs().max() / scale).item() < 2e-4, name
    for k in TM.MOE_METRICS:
        assert ms.extra_sums[k].item() == pytest.approx(float(jms.extra_sums[k]), rel=1e-5,
                                                        abs=1e-6)
