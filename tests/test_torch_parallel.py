"""Port parity of the multi-device layer: the mesh, data parallelism (DDP),
FSDP, tensor and sequence parallelism, against the JAX package on its
8-device virtual mesh (``tests/conftest.py``).

The port runs on 2 gloo ranks over the CPU, spawned once for the whole file
(``dlsc_tpu_torch.parallel.mesh.spawn``, a ``file://`` rendezvous, a group
timeout; the rank functions are ``tests/dist_workers.py``); the JAX side
runs once in the pytest process. Inputs are made with numpy from a seed;
the JAX draws are rebuilt from its key (``tests/test_torch_augment.py``).
Tolerances, each with its reason:

- the loss: 1e-5 relative (the JAX mesh tests' bar);
- parameters after SGD steps (each change is lr x gradient): every
  parameter within 1e-4 of its largest change, the JAX tests' gradient
  rtol taken on the gradient's scale (the port pads 325 tokens to 384 and
  masks them, JAX runs them unpadded: summation order only, magnified where
  a gradient is a sum that cancels, as ``tests/test_torch_train.py``
  measures); under TP/SP 2e-5 relative on the loss as JAX's own TP test;
- BatchNorm (EnvNet-v2, BC mixing) in f64 on both sides, as the family
  step tests compare (JAX's f32 gradients of the model are 29% off its f64
  ones on the CPU): parameters within 5e-5 of their largest change (the
  f32 pipelines before the f64 models round BC mixing apart: the port in
  one process is 1.3e-5 off JAX here) and within 1e-6 of the port in one
  process (the global batch's statistics in f64; the head is f32 in both
  packages, measured 7.6e-8), a
  pre-BatchNorm bias (0 gradient in exact arithmetic) within 1e-12
  absolute, the running statistics within 1e-6 as ``_stats_err`` reads
  them (the pipeline before the model is f32 on both sides, the family
  tests' bar);
- the port at 2 ranks against itself at 1, with dropout, SpecAugment and
  Mixup on: 1e-5 of each parameter's largest value (the same arithmetic;
  the ranks sum gradients in another order, measured 1.3e-6 under SP).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlsc_tpu.data.pipeline import DevicePipeline as JaxPipeline
from dlsc_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
from dlsc_tpu.models.ast import ASTModel as JaxASTModel
from dlsc_tpu.models.envnet_v2 import EnvNetV2 as JaxEnvNet
from dlsc_tpu.parallel import MeshPlan as JaxMeshPlan
from dlsc_tpu.parallel import get_mesh as jax_get_mesh
from dlsc_tpu.parallel import make_plan as jax_make_plan
from dlsc_tpu.parallel.tp import vit_param_shardings
from dlsc_tpu.train import losses as JL
from dlsc_tpu.train import metrics as JM
from dlsc_tpu.train import optim as JO
from dlsc_tpu.train.state import TrainState as JaxTrainState
from dlsc_tpu.train.steps import make_train_step as jax_make_train_step
from dlsc_tpu_torch.data.pipeline import PipelineConfig
from dlsc_tpu_torch.models.ast import ASTModel
from dlsc_tpu_torch.models.convert import params_from_jax
from dlsc_tpu_torch.models.envnet_v2 import EnvNetV2
from dlsc_tpu_torch.parallel import MeshPlan, spawn
from tests import dist_workers as dw
from tests.test_torch_augment import jax_pipeline_draws
from tests.test_torch_families import _stats_err, jax_wave_draws

W = 2
B, CLIP, FRAMES = 8, 44_100, 276
SMALL = dict(num_classes=5, emb_dim=32, depth=2, num_heads=2)
AST_PIPE = dict(mode="ast", num_classes=5, time_mask=192, freq_mask=48, enable_mixup=True,
                mixup_alpha=0.5)
ENV_IN = 30_000
ENV_PIPE = dict(mode="envnet_v2", num_classes=5, window_length=ENV_IN / 44_100,
                padding_ratio=0.5, enable_bc_mixing=True)
SGD = ("sgd", dict(lr=0.5, momentum=0.9))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed=0, b=B, n=CLIP):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n)) * 0.3).astype(np.float32), rng.integers(0, 5, b)


def _jax_ast(token_sharding=None):
    return JaxASTModel(**SMALL, dtype=jnp.float32, remat=False).clone(
        token_sharding=token_sharding)


def _jax_steps(jmodel, params, wave, labels, steps, plan, param_sh=None, apply_fn=None,
               state_sh=None, extras=()):
    """``steps`` JAX train steps (SGD + momentum, cosine, clip 1.0) jitted
    over ``plan``'s mesh: the batch over 'data', the state replicated, its
    params laid out by ``param_sh`` or the whole state by ``state_sh``.
    Returns the params after each step, the losses, the port's draws
    (rebuilt from each step's key) and the metric state."""
    jpipe = JaxPipeline(JaxPipelineConfig(**AST_PIPE))
    tx, _ = JO.build_optimizer(JO.sgd(**SGD[1]), JO.cosine_annealing(T_max=4), 1, 1.0)
    jstate = JaxTrainState.create(apply_fn=apply_fn or jmodel.apply, params=params,
                                  batch_stats=None, tx=tx, rng=jax.random.key(5))
    if param_sh is not None:
        jstate = jstate.replace(params=jax.tree_util.tree_map(jax.device_put, params, param_sh))
    rep, bat = plan.replicated, plan.batch
    st = state_sh(jstate) if state_sh is not None else (None if param_sh is not None else rep)
    if state_sh is not None:
        jstate = jax.device_put(jstate, st)
    step = jax.jit(jax_make_train_step(jpipe, JL.CrossEntropyLoss()),
                   in_shardings=(st, rep, bat, bat),
                   out_shardings=(st, rep, rep) if state_sh is not None else None)
    jms = jax.device_put(JM.MetricState.create(5, extras=extras), rep)
    w, y = jax.device_put(jnp.asarray(wave), bat), jax.device_put(jnp.asarray(labels), bat)
    out, losses, draws = [], [], []
    cfg = PipelineConfig(**AST_PIPE)
    for _ in range(steps):
        k_pipe = jax.random.split(jstate.rng, 3)[1]   # dlsc_tpu/train/steps.py:49
        draws.append(jax_pipeline_draws(k_pipe, cfg, B, FRAMES))
        jstate, jms, loss = step(jstate, jms, w, y)
        out.append(_np(jstate.params))
        losses.append(float(loss))
    return out, losses, draws, jms


def _ast_init(jmodel):
    feats = jnp.zeros((B, 128, FRAMES), jnp.float32)   # init reads only the shape
    return jax.jit(jmodel.init, static_argnames="train")({"params": jax.random.key(0)}, feats,
                                                        train=False)["params"]


def _port_sd(params, model):
    return {k: v.numpy() for k, v in params_from_jax(params, model).items()}


def _spec(layout, init, wave, labels, draws, **kw):
    return dict(model="ast", model_kw=dict(SMALL, dtype="float32", remat=False), init=init,
                pipe=AST_PIPE, layout=layout, wave=wave, labels=labels, steps=len(draws),
                draws=draws, opt=SGD, cosine_t_max=4, clip=1.0, **kw)


def _env_jax(wave, labels):
    """One f64 JAX step of EnvNet-v2 (BC mixing, KLDiv, dropout 0) on the
    8-device mesh; (params before, after, batch stats after, loss, draws)."""
    jm = JaxEnvNet(num_classes=5, dropout=0.0)
    with jax.enable_x64(True):
        jm64 = jm.clone(dtype=jnp.float64)
        v = jax.jit(jm64.init, static_argnames="train")(
            {"params": jax.random.key(0), "dropout": jax.random.key(1)},
            jnp.zeros((2, ENV_IN), jnp.float64), train=False)
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)
        before = _np(v)
        tx, _ = JO.build_optimizer(JO.sgd(lr=0.05, momentum=0.9), None, 1, None)
        jstate = JaxTrainState.create(apply_fn=jm64.apply, params=v["params"],
                                      batch_stats=v["batch_stats"], tx=tx,
                                      rng=jax.random.key(5))
        k_pipe = jax.random.split(jstate.rng, 3)[1]
        cfg = PipelineConfig(**ENV_PIPE)
        draws = jax_wave_draws(k_pipe, cfg, B, wave.shape[1])
        plan = jax_make_plan(8)
        rep, bat = plan.replicated, plan.batch
        step = jax.jit(jax_make_train_step(JaxPipeline(JaxPipelineConfig(**ENV_PIPE)),
                                           JL.KLDivLoss()), in_shardings=(rep, rep, bat, bat))
        jstate, _, loss = step(jax.device_put(jstate, rep),
                               jax.device_put(JM.MetricState.create(5), rep),
                               jax.device_put(jnp.asarray(wave), bat),
                               jax.device_put(jnp.asarray(labels), bat))
        after = {"params": _np(jstate.params), "batch_stats": _np(jstate.batch_stats)}
    return before, after, float(loss), draws


def _eval_spec(layout):
    """An eval batch with a padded, masked tail; the multi-crop EnvNet-v2
    test path (``dlsc_tpu/train/steps.py:184-202``)."""
    rng = np.random.default_rng(7)
    model = EnvNetV2(num_classes=5, dropout=0.0, input_samples=ENV_IN,
                     generator=torch.Generator().manual_seed(1))
    wave = (rng.standard_normal((4, 33_000)) * 0.3).astype(np.float32)
    return dict(fn="eval_logits", model="envnet_v2",
                model_kw=dict(num_classes=5, dropout=0.0, input_samples=ENV_IN),
                init={k: v.numpy() for k, v in model.state_dict().items()},
                pipe=dict(ENV_PIPE, multi_crop_test=True, test_crops=3), layout=layout,
                wave=wave, labels=np.array([1, 3, 0, 0]), mask=np.array([1, 1, 1, 0], bool))


def _dropout_specs():
    """The port with dropout (MLP and attention), SpecAugment and Mixup on,
    remat 'attn_res': DDP, FSDP, TP and SP."""
    vit = dict(num_classes=5, emb_dim=32, depth=2, num_heads=2, dtype="float32", dropout=0.1,
               remat=True, remat_policy="attn_res")
    init = {k: v.numpy() for k, v in dw.build_model("vit", vit).state_dict().items()}
    tp_init = {k: v.numpy() for k, v in
               dw.build_model("vit", dict(vit, attn_dropout=0.1)).state_dict().items()}
    wave, labels = _batch(3, 4, 8000)
    base = dict(model="vit", pipe=AST_PIPE, wave=wave, labels=labels, steps=2, draw_seed=3,
                dropout_seeds=[11, 12], opt=("sgd", dict(lr=0.5)))
    return [dict(base, model_kw=vit, init=init, layout="ddp"),
            dict(base, model_kw=vit, init=init, layout="fsdp"),
            dict(base, model_kw=dict(vit, attn_dropout=0.1), init=tp_init, layout="tp"),
            dict(base, model_kw=dict(vit, attn_dropout=0.1), init=tp_init, layout="sp")]


def _leaf_spec():
    """LEAF (BatchNorm, dropout, PCEN's α, which the loss does not reach) in
    f64 under DDP, two steps."""
    kw = dict(num_classes=5, n_filters=8, kernel_size=101)
    init = {k: v.numpy() for k, v in dw.build_model("leaf", kw).state_dict().items()}
    wave, labels = _batch(17, 8, 12_000)
    return dict(model="leaf", model_kw=kw, init=init, layout="ddp", wave=wave, labels=labels,
                pipe=dict(ENV_PIPE, window_length=16_000 / 44_100, enable_bc_mixing=False),
                steps=2, draw_seed=4, dropout_seeds=[21, 22],
                opt=("sgd", dict(lr=0.05, momentum=0.9)), float64=True)


@pytest.fixture(scope="module")
def runs():
    """Every check's JAX reference and port runs: one spawn of 2 ranks."""
    wave, labels = _batch(0)
    jmodel = _jax_ast()
    params = _ast_init(jmodel)
    model = ASTModel(**SMALL, dtype=torch.float32, remat=False)
    init = _port_sd(params, model)
    dp = _jax_steps(jmodel, params, wave, labels, 2, jax_make_plan(8))
    tp_plan = JaxMeshPlan(jax_get_mesh(8, model_parallel=2))
    from jax.sharding import NamedSharding, PartitionSpec as P

    tp_ref = {}
    for name, tok in (("tp", None), ("sp", NamedSharding(tp_plan.mesh, P("data", "model")))):
        jm = _jax_ast() if tok is None else _jax_ast(tok)
        tp_ref[name] = _jax_steps(jm, params, wave, labels, 1, tp_plan,
                                  vit_param_shardings(params, tp_plan.mesh))
    env_wave, env_labels = _batch(13, B, 25_000)
    env = _env_jax(env_wave, env_labels)
    env_model = EnvNetV2(num_classes=5, dropout=0.0, input_samples=ENV_IN)
    env_spec = dict(model="envnet_v2", model_kw=dict(num_classes=5, dropout=0.0,
                                                     input_samples=ENV_IN),
                    init={k: v.numpy() for k, v in params_from_jax(env[0], env_model).items()},
                    pipe=ENV_PIPE, layout="ddp", wave=env_wave, labels=env_labels, steps=1,
                    draws=[env[3]], dropout_seeds=[0], opt=("sgd", dict(lr=0.05, momentum=0.9)),
                    loss="kl", float64=True)
    specs = ([_spec("ddp", init, wave, labels, dp[2], extras=()),
              _spec("fsdp", init, wave, labels, dp[2]),
              _spec("tp", init, wave, labels, tp_ref["tp"][2]),
              _spec("sp", init, wave, labels, tp_ref["sp"][2]),
              env_spec, _eval_spec("ddp"), _eval_spec("fsdp")]
             + _dropout_specs() + [_leaf_spec()])
    specs.append(dict(fn="mesh_facts"))
    ranks = spawn(dw.run_all, W, specs, timeout_s=600)
    one = dw.run_all(specs[4:6] + _dropout_specs() + [_leaf_spec()])
    return dict(model=model, env_model=env_model, dp=dp, tp=tp_ref, env=env, two=ranks[0],
                one=dict(zip(("env", "eval", "ddp", "fsdp", "tp", "sp", "leaf"), one)))


def _param_errs(got: dict, want: dict, before: dict) -> dict:
    """Each parameter's error over its largest change."""
    return {k: float(np.abs(got[k] - want[k]).max()
                     / max(np.abs(want[k] - before[k]).max(), 1e-30)) for k in want}


@pytest.mark.parametrize("i,layout", [(0, "ddp"), (1, "fsdp")])
def test_data_parallel_matches_jax_mesh(runs, i, layout):
    """Two steps of the AST train step (SGD + momentum, cosine, clip 1.0,
    SpecAugment and Mixup on the JAX draws of the global batch of 8) on 2
    DDP or FSDP ranks against the JAX step jitted over the 8-device mesh
    (batch on 'data'): losses, every parameter after each step, and the
    confusion matrix reduced over the ranks."""
    params, losses, _, jms = runs["dp"]
    got = runs["two"][i]
    model = runs["model"]
    np.testing.assert_allclose(got["loss"], losses, rtol=1e-5)
    before = _port_sd(_ast_init(_jax_ast()), model)
    for step in range(2):
        want = _port_sd(params[step], model)
        errs = _param_errs(got["params"][step], want, before)
        assert max(errs.values()) < 1e-4, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
        before = want
    np.testing.assert_array_equal(got["confmat"], np.asarray(jms.confmat))


@pytest.mark.parametrize("i,name", [(2, "tp"), (3, "sp")])
def test_tensor_parallel_matches_jax(runs, i, name):
    """One step with the Megatron splits over 2 'model' ranks (and the
    token split under SP) against the JAX step with ``vit_param_shardings``
    (and ``token_sharding``) on a data=4 x model=2 mesh."""
    params, losses, _, _ = runs["tp"][name]
    got = runs["two"][i]
    model = runs["model"]
    np.testing.assert_allclose(got["loss"], losses, rtol=2e-5)
    before = _port_sd(_ast_init(_jax_ast()), model)
    errs = _param_errs(got["params"][0], _port_sd(params[0], model), before)
    assert max(errs.values()) < 1e-4, sorted(errs.items(), key=lambda kv: -kv[1])[:3]


def test_batchnorm_sees_the_global_batch(runs):
    """EnvNet-v2 in f64 on 2 DDP ranks (4 rows each) against the JAX step
    on the 8-device mesh: the BatchNorm statistics are the global batch's
    (a rank's own 4 rows give others), and so are the parameters."""
    before, after, loss, _ = runs["env"]
    got = runs["two"][4]
    model = runs["env_model"]
    assert got["loss"][0] == pytest.approx(loss, rel=1e-5)
    want = params_from_jax(after, model)
    init = params_from_jax(before, model)
    sd = got["params"][0]
    pre_bn = {k for k in want if k.endswith(".conv.bias")}   # every conv feeds a BatchNorm
    for k, v in want.items():
        v, b = v.double().numpy(), init[k].double().numpy()
        err = np.abs(sd[k] - v).max()
        if k in pre_bn:
            assert err < 1e-12, k
        elif "running" not in k and "num_batches" not in k:
            scale = max(np.abs(v - b).max(), 1e-30)
            assert err < 5e-5 * scale, k
            assert np.abs(sd[k] - runs["one"]["env"]["params"][0][k]).max() < 1e-6 * scale, k
    stats = [k for k in want if "running" in k]
    assert _stats_err({k: torch.from_numpy(sd[k]) for k in stats},
                      {k: want[k].double() for k in stats}) < 1e-6
    assert any(np.abs(sd[k] - init[k].double().numpy()).max() > 1e-3
               for k in want if "running_var" in k)


@pytest.mark.parametrize("i", [5, 6], ids=["ddp", "fsdp"])
def test_sharded_eval_matches_one_rank(runs, i):
    """The eval step on 2 ranks (a padded, masked last row; EnvNet-v2's
    multi-crop test path): the gathered logits and the reduced metrics
    equal one process's."""
    got, want = runs["two"][i], runs["one"]["eval"]
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got["confmat"], want["confmat"])
    assert got["count"] == want["count"] == 3
    assert got["loss_sum"] == pytest.approx(want["loss_sum"], rel=1e-5)


@pytest.mark.parametrize("i,name", [(7, "ddp"), (8, "fsdp"), (9, "tp"), (10, "sp")])
def test_modes_match_one_rank_with_dropout(runs, i, name):
    """Two steps with dropout 0.1 (and attention dropout under TP/SP),
    SpecAugment, Mixup and remat on 2 ranks against 1: a rank draws the
    unsplit masks' bits of its rows, heads, units and tokens (a
    counter-based draw), the mixing partners are featurised by the rank
    that needs them."""
    got, want = runs["two"][i], runs["one"][name]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    for g, w in zip(got["params"], want["params"]):
        for k in w:
            assert np.abs(g[k] - w[k]).max() <= 1e-5 * max(np.abs(w[k]).max(), 1e-3), k


def test_leaf_unreached_parameter_under_ddp(runs):
    """LEAF on 2 DDP ranks against 1, two steps: DDP expects PCEN's α, which
    the loss does not reach, to get no gradient (the model names it), α
    stays as it was, and every other parameter and BatchNorm statistic is
    the one-process step's."""
    got, want = runs["two"][11], runs["one"]["leaf"]
    init = _leaf_spec()["init"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    for g, w in zip(got["params"], want["params"]):
        assert np.array_equal(g["pcen.alpha"], init["pcen.alpha"])
        for k in w:
            assert np.abs(g[k] - w[k]).max() <= 1e-6 * max(np.abs(w[k]).max(), 1e-3), k


def test_mesh_plan_and_errors(runs):
    """``MeshPlan`` on one process and on the ranks' meshes, and the JAX
    errors of ``get_mesh``."""
    plan = MeshPlan()
    assert (plan.n_data, plan.n_batch, plan.rows(6), plan.pad_batch(5)) == (1, 1, (0, 6), 5)
    facts = runs["two"][-1]
    assert facts["rows"] == [(0, 4), (4, 8)] and facts["shard"] == [0, 1, 2, 3]
    assert facts["replicated"] == 1.0
    assert facts["pad"] == 14 and facts["n_data"] == 2
    assert "not divisible by model_parallel=3" in facts["mp_error"]
    assert "global batch 7" in facts["rows_error"]
