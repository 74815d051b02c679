"""Port parity: losses, optimizers, metrics, MFU accounting, the remat
policies and the whole AST train step, against the JAX package on the CPU.

Tolerances, each with its reason (f32 on both sides unless stated):

- losses and LR schedules: 1e-6 relative (the same formulas);
- optimizer steps against optax on the same gradients: 1e-6 relative plus
  1e-4 x lr absolute (each update is of order lr, rounded in another order;
  Adam's first moment can nearly cancel over the steps, which magnifies
  that rounding relative to the update);
- metrics: exact counts, 1e-6 on the derived rates;
- the remat policies: gradients equal to no remat at 1e-6 normalised (the
  same ops rerun);
- the train step (small AST, 1-s clips, B 4, SpecAugment and Mixup on, the
  JAX draws rebuilt from ``state.rng``): loss 1e-5 relative; with SGD every
  parameter after one and after two steps within 2e-4 normalised by the
  largest |change| of that parameter (the port pads 325 tokens to 384 and
  masks them, JAX runs them unpadded: summation order only, magnified where
  a gradient is a sum that cancels).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlsc_tpu.data.pipeline import DevicePipeline as JaxPipeline
from dlsc_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
from dlsc_tpu.models.ast import ASTModel as JaxASTModel
from dlsc_tpu.train import losses as JL
from dlsc_tpu.train import metrics as JM
from dlsc_tpu.train import optim as JO
from dlsc_tpu.train.state import TrainState as JaxTrainState
from dlsc_tpu.train.steps import make_eval_step as jax_make_eval_step
from dlsc_tpu.train.steps import make_train_step as jax_make_train_step
from dlsc_tpu.utils import mfu as JMFU
from dlsc_tpu_torch.data.pipeline import DevicePipeline, PipelineConfig
from dlsc_tpu_torch.models.ast import ASTModel
from dlsc_tpu_torch.models.convert import params_from_jax
from dlsc_tpu_torch.ops import attn_fast
from dlsc_tpu_torch.scripts import bench
from dlsc_tpu_torch.train import losses as L
from dlsc_tpu_torch.train import metrics as M
from dlsc_tpu_torch.train import optim as O
from dlsc_tpu_torch.train.state import TrainState
from dlsc_tpu_torch.train.steps import make_eval_step, make_train_step
from dlsc_tpu_torch.utils import mfu
from tests.test_torch_augment import jax_pipeline_draws

SMALL = dict(num_classes=7, emb_dim=64, depth=2, num_heads=2)
CLIP, FRAMES, B = 44_100, 276, 4


# ---- losses ------------------------------------------------------------------

@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("name,reduction,masked", [
    (name, reduction, masked) for name in ("ce", "kl")
    for reduction, masked in (("mean", False), ("mean", True), ("sum", True), ("none", False))
] + [("kl", "batchmean", False), ("kl", "batchmean", True)])
def test_losses_match_jax(name, smoothing, reduction, masked):
    rng = np.random.default_rng(0)
    logits = rng.uniform(0, 1, (6, 5)).astype(np.float32)   # sigmoid outputs, as AST's
    y = rng.dirichlet(np.ones(5) * 0.3, 6).astype(np.float32)
    y[0] = np.eye(5, dtype=np.float32)[2]                   # a one-hot row: 0 log 0
    mask = np.array([1, 1, 0, 1, 0, 1], np.float32) if masked else None
    jcls, cls = (JL.CrossEntropyLoss, L.CrossEntropyLoss) if name == "ce" else (JL.KLDivLoss,
                                                                                L.KLDivLoss)
    want = np.asarray(jcls(label_smoothing=smoothing, reduction=reduction)(
        jnp.asarray(logits), jnp.asarray(y), None if mask is None else jnp.asarray(mask)))
    got = cls(label_smoothing=smoothing, reduction=reduction)(
        torch.from_numpy(logits), torch.from_numpy(y),
        None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# ---- optimizers and schedules --------------------------------------------------

@pytest.mark.parametrize("sched", [None, ("cosine", 4), ("step", 2)])
def test_lr_schedule_matches_jax(sched):
    spec = JO.adam(lr=5e-4)
    js = None if sched is None else (JO.cosine_annealing(T_max=sched[1]) if sched[0] == "cosine"
                                     else JO.step_lr(step_size=sched[1], gamma=0.5))
    ps = None if sched is None else (O.cosine_annealing(T_max=sched[1]) if sched[0] == "cosine"
                                     else O.step_lr(step_size=sched[1], gamma=0.5))
    want, got = JO.lr_schedule(spec, js, 3), O.lr_schedule(O.adam(lr=5e-4), ps, 3)
    for step in range(20):
        assert got(step) == pytest.approx(want(step), rel=1e-12)


class _Params(torch.nn.Module):
    def __init__(self, arrays):
        super().__init__()
        self.p = torch.nn.ParameterList(torch.nn.Parameter(torch.from_numpy(a.copy()))
                                        for a in arrays)


@pytest.mark.parametrize("opt", [("adam", dict(lr=1e-2, weight_decay=1e-2)),
                                 ("adamw", dict(lr=1e-2, weight_decay=1e-1)),
                                 ("sgd", dict(lr=1e-1, momentum=0.9, weight_decay=1e-2)),
                                 ("sgd", dict(lr=1e-1))])
@pytest.mark.parametrize("clip", [None, 1.0])
def test_optimizer_steps_match_optax(opt, clip):
    """Three steps on the same gradients, a cosine schedule that changes
    every step (so step k must run at lr(k)), and the clip (the gradients'
    norm is about 6, so clip 1.0 scales them)."""
    name, kw = opt
    rng = np.random.default_rng(1)
    params = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (5,))]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) for p in params] for _ in range(3)]
    tx, _ = JO.build_optimizer(getattr(JO, name)(**kw), JO.cosine_annealing(T_max=4), 1, clip)
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    model = _Params(params)
    state = TrainState.create(model, getattr(O, name)(**kw), O.cosine_annealing(T_max=4), 1,
                              gradient_clip_val=clip)
    for g in grads:
        updates, opt_state = tx.update([jnp.asarray(x) for x in g], opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(model.p, g):
            p.grad = torch.from_numpy(x.copy())
        state.apply_gradients()
        for p, want in zip(model.p, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=1e-6,
                                       atol=1e-4 * kw["lr"])
    assert state.step == 3 and all(p.grad is None for p in model.p)


def test_clip_is_optax_clip():
    """Below the bar nothing changes; at or above it the norm becomes the bar
    exactly (optax), where clip_grad_norm_ would leave max_norm * n / (n + 1e-6)."""
    g = [torch.tensor([3.0, 4.0])]
    assert O.clip_by_global_norm_(g, 10.0).item() == 5.0 and g[0].tolist() == [3.0, 4.0]
    O.clip_by_global_norm_(g, 1.0)
    assert torch.linalg.vector_norm(g[0]).item() == pytest.approx(1.0, rel=1e-7)
    with pytest.raises(ValueError, match="Unknown optimizer"):
        O.build_optimizer([torch.nn.Parameter(torch.zeros(1))], O.OptimizerSpec("lamb", 1e-3),
                          None, 1)


# ---- metrics -----------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_metrics_match_jax(masked):
    rng = np.random.default_rng(2)
    C = 6
    jms, ms = JM.MetricState.create(C), M.MetricState.create(C)
    for _ in range(3):
        logits = rng.standard_normal((10, C)).astype(np.float32)
        labels = rng.integers(0, C - 1, 10)   # the last class has no support
        loss = np.float32(rng.uniform(1, 2))
        mask = rng.integers(0, 2, 10).astype(bool) if masked else None
        jms = jms.update(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(loss),
                         None if mask is None else jnp.asarray(mask))
        ms = ms.update(torch.from_numpy(logits), torch.from_numpy(labels), torch.tensor(loss),
                       None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(ms.confmat.numpy(), np.asarray(jms.confmat))
    assert (ms.count.item(), ms.batches.item()) == (int(jms.count), int(jms.batches))
    for fn, jfn in ((M.accuracy, JM.accuracy), (M.mean_loss, JM.mean_loss),
                    (M.per_class_accuracy, JM.per_class_accuracy), (M.macro_f1, JM.macro_f1)):
        np.testing.assert_allclose(fn(ms).numpy(), np.asarray(jfn(jms)), rtol=1e-6, atol=1e-7)
    probs = rng.uniform(size=(40, C)).round(1)   # ties
    labels = rng.integers(0, C, 40)
    assert M.macro_auroc(probs, labels, C) == JM.macro_auroc(probs, labels, C)


# ---- MFU accounting ------------------------------------------------------------

def test_mfu_matches_jax_and_knows_the_h100():
    model = ASTModel(**SMALL)   # AST-Base's patch geometry: the token counts are AST-Base's
    assert mfu.ast_token_counts(model, 220_500) == (1645, 1664)
    for remat in (True, False):
        kw = dict(n_real=1645, n_pad=1664, emb_dim=768, depth=12, remat_refwd=remat)
        assert (dataclasses.astuple(mfu.vit_step_flops(**kw))
                == dataclasses.astuple(JMFU.vit_step_flops(**kw)))
    assert dataclasses.astuple(mfu.ast_step_flops(model, 1645, 1664)) == dataclasses.astuple(
        JMFU.vit_step_flops(n_real=1645, n_pad=1664, emb_dim=64, depth=2, num_classes=7,
                            remat_refwd=True))
    assert mfu.peak_tflops("NVIDIA H100 80GB HBM3") == 989.0


@pytest.mark.parametrize("name", ["TPU v5 lite", "NVIDIA H100 PCIe", "NVIDIA H100 NVL",
                                  "NVIDIA H200"])
def test_peak_tflops_raises_for_other_cards(name):
    with pytest.raises(ValueError, match="no bf16 peak"):
        mfu.peak_tflops(name)


def test_bench_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the guard under test cannot trigger")
    with pytest.raises(RuntimeError, match="GPU"):
        bench.measure(batch=2, steps=1, warmup=0)


# ---- remat -------------------------------------------------------------------

@pytest.mark.parametrize("remat,policy,forwards", [(False, "full", 1), (True, "full", 2),
                                                   (True, "attn_res", 1)])
def test_remat_policies(remat, policy, forwards, monkeypatch):
    """Gradients equal to no remat; the attention forward runs ``forwards``
    times per block per step: 'full' reruns it in the backward, 'attn_res'
    keeps its out and lse. The CPU path runs the same op as the card."""
    calls = []
    real = attn_fast.fast_mha_forward
    monkeypatch.setattr(attn_fast, "fast_mha_forward", lambda *a: calls.append(1) or real(*a))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 128, FRAMES))
                         .astype(np.float32))
    grads = []
    for r, p in ((False, "full"), (remat, policy)):
        model = ASTModel(**SMALL, dtype=torch.float32, remat=r, remat_policy=p,
                         generator=torch.Generator().manual_seed(0)).train()
        calls.clear()
        model(x).square().sum().backward()
        grads.append([q.grad for q in model.parameters()])
    assert len(calls) == forwards * SMALL["depth"]
    for a, b in zip(*grads):
        assert ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item() < 1e-6
    with pytest.raises(ValueError, match="remat_policy"):
        ASTModel(**SMALL, remat_policy="everything")


def test_ast_defaults_and_eval_rebuild():
    model = ASTModel(**SMALL, dtype=torch.float32)
    assert (model.remat, model.remat_policy) == (True, "attn_res")   # the JAX defaults
    assert not model.training
    rebuilt = type(model)(**model.config)
    rebuilt.load_state_dict(model.state_dict())
    x = torch.randn(1, 128, FRAMES, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        assert torch.equal(rebuilt(x), model(x))


# ---- the whole step ------------------------------------------------------------

def _setup(opt_name, opt_kw, seed=0):
    rng = np.random.default_rng(seed)
    wave = (rng.standard_normal((B, CLIP)) * 0.3).astype(np.float32)
    labels = rng.integers(0, SMALL["num_classes"], B)
    kw = dict(mode="ast", num_classes=SMALL["num_classes"], time_mask=192, freq_mask=48,
              enable_mixup=True, mixup_alpha=0.5)
    jpipe, pipe = JaxPipeline(JaxPipelineConfig(**kw)), DevicePipeline(PipelineConfig(**kw))
    jmodel = JaxASTModel(**SMALL, dtype=jnp.float32, remat=False)
    feats, _ = jpipe.eval_batch(jnp.asarray(wave), jnp.asarray(labels))
    variables = jmodel.init({"params": jax.random.key(seed)}, feats, train=False)
    tx, _ = JO.build_optimizer(getattr(JO, opt_name)(**opt_kw), JO.cosine_annealing(T_max=4),
                               1, 1.0)
    jstate = JaxTrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                  batch_stats=None, tx=tx, rng=jax.random.key(seed + 5))
    model = ASTModel(**SMALL, dtype=torch.float32)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                                          model))
    state = TrainState.create(model, getattr(O, opt_name)(**opt_kw),
                              O.cosine_annealing(T_max=4), 1, gradient_clip_val=1.0)
    return wave, labels, jpipe, pipe, jstate, state


def _run_steps(opt_name, opt_kw, check_params):
    wave, labels, jpipe, pipe, jstate, state = _setup(opt_name, opt_kw)
    jstep = jax.jit(jax_make_train_step(jpipe, JL.CrossEntropyLoss()))
    step = make_train_step(pipe, L.CrossEntropyLoss())
    jms, ms = JM.MetricState.create(SMALL["num_classes"]), M.MetricState.create(
        SMALL["num_classes"])
    model = state.model
    for _ in range(2):
        before = {k: v.clone() for k, v in model.state_dict().items()}
        k_pipe = jax.random.split(jstate.rng, 3)[1]   # dlsc_tpu/train/steps.py:49
        draws = jax_pipeline_draws(k_pipe, pipe.cfg, B, FRAMES)
        jstate, jms, jloss = jstep(jstate, jms, jnp.asarray(wave), jnp.asarray(labels))
        state, ms, loss = step(state, ms, torch.from_numpy(wave), torch.from_numpy(labels),
                               draws)
        assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
        if check_params:
            want = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params), model)
            for name, p in model.state_dict().items():
                scale = (want[name] - before[name]).abs().max().clamp_min(1e-30)
                err = ((p - want[name]).abs().max() / scale).item()
                assert err < 2e-4, (name, err)
        np.testing.assert_array_equal(ms.confmat.numpy(), np.asarray(jms.confmat))
    assert state.step == 2 and int(jstate.step) == 2


@pytest.mark.parametrize("opt_kw", [dict(lr=0.5, momentum=0.9), dict(lr=0.5, weight_decay=1e-2)])
def test_train_step_matches_jax(opt_kw):
    """Two steps with SGD, whose update is proportional to the gradient:
    every parameter within 2e-4 of JAX, normalised by its largest change
    (measured up to 6e-5: the LN scales' gradients are sums over every token
    that largely cancel)."""
    _run_steps("sgd", opt_kw, check_params=True)


def test_train_step_with_adam_matches_jax_loss():
    """The bench's optimizer (Adam, L2 1e-6, cosine, clip 1.0): the loss of
    the second step, which reads the first update, within 1e-5. Parameters
    are not compared element by element under Adam: the gradient of the key
    bias is exactly 0 in exact arithmetic (softmax ignores a per-row
    constant), so its first Adam update is lr x the sign of rounding noise
    on either side."""
    _run_steps("adam", dict(lr=5e-4, weight_decay=1e-6), check_params=False)


def test_eval_step_matches_jax():
    wave, labels, jpipe, pipe, jstate, state = _setup("adam", dict(lr=5e-4))
    mask = np.array([True, True, False, True])
    jms, jlogits = jax.jit(jax_make_eval_step(jpipe, JL.CrossEntropyLoss()))(
        jstate, JM.MetricState.create(SMALL["num_classes"]), jnp.asarray(wave),
        jnp.asarray(labels), jnp.asarray(mask))
    ms, logits = make_eval_step(pipe, L.CrossEntropyLoss())(
        state, M.MetricState.create(SMALL["num_classes"]), torch.from_numpy(wave),
        torch.from_numpy(labels), torch.from_numpy(mask))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(ms.confmat.numpy(), np.asarray(jms.confmat))
    assert ms.count.item() == 3
    assert M.mean_loss(ms).item() == pytest.approx(float(JM.mean_loss(jms)), rel=1e-5)


def test_step_rng_is_seeded():
    a = TrainState.create(_Params([np.zeros(2, np.float32)]), O.sgd(), None, 1, seed=4)
    b = TrainState.create(_Params([np.zeros(2, np.float32)]), O.sgd(), None, 1, seed=4)
    draws = [s.step_rng().integers(0, 1 << 30, 3).tolist() for s in (a, a, b)]
    assert draws[0] == draws[2] and draws[0] != draws[1]
