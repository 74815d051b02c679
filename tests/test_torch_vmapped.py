"""The port's vmapped multi-trial HPO (``dlsc_tpu_torch/hpo/vmapped.py``)
against ``dlsc_tpu/hpo/vmapped.py``, on the CPU.

- ``schedule_factor`` against JAX's over a grid of counts, periods and
  warmups: 1e-6 absolute (f32 both sides).
- The kernel ops under ``torch.func``: the three ``autograd.Function`` +
  custom-op pairs (attention, add + LN, grouped matmul), their plain
  versions on the CPU, under ``vmap(grad_and_value(...))`` against a loop of
  K single calls: 1e-6 normalised (the same plain arithmetic; the folded
  batch only reorders independent problems), and the folded launches
  counted: one forward and one backward call for all K trials (add + LN:
  one a trial where γ and β are per trial).
- One K = 2 vmapped train step against the JAX ``_build_exec()["train"]``:
  the ``VTiny`` of ``tests/test_vmapped_hpo.py`` and a 2-block ViT, rebuilt
  in torch, each slot's Flax params converted with ``params_from_jax``; a
  deterministic pipeline (no SpecAugment, no Mixup, dropout 0). Bars: loss
  1e-5 relative; per-trial train accuracies equal; each parameter's Adam
  moments after the step (the trial's clipped + L2 gradient, and its
  square) 1e-5 of their largest entry; the parameter change 1e-5 of its
  largest entry beyond one f32 spacing of the parameter (both changes are
  differences of f32 parameters), on the entries whose gradient is at
  least 1e-3 of the parameter's largest and 1e3 · eps (some in every
  parameter; ``chip_smoke.settled_entries`` and ``beyond_spacing``, as in
  phase 28's parity): Adam's first update is lr · g / (|g| + eps), so an entry
  whose gradient is a near-cancelling sum (the attention key bias's is 0
  in exact arithmetic) moves by lr times the sign of its rounding. The
  optimiser alone is held in
  ``test_per_trial_optimiser_matches_the_injected_tx`` on given gradients
  (1e-6 of the largest change).
- Per-trial effects, as the JAX slow tests check them: lr 1e-9 against
  5e-3, MLP dropout 0 against 0.95, mixup α (the soft labels' spread), an
  all-warmup schedule against none.
- The runners: ``run_batch`` and ``run_continuous`` against the JAX
  runner with the same sampler seed, the port's slots initialised from the
  JAX runner's per-slot inits: trial params exact, reported values within
  one validation sample's share; ``chip_smoke.lockstep_epochs`` (phase
  28's count of a continuous study's epochs, from its trials) equal to the
  epochs the runner ran.
- The refusals, with the JAX runner's messages; the CLI's
  ``+optuna.vmapped.enabled=true`` on the synthetic tree; a tiny
  ``ASTMoE(dispatch='ragged')``, which the JAX runner trains, through one
  lockstep step (each grouped product one call over K·E groups).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import grad_and_value, vmap

import flax.linen as jnn
import optax
from chip_smoke import beyond_spacing, lockstep_epochs, settled_entries
from dlsc_tpu.data import ESC50DataModule as JaxDataModule
from dlsc_tpu.hpo import Study as JaxStudy
from dlsc_tpu.hpo import TPESampler as JaxTPE
from dlsc_tpu.hpo.hyperband import HyperbandPruner as JaxHyperband
from dlsc_tpu.hpo.vmapped import VmappedTrialRunner as JaxRunner
from dlsc_tpu.hpo.vmapped import schedule_factor as jax_schedule_factor
from dlsc_tpu.models.vit import ASTViT as JaxASTViT
from dlsc_tpu.train.metrics import MetricState as JaxMetricState
from dlsc_tpu_torch import hpo
from dlsc_tpu_torch.data.datamodule import ESC50DataModule
from dlsc_tpu_torch.data.pipeline import DevicePipeline
from dlsc_tpu_torch.data.synthetic import make_synthetic_dataset
from dlsc_tpu_torch.hpo.hyperband import HyperbandPruner
from dlsc_tpu_torch.hpo.vmapped import (ADAM_B1, TrialMetrics, TrialStates,
                                        VmappedTrialRunner, _slot_seed, adam_step_,
                                        schedule_factor)
from dlsc_tpu_torch.models.convert import params_from_jax
from dlsc_tpu_torch.models.vit import ASTViT
from dlsc_tpu_torch.ops import attn_fast as A
from dlsc_tpu_torch.ops import gmm as G
from dlsc_tpu_torch.ops import ln_fused as LN

NUM_CLASSES = 10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread in this file: its vmapped steps are many small
    ops, which slowed 30-70x on a pool of threads shared by parallel test
    workers (1.5 s alone, 53 s beside 5 busy workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class JaxVTiny(jnn.Module):
    """``tests/test_vmapped_hpo.py``'s ``VTiny``."""

    num_classes: int = NUM_CLASSES

    @jnn.compact
    def __call__(self, x, train: bool = False):
        x = x[..., None]
        x = jnn.Conv(8, (5, 5), (4, 4))(x)
        x = jnn.relu(x)
        return jnn.Dense(self.num_classes)(x.reshape(x.shape[0], -1))


class VTiny(nn.Module):
    """``JaxVTiny`` in torch: a stride-4 5x5 conv with Flax's SAME padding,
    ReLU, the NHWC flatten and a dense head; the port's forward contract
    and seeded init (``_init``)."""

    def __init__(self, n_mels: int = 128, n_frames: int = 51, num_classes: int = NUM_CLASSES):
        super().__init__()
        self.out_hw = (-(-n_mels // 4), -(-n_frames // 4))
        self.pad = []
        for size, out in zip((n_frames, n_mels), self.out_hw[::-1]):
            total = max((out - 1) * 4 + 5 - size, 0)
            self.pad += [total // 2, total - total // 2]
        self.conv = nn.Conv2d(1, 8, 5, 4)
        self.dense = nn.Linear(8 * self.out_hw[0] * self.out_hw[1], num_classes)

    def _init(self, gen):
        for p in self.parameters():
            p.normal_(0.0, 0.05, generator=gen)

    def flax_names(self):
        return {"Conv_0/kernel": "conv.weight", "Conv_0/bias": "conv.bias",
                "Dense_0/kernel": "dense.weight", "Dense_0/bias": "dense.bias"}

    def forward(self, x, dropout_seed=None, return_aux=False):
        h = F.relu(self.conv(F.pad(x[:, None], self.pad)))
        out = self.dense(h.permute(0, 2, 3, 1).reshape(x.shape[0], -1))
        return (out, 0.0, {}) if return_aux else out


def _tiny_vits(dropout=0.0):
    kw = dict(num_classes=NUM_CLASSES, emb_dim=32, depth=2, num_heads=2, patch_size=16,
              patch_stride=16, overlap=0, dropout=dropout)
    return (JaxASTViT(**kw, dtype=jnp.float32, use_flash=False, scan_blocks=True),
            ASTViT(**kw))


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("vshards")
    make_synthetic_dataset(root, num_classes=NUM_CLASSES, clips_per_class_per_fold=2,
                           clip_samples=8000)
    return root


def _dms(root, **kw):
    args = dict(root=str(root), num_classes=NUM_CLASSES, fold=0, val_split=0.2,
                batch_size=16, preprocessing_mode="ast", is_spectrogram=True, **kw)
    return JaxDataModule(**args), ESC50DataModule(**args)


@pytest.fixture(scope="module")
def dms(shards):
    return _dms(shards)


# ---- schedule_factor and the kernel ops under torch.func ------------------------------

def test_schedule_factor_matches_jax():
    counts = np.arange(0, 130, 3, dtype=np.float32)
    for tm, wu in ((0.0, 0.0), (100.0, 0.0), (100.0, 40.0), (400.0, 10.0), (50.0, 50.0),
                   (7.0, 3.0)):
        want = np.asarray(jax.vmap(lambda c: jax_schedule_factor(c, tm, wu))(counts))
        got = schedule_factor(torch.from_numpy(counts), tm, wu).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)
    # per-slot shapes broadcast, as the stacked optimiser uses them
    got = schedule_factor(torch.tensor([5, 5]), torch.tensor([0.0, 100.0]),
                          torch.tensor([0.0, 10.0]))
    np.testing.assert_allclose(got.numpy(), [1.0, 0.5], atol=1e-6)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _vmap_vs_loop(f, batched, shared=()):
    """``vmap(grad_and_value(f))`` over the leading axis of ``batched``
    against a loop of single calls: the largest normalised difference."""
    got_g, got_v = vmap(grad_and_value(f, argnums=tuple(range(len(batched)))),
                        in_dims=(0,) * len(batched) + (None,) * len(shared))(*batched, *shared)
    err = 0.0
    for i in range(batched[0].shape[0]):
        want_g, want_v = grad_and_value(f, argnums=tuple(range(len(batched))))(
            *(b[i] for b in batched), *shared)
        err = max(err, _rel(got_v[i], want_v),
                  *(_rel(g[i], w) for g, w in zip(got_g, want_g)))
    return err


def _spy(monkeypatch, module, *names):
    calls = []
    for name in names:
        fn = getattr(module, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls.append((_name, tuple(a[0].shape)))
            return _fn(*a, **kw)

        monkeypatch.setattr(module, name, spy)
    return calls


def test_attention_under_vmap(monkeypatch):
    rng = np.random.default_rng(0)
    K, B, H, N, DH, n_real = 3, 2, 2, 128, 64, 100
    q, k, v, cot = (torch.from_numpy(rng.standard_normal((K, B, H, N, DH), dtype=np.float32))
                    for _ in range(4))
    calls = _spy(monkeypatch, A, "fast_mha_forward", "fast_mha_backward")
    vmap(grad_and_value(lambda a, b, c: (A.fast_mha(a, b, c, n_real) * cot[0]).sum(),
                        argnums=(0, 1, 2)))(q, k, v)
    assert calls == [("fast_mha_forward", (K * B, H, N, DH)),
                     ("fast_mha_backward", (K * B, H, N, DH))]
    err = _vmap_vs_loop(lambda a, b, c, t: (A.fast_mha(a, b, c, n_real) * t).sum(),
                        (q, k, v, cot))
    assert err <= 1e-6, err


@pytest.mark.parametrize("shared_gamma", [False, True])
def test_add_ln_under_vmap(monkeypatch, shared_gamma):
    rng = np.random.default_rng(1)
    K, R, D = 3, 10, 32
    x, delta, cot_r, cot_y = (torch.from_numpy(rng.standard_normal((K, R, D), dtype=np.float32))
                              for _ in range(4))
    gamma, beta = (torch.from_numpy(rng.standard_normal((K, D), dtype=np.float32))
                   for _ in range(2))

    def f(a, d, g, b, cr, cy):
        r, y, _, _ = LN.add_ln(a, d, g, b)
        return (r * cr).sum() + (y * cy).sum()

    calls = _spy(monkeypatch, LN, "fused_add_ln_forward", "fused_add_ln_backward")
    if shared_gamma:
        vmap(grad_and_value(lambda a, d: f(a, d, gamma[0], beta[0], cot_r[0], cot_y[0]),
                            argnums=(0, 1)))(x, delta)
        assert [c[0] for c in calls] == ["fused_add_ln_forward"] + ["fused_add_ln_backward"] * K
        assert calls[0][1] == (K, R, D)   # the trials' rows in one launch
        err = _vmap_vs_loop(lambda a, d, g, b: f(a, d, g, b, cot_r[0], cot_y[0]), (x, delta),
                            (gamma[0], beta[0]))
    else:
        vmap(grad_and_value(lambda *a: f(*a, cot_r[0], cot_y[0]), argnums=(0, 1, 2, 3)))(
            x, delta, gamma, beta)
        assert [c[0] for c in calls] == (["fused_add_ln_forward"] * K
                                         + ["fused_add_ln_backward"] * K)
        err = _vmap_vs_loop(f, (x, delta, gamma, beta, cot_r, cot_y))
    assert err <= 1e-6, err


def test_grouped_matmul_under_vmap(monkeypatch):
    rng = np.random.default_rng(2)
    K, E, M, kk, n = 3, 4, 40, 16, 24
    lhs, cot = (torch.from_numpy(rng.standard_normal((K, M, d), dtype=np.float32))
                for d in (kk, n))
    rhs = torch.from_numpy(rng.standard_normal((K, E, kk, n), dtype=np.float32))
    # each trial its own split of the rows, empty groups included
    gs = torch.tensor([[10, 0, 25, 5], [0, 40, 0, 0], [12, 9, 9, 10]], dtype=torch.int32)
    calls = _spy(monkeypatch, G, "gmm", "tgmm")
    vmap(grad_and_value(lambda a, b, s: (G.grouped_matmul(a, b, s) * cot[0]).sum(),
                        argnums=(0, 1)))(lhs, rhs, gs)
    assert calls == [("gmm", (K * M, kk)), ("gmm", (K * M, n)), ("tgmm", (K * M, kk))]
    got_g, got_v = vmap(grad_and_value(
        lambda a, b, t, s: (G.grouped_matmul(a, b, s) * t).sum(), argnums=(0, 1)))(
        lhs, rhs, cot, gs)
    for i in range(K):
        want_g, want_v = grad_and_value(
            lambda a, b: (G.grouped_matmul(a, b, gs[i]) * cot[i]).sum(), argnums=(0, 1))(
            lhs[i], rhs[i])
        assert max(_rel(got_v[i], want_v), *(_rel(g[i], w) for g, w in zip(got_g, want_g))
                   ) <= 1e-6


# ---- one vmapped step against the JAX step -------------------------------------------

def _jax_states(jrunner, k, hp):
    fns = jrunner._build_exec()
    keys = jax.random.split(jax.random.key(jrunner.seed), k)
    states = fns["init_v"](keys, *(jnp.asarray(hp[n]) for n in ("lr", "wd", "do", "tm", "wu")))
    return fns, states


def _slot_params(jparams, i):
    return jax.tree_util.tree_map(lambda a: np.asarray(a[i]), jparams)


def _load_slots(pst, jparams, model):
    """Write each slot's JAX params into the port's stacked state."""
    for i in range(pst.k):
        sd = params_from_jax(_slot_params(jparams, i), model)
        for name, view in pst.params.items():
            view[i].copy_(sd[name])


HP = {"lr": np.asarray([1e-3, 5e-3], np.float32), "wd": np.asarray([1e-6, 1e-3], np.float32),
      "ls": np.asarray([0.0, 0.1], np.float32), "do": np.zeros(2, np.float32),
      "ma": np.ones(2, np.float32), "tm": np.asarray([0.0, 6.0], np.float32),
      "wu": np.asarray([0.0, 2.0], np.float32)}


def _adam_moments(opt_state):
    """(mu, nu) of the ScaleByAdamState inside a JAX runner's optimiser state."""
    found = []
    jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: isinstance(
        x, optax.ScaleByAdamState) and not found.append(x))
    return found[0].mu, found[0].nu


@pytest.mark.parametrize("arch", ["vtiny", "vit"])
def test_one_step_matches_jax(dms, tmp_path, arch):
    jdm, pdm = dms
    jmodel, pmodel = (JaxVTiny(), VTiny()) if arch == "vtiny" else _tiny_vits()
    jrunner = JaxRunner(JaxStudy("j", tmp_path / "j.db", "maximize"), jmodel, jdm.pipeline,
                        jdm, epochs=1, seed=0)
    prunner = VmappedTrialRunner(hpo.Study("p", tmp_path / "p.db", "maximize"), pmodel,
                                 pdm.pipeline, pdm, epochs=1, seed=0, device="cpu")
    jfns, jst = _jax_states(jrunner, 2, HP)
    pfns = prunner._build_exec()
    pst = pfns["init_v"]([0, 1], HP["lr"], HP["wd"], HP["do"], HP["tm"], HP["wu"])
    _load_slots(pst, jst.params, pmodel)
    batch = next(iter(pdm.train_batches(epoch=0, seed=0)))
    jparams0 = jax.tree_util.tree_map(np.array, jst.params)   # the step donates its state
    flat0 = pst.flat.clone()
    jms = jax.vmap(lambda _: JaxMetricState.create(NUM_CLASSES))(jnp.arange(2))
    pms = TrialMetrics(2, NUM_CLASSES, torch.device("cpu"))
    jst, jms, jloss = jfns["train"](jst, jms, jnp.asarray(HP["ls"]), jnp.asarray(HP["ma"]),
                                    jnp.asarray(batch["wave"]), jnp.asarray(batch["label"]))
    _, _, ploss = pfns["train"](pst, pms, HP["ls"], HP["ma"], batch["wave"], batch["label"])
    np.testing.assert_allclose(ploss.numpy(), np.asarray(jloss), rtol=1e-5)
    np.testing.assert_array_equal(pfns["acc"](pms), np.asarray(jfns["acc"](jms)))
    # the moments hold each trial's clipped + L2 gradient
    jmu, jnu = _adam_moments(jst.opt_state)
    jdelta = jax.tree_util.tree_map(lambda a, b: a - b, jst.params, jparams0)

    def views(flat):
        return type(pst)(flat, pst.shapes, {}, flat, flat, pst.count, {}, []).params

    for ours, theirs in ((pst.mu, jmu), (pst.nu, jnu)):
        for i in range(2):
            want = params_from_jax(_slot_params(theirs, i), pmodel)
            for name, view in views(ours).items():
                err = _rel(view[i], want[name])
                assert err <= 1e-5, (arch, i, name, err)
    # and the parameter change, where the gradient sets it, beyond one f32
    # spacing of the parameter (both changes are differences of f32 params)
    for i in range(2):
        grad = params_from_jax(_slot_params(jmu, i), pmodel)
        want = params_from_jax(_slot_params(jdelta, i), pmodel)
        for (name, view), p0 in zip(views(pst.flat - flat0).items(), views(flat0).values()):
            keep = settled_entries(grad[name] / (1 - ADAM_B1))
            assert keep.any(), (arch, i, name)
            err = float(beyond_spacing(view[i], want[name], p0[i])[keep].max()
                        / want[name].abs().max().clamp_min(1e-30))
            assert err <= 1e-5, (arch, i, name, err)


def test_per_trial_optimiser_matches_the_injected_tx():
    """``adam_step_`` against ``_make_injected_tx`` (clip, L2, Adam, lr ·
    schedule) run per trial on the same gradients, three steps, each trial
    its own lr, weight decay, T_max and warmup; the second trial's norm
    under the clip. 1e-6 of each step's largest update."""
    from dlsc_tpu.hpo.vmapped import _make_injected_tx

    rng = np.random.default_rng(4)
    K, P = 2, 300
    p0 = rng.standard_normal((K, P)).astype(np.float32)
    grads = [rng.standard_normal((K, P)).astype(np.float32) * np.asarray([[1.0], [1e-3]],
                                                                          np.float32)
             for _ in range(3)]
    hp = {"lr": [1e-3, 5e-2], "wd": [1e-2, 1e-4], "tm": [0.0, 6.0], "wu": [0.0, 2.0]}
    flat = torch.from_numpy(p0.copy())
    st = TrialStates(flat, [("w", (P,))], {}, torch.zeros_like(flat), torch.zeros_like(flat),
                     torch.zeros(K, dtype=torch.int32),
                     {n: torch.tensor(v, dtype=torch.float32) for n, v in hp.items()}, [])
    for g in grads:
        adam_step_(st, torch.from_numpy(g), 1.0)
    for i in range(K):
        tx = _make_injected_tx(1.0)(learning_rate=hp["lr"][i], weight_decay=hp["wd"][i],
                                    t_max_steps=hp["tm"][i], warmup_steps=hp["wu"][i])
        params = jnp.asarray(p0[i])
        state = tx.init(params)
        for g in grads:
            upd, state = tx.update(jnp.asarray(g[i]), state, params)
            params = optax.apply_updates(params, upd)
        change = np.asarray(params) - p0[i]
        np.testing.assert_allclose(st.flat[i].numpy() - p0[i], change,
                                   atol=1e-6 * np.abs(change).max())


# ---- per-trial effects -----------------------------------------------------------------

def _fixed_ask(runner, study, **cols):
    """``runner._ask_batch`` returning trials with the given per-slot values."""
    def ask(k):
        hp = {"lr": np.full(k, 5e-3, np.float32), "wd": np.full(k, 1e-6, np.float32),
              "ls": np.zeros(k, np.float32), "do": np.zeros(k, np.float32),
              "ma": np.ones(k, np.float32), "tm": np.zeros(k, np.float32),
              "wu": np.zeros(k, np.float32)}
        hp.update({n: np.asarray(v[:k], np.float32) for n, v in cols.items()})
        trials = []
        for i in range(k):
            t = study.ask()
            t.params["optimizer.lr"] = float(hp["lr"][i])
            trials.append(t)
        return trials, hp
    runner._ask_batch = ask


@pytest.mark.parametrize("effect", ["lr", "dropout", "schedule"])
def test_per_trial_effects(dms, tmp_path, effect):
    _, pdm = dms
    study = hpo.Study(effect, tmp_path / "e.db", "maximize")
    spe = pdm.steps_per_epoch
    model = VTiny() if effect != "dropout" else _tiny_vits(0.5)[1]
    kw = dict(do_space={"low": 0.0, "high": 0.95}) if effect == "dropout" else {}
    runner = VmappedTrialRunner(study, model, pdm.pipeline, pdm, epochs=4, seed=0,
                                device="cpu", **kw)
    cols = {"lr": dict(lr=[1e-9, 5e-3]), "dropout": dict(do=[0.0, 0.95]),
            "schedule": dict(tm=[0.0, 1000.0 * spe], wu=[0.0, 1000.0 * spe])}[effect]
    _fixed_ask(runner, study, **cols)
    result = runner.run_batch(k=2)
    if effect == "dropout":   # the stacked state holds each slot's rate
        rates = [b for n, b in result.states.buffers.items() if n.endswith("hyper_rate")]
        assert len(rates) == 2
        for r in rates:
            np.testing.assert_allclose(r.numpy(), [0.0, 0.95])
    live, frozen = (result.history[-1]["train_acc"][i] for i in ((1, 0) if effect == "lr"
                                                                 else (0, 1)))
    assert live > frozen + 0.1, (effect, result.history)


def test_mixup_alpha_is_per_trial(shards, tmp_path):
    """Each trial's α draws its own λ: α 0.05 leaves near one-hot labels,
    α 50 mixes them near 0.5; the study records a distinct α per trial."""
    _, pdm = _dms(shards, enable_mixup=True)
    pipe = pdm.pipeline
    wave = torch.zeros((64, 8000))
    labels = torch.arange(64) % NUM_CLASSES
    rngs = [np.random.default_rng(3) for _ in range(2)]
    draws = [pipe.draw(64, 8000, r, a) for r, a in zip(rngs, (0.05, 50.0))]
    _, ys = pipe.train_batch_trials(wave, labels, draws)
    gated = draws[0].mix.gate.numpy()
    top = ys.max(-1).values.numpy()[:, gated].mean(-1)
    assert top[0] > top[1] + 0.2, top
    study = hpo.Study("ma", tmp_path / "ma.db", "maximize", sampler=hpo.TPESampler(seed=3))
    runner = VmappedTrialRunner(study, VTiny(), pipe, pdm, epochs=1, seed=3, device="cpu",
                                ma_space={"low": 0.1, "high": 5.0, "log": True})
    runner.run_batch(k=3)
    alphas = {round(t.params["dataset.mixup_alpha"], 8) for t in study.trials}
    assert len(alphas) == 3 and all(a > 0 for a in alphas)


# ---- the runners against the JAX runner ---------------------------------------------

def _paired_runners(dms, tmp_path, name, epochs, pruner_kw):
    jdm, pdm = dms
    jstudy = JaxStudy(name, tmp_path / "j.db", "maximize", sampler=JaxTPE(seed=2),
                      pruner=JaxHyperband(**pruner_kw))
    pstudy = hpo.Study(name, tmp_path / "p.db", "maximize", sampler=hpo.TPESampler(seed=2),
                       pruner=HyperbandPruner(**pruner_kw))
    jrunner = JaxRunner(jstudy, JaxVTiny(), jdm.pipeline, jdm, epochs=epochs, seed=2)
    prunner = VmappedTrialRunner(pstudy, VTiny(), pdm.pipeline, pdm, epochs=epochs, seed=2,
                                 device="cpu")
    # the port's slots start from the JAX runner's inits: init_v from
    # split(key(seed), k), a recycled slot from fold_in(key(seed), 1000 + n)
    jfns = jrunner._build_exec()
    jrunner._build_exec = lambda: jfns
    build = prunner._build_exec

    def paired_exec():
        fns = build()
        init_v = fns["init_v"]

        def from_jax(jstate, seeds, hp_cols):
            pst = init_v(seeds, *hp_cols)
            _load_slots(pst, jstate.params, prunner.model)
            return pst

        def init_v_j(seeds, lr, wd, do, tm, wu):
            keys = jax.random.split(jax.random.key(2), len(seeds))
            js = jfns["init_v"](keys, *(jnp.asarray(np.asarray(c, np.float32))
                                        for c in (lr, wd, do, tm, wu)))
            return from_jax(js, seeds, (lr, wd, do, tm, wu))

        def init_one_j(seed, lr, wd, do, tm, wu):
            n = next(i for i in range(1000, 1100) if _slot_seed(2, i) == seed)
            js = jfns["init_one"](jax.random.fold_in(jax.random.key(2), n),
                                  *(jnp.asarray(c, jnp.float32) for c in (lr, wd, do, tm, wu)))
            js = jax.tree_util.tree_map(lambda a: a[None], js.params)
            pst = init_v([seed], [lr], [wd], [do], [tm], [wu])
            _load_slots(pst, js, prunner.model)
            return pst

        fns["init_v"], fns["init_one"] = init_v_j, init_one_j
        return fns

    prunner._build_exec = paired_exec
    share = 1.0 / len(list(pdm.val_batches()))   # > one sample's share of the accuracy
    return jrunner, prunner, jstudy, pstudy, share / pdm.batch_size


def _same_studies(jstudy, pstudy, share):
    assert len(jstudy.trials) == len(pstudy.trials)
    for jt, pt in zip(jstudy.trials, pstudy.trials):
        assert pt.params == jt.params
        assert str(pt.state) == str(jt.state)
        assert set(pt.intermediate_values) == set(jt.intermediate_values)
        for s, v in jt.intermediate_values.items():
            assert abs(pt.intermediate_values[s] - v) <= share + 1e-6


def test_run_batch_matches_jax(dms, tmp_path):
    jr, pr, js, ps, share = _paired_runners(dms, tmp_path, "batch", 2, dict(
        min_resource=1, max_resource=2, reduction_factor=2))
    jres, pres = jr.run_batch(k=3), pr.run_batch(k=3)
    assert pres.trial_numbers == jres.trial_numbers
    _same_studies(js, ps, share)
    for jh, ph in zip(jres.history, pres.history):
        np.testing.assert_allclose(ph["val_acc"], jh["val_acc"], atol=share + 1e-6)


def test_run_continuous_matches_jax(dms, tmp_path):
    jr, pr, js, ps, share = _paired_runners(dms, tmp_path, "cont", 2, dict(
        min_resource=1, max_resource=2, reduction_factor=2))
    epochs, run_epoch = [], pr._epoch
    pr._epoch = lambda *a: epochs.append(1) or run_epoch(*a)
    jfin, pfin = jr.run_continuous(k=2, total_trials=4), pr.run_continuous(k=2, total_trials=4)
    assert [t.number for t in pfin] == [t.number for t in jfin]
    assert len(ps.trials) == 4
    _same_studies(js, ps, share)
    # phase 28 of chip_smoke.py derives the lockstep epochs from the trials
    assert lockstep_epochs(ps.trials, 2) == len(epochs)


# ---- refusals and the CLI ------------------------------------------------------------

def test_refusals_carry_the_jax_messages(dms, shards, tmp_path):
    _, pdm = dms
    study = hpo.Study("err", tmp_path / "err.db", "maximize")
    with pytest.raises(ValueError, match="hyper_dropout"):
        VmappedTrialRunner(study, VTiny(), pdm.pipeline, pdm, do_space={"low": 0.0,
                                                                        "high": 0.5})
    with pytest.raises(ValueError, match="enable_mixup"):
        VmappedTrialRunner(study, VTiny(), pdm.pipeline, pdm,
                           ma_space={"low": 0.1, "high": 2.0})
    _, mix = _dms(shards, enable_mixup=True)
    with pytest.raises(ValueError, match="must be > 0"):
        VmappedTrialRunner(study, VTiny(), mix.pipeline, mix, ma_space={"low": 0.0,
                                                                        "high": 2.0})
    with pytest.raises(ValueError, match="tmax_space"):
        VmappedTrialRunner(study, VTiny(), pdm.pipeline, pdm,
                           wu_space={"low": 0.0, "high": 0.3})
    with pytest.raises(ValueError, match="enable_mixup"):
        pdm.pipeline.draw(2, 8000, np.random.default_rng(0), mixup_alpha=0.5)
    with pytest.raises(ValueError, match="must be > 0"):
        mix.pipeline.draw(2, 8000, np.random.default_rng(0), mixup_alpha=0.0)


def test_vmapped_cli_on_the_synthetic_tree(tmp_path, monkeypatch):
    """``optimize_hyperparams +optuna.vmapped.enabled=true`` with a tiny
    AST-Base (the ViT family: dropout searched through ``hyper_dropout``),
    every vmappable space, slot recycling."""
    from dlsc_tpu_torch.scripts import optimize_hyperparams

    root = tmp_path / "data"
    make_synthetic_dataset(root, num_classes=4, clips_per_class_per_fold=2,
                           clip_samples=16_000, seed=1)
    monkeypatch.setenv("DLSC_TRACKING_DIR", str(tmp_path / "runs"))
    spaces = ("{optimizer.lr: {low: 1e-4, high: 1e-2, log: true}, "
              "optimizer.weight_decay: {low: 1e-6, high: 1e-3, log: true}, "
              "loss.label_smoothing: {low: 0.0, high: 0.2}, "
              "model.dropout: {low: 0.0, high: 0.5}, "
              "dataset.mixup_alpha: {low: 0.1, high: 1.0}, "
              "scheduler.T_max: {low: 1, high: 4}, scheduler.warmup_frac: {low: 0.0, high: 0.3}}")
    study = optimize_hyperparams.main([
        "model=ast", "trainer.accelerator=cpu", f"dataset.root={root}",
        "dataset.num_classes=4", "+model.emb_dim=32", "+model.depth=2", "+model.num_heads=2",
        "batch_size=8", "trainer.max_epochs=2", "optuna.n_trials=3",
        f"optuna.storage_path=sqlite:///{tmp_path / 'study.db'}",
        f"optuna.output_dir={tmp_path / 'out'}", "+optuna.vmapped.enabled=true",
        "+optuna.vmapped.k=2", f"+optuna.vmapped.spaces={spaces}"])
    assert len(study.trials) == 3
    assert {t.state for t in study.trials} <= {hpo.TrialState.COMPLETE, hpo.TrialState.PRUNED}
    assert len({t.params["optimizer.lr"] for t in study.trials}) == 3
    for t in study.trials:
        assert {"model.dropout", "dataset.mixup_alpha", "scheduler.T_max",
                "scheduler.warmup_frac", "loss.label_smoothing"} <= set(t.params)
        assert t.intermediate_values
    # a reload in the JAX package's schema
    reloaded = JaxStudy(study.study_name, tmp_path / "study.db", "maximize")
    assert [t.params for t in reloaded.trials] == [t.params for t in study.trials]


def test_a_recycled_slot_is_written_in_place(dms, tmp_path):
    """``run_continuous`` writes a recycled slot in place: the other slots'
    parameters and moments are untouched by the write."""
    _, pdm = dms
    study = hpo.Study("slots", tmp_path / "s.db", "maximize", sampler=hpo.TPESampler(seed=5))
    runner = VmappedTrialRunner(study, VTiny(), pdm.pipeline, pdm, epochs=1, seed=5,
                                device="cpu")
    fns = runner._build_exec()
    st = fns["init_v"]([1, 2], [1e-3, 2e-3], [0, 0], [0, 0], [0, 0], [0, 0])
    batch = next(iter(pdm.train_batches(epoch=0, seed=5)))
    fns["train"](st, TrialMetrics(2, NUM_CLASSES, torch.device("cpu")), [0, 0], [1, 1],
                 batch["wave"], batch["label"])
    keep = st.flat[1].clone(), st.mu[1].clone()
    fresh = fns["init_one"](7, 3e-3, 0.0, 0.0, 0.0, 0.0)
    st.scatter(fresh, 0)
    assert torch.equal(st.flat[0], fresh.flat[0]) and not st.mu[0].any()
    assert int(st.count[0]) == 0 and int(st.count[1]) == 1
    assert torch.equal(st.flat[1], keep[0]) and torch.equal(st.mu[1], keep[1])
    assert math.isclose(float(st.hyper["lr"][0]), 3e-3, rel_tol=1e-6)


def test_ast_moe_ragged_runs_vmapped(dms, tmp_path, monkeypatch):
    """The JAX runner trains a tiny ``ASTMoE(dispatch='ragged')`` (``jax.vmap``
    of ``ragged_dot``), so the port's does: one lockstep step of 2 trials,
    each grouped product one call over K·E groups."""
    from dlsc_tpu_torch.models.ast_moe import ASTMoE

    _, pdm = dms
    model = ASTMoE(num_classes=NUM_CLASSES, emb_dim=32, depth=1, num_heads=2, n_experts=4,
                   top_k=2, dtype=torch.float32, remat=False)
    runner = VmappedTrialRunner(hpo.Study("moe", tmp_path / "m.db", "maximize"), model,
                                pdm.pipeline, pdm, epochs=1, seed=0, device="cpu")
    fns = runner._build_exec()
    st = fns["init_v"]([1, 2], [1e-3, 2e-3], [0, 0], [0, 0], [0, 0], [0, 0])
    calls = []
    for name in ("gmm", "tgmm"):
        fn = getattr(G, name)
        monkeypatch.setattr(G, name, lambda *a, _fn=fn, _n=name, **kw: (
            calls.append((_n, tuple(a[2].shape))), _fn(*a, **kw))[1])
    before = st.flat.clone()
    batch = next(iter(pdm.train_batches(epoch=0, seed=0)))
    _, _, loss = fns["train"](st, TrialMetrics(2, NUM_CLASSES, torch.device("cpu")),
                              [0, 0], [1, 1], batch["wave"], batch["label"])
    assert torch.isfinite(loss).all() and (st.flat != before).any(1).all()
    assert sorted(calls) == [("gmm", (8,))] * 4 + [("tgmm", (8,))] * 2
