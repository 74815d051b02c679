"""Port parity: the Trainer (fit, validate, test, SWA, gradient accumulation),
checkpoints, early stopping and resume, against the JAX package on the CPU.

A tiny AST (emb 64, depth 2, heads 2, f32, dropout 0) on tiny synthetic
shards (4 classes, 16 000-sample clips), Mixup and SpecAugment off, SGD with the
global-norm clip and a cosine schedule, starts from the JAX init (carried
across as an ``.npz`` through ``pretrained_path``). One JAX ``Trainer.fit``
of 2 epochs x 2 batches with SWA from epoch 0 and its ``test`` are the
reference for two port runs, one from the device-resident pool and one
host-streamed. Tolerances, each with its reason:

- epoch metrics (train/loss, train/acc, val/acc, val/loss, lr) and test
  metrics (acc, F1, AUROC, loss): 1e-4 relative (1e-6 absolute near 0):
  f32 on both sides, the port pads 109 tokens to 128 and masks them where
  JAX runs them unpadded, so only the summation order differs; the
  confusion matrix exactly;
- SWA's averaged parameters and one accumulating step's parameters: 1e-4
  of each parameter's largest |value| (the same summation-order argument);
- checkpoint names, deletions, ledgers and the early-stop epoch: exact;
- a resumed run against an uninterrupted one: bit-equal parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlsc_tpu.data import ESC50DataModule as JaxDataModule
from dlsc_tpu.models.ast import ASTModel as JaxASTModel
from dlsc_tpu.train import checkpoint as JC
from dlsc_tpu.train import losses as JL
from dlsc_tpu.train import loop as JLOOP
from dlsc_tpu.train import metrics as JM
from dlsc_tpu.train import optim as JO
from dlsc_tpu.train.state import TrainState as JaxTrainState
from dlsc_tpu.train.steps import make_train_step as jax_make_train_step
from dlsc_tpu_torch.data.datamodule import ESC50DataModule
from dlsc_tpu_torch.data.synthetic import make_synthetic_dataset
from dlsc_tpu_torch.models.ast import ASTModel
from dlsc_tpu_torch.models.convert import params_from_jax
from dlsc_tpu_torch.models.vit import ASTViT
from dlsc_tpu_torch.parallel import MeshPlan, make_layout
from dlsc_tpu_torch.parallel.pp import check_batch
from dlsc_tpu_torch.train import checkpoint as C
from dlsc_tpu_torch.train import losses as L
from dlsc_tpu_torch.train import metrics as M
from dlsc_tpu_torch.train import optim as O
from dlsc_tpu_torch.train.loop import EarlyStopping, Trainer, resolve_device
from dlsc_tpu_torch.train.state import TrainState
from dlsc_tpu_torch.train.steps import make_train_step
from dlsc_tpu_torch.utils import profiling

C_ = 4
CLIP = 16_000
SMALL = dict(num_classes=C_, emb_dim=64, depth=2, num_heads=2)
DM_KW = dict(num_classes=C_, fold=0, val_split=0.2, batch_size=8, preprocessing_mode="ast",
             is_spectrogram=True, preprocessing_config={"n_mels": 128})
LR, T_MAX, CLIP_VAL = 0.1, 4, 1.0
EPOCHS, LIMIT = 2, 2
CKPT_CFG = {"monitor": "val/acc", "mode": "max", "save_top_k": 1}
SWA_CFG = {"swa_epoch_start": 0}
METRIC_TOL = dict(rel=1e-4, abs=1e-6)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _param_err(model: torch.nn.Module, jax_params) -> float:
    want = params_from_jax(_np(jax_params), model)
    return max(((p.detach() - want[k]).abs().max() / want[k].abs().max().clamp_min(1e-30)).item()
               for k, p in model.state_dict().items())


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tmp_path_factory.mktemp("trainer_shards")
    make_synthetic_dataset(r, num_classes=C_, clips_per_class_per_fold=4, clip_samples=CLIP,
                           seed=0)
    return r


@pytest.fixture(scope="module")
def jax_run(root, tmp_path_factory):
    """The JAX reference: init params (as an .npz), the fit's history, its
    final (SWA) params and the test results."""
    tmp = tmp_path_factory.mktemp("jax_run")
    jmodel = JaxASTModel(**SMALL, dtype=jnp.float32, remat=False)
    jdm = JaxDataModule(root=str(root), **DM_KW)
    optim, sched = JO.sgd(lr=LR), JO.cosine_annealing(T_max=T_MAX)
    init = JLOOP.Trainer(seed=0, devices=1).init_state(jmodel, jdm, optim, sched)
    npz = tmp / "init.npz"
    np.savez(npz, **_flat(init.params))
    trainer = JLOOP.Trainer(max_epochs=EPOCHS, limit_train_batches=LIMIT,
                            gradient_clip_val=CLIP_VAL, enable_progress_bar=False,
                            checkpoint_dir=tmp / "ck", seed=0, devices=1)
    state = trainer.fit(jmodel, jdm, optim, sched, criterion=JL.CrossEntropyLoss(),
                        checkpoint_cfg=dict(CKPT_CFG), swa_cfg=dict(SWA_CFG))
    results = trainer.test(jdm, criterion=JL.CrossEntropyLoss())
    return dict(npz=npz, history=trainer.history, params=state.params, results=results,
                pool=trainer._use_device_data)


@pytest.fixture(scope="module")
def port_runs(root, jax_run, tmp_path_factory):
    runs = {}
    for mode in ("auto", False):
        tmp = tmp_path_factory.mktemp(f"port_run_{mode}")
        trainer = Trainer(accelerator="cpu", max_epochs=EPOCHS, limit_train_batches=LIMIT,
                          gradient_clip_val=CLIP_VAL, checkpoint_dir=tmp / "ck", seed=0,
                          device_data=mode)
        model = ASTModel(**SMALL, dtype=torch.float32)
        trainer.fit(model, ESC50DataModule(root=str(root), **DM_KW), O.sgd(lr=LR),
                    O.cosine_annealing(T_max=T_MAX), criterion=L.CrossEntropyLoss(),
                    checkpoint_cfg=dict(CKPT_CFG), swa_cfg=dict(SWA_CFG),
                    pretrained_path=str(jax_run["npz"]))
        swa_params = {k: v.clone() for k, v in model.state_dict().items()}
        results = trainer.test(ESC50DataModule(root=str(root), **DM_KW),
                               criterion=L.CrossEntropyLoss())
        runs[mode] = dict(trainer=trainer, model=model, swa_params=swa_params, results=results)
    return runs


MODES = pytest.mark.parametrize("mode", ["auto", False], ids=["pool", "host"])


@MODES
def test_data_route(port_runs, jax_run, mode):
    assert jax_run["pool"] is True
    assert port_runs[mode]["trainer"]._use_device_data is (mode == "auto")


@MODES
def test_fit_epoch_metrics_match_jax(port_runs, jax_run, mode):
    got, want = port_runs[mode]["trainer"].history, jax_run["history"]
    assert [h["epoch"] for h in got] == [h["epoch"] for h in want] == list(range(EPOCHS))
    for g, w in zip(got, want):
        for k in ("train/loss", "train/acc", "val/acc", "val/loss", "lr"):
            assert g[k] == pytest.approx(w[k], **METRIC_TOL), (g["epoch"], k)
    assert got[-1]["train/loss"] != got[0]["train/loss"]   # it trained


@MODES
def test_test_metrics_match_jax(port_runs, jax_run, mode):
    got, want = port_runs[mode]["results"], jax_run["results"]
    for k in ("test/acc", "test/f1", "test/auroc", "test/loss"):
        assert got[k] == pytest.approx(want[k], **METRIC_TOL), k
    np.testing.assert_array_equal(got["confmat"], want["confmat"])
    np.testing.assert_allclose(got["per_class_acc"], want["per_class_acc"], rtol=1e-6)


@MODES
def test_swa_params_match_jax(port_runs, jax_run, mode):
    model = ASTModel(**SMALL, dtype=torch.float32)
    model.load_state_dict(port_runs[mode]["swa_params"])
    assert _param_err(model, jax_run["params"]) < 1e-4


def test_accumulating_step_matches_jax(root):
    """accumulate_grad_batches=2: one step on a batch of 8 split in two, SGD,
    against the JAX step with accum=2; and against the port's own
    accum=1 step (without BatchNorm or dropout the mean of the micro-batch
    means is the batch mean, so the gradients agree to rounding)."""
    dm = ESC50DataModule(root=str(root), **DM_KW)
    batch = next(iter(dm.train_batches(0)))
    jdm = JaxDataModule(root=str(root), **DM_KW)
    jmodel = JaxASTModel(**SMALL, dtype=jnp.float32, remat=False)
    feats, _ = jdm.pipeline.eval_batch(jnp.asarray(batch.wave[:2]), jnp.zeros(2, jnp.int32))
    variables = jmodel.init({"params": jax.random.key(4)}, feats, train=False)
    tx, _ = JO.build_optimizer(JO.sgd(lr=LR), None, 1, CLIP_VAL)
    jstate = JaxTrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                  batch_stats=None, tx=tx, rng=jax.random.key(5))
    jstep = jax.jit(jax_make_train_step(jdm.pipeline, JL.CrossEntropyLoss(), 2))
    jstate, jms, jloss = jstep(jstate, JM.MetricState.create(C_), jnp.asarray(batch.wave),
                               jnp.asarray(batch.label))
    out = {}
    for accum in (2, 1):
        model = ASTModel(**SMALL, dtype=torch.float32)
        model.load_state_dict(params_from_jax(_np(variables["params"]), model))
        state = TrainState.create(model, O.sgd(lr=LR), None, 1, gradient_clip_val=CLIP_VAL)
        step = make_train_step(dm.pipeline, L.CrossEntropyLoss(), accum)
        _, ms, loss = step(state, M.MetricState.create(C_), torch.from_numpy(batch.wave),
                           torch.from_numpy(batch.label))
        out[accum] = (model, ms, loss)
    model, ms, loss = out[2]
    assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    np.testing.assert_array_equal(ms.confmat.numpy(), np.asarray(jms.confmat))
    assert ms.batches.item() == int(jms.batches) == 2
    assert _param_err(model, jstate.params) < 1e-4
    single = out[1][0].state_dict()
    for k, p in model.state_dict().items():
        assert ((p - single[k]).abs().max() / single[k].abs().max().clamp_min(1e-30)) < 1e-5, k
    with pytest.raises(ValueError, match="not divisible"):
        make_train_step(dm.pipeline, L.CrossEntropyLoss(), 3)(
            state, M.MetricState.create(C_), torch.from_numpy(batch.wave),
            torch.from_numpy(batch.label))


# ---- checkpoints and early stopping -------------------------------------------

def _states():
    jstate = JaxTrainState.create(apply_fn=lambda *a, **k: None,
                                  params={"w": jnp.ones((2,))}, batch_stats=None,
                                  tx=optax.sgd(0.1), rng=jax.random.key(0))
    state = TrainState.create(torch.nn.Linear(2, 1), O.sgd(lr=0.1), None, 1)
    return jstate, state


SEQUENCE = [0.50, 0.70, 0.60, 0.80, 0.80, 0.30, 0.90]


@pytest.mark.parametrize("cfg", [
    dict(save_top_k=2, filename="epoch-{epoch:02d}-val_acc-{val/acc:.3f}"),
    dict(save_top_k=-1),
    dict(save_top_k=1, monitor="val/loss", mode="min", save_last=True),
    dict(save_top_k=0, save_last=True),
], ids=["top2-template", "all", "min-last", "off"])
def test_checkpoint_manager_matches_jax(cfg, tmp_path):
    """The same saves, names, deletions, best path and value, and the same
    ledger re-read on resume."""
    jstate, state = _states()
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jm, pm = JC.CheckpointManager(jdir, **cfg), C.CheckpointManager(pdir, **cfg)
    monitor = cfg.get("monitor", "val/acc")
    for epoch, v in enumerate(SEQUENCE):
        metrics = {monitor: v if monitor == "val/acc" else 1 - v, "train/acc": 0.5}
        jp, pp = jm.save(jstate, epoch, metrics), pm.save(state, epoch, metrics)
        assert (jp and jp.name) == (pp and pp.name)
        if cfg.get("save_last"):
            assert jm.save_last_ckpt(jstate, epoch, metrics).name == pm.save_last_ckpt(
                state, epoch, metrics).name
        assert sorted(p.name for p in jdir.iterdir()) == sorted(p.name for p in pdir.iterdir())
        for p in pdir.iterdir():
            assert (p / "ckpt_meta.json").read_text() == (jdir / p.name /
                                                          "ckpt_meta.json").read_text()
    assert (jm.best_path and jm.best_path.name) == (pm.best_path and pm.best_path.name)
    assert jm.best_value == pm.best_value
    jr = JC.CheckpointManager(jdir, resume=True, **cfg)
    pr = C.CheckpointManager(pdir, resume=True, **cfg)
    assert [(v, p.name) for v, p in jr._saved] == [(v, p.name) for v, p in pr._saved]


def test_latest_checkpoint_matches_jax_and_last_wins_a_tie(tmp_path):
    def meta(name, text):
        (tmp_path / name).mkdir()
        (tmp_path / name / "ckpt_meta.json").write_text(text)

    assert C.latest_checkpoint(tmp_path) is None
    meta("epoch-00-val_acc-0.500", '{"epoch": 0, "val/acc": 0.5}')
    meta("epoch-03-val_acc-0.700", '{"epoch": 3, "val/acc": 0.7}')
    meta("broken", "{not json")
    assert C.latest_checkpoint(tmp_path).name == "epoch-03-val_acc-0.700"
    meta("last", '{"epoch": 3}')
    assert C.latest_checkpoint(tmp_path) == JC.latest_checkpoint(tmp_path) == tmp_path / "last"
    meta("epoch-04-val_acc-0.100", '{"epoch": 4, "val/acc": 0.1}')
    assert C.latest_checkpoint(tmp_path) == JC.latest_checkpoint(tmp_path)
    assert C.latest_checkpoint(tmp_path).name == "epoch-04-val_acc-0.100"


@pytest.mark.parametrize("cfg,values", [
    (dict(patience=2, min_delta=0.01), [0.1, 0.2, 0.205, 0.21, 0.5]),
    (dict(patience=3), [0.5, 0.4, 0.6, 0.6, 0.6, 0.6]),
    (dict(monitor="val/loss", mode="min", patience=1), [1.0, 0.5, 0.6]),
])
def test_early_stopping_matches_jax(cfg, values):
    def stop_epoch(stopper):
        for epoch, v in enumerate(values):
            if stopper.update({cfg.get("monitor", "val/acc"): v}):
                return epoch
        return None

    assert stop_epoch(EarlyStopping(**cfg)) == stop_epoch(JLOOP.EarlyStopping(**cfg))
    assert stop_epoch(EarlyStopping(**cfg)) is not None


def test_resume_is_bit_equal_to_an_uninterrupted_run(root, tmp_path):
    """Dropout 0.1, SpecAugment and Mixup on, Adam: a run stopped after its
    first epoch and resumed by ``auto_resume`` (weights, moments, step, the
    generator's draws) ends where an uninterrupted 2-epoch run ends."""
    kw = dict(DM_KW, batch_size=16, enable_mixup=True, augment={"time_mask": 20, "freq_mask": 8})

    def fit(max_epochs, ckdir, auto_resume=False):
        trainer = Trainer(accelerator="cpu", max_epochs=max_epochs, seed=3,
                          checkpoint_dir=ckdir, auto_resume=auto_resume)
        model = ASTViT(**SMALL, patch_stride=10, overlap=6, dropout=0.1,
                       generator=torch.Generator().manual_seed(0))
        trainer.fit(model, ESC50DataModule(root=str(root), **kw), O.adam(lr=1e-3),
                    O.cosine_annealing(T_max=T_MAX), checkpoint_cfg={"save_last": True})
        return trainer

    whole = fit(2, tmp_path / "a")
    fit(1, tmp_path / "b")
    resumed = fit(2, tmp_path / "b", auto_resume=True)
    assert [h["epoch"] for h in resumed.history] == [1]
    assert resumed.state.step == whole.state.step == 2 * 3
    a, b = whole.state.model.state_dict(), resumed.state.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert resumed.history[0]["train/loss"] == whole.history[1]["train/loss"]


def test_callbacks_and_should_stop(root):
    """``on_validation_epoch_end(trainer, epoch, metrics)`` runs after each
    validated epoch; ``trainer.should_stop`` ends fit after that epoch."""
    seen = []

    class StopAfterFirst:
        def on_validation_epoch_end(self, trainer, epoch, metrics):
            seen.append((epoch, "val/acc" in metrics))
            trainer.should_stop = True

    trainer = Trainer(accelerator="cpu", max_epochs=3, limit_train_batches=1,
                      limit_val_batches=1, enable_checkpointing=False)
    trainer.fit(ASTModel(**SMALL, dtype=torch.float32), ESC50DataModule(root=str(root), **DM_KW),
                O.sgd(lr=LR), callbacks=[StopAfterFirst()])
    assert seen == [(0, True)] and [h["epoch"] for h in trainer.history] == [0]
    assert trainer.ckpt_manager is None and trainer.fit_seconds > 0


def test_load_params_reads_npz_checkpoints_and_params(jax_run, tmp_path):
    model = ASTModel(**SMALL, dtype=torch.float32)
    from_npz = C.load_params(jax_run["npz"], model)
    with np.load(jax_run["npz"]) as z:
        wq = z["blocks_0/attn/qkv/kernel"]
    assert torch.equal(from_npz["blocks.0.attn.qkv.weight"], torch.from_numpy(wq.T.copy()))
    model.load_state_dict(from_npz)
    state = TrainState.create(model, O.adam(lr=1e-3), None, 1, seed=9)
    path = C.CheckpointManager(tmp_path / "ck").save(state, 0, {"val/acc": 0.5})
    params = C.save_params(tmp_path / "params", model, meta={"from": "test"})
    for src in (path, path / C.STATE_FILE, params):
        got = C.load_params(src, ASTModel(**SMALL, dtype=torch.float32))
        assert all(torch.equal(got[k], v) for k, v in from_npz.items())


def test_restore_state_round_trips_step_moments_and_generator(tmp_path):
    model = torch.nn.Linear(3, 2)
    state = TrainState.create(model, O.adam(lr=1e-2), None, 1, seed=1)
    model(torch.ones(4, 3)).sum().backward()
    state.apply_gradients()
    state.step_rng()
    path = C.CheckpointManager(tmp_path).save(state, 0, {"val/acc": 1.0})
    fresh = TrainState.create(torch.nn.Linear(3, 2), O.adam(lr=1e-2), None, 1, seed=2)
    C.restore_state(path, fresh)
    assert fresh.step == 1
    assert torch.equal(fresh.generator.get_state(), state.generator.get_state())
    for a, b in zip(fresh.optimizer.state.values(), state.optimizer.state.values()):
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
    assert int(fresh.step_rng().integers(1 << 30)) == int(state.step_rng().integers(1 << 30))


# ---- devices, the pool, schedules, profiling --------------------------------------

def test_accelerator_auto_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the guard under test cannot trigger")
    for acc in ("auto", "gpu"):
        with pytest.raises(RuntimeError, match="needs a GPU"):
            Trainer(accelerator=acc)
    with pytest.raises(ValueError, match="tpu"):
        resolve_device("tpu")
    assert resolve_device("cpu") == torch.device("cpu")


def _moe_model(n_experts=4):
    from dlsc_tpu_torch.models.ast_moe import ASTMoE

    return ASTMoE(num_classes=C_, emb_dim=32, depth=1, num_heads=2, n_experts=n_experts,
                  dtype=torch.float32)


@pytest.mark.parametrize("make,match", [
    (lambda: Trainer(accelerator="cpu", pipeline_parallel=2, expert_parallel=2),
     "does not compose with expert_parallel"),
    (lambda: Trainer(accelerator="cpu", pipeline_parallel=2, fsdp=True),
     "does not compose with fsdp"),
    (lambda: Trainer(accelerator="gpu", devices=max(torch.cuda.device_count(), 1) + 1),
     "GPU\\(s\\) are visible"),
    (lambda: make_layout(ASTModel(**SMALL, dtype=torch.float32), MeshPlan(),
                         torch.device("cpu"), expert_parallel=2), "requires a MoE model"),
    (lambda: check_batch(8, 2, 3), "must be divisible by data-parallel degree \\(2\\) × "
                                   "pp_microbatches \\(3\\)"),
    (lambda: make_layout(_moe_model(4), MeshPlan(), torch.device("cpu"), expert_parallel=3),
     "n_experts=4 must be divisible by trainer.expert_parallel=3"),
    (lambda: Trainer(accelerator="cpu", devices=2), "one rank per device"),
], ids=["pp+ep", "pp+fsdp", "devices>gpus", "ep-without-moe", "batch%(data*micro)",
        "experts%ep", "devices-without-ranks"])
def test_multi_device_option_errors(make, match):
    """The JAX Trainer's errors (``dlsc_tpu/train/loop.py:221-247``,
    ``:466-474``, ``:584-596``) and the port's own: N devices need N ranks
    of a process group (``scripts/train.py`` starts them)."""
    with pytest.raises(ValueError, match=match):
        make()


def test_device_pool_upload_and_cap(root):
    dm = ESC50DataModule(root=str(root), **DM_KW)
    capped = Trainer(accelerator="cpu", device_data_max_bytes=1000)
    assert capped._device_pool_budget() == (1000, "explicit cap")
    capped._setup_device_data(dm)
    assert capped._use_device_data is False
    auto = Trainer(accelerator="cpu")
    auto._setup_device_data(dm)
    assert auto._use_device_data is True
    parts, _, test_w, _ = dm.pool_parts()
    assert auto._pool_dev.dtype == torch.int16
    np.testing.assert_array_equal(auto._pool_dev.numpy(), np.concatenate(parts))
    np.testing.assert_array_equal(auto._test_pool_dev.numpy(), test_w)
    assert dm.pool_nbytes == auto._pool_dev.numel() * 2 + auto._test_pool_dev.numel() * 2


def test_swa_lr_wrap_matches_jax():
    base = O.lr_schedule(O.adam(lr=1e-3), O.cosine_annealing(T_max=10), 3)
    jbase = JO.lr_schedule(JO.adam(lr=1e-3), JO.cosine_annealing(T_max=10), 3)
    kw = dict(swa_lr=1e-4, start_epoch=4, annealing_epochs=3, steps_per_epoch=3)
    got = O.swa_lr_wrap(base, **kw)
    want, _ = JO.swa_lr_wrap(jbase, None, **kw)
    assert [got(s) for s in range(40)] == pytest.approx([want(s) for s in range(40)], rel=1e-12)


def test_profiling_trace_and_memory_stats(tmp_path):
    with profiling.trace(tmp_path / "prof"):
        torch.ones(8).sum()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}
