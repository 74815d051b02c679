"""The port's Trainer and train CLI on several ranks: a 2-rank FSDP
``Trainer.fit`` against the JAX ``Trainer.fit`` on its 8-device mesh, the
full-state checkpoint it writes read by a 1-rank resume, ``export`` and
``predict``, the Trainer's option errors that need ranks, and
``scripts.train trainer.devices=2``, which starts its ranks itself.

The ranks are gloo processes over the CPU (``parallel.mesh.spawn``, the
rank functions in ``tests/dist_workers.py``). A tiny AST (emb 64, depth 2,
heads 2, f32, dropout 0) on tiny synthetic shards (4 classes, 16 000-sample
clips), starting from the JAX init carried as an ``.npz``, as
``tests/test_torch_trainer.py`` does. Tolerances: the history's accuracies
exactly (counts of the same argmaxes), its losses within 1e-3 relative
(f32; the port pads the tokens and sums the ranks' shares in another
order); a checkpoint read back bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlsc_tpu.data import ESC50DataModule as JaxDataModule
from dlsc_tpu.models.ast import ASTModel as JaxASTModel
from dlsc_tpu.train import losses as JL
from dlsc_tpu.train import loop as JLOOP
from dlsc_tpu.train import optim as JO
from dlsc_tpu_torch.data.synthetic import make_synthetic_dataset
from dlsc_tpu_torch.models.ast import ASTModel
from dlsc_tpu_torch.parallel import spawn
from dlsc_tpu_torch.scripts import export, predict
from dlsc_tpu_torch.scripts import train as train_cli
from dlsc_tpu_torch.train import checkpoint as C
from dlsc_tpu_torch.train import optim as O
from dlsc_tpu_torch.train.loop import Trainer
from dlsc_tpu_torch.train.state import TrainState
from tests import dist_workers as dw
from tests.test_torch_cli import _wavs

C_ = 4
CLIP = 16_000
SMALL = dict(num_classes=C_, emb_dim=64, depth=2, num_heads=2)
DM_KW = dict(num_classes=C_, fold=0, val_split=0.2, batch_size=8, preprocessing_mode="ast",
             is_spectrogram=True, preprocessing_config={"n_mels": 128})
LR, EPOCHS, LIMIT = 0.1, 2, 2
CKPT = {"monitor": "val/acc", "mode": "max", "save_top_k": 1}
TINY = ["+model.emb_dim=64", "+model.depth=2", "+model.num_heads=2"]


def _flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tmp_path_factory.mktemp("dist_shards")
    make_synthetic_dataset(r, num_classes=C_, clips_per_class_per_fold=4, clip_samples=CLIP,
                           seed=0)
    return r


@pytest.fixture(scope="module")
def jax_fit(root, tmp_path_factory):
    """The JAX reference: its init (an .npz) and a fit on the 8-device mesh."""
    tmp = tmp_path_factory.mktemp("jax_fit")
    jmodel = JaxASTModel(**SMALL, dtype=jnp.float32, remat=False)
    jdm = JaxDataModule(root=str(root), **DM_KW)
    optim, sched = JO.sgd(lr=LR), JO.cosine_annealing(T_max=4)
    init = JLOOP.Trainer(seed=0, devices=1).init_state(jmodel, jdm, optim, sched)
    npz = tmp / "init.npz"
    np.savez(npz, **_flat(init.params))
    trainer = JLOOP.Trainer(max_epochs=EPOCHS, limit_train_batches=LIMIT,
                            gradient_clip_val=None, enable_progress_bar=False,
                            checkpoint_dir=tmp / "ck", seed=0, devices=8)
    assert trainer.plan.n_data == 8
    trainer.fit(jmodel, jdm, optim, sched, criterion=JL.CrossEntropyLoss(),
                checkpoint_cfg=dict(CKPT))
    return dict(npz=npz, history=trainer.history)


@pytest.fixture(scope="module")
def port_fit(root, jax_fit, tmp_path_factory):
    """One spawn of 2 ranks: the FSDP fit, then the option errors."""
    tmp = tmp_path_factory.mktemp("port_fit")
    base = dict(root=str(root), model_kw=SMALL, dm=DM_KW)
    specs = [dict(base, fn="fit", npz=str(jax_fit["npz"]), lr=LR, ckpt=CKPT,
                  trainer=dict(devices=2, fsdp=True, max_epochs=EPOCHS,
                               limit_train_batches=LIMIT, checkpoint_dir=str(tmp / "ck"))),
             dict(base, fn="option_error", trainer=dict(devices=2, expert_parallel=2)),
             dict(base, fn="option_error", trainer=dict(devices=2, pipeline_parallel=2,
                                                        pp_microbatches=3))]
    return spawn(dw.run_all, 2, specs, timeout_s=600)[0]


def test_fsdp_fit_matches_jax_mesh_fit(port_fit, jax_fit):
    """2 FSDP ranks, 2 epochs x 2 batches of 8, the pool on the device:
    the history of the JAX fit with its batch on 8 devices."""
    got, want = port_fit[0]["history"], jax_fit["history"]
    assert port_fit[0]["layout"] == "FullyShardedDP"
    assert [h["epoch"] for h in got] == [h["epoch"] for h in want] == list(range(EPOCHS))
    for g, w in zip(got, want):
        for k in ("train/acc", "val/acc"):
            assert g[k] == w[k], (g["epoch"], k)
        for k in ("train/loss", "val/loss", "lr"):
            assert g[k] == pytest.approx(w[k], rel=1e-3), (g["epoch"], k)
    assert got[-1]["train/loss"] != got[0]["train/loss"]


def test_fsdp_checkpoint_loads_into_one_rank(port_fit, root, tmp_path, monkeypatch):
    """The 2-rank checkpoint is the one-process format: a 1-rank state
    restores it bit for bit, and ``export`` and ``predict`` read it."""
    best = port_fit[0]["best"]
    model = ASTModel(**SMALL, dtype=torch.float32)
    state = TrainState.create(model, O.sgd(lr=LR), O.cosine_annealing(T_max=4), 1)
    C.restore_state(best, state)
    ck = torch.load(f"{best}/{C.STATE_FILE}", weights_only=True)
    assert set(ck["model"]) == set(model.state_dict())
    assert len(ck["optimizer"]["param_groups"][0]["params"]) == len(list(model.parameters()))
    for k, v in model.state_dict().items():
        assert torch.equal(v, ck["model"][k]), k
    monkeypatch.setenv("DLSC_TRACKING_DIR", str(tmp_path / "runs"))
    monkeypatch.chdir(tmp_path)
    common = ["trainer.accelerator=cpu", f"dataset.root={root}", f"dataset.num_classes={C_}",
              *TINY]
    art = export.main(["model=ast", f"dataset.num_classes={C_}", *TINY, f"+ckpt_path={best}",
                       f"+out={tmp_path / 'art'}", "+dtype=float32", "+batch=2",
                       f"+clip_samples={CLIP}"])
    files = "+files=[" + ",".join(_wavs(tmp_path)) + "]"
    by_ckpt = predict.main(["model=ast", *common, f"+ckpt_path={best}", files, "+top_k=2"])
    by_art = predict.main(["trainer.accelerator=cpu", f"+artifact={art}", files, "+top_k=2"])
    assert len(by_ckpt) == len(by_art) == 3
    for a, b in zip(by_ckpt, by_art):
        assert [c for c, _ in a["top_k"]] == [c for c, _ in b["top_k"]]


def test_one_rank_resume_of_a_two_rank_run(port_fit, root, tmp_path):
    """A 1-rank Trainer resumes the 2-rank run's best checkpoint (its step
    count, weights, moments and generator) and trains on: the epoch counts
    whole epochs of the datamodule, so with ``limit_train_batches`` the
    resumed run starts at epoch 0 again, from step 2."""
    trainer = Trainer(accelerator="cpu", seed=0, max_epochs=EPOCHS + 1,
                      limit_train_batches=LIMIT, checkpoint_dir=tmp_path / "ck")
    from dlsc_tpu_torch.data.datamodule import ESC50DataModule
    from dlsc_tpu_torch.train import losses as L

    trainer.fit(ASTModel(**SMALL, dtype=torch.float32), ESC50DataModule(root=str(root), **DM_KW),
                O.sgd(lr=LR), O.cosine_annealing(T_max=4), criterion=L.CrossEntropyLoss(),
                checkpoint_cfg=dict(CKPT), ckpt_path=port_fit[0]["best"])
    assert trainer.state.step == LIMIT + (EPOCHS + 1) * LIMIT


def test_option_errors_on_ranks(port_fit):
    """At 2 ranks: expert parallelism on a model without MoE, and a batch
    of 8 that 1 data shard x 3 microbatches do not divide."""
    assert "MoE" in port_fit[1]
    assert "batch_size=8 must be divisible by data-parallel degree (1)" in port_fit[2]


def test_train_cli_starts_its_ranks(root, tmp_path, monkeypatch):
    """``scripts.train trainer.accelerator=cpu trainer.devices=2
    +trainer.fsdp=true``: the script spawns its 2 ranks, rank 0 reports."""
    monkeypatch.setenv("DLSC_TRACKING_DIR", str(tmp_path / "runs"))
    monkeypatch.chdir(tmp_path)
    res = train_cli.main(["model=ast", "trainer.accelerator=cpu", "trainer.devices=2",
                          "+trainer.fsdp=true", f"dataset.root={root}",
                          f"dataset.num_classes={C_}", *TINY, "batch_size=8",
                          "trainer.max_epochs=1", "+trainer.limit_train_batches=2",
                          f"hydra.run.dir={tmp_path / 'run'}"])
    assert res["confmat"].sum() > 0 and 0.0 <= res["test/acc"] <= 1.0
    assert list((tmp_path / "run" / "checkpoints").glob(f"*/{C.STATE_FILE}"))
