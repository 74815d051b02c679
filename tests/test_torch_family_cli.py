"""The port's CLIs for EnvNet-v2 and the spectrogram CNN on the CPU: train
(EnvNet-v2 with BC mixing, KLDiv, three test crops and SWA from the second
epoch, so that the BatchNorm refresh runs in the CLI), evaluate on the best
checkpoint, export from it, and predict by checkpoint and by artifact.

Tiny synthetic shards (4 classes, 16 000-sample clips); EnvNet-v2 on a
0.7-s window (30 869 samples, ~30 000 is the least its trunk takes), the
CNN on 224² images of the 16 000-sample clips. Tolerances, each with its
reason: evaluate against the train run's own test, the same confusion
matrix and a loss within 1e-6 relative (the same weights and ops; the pool
against host batches); predict's checkpoint mode against the artifact of the
same checkpoint, the same top-k classes and probabilities within 1e-6 (the
same f32 weights and ops, batched differently).
"""

import numpy as np
import pytest

from dlsc_tpu_torch.data import wav as W
from dlsc_tpu_torch.data.synthetic import make_synthetic_dataset
from dlsc_tpu_torch.scripts import evaluate, export, predict
from dlsc_tpu_torch.scripts import train as train_cli

C_ = 4
CLIP = 16_000
ENVNET = ["model=envnet_v2", "+model.dataset_overrides.preprocessing_config.window_length=0.7",
          "+model.input_samples=30869", "loss._target_=torch.nn.KLDivLoss"]
MODELS = {
    "envnet_v2": (ENVNET, ["+model.dataset_overrides.preprocessing_config.multi_crop_test=true",
                           "+model.dataset_overrides.preprocessing_config.test_crops=3"]),
    "cnn_esc50": (["model=cnn_esc50"], []),
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tmp_path_factory.mktemp("family_shards")
    make_synthetic_dataset(r, num_classes=C_, clips_per_class_per_fold=2, clip_samples=CLIP,
                           seed=3)
    return r


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("DLSC_TRACKING_DIR", str(tmp_path / "runs"))
    monkeypatch.chdir(tmp_path)


def _common(root, run_dir, *extra):
    return ["trainer.accelerator=cpu", f"dataset.root={root}", f"dataset.num_classes={C_}",
            "batch_size=8", "+trainer.limit_val_batches=1", f"hydra.run.dir={run_dir}", *extra]


def best_epoch(trainer) -> int:
    return int(trainer.ckpt_manager.best_path.name.split("-")[1])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_train_evaluate_export_predict(root, tmp_path, name):
    model, test_crops = MODELS[name]
    swa = ["+swa.enabled=true", "+swa.swa_epoch_start=1"] if name == "envnet_v2" else []
    res = train_cli.main([*model, *test_crops, *_common(
        root, tmp_path / "run", "trainer.max_epochs=2", "+trainer.limit_train_batches=2",
        *swa)])
    trainer = res["trainer"]
    for k in ("test/acc", "test/f1", "test/auroc"):
        assert 0.0 <= res[k] <= 1.0, k
    assert np.isfinite(res["test/loss"]) and res["confmat"].sum() == 2 * C_
    assert [h["epoch"] for h in trainer.history] == [0, 1]
    # the test loaded the best checkpoint: 2 train steps an epoch up to its epoch
    tracked = {b.item() for k, b in trainer.state.model.state_dict().items()
               if k.endswith("num_batches_tracked")}
    assert tracked == {2 * (int(best_epoch(trainer)) + 1)}

    best = trainer.ckpt_manager.best_path
    ev = evaluate.main([*model, *test_crops, *_common(root, tmp_path / "ev",
                                                      f"+ckpt_path={best}",
                                                      "+trainer.device_data=false")])
    np.testing.assert_array_equal(ev["confmat"], res["confmat"])
    assert ev["test/loss"] == pytest.approx(res["test/loss"], rel=1e-6)

    rng = np.random.default_rng(5)
    files = []
    for i, seconds in enumerate((0.36, 0.9)):
        p = tmp_path / f"clip{i}.wav"
        W.write_wav(p, (rng.standard_normal(int(seconds * 44_100)) * 0.3).astype(np.float32),
                    44_100)
        files.append(str(p))
    files_arg = "+files=[" + ",".join(files) + "]"
    by_ckpt = predict.main([*model, *test_crops, *_common(root, tmp_path / "p",
                                                          f"+ckpt_path={best}", files_arg,
                                                          "+top_k=3")])
    art = export.main([*model, *test_crops, f"dataset.num_classes={C_}", f"+ckpt_path={best}",
                       f"+out={tmp_path / 'art'}", "+dtype=float32", "+batch=2",
                       f"+clip_samples={CLIP}"])
    by_art = predict.main(["trainer.accelerator=cpu", f"+artifact={art}", files_arg, "+top_k=3"])
    assert len(by_ckpt) == len(by_art) == 2
    for a, b in zip(by_ckpt, by_art):
        assert [c for c, _ in a["top_k"]] == [c for c, _ in b["top_k"]]
        np.testing.assert_allclose([p for _, p in a["top_k"]], [p for _, p in b["top_k"]],
                                   rtol=1e-6)


def test_export_checks_the_window(tmp_path):
    """EnvNet-v2 is sized for one window: an artifact whose pipeline gives
    another length fails at export, not at the first request."""
    with pytest.raises(ValueError, match="input_samples"):
        export.main(["model=envnet_v2", "+model.input_samples=30000", f"dataset.num_classes={C_}",
                     f"+out={tmp_path / 'art'}", "+dtype=float32", f"+clip_samples={CLIP}",
                     "+model.dataset_overrides.preprocessing_config.window_length=0.7"])
