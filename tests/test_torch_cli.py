"""The port's training entry point end to end on the CPU: the train, evaluate,
predict and export CLIs at tiny sizes, the predict helpers and the artifact
mode against the JAX ``scripts/predict.py``, and the ``_target_`` table.

Every CLI run passes ``trainer.accelerator=cpu`` and tiny overrides (emb
64, depth 2, heads 2, f32, 16 000-sample clips, a batch or two). Tolerances, each
with its reason:

- evaluate on the best checkpoint against the train run's own test: the
  same confusion matrix and a loss within 1e-6 relative (the same weights,
  data and ops in the same order: only the route differs, the device pool
  against host batches);
- predict's checkpoint mode against the artifact of the same checkpoint:
  top-k classes equal, probabilities within 1e-6 (the same f32 weights and
  ops, batched differently);
- the port's ``predict +artifact`` against the JAX ``predict_from_artifact``
  on artifacts of the same params: top-k classes equal, probabilities within
  1e-4 (f32 both sides; token padding changes the summation order only);
- the window helpers: exact.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlsc_tpu.native
import dlsc_tpu_torch.native
import scripts.predict as jax_predict
from dlsc_tpu.data.pipeline import DevicePipeline as JaxPipeline
from dlsc_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
from dlsc_tpu.models.ast import ASTModel as JaxASTModel
from dlsc_tpu.serving import export_model as jax_export_model
from dlsc_tpu_torch.config import resolve_target
from dlsc_tpu_torch.data import wav as W
from dlsc_tpu_torch.data.synthetic import make_synthetic_dataset
from dlsc_tpu_torch.models.moe import MOE_METRICS
from dlsc_tpu_torch.scripts import evaluate, export, predict
from dlsc_tpu_torch.scripts import train as train_cli

C_ = 4
CLIP = 16_000
TINY = ["+model.emb_dim=64", "+model.depth=2", "+model.num_heads=2"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tmp_path_factory.mktemp("cli_shards")
    make_synthetic_dataset(r, num_classes=C_, clips_per_class_per_fold=2, clip_samples=CLIP,
                           seed=1)
    return r


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("DLSC_TRACKING_DIR", str(tmp_path / "runs"))
    monkeypatch.chdir(tmp_path)


def _common(root, run_dir, *extra):
    return ["trainer.accelerator=cpu", f"dataset.root={root}", f"dataset.num_classes={C_}",
            *TINY, "batch_size=8", "+trainer.limit_val_batches=1", f"hydra.run.dir={run_dir}",
            *extra]


def _finite_results(res: dict) -> None:
    for k in ("test/acc", "test/f1", "test/auroc", "test/loss"):
        assert math.isfinite(res[k]), k
    for k in ("test/acc", "test/f1", "test/auroc"):
        assert 0.0 <= res[k] <= 1.0, k
    assert res["confmat"].shape == (C_, C_) and res["confmat"].sum() == 2 * C_


@pytest.mark.parametrize("model", [["model=ast"], ["model=ast_small", "+model.ln_fused=true"],
                                   ["model=ast_mini"], ["model=ast_moe"]],
                         ids=["ast", "ast_small-ln_fused", "ast_mini", "ast_moe"])
def test_train_cli_each_model(root, tmp_path, model):
    res = train_cli.main([*model, *_common(root, tmp_path / "run", "trainer.max_epochs=1",
                                           "+trainer.limit_train_batches=1",
                                           f"+trainer.profile_dir={tmp_path / 'prof'}")])
    _finite_results(res)
    trainer = res["trainer"]
    assert trainer.ckpt_manager.best_path.exists()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert (trainer.state.step, len(trainer.history)) == (1, 1)
    if model[0] == "model=ast_moe":
        assert set(MOE_METRICS) <= set(trainer.logged_metrics)


@pytest.fixture(scope="module")
def trained(root, tmp_path_factory):
    """One AST run of 2 epochs with ``last`` kept: (results, run dir)."""
    run = tmp_path_factory.mktemp("trained")
    res = train_cli.main(["model=ast", *_common(root, run / "run", "trainer.max_epochs=2",
                                                 "+checkpoint.save_last=true")])
    return res, run


def test_evaluate_checkpoint_matches_the_train_runs_test(root, trained, tmp_path):
    res, _ = trained
    best = res["trainer"].ckpt_manager.best_path
    got = evaluate.main(["model=ast", *_common(root, tmp_path / "ev", f"+ckpt_path={best}",
                                               "+trainer.device_data=false")])
    np.testing.assert_array_equal(got["confmat"], res["confmat"])
    assert got["test/loss"] == pytest.approx(res["test/loss"], rel=1e-6)
    with pytest.raises(SystemExit, match="ckpt_path"):
        evaluate.main(["model=ast", *_common(root, tmp_path / "ev")])


def test_resume_from_last_continues_the_run(root, trained):
    _, run = trained
    again = train_cli.main(["model=ast", *_common(root, run / "run", "trainer.max_epochs=3",
                                                   "+checkpoint.save_last=true",
                                                   "+trainer.auto_resume=true")])
    assert [h["epoch"] for h in again["trainer"].history] == [2]
    last = run / "run" / "checkpoints" / "last"
    assert json.loads((last / "ckpt_meta.json").read_text())["epoch"] == 2
    # 3 epochs of 28 // 8 = 3 steps; the trained run's test loaded its best
    # checkpoint into its state, so its own step is not the end of its fit
    assert torch.load(last / "state.pt", weights_only=True)["step"] == 9


def test_evaluate_cv_writes_the_jax_report_keys(root, tmp_path):
    report = evaluate.main(["--cv", "model=ast", *_common(root, tmp_path / "cv",
                                                          "trainer.max_epochs=1",
                                                          "+trainer.limit_train_batches=1")])
    on_disk = json.loads((tmp_path / "outputs" / "cv_report.json").read_text())
    assert set(report) == set(on_disk) == {"per_fold", "mean_acc", "std_acc", "n_folds"}
    assert report["n_folds"] == 5 and sorted(on_disk["per_fold"]) == list("01234")
    accs = [f["test/acc"] for f in report["per_fold"].values()]
    assert report["mean_acc"] == pytest.approx(np.mean(accs))


def _wavs(tmp_path, seconds=(1.0, 2.4, 0.3)) -> list[str]:
    rng = np.random.default_rng(4)
    paths = []
    for i, s in enumerate(seconds):
        sr = 22_050 if i == 1 else 44_100
        ch = 2 if i == 2 else 1
        p = tmp_path / f"clip{i}.wav"
        W.write_wav(p, (rng.standard_normal((ch, int(s * sr))) * 0.3).astype(np.float32), sr)
        paths.append(str(p))
    return paths


def test_predict_checkpoint_and_artifact_modes_agree(root, trained, tmp_path):
    res, _ = trained
    best = res["trainer"].ckpt_manager.best_path
    files = "+files=[" + ",".join(_wavs(tmp_path)) + "]"
    by_ckpt = predict.main(["model=ast", *_common(root, tmp_path / "p", f"+ckpt_path={best}",
                                                  files, "+top_k=3")])
    art = export.main(["model=ast", f"dataset.num_classes={C_}", *TINY, f"+ckpt_path={best}",
                       f"+out={tmp_path / 'art'}", "+dtype=float32", "+batch=2",
                       f"+clip_samples={CLIP}"])
    by_art = predict.main(["trainer.accelerator=cpu", f"+artifact={art}", files, "+top_k=3"])
    assert len(by_ckpt) == len(by_art) == 3
    for a, b in zip(by_ckpt, by_art):
        assert [c for c, _ in a["top_k"]] == [c for c, _ in b["top_k"]]
        np.testing.assert_allclose([p for _, p in a["top_k"]], [p for _, p in b["top_k"]],
                                   rtol=1e-6)
    with pytest.raises(SystemExit, match="long_audio"):
        predict.main(["trainer.accelerator=cpu", f"+artifact={art}", files,
                      "+long_audio=mean"])


@pytest.mark.parametrize("n,clip,mode", [(100, 100, "avg"), (50, 100, "avg"), (250, 100, "avg"),
                                         (250, 100, "truncate"), (301, 100, "avg"),
                                         (1000, 7, "avg")])
def test_windows_equal_jax(n, clip, mode):
    x = np.arange(n, dtype=np.float32)
    got, want = predict._windows(x, clip, mode), jax_predict._windows(x, clip, mode)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_file_windows_and_average_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(dlsc_tpu.native, "available", lambda: False)
    monkeypatch.setattr(dlsc_tpu_torch.native, "available", lambda: False)
    files = _wavs(tmp_path)
    got, counts = predict._file_windows(files, 44_100, 44_100, "avg")
    want, jcounts = jax_predict._file_windows(files, 44_100, 44_100, "avg")
    np.testing.assert_array_equal(got, want)
    assert counts == jcounts == [1, 4, 1]
    probs = np.random.default_rng(0).uniform(size=(sum(counts), C_))
    np.testing.assert_array_equal(predict._avg_by_file(probs, counts),
                                  jax_predict._avg_by_file(probs, jcounts))


def test_predict_artifact_matches_jax(tmp_path, monkeypatch):
    """Artifacts of the same f32 params: the JAX one through the JAX
    ``predict_from_artifact``, the port's (exported by its CLI from an
    ``.npz`` of those params) through ``predict +artifact``."""
    monkeypatch.setattr(dlsc_tpu.native, "available", lambda: False)
    monkeypatch.setattr(dlsc_tpu_torch.native, "available", lambda: False)
    small = dict(num_classes=C_, emb_dim=64, depth=2, num_heads=2)
    jpipe = JaxPipeline(JaxPipelineConfig(mode="ast", num_classes=C_))
    jmodel = JaxASTModel(**small, dtype=jnp.float32, remat=False)
    feats, _ = jpipe.eval_batch(jnp.zeros((2, CLIP)), jnp.zeros((2,), jnp.int32))
    variables = jmodel.init({"params": jax.random.key(2)}, feats, train=False)
    jart = jax_export_model(jmodel, jpipe, variables, tmp_path / "jart", batch=2,
                            clip_samples=CLIP)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(variables["params"])}
    np.savez(tmp_path / "params.npz", **flat)
    art = export.main(["model=ast", f"dataset.num_classes={C_}", *TINY,
                       f"+params_npz={tmp_path / 'params.npz'}", f"+out={tmp_path / 'art'}",
                       "+dtype=float32", "+batch=2", f"+clip_samples={CLIP}"])
    files = _wavs(tmp_path)
    want = jax_predict.predict_from_artifact(str(jart), files, 3)
    got = predict.main(["trainer.accelerator=cpu", f"+artifact={art}",
                        "+files=[" + ",".join(files) + "]", "+top_k=3"])
    for g, w in zip(got, want, strict=True):
        assert [c for c, _ in g["top_k"]] == [c for c, _ in w["top_k"]]
        np.testing.assert_allclose([p for _, p in g["top_k"]], [p for _, p in w["top_k"]],
                                   atol=1e-4)


# ---- the _target_ table ------------------------------------------------------------

@pytest.mark.parametrize("target,name", [
    ("src.models.ast.ASTModel", "dlsc_tpu_torch.models.ast.ASTModel"),
    ("dlsc_tpu.models.ast_moe.ASTMoE", "dlsc_tpu_torch.models.ast_moe.ASTMoE"),
    ("src.models.ast_mini.ASTMiniViT", "dlsc_tpu_torch.models.ast_mini.ASTMiniViT"),
    ("dlsc_tpu.data.us8k.US8KDataModule", "dlsc_tpu_torch.data.datamodule.US8KDataModule"),
    ("torch.optim.Adam", "dlsc_tpu_torch.train.optim.adam"),
    ("torch.nn.KLDivLoss", "dlsc_tpu_torch.train.losses.KLDivLoss"),
])
def test_targets_resolve_into_the_port(target, name):
    obj = resolve_target(target)
    assert f"{obj.__module__}.{obj.__qualname__}" == name


@pytest.mark.parametrize("target,item", [
    ("dlsc_tpu.train.loop.Trainer", "JAX package"),
])
def test_targets_the_port_lacks_raise(target, item):
    with pytest.raises(NotImplementedError, match=item):
        resolve_target(target)


def test_unported_model_stops_the_clis(root, tmp_path):
    """Every model family is ported: a ``_target_`` the port lacks (here a
    name only the JAX package has) stops the train and export CLIs."""
    assert export.parse_cli is train_cli.parse_cli
    lacking = "model._target_=dlsc_tpu.models.envnet_v2.EnvNetV3"
    with pytest.raises(NotImplementedError, match="JAX package"):
        train_cli.main(["model=envnet_v2", lacking, *_common(root, tmp_path / "r")])
    with pytest.raises(SystemExit, match="envnet_v2, cnn_esc50 and leaf"):
        export.main(["model=leaf", lacking, f"+out={tmp_path / 'a'}"])
