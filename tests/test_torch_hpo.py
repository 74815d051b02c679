"""The port's HPO layer against the JAX package's, on the CPU.

- The TPE sampler, the Hyperband pruner and the SQLite study: the AST-MoE
  + training + loss search spaces of ``configs/optimization``, a
  deterministic objective reporting four steps, 20 trials (10 random
  startup trials, then TPE) with the same seed in both packages: identical
  params, states, values and intermediate values, trial by trial (exact:
  the same numpy draws in the same order).
- Each package's ``StudyManager`` loads the other's db.
- ``HPORunner`` end to end: a tiny AST-MoE, 2 trials of 1 epoch x 2
  batches on the CPU, a token-choice and an expert-choice trial; the best
  config written.
- The three CLIs on a temp tree: ``optimize_hyperparams`` and
  ``debug_optimize`` with ``model=ast_moe``, ``analyze_study`` (its summary
  JSON and CSV for one db equal the JAX script's), ``optuna.vmapped``
  running two lockstep trials (``debug_optimize`` ignoring the flag, as the
  JAX script does); the six HPO ``_target_`` names resolving into the port.
"""

import json
import math
import sys

import pytest
import yaml

import scripts.analyze_study as jax_analyze
from dlsc_tpu.config import compose as jax_compose
from dlsc_tpu.hpo import HyperparameterSpace as JaxSpace
from dlsc_tpu.hpo import StudyManager as JaxStudyManager
from dlsc_tpu.hpo import TrialPruned as JaxTrialPruned
from dlsc_tpu_torch import hpo
from dlsc_tpu_torch.config import compose, resolve_target
from dlsc_tpu_torch.data.synthetic import make_synthetic_dataset
from dlsc_tpu_torch.hpo.runner import HPORunner
from dlsc_tpu_torch.scripts import analyze_study, debug_optimize, optimize_hyperparams
from dlsc_tpu_torch.scripts.optimize_hyperparams import SPACES_DIR
from dlsc_tpu_torch.scripts.train import CONFIG_DIR

N_TRIALS = 20
TINY = ["+model.emb_dim=32", "+model.depth=2", "+model.num_heads=2"]


def _objective(trial_pruned):
    """A deterministic objective of the AST-MoE study's params, reporting
    four steps and pruning where the pruner says so."""

    def objective(trial, space):
        p = space.suggest_parameters(trial)
        base = (-abs(math.log10(p["optimizer.lr"]) + 4.5) - p["loss.label_smoothing"]
                + 0.1 * (p["model.router"] == "expert") + 0.01 * p["model.n_experts"]
                + 0.02 * p["model.top_k"] - 0.05 * abs(p["model.capacity_factor"] - 1.3)
                + 1e-4 * p["batch_size"] + 1e-3 * p["scheduler.T_max"] / 250)
        for step in range(4):
            trial.report(base * (step + 1) / 4, step)
            if trial.should_prune():
                raise trial_pruned()
        return base
    return objective


def _optuna_cfg(cfg, db) -> dict:
    oc = cfg.optuna.to_dict()
    oc.update(study_name="moe_tpe", storage_path=f"sqlite:///{db}")
    oc["sampler"]["seed"] = 3
    oc["pruner"]["max_resource"] = 4
    return oc


@pytest.fixture(scope="module")
def studies(tmp_path_factory):
    """The same 20-trial AST-MoE study run by each package: (port study, JAX
    study, port db, JAX db)."""
    d = tmp_path_factory.mktemp("tpe")
    cfg = compose(str(CONFIG_DIR), "optimization", ["model=ast_moe"])
    jcfg = jax_compose(str(CONFIG_DIR), "optimization", ["model=ast_moe"])
    space = hpo.HyperparameterSpace.from_model_config(cfg, SPACES_DIR)
    jspace = JaxSpace.from_model_config(jcfg, SPACES_DIR)
    assert space.space == jspace.space and "model.router" in space.space
    # the optuna block's _target_ sampler and pruner, through each package's table
    study = hpo.StudyManager.from_config(_optuna_cfg(cfg, d / "port.db")).create_study()
    jstudy = JaxStudyManager.from_config(_optuna_cfg(jcfg, d / "jax.db")).create_study()
    assert type(study.sampler) is hpo.TPESampler and type(study.pruner) is hpo.HyperbandPruner
    study.optimize(lambda t: _objective(hpo.TrialPruned)(t, space), n_trials=N_TRIALS)
    jstudy.optimize(lambda t: _objective(JaxTrialPruned)(t, jspace), n_trials=N_TRIALS)
    return study, jstudy, d / "port.db", d / "jax.db"


def _record(t) -> tuple:
    return (t.number, t.state, t.value, t.params, t.distributions, t.intermediate_values,
            t.user_attrs)


def test_tpe_and_hyperband_match_jax_trial_by_trial(studies):
    study, jstudy, _, _ = studies
    assert len(study.trials) == len(jstudy.trials) == N_TRIALS
    for t, jt in zip(study.trials, jstudy.trials):
        assert _record(t) == _record(jt), t.number
    states = {t.state for t in study.trials}
    assert hpo.TrialState.PRUNED in states and hpo.TrialState.COMPLETE in states
    assert {t.params["model.router"] for t in study.trials} == {"token", "expert"}
    assert study.best_params == jstudy.best_params


def test_each_package_loads_the_others_db(studies):
    study, jstudy, db, jdb = studies
    port_reads_jax = hpo.StudyManager("moe_tpe", f"sqlite:///{jdb}").load_study()
    jax_reads_port = JaxStudyManager("moe_tpe", f"sqlite:///{db}").load_study()
    assert [_record(t) for t in port_reads_jax.trials] == [_record(t) for t in jstudy.trials]
    assert [_record(t) for t in jax_reads_port.trials] == [_record(t) for t in study.trials]
    assert port_reads_jax.summary() == jstudy.summary()
    assert hpo.StudyManager("x", f"sqlite:///{jdb}").list_studies() == \
        JaxStudyManager("x", f"sqlite:///{jdb}").list_studies()


def test_analyze_study_writes_the_jax_scripts_summary(studies, tmp_path, monkeypatch, capsys):
    """One db through both scripts: the same summary JSON (fANOVA included)
    and CSV; the port's five HTML reports; without matplotlib the port
    says that it skipped the plots."""
    _, _, db, _ = studies
    args = ["moe_tpe", "--storage", f"sqlite:///{db}", "--csv", "--no-plots"]
    jax_analyze.main([*args, "--out", str(tmp_path / "jax")])
    analyze_study.main([*args, "--out", str(tmp_path / "port"), "--html"])
    for name in ("moe_tpe_summary.json", "moe_tpe_trials.csv"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    summary = json.loads((tmp_path / "port" / "moe_tpe_summary.json").read_text())
    assert summary["n_trials"] == N_TRIALS and summary["importances_fanova"]
    assert len(list((tmp_path / "port").glob("*.html"))) == 5
    monkeypatch.setitem(sys.modules, "matplotlib", None)   # as on the card's machine
    capsys.readouterr()
    analyze_study.main(["moe_tpe", "--storage", str(db), "--out", str(tmp_path / "np")])
    assert "plots skipped: matplotlib is not installed" in capsys.readouterr().out
    assert not list((tmp_path / "np").glob("*.png"))
    analyze_study.main(["--list", "--storage", f"sqlite:///{db}"])
    assert f"moe_tpe: {N_TRIALS} trials" in capsys.readouterr().out


@pytest.mark.parametrize("target,name", [
    ("optuna.samplers.TPESampler", "tpe.TPESampler"),
    ("optuna.pruners.HyperbandPruner", "hyperband.HyperbandPruner"),
    ("optuna.pruners.MedianPruner", "pruners.MedianPruner"),
    ("dlsc_tpu.hpo.tpe.TPESampler", "tpe.TPESampler"),
    ("dlsc_tpu.hpo.hyperband.HyperbandPruner", "hyperband.HyperbandPruner"),
    ("dlsc_tpu.hpo.pruners.MedianPruner", "pruners.MedianPruner"),
])
def test_hpo_targets_resolve_into_the_port(target, name):
    obj = resolve_target(target)
    assert f"{obj.__module__}.{obj.__qualname__}" == f"dlsc_tpu_torch.hpo.{name}"


# ---- trials trained by the port's Trainer -----------------------------------------

@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("hpo_shards")
    make_synthetic_dataset(root, num_classes=4, clips_per_class_per_fold=2,
                           clip_samples=16_000, seed=2)
    return root


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("DLSC_TRACKING_DIR", str(tmp_path / "runs"))
    monkeypatch.chdir(tmp_path)


def _tiny(shards, tmp_path, *extra) -> list[str]:
    return ["model=ast_moe", "trainer.accelerator=cpu", f"dataset.root={shards}",
            "dataset.num_classes=4", *TINY, "batch_size=4", "trainer.max_epochs=1",
            "+trainer.limit_train_batches=2", "+trainer.limit_val_batches=1",
            f"optuna.storage_path=sqlite:///{tmp_path / 'study.db'}",
            f"optuna.output_dir={tmp_path / 'out'}", *extra]


def test_hpo_runner_trains_a_token_and_an_expert_trial(shards, tmp_path):
    cfg = compose(str(CONFIG_DIR), "optimization", _tiny(shards, tmp_path))
    space = hpo.HyperparameterSpace.from_nested({
        "model": {"router": {"type": "categorical", "choices": ["token", "expert"]}},
        "optimizer": {"lr": {"type": "float", "low": 1e-4, "high": 1e-2, "log": True}}})
    study = hpo.Study("runner", tmp_path / "runner.db", sampler=hpo.TPESampler(seed=1),
                      pruner=hpo.NopPruner())
    runner = HPORunner(study, cfg, space, min_epochs=0, n_trials=2, output_dir=tmp_path / "o")
    seen = []
    runner.optimize(callbacks=[lambda s, t: seen.append(t.number)])
    assert seen == [0, 1]
    assert [t.state for t in study.trials] == [hpo.TrialState.COMPLETE] * 2
    assert {t.params["model.router"] for t in study.trials} == {"token", "expert"}
    for t in study.trials:
        assert 0.0 <= t.value <= 1.0 and t.intermediate_values == {0: t.value}
        assert t.user_attrs["fit_seconds"] > 0 and 0.0 <= t.user_attrs["test_acc"] <= 1.0
    best = yaml.safe_load(runner.save_best_config().read_text())
    assert best["best_trial"] == study.best_trial.number
    assert best["config"]["model"]["router"] == study.best_params["model.router"]


def test_the_three_clis(shards, tmp_path, capsys):
    spaces = tmp_path / "spaces"
    (spaces / "models").mkdir(parents=True)
    (spaces / "training.yaml").write_text(
        "optimizer:\n  lr: {type: float, low: 1e-4, high: 1e-2, log: true}\n")
    (spaces / "models" / "ast_moe.yaml").write_text(
        "model:\n  router: {type: categorical, choices: [expert]}\n"
        "  capacity_factor: {type: float, low: 1.0, high: 2.0}\n")
    common = _tiny(shards, tmp_path, f"optuna.spaces_dir={spaces}", "optuna.n_trials=1")
    study = optimize_hyperparams.main(common)
    (trial,) = study.trials
    assert trial.state == hpo.TrialState.COMPLETE and trial.params["model.router"] == "expert"
    best = yaml.safe_load((tmp_path / "out" / "best_config.yaml").read_text())
    assert best["params"] == trial.params
    debug = debug_optimize.main([*common, "optuna.study_name=debug_study"])
    assert [t.state for t in debug.study.trials] == [hpo.TrialState.COMPLETE]
    capsys.readouterr()
    analyze_study.main(["optuna_leaf_esc50", "--storage", str(tmp_path / "study.db"),
                        "--out", str(tmp_path / "an"), "--csv", "--no-plots"])
    assert "best trial #0" in capsys.readouterr().out
    assert (tmp_path / "an" / "optuna_leaf_esc50_summary.json").exists()
    # optuna.vmapped: K lockstep trials (hpo/vmapped.py); debug_optimize runs
    # the sequential sweep whatever the flag, as the JAX script does
    vm = optimize_hyperparams.main([*common[:-1], "optuna.n_trials=2",
                                    "optuna.study_name=vmapped", "+optuna.vmapped.enabled=true",
                                    "+optuna.vmapped.k=2"])
    assert len(vm.trials) == 2 and {t.state for t in vm.trials} <= {
        hpo.TrialState.COMPLETE, hpo.TrialState.PRUNED}
    debug = debug_optimize.main([*common, "optuna.study_name=debug_vmapped",
                                 "+optuna.vmapped.enabled=true"])
    assert [t.state for t in debug.study.trials] == [hpo.TrialState.COMPLETE]


def test_startup_trials_of_the_card_study_take_both_routers(tmp_path):
    """The card's AST-MoE study (``chip_smoke.py`` phase 27) runs 4 trials
    with the configs' sampler seed 42: all four are startup draws, and
    they take both routers."""
    cfg = compose(str(CONFIG_DIR), "optimization", ["model=ast_moe"])
    space = hpo.HyperparameterSpace.from_model_config(cfg, SPACES_DIR)
    assert cfg.optuna.sampler.n_startup_trials >= 4
    study = hpo.Study("startup", tmp_path / "s.db",
                      sampler=hpo.TPESampler(seed=cfg.optuna.sampler.seed))
    routers = set()
    for _ in range(4):
        trial = study.ask()
        routers.add(space.suggest_parameters(trial)["model.router"])
        study.tell(trial, 0.0, hpo.TrialState.COMPLETE)
    assert routers == {"token", "expert"}
