"""Hyperparameter optimization with the port (the HPO entry point).

    python -m dlsc_tpu_torch.scripts.optimize_hyperparams                  # LEAF sweep
    python -m dlsc_tpu_torch.scripts.optimize_hyperparams model=ast_moe optuna.n_trials=20
    python -m dlsc_tpu_torch.scripts.optimize_hyperparams optuna.study_name=my_study

A tiny sweep on the CPU (synthetic shards from
``dlsc_tpu_torch.data.synthetic.make_synthetic_dataset``):

    python -m dlsc_tpu_torch.scripts.optimize_hyperparams model=ast_moe \
        trainer.accelerator=cpu dataset.root=<shards> dataset.num_classes=4 \
        +model.emb_dim=32 +model.depth=2 +model.num_heads=2 trainer.max_epochs=1 \
        +trainer.limit_train_batches=2 optuna.n_trials=2 \
        optuna.storage_path=sqlite:///<dir>/study.db optuna.output_dir=<dir>

The counterpart of ``scripts/optimize_hyperparams.py``, with the same
configs (``configs/optimization.yaml``) and override grammar: the modular
search space of ``configs/optimization/hyperparameter_spaces`` (training +
loss + the model's file, picked by its ``_target_``), a TPE + Hyperband
study on SQLite (resumable by ``optuna.study_name``; a db of either package
loads in the other), each trial trained and tested by the port's
``Trainer`` with per-epoch pruning, and the best config written to
``<optuna.output_dir>/<optuna.best_config_path>``. A failed trial is
recorded FAIL and the sweep goes on, as in the JAX package.
``trainer.accelerator`` 'auto' trains on the GPU and fails without one.
``optuna.vmapped.enabled=true`` (K trials in one program, ``hpo/vmapped.py``)
is not ported and raises (ROADMAP M10b).
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Callable, Sequence

from dlsc_tpu_torch.config import compose
from dlsc_tpu_torch.hpo import HyperparameterSpace, StudyManager
from dlsc_tpu_torch.hpo.runner import HPORunner
from dlsc_tpu_torch.scripts.train import CONFIG_DIR, fix_seed, parse_cli
from dlsc_tpu_torch.tracking import Tracker

SPACES_DIR = CONFIG_DIR / "optimization" / "hyperparameter_spaces"


def build_runner(cfg, trainer_overrides: dict | None = None) -> HPORunner:
    spaces_dir = Path(cfg.select("optuna.spaces_dir", default=SPACES_DIR))
    space = HyperparameterSpace.from_model_config(cfg, spaces_dir)
    if not len(space):
        raise SystemExit(f"empty search space — add YAMLs under {spaces_dir} for this model")
    optuna_cfg = cfg.optuna.to_dict()
    study = StudyManager.from_config(optuna_cfg).create_study(load_if_exists=True)
    tracker = Tracker(cfg.select("logging.experiment_name", default="optuna"))
    return HPORunner(
        study=study,
        base_cfg=cfg,
        space=space,
        monitor=optuna_cfg.get("monitor", "val/acc"),
        min_epochs=int(optuna_cfg.get("min_epochs", 0)),
        n_trials=int(optuna_cfg.get("n_trials", 50)),
        timeout=optuna_cfg.get("timeout"),
        output_dir=optuna_cfg.get("output_dir", "outputs/optimization"),
        tracker=tracker,
        trainer_overrides=trainer_overrides,
    )


def compose_cli(argv: list[str]):
    """The optimization config (``configs/optimization.yaml`` unless
    ``--config-name`` names another) with the CLI's overrides, seeded."""
    config_path, config_name, overrides = parse_cli(argv)
    if config_name == "training":
        config_name = "optimization"
    cfg = compose(config_path, config_name, overrides)
    fix_seed(int(cfg.select("seed", default=42)))
    if cfg.select("optuna.vmapped.enabled", default=False):
        raise NotImplementedError(
            "optuna.vmapped.enabled=true (K trials in one program, hpo/vmapped.py) is not "
            "ported yet (ROADMAP §1 M10b); drop it to run the trials one after another")
    return cfg, overrides


def main(argv: list[str] | None = None,
         callbacks: Sequence[Callable] = ()) -> HPORunner:
    """Run the study; ``callbacks`` (study, trial) are called after each trial."""
    cfg, _ = compose_cli(list(argv if argv is not None else sys.argv[1:]))
    runner = build_runner(cfg)
    print(f"search space ({len(runner.space)} params): {runner.space.names()}")
    runner.optimize(callbacks)

    summary = runner.summary()
    print("\n=== study summary ===")
    for k, v in summary.items():
        print(f"  {k}: {v}")
    best_path = runner.save_best_config(
        Path(cfg.select("optuna.output_dir", default="outputs/optimization"))
        / cfg.select("optuna.best_config_path", default="best_config.yaml"))
    print(f"best config → {best_path}")
    return runner


if __name__ == "__main__":
    main()
