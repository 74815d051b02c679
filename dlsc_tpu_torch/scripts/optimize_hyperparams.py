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

``+optuna.vmapped.enabled=true`` trains K trials in lockstep, each step one
``torch.func.vmap`` over the trials (``hpo/vmapped.py``; ``run_vmapped``),
with the JAX script's keys: ``optuna.vmapped.k`` (8), ``rounds``,
``continuous`` (slot recycling, the default) and ``spaces`` (the searched
ranges by name, e.g. ``'+optuna.vmapped.spaces={model.dropout: {low: 0.0,
high: 0.5}}'``; the port also reads ``scheduler.T_max`` and
``scheduler.warmup_frac`` there). ``optuna.vmapped.mesh=true`` shards the
K trials over the devices that ``trainer.devices`` names (``auto``: every
visible GPU), K / W a rank (``hpo/vmapped.py``, ``plan``): the script starts
one rank per device (``parallel.mesh.spawn``), or joins torchrun's group
(``torchrun --nproc-per-node N -m dlsc_tpu_torch.scripts.optimize_hyperparams
...``), as ``scripts/train.py`` does; rank 0 alone opens, prints and writes
the study. On one device, or without the flag, it runs in one process. On
the CPU, ``trainer.accelerator=cpu trainer.devices=2`` runs two gloo ranks.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Callable, Sequence

import torch.distributed as dist

from dlsc_tpu_torch.config import compose
from dlsc_tpu_torch.hpo import HyperparameterSpace, Study, StudyManager
from dlsc_tpu_torch.hpo.runner import HPORunner
from dlsc_tpu_torch.parallel.data import is_writer
from dlsc_tpu_torch.parallel.mesh import init_distributed, spawn
from dlsc_tpu_torch.scripts.train import CONFIG_DIR, fix_seed, n_ranks, parse_cli
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


def run_vmapped(cfg) -> Study | None:
    """K lockstep trials a step (``hpo/vmapped.py``), as the JAX script's
    ``run_vmapped``; in a process group the trials are split over its ranks.
    Returns the study (None on ranks other than 0)."""
    from dlsc_tpu_torch.hpo.vmapped import VmappedTrialRunner
    from dlsc_tpu_torch.parallel import make_plan
    from dlsc_tpu_torch.scripts.train import build_datamodule
    from dlsc_tpu_torch.train.loop import build_from_cfg, resolve_device

    optuna_cfg = cfg.optuna.to_dict()
    vm = optuna_cfg.get("vmapped", {})
    k = int(vm.get("k", 8))
    rounds = int(vm.get("rounds", max(optuna_cfg.get("n_trials", 16) // k, 1)))
    device = resolve_device(cfg.select("trainer.accelerator", default="auto"))
    plan = make_plan(device.type) if dist.is_initialized() else None
    lead = is_writer()

    datamodule = build_datamodule(cfg)
    built = build_from_cfg(cfg, datamodule.pipeline.cfg)
    study = StudyManager.from_config(optuna_cfg).create_study(load_if_exists=True) \
        if lead else None
    sp = vm.get("spaces", {})
    runner = VmappedTrialRunner(
        study, built["model"], datamodule.pipeline, datamodule,
        epochs=int(cfg.select("trainer.max_epochs", default=10)),
        lr_space=sp.get("optimizer.lr"),
        wd_space=sp.get("optimizer.weight_decay"),
        ls_space=sp.get("loss.label_smoothing"),
        do_space=sp.get("model.dropout"),
        ma_space=sp.get("dataset.mixup_alpha"),
        tmax_space=sp.get("scheduler.T_max"),
        wu_space=sp.get("scheduler.warmup_frac"),
        gradient_clip_val=cfg.select("trainer.gradient_clip_val", default=1.0),
        min_epochs=int(optuna_cfg.get("min_epochs", 0)),
        seed=int(cfg.select("seed", default=42)),
        device=device,
        plan=plan,
    )
    if vm.get("continuous", True):
        # slot recycling: pruned/finished slots refill with fresh suggestions
        total = int(optuna_cfg.get("n_trials", k * rounds))
        finished = runner.run_continuous(k=k, total_trials=total)
        if lead:
            print(f"[vmapped continuous] processed {len(finished)} trials "
                  f"through {k} slots")
    else:
        for r in range(rounds):
            result = runner.run_batch(k=k)
            if lead:
                print(f"[vmapped round {r}] trials {result.trial_numbers} "
                      f"values {['%.4f' % v for v in result.values]}")
    if lead:
        print(study.summary())
    return study


def _vmapped_rank(argv: list[str]) -> None:
    """One spawned rank of a sharded vmapped study."""
    cfg, _ = compose_cli(argv)
    run_vmapped(cfg)


def main_vmapped(cfg, argv: list[str]) -> Study:
    """``run_vmapped``; with ``optuna.vmapped.mesh`` on several devices, on
    one rank per device (spawned, or torchrun's), the study reopened from
    its storage when the ranks are done."""
    n, device_type, _ = n_ranks(cfg)
    if cfg.select("optuna.vmapped.mesh", default=False) and not dist.is_initialized():
        if "RANK" in os.environ:   # under torchrun
            init_distributed(device_type=device_type)
        elif n > 1:
            spawn(_vmapped_rank, n, argv, device_type=device_type, timeout_s=24 * 3600)
            return StudyManager.from_config(cfg.optuna.to_dict()).create_study(
                load_if_exists=True)
    return run_vmapped(cfg)


def compose_cli(argv: list[str]):
    """The optimization config (``configs/optimization.yaml`` unless
    ``--config-name`` names another) with the CLI's overrides, seeded."""
    config_path, config_name, overrides = parse_cli(argv)
    if config_name == "training":
        config_name = "optimization"
    cfg = compose(config_path, config_name, overrides)
    fix_seed(int(cfg.select("seed", default=42)))
    return cfg, overrides


def main(argv: list[str] | None = None, callbacks: Sequence[Callable] = ()) -> Study:
    """Run the study and return it: trial by trial through the
    ``HPORunner`` (``callbacks`` (study, trial) are called after each
    trial), or with ``optuna.vmapped.enabled`` through ``run_vmapped``."""
    argv = list(argv if argv is not None else sys.argv[1:])
    cfg, _ = compose_cli(argv)
    if cfg.select("optuna.vmapped.enabled", default=False):
        return main_vmapped(cfg, argv)
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
    return runner.study


if __name__ == "__main__":
    main()
