"""HPO trial runner — the OptunaTrainer equivalent.

The port's copy of ``dlsc_tpu/hpo/runner.py``: each trial builds the
datamodule (``scripts/train.build_datamodule``), the model, loss and
optimizer (``train/loop.build_from_cfg``) and a ``Trainer`` of the port,
and records its fit's wall time as the ``fit_seconds`` attribute. The
pruning callback runs on the Trainer's ``on_validation_epoch_end`` hook.

Mirrors the reference orchestration (src/optimization/optuna_trainer.py):
per trial, suggest parameters → patch the composed config → rebuild
datamodule + model → fit with a Hyperband pruning callback (checkpointing
and progress bars disabled, :279-292) → extract the monitor metric → run the
test phase and log per-trial metrics → return the metric so the TPE sampler
updates its posterior. Failed trials are recorded FAILED and the sweep
continues. ``save_best_config`` writes the winning config YAML (:478-512).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Sequence

import yaml

from dlsc_tpu_torch.config.core import Config
from dlsc_tpu_torch.hpo.space import HyperparameterSpace
from dlsc_tpu_torch.hpo.study import Study, Trial, TrialPruned


class PruningCallback:
    """Per-epoch ``trial.report`` + prune check after ``min_epochs``
    (reference: src/optimization/pruning_callbacks.py:58-91). Tracks the
    learning curve as a trial attribute like the Hyperband callback
    (:152-279)."""

    def __init__(self, trial: Trial, monitor: str = "val/acc", min_epochs: int = 0,
                 tracker=None):
        self.trial = trial
        self.monitor = monitor
        self.min_epochs = min_epochs
        self.tracker = tracker
        self.curve: list[float] = []

    def on_validation_epoch_end(self, trainer, epoch: int, metrics: dict) -> None:
        value = metrics.get(self.monitor)
        if value is None:
            return
        self.curve.append(float(value))
        if self.tracker:
            self.tracker.log_metric(
                f"trial_{self.trial.number}/{self.monitor}", value, epoch
            )
        self.trial.report(float(value), epoch)
        if epoch >= self.min_epochs and self.trial.should_prune():
            self.trial.set_user_attr("learning_curve", self.curve)
            raise TrialPruned(f"pruned at epoch {epoch}")


class HPORunner:
    def __init__(
        self,
        study: Study,
        base_cfg: Config,
        space: HyperparameterSpace,
        monitor: str = "val/acc",
        min_epochs: int = 0,
        n_trials: int = 50,
        timeout: float | None = None,
        output_dir: str | Path = "outputs/optimization",
        tracker=None,
        run_test_per_trial: bool = True,
        trainer_overrides: dict | None = None,
    ):
        self.study = study
        self.base_cfg = base_cfg
        self.space = space
        self.monitor = monitor
        self.min_epochs = min_epochs
        self.n_trials = n_trials
        self.timeout = timeout
        self.output_dir = Path(output_dir)
        self.tracker = tracker
        self.run_test_per_trial = run_test_per_trial
        self.trainer_overrides = trainer_overrides or {}

    # -- per-trial build (reference: optuna_trainer.py:179-237) -----------------
    def _build(self, cfg: Config):
        from dlsc_tpu_torch.scripts.train import build_datamodule
        from dlsc_tpu_torch.train.loop import Trainer, build_from_cfg

        datamodule = build_datamodule(cfg)
        built = build_from_cfg(cfg, datamodule.pipeline.cfg)
        trainer_cfg = cfg.trainer.to_dict()
        trainer_cfg.update(self.trainer_overrides)
        # folded into the dict so a user-provided trainer.enable_checkpointing
        # doesn't collide with an explicit kwarg
        trainer_cfg["enable_checkpointing"] = False  # disabled during HPO (ref :284)
        trainer_cfg["seed"] = int(cfg.select("seed", default=42))
        trainer = Trainer(**trainer_cfg)
        return datamodule, built, trainer

    def _objective(self, trial: Trial) -> float:
        cfg = self.base_cfg.copy()
        params = self.space.suggest_parameters(trial)
        HyperparameterSpace.update_config_with_params(cfg, params)
        if self.tracker:
            self.tracker.log_params(
                {f"trial_{trial.number}/{k}": v for k, v in params.items()}
            )
        datamodule, built, trainer = self._build(cfg)
        cb = PruningCallback(trial, self.monitor, self.min_epochs, self.tracker)
        trainer.fit(
            built["model"], datamodule, built["optim_spec"], built["sched_spec"],
            criterion=built["criterion"], callbacks=[cb],
        )
        trial.set_user_attr("fit_seconds", trainer.fit_seconds)
        value = self._final_metric(trainer)
        if self.run_test_per_trial:
            results = trainer.test(datamodule, ckpt=None,
                                   criterion=built["criterion"])
            trial.set_user_attr("test_acc", results["test/acc"])
            trial.set_user_attr("test_f1", results["test/f1"])
            if self.tracker:
                self.tracker.log_metrics(
                    {f"trial_{trial.number}/test_acc": results["test/acc"],
                     f"trial_{trial.number}/test_f1": results["test/f1"]},
                )
        return value

    def _final_metric(self, trainer) -> float:
        """Monitor-metric extraction with fallback (reference :362-411):
        last logged value, else best of the history curve."""
        v = trainer.logged_metrics.get(self.monitor)
        if v is not None:
            return float(v)
        vals = [h[self.monitor] for h in trainer.history if self.monitor in h]
        if vals:
            return float(max(vals))
        raise RuntimeError(f"monitor metric {self.monitor!r} was never logged")

    # -- sweep -------------------------------------------------------------------
    def optimize(self, callbacks: Sequence[Callable[[Study, Trial], None]] = ()) -> Study:
        """Run the trials; each of ``callbacks`` is called with the study and
        the trial after every trial."""
        self.study.optimize(self._objective, n_trials=self.n_trials,
                            timeout=self.timeout, callbacks=callbacks)
        return self.study

    def summary(self) -> dict:
        return self.study.summary()

    def save_best_config(self, path: str | Path | None = None) -> Path:
        best = self.study.best_trial
        cfg = self.base_cfg.copy()
        HyperparameterSpace.update_config_with_params(cfg, best.params)
        out = Path(path) if path else self.output_dir / "best_config.yaml"
        out.parent.mkdir(parents=True, exist_ok=True)
        payload = {
            "best_value": best.value,
            "best_trial": best.number,
            "params": best.params,
            "config": cfg.to_dict(resolve=False),
        }
        out.write_text(yaml.safe_dump(payload, sort_keys=False))
        return out
