"""Simple pruners: median and no-op (the port's copy of
``dlsc_tpu/hpo/pruners.py``)."""

from __future__ import annotations

import numpy as np

from dlsc_tpu_torch.hpo.study import Study, Trial, TrialState


class NopPruner:
    def prune(self, study: Study, trial: Trial) -> bool:
        return False


class MedianPruner:
    """Prune when the trial's latest value is worse than the median of other
    trials' values at the same step (optuna semantics)."""

    def __init__(self, n_startup_trials: int = 5, n_warmup_steps: int = 0,
                 interval_steps: int = 1):
        self.n_startup_trials = n_startup_trials
        self.n_warmup_steps = n_warmup_steps
        self.interval_steps = max(interval_steps, 1)

    def prune(self, study: Study, trial: Trial) -> bool:
        step = trial.last_step
        if step is None or step < self.n_warmup_steps:
            return False
        if (step - self.n_warmup_steps) % self.interval_steps:
            return False
        completed = [t for t in study.trials
                     if t.number != trial.number
                     and t.state in (TrialState.COMPLETE, TrialState.PRUNED)
                     and step in t.intermediate_values]
        if len(completed) < self.n_startup_trials:
            return False
        others = np.asarray([t.intermediate_values[step] for t in completed])
        mine = trial.intermediate_values[step]
        med = float(np.median(others))
        return mine < med if study.direction == "maximize" else mine > med
