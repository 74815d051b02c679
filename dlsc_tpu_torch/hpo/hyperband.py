"""Successive Halving + Hyperband pruners (optuna semantics).

The port's copy of ``dlsc_tpu/hpo/hyperband.py``.

The reference configures ``HyperbandPruner(min_resource=1, max_resource=100,
reduction_factor=3)`` (reference: src/optimization/study_manager.py:69-78):
trials are hashed into brackets; within a bracket, Successive Halving keeps
the top 1/η of trials at each rung (rungs at min_resource·η^k steps).
"""

from __future__ import annotations

import math

from dlsc_tpu_torch.hpo.study import Study, Trial, TrialState


class SuccessiveHalvingPruner:
    def __init__(self, min_resource: int = 1, reduction_factor: int = 3,
                 min_early_stopping_rate: int = 0):
        self.min_resource = min_resource
        self.rf = reduction_factor
        self.rate0 = min_early_stopping_rate

    def _rungs(self, step: int) -> list[int]:
        """All rung step-counts <= step."""
        rungs, k = [], self.rate0
        while True:
            r = self.min_resource * (self.rf ** k)
            if r > step:
                break
            rungs.append(r)
            k += 1
        return rungs

    def prune(self, study: Study, trial: Trial) -> bool:
        step = trial.last_step
        if step is None:
            return False
        sign = 1.0 if study.direction == "maximize" else -1.0
        for rung in self._rungs(step):
            my = _value_at(trial, rung)
            if my is None:
                continue
            others = []
            for t in study.trials:
                if t.number == trial.number:
                    continue
                if t.state in (TrialState.COMPLETE, TrialState.PRUNED,
                               TrialState.RUNNING):
                    v = _value_at(t, rung)
                    if v is not None:
                        others.append(sign * v)
            if not others:
                continue
            others.sort(reverse=True)
            n_keep = max(1, math.ceil((len(others) + 1) / self.rf))
            # survive iff within the top 1/rf of {others + me}
            threshold = others[n_keep - 1] if n_keep <= len(others) else -math.inf
            if sign * my < threshold:
                return True
        return False


def _value_at(trial: Trial, rung: int) -> float | None:
    """Best reported value at or before the rung step."""
    vals = [v for s, v in trial.intermediate_values.items() if s <= rung]
    return vals[-1] if vals else None


class HyperbandPruner:
    """Bracketed Successive Halving (reference defaults min=1, max=100, η=3).

    A trial is deterministically assigned to a bracket by number; bracket b
    applies SuccessiveHalving with early-stopping rate b (later rungs →
    gentler pruning).

    ``max_resource='auto'`` follows optuna's semantics: the value is resolved
    lazily from the last reported step of the first trial to COMPLETE (its
    actual epoch budget), and no pruning happens until then. The reference
    passes an explicit 100 (src/optimization/study_manager.py:69-78), so the
    parity path never exercises 'auto' — but when it is used, the bracket
    count must follow the real budget, not a hardcoded 100."""

    def __init__(self, min_resource: int = 1, max_resource: int | str = 100,
                 reduction_factor: int = 3):
        self.min_resource = min_resource
        self.rf = reduction_factor
        self.max_resource: int | None = (
            None if max_resource == "auto" else int(max_resource))
        self.n_brackets: int | None = None
        self._shas: list[SuccessiveHalvingPruner] | None = None
        if self.max_resource is not None:
            self._build_brackets()

    def _build_brackets(self) -> None:
        self.n_brackets = (
            int(math.log(max(self.max_resource / self.min_resource, 1), self.rf)) + 1
        )
        self._shas = [
            SuccessiveHalvingPruner(self.min_resource, self.rf,
                                    min_early_stopping_rate=b)
            for b in range(self.n_brackets)
        ]

    def _try_resolve_auto(self, study: Study) -> bool:
        """Resolve max_resource from completed trials (optuna 'auto')."""
        if self._shas is not None:
            return True
        steps = [t.last_step for t in study.trials
                 if t.state == TrialState.COMPLETE and t.last_step is not None]
        if not steps:
            return False
        # optuna: max_resource = max(last_step over COMPLETE trials) + 1
        self.max_resource = max(steps) + 1
        self._build_brackets()
        return True

    def bracket_of(self, trial: Trial) -> int:
        if self.n_brackets is None:
            raise RuntimeError(
                "HyperbandPruner(max_resource='auto') not yet resolved: "
                "no trial has completed")
        return trial.number % self.n_brackets

    def prune(self, study: Study, trial: Trial) -> bool:
        if not self._try_resolve_auto(study):
            return False  # 'auto' unresolved: optuna never prunes before then
        return self._shas[self.bracket_of(trial)].prune(study, trial)
