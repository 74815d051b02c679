"""Hyperparameter optimization: TPE sampler + Hyperband pruning + SQLite
study persistence + config-space parsing + the trial runner.

The port's copy of ``dlsc_tpu/hpo`` (its modules need no jax; the port
imports nothing of the JAX package): the same sampler, pruners, SQLite
schema and search spaces, with trials trained by the port's ``Trainer``
(``runner.py``), or K trials a step in lockstep under ``torch.func.vmap``
(``vmapped.py``).
"""

from dlsc_tpu_torch.hpo.study import Study, StudyManager, Trial, TrialPruned, TrialState
from dlsc_tpu_torch.hpo.tpe import TPESampler, RandomSampler
from dlsc_tpu_torch.hpo.hyperband import HyperbandPruner, SuccessiveHalvingPruner
from dlsc_tpu_torch.hpo.pruners import MedianPruner, NopPruner
from dlsc_tpu_torch.hpo.space import HyperparameterSpace

__all__ = [
    "Study", "StudyManager", "Trial", "TrialPruned", "TrialState",
    "TPESampler", "RandomSampler",
    "HyperbandPruner", "SuccessiveHalvingPruner", "MedianPruner", "NopPruner",
    "HyperparameterSpace",
]
