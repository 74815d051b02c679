"""Tree-structured Parzen Estimator sampler (from scratch; optuna-semantics).

The port's copy of ``dlsc_tpu/hpo/tpe.py`` (numpy and scipy): the same
seed gives the same suggestions in both packages.

Univariate TPE as in optuna's default sampler (the reference configures
``TPESampler(n_startup_trials=10, n_ei_candidates=24, seed=42)``,
reference: src/optimization/study_manager.py:58-67):

1. random sampling for the first ``n_startup_trials`` completed trials,
2. afterwards, split observed (param, objective) pairs into a "good" set
   (top γ(n) fraction by objective) and a "bad" set,
3. fit Parzen estimators l(x) over good and g(x) over bad — truncated
   per-point Gaussians for float/int (log-domain when log=True), weighted
   category counts with a Dirichlet prior for categoricals,
4. draw ``n_ei_candidates`` candidates from l and return the one maximizing
   l(x)/g(x) (equivalent to maximizing expected improvement).

γ(n) follows optuna: min(ceil(0.25·√n), 25) / n.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np

from dlsc_tpu_torch.hpo.study import Study, Trial, TrialState


def _gamma(n: int) -> int:
    return min(int(np.ceil(0.25 * np.sqrt(n))), 25)


class RandomSampler:
    def __init__(self, seed: int | None = None):
        self.rng = np.random.default_rng(seed)

    def sample(self, study: Study, name: str, dist: dict) -> Any:
        return _sample_uniform(self.rng, dist)


def _sample_uniform(rng: np.random.Generator, dist: dict) -> Any:
    kind = dist["type"]
    if kind == "categorical":
        return dist["choices"][int(rng.integers(len(dist["choices"])))]
    low, high, log = dist["low"], dist["high"], dist.get("log", False)
    if log:
        x = math.exp(rng.uniform(math.log(low), math.log(high)))
    else:
        x = rng.uniform(low, high)
    if kind == "int":
        step = dist.get("step") or 1
        return int(np.clip(round((x - low) / step) * step + low, low, high))
    step = dist.get("step")
    if step:
        x = round((x - low) / step) * step + low
    return float(np.clip(x, low, high))


class _ParzenEstimator:
    """1-D truncated-Gaussian mixture over observations (+ a flat prior
    component), in the transformed (possibly log) domain."""

    def __init__(self, obs: np.ndarray, low: float, high: float,
                 weights: np.ndarray | None = None):
        self.low, self.high = low, high
        prior_mu = 0.5 * (low + high)
        prior_sigma = high - low
        self.mus = np.concatenate([obs, [prior_mu]])
        n = len(self.mus)
        if n > 2:
            order = np.argsort(self.mus)
            sorted_mus = self.mus[order]
            gaps = np.empty(n)
            gaps[0] = sorted_mus[1] - sorted_mus[0]
            gaps[-1] = sorted_mus[-1] - sorted_mus[-2]
            gaps[1:-1] = np.maximum(
                sorted_mus[1:-1] - sorted_mus[:-2], sorted_mus[2:] - sorted_mus[1:-1]
            )
            sig = np.empty(n)
            sig[order] = gaps
        else:
            sig = np.full(n, prior_sigma)
        min_sig, max_sig = prior_sigma / max(100.0, n), prior_sigma
        self.sigmas = np.clip(sig, min_sig, max_sig)
        self.sigmas[-1] = prior_sigma  # prior keeps full width
        w = np.ones(n) if weights is None else np.concatenate([weights, [1.0]])
        self.weights = w / w.sum()

    def sample(self, rng: np.random.Generator, size: int) -> np.ndarray:
        comp = rng.choice(len(self.mus), size=size, p=self.weights)
        x = rng.normal(self.mus[comp], self.sigmas[comp])
        return np.clip(x, self.low, self.high)

    def log_pdf(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)[:, None]
        mus, sig, w = self.mus[None], self.sigmas[None], self.weights[None]
        # truncated-normal normalization over [low, high]
        z = 0.5 * (_erf((self.high - self.mus) / (self.sigmas * math.sqrt(2)))
                   - _erf((self.low - self.mus) / (self.sigmas * math.sqrt(2))))
        z = np.maximum(z, 1e-12)[None]
        log_comp = (
            -0.5 * ((x - mus) / sig) ** 2
            - np.log(sig) - 0.5 * math.log(2 * math.pi) - np.log(z)
        )
        m = log_comp.max(axis=1, keepdims=True)
        return (m + np.log((w * np.exp(log_comp - m)).sum(axis=1, keepdims=True)))[:, 0]


def _erf(x):
    from scipy.special import erf

    return erf(x)


class TPESampler:
    def __init__(
        self,
        n_startup_trials: int = 10,
        n_ei_candidates: int = 24,
        seed: int | None = None,
        **_: Any,
    ):
        self.n_startup_trials = n_startup_trials
        self.n_ei_candidates = n_ei_candidates
        self.rng = np.random.default_rng(seed)

    # -- observation collection --------------------------------------------------
    def _observations(self, study: Study, name: str) -> tuple[list, list]:
        values, scores = [], []
        for t in study.trials:
            if name not in t.params or t.value is None:
                continue
            if t.state not in (TrialState.COMPLETE, TrialState.PRUNED):
                continue
            values.append(t.params[name])
            scores.append(t.value if study.direction == "minimize" else -t.value)
        return values, scores

    def sample(self, study: Study, name: str, dist: dict) -> Any:
        values, scores = self._observations(study, name)
        if len(values) < self.n_startup_trials:
            return _sample_uniform(self.rng, dist)
        order = np.argsort(scores)  # ascending: best first (scores are losses)
        n_good = max(_gamma(len(values)), 1)
        good = [values[i] for i in order[:n_good]]
        bad = [values[i] for i in order[n_good:]] or good

        if dist["type"] == "categorical":
            return self._sample_categorical(dist, good, bad)
        return self._sample_numeric(dist, good, bad)

    # -- numeric ---------------------------------------------------------------
    def _transform(self, x: np.ndarray, dist: dict) -> np.ndarray:
        return np.log(x) if dist.get("log") else np.asarray(x, dtype=np.float64)

    def _untransform(self, x: float, dist: dict):
        v = math.exp(x) if dist.get("log") else x
        low, high = dist["low"], dist["high"]
        if dist["type"] == "int":
            step = dist.get("step") or 1
            return int(np.clip(round((v - low) / step) * step + low, low, high))
        step = dist.get("step")
        if step:
            v = round((v - low) / step) * step + low
        return float(np.clip(v, low, high))

    def _sample_numeric(self, dist: dict, good: list, bad: list):
        low, high = dist["low"], dist["high"]
        tlow, thigh = ((math.log(low), math.log(high)) if dist.get("log")
                       else (float(low), float(high)))
        l_est = _ParzenEstimator(self._transform(np.asarray(good, float), dist), tlow, thigh)
        g_est = _ParzenEstimator(self._transform(np.asarray(bad, float), dist), tlow, thigh)
        cands = l_est.sample(self.rng, self.n_ei_candidates)
        score = l_est.log_pdf(cands) - g_est.log_pdf(cands)
        return self._untransform(float(cands[int(np.argmax(score))]), dist)

    # -- categorical ----------------------------------------------------------
    def _sample_categorical(self, dist: dict, good: list, bad: list):
        choices = dist["choices"]

        def weights(obs):
            counts = np.ones(len(choices), dtype=np.float64)  # Dirichlet prior
            for o in obs:
                counts[choices.index(o)] += 1
            return counts / counts.sum()

        wl, wg = weights(good), weights(bad)
        idx = self.rng.choice(len(choices), size=self.n_ei_candidates, p=wl)
        score = np.log(wl[idx]) - np.log(wg[idx])
        return choices[int(idx[int(np.argmax(score))])]
