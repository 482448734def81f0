"""Samplers: random + Tree-structured Parzen Estimator (TPE).

The reference uses ``optuna.samplers.TPESampler(seed=SEED)`` (reference
functions/hyperopt.py:434-436).  This is a from-scratch univariate TPE:

for each parameter independently, completed observations are split into a
"good" set (top gamma quantile by objective) and a "bad" set; each set is
modeled with a truncated-Gaussian Parzen mixture (plus a uniform prior
component) in the parameter's internal space (log-space for log params);
candidates drawn from the good model are scored by the density ratio
l(x)/g(x) and the best candidate wins.  Categoricals use smoothed category
frequencies.  Pruned trials participate with their last intermediate value
(like Optuna), so pruning steers the search too.  The draws are numpy's,
as in the JAX package: the same seed and history propose the same
parameters in both packages.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np

from irp_tpu_torch.hyperopt.distributions import CategoricalDistribution


class RandomSampler:
    def __init__(self, seed: Optional[int] = None):
        self.rng = np.random.default_rng(seed)

    def sample(self, study, trial, name: str, dist) -> Any:
        if isinstance(dist, CategoricalDistribution):
            return dist.choices[self.rng.integers(len(dist.choices))]
        low, high = dist.internal_bounds
        x = self.rng.uniform(low, high)
        return dist.from_internal(x)


def _default_gamma(n: int) -> int:
    return min(int(np.ceil(0.1 * n)), 25)


def _split_observations(trials, name: str, direction: str, dist=None):
    """(internal_values, objectives) for trials that sampled ``name``.

    ``dist``: the CURRENT distribution for this param.  A resumed study
    can carry trials sampled from a DIFFERENT space (e.g. a --quick smoke
    run sharing storage with the full sweep); their internal encodings
    are not comparable — a stale categorical index can be out of range or
    silently mean another choice — so such trials are skipped."""
    values, objs = [], []
    for t in trials:
        if name not in t.params:
            continue
        tdist = t.distributions.get(name)
        if tdist is None or (dist is not None and tdist != dist):
            continue
        if t.state == "COMPLETE" and t.value is not None:
            obj = t.value
        elif t.state == "PRUNED" and t.intermediate_values:
            obj = t.intermediate_values[max(t.intermediate_values)]
        else:
            continue
        if not np.isfinite(obj):
            continue
        values.append(tdist.to_internal(t.params[name]))
        objs.append(obj if direction == "maximize" else -obj)
    return np.asarray(values, float), np.asarray(objs, float)


class _ParzenMixture:
    """Truncated-Gaussian mixture over [low, high] + one uniform prior
    component (weight 1/(k+1) each)."""

    def __init__(self, points: np.ndarray, low: float, high: float):
        self.low, self.high = low, high
        self.points = points
        k = len(points)
        span = max(high - low, 1e-12)
        if k == 0:
            self.sigmas = np.zeros(0)
        else:
            # Scott-style bandwidth, floored to 1% of the span
            sigma = max(span * 1.06 * k ** (-0.2), 0.01 * span)
            self.sigmas = np.full(k, sigma)
        self.weights = np.full(k + 1, 1.0 / (k + 1))  # last = uniform prior

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        k = len(self.points)
        comp = rng.integers(0, k + 1, size=n)
        out = np.empty(n)
        uniform_mask = comp == k
        out[uniform_mask] = rng.uniform(self.low, self.high,
                                        uniform_mask.sum())
        gm = ~uniform_mask
        if gm.any():
            mu = self.points[comp[gm]]
            sd = self.sigmas[comp[gm]]
            x = rng.normal(mu, sd)
            out[gm] = np.clip(x, self.low, self.high)
        return out

    def log_pdf(self, xs: np.ndarray) -> np.ndarray:
        span = max(self.high - self.low, 1e-12)
        parts = [np.full_like(xs, math.log(self.weights[-1] / span))]
        for mu, sd, w in zip(self.points, self.sigmas,
                             self.weights[:-1]):
            z = (xs - mu) / sd
            logp = (math.log(w) - 0.5 * z * z
                    - math.log(sd * math.sqrt(2 * math.pi)))
            parts.append(logp)
        stacked = np.stack(parts)
        m = stacked.max(axis=0)
        return m + np.log(np.exp(stacked - m).sum(axis=0))


class TPESampler:
    def __init__(self, seed: Optional[int] = None,
                 n_startup_trials: int = 10,
                 n_ei_candidates: int = 24,
                 gamma=_default_gamma):
        self.rng = np.random.default_rng(seed)
        self.n_startup_trials = n_startup_trials
        self.n_ei_candidates = n_ei_candidates
        self.gamma = gamma
        self._fallback = RandomSampler(
            seed if seed is None else seed + 10007)

    def sample(self, study, trial, name: str, dist) -> Any:
        trials = study.get_trials()
        values, objs = _split_observations(trials, name, study.direction,
                                           dist)
        n = len(values)
        if n < self.n_startup_trials:
            return self._fallback.sample(study, trial, name, dist)

        n_below = self.gamma(n)
        order = np.argsort(-objs)  # best first (already maximize-internal)
        below = values[order[:n_below]]
        above = values[order[n_below:]]

        if isinstance(dist, CategoricalDistribution):
            k = len(dist.choices)
            cb = np.bincount(below.astype(int), minlength=k) + 1.0
            ca = np.bincount(above.astype(int), minlength=k) + 1.0
            score = np.log(cb / cb.sum()) - np.log(ca / ca.sum())
            return dist.choices[int(np.argmax(score))]

        low, high = dist.internal_bounds
        l_model = _ParzenMixture(below, low, high)
        g_model = _ParzenMixture(above, low, high)
        cands = l_model.sample(self.rng, self.n_ei_candidates)
        score = l_model.log_pdf(cands) - g_model.log_pdf(cands)
        return dist.from_internal(float(cands[int(np.argmax(score))]))
