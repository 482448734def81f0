"""Pruners (the JAX package's ``hyperopt/pruners.py``).

``MedianPruner(n_startup_trials=20, n_warmup_steps=10, interval_steps=1)``
is tier 1 of the sweep's three-tier pruning; tiers 2 and 3 live in the
objective (``irp_tpu_torch.hyperopt.objective``).
``SuccessiveHalvingPruner`` is asynchronous successive halving (ASHA, Li
et al. 2018): it needs no startup-trial count and decides per rung from
whoever has arrived.
"""

from __future__ import annotations

import numpy as np


class NopPruner:
    def should_prune(self, study, trial) -> bool:
        return False


class SuccessiveHalvingPruner:
    """Asynchronous successive halving (ASHA, Li et al. 2018).

    Rungs sit at resources ``min_resource * reduction_factor**k``
    (reported steps are 0-indexed: a trial reaches rung resource r once
    it has reported step r-1).  At each rung a trial continues only if
    its best-so-far intermediate value is in the top
    ``1/reduction_factor`` of every trial that has reached that rung
    (itself included); with fewer than ``reduction_factor`` arrivals the
    rung cannot discriminate and lets the trial through.  Asynchronous:
    the decision uses whoever has arrived so far — no waiting for a
    cohort.
    """

    def __init__(self, min_resource: int = 1, reduction_factor: int = 3):
        if min_resource < 1:
            raise ValueError(f"min_resource must be >= 1, "
                             f"got {min_resource}")
        if reduction_factor < 2:
            raise ValueError(f"reduction_factor must be >= 2, "
                             f"got {reduction_factor}")
        self.min_resource = min_resource
        self.reduction_factor = reduction_factor

    @staticmethod
    def _best_at(trial, rung_step: int, maximize: bool):
        vals = [v for s, v in trial.intermediate_values.items()
                if s <= rung_step]
        if not vals:
            return None
        return max(vals) if maximize else min(vals)

    def should_prune(self, study, trial) -> bool:
        step = trial.last_step
        if step is None:
            return False
        maximize = study.direction == "maximize"
        peers = [t for t in study.get_trials()
                 if t.trial_id != trial.trial_id]
        rung_step = self.min_resource - 1  # step index reaching the rung
        while rung_step <= step:
            own = self._best_at(trial, rung_step, maximize)
            arrived = [self._best_at(t, rung_step, maximize)
                       for t in peers
                       if any(s >= rung_step for s in
                              t.intermediate_values)]
            arrived = [v for v in arrived if v is not None]
            n = len(arrived) + 1
            if n >= self.reduction_factor and own is not None:
                k = max(1, n // self.reduction_factor)  # promotions
                ranked = sorted(arrived + [own], reverse=maximize)
                cutoff = ranked[k - 1]
                if (own < cutoff) if maximize else (own > cutoff):
                    return True
            rung_step = (rung_step + 1) * self.reduction_factor - 1
        return False


class MedianPruner:
    """Prune when the trial's value at step s is worse than the median of
    completed trials' values at the same step.

    - no pruning until ``n_startup_trials`` trials have completed
    - no pruning before ``n_warmup_steps`` steps into a trial
    - checks only every ``interval_steps`` steps

    Optuna semantics, exactly: the median is over peers' intermediate
    values AT the step, and the candidate quantity is the current trial's
    BEST intermediate value so far.  (An earlier version medianed peers\'
    best-so-far and compared the current at-step value — BOTH
    substitutions push toward over-pruning when curves dip, the opposite
    of what its doc note claimed; caught in the round-2 review.)
    """

    def __init__(self, n_startup_trials: int = 5, n_warmup_steps: int = 0,
                 interval_steps: int = 1):
        self.n_startup_trials = n_startup_trials
        self.n_warmup_steps = n_warmup_steps
        self.interval_steps = max(interval_steps, 1)

    def should_prune(self, study, trial) -> bool:
        step = trial.last_step
        if step is None or step < self.n_warmup_steps:
            return False
        if (step - self.n_warmup_steps) % self.interval_steps != 0:
            return False
        completed = [t for t in study.get_trials()
                     if t.state == "COMPLETE" and t.trial_id != trial.trial_id]
        if len(completed) < self.n_startup_trials:
            return False
        maximize = study.direction == "maximize"
        peers = [t.intermediate_values[step] for t in completed
                 if step in t.intermediate_values]
        if not peers:
            return False
        median = float(np.median(peers))
        own = [v for s, v in trial.intermediate_values.items() if s <= step]
        best = max(own) if maximize else min(own)
        return best < median if maximize else best > median
