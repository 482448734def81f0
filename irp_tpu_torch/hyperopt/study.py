"""Study / Trial API (ask-tell + optimize loop).

Mirrors the Optuna surface the reference uses (reference functions/
hyperopt.py:386-495, run_hyperopt.py:41-52): create_study with SQLite
storage + load_if_exists resume, study.optimize(objective, n_trials,
callbacks), trial.suggest_*, trial.report/should_prune, TrialPruned,
trial.set_user_attr, study.best_trial/best_params/best_value.
"""

from __future__ import annotations

import math
import threading
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

from irp_tpu_torch.hyperopt.distributions import (CategoricalDistribution,
                                            FloatDistribution,
                                            IntDistribution)
from irp_tpu_torch.hyperopt.pruners import NopPruner
from irp_tpu_torch.hyperopt.samplers import TPESampler
from irp_tpu_torch.hyperopt.storage import FrozenTrial, SQLiteStorage


class TrialPruned(Exception):
    """Raised inside an objective to mark the trial pruned."""


class TrialState:
    RUNNING = "RUNNING"
    COMPLETE = "COMPLETE"
    PRUNED = "PRUNED"
    FAILED = "FAILED"


class Trial:
    def __init__(self, study: "Study", frozen: FrozenTrial):
        self.study = study
        self._frozen = frozen

    @property
    def number(self) -> int:
        return self._frozen.number

    @property
    def trial_id(self) -> int:
        return self._frozen.trial_id

    @property
    def params(self):
        return dict(self._frozen.params)

    @property
    def user_attrs(self):
        return dict(self._frozen.user_attrs)

    @property
    def intermediate_values(self):
        return dict(self._frozen.intermediate_values)

    @property
    def last_step(self):
        return self._frozen.last_step

    def _suggest(self, name: str, dist) -> Any:
        if name in self._frozen.params:
            return self._frozen.params[name]
        with self.study._sampler_lock:
            # numpy Generators aren't thread-safe; trials run from
            # several threads share this sampler
            value = self.study.sampler.sample(self.study, self._frozen,
                                              name, dist)
        self.study.storage.set_param(self.trial_id, name, value, dist)
        self._frozen.params[name] = value
        self._frozen.distributions[name] = dist
        return value

    def suggest_float(self, name: str, low: float, high: float,
                      log: bool = False, step: float | None = None) -> float:
        return self._suggest(name, FloatDistribution(low, high, log, step))

    def suggest_int(self, name: str, low: int, high: int, log: bool = False,
                    step: int = 1) -> int:
        return self._suggest(name, IntDistribution(low, high, log, step))

    def suggest_categorical(self, name: str, choices: Sequence[Any]) -> Any:
        return self._suggest(name, CategoricalDistribution(choices))

    def report(self, value: float, step: int) -> None:
        self.study.storage.report_intermediate(self.trial_id, step,
                                               float(value))
        self._frozen.intermediate_values[step] = float(value)

    def should_prune(self) -> bool:
        return self.study.pruner.should_prune(self.study, self._frozen)

    def set_user_attr(self, key: str, value: Any) -> None:
        self.study.storage.set_user_attr(self.trial_id, key, value)
        self._frozen.user_attrs[key] = value


class Study:
    def __init__(self, study_name: str, storage: SQLiteStorage,
                 sampler=None, pruner=None, direction: str = "maximize",
                 load_if_exists: bool = True, fail_orphans: bool = True):
        self.study_name = study_name
        self.storage = storage
        self.sampler = sampler or TPESampler()
        self.pruner = pruner or NopPruner()
        self.study_id = storage.get_or_create_study(study_name, direction,
                                                    load_if_exists,
                                                    fail_orphans)
        self.direction = storage.study_direction(self.study_id)
        self._sampler_lock = threading.Lock()

    # -- introspection ---------------------------------------------------
    def get_trials(self) -> List[FrozenTrial]:
        return self.storage.get_trials(self.study_id)

    @property
    def trials(self) -> List[FrozenTrial]:
        return self.get_trials()

    def _completed(self) -> List[FrozenTrial]:
        return [t for t in self.get_trials()
                if t.state == TrialState.COMPLETE and t.value is not None
                and math.isfinite(t.value)]

    @property
    def best_trial(self) -> FrozenTrial:
        completed = self._completed()
        if not completed:
            raise ValueError("no completed trials")
        key = (lambda t: t.value) if self.direction == "maximize" else (
            lambda t: -t.value)
        return max(completed, key=key)

    @property
    def best_value(self) -> float:
        return self.best_trial.value

    @property
    def best_params(self):
        return dict(self.best_trial.params)

    # -- ask / tell ------------------------------------------------------
    def ask(self) -> Trial:
        frozen = self.storage.create_trial(self.study_id)
        return Trial(self, frozen)

    def tell(self, trial: Trial, state: str,
             value: Optional[float] = None) -> None:
        self.storage.finish_trial(trial.trial_id, state, value)

    # -- optimize loop ---------------------------------------------------
    def optimize(self, objective: Callable[[Trial], float],
                 n_trials: int,
                 callbacks: Optional[List[Callable]] = None,
                 catch: tuple = (Exception,),
                 verbose: bool = False) -> None:
        for _ in range(n_trials):
            trial = self.ask()
            t0 = time.time()
            try:
                value = objective(trial)
            except TrialPruned:
                self.tell(trial, TrialState.PRUNED)
                if verbose:
                    print(f"trial {trial.number}: PRUNED "
                          f"({time.time() - t0:.1f}s)")
            except catch as e:
                self.tell(trial, TrialState.FAILED)
                if verbose:
                    print(f"trial {trial.number}: FAILED {e!r}")
                    traceback.print_exc()
            else:
                value = float(value)
                # NaN -> FAILED; -inf stays COMPLETE(-inf): the reference
                # records the OOM penalty as a completed value, which the
                # tier-3 progressive median sees (the TPE sampler itself
                # filters non-finite objectives; best_trial too).
                if math.isnan(value):
                    self.tell(trial, TrialState.FAILED)
                else:
                    self.tell(trial, TrialState.COMPLETE, value)
                if verbose:
                    print(f"trial {trial.number}: {value:.4f} "
                          f"({time.time() - t0:.1f}s)")
            if callbacks:
                frozen = next(t for t in self.get_trials()
                              if t.trial_id == trial.trial_id)
                for cb in callbacks:
                    cb(self, frozen)


def create_study(study_name: str, storage: str | SQLiteStorage,
                 sampler=None, pruner=None, direction: str = "maximize",
                 load_if_exists: bool = True,
                 fail_orphans: bool = True) -> Study:
    """storage: path to a sqlite file, 'sqlite:///<path>' URI (Optuna
    style, reference hyperopt.py:407), or a SQLiteStorage instance.

    ``fail_orphans=False`` when JOINING a study that other live worker
    processes are running against (their RUNNING trials are not orphans
    of a dead process)."""
    if isinstance(storage, str):
        if storage.startswith("sqlite:///"):
            storage = storage[len("sqlite:///"):]
        storage = SQLiteStorage(storage)
    return Study(study_name, storage, sampler, pruner, direction,
                 load_if_exists, fail_orphans)
