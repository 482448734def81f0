"""Study runner: create or resume the study and drive the sweep (the JAX
package's ``hyperopt/runner.py``, sequential).

``TPESampler(seed)`` with the configured tier-1 pruner, SQLite storage
with ``load_if_exists`` resume and a progress printout, a completion
callback and the end-of-sweep summary.  Trials run one after another on
one device; the JAX package's parallel trial workers on sub-meshes are
not ported (ROADMAP A14).
"""

from __future__ import annotations

from typing import Optional

from irp_tpu_torch.hyperopt.objective import HyperoptContext, objective_kfold
from irp_tpu_torch.hyperopt.pruners import (MedianPruner, NopPruner,
                                            SuccessiveHalvingPruner)
from irp_tpu_torch.hyperopt.samplers import TPESampler
from irp_tpu_torch.hyperopt.study import Study, TrialState, create_study


def make_pruner(hcfg):
    """The tier-1 pruner ``hcfg.pruner`` names."""
    kind = hcfg.pruner
    if kind == "asha":
        return SuccessiveHalvingPruner(
            min_resource=hcfg.asha_min_resource,
            reduction_factor=hcfg.asha_reduction_factor)
    if kind == "none":
        return NopPruner()
    if kind == "median":
        return MedianPruner(n_startup_trials=hcfg.median_startup_trials,
                            n_warmup_steps=hcfg.median_warmup_steps,
                            interval_steps=1)
    raise ValueError(f"unknown pruner {kind!r} "
                     "(one of 'median', 'asha', 'none')")


def run_kfold_optimization(ctx: HyperoptContext,
                           n_trials: Optional[int] = None,
                           verbose: bool = True,
                           parallel_workers: Optional[int] = None) -> Study:
    """Run ``n_trials`` more trials (default ``hcfg.n_trials``) of the
    study ``ctx.hcfg`` names, one after another; the fold pool is released
    at the end.  ``parallel_workers`` > 1 raises NotImplementedError."""
    if parallel_workers and parallel_workers > 1:
        raise NotImplementedError(
            "parallel trial workers are not ported to irp_tpu_torch: one "
            "device runs the trials in sequence (ROADMAP A14)")
    hcfg = ctx.hcfg
    n_trials = n_trials if n_trials is not None else hcfg.n_trials
    study = create_study(study_name=hcfg.study_name,
                         storage=f"sqlite:///{hcfg.storage}",
                         sampler=TPESampler(seed=hcfg.seed),
                         pruner=make_pruner(hcfg),
                         direction="maximize",
                         load_if_exists=True)

    prior = study.get_trials()
    if prior and verbose:
        print(f"Loaded existing study with {len(prior)} previous trials.")
        try:
            print(f"Best value so far: {study.best_value:.2f} "
                  f"(t-dist lower bound); params:")
            for k, v in study.best_params.items():
                print(f"  {k}: {v}")
        except ValueError:
            pass

    def progress_callback(study, frozen):
        if frozen.state == TrialState.COMPLETE:
            print(f"Trial {frozen.number} completed with value: "
                  f"{frozen.value:.2f}")
        elif frozen.state == TrialState.PRUNED:
            print(f"Trial {frozen.number} pruned at step {frozen.last_step}")

    try:
        study.optimize(lambda t: objective_kfold(t, ctx), n_trials,
                       callbacks=([progress_callback] if verbose else None),
                       verbose=verbose)
    finally:
        ctx.release_hbm_pool()

    if verbose:
        trials = study.get_trials()
        pruned = [t for t in trials if t.state == TrialState.PRUNED]
        print("\nK-Fold Study statistics:")
        print(f"  Number of finished trials: {len(trials)}")
        print(f"  Number of pruned trials: {len(pruned)}")
        try:
            best = study.best_trial
            print("  Best trial:")
            print(f"    Value: {best.value:.2f} (t-dist lower bound)")
            for k, v in best.params.items():
                print(f"      {k}: {v}")
        except ValueError:
            print("  No completed trials yet.")
    return study
