"""Study runner: create or resume the study and drive the sweep (the JAX
package's ``hyperopt/runner.py``).

``TPESampler(seed)`` with the configured tier-1 pruner, SQLite storage
with ``load_if_exists`` resume and a progress printout, a completion
callback and the end-of-sweep summary.  Trials run one after another, or
with ``parallel_workers`` > 1 concurrently on per-worker meshes
(``hyperopt/parallel.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

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
                           parallel_workers: Optional[int] = None,
                           devices: Optional[Sequence] = None) -> Study:
    """Run ``n_trials`` more trials (default ``hcfg.n_trials``) of the
    study ``ctx.hcfg`` names; the fold pools are released at the end.

    ``parallel_workers`` > 1 runs up to that many trials at once, one
    worker per device of ``devices`` (every local CUDA device by
    default; a device may repeat), each worker with its own
    context on its own mesh sharing the fold memo; the workers' pool
    sizes are summed onto ``ctx.hbm_pool_stats``."""
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

    if parallel_workers and parallel_workers > 1:
        from irp_tpu_torch.hyperopt.parallel import run_parallel_trials

        # one context per worker mesh, made once (replace re-runs the
        # per-shard histogram scan), sharing the fold memo
        mesh_ctxs = {}

        def objective_for_mesh(trial, mesh):
            mesh_ctx = mesh_ctxs.get(id(mesh))
            if mesh_ctx is None:
                mesh_ctx = dataclasses.replace(ctx, mesh=mesh)
                mesh_ctx._fold_cache = ctx._fold_cache
                mesh_ctxs[id(mesh)] = mesh_ctx
            return objective_kfold(trial, mesh_ctx)

        try:
            run_parallel_trials(study, objective_for_mesh, n_trials,
                                max_workers=parallel_workers,
                                verbose=verbose, devices=devices)
        finally:
            # free every worker's pool: the next stage uploads its own
            for mctx in mesh_ctxs.values():
                mctx.release_hbm_pool()
            stats = [m.hbm_pool_stats for m in mesh_ctxs.values()
                     if m.hbm_pool_stats is not None]
            if stats and ctx.hbm_pool_stats is None:
                ctx.hbm_pool_stats = {
                    "upload_bytes": sum(s["upload_bytes"] for s in stats),
                    "last_dropped": max(s["last_dropped"] for s in stats),
                    "n_worker_pools": len(stats)}
    else:
        try:
            study.optimize(lambda t: objective_kfold(t, ctx), n_trials,
                           callbacks=([progress_callback] if verbose
                                      else None),
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
