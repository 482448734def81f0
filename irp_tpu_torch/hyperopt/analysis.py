"""Study analysis + plots (the JAX package's ``hyperopt/analysis.py``).

Rebuild of the reference's Optuna analysis utilities (reference
functions/hyperopt.py:498-612 ``visualize_best_trial_metrics`` and
:615-752 ``enhanced_optuna_analysis``): best-trial epoch curves pulled back
from the tracking store, study statistics, hyperparameter importances, and
optimization-history / parallel-coordinate plots (matplotlib versions of
optuna.visualization's plotly figures).
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from irp_tpu_torch import tracking
from irp_tpu_torch.hyperopt.distributions import CategoricalDistribution
from irp_tpu_torch.hyperopt.study import Study, TrialState
from irp_tpu_torch.utils.viz import pyplot as _pyplot


def study_statistics(study: Study) -> Dict:
    trials = study.get_trials()
    states = [t.state for t in trials]
    stats: Dict = {
        "n_trials": len(trials),
        "n_complete": states.count(TrialState.COMPLETE),
        "n_pruned": states.count(TrialState.PRUNED),
        "n_failed": states.count(TrialState.FAILED),
    }
    try:
        best = study.best_trial
        stats["best_value"] = best.value
        stats["best_number"] = best.number
        stats["best_params"] = dict(best.params)
    except ValueError:
        pass
    return stats


def visualize_best_trial_metrics(study: Study, out_dir: str,
                                 client: Optional[object] = None) -> List[str]:
    """Epoch-curve plots for the best trial, read back from tracking
    (reference hyperopt.py:519-607: epoch_avg_val_acc +- std)."""
    os.makedirs(out_dir, exist_ok=True)
    best = study.best_trial
    run_id = best.user_attrs.get("tracking_run_id")
    if not run_id:
        print("Best trial has no tracking run id.")
        return []
    client = client or tracking.TrackingClient()
    avg = client.get_metric_history(run_id, "epoch_avg_val_acc")
    std = client.get_metric_history(run_id, "epoch_std_val_acc")
    if not avg:
        print("No epoch metrics found for the best trial.")
        return []
    std_by_step = {p.step: p.value for p in std}
    epochs = [p.step + 1 for p in avg]
    means = [p.value for p in avg]
    stds = [std_by_step.get(p.step, 0.0) for p in avg]

    from irp_tpu_torch.utils.viz import plot_epoch_mean_std

    path = plot_epoch_mean_std(
        epochs, means, stds,
        os.path.join(out_dir, "best_trial_epoch_curve.png"),
        title=f"Best trial {best.number}: cross-fold val acc")
    return [path]


def _param_importances(study: Study) -> Dict[str, float]:
    """Hyperparameter importances via a random-forest surrogate (fANOVA-
    style MDI) over completed trials; falls back to |spearman| when trials
    are too few.  Same role as optuna.importance (hyperopt.py:658-668)."""
    completed = [t for t in study.get_trials()
                 if t.state == TrialState.COMPLETE and t.value is not None
                 and math.isfinite(t.value)]
    if len(completed) < 4:
        return {}
    names = sorted({n for t in completed for n in t.params})
    rows, ys = [], []
    for t in completed:
        if set(names) - set(t.params):
            continue
        row = []
        for n in names:
            dist = t.distributions[n]
            row.append(dist.to_internal(t.params[n]))
        rows.append(row)
        ys.append(t.value)
    x = np.asarray(rows)
    y = np.asarray(ys)
    try:
        from sklearn.ensemble import RandomForestRegressor

        rf = RandomForestRegressor(n_estimators=64, random_state=0)
        rf.fit(x, y)
        imp = rf.feature_importances_
    except ImportError:  # no scikit-learn: rank correlations instead
        from scipy.stats import spearmanr

        imp = np.array([abs(spearmanr(x[:, i], y).statistic)
                        if len(set(x[:, i])) > 1 else 0.0
                        for i in range(x.shape[1])])
        imp = np.nan_to_num(imp)
        if imp.sum() > 0:
            imp = imp / imp.sum()
    return dict(sorted(zip(names, imp.tolist()), key=lambda kv: -kv[1]))


def plot_optimization_history(study: Study, path: str) -> str:
    plt = _pyplot()
    trials = [t for t in study.get_trials()
              if t.state == TrialState.COMPLETE and t.value is not None
              and math.isfinite(t.value)]
    xs = [t.number for t in trials]
    ys = [t.value for t in trials]
    acc = (np.minimum.accumulate if study.direction == "minimize"
           else np.maximum.accumulate)
    best_so_far = acc(ys) if ys else []
    plt.figure(figsize=(9, 5))
    plt.scatter(xs, ys, s=14, label="trial value")
    if len(xs):
        plt.step(xs, best_so_far, where="post", color="tab:red",
                 label="best so far")
    plt.xlabel("trial"); plt.ylabel("objective")
    plt.title("Optimization history")
    plt.legend(); plt.tight_layout()
    plt.savefig(path); plt.close()
    return path


def plot_param_importances(study: Study, path: str) -> str:
    plt = _pyplot()
    imp = _param_importances(study)
    plt.figure(figsize=(8, 4.5))
    if imp:
        names = list(imp)[::-1]
        vals = [imp[n] for n in names]
        plt.barh(names, vals)
    plt.xlabel("importance")
    plt.title("Hyperparameter importances")
    plt.tight_layout(); plt.savefig(path); plt.close()
    return path


def plot_parallel_coordinates(study: Study, path: str,
                              params: Optional[Sequence[str]] = None) -> str:
    plt = _pyplot()
    completed = [t for t in study.get_trials()
                 if t.state == TrialState.COMPLETE and t.value is not None
                 and math.isfinite(t.value)]
    plt.figure(figsize=(11, 5))
    if completed:
        names = params or sorted({n for t in completed for n in t.params})
        axes_vals = []
        for t in completed:
            row = []
            for n in names:
                d = t.distributions.get(n)
                if d is None:
                    row.append(np.nan)
                elif isinstance(d, CategoricalDistribution):
                    row.append(d.to_internal(t.params[n]) /
                               max(len(d.choices) - 1, 1))
                else:
                    lo, hi = d.internal_bounds
                    row.append((d.to_internal(t.params[n]) - lo) /
                               max(hi - lo, 1e-12))
            axes_vals.append(row)
        vals = np.asarray(axes_vals)
        objs = np.asarray([t.value for t in completed])
        lo, hi = objs.min(), objs.max()
        norm = (objs - lo) / max(hi - lo, 1e-12)
        cmap = plt.get_cmap("viridis")
        for row, c in zip(vals, norm):
            plt.plot(range(len(names)), row, color=cmap(c), alpha=0.5)
        plt.xticks(range(len(names)), names, rotation=30, ha="right")
        plt.ylabel("normalized value")
    plt.title("Parallel coordinates (color = objective)")
    plt.tight_layout(); plt.savefig(path); plt.close()
    return path


def enhanced_optuna_analysis(study: Study, out_dir: str,
                             verbose: bool = True) -> Dict:
    """Study stats + importances + the three standard plots
    (reference hyperopt.py:615-752)."""
    os.makedirs(out_dir, exist_ok=True)
    stats = study_statistics(study)
    if verbose:
        print("Study statistics:")
        for k, v in stats.items():
            print(f"  {k}: {v}")
    importances = _param_importances(study)
    if verbose and importances:
        print("Param importances:")
        for k, v in importances.items():
            print(f"  {k}: {v:.3f}")
    paths = {
        "history": plot_optimization_history(
            study, os.path.join(out_dir, "optimization_history.png")),
        "importances": plot_param_importances(
            study, os.path.join(out_dir, "param_importances.png")),
        "parallel": plot_parallel_coordinates(
            study, os.path.join(out_dir, "parallel_coordinates.png")),
    }
    return {"stats": stats, "importances": importances, "plots": paths}
