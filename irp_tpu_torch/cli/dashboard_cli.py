#!/usr/bin/env python
"""Terminal dashboard for studies and tracking runs (the JAX package's
``cli/dashboard_cli.py``), read-only, over the port's SQLite study
storage and tracking directory (both the JAX package's formats, so it
reads what either package wrote).  The output is the JAX CLI's.

Usage:
  python -m irp_tpu_torch.cli.dashboard_cli study
      [--storage optuna_animals10_kfold.db] [--study-name animals10_kfold]
      [--top 10]
  python -m irp_tpu_torch.cli.dashboard_cli runs [--experiment animals10]
      [--limit 20]
  python -m irp_tpu_torch.cli.dashboard_cli run RUN_ID
      [--experiment animals10]
"""

from __future__ import annotations

import argparse
import math
import os
import sys

SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values, width: int = 40) -> str:
    vals = [v for v in values if v is not None and math.isfinite(v)]
    if not vals:
        return ""
    if len(vals) > width:  # downsample to width buckets (max-preserving)
        step = len(vals) / width
        vals = [max(vals[int(i * step):max(int(i * step) + 1,
                                           int((i + 1) * step))])
                for i in range(width)]
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(SPARK[int((v - lo) / span * (len(SPARK) - 1))]
                   for v in vals)


def fmt_value(v) -> str:
    if isinstance(v, float):
        return f"{v:.5g}"
    return str(v)


def show_study(args) -> int:
    from irp_tpu_torch.hyperopt import create_study
    from irp_tpu_torch.hyperopt.analysis import (_param_importances,
                                           study_statistics)
    from irp_tpu_torch.hyperopt.storage import SQLiteStorage
    from irp_tpu_torch.hyperopt.study import TrialState

    if not os.path.exists(args.storage):
        print(f"No study storage at {args.storage}", file=sys.stderr)
        return 2
    # a VIEWER must not mutate the store: no study creation on a typo'd
    # name, and no orphan-failing of live workers' RUNNING trials
    storage = SQLiteStorage(args.storage)
    if storage.find_study(args.study_name) is None:
        print(f"No study named {args.study_name!r} in {args.storage}",
              file=sys.stderr)
        return 2
    study = create_study(study_name=args.study_name, storage=storage,
                         load_if_exists=True, fail_orphans=False)
    stats = study_statistics(study)
    print(f"Study: {args.study_name}  ({args.storage})")
    print(f"  trials: {stats['n_trials']}  complete: "
          f"{stats['n_complete']}  pruned: {stats['n_pruned']}  "
          f"failed: {stats['n_failed']}")
    if "best_value" in stats:
        print(f"  best: trial {stats['best_number']}  "
              f"value {stats['best_value']:.4f}")
        for k, v in stats["best_params"].items():
            print(f"    {k}: {fmt_value(v)}")

    completed = [t for t in study.get_trials()
                 if t.state == TrialState.COMPLETE and t.value is not None
                 and math.isfinite(t.value)]
    if completed:
        history = [t.value for t in sorted(completed,
                                           key=lambda t: t.number)]
        print(f"\n  optimization history ({len(history)} completed):")
        print(f"    {sparkline(history)}")
        print(f"    min {min(history):.4f}  max {max(history):.4f}")

        print(f"\n  top {min(args.top, len(completed))} trials:")
        ranked = sorted(completed, key=lambda t: t.value,
                        reverse=study.direction == "maximize")
        names = sorted({n for t in completed for n in t.params})
        header = "    #     value  " + "  ".join(f"{n[:14]:>14}"
                                                 for n in names)
        print(header)
        for t in ranked[:args.top]:
            row = f"    {t.number:<4} {t.value:8.4f}  "
            row += "  ".join(f"{fmt_value(t.params.get(n, '-')):>14}"
                             for n in names)
            print(row)

    imps = _param_importances(study)
    if imps:
        print("\n  param importances:")
        top = max(imps.values()) or 1.0
        for name, imp in sorted(imps.items(), key=lambda kv: -kv[1]):
            bar = "#" * max(1, int(imp / top * 30))
            print(f"    {name:<26} {imp:6.3f}  {bar}")
    return 0


def show_runs(args) -> int:
    from irp_tpu_torch.tracking import TrackingClient

    client = TrackingClient()
    if client.get_experiment_by_name(args.experiment) is None:
        print(f"No experiment '{args.experiment}'", file=sys.stderr)
        return 2
    runs = client.search_runs(args.experiment)
    # newest first — run ids are random hex, so directory order is noise
    runs.sort(key=lambda r: int(r["info"].get("start_time", 0) or 0),
              reverse=True)
    runs = runs[:args.limit]
    print(f"Experiment: {args.experiment}  ({len(runs)} shown)")
    for run in runs:
        info = run["info"]
        metrics = run.get("metrics", {})
        key_metrics = "  ".join(
            f"{k}={fmt_value(v)}" for k, v in sorted(metrics.items())
            if any(s in k for s in ("acc", "loss")))[:80]
        print(f"  {info.get('run_id', '?')[:12]}  "
              f"{info.get('status', '?'):<9} "
              f"{info.get('run_name', '')[:32]:<32} {key_metrics}")
    return 0


def show_run(args) -> int:
    from irp_tpu_torch.tracking import TrackingClient

    client = TrackingClient()
    try:
        # histories are read in full below; skip get_run's own parse of
        # every metric file
        run = client.get_run(args.run_id, include_metrics=False)
    except Exception:
        print(f"No run '{args.run_id}'", file=sys.stderr)
        return 2
    info = run["info"]
    print(f"Run {args.run_id}  "
          f"({info.get('run_name', '')}, {info.get('status', '?')})")
    if run.get("params"):
        print("  params:")
        for k, v in sorted(run["params"].items()):
            print(f"    {k}: {v}")
    histories = client.get_metric_histories(args.run_id)
    if histories:
        print("  metrics (latest, with history):")
        for k in sorted(histories):
            vals = [p.value for p in histories[k]]
            if vals:
                print(f"    {k:<24} {fmt_value(vals[-1]):>10}  "
                      f"{sparkline(vals, 30)}")
    artifacts = client.list_artifacts(args.run_id)
    if artifacts:
        print("  artifacts:")
        for a in artifacts:
            print(f"    {a}")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("study", help="study summary (optuna-dashboard "
                                      "equivalent)")
    ps.add_argument("--storage", default="optuna_animals10_kfold.db")
    ps.add_argument("--study-name", default="animals10_kfold")
    ps.add_argument("--top", type=int, default=10)
    ps.set_defaults(fn=show_study)

    pr = sub.add_parser("runs", help="list tracking runs (mlflow ui "
                                     "equivalent)")
    pr.add_argument("--experiment", default="animals10")
    pr.add_argument("--limit", type=int, default=20)
    pr.set_defaults(fn=show_runs)

    p1 = sub.add_parser("run", help="one run's params/metrics/artifacts")
    p1.add_argument("run_id")
    p1.add_argument("--experiment", default="animals10")
    p1.set_defaults(fn=show_run)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
