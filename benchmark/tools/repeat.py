#!/usr/bin/env python3
"""Run a cell several times, each run a process of its own, and keep
every result line.

    python3 benchmark/tools/repeat.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 30] [--trace 0] [--out runs.jsonl]

From the root of a checkout.  Each run is ``benchmark/run.py`` with one
seed; its exit code, wall time, result and the end of its standard error
go as one JSON line to ``--out``.  A summary of each metric and check
(median, quartiles, spread) is printed at the end.  ``--seconds``
defaults to ``run_seconds`` of ``BENCHMARK.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def one(workload, seed, seconds, trace, timeout):
    cmd = [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
           "--workload", workload, "--seed", str(seed), "--seconds",
           str(seconds), "--trace", str(trace)]
    t = time.perf_counter()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                           timeout=timeout)
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or "", e.stderr or ""
        out = out.decode() if isinstance(out, bytes) else out
        err = err.decode() if isinstance(err, bytes) else err
    wall = time.perf_counter() - t
    lines = out.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return {"workload": workload, "seed": seed, "trace": trace, "rc": rc,
            "wall_s": wall, "result": result, "stderr_tail": err[-3000:]}


def spread(values):
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return {"median": q2, "q1": q1, "q3": q3,
            "spread": (q3 - q1) / abs(q2) if q2 else None}


def summary(runs):
    by = {}
    for r in runs:
        res = r["result"] or {}
        for k, m in res.get("metrics", {}).items():
            by.setdefault(k, []).append(m["value"])
        for k, c in res.get("checks", {}).items():
            by.setdefault("check." + k, []).append(c["value"])
    return {k: {"values": v, **(spread(v) or {})} for k, v in by.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--timeout", type=float, default=1200)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        seconds = args.seconds or json.load(f)["run_seconds"]
    print(f"card: {card()}", flush=True)
    runs = []
    for seed in (int(s) for s in args.seeds.split(",")):
        r = one(args.workload, seed, seconds, args.trace, args.timeout)
        runs.append(r)
        res = r["result"] or {}
        print(json.dumps({"seed": seed, "rc": r["rc"],
                          "wall_s": round(r["wall_s"], 1),
                          "correct": res.get("correct"),
                          "metrics": {k: m["value"] for k, m in
                                      res.get("metrics", {}).items()},
                          "checks": {k: c["value"] for k, c in
                                     res.get("checks", {}).items()}}),
              flush=True)
        if r["rc"] != 0 or not res:
            print(r["stderr_tail"][-1500:], flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(r) + "\n")
    print(json.dumps({"summary": summary(runs)}), flush=True)
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
