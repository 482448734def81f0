"""The benchmark's core: find a cell's files by name, run its traffic's
loop, read its metrics, judge its outputs, and print the result.

Everything that belongs to one configuration, one traffic mix, one cell's
limits or one metric is a file of its own under the benchmark's folder,
found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the model as it is run;
- ``traffic/<traffic>.json``: the mix's parameters; its ``kind`` names
  the loop, ``loops/<kind>.py``, a general generator of that kind of
  load;
- ``limits/<cell>.json``: the limit of each number the cell's
  correctness check compares;
- ``metrics/<metric>.py``: ``read(record)``, the metric's value from the
  run's record, or None where the record holds nothing to read.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
# top-level module names no process of the benchmark may hold: JAX and
# the JAX package (the port's own name starts with it, so names are
# compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "irp_tpu")


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: this
    process's ``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _load_json(path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A cell with its files read, and how this run is to drive it."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    metrics: list  # the manifest's metric entries this run reports
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    bench_dir: str = BENCH_DIR


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, seed: int, seconds: float, trace: bool,
              device: str = "cuda", root: str | None = None,
              t_start: float | None = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` (root: the folder
    above the benchmark's), its files read."""
    root = root or os.path.dirname(BENCH_DIR)
    manifest = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(known: {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    bench_dir = os.path.join(root, os.path.basename(BENCH_DIR))
    config = _load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(bench_dir, "traffic",
                                      f"{w['traffic']}.json"))
    limits = _load_json(os.path.join(bench_dir, "limits", f"{name}.json"))
    section = "per_layer" if trace else "end_to_end"
    metrics = [m for m in manifest[section] if _applies(m, name)]
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic,
                limits=limits, metrics=metrics, seed=int(seed),
                seconds=float(seconds), trace=bool(trace), device=device,
                t_start=time.perf_counter() if t_start is None else t_start,
                bench_dir=bench_dir)


def _import_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(cell: Cell, metric: str):
    """``metrics/<metric>.py``'s ``read``."""
    path = os.path.join(cell.bench_dir, "metrics", f"{metric}.py")
    return _import_file(path, "_bench_metric_"
                        + metric.replace(".", "_").replace("-", "_")).read


def loop(cell: Cell):
    """The module of the traffic's kind: ``loops/<kind>.py``."""
    kind = cell.traffic["kind"]
    return importlib.import_module(f"benchmark.loops.{kind}")


def device_info(cell: Cell, record: dict) -> dict:
    import torch

    if cell.device == "cpu":
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": cell.chips,
                "memory_peak_bytes": int(record["memory_peak_bytes"])}
    prof = record.get("profile")
    if cell.trace and prof is not None:
        info["busy_s"] = prof["busy_s"]
        info["window_s"] = prof["window_s"]
    return info


def judge(cell: Cell, checks: dict) -> bool:
    """Whether every number that has a limit is a number within it."""
    return all(k in checks and isinstance(checks[k], (int, float))
               and math.isfinite(checks[k]) and checks[k] <= limit
               for k, limit in cell.limits.items())


def run(cell: Cell) -> dict:
    """Drive the cell and return its result line (a dict)."""
    record = loop(cell).run(cell)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or of the JAX package are "
                           f"loaded: {found}")
    metrics = {}
    for m in cell.metrics:
        value = reader(cell, m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = record["checks"]
    result = {"correct": judge(cell, checks),
              "attempted": int(record["attempted"]),
              "failed": int(record["failed"]),
              "metrics": metrics,
              "device": device_info(cell, record)}
    if cell.trace and record.get("profile") is not None:
        prof = record["profile"]
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["notes"] = dict(record.get("notes", {}))
    # numbers the cell reads but does not compare (no limit separates its
    # sound runs from the control and the faults; PERF.md gives why)
    result["notes"].update({f"{k} (not compared)": v
                            for k, v in checks.items()
                            if k not in cell.limits})
    result["checks"] = {k: {"value": checks.get(k), "limit": limit}
                        for k, limit in cell.limits.items()}
    return result


def print_result(result: dict, out=None, err=None) -> None:
    """The checks, each beside its limit, as the last lines on standard
    error; the result as the last line on standard output."""
    out = out or sys.stdout
    err = err or sys.stderr
    for k, v in result.get("notes", {}).items():
        print(f"note {k}: {json.dumps(v)}", file=err, flush=True)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=err,
              flush=True)
    line = {k: v for k, v in result.items() if k != "notes"}
    print(json.dumps(line), file=out, flush=True)
