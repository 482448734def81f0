#!/usr/bin/env python3
"""Run a training cell as ``run.py --trace 1`` runs it, with the
program's spans (``irp_tpu_torch/utils/monitor.py``) on or off, and print
what they read.

    python3 benchmark/tools/spans.py --workload <cell> --seeds 1,2 \\
        [--spans 0,1,1,0] [--seconds 30] [--out spans.jsonl]

From the root of a checkout, on a card.  For each seed, one run for each
entry of ``--spans``, in this process and in that order: the cell's loop
(``loops/<kind>.py``) as it is, its hooks and its 16-step profiler
session included, and, where the entry is 1, ``monitor.tracing()`` over
the window (device times from CUDA events).  The spans are on in the
session whatever the entry, as in any run under a profiler, and its
events are read by ``benchmark/spans.py``.  Each run prints one JSON
line and appends it to ``--out``: the window's images/s (hooks on, as in
any traced run), ``correct``, the cell's per-layer metrics, the number
of ``train.*`` ranges in the profile, the idle gaps as
``breakdown.idle_gaps`` names them, and with spans on ``frozen_forward_ms`` (the frozen prefix's
device ms a step over the window), ``launches_per_step`` and
``step_idle_ms`` (the session's device kernels and copies launched, and
its idle ms, inside ``train.step``), each span's mean device and host
self ms beside the hooks' split, idle ms by span, and device ms a step
by span and kernel group (``kernel_groups.json``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@contextlib.contextmanager
def _patched(loop, spans_on: bool, device, got: dict):
    """For one run of ``loop``: spans on over its window (from its hooks'
    installation to its profiler session), and the session's events kept
    in ``got``."""
    from benchmark import tracing
    from irp_tpu_torch.utils import monitor

    window = contextlib.ExitStack()
    real = (loop._hooks, tracing.traced, tracing.reduce_events)

    def hooks(state, marks):
        if spans_on:
            got["window"] = window.enter_context(
                monitor.tracing(device=device))
        return real[0](state, marks)

    def traced(dev):
        window.close()
        return real[1](dev)

    def reduce_events(events):
        got["events"] = events
        return real[2](events)

    loop._hooks, tracing.traced, tracing.reduce_events = (hooks, traced,
                                                          reduce_events)
    try:
        yield
    finally:
        window.close()
        loop._hooks, tracing.traced, tracing.reduce_events = real


def one(cell, spans_on: bool) -> dict:
    """One run of ``cell`` (loaded with ``trace=True``)."""
    from torch.autograd import DeviceType

    from benchmark import harness, spans
    from benchmark.loops import common

    loop = harness.loop(cell)
    got: dict = {}
    with _patched(loop, spans_on, cell.device, got):
        record = loop.run(cell)
    events = got.pop("events", [])
    out = {"workload": cell.name, "seed": cell.seed,
           "spans_on": int(spans_on),
           "window_images_per_s": record["images"] / record["window_s"],
           "correct": harness.judge(cell, record["checks"]),
           "metrics": {m["name"]: harness.reader(cell, m["name"])(record)
                       for m in cell.metrics},
           "train_ranges_in_profile": sum(
               1 for e in events if e.device_type == DeviceType.CPU
               and e.name.startswith("train.")),
           "idle_gaps": (record["profile"] or {}).get("idle_gaps")}
    if spans_on:
        window = got["window"]
        hook = {part: sum(v) / len(v) if v else None
                for part, v in record["hook_ms"].items()}
        out["frozen_forward_ms"] = spans.per_step_ms(
            window, "train.forward.frozen")
        out["by_span"] = {name: {**s, "hook_ms": hook.get(
            name.split(".", 1)[1])} for name, s in
            spans.summary(window).items()}
        out["session"] = spans.attribute(events, {
            e.name for e in events if e.device_type == DeviceType.CPU
            and e.name.startswith("train.")})
        out["launches_per_step"] = out["session"]["launches_per_step"]
        out["step_idle_ms"] = out["session"]["step_idle_ms"]
    del events, record
    common.free(cell.device)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--spans", default="0,1,1,0")
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import harness, run
    from benchmark.tools.repeat import card

    run._environment()
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        seconds = args.seconds or json.load(f)["run_seconds"]
    print(f"card: {card()}", file=sys.stderr, flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        for on in (s == "1" for s in args.spans.split(",")):
            cell = harness.load_cell(args.workload, seed, seconds, True,
                                     args.device, ROOT, time.perf_counter())
            line = json.dumps(one(cell, on))
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    found = harness.forbidden_modules()
    if found:
        print(f"error: loaded: {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
