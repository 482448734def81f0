#!/usr/bin/env python3
"""Read the correctness check's upper end: the control and the planted
faults, at a cell's own size, on several seeds.

    python3 benchmark/tools/control.py --workload <cell> --seeds 1,2,3 \\
        [--device cuda]

From the root of a checkout.  The control is the plain reference put in
the program's place and computed one precision below the
configuration's bfloat16: every operand of a convolution or matrix
product rounded to float8 e4m3 (``reference/precision.py``).  Its numbers
are the cell's check's numbers, taken against the float32 reference on
the run's own inputs.  The half-batch fault (each step on half its
batch, the loss the mean over that half) is read the same way; a step
that leaves its state unchanged reads 1 by the measure and needs no
run.  Prints one JSON line per seed and reading, with whether the
harness would judge it correct.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def train_readings(cell) -> list:
    from benchmark.loops import train
    from benchmark.reference import train as ref_train

    cfg, tr, dev = cell.config["model"], cell.traffic, cell.device
    images, labels, cw, w0, seeds = train.inputs(cell)
    k = tr["checked_steps"]
    ref = ref_train.follow(cfg, tr, w0, images, labels, cw, seeds, k, dev)
    out = []
    for name, kw in (("control_fp8", {"precision": "fp8"}),
                     ("fault_half_batch", {"half_batch": True})):
        got = ref_train.follow(cfg, tr, w0, images, labels, cw, seeds, k,
                               dev, **kw)
        checks, notes = train.compare(got, ref)
        out.append({"reading": name, "checks": checks,
                    "widest": {n: notes[n][:2] for n in notes
                               if n.startswith("widest")}})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import harness

    for seed in (int(s) for s in args.seeds.split(",")):
        cell = harness.load_cell(args.workload, seed, 1.0, False,
                                 args.device, ROOT)
        for r in train_readings(cell):
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "correct": harness.judge(cell, r["checks"]),
                              **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
