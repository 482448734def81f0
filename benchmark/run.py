#!/usr/bin/env python3
"""Run one cell of the benchmark of ``irp_tpu_torch`` on this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared with its limit; the same numbers as the
last lines of standard error.  Exits non-zero, printing no result, when
there is no CUDA device or fewer than the cell needs, when the program
is missing, or when JAX or the JAX package is loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "benchmark_cache")


def _environment() -> None:
    """Keep every cache of the program inside the checkout, at fixed
    paths, and keep libraries from loading JAX."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()
    from benchmark import harness

    found = harness.forbidden_modules()
    if found:
        print(f"error: loaded before the run: {found}", file=sys.stderr)
        return 3
    import torch

    cell = harness.load_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), "cuda", ROOT, T_START)
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"error: {args.workload} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = harness.run(cell)  # raises if JAX was loaded meanwhile
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
