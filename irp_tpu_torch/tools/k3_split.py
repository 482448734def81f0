#!/usr/bin/env python
"""Where the fused distance + top-k kernel spends its time, on the card.

Writes two copies of ``csrc/pairwise_topk.cu`` into
``build/irp_tpu_torch/k3_split/`` (the kernel's own source is not
touched) and builds them with the port's nvcc flags:

- ``distances_only``: the same kernels with the per-row merges never
  entered (their conditions gain ``k < 0``, which no launch meets and
  the compiler cannot rule out), so it computes the row bounds and every
  distance and key and keeps nothing;
- ``counters``: the kernel with clock64() counters, which give, per warp
  and averaged over the warps, the cycles spent waiting for a tile
  (``wait``), computing its distances (``fma``), in the selection
  (``select``) and in all, and the merge rounds and offered keys
  (``turns``) the selection ran.  The counters cost time of their own, so
  their split is a share, not a time.

For one row block of each kNN of the curation path (1024 rows against
26,179 points at D = 50, k = 15 and at D = 2, k = 75; 1024 rows against
2,618 points at D = 2, k = 30), with points from a seeded generator, it
times the kernel as shipped and ``distances_only`` in turns (shipped,
distances only, distances only, shipped) and prints one JSON line per
shape with the counters' split.

  python -m irp_tpu_torch.tools.k3_split
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import torch
import torch.nn.functional as F

from irp_tpu_torch import _kernels
from irp_tpu_torch.ops.cuda_image import pairwise_topk
from irp_tpu_torch.tools.bench_fused_block import gpu_ms, n_sets

# (name, M, N, D, k): one row block of each kNN of the curation path
SHAPES = (("umap", 1024, 26_179, 50, 15), ("lof_global", 1024, 26_179, 2, 75),
          ("lof_class", 1024, 2618, 2, 30))
OUT_DIR = os.path.join(_kernels.BUILD_DIR, "k3_split")
COUNTERS = ("rounds", "turns", "wait", "fma", "select", "total", "warps")

_MERGE = "      if (__any_sync(0xffffffffu, more)) {\n"
_FLUSH = "    if (__any_sync(0xffffffffu, held[i] != kNone))\n"
# (anchor in the kernel's source, what replaces it), per variant; every
# anchor must occur exactly once
_PATCHES = {
    "distances_only": (
        (_MERGE, _MERGE.replace("more)", "more && k < 0)")),
        (_FLUSH, _FLUSH.replace("kNone)", "kNone && k < 0)"))),
    "counters": (
        ("namespace {\n\nconstexpr int kThreads",
         "__device__ unsigned long long g_k3[8];\n"
         "namespace {\n\nconstexpr int kThreads"),
        ("  while (__any_sync(0xffffffffu, pending != 0)) {\n",
         "  while (__any_sync(0xffffffffu, pending != 0)) {\n"
         "    if ((threadIdx.x & 31) == 0) atomicAdd(&g_k3[0], 1ull);\n"),
        ("    for (int t = 0; t < turns; ++t) {",
         "    if ((threadIdx.x & 31) == 0)\n"
         "      atomicAdd(&g_k3[1], static_cast<unsigned long long>(turns));\n"
         "    for (int t = 0; t < turns; ++t) {"),
        ("  for (int t = t0; t < t1; ++t) {\n    cp_async_wait<1>();\n"
         "    __syncthreads();\n",
         "  long long c_wait = 0, c_fma = 0, c_sel = 0, c_all = clock64();\n"
         "  for (int t = t0; t < t1; ++t) {\n    long long c0 = clock64();\n"
         "    cp_async_wait<1>();\n    __syncthreads();\n"
         "    c_wait += clock64() - c0;\n    c0 = clock64();\n"),
        ("    // selection, row by row (select_row)\n",
         "    c_fma += clock64() - c0;\n    c0 = clock64();\n"
         "    // selection, row by row (select_row)\n"),
        ("      }\n    }\n  }\n  cp_async_wait<0>();\n  // the keys still held\n",
         "      }\n    }\n    c_sel += clock64() - c0;\n  }\n"
         "  cp_async_wait<0>();\n  const long long c_flush = clock64();\n"
         "  // the keys still held\n"),
        ("  // this split's sorted lists, rows past m dropped\n",
         "  c_sel += clock64() - c_flush;\n"
         "  c_all = clock64() - c_all;\n"
         "  if ((threadIdx.x & 31) == 0) {\n"
         "    atomicAdd(&g_k3[2], static_cast<unsigned long long>(c_wait));\n"
         "    atomicAdd(&g_k3[3], static_cast<unsigned long long>(c_fma));\n"
         "    atomicAdd(&g_k3[4], static_cast<unsigned long long>(c_sel));\n"
         "    atomicAdd(&g_k3[5], static_cast<unsigned long long>(c_all));\n"
         "    atomicAdd(&g_k3[6], 1ull);\n  }\n"
         "  // this split's sorted lists, rows past m dropped\n"),
        ('extern "C" {\n',
         'extern "C" {\n\n'
         "// the counters to host (reset: zero them instead)\n"
         "int irp_k3_counters(unsigned long long* host, int reset) {\n"
         "  if (reset) {\n    const unsigned long long zero[8] = {0};\n"
         "    return static_cast<int>(cudaMemcpyToSymbol(g_k3, zero, "
         "sizeof(zero)));\n  }\n"
         "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_k3, "
         "8 * sizeof(unsigned long long)));\n}\n"),
    ),
}


def stamped_source(variant: str) -> str:
    with open(os.path.join(_kernels.CSRC_DIR, "pairwise_topk.cu")) as f:
        src = f.read()
    for anchor, repl in _PATCHES[variant]:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor for {variant!r} not found once in "
                               f"csrc/pairwise_topk.cu: {anchor[:60]!r}")
        src = src.replace(anchor, repl)
    return src


def build() -> dict:
    """Both variants, built in parallel; {name: ctypes library}."""
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for variant in _PATCHES:
        src = os.path.join(OUT_DIR, f"{variant}.cu")
        with open(src, "w") as f:
            f.write(stamped_source(variant))
        lib = os.path.join(OUT_DIR, f"lib{variant}.so")
        procs[variant] = (lib, subprocess.Popen(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for variant, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {variant}:\n{log}")
        lib = ctypes.CDLL(path)
        for fn, (restype, argtypes) in _kernels.SIGNATURES[
                "pairwise_topk"].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        lib.irp_cuda_error_string.restype = ctypes.c_char_p
        lib.irp_cuda_error_string.argtypes = [ctypes.c_int]
        libs[variant] = lib
    libs["counters"].irp_k3_counters.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_int]
    return libs


def _call(lib, a, b, a_sq, b_sq, k: int) -> None:
    """One launch of a variant, as ``pairwise_topk`` launches the shipped
    kernel (self_offset 0)."""
    m, dp = a.shape
    n = b.shape[0]
    splits = lib.irp_pairwise_topk_splits(m, n, dp, k)
    part = torch.empty((splits, m, k), dtype=torch.int64, device=a.device)
    bound = torch.empty((m, k), dtype=torch.int32, device=a.device)
    out_d = torch.empty((m, k), dtype=torch.float32, device=a.device)
    out_i = torch.empty((m, k), dtype=torch.int32, device=a.device)
    code = lib.irp_pairwise_topk(
        a.data_ptr(), b.data_ptr(), a_sq.data_ptr(), b_sq.data_ptr(),
        part.data_ptr(), bound.data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(), m, n, dp, k, 0, splits,
        _kernels.stream_handle(a.device))
    _kernels.check(lib, code, "k3_split variant")


def split(libs: dict, name: str, m: int, n: int, d: int, k: int,
          gen: torch.Generator) -> dict:
    dp = -(-d // 4) * 4
    sets = []
    for _ in range(n_sets((n * dp + n) * 4 + m * n * 4)):
        b = F.pad(torch.randn(n, d, generator=gen), (0, dp - d)).cuda()
        b_sq = (b * b).sum(dim=1)
        sets.append((b[:m], b, b_sq[:m], b_sq))
    shipped = [lambda s=s: pairwise_topk(s[0], s[1], k, s[2], s[3],
                                         self_offset=0) for s in sets]
    dist_only = [lambda s=s: _call(libs["distances_only"], *s, k)
                 for s in sets]
    turns = [gpu_ms(shipped), gpu_ms(dist_only), gpu_ms(dist_only),
             gpu_ms(shipped)]
    lib = libs["counters"]
    host = (ctypes.c_ulonglong * 8)()
    torch.cuda.synchronize()
    _kernels.check(lib, lib.irp_k3_counters(None, 1), "counters reset")
    _call(lib, *sets[0], k)
    torch.cuda.synchronize()
    _kernels.check(lib, lib.irp_k3_counters(host, 0), "counters read")
    warps = max(host[6], 1)
    per_warp = {key: host[i] / warps for i, key in enumerate(COUNTERS[:6])}
    return {"case": name, "shape": f"({m},{d}) x ({n},{d}) f32, k={k}",
            "ms": (turns[0] + turns[3]) / 2,
            "distances_only_ms": (turns[1] + turns[2]) / 2,
            "turns_shipped_dist_dist_shipped": turns,
            "warps": host[6], "per_warp": per_warp,
            "select_share": per_warp["select"] / max(per_warp["total"], 1)}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k3_split: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    libs = build()
    gen = torch.Generator().manual_seed(args.seed)
    rows = []
    for shape in SHAPES:
        row = split(libs, *shape, gen)
        row["nvidia_smi"] = smi
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
