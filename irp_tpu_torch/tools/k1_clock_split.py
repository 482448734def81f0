#!/usr/bin/env python
"""Per-phase clock64() split of the fused identity bottleneck kernel, on
the card.

Writes a copy of ``csrc/identity_bottleneck.cu`` with clock64() counters
into ``build/irp_tpu_torch/clock_split/`` (the kernel's own source is not
touched), builds it with the port's nvcc flags, runs it once at each
ResNet50 shape at B=32 and B=256 and prints one JSON line per shape: the
cycles per block, averaged over the blocks, that consumer thread 0 spent
in each phase, and inside each phase waiting for a full ring stage
(``wait``) and in the GEMM's wgmma (``mma``: from issue to completion in
phase 3; in phases 1 and 2, whose wgmma overlap the next stage's loads,
the GEMM's time less its waits);
the rest of a phase is its epilogue, split for phase 3 into staging
(bias, bf16 round, shared-memory writes) and storing (residual add and
global stores); and the producer thread's wait for an empty stage.  The
counters cost a little time of their own, so the split is a share, not a
time.

  python -m irp_tpu_torch.tools.k1_clock_split
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import numpy as np
import torch

from irp_tpu_torch import _kernels
from irp_tpu_torch.tools.bench_fused_block import SHAPES, random_identity_block

COUNTERS = ("wait1", "wait2", "wait3", "gemm1", "gemm2", "mma3", "phase1",
            "phase2", "phase3", "epi3_stage", "epi3_store", "producer_wait",
            "producer_total")
OUT_DIR = os.path.join(_kernels.BUILD_DIR, "clock_split")

# (anchor in the kernel's source, what replaces it); every anchor must
# occur exactly once (``count`` times where given)
_PATCHES = (
    ("namespace {\n\ntypedef",
     "__device__ long long g_clk[1024][16];\nnamespace {\n\ntypedef"),
    ("""  auto acquire = [&]() -> uint32_t {
    mbar_wait(full0 + 8 * next_full.stage, next_full.phase);""",
     """  long long clk[16] = {0};
  int cur = 0;
  long long tph = 0;
  auto acquire = [&]() -> uint32_t {
    const long long t_w = clock64();
    mbar_wait(full0 + 8 * next_full.stage, next_full.phase);
    clk[cur] += clock64() - t_w;"""),
    ("    consumer_sync();  // the previous unit's phase 2 is done with `a`\n",
     "    consumer_sync();  // the previous unit's phase 2 is done with `a`\n"
     "    cur = 0; tph = clock64();\n"),
    ("        gemm_stages<N1>(\n",
     "        const long long t_g1 = clock64();\n        gemm_stages<N1>(\n"),
    ("              release();\n            });\n",
     "              release();\n            });\n"
     "        clk[3] += clock64() - t_g1;\n"),
    ("    consumer_sync();  // `a` is complete\n",
     "    clk[6] += clock64() - tph;\n"
     "    consumer_sync();  // `a` is complete\n"),
    ("      uint32_t bm[M / 4];  // bmap as A fragments: k16 block kb in "
     "[4kb, 4kb+4)\n",
     "      uint32_t bm[M / 4];\n      cur = 1; tph = clock64();\n"),
    ("        gemm_stages<N2>(\n",
     "        const long long t_g2 = clock64();\n        gemm_stages<N2>(\n"),
    ("            release);\n",
     "            release);\n        clk[4] += clock64() - t_g2;\n"),
    ("      const int wtid = threadIdx.x % 128;\n      long long goff[4];\n",
     "      clk[7] += clock64() - tph; cur = 2; tph = clock64();\n"
     "      const int wtid = threadIdx.x % 128;\n      long long goff[4];\n"),
    ("""          reg_fence(acc);
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int kb = 4 * kc + s;""",
     """          const long long t_m = clock64();
          reg_fence(acc);
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int kb = 4 * kc + s;"""),
    ("""          for (int i = 0; i < 16; ++i) reg_fence(bm[16 * kc + i]);
          if (kc + 1 < M / kKC) release();""",
     """          for (int i = 0; i < 16; ++i) reg_fence(bm[16 * kc + i]);
          clk[5] += clock64() - t_m;
          if (kc + 1 < M / kKC) release();"""),
    ("          const int col0 = n3c * N3 + 64 * j;\n",
     "          const int col0 = n3c * N3 + 64 * j;\n"
     "          long long t_e = clock64();\n"),
    ("          warpgroup_sync(wg);\n          uint4 yv[4];",
     "          warpgroup_sync(wg);\n"
     "          clk[9] += clock64() - t_e; t_e = clock64();\n"
     "          uint4 yv[4];"),
    ("          warpgroup_sync(wg);  // the staging rows are free again\n",
     "          warpgroup_sync(wg);  // the staging rows are free again\n"
     "          clk[10] += clock64() - t_e;\n"),
    ("""        asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
        release();
      }
""", """        asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
        release();
      }
      clk[8] += clock64() - tph;
"""),
    # the consumer's counters out, by thread 0, at the end of consume
    ("""        release();
      }
      clk[8] += clock64() - tph;
    }
  }
}
""", """        release();
      }
      clk[8] += clock64() - tph;
    }
  }
  if (threadIdx.x == 0)
    for (int i = 0; i < 11; ++i) g_clk[blockIdx.x][i] = clk[i];
}
"""),
    # the producer's
    ("""  Ring ring;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Unit t = unit_at(p, u);
    const int px0""", """  Ring ring;
  long long pw = 0;
  const long long pt0 = clock64();
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Unit t = unit_at(p, u);
    const int px0"""),
    ("          mbar_wait(empty0 + 8 * ring.stage, ring.phase ^ 1u);",
     "          { const long long t_p = clock64();"
     " mbar_wait(empty0 + 8 * ring.stage, ring.phase ^ 1u);"
     " pw += clock64() - t_p; }", 3),
    ("""          ring.next(p.stages);
        }
    }
  }
}""", """          ring.next(p.stages);
        }
    }
  }
  g_clk[blockIdx.x][11] = pw;
  g_clk[blockIdx.x][12] = clock64() - pt0;
}"""),
    ("const char* irp_cuda_error_string(int code) {",
     """int irp_k1_clocks(void* dst) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_clk, sizeof(g_clk)));
}

const char* irp_cuda_error_string(int code) {"""),
)


def stamped_source() -> str:
    """The kernel's source with the counters patched in."""
    with open(os.path.join(_kernels.CSRC_DIR, "identity_bottleneck.cu")) as f:
        src = f.read()
    for patch in _PATCHES:
        old, new = patch[:2]
        count = patch[2] if len(patch) > 2 else 1
        if src.count(old) != count:
            raise RuntimeError("the kernel's source changed: update "
                               f"k1_clock_split's anchor {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build() -> ctypes.CDLL:
    os.makedirs(OUT_DIR, exist_ok=True)
    src = os.path.join(OUT_DIR, "identity_bottleneck_clk.cu")
    lib = os.path.join(OUT_DIR, "libidentity_bottleneck_clk.so")
    with open(src, "w") as f:
        f.write(stamped_source())
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", lib, src],
                   check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(lib)
    restype, argtypes = _kernels.SIGNATURES["identity_bottleneck"][
        "irp_identity_bottleneck"]
    dll.irp_identity_bottleneck.restype = restype
    dll.irp_identity_bottleneck.argtypes = argtypes
    dll.irp_k1_clocks.argtypes = [ctypes.c_void_p]
    dll.irp_cuda_error_string.restype = ctypes.c_char_p
    dll.irp_cuda_error_string.argtypes = [ctypes.c_int]
    return dll


def split(dll, b, h, w, c, m, gen) -> dict:
    """One launch at (b, h, w, c, m); mean counters over the blocks."""
    from irp_tpu_torch.ops.cuda_resnet import bottleneck_plan

    weights = random_identity_block(c, m, gen).folded_weights()
    x = torch.randn(b, h, w, c, generator=gen).to(torch.bfloat16).cuda()
    out = torch.empty_like(x)
    band = bottleneck_plan(h, w, c, m)
    code = dll.irp_identity_bottleneck(
        *(t.data_ptr() for t in (x, *weights)), out.data_ptr(), b, h, w, c,
        m, band, torch.cuda.current_stream().cuda_stream)
    _kernels.check(dll, code, "identity_bottleneck (clock copy)")
    torch.cuda.synchronize()
    clk = np.zeros((1024, 16), np.int64)
    _kernels.check(dll, dll.irp_k1_clocks(clk.ctypes.data), "clock readback")
    blocks = min(torch.cuda.get_device_properties(0).multi_processor_count,
                 b * -(-h // band))
    mean = dict(zip(COUNTERS, clk[:blocks].mean(axis=0).tolist()))
    # phases 1 and 2 overlap a stage's wgmma with the next one's loads:
    # their GEMM time less the waits for a full stage is the MMA's
    mean["mma1"] = mean["gemm1"] - mean["wait1"]
    mean["mma2"] = mean["gemm2"] - mean["wait2"]
    return {"band": band, "blocks": blocks, "cycles_per_block": mean}


def main(argv=None) -> list:
    argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter).parse_args(argv)
    _kernels.resolve_device("cuda")  # raises without a card
    dll = build()
    gen = torch.Generator().manual_seed(0)
    results = []
    for b in (32, 256):
        for _, h, w, c, m, label in SHAPES:
            r = {"shape": label, "B": b, **split(dll, b, h, w, c, m, gen)}
            print(json.dumps(r), flush=True)
            results.append(r)
    return results


if __name__ == "__main__":
    main()
