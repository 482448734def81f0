// Fused frozen identity bottleneck for Hopper (sm_90a):
//   a    = bf16(relu(x . w1 + b1))                      1x1 conv, C -> M
//   bmap = bf16(relu(conv3x3_same(a, w2) + b2))         3x3 conv, M -> M
//   out  = relu(bf16(x + bf16(bmap . w3 + b3)))         1x1 conv, M -> C
// with BatchNorm folded into (w, b) ahead of the call, bf16 operands and
// f32 accumulation.  Forward only.
//
// Replaces irp_tpu/ops/pallas_resnet.py::fused_identity_bottleneck (body
// _bottleneck_kernel), which kept one whole image in the TPU's VMEM.  A
// Hopper block has at most 227 KB of shared memory, and layer1's `a` alone
// is 56*56*64*2 B = 401 KB, so the image is cut into bands of rows.
//
// Bound on this card: bytes at layer1 and layer2, operations at layer3.
// x is read and out written once, 2*B*H*W*C*2 bytes (103 MB at B=32,
// layer1: 30.7 us at 3.35 TB/s) against 14 GFLOP (14.1 us at 989
// TFLOP/s).  The design keeps `a` and `bmap` out of device memory, which
// is what the unfused block pays for:
// - one thread block owns one image x a band of kBand output rows;
// - phase 1 computes `a` for the band plus a one-row halo above and below
//   (conv1 recomputed for the halo rows) into shared memory, zero-padded
//   at the image edge and in one pad column on each side;
// - phase 2 runs the 3x3 conv as one GEMM with K = 9*M over that buffer:
//   tap (dy, dx) of pixel q reads a[q + dy*wp + dx].  It computes every
//   position of the padded width wp = W+2, so that the 16 rows of an A
//   tile are 16 consecutive pixels of the flattened buffer; the two pad
//   columns of each row are computed and dropped;
// - phase 3 runs conv3 from `bmap` in shared memory, adds the residual x
//   (read again from device memory, mostly from L2) and stores.
// Each phase is a sequence of GEMM passes.  A pass covers a block of
// 16-row tiles times up to 256 output columns; its weights (and, in
// phase 1, its rows of x) are copied into shared memory in K-chunks of 32
// with cp.async through a ring of 4 stages (3 chunks in flight while one
// is consumed), and shared by all 16 warps, so a block reads each weight
// once per pass from L2.  Matrix products are bf16 tensor-core
// mma.sync.m16n8k16 with f32 accumulators, fed by ldmatrix from shared
// rows padded by 16 bytes (no bank conflicts); a warp owns up to two
// 16-row tiles of one 64-column group, so one B fragment feeds two MMAs
// and one A fragment eight.  Epilogues work on the accumulator registers.
// TMA, wgmma and warp specialisation are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 16;                 // rows of an A tile, K of an MMA
constexpr int kGroupCols = 64;            // columns a warp owns in a pass
constexpr int kN8 = kGroupCols / 8;       // m16n8 MMAs per A fragment
constexpr int kTasksPerWarp = 2;          // row tiles a warp owns in a pass
constexpr int kMaxGroups = 4;             // groups per pass: <= 256 columns
constexpr int kKC = 32;                   // K-chunk staged per step
constexpr int kSkew = 8;                  // bf16 pad per shared row (16 B)
constexpr int kStages = 4;                // K-chunks in the shared ring
constexpr int kALd = kKC + kSkew;
// A stage holds one K-chunk of W (kKC rows of g*64 + kSkew) and, in
// phase 1, the chunk of x's rows in the rest: 8 row tiles when W is 256
// columns wide, 17 when it is 64
constexpr int kStageElems =
    kKC * (kMaxGroups * kGroupCols + kSkew) + 8 * kTile * kALd;
constexpr int kBand = 4;                  // output rows per block
constexpr int kMaxSmem = 232448;          // bytes a block may use

struct Geometry {
  int h, w, c, m;
  int wp;       // padded width, w + 2
  int sa;       // shared pixel stride in elements, m + kSkew
  int q_tiles;  // 16-pixel tiles over kBand * wp positions
  int apad_px;  // pixels of the `a` buffer (with halo, pads and slack)
  int bmap_px;  // pixels of the `bmap` buffer
  int n_bands;
  // byte offsets in shared memory, each a multiple of 128; smem = total
  // bytes, 0 when the shape does not fit
  int bmap_off, stage_off, smem;
};

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and register i receives matrix i.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ int b_ld(int g) { return g * kGroupCols + kSkew; }

// 16-row tiles of phase 1's A chunk that fit beside a W chunk of g groups.
__device__ __forceinline__ int a_tile_capacity(int g) {
  return (kStageElems - kKC * b_ld(g)) / (kALd * kTile);
}

// One GEMM pass: C[rows, cols] = sum_k A[rows, k] * W[k, cols] over the
// row tiles [rt0, rt0 + rb) and the column groups [cg0, cg0 + gp), K =
// k_rows.  W is row-major with leading dimension ldw.  stage_a(buf, k0,
// rows) copies phase 1's A chunk (a no-op elsewhere); a_ptr(buf, r, k)
// gives row 0 of the A tile of row tile r at K index k, whose rows are
// lda elements apart.  epi(row, col, v0, v1) consumes the accumulators of
// columns col and col + 1 of one row.
template <class StageA, class APtr, class Epi>
__device__ __forceinline__ void gemm_pass(
    bf16* stage, const bf16* __restrict__ wmat, int ldw, int k_rows,
    int g, int cg0, int gp, int rt0, int rb, int lda, StageA stage_a,
    APtr a_ptr, Epi epi) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int warps_per_group = kWarps / g;
  const int group = warp / warps_per_group;
  const int slot = warp % warps_per_group;
  const bool active = group < gp && slot < rb;
  const int n0 = cg0 * kGroupCols;
  const int nk = k_rows / kKC;
  const int bld = b_ld(g);

  auto issue = [&](int chunk, int buf) {
    bf16* bs = stage + buf * kStageElems;
    stage_a(bs + kKC * bld, chunk * kKC, rb * kTile);
    const int cols8 = gp * kGroupCols / 8;
    const int ops = kKC * cols8;
    const bf16* src = wmat + static_cast<size_t>(chunk) * kKC * ldw + n0;
    for (int i = threadIdx.x; i < ops; i += kThreads) {
      const int kk = i / cols8;
      const int c8 = i - kk * cols8;
      cp_async16(bs + kk * bld + c8 * 8,
                 src + static_cast<size_t>(kk) * ldw + c8 * 8);
    }
    cp_async_commit();
  };

  float acc[kTasksPerWarp][kN8][4];
#pragma unroll
  for (int t = 0; t < kTasksPerWarp; ++t)
#pragma unroll
    for (int u = 0; u < kN8; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][u][e] = 0.0f;

  // ldmatrix lane offsets: A rows lane % 16, K half lane / 16; B (K x N,
  // row-major, read transposed) K row lane % 8 + 8 * ((lane / 8) % 2), N
  // half lane / 16
  const int a_off = (lane & 15) * lda + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * bld +
                    (lane >> 4) * 8 + group * kGroupCols;

  // prologue: chunks 0 .. kStages-2 in flight; one commit group per chunk
  // (empty past the end) keeps the wait_group count uniform
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) issue(st, st);
    else cp_async_commit();
  }
  for (int chunk = 0; chunk < nk; ++chunk) {
    cp_async_wait<kStages - 2>();  // this thread's copies of `chunk` landed
    __syncthreads();               // everyone's did; stage chunk-1 is free
    const int next = chunk + kStages - 1;
    if (next < nk) issue(next, next % kStages);
    else cp_async_commit();
    if (active) {
      const bf16* bs = stage + (chunk % kStages) * kStageElems;
      const bf16* as = bs + kKC * bld;
      bs += b_off;
#pragma unroll
      for (int s = 0; s < kKC; s += kTile) {
        unsigned bf[kN8 / 2][4];  // [16 columns][b0, b1 of n8 lo, hi]
#pragma unroll
        for (int j = 0; j < kN8 / 2; ++j)
          ldsm_x4_trans(bf[j], bs + s * bld + j * 16);
#pragma unroll
        for (int t = 0; t < kTasksPerWarp; ++t) {
          const int r = slot + t * warps_per_group;
          if (r < rb) {
            unsigned af[4];
            ldsm_x4(af, a_ptr(as, rt0 + r, chunk * kKC + s) + a_off);
#pragma unroll
            for (int u = 0; u < kN8; ++u)
              mma16816(acc[t][u], af, bf[u / 2][(u & 1) * 2],
                       bf[u / 2][(u & 1) * 2 + 1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // accumulator layout of m16n8: lane holds rows lane/4 and lane/4 + 8,
  // columns 2*(lane%4) and 2*(lane%4) + 1
  if (active) {
#pragma unroll
    for (int t = 0; t < kTasksPerWarp; ++t) {
      const int r = slot + t * warps_per_group;
      if (r < rb) {
        const int row = (rt0 + r) * kTile + lane / 4;
#pragma unroll
        for (int u = 0; u < kN8; ++u) {
          const int col = n0 + group * kGroupCols + u * 8 + 2 * (lane % 4);
          epi(row, col, acc[t][u][0], acc[t][u][1]);
          epi(row + 8, col, acc[t][u][2], acc[t][u][3]);
        }
      }
    }
  }
  __syncthreads();
}

// Column groups per pass and row tiles per pass for a phase of row_tiles
// 16-row tiles and n output columns; max_rb <= 0 means as many as fit in
// the A part of a stage.
__device__ __forceinline__ void plan(int row_tiles, int n, int max_rb,
                                     int* g, int* rb) {
  int groups = min(kMaxGroups, n / kGroupCols);
  while (groups > 1 && groups * row_tiles > kWarps * kTasksPerWarp)
    groups >>= 1;
  *g = groups;
  if (max_rb <= 0) max_rb = a_tile_capacity(groups);
  const int cap = min(max_rb, kTasksPerWarp * (kWarps / groups));
  // passes of nearly equal size
  *rb = ceil_div(row_tiles, ceil_div(row_tiles, cap));
}

__global__ void __launch_bounds__(kThreads, 1)
identity_bottleneck_kernel(const bf16* __restrict__ x,
                           const bf16* __restrict__ w1,
                           const float* __restrict__ b1,
                           const bf16* __restrict__ w2,
                           const float* __restrict__ b2,
                           const bf16* __restrict__ w3,
                           const float* __restrict__ b3,
                           bf16* __restrict__ out, Geometry g) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* apad = reinterpret_cast<bf16*>(smem_raw);
  bf16* bmap = reinterpret_cast<bf16*>(smem_raw + g.bmap_off);
  bf16* stage = reinterpret_cast<bf16*>(smem_raw + g.stage_off);

  const int img = blockIdx.x / g.n_bands;
  const int r0 = (blockIdx.x % g.n_bands) * kBand;
  const int img_px = g.h * g.w;
  const bf16* ximg = x + static_cast<size_t>(img) * img_px * g.c;
  bf16* oimg = out + static_cast<size_t>(img) * img_px * g.c;
  const int sa = g.sa;

  // Zero the `a` buffer: halo rows outside the image, pad columns, slack.
  {
    const int n16 = g.apad_px * sa / 8;
    uint4* p = reinterpret_cast<uint4*>(apad);
    for (int i = threadIdx.x; i < n16; i += kThreads)
      p[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  // Phase 1: a = bf16(relu(x . w1 + b1)) for image rows [r0-1, r0+band],
  // clipped to the image: pixels [p_lo, p_hi), contiguous in x.  Rows of
  // the last tile past p_hi read a valid pixel and are dropped.
  const int p_lo = max(r0 - 1, 0) * g.w;
  const int p_hi = min(r0 + kBand + 1, g.h) * g.w;
  {
    int gq, rb;
    const int row_tiles = ceil_div(p_hi - p_lo, kTile);
    plan(row_tiles, g.m, 0, &gq, &rb);
    for (int rt0 = 0; rt0 < row_tiles; rt0 += rb) {
      const int rbp = min(rb, row_tiles - rt0);
      auto stage_a = [&](bf16* as, int k0, int rows) {
        const int ops = rows * (kKC / 8);
        for (int i = threadIdx.x; i < ops; i += kThreads) {
          const int r = i / (kKC / 8);
          const int c8 = i - r * (kKC / 8);
          const int p = min(p_lo + rt0 * kTile + r, img_px - 1);
          cp_async16(as + r * kALd + c8 * 8,
                     ximg + static_cast<size_t>(p) * g.c + k0 + c8 * 8);
        }
      };
      auto a_ptr = [&](const bf16* as, int r, int k) {
        return as + (r - rt0) * kTile * kALd + (k % kKC);
      };
      auto epi = [&](int row, int n, float v0, float v1) {
        const int p = p_lo + row;
        if (p < p_hi) {
          const int arow = p / g.w - (r0 - 1);
          const int acol = p % g.w + 1;
          *reinterpret_cast<unsigned*>(
              apad + static_cast<size_t>(arow * g.wp + acol) * sa + n) =
              pack2(fmaxf(v0 + b1[n], 0.0f), fmaxf(v1 + b1[n + 1], 0.0f));
        }
      };
      for (int cg0 = 0; cg0 < g.m / kGroupCols; cg0 += gq)
        gemm_pass(stage, w1, g.m, g.c, gq, cg0,
                  min(gq, g.m / kGroupCols - cg0), rt0, rbp, kALd, stage_a,
                  a_ptr, epi);
    }
  }

  auto no_stage = [](bf16*, int, int) {};

  // Phase 2: bmap = bf16(relu(conv3x3(a) + b2)) at every position q of the
  // padded-width grid, q = r*wp + col; w2 is the (9M, M) matrix of taps.
  {
    int gq, rb;
    plan(g.q_tiles, g.m, g.q_tiles, &gq, &rb);
    auto a_ptr = [&](const bf16*, int r, int k) {
      const int tap = k / g.m;
      const int kin = k - tap * g.m;
      return static_cast<const bf16*>(apad) +
             static_cast<size_t>(r * kTile + (tap / 3) * g.wp + tap % 3) *
                 sa + kin;
    };
    auto epi = [&](int q, int n, float v0, float v1) {
      *reinterpret_cast<unsigned*>(bmap + static_cast<size_t>(q) * sa + n) =
          pack2(fmaxf(v0 + b2[n], 0.0f), fmaxf(v1 + b2[n + 1], 0.0f));
    };
    for (int rt0 = 0; rt0 < g.q_tiles; rt0 += rb)
      for (int cg0 = 0; cg0 < g.m / kGroupCols; cg0 += gq)
        gemm_pass(stage, w2, g.m, 9 * g.m, gq, cg0,
                  min(gq, g.m / kGroupCols - cg0), rt0,
                  min(rb, g.q_tiles - rt0), sa, no_stage, a_ptr, epi);
  }

  // Phase 3: out = relu(bf16(x + bf16(bmap . w3 + b3))) for the band's
  // valid positions (col < w, row inside the band and the image).
  {
    int gq, rb;
    plan(g.q_tiles, g.c, g.q_tiles, &gq, &rb);
    auto a_ptr = [&](const bf16*, int r, int k) {
      return static_cast<const bf16*>(bmap) +
             static_cast<size_t>(r * kTile) * sa + k;
    };
    auto epi = [&](int q, int n, float v0, float v1) {
      const int r = q / g.wp;
      const int col = q - r * g.wp;
      if (col < g.w && r < kBand && r0 + r < g.h) {
        const size_t off =
            (static_cast<size_t>(r0 + r) * g.w + col) * g.c + n;
        const __nv_bfloat162 xv =
            *reinterpret_cast<const __nv_bfloat162*>(ximg + off);
        const float y0 = __bfloat162float(__float2bfloat16_rn(v0 + b3[n]));
        const float y1 =
            __bfloat162float(__float2bfloat16_rn(v1 + b3[n + 1]));
        *reinterpret_cast<unsigned*>(oimg + off) =
            pack2(fmaxf(__low2float(xv) + y0, 0.0f),
                  fmaxf(__high2float(xv) + y1, 0.0f));
      }
    };
    for (int rt0 = 0; rt0 < g.q_tiles; rt0 += rb)
      for (int cg0 = 0; cg0 < g.c / kGroupCols; cg0 += gq)
        gemm_pass(stage, w3, g.c, g.m, gq, cg0,
                  min(gq, g.c / kGroupCols - cg0), rt0,
                  min(rb, g.q_tiles - rt0), sa, no_stage, a_ptr, epi);
  }
}

Geometry make_geometry(int h, int w, int c, int m) {
  Geometry g;
  g.h = h;
  g.w = w;
  g.c = c;
  g.m = m;
  g.wp = w + 2;
  g.sa = m + kSkew;
  g.q_tiles = ceil_div(kBand * g.wp, kTile);
  g.bmap_px = g.q_tiles * kTile;
  // phase 2 reads up to q_tiles*16 - 1 + 2*wp + 2; phase 1 writes
  // (band + 2) * wp pixels, which is no more
  g.apad_px = g.bmap_px + 2 * g.wp + 2;
  g.n_bands = ceil_div(h, kBand);
  auto up128 = [](long long b) { return (b + 127) / 128 * 128; };
  const long long bmap_off = up128(1LL * g.apad_px * g.sa * sizeof(bf16));
  const long long stage_off =
      bmap_off + up128(1LL * g.bmap_px * g.sa * sizeof(bf16));
  const long long total =
      stage_off + 1LL * kStages * kStageElems * sizeof(bf16);
  const bool fits = total <= kMaxSmem;
  g.bmap_off = fits ? static_cast<int>(bmap_off) : 0;
  g.stage_off = fits ? static_cast<int>(stage_off) : 0;
  g.smem = fits ? static_cast<int>(total) : 0;
  return g;
}

}  // namespace

extern "C" {

// x, out: (batch, h, w, c) bf16; w1 (c, m), w2 (3, 3, m, m), w3 (m, c)
// bf16; b1, b2 (m,), b3 (c,) f32; every pointer 16-byte aligned.
// Requires c % 64 == 0 and m % 64 == 0 (the wrapper checks).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape it does not take.
int irp_identity_bottleneck(const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, const void* w3,
                            const void* b3, void* out, int batch, int h,
                            int w, int c, int m, void* stream) {
  if (c % kGroupCols != 0 || m % kGroupCols != 0 || h < 1 || w < 1 ||
      batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = make_geometry(h, w, c, m);
  if (g.smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      identity_bottleneck_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      g.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(batch) * g.n_bands);
  identity_bottleneck_kernel<<<grid, kThreads, g.smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const bf16*>(w3),
      static_cast<const float*>(b3), static_cast<bf16*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

const char* irp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
