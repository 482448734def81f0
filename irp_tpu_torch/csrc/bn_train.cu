// Train-mode BatchNorm for Hopper (sm_90a): the batch moments, the
// normalisation and the hand-written backward over a bf16 NHWC map (a
// channels_last conv output), with f32 arithmetic throughout.
//
// Replaces no TPU kernel (no pl.pallas_call counterpart).  The JAX package
// leaves train-mode BatchNorm to XLA, which fuses the moments and the
// normalisation into a few passes and derives the backward itself.  Eager
// PyTorch ran the same formula (models/resnet.py::BatchNorm2d) as some 22
// f32 ops forward and autograd's ~30 backward, each a pass over the map.
//
// Bound on this card: bytes.  An element costs a few f32 flops against 2-6
// bf16 bytes, far below the ~295 flop/byte ridge.  Forward: read x for the
// moments, then read x and write y (6 B an element).  Backward: read dy and
// x for two per-channel sums, then read dy and x and write dx (10 B).
//
// Layout and tiling.  The map is (rows, C) with rows = N*H*W and C
// innermost.  A thread owns one 16-byte vector of 8 channels and walks
// rows; a block of 256 threads is `sw` vectors (<= 32, a warp's 512
// contiguous bytes of a row) by `rp` row phases; grid.y is the channel
// slabs of sw vectors.  The host's plan (ops/cuda_batch_norm.py::bn_plan)
// picks sw, rp and the reductions' row splits from C, the row count and
// the SM count, so that every shape fills the card with no per-model path.
//
// Reductions (bn_fw_stats, bn_bw_reduce): grid.x is `splits` row ranges.
// Each thread sums its rows into 8 f32 sums of each kind, eight rows in
// flight; the block adds its row phases in shared memory as a pairwise tree
// and writes one partial row of the slab's channels.  The last block of a
// slab to arrive (a counter per slab, reset by that block) adds the slab's
// partials in split order and finalises: forward, the mean, E[x^2] -
// mean^2 and the running statistics; backward, dw, db and the per-channel
// coefficients of dx.  No atomics on the data, so the sums are the same
// run to run.
//
// Elementwise passes (bn_fw_normalize, bn_bw_dx): each thread takes four
// rows of its channel vector, its per-channel constants loaded once.
//
// Arithmetic, in the plain version's order and with no contraction
// (__fsub_rn, __fmul_rn, __fadd_rn):
//   var = max(var_raw, 0) keeping NaN;  mul = rsqrtf(var + eps) * w
//   y   = bf16((x - mean) * mul + b)
//   s = rstd * w;  a = sum(dy) / n;  k = s * rstd * rstd * (sum(dy*xc) / n),
//   0 where var_raw < 0 (the clamp's gradient);  xc = x - mean
//   dx  = bf16(s * (dy - a) - k * xc);  dw = rstd * sum(dy*xc);  db = sum(dy)
// rsqrtf is what PyTorch's CUDA rsqrt calls, so given the same moments y
// is bit-equal to the plain formula run on the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;        // bf16 channels a thread
constexpr int kMaxSw = 32;     // vectors of a slab
constexpr int kUnroll = 8;     // rows in flight in the reductions
constexpr int kRows = 4;       // rows a thread in the elementwise passes

__device__ __forceinline__ uint4 load_stream(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[kVec]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(
             __bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(
              __bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

__device__ __forceinline__ uint4 pack8(const float (&o)[kVec]) {
  return make_uint4(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]),
                    pack_bf16(o[4], o[5]), pack_bf16(o[6], o[7]));
}

// 8 floats from p (32-byte aligned), through L1
__device__ __forceinline__ void load8(const float* __restrict__ p,
                                      float (&out)[kVec]) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  out[0] = lo.x; out[1] = lo.y; out[2] = lo.z; out[3] = lo.w;
  out[4] = hi.x; out[5] = hi.y; out[6] = hi.z; out[7] = hi.w;
}

// 8 floats another block wrote in this kernel: from L2, never a stale L1
__device__ __forceinline__ void load8_cg(const float* p, float (&out)[kVec]) {
  const float4 lo = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 hi = __ldcg(reinterpret_cast<const float4*>(p) + 1);
  out[0] = lo.x; out[1] = lo.y; out[2] = lo.z; out[3] = lo.w;
  out[4] = hi.x; out[5] = hi.y; out[6] = hi.z; out[7] = hi.w;
}

// the clamp at 0 of the biased variance; NaN stays NaN, as clamp_min keeps it
__device__ __forceinline__ float clip0(float v) { return v < 0.f ? 0.f : v; }

// Where a thread sits in its block: vector `cv` of the map's `cvec`, row
// phase `rp_i` of `rp`; `active` unless it falls past the slab or the row.
struct Lane {
  int cv_l, rp_i, cv;
  bool active;
};

__device__ __forceinline__ Lane lane(int sw, int rp, int cvec) {
  Lane l;
  l.cv_l = threadIdx.x % sw;
  l.rp_i = threadIdx.x / sw;
  l.cv = blockIdx.y * sw + l.cv_l;
  l.active = l.rp_i < rp && l.cv < cvec;
  return l;
}

// Adds the row phases' sums in shared memory as a pairwise tree, in a fixed
// order (phase i takes phase i + step at each level); thread t < sw * 8
// walks channel t's column alone and returns it in s_out / q_out.
__device__ __forceinline__ void block_sum(const Lane& l, int sw, int rp,
                                          const float (&s)[kVec],
                                          const float (&q)[kVec],
                                          float* red, float& s_out,
                                          float& q_out) {
  const int width = sw * kVec;  // channels of the slab
  const int plane = rp * width;
  __syncthreads();               // red may hold an earlier sum
  if (l.rp_i < rp) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      red[l.rp_i * width + l.cv_l * kVec + k] = s[k];
      red[plane + l.rp_i * width + l.cv_l * kVec + k] = q[k];
    }
  }
  __syncthreads();
  s_out = 0.f;
  q_out = 0.f;
  if (threadIdx.x < width) {
    float* cs = red + threadIdx.x;
    float* cq = cs + plane;
    for (int step = 1; step < rp; step <<= 1) {
      for (int i = 0; i + step < rp; i += 2 * step) {
        cs[i * width] = __fadd_rn(cs[i * width], cs[(i + step) * width]);
        cq[i * width] = __fadd_rn(cq[i * width], cq[(i + step) * width]);
      }
    }
    s_out = cs[0];
    q_out = cq[0];
  }
}

// Per-channel constants the finalize needs besides the two sums.
struct FwFinal {
  float* moments;  // (2, c): mean, E[x^2] - mean^2 (unclipped)
  float* running_mean;
  float* running_var;
  float keep, momentum;
  int update;
};

struct BwFinal {
  const float* moments;
  const float* w;
  float eps;
  float* coef;  // (3, c): s, a, k
  float* dw;
  float* db;
};

__device__ __forceinline__ void finalize(const FwFinal& f, int ch, int c,
                                         float n, float s, float q) {
  const float mean = __fdiv_rn(s, n);
  const float ex2 = __fdiv_rn(q, n);
  const float var_raw = __fsub_rn(ex2, __fmul_rn(mean, mean));
  f.moments[ch] = mean;
  f.moments[c + ch] = var_raw;
  if (f.update) {
    f.running_mean[ch] = __fadd_rn(__fmul_rn(f.keep, f.running_mean[ch]),
                                   __fmul_rn(f.momentum, mean));
    f.running_var[ch] = __fadd_rn(__fmul_rn(f.keep, f.running_var[ch]),
                                  __fmul_rn(f.momentum, clip0(var_raw)));
  }
}

__device__ __forceinline__ void finalize(const BwFinal& f, int ch, int c,
                                         float n, float s, float q) {
  const float var_raw = f.moments[c + ch];
  const float rstd = rsqrtf(__fadd_rn(clip0(var_raw), f.eps));
  const float scale = __fmul_rn(rstd, f.w[ch]);
  f.dw[ch] = __fmul_rn(rstd, q);
  f.db[ch] = s;
  f.coef[ch] = scale;
  f.coef[c + ch] = __fdiv_rn(s, n);
  // the clamp passes its gradient where its input is >= 0
  f.coef[2 * c + ch] =
      var_raw >= 0.f
          ? __fmul_rn(__fmul_rn(__fmul_rn(scale, rstd), rstd),
                      __fdiv_rn(q, n))
          : 0.f;
}

// One element's contribution to the two sums: forward x and x^2; backward
// dy and dy * (x - mean).
template <bool kBw>
__device__ __forceinline__ void accumulate(const uint4& a, const uint4& b,
                                           const float (&mean)[kVec],
                                           float (&s)[kVec],
                                           float (&q)[kVec]) {
  float va[kVec];
  unpack(a, va);
  if (kBw) {
    float vb[kVec];
    unpack(b, vb);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      s[k] = __fadd_rn(s[k], va[k]);
      q[k] = __fadd_rn(q[k], __fmul_rn(va[k], __fsub_rn(vb[k], mean[k])));
    }
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      s[k] = __fadd_rn(s[k], va[k]);
      q[k] = __fadd_rn(q[k], __fmul_rn(va[k], va[k]));
    }
  }
}

// The reductions' body.  a: x (forward) or dy (backward); b: x (backward).
// partial: (2, splits, c) f32; counters: one int a slab, 0 between calls.
template <bool kBw, typename Final>
__device__ __forceinline__ void reduce_pass(const uint4* __restrict__ a,
                                       const uint4* __restrict__ b,
                                       const float* __restrict__ mean_in,
                                       int rows, int c, int sw, int rp,
                                       int splits, float* partial,
                                       int* counters, const Final& fin) {
  __shared__ float red[2 * kThreads * kVec];
  __shared__ bool last;
  const int cvec = c / kVec;
  const Lane l = lane(sw, rp, cvec);
  float s[kVec], q[kVec], mean[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) s[k] = q[k] = mean[k] = 0.f;
  if (l.active) {
    if (kBw) load8(mean_in + l.cv * kVec, mean);
    const int per_split = (rows + splits - 1) / splits;
    const int r0 = blockIdx.x * per_split;
    const int r1 = min(rows, r0 + per_split);
    int r = r0 + l.rp_i;
    for (; r + (kUnroll - 1) * rp < r1; r += kUnroll * rp) {
      uint4 va[kUnroll], vb[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long at = static_cast<long long>(r + u * rp) * cvec + l.cv;
        va[u] = load_stream(a + at);
        if (kBw) vb[u] = load_stream(b + at);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        accumulate<kBw>(va[u], vb[u], mean, s, q);
    }
    for (; r < r1; r += rp) {
      const long long at = static_cast<long long>(r) * cvec + l.cv;
      const uint4 va = load_stream(a + at);
      const uint4 vb = kBw ? load_stream(b + at) : va;
      accumulate<kBw>(va, vb, mean, s, q);
    }
  }
  float s_blk, q_blk;
  block_sum(l, sw, rp, s, q, red, s_blk, q_blk);
  const int width = sw * kVec;
  const int ch = blockIdx.y * width + threadIdx.x;
  const long long plane = static_cast<long long>(splits) * c;
  if (threadIdx.x < width && ch < c) {
    partial[static_cast<long long>(blockIdx.x) * c + ch] = s_blk;
    partial[plane + static_cast<long long>(blockIdx.x) * c + ch] = q_blk;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(counters + blockIdx.y, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  // the slab's last block: every split's partial is written
  __threadfence();
#pragma unroll
  for (int k = 0; k < kVec; ++k) s[k] = q[k] = 0.f;
  if (l.active) {
    for (int sp = l.rp_i; sp < splits; sp += rp) {
      float ps[kVec], pq[kVec];
      const long long at = static_cast<long long>(sp) * c + l.cv * kVec;
      load8_cg(partial + at, ps);
      load8_cg(partial + plane + at, pq);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        s[k] = __fadd_rn(s[k], ps[k]);
        q[k] = __fadd_rn(q[k], pq[k]);
      }
    }
  }
  block_sum(l, sw, rp, s, q, red, s_blk, q_blk);
  if (threadIdx.x < width && ch < c)
    finalize(fin, ch, c, static_cast<float>(rows), s_blk, q_blk);
  if (threadIdx.x == 0) counters[blockIdx.y] = 0;
}

__global__ void __launch_bounds__(kThreads)
bn_fw_stats_kernel(const uint4* __restrict__ x, int rows, int c, int sw,
                   int rp, int splits, float* partial, int* counters,
                   FwFinal fin) {
  reduce_pass<false>(x, nullptr, nullptr, rows, c, sw, rp, splits, partial,
                counters, fin);
}

__global__ void __launch_bounds__(kThreads)
bn_bw_reduce_kernel(const uint4* __restrict__ dy,
                    const uint4* __restrict__ x, int rows, int c, int sw,
                    int rp, int splits, float* partial, int* counters,
                    BwFinal fin) {
  reduce_pass<true>(dy, x, fin.moments, rows, c, sw, rp, splits, partial,
               counters, fin);
}

// y = bf16((x - mean) * (rsqrtf(max(var_raw, 0) + eps) * w) + b)
__global__ void __launch_bounds__(kThreads)
bn_fw_normalize_kernel(const uint4* __restrict__ x,
                       const float* __restrict__ moments,
                       const float* __restrict__ w,
                       const float* __restrict__ b, float eps,
                       uint4* __restrict__ y, int rows, int c, int sw,
                       int rp) {
  const int cvec = c / kVec;
  const Lane l = lane(sw, rp, cvec);
  if (!l.active) return;
  float mean[kVec], mul[kVec], bias[kVec], wv[kVec];
  load8(moments + l.cv * kVec, mean);
  load8(moments + c + l.cv * kVec, mul);  // var_raw, then the multiplier
  load8(w + l.cv * kVec, wv);
  load8(b + l.cv * kVec, bias);
#pragma unroll
  for (int k = 0; k < kVec; ++k)
    mul[k] = __fmul_rn(rsqrtf(__fadd_rn(clip0(mul[k]), eps)), wv[k]);
  const int r0 = blockIdx.x * rp * kRows + l.rp_i;
  uint4 v[kRows];
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int r = r0 + u * rp;
    if (r < rows) v[u] = load_stream(x + static_cast<long long>(r) * cvec + l.cv);
  }
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int r = r0 + u * rp;
    if (r >= rows) break;
    float f[kVec];
    unpack(v[u], f);
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      f[k] = __fadd_rn(__fmul_rn(__fsub_rn(f[k], mean[k]), mul[k]), bias[k]);
    y[static_cast<long long>(r) * cvec + l.cv] = pack8(f);
  }
}

// dx = bf16(s * (dy - a) - k * (x - mean))
__global__ void __launch_bounds__(kThreads)
bn_bw_dx_kernel(const uint4* __restrict__ dy, const uint4* __restrict__ x,
                const float* __restrict__ moments,
                const float* __restrict__ coef, uint4* __restrict__ dx,
                int rows, int c, int sw, int rp) {
  const int cvec = c / kVec;
  const Lane l = lane(sw, rp, cvec);
  if (!l.active) return;
  float mean[kVec], sc[kVec], av[kVec], kv[kVec];
  load8(moments + l.cv * kVec, mean);
  load8(coef + l.cv * kVec, sc);
  load8(coef + c + l.cv * kVec, av);
  load8(coef + 2 * c + l.cv * kVec, kv);
  const int r0 = blockIdx.x * rp * kRows + l.rp_i;
  uint4 vd[kRows], vx[kRows];
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int r = r0 + u * rp;
    if (r < rows) {
      const long long at = static_cast<long long>(r) * cvec + l.cv;
      vd[u] = load_stream(dy + at);
      vx[u] = load_stream(x + at);
    }
  }
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int r = r0 + u * rp;
    if (r >= rows) break;
    float fd[kVec], fx[kVec];
    unpack(vd[u], fd);
    unpack(vx[u], fx);
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      fd[k] = __fsub_rn(__fmul_rn(sc[k], __fsub_rn(fd[k], av[k])),
                        __fmul_rn(kv[k], __fsub_rn(fx[k], mean[k])));
    dx[static_cast<long long>(r) * cvec + l.cv] = pack8(fd);
  }
}

bool bad_plan(int rows, int c, int sw, int rp, int splits) {
  return rows <= 0 || c <= 0 || c % kVec || sw <= 0 || sw > kMaxSw ||
         rp <= 0 || sw * rp > kThreads || splits <= 0 || splits > rows ||
         (c / kVec + sw - 1) / sw > 65535;
}

dim3 elementwise_grid(int rows, int c, int sw, int rp) {
  const int per_block = rp * kRows;
  return dim3((rows + per_block - 1) / per_block, (c / kVec + sw - 1) / sw);
}

}  // namespace

extern "C" {

// The batch moments of x (rows, c) bf16 into moments (2, c) f32: the mean
// and E[x^2] - mean^2, unclipped; with `update`, running_mean and
// running_var move toward the mean and the clipped variance:
// keep * running + momentum * new.  partial: 2 * splits * c floats;
// counters: ceil(c / 8 / sw) ints, 0 on entry and on return.  c a multiple
// of 8, pointers 16-byte aligned.  Returns cudaGetLastError() after the
// launch.
int irp_bn_fw_stats(const void* x, int rows, int c, int sw, int rp,
                    int splits, float* partial, int* counters,
                    float* moments, float* running_mean, float* running_var,
                    float keep, float momentum, int update, void* stream) {
  if (bad_plan(rows, c, sw, rp, splits))
    return static_cast<int>(cudaErrorInvalidValue);
  const FwFinal fin{moments, running_mean, running_var, keep, momentum,
                    update};
  bn_fw_stats_kernel<<<dim3(splits, (c / kVec + sw - 1) / sw), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), rows, c, sw, rp, splits, partial,
      counters, fin);
  return static_cast<int>(cudaGetLastError());
}

// y (rows, c) bf16 from x and the moments irp_bn_fw_stats wrote.
int irp_bn_fw_normalize(const void* x, const float* moments, const float* w,
                        const float* b, float eps, void* y, int rows, int c,
                        int sw, int rp, void* stream) {
  if (bad_plan(rows, c, sw, rp, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  bn_fw_normalize_kernel<<<elementwise_grid(rows, c, sw, rp), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), moments, w, b, eps,
      static_cast<uint4*>(y), rows, c, sw, rp);
  return static_cast<int>(cudaGetLastError());
}

// The backward's sums over dy and x (rows, c) bf16: dw = rstd *
// sum(dy * (x - mean)), db = sum(dy), and coef (3, c) f32 for
// irp_bn_bw_dx.  partial and counters as for irp_bn_fw_stats.
int irp_bn_bw_reduce(const void* dy, const void* x, const float* moments,
                     const float* w, float eps, int rows, int c, int sw,
                     int rp, int splits, float* partial, int* counters,
                     float* coef, float* dw, float* db, void* stream) {
  if (bad_plan(rows, c, sw, rp, splits))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwFinal fin{moments, w, eps, coef, dw, db};
  bn_bw_reduce_kernel<<<dim3(splits, (c / kVec + sw - 1) / sw), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(dy), static_cast<const uint4*>(x), rows, c,
      sw, rp, splits, partial, counters, fin);
  return static_cast<int>(cudaGetLastError());
}

// dx (rows, c) bf16 from dy, x, the moments and irp_bn_bw_reduce's coef.
int irp_bn_bw_dx(const void* dy, const void* x, const float* moments,
                 const float* coef, void* dx, int rows, int c, int sw,
                 int rp, void* stream) {
  if (bad_plan(rows, c, sw, rp, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  bn_bw_dx_kernel<<<elementwise_grid(rows, c, sw, rp), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(dy), static_cast<const uint4*>(x), moments,
      coef, static_cast<uint4*>(dx), rows, c, sw, rp);
  return static_cast<int>(cudaGetLastError());
}

const char* irp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
