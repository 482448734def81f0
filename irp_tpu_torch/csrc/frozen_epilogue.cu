// Epilogue of the frozen ResNet prefix's unfused convs for Hopper (sm_90a):
// per-channel bias, optionally a residual branch and its bias, ReLU and,
// for the stem, the 3x3/2 pad-1 max-pool, in one pass over a conv's bf16
// NHWC output.
//
// Replaces no TPU kernel (no pl.pallas_call counterpart).  The JAX package
// leaves the stem's and each downsampling block 0's inference BatchNorm to
// XLA, which fuses them into the convs' epilogues.  Eager PyTorch ran each
// of them as a cast up to f32, cuDNN's f32 BatchNorm and a cast back, then
// a ReLU, an add and a ReLU.  With the BN folded into the conv weights
// (ops/cuda_resnet.py::fold_bn_into_conv), what is left of each is a
// per-channel bias, which this kernel applies together with what follows.
//
// Bound on this card: bytes.  An element costs one or two bf16 reads, one
// bf16 write and at most three adds, far below the ~295 flop/byte ridge.
// Per ResNet50 image at 224 the ten passes (stem 1, blocks 0 of layers 1-3
// 3 each) move 15.05 MB: 3.85 GB for a B=256 forward, 1.15 ms at 3.35 TB/s.
//
// Design.  Elementwise passes (bias_relu, bias_add_relu): one 16-byte
// vector (8 channels of one pixel) a thread, neighbouring threads on
// neighbouring vectors, a grid sized to the tensor and no loop, as
// copy_floor.cu found fastest for one read and one write.  The thread's 8
// biases are two 16-byte loads that stay in L1 and then in registers.
// Loads of the conv outputs skip L1 (ld.global.nc.L1::no_allocate): this
// pass reads them once.  Stores are plain, so the next conv can find its
// input in L2.  Max-pool pass: one thread per output pixel and 8 channels,
// 9 window loads through L1 (a window shares a column with its right
// neighbour and a row with the one below), the max taken on the bf16
// values, then bias and ReLU: the bias is per channel and x -> relu(x + b)
// and the rounding to bf16 do not decrease, so relu(max(window) + b)
// equals max over the window of relu(y + b), rounded either way alike.
//
// Arithmetic: f32 throughout, one rounding to bf16 (round to nearest
// even) at the end, adds in the plain version's order with no contraction
// (__fadd_rn): y + r first, then b_y + b_r, then the sum of the two.  NaN
// propagates through the max and the ReLU, as in PyTorch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // bf16 channels a thread

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

// relu that keeps NaN, as torch.relu does
__device__ __forceinline__ float relu(float s) { return s < 0.f ? 0.f : s; }

__device__ __forceinline__ uint4 finish(const float (&s)[kVec],
                                        const float (&b)[kVec]) {
  float o[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) o[k] = relu(__fadd_rn(s[k], b[k]));
  return make_uint4(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]),
                    pack_bf16(o[4], o[5]), pack_bf16(o[6], o[7]));
}

__device__ __forceinline__ void load_bias(const float* __restrict__ b,
                                          int c0, float (&out)[kVec]) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(b + c0));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(b + c0) + 1);
  out[0] = lo.x; out[1] = lo.y; out[2] = lo.z; out[3] = lo.w;
  out[4] = hi.x; out[5] = hi.y; out[6] = hi.z; out[7] = hi.w;
}

// out = relu(y [+ r] + (b_y [+ b_r])) over n_vec 8-channel vectors of a
// map with c_vec vectors a pixel
template <bool kResidual>
__global__ void __launch_bounds__(kThreads)
bias_relu_kernel(const uint4* __restrict__ y, const float* __restrict__ b_y,
                 const uint4* __restrict__ r, const float* __restrict__ b_r,
                 uint4* __restrict__ out, int n_vec, int c_vec) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_vec) return;
  const int c0 = (i % c_vec) * kVec;
  float bias[kVec], s[kVec];
  load_bias(b_y, c0, bias);
  unpack(load_stream(y + i), s);
  if (kResidual) {
    float br[kVec], t[kVec];
    load_bias(b_r, c0, br);
    unpack(load_stream(r + i), t);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      s[k] = __fadd_rn(s[k], t[k]);
      bias[k] = __fadd_rn(bias[k], br[k]);
    }
  }
  out[i] = finish(s, bias);
}

// out (batch, ho, wo, c) = relu(max over the 3x3/2 pad-1 window of y
// (batch, h, w, c) + b)
__global__ void __launch_bounds__(kThreads)
bias_relu_maxpool_kernel(const uint4* __restrict__ y,
                         const float* __restrict__ b, uint4* __restrict__ out,
                         int n_vec, int h, int w, int c_vec, int ho, int wo) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_vec) return;
  const int g = i % c_vec;
  int p = i / c_vec;
  const int ox = p % wo;
  p /= wo;
  const int oy = p % ho;
  const int n = p / ho;
  float m[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) m[k] = -__int_as_float(0x7f800000);
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int iy = 2 * oy - 1 + dy;
    if (iy < 0 || iy >= h) continue;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int ix = 2 * ox - 1 + dx;
      if (ix < 0 || ix >= w) continue;
      float v[kVec];
      unpack(__ldg(y + (static_cast<long long>(n * h + iy) * w + ix) * c_vec
                   + g), v);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        m[k] = (v[k] > m[k] || v[k] != v[k]) ? v[k] : m[k];
    }
  }
  float bias[kVec];
  load_bias(b, g * kVec, bias);
  out[i] = finish(m, bias);
}

int blocks_for(long long n_vec) {
  return static_cast<int>((n_vec + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// y, out: n contiguous bf16 values of an NHWC map with c channels;
// b: c floats.  n and c multiples of 8, pointers 16-byte aligned.
// Returns cudaGetLastError() after the launch.
int irp_bias_relu(const void* y, const float* b, void* out, long long n,
                  int c, void* stream) {
  if (n <= 0 || c <= 0 || c % kVec || n % c || n / kVec > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_vec = static_cast<int>(n / kVec);
  bias_relu_kernel<false><<<blocks_for(n_vec), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(y), b, nullptr, nullptr,
      static_cast<uint4*>(out), n_vec, c / kVec);
  return static_cast<int>(cudaGetLastError());
}

// As irp_bias_relu, with r (the same shape as y) and b_r added:
// relu((y + r) + (b_y + b_r)).
int irp_bias_add_relu(const void* y, const float* b_y, const void* r,
                      const float* b_r, void* out, long long n, int c,
                      void* stream) {
  if (n <= 0 || c <= 0 || c % kVec || n % c || n / kVec > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_vec = static_cast<int>(n / kVec);
  bias_relu_kernel<true><<<blocks_for(n_vec), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(y), b_y, static_cast<const uint4*>(r), b_r,
      static_cast<uint4*>(out), n_vec, c / kVec);
  return static_cast<int>(cudaGetLastError());
}

// y (batch, h, w, c) bf16 -> out (batch, ho, wo, c) bf16 with ho =
// (h - 1) / 2 + 1, wo = (w - 1) / 2 + 1; b: c floats; c a multiple of 8.
int irp_bias_relu_maxpool(const void* y, const float* b, void* out,
                          int batch, int h, int w, int c, int ho, int wo,
                          void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0 || c % kVec ||
      ho != (h - 1) / 2 + 1 || wo != (w - 1) / 2 + 1 ||
      static_cast<long long>(batch) * h * w * (c / kVec) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_vec = batch * ho * wo * (c / kVec);
  bias_relu_maxpool_kernel<<<blocks_for(n_vec), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(y), b, static_cast<uint4*>(out), n_vec, h, w,
      c / kVec, ho, wo);
  return static_cast<int>(cudaGetLastError());
}

const char* irp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
