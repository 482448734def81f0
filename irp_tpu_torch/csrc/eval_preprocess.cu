// Eval preprocessing for Hopper (sm_90a): center crop + ImageNet
// normalize + cast, in one pass over the batch.
//
// Replaces irp_tpu/ops/pallas_image.py::pallas_eval_preprocess (the TPU
// kernel views each image as (H, W*C) rows with per-lane scale/bias rows).
//
// Bound on this card: bytes.  Each output element costs one u8 read and
// one 2-byte (bf16) or 4-byte (f32) write and two flops, so the pass sits
// far below the H100's ~295 flop/byte ridge.  At B=64, 256->224 it reads
// 9.6 MB of crop and writes 19.3 MB of bf16: ~8.6 us at 3.35 TB/s.
//
// Design: one thread per group of 8 consecutive output elements of the
// NHWC output (== NCHW in channels_last memory, the model's input), so
// every store is one 16-byte (bf16) or two 16-byte (f32) vector stores
// and a warp writes 512 contiguous bytes.  The crop starts on a pixel
// boundary, so the channel of element e of a row is e % 3 and the
// per-lane rows of the TPU kernel reduce to three per-channel constants.
// The arithmetic is x*scale (rounded) + bias (rounded) with no FMA
// contraction, the same two roundings as the TPU kernel and the plain
// PyTorch version.  A scalar kernel serves rows whose length is not a
// multiple of 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Norm {
  float scale[3];
  float bias[3];
};

__device__ __forceinline__ float normalize(uint8_t v, int ch, const Norm& n) {
  return __fadd_rn(__fmul_rn(static_cast<float>(v), n.scale[ch]), n.bias[ch]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float* v) {
  __align__(16) __nv_bfloat16 packed[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) packed[i] = __float2bfloat16_rn(v[i]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(packed);
}

__device__ __forceinline__ void store8(float* dst, const float* v) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store1(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void store1(float* dst, float v) { *dst = v; }

// out row r = (image b, crop row y); a row holds out_size*3 elements.
template <typename OutT>
__global__ void eval_preprocess_vec8(const uint8_t* __restrict__ in,
                                     OutT* __restrict__ out, int h, int w,
                                     int out_size, int top, int left,
                                     Norm norm, long long n_groups) {
  const long long g = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (g >= n_groups) return;
  const int row_elems = out_size * 3;
  const long long e0 = g * 8;
  const long long row = e0 / row_elems;
  const int col = static_cast<int>(e0 - row * row_elems);
  const long long b = row / out_size;
  const int y = static_cast<int>(row - b * out_size);
  const uint8_t* src = in + ((b * h + top + y) * w + left) * 3 + col;
  float v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = normalize(src[i], (col + i) % 3, norm);
  store8(out + e0, v);
}

template <typename OutT>
__global__ void eval_preprocess_scalar(const uint8_t* __restrict__ in,
                                       OutT* __restrict__ out, int h, int w,
                                       int out_size, int top, int left,
                                       Norm norm, long long n_elems) {
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (e >= n_elems) return;
  const int row_elems = out_size * 3;
  const long long row = e / row_elems;
  const int col = static_cast<int>(e - row * row_elems);
  const long long b = row / out_size;
  const int y = static_cast<int>(row - b * out_size);
  const uint8_t* src = in + ((b * h + top + y) * w + left) * 3 + col;
  store1(out + e, normalize(*src, col % 3, norm));
}

template <typename OutT>
int launch(const void* in, void* out, int batch, int h, int w, int out_size,
           const float* scale, const float* bias, void* stream) {
  Norm norm;
  for (int c = 0; c < 3; ++c) {
    norm.scale[c] = scale[c];
    norm.bias[c] = bias[c];
  }
  const int top = (h - out_size) / 2;
  const int left = (w - out_size) / 2;
  const long long n_elems =
      static_cast<long long>(batch) * out_size * out_size * 3;
  const int threads = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* src = static_cast<const uint8_t*>(in);
  OutT* dst = static_cast<OutT*>(out);
  if ((out_size * 3) % 8 == 0) {
    const long long n_groups = n_elems / 8;
    const long long blocks = (n_groups + threads - 1) / threads;
    eval_preprocess_vec8<OutT><<<static_cast<unsigned>(blocks), threads, 0,
                                 s>>>(src, dst, h, w, out_size, top, left,
                                      norm, n_groups);
  } else {
    const long long blocks = (n_elems + threads - 1) / threads;
    eval_preprocess_scalar<OutT><<<static_cast<unsigned>(blocks), threads, 0,
                                   s>>>(src, dst, h, w, out_size, top, left,
                                        norm, n_elems);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// images (batch, h, w, 3) uint8 -> out (batch, out_size, out_size, 3).
// out_dtype: 0 = bfloat16, 1 = float32.  scale/bias: 3 host floats.
// Returns cudaGetLastError() after the launch.
int irp_eval_preprocess(const void* images, void* out, int batch, int h,
                        int w, int out_size, int out_dtype,
                        const float* scale, const float* bias, void* stream) {
  if (out_dtype == 0)
    return launch<__nv_bfloat16>(images, out, batch, h, w, out_size, scale,
                                 bias, stream);
  if (out_dtype == 1)
    return launch<float>(images, out, batch, h, w, out_size, scale, bias,
                         stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* irp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
