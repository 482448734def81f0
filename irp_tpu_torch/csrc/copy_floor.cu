// relu(x) copied over a contiguous bf16 tensor for Hopper (sm_90a): the
// bandwidth floor the fused identity bottleneck (identity_bottleneck.cu)
// is measured against.
//
// Replaces tools/bench_fused_block.py::copy_floor (a Pallas relu copy over
// one image per grid step, the TPU block pipeline's bandwidth probe).
//
// Bound on this card: bytes.  Each element is read once and written once
// (2 * 2 bytes) for one compare, so the pass is pure memory traffic: at
// ResNet50 layer1's (32, 56, 56, 256) bf16 map, 51.4 MB in all, 0.0307 ms
// at 3.35 TB/s.
//
// Design: each thread moves 16 bytes (8 bf16) per load and store, four
// loads in flight before their stores, over a grid-stride loop sized to
// the card's SMs.  The relu works on the bits: a value is replaced by +0
// only when it is negative and not a NaN, so every other value, -0.0 and
// NaN payloads included, is copied bit for bit.  The up-to-7 elements
// past the last full 16-byte group go through a scalar tail.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t relu_half(uint32_t h) {
  const uint32_t mag = h & 0x7fffu;
  const bool negative = (h & 0x8000u) && mag != 0 && mag <= 0x7f80u;
  return negative ? 0u : h;
}

__device__ __forceinline__ uint32_t relu_pair(uint32_t w) {
  return relu_half(w & 0xffffu) | (relu_half(w >> 16) << 16);
}

__device__ __forceinline__ uint4 relu8(uint4 v) {
  return make_uint4(relu_pair(v.x), relu_pair(v.y), relu_pair(v.z),
                    relu_pair(v.w));
}

__global__ void relu_copy_kernel(const uint4* __restrict__ in,
                                 uint4* __restrict__ out, long long n_vec,
                                 const uint16_t* __restrict__ in_tail,
                                 uint16_t* __restrict__ out_tail, int n_tail) {
  const long long stride =
      static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n_tail) out_tail[i] = static_cast<uint16_t>(relu_half(in_tail[i]));
  for (; i + 3 * stride < n_vec; i += 4 * stride) {
    const uint4 v0 = in[i];
    const uint4 v1 = in[i + stride];
    const uint4 v2 = in[i + 2 * stride];
    const uint4 v3 = in[i + 3 * stride];
    out[i] = relu8(v0);
    out[i + stride] = relu8(v1);
    out[i + 2 * stride] = relu8(v2);
    out[i + 3 * stride] = relu8(v3);
  }
  for (; i < n_vec; i += stride) out[i] = relu8(in[i]);
}

}  // namespace

extern "C" {

// x and out: n contiguous bf16 values, 16-byte aligned.  Returns
// cudaGetLastError() after the launch.
int irp_relu_copy(const void* x, void* out, long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  const long long n_vec = n / 8;
  const int n_tail = static_cast<int>(n - n_vec * 8);
  long long blocks = (n_vec + threads - 1) / threads;
  if (blocks > 8LL * sms) blocks = 8LL * sms;
  if (blocks < 1) blocks = 1;
  const uint16_t* in16 = static_cast<const uint16_t*>(x);
  uint16_t* out16 = static_cast<uint16_t*>(out);
  relu_copy_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), n_vec,
      in16 + n_vec * 8, out16 + n_vec * 8, n_tail);
  return static_cast<int>(cudaGetLastError());
}

const char* irp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
