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
// Design: a grid sized to the tensor, one 16-byte vector (8 bf16) a
// thread, neighbouring threads on neighbouring vectors: no thread loops,
// so no remainder runs with one load in flight, and 8 blocks of 256
// threads per SM keep 2048 loads in flight there.  (2, 4 and 8 vectors a
// thread, every load issued before the stores, were each slower on the
// card at the bench shapes.)  Loads skip L1 (ld.global.nc.L1::no_allocate)
// and stores stream (st.global.cs): this pass reads neither side again.
// The relu works on the bits: a value is replaced by +0 only when it is
// negative and not a NaN, so every other value, -0.0 and NaN payloads
// included, is copied bit for bit.  The up-to-7 elements past the last
// full 16-byte group go through a scalar tail.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t relu_half(uint32_t h) {
  const uint32_t mag = h & 0x7fffu;
  const bool negative = (h & 0x8000u) && mag != 0 && mag <= 0x7f80u;
  return negative ? 0u : h;
}

__device__ __forceinline__ uint32_t relu_pair(uint32_t w) {
  return relu_half(w & 0xffffu) | (relu_half(w >> 16) << 16);
}

__device__ __forceinline__ uint4 load_stream(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__global__ void __launch_bounds__(kThreads)
relu_copy_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                 long long n_vec, const uint16_t* __restrict__ in_tail,
                 uint16_t* __restrict__ out_tail, int n_tail) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (blockIdx.x == 0 && threadIdx.x < n_tail)
    out_tail[threadIdx.x] =
        static_cast<uint16_t>(relu_half(in_tail[threadIdx.x]));
  if (i < n_vec) {
    const uint4 v = load_stream(in + i);
    __stcs(out + i, make_uint4(relu_pair(v.x), relu_pair(v.y),
                               relu_pair(v.z), relu_pair(v.w)));
  }
}

}  // namespace

extern "C" {

// x and out: n contiguous bf16 values, 16-byte aligned.  Returns
// cudaGetLastError() after the launch.
int irp_relu_copy(const void* x, void* out, long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_vec = n / 8;
  const int n_tail = static_cast<int>(n - n_vec * 8);
  long long blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const uint16_t* in16 = static_cast<const uint16_t*>(x);
  uint16_t* out16 = static_cast<uint16_t*>(out);
  relu_copy_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), n_vec,
      in16 + n_vec * 8, out16 + n_vec * 8, n_tail);
  return static_cast<int>(cudaGetLastError());
}

const char* irp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
