// Eval preprocessing for Hopper (sm_90a): center crop + ImageNet
// normalize + cast, in one streaming pass over the batch.
//
// Replaces irp_tpu/ops/pallas_image.py::pallas_eval_preprocess (the TPU
// kernel views each image as (H, W*C) rows with per-lane scale/bias rows).
//
// Bound on this card: bytes.  Each output element costs one u8 read and
// one 2-byte (bf16) or 4-byte (f32) write and two flops, so the pass sits
// far below the H100's ~295 flop/byte ridge.  At B=64, 256->224 it reads
// 9.6 MB of crop and writes 19.3 MB of bf16: 8.6 us at 3.35 TB/s.
//
// Design: the grid runs over output rows (image, crop row), several rows
// a block, and a thread takes 16 consecutive elements of one row.  Its
// (image, row, chunk) come from blockIdx/threadIdx with 32-bit
// arithmetic.  At the cache geometry (256x256 -> 224) the source row
// pitch (768 bytes), the crop offset (48 bytes) and the output row (672
// elements) are multiples of 16, so the thread's source is one 16-byte
// load and its output two 16-byte bf16 stores (four for f32): loads skip
// L1 (ld.global.nc.L1::no_allocate) and stores stream (st.global.cs), as
// neither side is read again by this pass.  The crop starts on a pixel
// boundary, so the channel of element e of a row is e % 3 and the TPU
// kernel's per-lane rows reduce to three per-channel constants; a thread
// picks its 16 scale/bias pairs from them once.  The arithmetic is
// x*scale (rounded) + bias (rounded) with no FMA contraction, the same two
// roundings as the TPU kernel and the plain PyTorch version.  Where the
// pitch, the crop offset or the output row is not a multiple of 16 bytes
// (W = 250, an odd offset, out_size = 7), the same kernel reads and
// writes the thread's elements one at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 16;  // output elements a thread
constexpr int kMaxThreads = 256;

struct Norm {
  float scale[3];
  float bias[3];
};

__device__ __forceinline__ float normalize(uint32_t v, float scale,
                                           float bias) {
  return __fadd_rn(__fmul_rn(static_cast<float>(v), scale), bias);
}

__device__ __forceinline__ uint4 load_stream(const uint8_t* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat16 l = __float2bfloat16_rn(lo);
  const __nv_bfloat16 h = __float2bfloat16_rn(hi);
  return static_cast<uint32_t>(__bfloat16_as_ushort(l)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(h)) << 16);
}

__device__ __forceinline__ void store16(__nv_bfloat16* dst, const float* v) {
  uint4* p = reinterpret_cast<uint4*>(dst);
  __stcs(p, make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                       pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7])));
  __stcs(p + 1, make_uint4(pack_bf16(v[8], v[9]), pack_bf16(v[10], v[11]),
                           pack_bf16(v[12], v[13]),
                           pack_bf16(v[14], v[15])));
}

__device__ __forceinline__ void store16(float* dst, const float* v) {
  float4* p = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    __stcs(p + q, make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                              v[4 * q + 3]));
}

__device__ __forceinline__ void store1(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void store1(float* dst, float v) { *dst = v; }

// A block is rows_per_block output rows x chunks_per_block chunks of 16
// elements; blockIdx.y picks the chunks of rows wider than one block.
template <typename OutT>
__global__ void __launch_bounds__(kMaxThreads)
eval_preprocess_kernel(const uint8_t* __restrict__ in, OutT* __restrict__ out,
                       int h, int w, int out_size, int top, int left,
                       int n_rows, int chunks_per_block, int rows_per_block,
                       bool vec, Norm norm) {
  const int r_local = threadIdx.x / chunks_per_block;
  const int row = blockIdx.x * rows_per_block + r_local;
  const int row_elems = out_size * 3;
  const int chunk = blockIdx.y * chunks_per_block +
                    (threadIdx.x - r_local * chunks_per_block);
  const int col = chunk * kVec;
  if (row >= n_rows || col >= row_elems) return;
  const int img = row / out_size;
  const int y = row - img * out_size;
  const uint8_t* src =
      in + ((static_cast<long long>(img) * h + top + y) * w + left) * 3 + col;
  OutT* dst = out + static_cast<long long>(row) * row_elems + col;
  // channel of element col + i is (col + i) % 3, and 16 % 3 == 1
  const int c0 = chunk % 3;
  float scale[kVec], bias[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int c = (c0 + i) % 3;
    scale[i] = c == 0 ? norm.scale[0] : c == 1 ? norm.scale[1] : norm.scale[2];
    bias[i] = c == 0 ? norm.bias[0] : c == 1 ? norm.bias[1] : norm.bias[2];
  }
  if (vec) {
    const uint4 raw = load_stream(src);
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
    float v[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      v[i] = normalize((words[i / 4] >> (8 * (i % 4))) & 0xffu, scale[i],
                       bias[i]);
    store16(dst, v);
  } else {
    const int n_el = min(kVec, row_elems - col);
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      if (i < n_el) store1(dst + i, normalize(src[i], scale[i], bias[i]));
  }
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
  const long long n_rows = static_cast<long long>(batch) * out_size;
  const long long row_bytes = static_cast<long long>(out_size) * 3;
  if (n_rows > 0x7fffffffLL ||
      static_cast<long long>(batch) * h * w * 3 > (1LL << 40))
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = static_cast<int>((row_bytes + kVec - 1) / kVec);
  const int chunks_per_block = chunks < kMaxThreads ? chunks : kMaxThreads;
  const int rows_per_block = kMaxThreads / chunks_per_block;
  const bool vec =
      (w * 3) % 16 == 0 && (left * 3) % 16 == 0 && row_bytes % 16 == 0 &&
      reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid(
      static_cast<unsigned>((n_rows + rows_per_block - 1) / rows_per_block),
      (chunks + chunks_per_block - 1) / chunks_per_block);
  eval_preprocess_kernel<OutT><<<grid, rows_per_block * chunks_per_block, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<OutT*>(out), h, w,
      out_size, top, left, static_cast<int>(n_rows), chunks_per_block,
      rows_per_block, vec, norm);
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
  if (batch <= 0 || out_size <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
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
