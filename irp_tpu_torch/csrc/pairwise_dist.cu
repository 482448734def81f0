// Pairwise squared Euclidean distances for Hopper (sm_90a), in float32:
// out[i][j] = max(|a_i|^2 + |b_j|^2 - 2 a_i . b_j, 0).
//
// Replaces irp_tpu/ops/pallas_image.py::pallas_pairwise_dist (the TPU
// kernel tiles only M and keeps all of b resident in VMEM; a Hopper block
// cannot hold b, so here both M and N are tiled).
//
// Bound on this card: at the kNN's shapes (a block of 1024 rows against
// N = 26,179 points) the (M, N) f32 output is 107 MB, 0.032 ms at
// 3.35 TB/s; at D = 50 the 2*M*N*D = 2.68 GFLOP take 0.040 ms at the
// 67 TFLOP/s float32 rate outside the tensor cores, so that case is
// bound by operations and D = 2 by bytes.  Tensor cores are not used:
// TF32 keeps about three decimal digits, which would reorder near
// neighbours against the f32 reference.
//
// Design: one block of 256 threads computes one 128 x 128 output tile.
// The D axis is staged through shared memory in chunks of 32 (one chunk
// for D <= 32, two for the PCA-50 case), both tiles stored k-major so a
// thread reads its 8 rows of a and its 8 columns of b as two 16-byte
// loads each.  Each thread keeps an 8 x 8 register tile of float32 FMA
// sums.  |a|^2 and |b|^2 come in as vectors.  The epilogue applies
// max(., 0), masks the ragged M and N edges and writes each row's 8
// columns with two 16-byte stores: the caller gives the output a leading
// dimension that is a multiple of 4 floats, so every such store is
// aligned, and a warp writes 512 contiguous bytes of a row.

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;  // rows of a per tile
constexpr int kBN = 128;  // rows of b (output columns) per tile
constexpr int kKC = 32;   // D chunk staged in shared memory
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads, 2)
pairwise_dist_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     const float* __restrict__ a_sq,
                     const float* __restrict__ b_sq, float* __restrict__ out,
                     int m, int n, int d, int ldo) {
  __shared__ __align__(16) float as[kKC][kBM];
  __shared__ __align__(16) float bs[kKC][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx*8 .. tx*8+7 of the tile
  const int ty = tid / 16;  // rows ty*8 .. ty*8+7 of the tile
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kKC) {
    const int kc = min(kKC, d - k0);
    // row index fastest across the warp: conflict-free shared stores
    for (int e = tid; e < kBM * kKC; e += kThreads) {
      const int r = e % kBM;
      const int k = e / kBM;
      const int gm = m0 + r;
      const int gn = n0 + r;
      as[k][r] = (gm < m && k < kc)
                     ? a[static_cast<long long>(gm) * d + k0 + k] : 0.f;
      bs[k][r] = (gn < n && k < kc)
                     ? b[static_cast<long long>(gn) * d + k0 + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kc; ++k) {
      const float4 a_lo = *reinterpret_cast<const float4*>(&as[k][ty * 8]);
      const float4 a_hi =
          *reinterpret_cast<const float4*>(&as[k][ty * 8 + 4]);
      const float4 b_lo = *reinterpret_cast<const float4*>(&bs[k][tx * 8]);
      const float4 b_hi =
          *reinterpret_cast<const float4*>(&bs[k][tx * 8 + 4]);
      const float av[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                           a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float bv[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w,
                           b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int col0 = n0 + tx * 8;
  float bsq[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) bsq[j] = (col0 + j < n) ? b_sq[col0 + j] : 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + ty * 8 + i;
    if (row >= m) break;
    const float asq = a_sq[row];
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = fmaxf(asq + bsq[j] - 2.f * acc[i][j], 0.f);
    float* dst = out + static_cast<long long>(row) * ldo + col0;
    if (col0 + 8 <= n) {
      reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (col0 + j < n) dst[j] = v[j];
    }
  }
}

}  // namespace

extern "C" {

// a (m, d), b (n, d), a_sq (m,), b_sq (n,) float32, contiguous; out is
// (m, ldo) float32 with ldo >= n a multiple of 4 and 16-byte aligned.
// Columns n .. ldo-1 are left unwritten.  Returns cudaGetLastError()
// after the launch.
int irp_pairwise_dist(const void* a, const void* b, const void* a_sq,
                      const void* b_sq, void* out, int m, int n, int d,
                      int ldo, void* stream) {
  if (m <= 0 || n <= 0 || d < 0 || ldo < n || ldo % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  pairwise_dist_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(a_sq), static_cast<const float*>(b_sq),
      static_cast<float*>(out), m, n, d, ldo);
  return static_cast<int>(cudaGetLastError());
}

const char* irp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
