// Fused pairwise squared distances + k smallest per row, for Hopper
// (sm_90a), in float32: for each row i of a, the k columns j of b with the
// smallest d(i, j) = max(|a_i|^2 + |b_j|^2 - 2 a_i . b_j, 0), in ascending
// order of (d, j), with column i + self_offset left out when
// self_offset >= 0.
//
// Replaces irp_tpu/ops/pallas_image.py::pallas_pairwise_dist together with
// the top-k that both packages' knn apply to that kernel's output
// (irp_tpu/data/outliers.py::knn: d.at[rows, rows].set(inf), then
// lax.top_k).  Equal distances come out lower index first, as lax.top_k
// gives them: a candidate's key is (bits of d) << 32 | j, and non-negative
// floats order like their bits.
//
// Bound on this card: at the kNN's row block (1024 rows against N =
// 26,179 points, D = 50) the M N (2D + 1) operations take 0.040 ms at the
// 67 TFLOP/s float32 rate outside the tensor cores, and the inputs and
// the (M, k) output are a few MB: operations bound it.  At D = 2 the same
// count is 0.002 ms, and the selection (a compare a pair, insertions into
// the lists), which no such bound counts, sets the time.  Tensor cores are
// not used: TF32 keeps about three decimal digits, which reorders near
// neighbours against the f32 reference.
//
// Design.  The grid is (row tiles of BM rows) x (column splits), sized
// from the occupancy so that every SM holds blocks.  A block keeps its BM
// rows of a resident in shared memory and sweeps its split's columns in
// tiles of BN = 64 rows of b, which cp.async brings as coalesced 16-byte
// copies through a 3-stage ring, so tiles t+1 and t+2 load while tile t
// is multiplied.  D is padded to a multiple of 4 by the caller; the
// shared row pitch is D, or D + 4 when D / 4 is even, so a quarter warp's
// eight 16-byte reads of eight rows hit distinct banks.  256 threads in a
// 16 x 16 grid: a thread owns rows ty + 16 i (TM of them) and columns
// tx + 16 j (4 of them) of the tile and keeps TM x 4 f32 FMA sums in
// registers, so a row's 64 keys of a tile lie in one half-warp, 4 a lane.
// Selection.  First a bound on each row's k-th distance
// (row_bound_kernel): sampled columns (every 4th where D >= 16, all at
// D = 2) are dealt to k groups by tile, each group's smallest distance to
// the row is kept, and the largest of those k minima, k distinct
// columns' distances, bounds the row's k nearest.  Then every row keeps a
// sorted list of 16 Q >= k keys in shared memory, and the threads of its
// half-warp hold its threshold: the bound, then the list's k-th key once
// that is lower.  A lane holds one key below the threshold over to later
// tiles; when a lane of the warp has two, each lane offers its smallest
// key, the half-warp merges the offers into the list by rank (each key's
// new place is its place in its own sequence plus the keys of the other
// below it; select_row) and the threshold is refreshed, until no lane has
// a key left below it.  Without the bound a split of n columns sees about
// k (1 + ln(n / k)) insertions a row; with it, about the keys under the
// bound, a few times k over all the splits.  tools/k3_split.py measures
// the time without the merges and the merges' share.  Each split writes
// its sorted list (padded with all-ones keys where it saw fewer than k
// columns) to scratch, and a third kernel merges the splits' lists, one
// warp a row, lane s holding the head of split s.  k <= 128 and padded
// D <= 128: BM = 128 rows for k <= 32 and 64 above, so that a, the ring
// and the lists fit in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;       // columns (rows of b) per tile
constexpr int kTN = 4;        // columns a thread owns per tile
constexpr int kStages = 3;    // cp.async ring depth
constexpr int kMaxK = 128;
constexpr int kMaxD = 128;    // padded width
constexpr int kMaxSplits = 32;  // one merge lane a split
constexpr unsigned long long kNone = ~0ull;  // padding key

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ unsigned long long make_key(float d, int col) {
  return (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
         static_cast<unsigned>(col);
}

// rows [r0, r0 + rows) of a (rows_total, dp) row-major matrix, whose row
// r sits `stride` rows of dp apart in src, into smem with row pitch
// `pitch`; rows past rows_total are zero-filled
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int rows, int rows_total,
                                          int dp, int pitch, int stride = 1) {
  const int q = dp / 4;  // 16-byte chunks a row
  for (int c = threadIdx.x; c < rows * q; c += kThreads) {
    const int r = c / q;
    const int v = c - r * q;
    const bool valid = r0 + r < rows_total;
    const float* g =
        valid ? src + static_cast<long long>(r0 + r) * stride * dp + 4 * v
              : src;
    cp_async16(dst + r * pitch + 4 * v, g, valid);
  }
}

// acc[i][j] = a_{ty + 16 i} . b_{tx + 16 j} over the tile in shared
// memory: ar points at row ty of a, bs at row tx of the tile
template <int TM>
__device__ __forceinline__ void tile_dot(float (&acc)[TM][kTN],
                                         const float* ar, const float* bs,
                                         int dp, int pitch) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  for (int d0 = 0; d0 < dp; d0 += 4) {
    float4 bv[kTN];
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      bv[j] = *reinterpret_cast<const float4*>(bs + 16 * j * pitch + d0);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float4 av =
          *reinterpret_cast<const float4*>(ar + 16 * i * pitch + d0);
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        acc[i][j] = fmaf(av.x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av.y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av.z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av.w, bv[j].w, acc[i][j]);
      }
    }
  }
}

// A bound on every row's k-th distance, before the selection: the
// sampled columns (every step-th) are dealt to k groups by tile (group
// t % k for sampled tile t), and each group's smallest distance to the
// row, itself left out, is an atomicMin into bound[row][group] (float
// bits, which order like the non-negative floats).  The largest of a
// row's k group minima is the distance of k distinct columns or more, so
// no key above it is among the row's k nearest; a group that saw no
// column keeps all ones, and then the row has no bound.
template <int TM>
__global__ void __launch_bounds__(kThreads, 2)
row_bound_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ a_sq,
                 const float* __restrict__ b_sq, unsigned* __restrict__ bound,
                 int m, int n, int dp, int pitch, int k, int self_offset,
                 int step, int tiles_per_split) {
  constexpr int BM = 16 * TM;
  extern __shared__ __align__(16) unsigned char smem[];
  float* as = reinterpret_cast<float*>(smem);
  float* ring = as + BM * pitch;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int m0 = blockIdx.x * BM;
  const int ns = (n + step - 1) / step;  // sampled columns
  const int first = blockIdx.y * tiles_per_split;
  const int last = min(first + tiles_per_split, (ns + kBN - 1) / kBN);

  load_rows(as, a, m0, BM, m, dp, pitch);
  load_rows(ring, b, first * kBN, kBN, ns, dp, pitch, step);
  cp_async_commit();
  if (first + 1 < last)
    load_rows(ring + kBN * pitch, b, (first + 1) * kBN, kBN, ns, dp, pitch,
              step);
  cp_async_commit();
  float asq[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
    asq[i] = m0 + ty + 16 * i < m ? a_sq[m0 + ty + 16 * i] : 0.f;

  for (int tile = first; tile < last; ++tile) {
    cp_async_wait<1>();
    __syncthreads();
    if (tile + 2 < last)
      load_rows(ring + ((tile + 2 - first) % kStages) * kBN * pitch, b,
                (tile + 2) * kBN, kBN, ns, dp, pitch, step);
    cp_async_commit();
    const int s0 = tile * kBN;
    float bsq[kTN];
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int sj = s0 + tx + 16 * j;
      bsq[j] = sj < ns ? b_sq[static_cast<long long>(sj) * step] : 0.f;
    }
    float acc[TM][kTN];
    tile_dot<TM>(acc, as + ty * pitch,
                 ring + ((tile - first) % kStages) * kBN * pitch + tx * pitch,
                 dp, pitch);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = m0 + ty + 16 * i;
      unsigned best = ~0u;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int sj = s0 + tx + 16 * j;
        const bool valid = row < m && sj < ns &&
                           (self_offset < 0 || sj * step != row + self_offset);
        const unsigned bits = __float_as_uint(
            fmaxf(asq[i] + bsq[j] - 2.f * acc[i][j], 0.f));
        if (valid && bits < best) best = bits;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        best = min(best, __shfl_xor_sync(0xffffffffu, best, off, 16));
      if (tx == 0 && best != ~0u)
        atomicMin(bound + static_cast<long long>(row) * k + tile % k, best);
    }
  }
  cp_async_wait<0>();
}

// One row's selection after a tile.  The row's sorted list of 16 Q keys
// lives in shared memory (L, position p at L[p]) and its 16 threads, a
// half-warp, hold up to 5 keys each (k0..k3 of the tile and k4 held over
// from earlier tiles; the set bits of `pending` mark those still to
// merge).  Each round, every lane offers its
// lowest pending key (kNone where it has none) and the half-warp merges
// the offers into L: a key's new position is its position in its own
// sequence plus the count of keys of the other sequence below it.  Keys
// are unique except kNone, whose writes all land at or past the last real
// key and write the same value.  Returns the row's new threshold, its
// k-th key or its bound, whichever is lower.  The whole warp calls it, each half on its own row, and runs
// the rounds together (a half with nothing left merges nothing); it is
// one function, not inlined, so that its code is not repeated for every
// row a thread owns.
template <int Q>
__device__ __noinline__ unsigned long long select_row(
    unsigned long long* L, unsigned long long k0, unsigned long long k1,
    unsigned long long k2, unsigned long long k3, unsigned long long k4,
    unsigned pending, unsigned long long thr, int k, int tx) {
  while (__any_sync(0xffffffffu, pending != 0)) {
    // the lane's smallest pending key: each lane offers its keys in
    // ascending order, so the first round's offers raise the threshold
    // most and later keys fail it sooner
    unsigned long long x = kNone;
    unsigned bit = 0;
    if ((pending & 1u) && k0 < x) { x = k0; bit = 1u; }
    if ((pending & 2u) && k1 < x) { x = k1; bit = 2u; }
    if ((pending & 4u) && k2 < x) { x = k2; bit = 4u; }
    if ((pending & 8u) && k3 < x) { x = k3; bit = 8u; }
    if ((pending & 16u) && k4 < x) { x = k4; bit = 16u; }
    pending &= ~bit;
    unsigned long long y[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) y[q] = L[tx + 16 * q];
    // the offering lanes of this half, walked in turn; the halves walk
    // theirs together, for as many turns as the longer has
    const unsigned offers = __ballot_sync(0xffffffffu, x != kNone);
    unsigned mine = (offers >> (threadIdx.x & 16)) & 0xffffu;
    const int turns = max(__popc(offers & 0xffffu), __popc(offers >> 16));
    int rank = 0;
    int below[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) below[q] = 0;
    for (int t = 0; t < turns; ++t) {
      const int src = mine ? __ffs(mine) - 1 : 0;
      mine &= mine - 1;
      unsigned long long c = __shfl_sync(0xffffffffu, x, src, 16);
      if (t >= __popc((offers >> (threadIdx.x & 16)) & 0xffffu)) c = kNone;
      rank += c < x;
#pragma unroll
      for (int q = 0; q < Q; ++q) below[q] += c < y[q];
    }
    int lo = 16 * Q;
    if (x != kNone) {
      lo = 0;
      int hi = 16 * Q;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (L[mid] < x) lo = mid + 1; else hi = mid;
      }
    }
    __syncwarp();
    if (rank + lo < 16 * Q) L[rank + lo] = x;
#pragma unroll
    for (int q = 0; q < Q; ++q)
      if (tx + 16 * q + below[q] < 16 * Q) L[tx + 16 * q + below[q]] = y[q];
    __syncwarp();
    if (L[k - 1] < thr) thr = L[k - 1];  // never above the row's bound
    if (!(k0 < thr)) pending &= ~1u;
    if (!(k1 < thr)) pending &= ~2u;
    if (!(k2 < thr)) pending &= ~4u;
    if (!(k3 < thr)) pending &= ~8u;
    if (!(k4 < thr)) pending &= ~16u;
  }
  return thr;
}

// TM rows a thread (BM = 16 TM rows a block), lists of 16 Q >= k keys
template <int TM, int Q>
__global__ void __launch_bounds__(kThreads, 2)
pairwise_topk_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     const float* __restrict__ a_sq,
                     const float* __restrict__ b_sq,
                     const unsigned* __restrict__ bound,
                     unsigned long long* __restrict__ part, int m, int n,
                     int dp, int pitch, int k, int self_offset,
                     int tiles_per_split) {
  constexpr int BM = 16 * TM;
  extern __shared__ __align__(16) unsigned char smem[];
  float* as = reinterpret_cast<float*>(smem);
  float* ring = as + BM * pitch;
  // each row's sorted list of 16 Q keys
  unsigned long long* lists = reinterpret_cast<unsigned long long*>(
      ring + kStages * kBN * pitch);
  const int tid = threadIdx.x;

  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int n_tiles = (n + kBN - 1) / kBN;
  const int t0 = split * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, n_tiles);

  // group 0: a's rows and the first tile; group 1: the second tile
  load_rows(as, a, m0, BM, m, dp, pitch);
  load_rows(ring, b, t0 * kBN, kBN, n, dp, pitch);
  cp_async_commit();
  if (t0 + 1 < t1)
    load_rows(ring + kBN * pitch, b, (t0 + 1) * kBN, kBN, n, dp, pitch);
  cp_async_commit();

  for (int e = tid; e < BM * 16 * Q; e += kThreads) lists[e] = kNone;
  float asq[TM];
  bool row_ok[TM];
  unsigned long long thr[TM];
  unsigned long long held[TM];  // a key below the threshold, not merged yet
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty + 16 * i;
    held[i] = kNone;
    row_ok[i] = row < m;
    asq[i] = row_ok[i] ? a_sq[row] : 0.f;
    // the row's bound, if it has one: the largest of its group minima
    unsigned tau = ~0u;
    if (bound != nullptr && row_ok[i]) {
      tau = 0;
      for (int g = tx; g < k; g += 16)
        tau = max(tau, bound[static_cast<long long>(row) * k + g]);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      tau = max(tau, __shfl_xor_sync(0xffffffffu, tau, off, 16));
    thr[i] = tau == ~0u ? kNone
                        : (static_cast<unsigned long long>(tau) << 32) | ~0u;
  }

  for (int t = t0; t < t1; ++t) {
    cp_async_wait<1>();
    __syncthreads();
    if (t + 2 < t1)
      load_rows(ring + ((t + 2 - t0) % kStages) * kBN * pitch, b,
                (t + 2) * kBN, kBN, n, dp, pitch);
    cp_async_commit();

    const int n0 = t * kBN;
    float bsq[kTN];
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = n0 + tx + 16 * j;
      bsq[j] = col < n ? b_sq[col] : 0.f;
    }
    float acc[TM][kTN];
    tile_dot<TM>(acc, as + ty * pitch,
                 ring + ((t - t0) % kStages) * kBN * pitch + tx * pitch, dp,
                 pitch);

    // selection, row by row (select_row)
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = m0 + ty + 16 * i;
      unsigned long long key[kTN];
      unsigned pending = 0;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int col = n0 + tx + 16 * j;
        key[j] = make_key(fmaxf(asq[i] + bsq[j] - 2.f * acc[i][j], 0.f), col);
        const bool valid = row_ok[i] && col < n &&
                           (self_offset < 0 || col != row + self_offset);
        if (valid && key[j] < thr[i]) pending |= 1u << j;
      }
      // a lane holds one key over to a later tile; the warp merges only
      // when a lane of it has two (its held key and this tile's, or two
      // of this tile's)
      const bool more = __popc(pending) + (held[i] != kNone) > 1;
      if (__any_sync(0xffffffffu, more)) {
        thr[i] = select_row<Q>(lists + (ty + 16 * i) * 16 * Q, key[0], key[1],
                               key[2], key[3], held[i],
                               pending | (held[i] != kNone ? 16u : 0u),
                               thr[i], k, tx);
        held[i] = kNone;
      } else if (pending != 0) {
        held[i] = pending & 1u ? key[0] : pending & 2u ? key[1]
                  : pending & 4u ? key[2] : key[3];
      }
    }
  }
  cp_async_wait<0>();
  // the keys still held
#pragma unroll
  for (int i = 0; i < TM; ++i)
    if (__any_sync(0xffffffffu, held[i] != kNone))
      select_row<Q>(lists + (ty + 16 * i) * 16 * Q, kNone, kNone, kNone,
                    kNone, held[i], held[i] != kNone ? 16u : 0u, thr[i], k,
                    tx);

  // this split's sorted lists, rows past m dropped
  __syncthreads();
  const int rows = min(BM, m - m0);
  for (int e = tid; e < rows * k; e += kThreads) {
    const int r = e / k;
    part[(static_cast<long long>(split) * m + m0 + r) * k + (e - r * k)] =
        lists[r * 16 * Q + e - r * k];
  }
}

// One warp a row: lane s walks split s's sorted list; each step the
// warp's smallest head is the next key of the row.
__global__ void __launch_bounds__(kThreads)
merge_splits_kernel(const unsigned long long* __restrict__ part,
                    float* __restrict__ out_d, int* __restrict__ out_i,
                    int m, int k, int splits) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= m) return;
  const unsigned long long* mine =
      part + (static_cast<long long>(lane) * m + row) * k;
  int pos = 0;
  unsigned long long head = lane < splits ? mine[0] : kNone;
  unsigned long long next = lane < splits && k > 1 ? mine[1] : kNone;
  for (int t = 0; t < k; ++t) {
    unsigned long long v = head;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, off);
      v = o < v ? o : v;
    }
    if (lane == 0) {
      out_d[static_cast<long long>(row) * k + t] =
          v == kNone ? __int_as_float(0x7f800000) : __uint_as_float(
              static_cast<unsigned>(v >> 32));
      out_i[static_cast<long long>(row) * k + t] =
          v == kNone ? -1 : static_cast<int>(v & 0xffffffffu);
    }
    if (v != kNone && head == v) {  // keys are unique: one lane moves on
      ++pos;
      head = next;
      next = pos + 1 < k ? mine[pos + 1] : kNone;
    }
  }
}

int pitch_for(int dp) { return (dp / 4) % 2 == 0 ? dp + 4 : dp; }

template <int TM, int Q>
size_t smem_bytes(int pitch) {
  return (static_cast<size_t>(16 * TM) + kStages * kBN) * pitch *
             sizeof(float) +
         static_cast<size_t>(16 * TM) * 16 * Q * sizeof(unsigned long long);
}

// (splits, tiles per split) for an (m, n) problem: enough blocks for
// every SM at this kernel's occupancy, at most kMaxSplits
template <int TM, int Q>
cudaError_t plan(int m, int n, int dp, int* splits, int* tps) {
  const size_t smem = smem_bytes<TM, Q>(pitch_for(dp));
  cudaError_t err = cudaFuncSetAttribute(
      pairwise_topk_kernel<TM, Q>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, pairwise_topk_kernel<TM, Q>, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int row_tiles = (m + 16 * TM - 1) / (16 * TM);
  const int n_tiles = (n + kBN - 1) / kBN;
  int s = (per_sm * sms + row_tiles - 1) / row_tiles;
  s = max(1, min(s, min(kMaxSplits, n_tiles)));
  *tps = (n_tiles + s - 1) / s;
  *splits = (n_tiles + *tps - 1) / *tps;
  return cudaSuccess;
}

// The row bounds (row_bound_kernel) when the sampled columns fill at
// least one tile a group; returns whether it launched.  Every 4th column
// is sampled where the FMAs cost (D >= 16), every column at D = 2.
template <int TM>
cudaError_t launch_bound(const float* a, const float* b, const float* a_sq,
                         const float* b_sq, unsigned* bound, int m, int n,
                         int dp, int k, int self_offset, cudaStream_t stream,
                         bool* launched) {
  *launched = false;
  const int step = dp >= 16 ? 4 : 1;
  const int n_tiles = ((n + step - 1) / step + kBN - 1) / kBN;
  if (n_tiles < k) return cudaSuccess;
  const int pitch = pitch_for(dp);
  const size_t smem =
      (static_cast<size_t>(16 * TM) + kStages * kBN) * pitch * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      row_bound_kernel<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, row_bound_kernel<TM>, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int row_tiles = (m + 16 * TM - 1) / (16 * TM);
  int s = max(1, min((per_sm * sms + row_tiles - 1) / row_tiles, n_tiles));
  const int tps = (n_tiles + s - 1) / s;
  s = (n_tiles + tps - 1) / tps;
  err = cudaMemsetAsync(bound, 0xff, static_cast<size_t>(m) * k *
                        sizeof(unsigned), stream);
  if (err != cudaSuccess) return err;
  row_bound_kernel<TM><<<dim3(row_tiles, s), kThreads, smem, stream>>>(
      a, b, a_sq, b_sq, bound, m, n, dp, pitch, k, self_offset, step, tps);
  *launched = true;
  return cudaGetLastError();
}

template <int TM, int Q>
cudaError_t launch(const float* a, const float* b, const float* a_sq,
                   const float* b_sq, unsigned long long* part,
                   unsigned* bound, float* out_d, int* out_i, int m, int n,
                   int dp, int k, int self_offset, int splits,
                   cudaStream_t stream) {
  int want_splits = 0, tps = 0;
  cudaError_t err = plan<TM, Q>(m, n, dp, &want_splits, &tps);
  if (err != cudaSuccess) return err;
  if (want_splits != splits) return cudaErrorInvalidValue;
  bool bounded = false;
  err = launch_bound<TM>(a, b, a_sq, b_sq, bound, m, n, dp, k, self_offset,
                         stream, &bounded);
  if (err != cudaSuccess) return err;
  const int pitch = pitch_for(dp);
  const dim3 grid((m + 16 * TM - 1) / (16 * TM), splits);
  pairwise_topk_kernel<TM, Q><<<grid, kThreads, smem_bytes<TM, Q>(pitch),
                                stream>>>(a, b, a_sq, b_sq,
                                          bounded ? bound : nullptr, part, m,
                                          n, dp, pitch, k, self_offset, tps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int per_block = kThreads / 32;
  merge_splits_kernel<<<(m + per_block - 1) / per_block, kThreads, 0,
                        stream>>>(part, out_d, out_i, m, k, splits);
  return cudaGetLastError();
}

// the instantiation for k: lists of 16, 32, 64 or 128 keys a row
#define IRP_TOPK_DISPATCH(k, FN, ...)                                   \
  ((k) <= 16 ? FN<8, 1>(__VA_ARGS__) : (k) <= 32 ? FN<8, 2>(__VA_ARGS__) \
   : (k) <= 64 ? FN<4, 4>(__VA_ARGS__) : FN<4, 8>(__VA_ARGS__))

bool shape_ok(int m, int n, int dp, int k) {
  return m > 0 && n > 0 && dp > 0 && dp % 4 == 0 && dp <= kMaxD && k >= 1 &&
         k <= kMaxK && k <= n;
}

}  // namespace

extern "C" {

// Column splits for an (m, n) problem of padded width dp and k: the
// wrapper allocates scratch of splits * m * k 64-bit keys.  Returns the
// count, or -(CUDA error) on failure.
int irp_pairwise_topk_splits(int m, int n, int dp, int k) {
  if (!shape_ok(m, n, dp, k)) return -static_cast<int>(cudaErrorInvalidValue);
  int splits = 0, tps = 0;
  const cudaError_t err =
      IRP_TOPK_DISPATCH(k, plan, m, n, dp, &splits, &tps);
  return err == cudaSuccess ? splits : -static_cast<int>(err);
}

// a (m, dp), b (n, dp), a_sq (m,), b_sq (n,) float32, contiguous, rows
// 16-byte aligned (dp a multiple of 4, at most 128); part: splits * m * k
// 64-bit keys of scratch; bound: m * k 32-bit words of scratch; out_d
// (m, k) float32 and out_i (m, k) int32.
// The caller guarantees at least k columns a row once column
// i + self_offset is left out (self_offset < 0: none is).  Returns
// cudaGetLastError() after the launches.
int irp_pairwise_topk(const void* a, const void* b, const void* a_sq,
                      const void* b_sq, void* part, void* bound, void* out_d,
                      void* out_i, int m, int n, int dp, int k,
                      int self_offset, int splits, void* stream) {
  if (!shape_ok(m, n, dp, k) || splits < 1 || splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  const float* fa_sq = static_cast<const float*>(a_sq);
  const float* fb_sq = static_cast<const float*>(b_sq);
  auto* keys = static_cast<unsigned long long*>(part);
  float* od = static_cast<float*>(out_d);
  int* oi = static_cast<int*>(out_i);
  const cudaError_t err =
      IRP_TOPK_DISPATCH(k, launch, fa, fb, fa_sq, fb_sq, keys,
                        static_cast<unsigned*>(bound), od, oi, m, n, dp, k,
                        self_offset, splits, s);
  return static_cast<int>(err);
}

const char* irp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
