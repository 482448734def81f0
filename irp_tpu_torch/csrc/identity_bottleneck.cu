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
// Bound on this card (989 TFLOP/s bf16, 3.35 TB/s), x read and out written
// once, weights once: at B=32, layer1 (56,56,256,64) 0.0307 ms (bytes),
// layer2 (28,28,512,128) 0.0155 ms (bytes), layer3 (14,14,1024,256)
// 0.0141 ms (operations: 14 GFLOP at every shape); at B=256, 0.2454 /
// 0.1229 / 0.1130 ms.  Measured times are in PERF.md (chip_smoke.py).
//
// Design.  The work unit is one image x a band of `band` output rows,
// chosen per shape by the wrapper (ops/cuda_resnet.py::bottleneck_plan:
// about one 128-pixel pass of output a unit).  A persistent grid of one
// block per SM walks the units.  A block has three warpgroups: two
// consumers, which run every matrix product as wgmma.mma_async m64nNk16
// (A from registers, B from shared memory, f32 accumulators in
// registers), and one producer thread (setmaxnreg gives its registers to
// the consumers), which keeps a ring of 2-4 stages of shared memory filled
// by TMA through mbarrier full/empty pairs, running ahead across unit
// boundaries.  A stage is one K-chunk of 64 rows of a weight matrix, as
// 64 x 64 boxes in 128-byte swizzle that wgmma reads as an N-major B
// through the transpose bit, plus in phase 1 the chunk of 128 pixels of x.
// Each consumer owns 64 of the 128 rows of a pass, so one weight byte read
// from L2 feeds 128 pixels.
// - Phase 1: a for the band plus a one-row halo (conv1 recomputed there),
//   x rows fed to wgmma by ldmatrix from the swizzled TMA tile; the
//   epilogue writes bf16(relu(acc + b1)) into an `a` buffer of
//   (band + 2) rows in shared memory, pixels skewed by 16 bytes.
// - Phases 2 and 3, per 64-pixel tile of output pixels (no pad columns):
//   the 3x3 conv is one GEMM with K = 9M whose A rows are gathered by
//   ldmatrix's per-lane addresses, tap (dy, dx) of pixel q at a[q + dy,
//   dx] or at a zero row outside the image; its accumulators, after bias,
//   relu and bf16, are exactly wgmma's A-register layout, so bmap never
//   leaves registers and conv3 runs on it at once.  conv3's epilogue
//   stages bf16(acc + b3) in the x part of the chunk's last stage, then
//   adds the residual x (loaded one 64-column round ahead) and stores
//   with coalesced 16-byte accesses.
// Shared memory is sized per shape: the ring by the widest weight chunk of
// the shape, the `a` buffer by the band; the biases live there too, since
// L1 has little room left beside it.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kConsumers = 2;                 // consumer warpgroups
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kTileRows = 64;                 // rows of a wgmma tile
constexpr int kPassRows = kConsumers * kTileRows;
constexpr int kKC = 64;                       // K rows per ring stage
constexpr int kXBytes = kPassRows * kKC * 2;  // phase 1's x chunk
constexpr int kBoxBytes = kKC * 64 * 2;       // one 64 x 64 weight box
constexpr int kMaxStages = 4;
constexpr int kSkew = 8;                      // bf16 pad per `a` pixel
constexpr int kMaxSmem = 232448;              // bytes a block may use

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

struct Params {
  const bf16* x;
  bf16* out;
  const float* b1;
  const float* b2;
  const float* b3;
  int h, w, c;
  int band, n_bands, units;
  int stages, stage_bytes;
  // byte offsets from the 1024-aligned base of shared memory
  int a_off, zero_off, bias_off, bar_off;
};

// One work unit: image img, output rows [r0, r0 + rows); phase 1 covers
// the pixels [p_lo, p_hi) of the image (band plus halo, clipped).
struct Unit {
  int img, r0, rows, p_lo, p_hi, passes1, nq, passes2;
};

__device__ __forceinline__ Unit unit_at(const Params& p, int u) {
  Unit t;
  t.img = u / p.n_bands;
  t.r0 = (u - t.img * p.n_bands) * p.band;
  t.rows = min(p.band, p.h - t.r0);
  t.p_lo = max(t.r0 - 1, 0) * p.w;
  t.p_hi = min(t.r0 + t.rows + 1, p.h) * p.w;
  t.passes1 = ceil_div(t.p_hi - t.p_lo, kPassRows);
  t.nq = t.rows * p.w;
  t.passes2 = ceil_div(t.nq, kPassRows);
  return t;
}

struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
// A phase that never completes (a fault in the stage sequence) traps
// after about 2^34 cycles, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

// TMA: the box at (c0 = column, c1 = row) of a 2-D tensor map into shared
// memory, completion counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128) : "memory");
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and register i receives matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// No "memory" clobber: the global loads of an epilogue may move across it;
// the barrier that follows (bar.sync) orders it before the readers.
__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v));
}

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ float2 lds2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0,%1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr));
  return v;
}

// The 128 threads of consumer warpgroup wg (named barriers 2 and 3).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// relu(x + y) of two bf16 pairs in one instruction: x * 1 + y, rounded
// once to bf16 (as the sum in f32 rounds), then clamped at 0
__device__ __forceinline__ uint32_t add_relu2(uint32_t x, uint32_t y) {
  uint32_t r;
  asm("fma.rn.relu.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r)
      : "r"(x), "r"(0x3F803F80u), "r"(y));
  return r;
}

// wgmma's B descriptor for a K-chunk stage: 64-column boxes of 64 rows x
// 128 bytes in 128-byte swizzle, N-major; the leading offset steps to the
// next box (64 columns), the stride offset to the next 8 rows.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kBoxBytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Keep the compiler from moving a register's reads or writes across an
// asynchronous wgmma that uses it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void reg_fence(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// d (64 x N, f32) += a (64 x 16, bf16, registers) * B (16 x N, bf16,
// shared memory, N-major).
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint32_t a0, uint32_t a1,
                                          uint32_t a2, uint32_t a3, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, {%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint32_t a0, uint32_t a1,
                                          uint32_t a2, uint32_t a3, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, {%64,%65,%66,%67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint32_t a0, uint32_t a1,
                                          uint32_t a2, uint32_t a3, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
      "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,"
      "%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127"
      "}, {%128,%129,%130,%131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint32_t a0,
                                      uint32_t a1, uint32_t a2, uint32_t a3,
                                      uint64_t desc) {
  if constexpr (N == 64) wgmma_n64(d, a0, a1, a2, a3, desc);
  else if constexpr (N == 128) wgmma_n128(d, a0, a1, a2, a3, desc);
  else wgmma_n256(d, a0, a1, a2, a3, desc);
}

// acc += the products of nk ring stages, A (64 x 64, four k16 fragments
// from registers) by W (64 x N at the stage's weight part), two stages in
// flight below N = 256: stage k + 1's fragments load and its wgmma issue
// while stage k's run.  load(k, f) acquires stage k, fills f and returns
// the stage's address; retire() releases the oldest stage, once its wgmma
// is done.
template <int N, class Load, class Retire>
__device__ __forceinline__ void gemm_stages(float (&acc)[N / 2], int nk,
                                            Load load, Retire retire) {
  uint32_t fr[2][4][4];
  auto issue = [&](int k, uint32_t (&f)[4][4]) {
    const uint32_t st = load(k, f);
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
      wgmma<N>(acc, f[s][0], f[s][1], f[s][2], f[s][3],
               b_desc(st + kXBytes + s * 16 * 128));
    wgmma_commit();
  };
  auto done = [&](uint32_t (&f)[4][4], bool all) {
    if (all) wgmma_wait_all();
    else wgmma_wait_one();
    reg_fence(acc);
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) reg_fence(f[s][i]);
    retire();
  };
  if constexpr (N == 256) {
    // 128 accumulator registers leave no room for a second set of
    // fragments (it spills): one stage at a time
#pragma unroll 1
    for (int k = 0; k < nk; ++k) {
      issue(k, fr[0]);
      done(fr[0], true);
    }
    return;
  }
  issue(0, fr[0]);
  int k = 1;
#pragma unroll 1
  for (; k + 1 < nk; k += 2) {
    issue(k, fr[1]);
    done(fr[0], false);
    issue(k + 1, fr[0]);
    done(fr[1], false);
  }
  if (k < nk) {
    issue(k, fr[1]);
    done(fr[0], false);
    done(fr[1], true);
  } else {
    done(fr[0], true);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.0f;
}

// Columns of one phase's GEMM, by M: phase 1 (N1) and phase 2 (N2) keep
// their accumulators within 128 registers a thread.
template <int M>
struct Cols {
  static constexpr int N1 = M < 256 ? M : 256;
  static constexpr int N2 = M <= 256 ? M : 128;
  static constexpr int kPix = (M + kSkew) * 2;  // bytes per `a` pixel
};

// The producer thread: walks the same sequence of stages as the consumers
// and fills each one by TMA as soon as both consumers have released it.
template <int M, int N3>
__device__ __forceinline__ void produce(const CUtensorMap* tm_x,
                                        const CUtensorMap* tm_w1,
                                        const CUtensorMap* tm_w2,
                                        const CUtensorMap* tm_w3,
                                        const Params& p, uint32_t stage0,
                                        uint32_t full0, uint32_t empty0) {
  constexpr int N1 = Cols<M>::N1;
  constexpr int N2 = Cols<M>::N2;
  Ring ring;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Unit t = unit_at(p, u);
    const int px0 = t.img * p.h * p.w + t.p_lo;
    // phase 1: x chunk and w1 chunk
    for (int pass = 0; pass < t.passes1; ++pass)
      for (int n1c = 0; n1c < M / N1; ++n1c)
        for (int kc = 0; kc < p.c / kKC; ++kc) {
          const uint32_t full = full0 + 8 * ring.stage;
          const uint32_t dst = stage0 + ring.stage * p.stage_bytes;
          mbar_wait(empty0 + 8 * ring.stage, ring.phase ^ 1u);
          mbar_expect_tx(full, kXBytes + N1 / 64 * kBoxBytes);
          tma_load(dst, tm_x, full, kc * kKC, px0 + pass * kPassRows);
#pragma unroll
          for (int j = 0; j < N1 / 64; ++j)
            tma_load(dst + kXBytes + j * kBoxBytes, tm_w1, full,
                     n1c * N1 + j * 64, kc * kKC);
          ring.next(p.stages);
        }
    for (int pass = 0; pass < t.passes2; ++pass) {
      // phase 2: w2 chunks, then phase 3: w3 chunks
      for (int n2c = 0; n2c < M / N2; ++n2c)
        for (int kc = 0; kc < 9 * M / kKC; ++kc) {
          const uint32_t full = full0 + 8 * ring.stage;
          const uint32_t dst = stage0 + ring.stage * p.stage_bytes + kXBytes;
          mbar_wait(empty0 + 8 * ring.stage, ring.phase ^ 1u);
          mbar_expect_tx(full, N2 / 64 * kBoxBytes);
#pragma unroll
          for (int j = 0; j < N2 / 64; ++j)
            tma_load(dst + j * kBoxBytes, tm_w2, full, n2c * N2 + j * 64,
                     kc * kKC);
          ring.next(p.stages);
        }
      for (int n3c = 0; n3c < p.c / N3; ++n3c)
        for (int kc = 0; kc < M / kKC; ++kc) {
          const uint32_t full = full0 + 8 * ring.stage;
          const uint32_t dst = stage0 + ring.stage * p.stage_bytes + kXBytes;
          mbar_wait(empty0 + 8 * ring.stage, ring.phase ^ 1u);
          mbar_expect_tx(full, N3 / 64 * kBoxBytes);
#pragma unroll
          for (int j = 0; j < N3 / 64; ++j)
            tma_load(dst + j * kBoxBytes, tm_w3, full, n3c * N3 + j * 64,
                     kc * kKC);
          ring.next(p.stages);
        }
    }
  }
}

// The two consumer warpgroups.  Warpgroup wg owns rows [64 wg, 64 wg + 64)
// of each 128-row pass; warp `warp` of it rows 16 warp + [0, 16), and lane
// (g, tq) = (lane / 4, lane % 4) the accumulator rows g and g + 8, columns
// 8 j + 2 tq and 8 j + 2 tq + 1 of each 8-column block j.
template <int M, int N3>
__device__ __forceinline__ void consume(const Params& p, uint32_t stage0,
                                        uint32_t full0, uint32_t empty0,
                                        uint32_t a_addr, uint32_t zero_addr,
                                        uint32_t b1s) {
  constexpr int N1 = Cols<M>::N1;
  constexpr int N2 = Cols<M>::N2;
  constexpr int kPix = Cols<M>::kPix;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int my_row = wg * kTileRows + warp * 16;  // first row of this warp
  const uint32_t b2s = b1s + 4 * M;  // the biases in shared memory
  const uint32_t b3s = b2s + 4 * M;
  Ring next_full, next_free;  // stages are taken and given back in order
  auto acquire = [&]() -> uint32_t {
    mbar_wait(full0 + 8 * next_full.stage, next_full.phase);
    const uint32_t st = stage0 + next_full.stage * p.stage_bytes;
    next_full.next(p.stages);
    return st;
  };
  auto release = [&]() {
    if (lane == 0) mbar_arrive(empty0 + 8 * next_free.stage);
    next_free.next(p.stages);
  };

  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Unit t = unit_at(p, u);
    const int a_px0 = (t.r0 - 1) * p.w;  // image pixel of a's slot 0
    consumer_sync();  // the previous unit's phase 2 is done with `a`

    // Phase 1: a = bf16(relu(x . w1 + b1)) over pixels [p_lo, p_hi).
    // Rows past p_hi (the next band or image, or zeros past the tensor)
    // are computed and dropped.
    for (int pass = 0; pass < t.passes1; ++pass) {
#pragma unroll
      for (int n1c = 0; n1c < M / N1; ++n1c) {
        float acc[N1 / 2];
        zero(acc);
        const int xr = my_row + (lane & 15);  // ldmatrix row of the x chunk
        gemm_stages<N1>(
            acc, p.c / kKC,
            [&](int, uint32_t (&f)[4][4]) {
              const uint32_t st = acquire();
#pragma unroll
              for (int s = 0; s < 4; ++s)
                ldsm_x4(f[s], st + xr * 128 +
                                  (((2 * s + (lane >> 4)) ^ (xr & 7)) << 4));
              return st;
            },
            [&]() {
              // ldmatrix read the stage through the generic proxy; TMA
              // rewrites it through the async one
              asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
              release();
            });
        // rows g and g + 8 of this lane, biases loaded 8 blocks at a time
        const int px = t.p_lo + pass * kPassRows + my_row + g;
        const uint32_t dst = a_addr + (px - a_px0) * kPix;
#pragma unroll
        for (int nb0 = 0; nb0 < N1 / 8; nb0 += 8) {
          float2 bias[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            bias[i] = lds2(b1s + 4 * (n1c * N1 + (nb0 + i) * 8 + 2 * tq));
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            if (px + 8 * half >= t.p_hi) continue;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int nb = nb0 + i;
              const int col = n1c * N1 + nb * 8 + 2 * tq;
              st_shared(dst + 8 * half * kPix + col * 2,
                        pack2(fmaxf(acc[4 * nb + 2 * half] + bias[i].x, 0.0f),
                              fmaxf(acc[4 * nb + 2 * half + 1] + bias[i].y,
                                    0.0f)));
            }
          }
        }
      }
    }
    consumer_sync();  // `a` is complete

    for (int pass = 0; pass < t.passes2; ++pass) {
      // Phase 2: bmap = bf16(relu(conv3x3(a) + b2)) for output pixels q of
      // the band; this lane's ldmatrix row is pixel q = (qr, qc).
      const int q = pass * kPassRows + my_row + (lane & 15);
      const bool qv = q < t.nq;
      const int qr = qv ? q / p.w : 0;
      const int qc = qv ? q - qr * p.w : 0;
      uint32_t bm[M / 4];  // bmap as A fragments: k16 block kb in [4kb, 4kb+4)
#pragma unroll
      for (int n2c = 0; n2c < M / N2; ++n2c) {
        float acc[N2 / 2];
        zero(acc);
        gemm_stages<N2>(
            acc, 9 * M / kKC,
            [&](int kc, uint32_t (&f)[4][4]) {
              const int tap = kc * kKC / M;
              const int kin = kc * kKC - tap * M;
              const int dy = tap / 3;
              const int dx = tap - 3 * dy;
              const int ir = t.r0 + qr + dy - 1;
              const int ic = qc + dx - 1;
              const bool in =
                  qv && ir >= 0 && ir < p.h && ic >= 0 && ic < p.w;
              const uint32_t row =
                  (in ? a_addr + ((qr + dy) * p.w + ic) * kPix : zero_addr) +
                  (kin + (lane >> 4) * 8) * 2;
              const uint32_t st = acquire();
#pragma unroll
              for (int s = 0; s < 4; ++s) ldsm_x4(f[s], row + s * 32);
              return st;
            },
            release);
        // accumulator blocks 2j and 2j + 1 are the A fragment of k16 block j
#pragma unroll
        for (int j = 0; j < N2 / 16; ++j) {
          const int col = n2c * N2 + 16 * j + 2 * tq;
          const float2 lo = lds2(b2s + 4 * col);
          const float2 hi = lds2(b2s + 4 * (col + 8));
          const int kb = n2c * N2 / 16 + j;
          bm[4 * kb] = pack2(fmaxf(acc[8 * j] + lo.x, 0.0f),
                             fmaxf(acc[8 * j + 1] + lo.y, 0.0f));
          bm[4 * kb + 1] = pack2(fmaxf(acc[8 * j + 2] + lo.x, 0.0f),
                                 fmaxf(acc[8 * j + 3] + lo.y, 0.0f));
          bm[4 * kb + 2] = pack2(fmaxf(acc[8 * j + 4] + hi.x, 0.0f),
                                 fmaxf(acc[8 * j + 5] + hi.y, 0.0f));
          bm[4 * kb + 3] = pack2(fmaxf(acc[8 * j + 6] + hi.x, 0.0f),
                                 fmaxf(acc[8 * j + 7] + hi.y, 0.0f));
        }
      }

      // Phase 3: out = relu(bf16(x + bf16(bmap . w3 + b3))).  The epilogue
      // goes through the x part of each column chunk's last stage, held
      // until it is done: a warpgroup writes y = bf16(acc + b3) for 64
      // columns into its 64 rows of 128 bytes (16-byte chunks swizzled by
      // row), then reads them back 16 bytes a thread, adds the residual x
      // and stores, both coalesced.  Thread wtid moves chunk wtid % 8 of
      // rows wtid / 8 + 16 k (global offsets, -1 past the band).
      const int wtid = threadIdx.x % 128;
      long long goff[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int qq = pass * kPassRows + wg * kTileRows + wtid / 8 + 16 * k;
        const int rr = qq / p.w;
        goff[k] = qq < t.nq
                      ? ((static_cast<long long>(t.img) * p.h + t.r0 + rr) *
                             p.w + (qq - rr * p.w)) * p.c + (wtid % 8) * 8
                      : -1;
      }
      // the residual x of each 64-column round is loaded one round ahead
      uint4 x_next[4];
      auto load_x = [&](int col0) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (goff[k] >= 0)
            x_next[k] =
                __ldg(reinterpret_cast<const uint4*>(p.x + goff[k] + col0));
      };
      load_x(0);
      for (int n3c = 0; n3c < p.c / N3; ++n3c) {
        float acc[N3 / 2];
        zero(acc);
        uint32_t st = 0;
#pragma unroll
        for (int kc = 0; kc < M / kKC; ++kc) {
          st = acquire();
          reg_fence(acc);
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int kb = 4 * kc + s;
            wgmma<N3>(acc, bm[4 * kb], bm[4 * kb + 1], bm[4 * kb + 2],
                      bm[4 * kb + 3], b_desc(st + kXBytes + s * 16 * 128));
          }
          wgmma_commit();
          wgmma_wait_all();
          reg_fence(acc);
#pragma unroll
          for (int i = 0; i < 16; ++i) reg_fence(bm[16 * kc + i]);
          if (kc + 1 < M / kKC) release();
        }
        const uint32_t stg = st + wg * (kXBytes / kConsumers);
#pragma unroll
        for (int j = 0; j < N3 / 64; ++j) {
          const int col0 = n3c * N3 + 64 * j;
          uint4 xv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) xv[k] = x_next[k];
          if (col0 + 64 < p.c) load_x(col0 + 64);
          float2 bias[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            bias[i] = lds2(b3s + 4 * (col0 + 8 * i + 2 * tq));
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = warp * 16 + g + 8 * half;  // row % 8 == g
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int nb = 8 * j + i;
              st_shared(stg + row * 128 + ((i ^ g) << 4) + tq * 4,
                        pack2(acc[4 * nb + 2 * half] + bias[i].x,
                              acc[4 * nb + 2 * half + 1] + bias[i].y));
            }
          }
          warpgroup_sync(wg);
          uint4 yv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int row = wtid / 8 + 16 * k;
            yv[k] = ld_shared_v4(stg + row * 128 +
                                 (((wtid % 8) ^ (row & 7)) << 4));
          }
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (goff[k] >= 0)
              *reinterpret_cast<uint4*>(p.out + goff[k] + col0) =
                  make_uint4(add_relu2(xv[k].x, yv[k].x),
                             add_relu2(xv[k].y, yv[k].y),
                             add_relu2(xv[k].z, yv[k].z),
                             add_relu2(xv[k].w, yv[k].w));
          warpgroup_sync(wg);  // the staging rows are free again
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        release();
      }
    }
  }
}

template <int M, int N3>
__global__ void __launch_bounds__(kThreads, 1)
identity_bottleneck_kernel(const __grid_constant__ CUtensorMap tm_x,
                           const __grid_constant__ CUtensorMap tm_w1,
                           const __grid_constant__ CUtensorMap tm_w2,
                           const __grid_constant__ CUtensorMap tm_w3,
                           const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // TMA's swizzle atoms
  const uint32_t full0 = base + p.bar_off;
  const uint32_t empty0 = full0 + 8 * kMaxStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers * 4);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  {
    unsigned char* gen = smem_raw + (base - raw);
    uint4* zero_row = reinterpret_cast<uint4*>(gen + p.zero_off);
    for (int i = threadIdx.x; i < Cols<M>::kPix / 16; i += kThreads)
      zero_row[i] = make_uint4(0u, 0u, 0u, 0u);
    // b1, b2, b3 side by side: the epilogues read them from shared memory,
    // since L1 is mostly given over to shared memory here
    float* bias = reinterpret_cast<float*>(gen + p.bias_off);
    for (int i = threadIdx.x; i < 2 * M + p.c; i += kThreads)
      bias[i] = i < M ? p.b1[i] : i < 2 * M ? p.b2[i - M] : p.b3[i - 2 * M];
  }
  __syncthreads();
  // one if/else for the whole kernel, so that setmaxnreg takes effect
  if (threadIdx.x >= kConsumers * 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128)
      produce<M, N3>(&tm_x, &tm_w1, &tm_w2, &tm_w3, p, base, full0, empty0);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    consume<M, N3>(p, base, full0, empty0, base + p.a_off,
                   base + p.zero_off, base + p.bias_off);
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so that the
// library needs no -lcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A row-major (rows, cols) bf16 matrix read in boxes of box_rows x 64
// columns (128 bytes, the 128-byte swizzle's width).
bool make_map(EncodeTiledFn encode, CUtensorMap* map, const void* ptr,
              long long rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Maps {
  CUtensorMap x, w1, w2, w3;
};

template <int M, int N3>
cudaError_t launch(const Maps& maps, const Params& p, int grid, int smem,
                   cudaStream_t stream) {
  auto kernel = identity_bottleneck_kernel<M, N3>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(maps.x, maps.w1, maps.w2, maps.w3,
                                           p);
  return cudaGetLastError();
}

// Phase 3's columns per GEMM: 128, or 64 where c is an odd multiple of 64
// or m = 512 (bmap's m / 4 registers leave room for 32 accumulators); 0
// for an m the kernel does not take.
int phase3_cols(int c, int m) {
  const int cap = (m == 64 || m == 128 || m == 256) ? 128 : m == 512 ? 64 : 0;
  for (int n = cap; n >= 64; n /= 2)
    if (c % n == 0) return n;
  return 0;
}

long long up128(long long b) { return (b + 127) / 128 * 128; }

}  // namespace

extern "C" {

// x, out: (batch, h, w, c) bf16; w1 (c, m), w2 (3, 3, m, m), w3 (m, c)
// bf16; b1, b2 (m,), b3 (c,) f32; every pointer 16-byte aligned.  band:
// output rows per work unit (ops/cuda_resnet.py::bottleneck_plan), made
// narrower here where its `a` buffer leaves too little shared memory.
// Takes c % 64 == 0 and m in {64, 128, 256, 512} when a one-row band and
// two ring stages fit in shared memory.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape it does not take.
int irp_identity_bottleneck(const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, const void* w3,
                            const void* b3, void* out, int batch, int h,
                            int w, int c, int m, int band, void* stream) {
  const int n3 = phase3_cols(c, m);
  if (n3 == 0 || c % 64 != 0 || h < 1 || w < 1 || batch < 1 || band < 1 ||
      band > h)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n1 = m < 256 ? m : 256;
  const int n2 = m <= 256 ? m : 128;
  const int stage_bytes =
      kXBytes + (n1 > n2 ? (n1 > n3 ? n1 : n3) : (n2 > n3 ? n2 : n3)) / 64 *
                    kBoxBytes;
  const long long pix = (m + kSkew) * 2;
  const long long zero_bytes = up128(pix);
  const long long bias_bytes = up128((2LL * m + c) * 4);
  // ring stages beside the `a` buffer of a band of b rows (at most 4)
  auto stages_beside = [&](int b) {
    const long long fixed = 1024 + up128((b + 2LL) * w * pix) + zero_bytes +
                            bias_bytes + 2 * kMaxStages * 8;
    const long long n = (kMaxSmem - fixed) / stage_bytes;
    return n < kMaxStages ? n : kMaxStages;
  };
  // the band, narrowed until its `a` buffer leaves room for three stages,
  // or for two where no band does
  for (int need = 3; need >= 2; --need) {
    int b = band;
    while (b > 1 && stages_beside(b) < need) --b;
    if (stages_beside(b) >= need) {
      band = b;
      break;
    }
  }
  const long long stages = stages_beside(band);
  if (stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const long long a_bytes = up128((band + 2LL) * w * pix);
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);

  Params p;
  p.x = static_cast<const bf16*>(x);
  p.out = static_cast<bf16*>(out);
  p.b1 = static_cast<const float*>(b1);
  p.b2 = static_cast<const float*>(b2);
  p.b3 = static_cast<const float*>(b3);
  p.h = h;
  p.w = w;
  p.c = c;
  p.band = band;
  p.n_bands = ceil_div(h, band);
  p.units = batch * p.n_bands;
  p.stages = static_cast<int>(stages);
  p.stage_bytes = stage_bytes;
  p.a_off = p.stages * stage_bytes;
  p.zero_off = static_cast<int>(p.a_off + a_bytes);
  p.bias_off = static_cast<int>(p.zero_off + zero_bytes);
  p.bar_off = static_cast<int>(p.bias_off + bias_bytes);
  const int smem = 1024 + p.bar_off + 2 * kMaxStages * 8;

  Maps maps;
  if (!make_map(encode, &maps.x, x, 1LL * batch * h * w, c, kPassRows) ||
      !make_map(encode, &maps.w1, w1, c, m, kKC) ||
      !make_map(encode, &maps.w2, w2, 9LL * m, m, kKC) ||
      !make_map(encode, &maps.w3, w3, m, c, kKC))
    return static_cast<int>(cudaErrorInvalidValue);

  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = p.units < sms ? p.units : sms;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m * 1000 + n3) {
    case 64064: err = launch<64, 64>(maps, p, grid, smem, s); break;
    case 64128: err = launch<64, 128>(maps, p, grid, smem, s); break;
    case 128064: err = launch<128, 64>(maps, p, grid, smem, s); break;
    case 128128: err = launch<128, 128>(maps, p, grid, smem, s); break;
    case 256064: err = launch<256, 64>(maps, p, grid, smem, s); break;
    case 256128: err = launch<256, 128>(maps, p, grid, smem, s); break;
    case 512064: err = launch<512, 64>(maps, p, grid, smem, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* irp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
