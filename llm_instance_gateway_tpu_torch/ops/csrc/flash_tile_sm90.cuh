// The bf16 body of flash prefill and chunk attention on Hopper's tensor
// cores (sm_90a), shared by flash_prefill.cu (start = 0, S_kv = S) and
// chunk_attention.cu (a chunk at a runtime offset against a cache lane);
// flash_tile.cuh dispatches bf16 here and keeps f32 on CUDA-core FMAs.
//
// Replaces, for bf16: llm_instance_gateway_tpu/ops/pallas_attention.py::
// flash_attention_bhsd and chunk_attention_pallas (the shared
// _softmax_block recurrence).
//
// q/out [B, C, H, hd], k/v [B, S_kv, K, hd] bf16; query head h reads KV
// head h / (H/K).  Query row i sits at position start + i and attends keys
// j <= start + i with j < S_kv.  Bound on an H100: the operations of QK^T
// and PV over the live keys at 989 TFLOP/s bf16 (the bytes, q/k/v/out read
// or written once, are below it from S ~ 740 at Llama-3-8B's heads).
//
// Design (FlashAttention-3's shape, simple first): one block per (128-row
// query tile, query head, batch row), three warpgroups.  Warpgroup 0 is
// the producer: one thread starts the TMA loads, the Q tile once and the K/V
// tiles (BK = 128 keys at hd <= 128, 64 at hd = 256) through a two-stage
// ring guarded by full/empty mbarriers.  Warpgroups 1 and 2 are consumers
// of 64 query rows each and share every K/V tile.  Tiles arrive in 128-byte
// swizzled 64-column slabs, the layout wgmma reads.  Per tile a consumer
//   S = Q K^T   wgmma m64nBKk16, both operands K-major in shared memory,
//               f32 accumulators; the scale 1/sqrt(hd) (times log2 e, for
//               exp2) multiplies the f32 scores;
//   masks       only the tile that straddles its rows' diagonal or the lane
//               end (logit -1e30); interior tiles skip the mask;
//   softmax     online, in registers on the accumulator fragment: row max
//               and sum by quad shuffles, O rescaled by exp(m_old - m_new),
//               l summed from the f32 p;
//   O += P V    P rounded to bf16 in registers as wgmma's A operand, V the
//               MN-major (transposed) B operand in shared memory, f32 sums;
// then arrives on the stage's empty barrier.  The epilogue writes acc /
// max(l, 1e-30) in bf16 with guarded register stores: query rows >= n_q
// (a ragged last tile) are never stored.  Tiles past the block's reach,
// min(start + its last row, S_kv - 1), are never requested; a tile past
// one consumer's own reach is waited on and released without math.  The
// tensor maps are 4-D {hd, heads, rows, batch}, so a ragged tile reads
// zeros past its batch row, never the next row's keys.  Blocks launch
// longest query tile first (the tile index is the slowest grid axis:
// blocks dispatch in linear order, x fastest).
//
// Numerics: the one departure from the TPU kernel (which keeps p in f32
// for PV) is P rounded to bf16 before PV, a relative 2^-9 per probability;
// the scores differ only in f32 summation order.
// tests/test_torch_flash_numerics.py holds an emulation of this rounding
// against the Pallas kernels on the CPU.
//
// Internal linkage (anonymous namespace): two kernel libraries include
// this header, and a function-local static here would otherwise be one
// GNU-unique symbol shared by both.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_tile_sm90 {
namespace {

constexpr int kBQ = 128;       // query rows per block: two consumers x 64
constexpr int kThreads = 384;  // producer + two consumer warpgroups
constexpr int kStages = 2;     // K/V ring depth
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
// A wait this long means a lost barrier phase: trap rather than hang.
constexpr long long kHangCycles = 1ll << 34;

template <int HD>
struct Cfg {
  static constexpr int BK = HD <= 128 ? 128 : 64;  // keys per K/V tile
  static constexpr int SLABS = HD / 64;            // 64-column slabs
  static constexpr int ON = HD < 128 ? HD : 128;   // O columns per wgmma
  static constexpr int OC = HD / ON;               // O wgmmas per k-step
  static constexpr int Q_SLAB = kBQ * 128;         // bytes of one Q slab
  static constexpr int KV_SLAB = BK * 128;         // ... of one K/V slab
  static constexpr int Q_BYTES = Q_SLAB * SLABS;
  static constexpr int KV_BYTES = KV_SLAB * SLABS;
  static constexpr int K_OFF = Q_BYTES;            // Q | K ring | V ring
  static constexpr int V_OFF = K_OFF + kStages * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + kStages * KV_BYTES;
  // 1 + 3 * kStages barriers, and slack to align the base to 1024 bytes
  // (the 128-byte swizzle repeats every 1024).
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 3 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// One arrival that also expects `bytes` of TMA transactions.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the completion of the barrier phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > kHangCycles) __trap();
}

// TMA: one box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle.  K-major tiles
// (Q, K): rows of 128 bytes, 8-row groups 1024 bytes apart (SBO); the LBO
// is unused.  MN-major tiles (V as PV's B): 64-column slabs `lbo` bytes
// apart along N, 8-key groups 1024 bytes apart along K (SBO).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
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

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (as CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64]; A and B K-major in shared
// memory; D is overwritten when scale_d is 0.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128]; A and B K-major in shared
// memory; D is overwritten when scale_d is 0.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64]; A in registers, B MN-major
// (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128]; A in registers, B MN-major
// (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, a, b, scale_d);
  else wgmma_ss_n128(d, a, b, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, b);
  else wgmma_rs_n128(d, a, b);
}

// kLse (the training forward, flash_backward.cu) also stores each stored
// row's log-sum-exp of its scaled logits in base 2, m + log2(l) (the
// kernel's own log2 domain: lse2 = lse / ln 2), f32 [B, H, n_q]; the
// serving instantiation (kLse false) never touches `lse`.
template <int HD, bool kLse = false>
__global__ void __launch_bounds__(kThreads, 1) flash_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ out,
    int n_q, int s_kv, int start, int n_heads, int n_kv, float scale_log2,
    float* __restrict__ lse) {
  using C = Cfg<HD>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base, k_s = base + C::K_OFF, v_s = base + C::V_OFF;
  const uint32_t q_full = base + C::BAR_OFF;
  auto k_full = [&](int st) { return q_full + 8 * (1 + st); };
  auto v_full = [&](int st) { return q_full + 8 * (1 + kStages + st); };
  auto empty = [&](int st) { return q_full + 8 * (1 + 2 * kStages + st); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // longest tiles first
  const int kh = h / (n_heads / n_kv);
  // Last key the block's stored rows reach, clamped to the lane.
  const int reach = min(start + min(q0 + kBQ, n_q) - 1, s_kv - 1);
  const int n_tiles = reach / BK + 1;
  const int n_cons = q0 + 64 < n_q ? 2 : 1;  // consumers with stored rows

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), 4 * n_cons);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (wg == 0) {
    // ---- producer: one thread starts every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int s = 0; s < C::SLABS; ++s)
        tma_load(q_s + s * C::Q_SLAB, &q_map, q_full, 64 * s, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(empty(st), (t / kStages - 1) & 1);
        mbar_expect_tx(k_full(st), C::KV_BYTES);
#pragma unroll
        for (int s = 0; s < C::SLABS; ++s)
          tma_load(k_s + st * C::KV_BYTES + s * C::KV_SLAB, &k_map,
                   k_full(st), 64 * s, kh, t * BK, b);
        mbar_expect_tx(v_full(st), C::KV_BYTES);
#pragma unroll
        for (int s = 0; s < C::SLABS; ++s)
          tma_load(v_s + st * C::KV_BYTES + s * C::KV_SLAB, &v_map,
                   v_full(st), 64 * s, kh, t * BK, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int q0c = q0 + 64 * (wg - 1);
    if (q0c < n_q) {
      const int warp = tid / 32, lane = tid % 32;
      const int r_lo = 16 * warp + lane / 4;  // rows r_lo and r_lo + 8
      const int pos0 = start + q0c;           // the consumer's first row
      const int my_reach = min(start + min(q0c + 64, n_q) - 1, s_kv - 1);
      const uint32_t qa = q_s + (wg - 1) * 64 * 128;

      float o[C::OC][C::ON / 2];
      float s[BK / 2];
#pragma unroll
      for (int oc = 0; oc < C::OC; ++oc)
#pragma unroll
        for (int i = 0; i < C::ON / 2; ++i) o[oc][i] = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

      mbar_wait(q_full, 0);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        const uint32_t phase = (t / kStages) & 1;
        const int k0 = t * BK;
        mbar_wait(k_full(st), phase);
        if (k0 > my_reach) {  // past this consumer's rows: release only
          if (lane == 0) mbar_arrive(empty(st));
          continue;
        }

        // S = Q K^T on the tensor cores (hd / 16 k-steps of 16).
        const uint32_t kb = k_s + st * C::KV_BYTES;
        fence_regs(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;  // 16 bf16 along the row
          wgmma_ss<BK>(s, smem_desc(qa + (kk / 4) * C::Q_SLAB + off, 16),
                       smem_desc(kb + (kk / 4) * C::KV_SLAB + off, 16),
                       kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);

        // Scale (log2 domain), mask the straddling tile, online softmax.
        const bool masked = k0 + BK - 1 > pos0 || k0 + BK > s_kv;
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[4 * j + e] * scale_log2;
            if (masked) {
              const int col = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
              const int pos = pos0 + r_lo + 8 * (e >> 1);
              if (col > pos || col >= s_kv) x = kNegInf;
            }
            s[4 * j + e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r]);
          corr[r] = exp2f(m[r] - m_new);
          m[r] = m_new;
          l[r] *= corr[r];
        }
        uint32_t p[BK / 16][4];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const float p0 = exp2f(s[4 * j] - m[0]);
          const float p1 = exp2f(s[4 * j + 1] - m[0]);
          const float p2 = exp2f(s[4 * j + 2] - m[1]);
          const float p3 = exp2f(s[4 * j + 3] - m[1]);
          l[0] += p0 + p1;  // l from the f32 p
          l[1] += p2 + p3;
          // Accumulator layout -> wgmma A fragment of k-step j / 2.
          p[j / 2][2 * (j % 2)] = pack_bf16(p0, p1);
          p[j / 2][2 * (j % 2) + 1] = pack_bf16(p2, p3);
        }
#pragma unroll
        for (int oc = 0; oc < C::OC; ++oc)
#pragma unroll
          for (int i = 0; i < C::ON / 2; ++i) o[oc][i] *= corr[(i >> 1) & 1];

        // O += P V on the tensor cores (BK / 16 k-steps over the keys).
        const uint32_t vb = v_s + st * C::KV_BYTES;
        mbar_wait(v_full(st), phase);
#pragma unroll
        for (int oc = 0; oc < C::OC; ++oc) fence_regs(o[oc]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int oc = 0; oc < C::OC; ++oc)
            wgmma_rs<C::ON>(o[oc], p[kk],
                            smem_desc(vb + oc * (C::ON / 64) * C::KV_SLAB +
                                          kk * 16 * 128,
                                      C::KV_SLAB));
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int oc = 0; oc < C::OC; ++oc) fence_regs(o[oc]);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(st));
      }

      // Epilogue: acc / max(l, 1e-30) in bf16; rows >= n_q are not stored.
      float den[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        den[r] = fmaxf(l[r], 1e-30f);
      }
      if constexpr (kLse) {
        if (lane % 4 == 0) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = q0c + r_lo + 8 * r;
            if (row < n_q)
              lse[(static_cast<size_t>(b) * n_heads + h) * n_q + row] =
                  m[r] + log2f(l[r]);
          }
        }
      }
      const size_t row_stride = static_cast<size_t>(n_heads) * HD;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0c + r_lo + 8 * r;
        if (row >= n_q) continue;
        __nv_bfloat16* orow = out + (static_cast<size_t>(b) * n_q + row) *
                                        row_stride +
                              static_cast<size_t>(h) * HD + 2 * (lane % 4);
#pragma unroll
        for (int oc = 0; oc < C::OC; ++oc)
#pragma unroll
          for (int j = 0; j < C::ON / 8; ++j)
            *reinterpret_cast<uint32_t*>(orow + oc * C::ON + 8 * j) =
                pack_bf16(o[oc][4 * j + 2 * r] / den[r],
                          o[oc][4 * j + 2 * r + 1] / den[r]);
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime,
// so the libraries need no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 [batch, rows, heads, hd] tensor as a 4-D map {hd, heads, rows,
// batch} with boxes of 64 columns x one head x `box_rows` rows, 128-byte
// swizzled.  Boxes past `rows` fill zeros and never cross a batch row.
int make_map(CUtensorMap* map, const void* ptr, int hd, int heads, int rows,
             int batch, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t row = (cuuint64_t)heads * hd * 2;
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, row, row * rows};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Launches the bf16 kernel (q/out [B, n_q, H, HD], k/v [B, s_kv, K, HD]).
// The three tensor maps are encoded on the host for every call (the base
// pointers change every call) and travel as __grid_constant__ parameters.
// With kLse, `lse` ([B, H, n_q] f32) receives the rows' base-2 lse.
// Returns 0 or a CUDA error code; the caller reads cudaGetLastError().
template <int HD, bool kLse = false>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int n_q, int s_kv, int start, int n_heads, int n_kv, float scale,
           cudaStream_t stream, float* lse = nullptr) {
  using C = Cfg<HD>;
  // TMA needs 16-byte aligned bases.
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (n_q + kBQ - 1) / kBQ;
  if (n_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // A function's attributes are per device: set them once on each.
  static unsigned long long configured = 0;  // a bit per device
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device >= 64)
    return (int)cudaErrorInvalidDevice;
  if (!(configured >> device & 1)) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<HD, kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured |= 1ull << device;
  }
  CUtensorMap q_map, k_map, v_map;
  int rc = make_map(&q_map, q, HD, n_heads, n_q, batch, kBQ);
  if (rc == 0) rc = make_map(&k_map, k, HD, n_kv, s_kv, batch, C::BK);
  if (rc == 0) rc = make_map(&v_map, v, HD, n_kv, s_kv, batch, C::BK);
  if (rc != 0) return rc;
  const dim3 grid(n_heads, batch, n_tiles);
  flash_kernel<HD, kLse><<<grid, kThreads, C::SMEM, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), n_q, s_kv, start,
      n_heads, n_kv, scale * kLog2e, lse);
  return 0;
}

}  // namespace
}  // namespace flash_tile_sm90
