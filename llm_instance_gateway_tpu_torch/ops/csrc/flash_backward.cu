// Gradient of causal flash attention (dq, dk, dv) on Hopper (sm_90a).
//
// Replaces: llm_instance_gateway_tpu/ops/pallas_attention.py::flash_attention's
//   gradient, which has no Pallas kernel: jax.grad cannot differentiate the
//   pallas_call (its JVP rule raises), so the reference's train step
//   differentiates XLA's prefill_attention (ops/attention.py), where the
//   flash gate falls back to it.  The port's forward runs its kernel for
//   every S (flash_prefill.cu), so its gradient is a kernel too.
//
// Computes the gradient of what flash_prefill computes: causal GQA
// attention, logits (q * scale) . k in f32 with scale 1/sqrt(hd), keys
// above the diagonal masked (-1e30), f32 softmax.  Layout: q, out, dout,
// dq [B, S, H, hd]; k, v, dk, dv [B, S, K, hd]; query head h reads KV head
// h / (H/K).  Any S: the ragged last tile is masked.
//
// Bound on an H100: five causal products (QK^T, dP = dout V^T, dV, dK,
// dQ), each 2 * B * H * S(S+1)/2 * hd flops, at 989 TFLOP/s (bf16), or the
// bytes of q, k, v, out, dout, dq, dk and dv at 3.35 TB/s, whichever is
// larger.
//
// bf16 (hd 64, 128, 256): FlashAttention-3's backward on wgmma fed by TMA,
// simplified.  Launches, all from flash_backward_launch, none atomic (so
// the gradients are bitwise the same from run to run):
//   (0) only when the caller has no lse: the training forward
//       (flash_tile_sm90.cuh's flash_kernel<HD, true>, also exported as
//       flash_forward_lse_launch) run for its lse alone, its output into
//       dq's buffer, which (4) overwrites.  FlashAttention's forward saves
//       that lse, so training never recomputes QK^T for it;
//   (1) delta_kernel: delta = rowsum(dout * out), f32 [B, H, S], 16 bytes
//       a thread (memory-bound, ~33 MB at Llama-3-8B's train shape);
//   (2) dkdv_kernel, one block per (key tile, KV head x group split, row):
//       three warpgroups.  A producer warp (its warpgroup lowered to 24
//       registers by setmaxnreg) loads the block's K and V once by TMA,
//       then streams the 64-row Q and dout tiles of each of its heads at or
//       below the diagonal through a two-stage ring guarded by full/empty
//       mbarriers, with their lse and delta slices (copied by the warp's
//       lanes, which also arrive on the full barrier).  Each consumer
//       warpgroup (240 registers) computes, per tile,
//         S^T = K Q^T, dP^T = V dout^T   SS wgmma m64n64k16, f32;
//         P^T = exp2(S^T * scale * log2 e - lse2), dS^T = P^T (dP^T - delta)
//                                        in registers; masked (P = 0) only
//                                        on the tile that straddles the
//                                        diagonal or the ragged end;
//         dV += P^T dout, dK += dS^T q   RS wgmma, P^T and dS^T rounded to
//                                        bf16 in registers as the A operand,
//                                        dout and q the MN-major B operand
//                                        (the forward's PV);
//       then releases the stage; dK is scaled once in the epilogue.  At hd
//       64 and 128 a block owns 128 keys, 64 per consumer, and each keeps
//       dK and dV for all hd columns (2 x 64 f32 registers at hd 128).  At
//       hd 256 that would be 256 registers a thread, so the two consumers
//       share 64 keys and split dK/dV's columns, 128 each; each computes
//       S^T and dP^T for the 64 keys itself (P^T and dS^T stay in
//       registers: no exchange through shared memory and no barrier
//       between the consumers, for two products more).  Shared memory at
//       hd 256: K and V 64 KB, the two-stage Q/dout ring 128 KB, lse/delta
//       1 KB, ~194 KB of 227 KB (hd 128: ~130 KB; tiles: 128 keys x 64
//       queries);
//   (3) the group split: with few blocks (one KV head, as Gemma-2B's 8:1,
//       or a short S) the wrapper splits each group's heads over `splits`
//       blocks (flash_attention.split_plan), each writing f32 partial
//       dK/dV to scratch [2, splits, B, S, K, hd]; reduce_kernel sums the
//       partials in split order, scales dK and casts;
//   (4) dq_kernel, one block per (query tile, head, row), longest tiles
//       first: Q, dout (TMA, once), lse and delta stay resident; 64-key K
//       and V tiles stream through the TMA ring; per tile S = Q K^T,
//       dP = dout V^T (SS), P and dS, dQ += dS K (RS, K the MN-major B
//       operand); scaled once at the end.  128 queries a block (64 per
//       consumer) at hd 64/128, 64 with the hd columns split at 256.
// lse2 is the forward's base-2 log-sum-exp of the scaled logits
// (lse / ln 2), so P is one FMA and one exp2 per score.
//
// What it leaves on the table: seven products for five (S and dP are
// computed in both passes; eleven at hd 256), no ping-pong of the softmax
// against the other consumer's wgmma, S^T/dP^T waited on before the
// softmax rather than pipelined, and no persistent scheduler (the causal
// blocks differ in length; both grids launch the longest tiles first).
// Tried on an H100 and slower: at hd 256, consumer 0 computing S^T (S)
// and consumer 1 dP^T (dP) and the two swapping them through shared
// memory between named barriers (seven products, as at hd 128, but the
// consumers in lockstep); separate commit groups so that P^T is computed
// while dP^T runs; and no faster: a third ring stage at hd <= 128 and
// 128-key dQ tiles (wgmma n128 for S and dP).
//
// f32 (the card's f32 parity checks, no TF32): CUDA-core FMAs in f32 from
// shared memory, 256 threads as a 16 x 16 grid, each owning a
// (tile/16) x (tile/16) score tile and a (tile/16) x (hd/16) accumulator
// tile; tiles of 64 rows (32 at hd 256, to stay within shared memory);
// three kernels: stats (lse, natural log, recomputed from q and k, and
// delta), dK/dV per key tile looping over the group, dQ.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tile_sm90.cuh"

// Named, so a profile's kernel names say whose they are.
namespace flash_backward {
namespace {

namespace sm90 = flash_tile_sm90;

// ---------------------------------------------------------------------------
// f32 on CUDA-core FMAs.

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;

template <int HD>
struct Cfg {
  static constexpr int B = HD == 256 ? 32 : 64;  // query and key tile rows
  static constexpr int R = B / 16;               // score rows/cols a thread
  static constexpr int DJ = HD / 16;             // accumulator cols a thread
  static constexpr int LD = HD + 1;              // f32 tile row stride
  static constexpr int SS = B + 1;               // f32 score row stride
  static constexpr int LPR = kThreads / B;       // lanes per row (softmax)
  // stats: q, k tiles, scores, m, l
  static constexpr size_t stats_bytes =
      (2 * (size_t)B * LD + (size_t)B * SS + 2 * B) * sizeof(float);
  // dq / dkdv: q, dout, k, v tiles, two score tiles, lse, delta
  static constexpr size_t grad_bytes =
      (4 * (size_t)B * LD + 2 * (size_t)B * SS + 2 * B) * sizeof(float);
};

// Rows [row0, row0 + B) of a [S, *, hd] operand (position stride
// `stride`) into a f32 tile, times `mul`; rows at or past `n` load zeros.
template <int HD, int B>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          size_t stride, int row0, int n,
                                          float mul) {
  for (int i = threadIdx.x; i < B * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    float x = 0.f;
    if (row0 + r < n) x = src[(size_t)(row0 + r) * stride + d] * mul;
    dst[r * (HD + 1) + d] = x;
  }
}

// s = A B^T and (optionally) t = C D^T over hd, for this thread's score
// tile: rows ty*R + i of A and C, rows tx + 16*j of B and D.
template <int HD, bool TWO>
__device__ __forceinline__ void scores(const float* a, const float* b,
                                       const float* c, const float* dd,
                                       float (&s)[Cfg<HD>::R][Cfg<HD>::R],
                                       float (&t)[Cfg<HD>::R][Cfg<HD>::R]) {
  using C_ = Cfg<HD>;
  constexpr int R = C_::R, LD = C_::LD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = t[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float av[R], bv[R], cv[R], dv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      av[i] = a[(ty * R + i) * LD + d];
      if constexpr (TWO) cv[i] = c[(ty * R + i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      bv[j] = b[(tx + 16 * j) * LD + d];
      if constexpr (TWO) dv[j] = dd[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] += av[i] * bv[j];
        if constexpr (TWO) t[i][j] += cv[i] * dv[j];
      }
  }
}

// f32: lse (natural log) and delta for one (query tile, head, row).
template <int HD>
__global__ void __launch_bounds__(kThreads, 1) stats_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ out, const float* __restrict__ dout,
    float* __restrict__ lse, float* __restrict__ delta, int seq,
    int n_heads, int n_kv, float scale) {
  using C_ = Cfg<HD>;
  constexpr int B = C_::B, R = C_::R, LD = C_::LD, SS = C_::SS,
                LPR = C_::LPR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // [B][LD]
  float* k_s = q_s + B * LD;                          // [B][LD]
  float* s_s = k_s + B * LD;                          // [B][SS]
  float* m_s = s_s + B * SS;                          // [B]
  float* l_s = m_s + B;                               // [B]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (n_heads / n_kv);
  const int q0 = qt * B;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t q_pos = (size_t)n_heads * HD, kv_pos = (size_t)n_kv * HD;
  const size_t q_off = (size_t)b * seq * q_pos + (size_t)h * HD;
  const float* kb = k + (size_t)b * seq * kv_pos + (size_t)kh * HD;
  float* lse_b = lse + ((size_t)b * n_heads + h) * seq;
  float* delta_b = delta + ((size_t)b * n_heads + h) * seq;

  load_tile<HD, B>(q_s, q + q_off, q_pos, q0, seq, scale);
  // delta = rowsum(dout * out): LPR neighbouring lanes per row.
  {
    const int r = tid / LPR, part = tid % LPR;
    float acc = 0.f;
    if (q0 + r < seq) {
      const size_t row = q_off + (size_t)(q0 + r) * q_pos;
      for (int d = part; d < HD; d += LPR)
        acc += dout[row + d] * out[row + d];
    }
#pragma unroll
    for (int o = 1; o < LPR; o <<= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (part == 0 && q0 + r < seq) delta_b[q0 + r] = acc;
  }
  if (tid < B) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  const int last = min(q0 + B, seq) - 1;  // the tile's last stored row
  for (int kt = 0; kt <= last / B; ++kt) {
    const int k0 = kt * B;
    __syncthreads();  // q_s loaded / the previous tile's s_s consumed
    load_tile<HD, B>(k_s, kb, kv_pos, k0, seq, 1.f);
    __syncthreads();
    float s[R][R], unused[R][R];
    scores<HD, false>(q_s, k_s, nullptr, nullptr, s, unused);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int r = ty * R + i, c = tx + 16 * j;
        s_s[r * SS + c] = k0 + c <= q0 + r ? s[i][j] : kNegInf;
      }
    __syncthreads();
    const int r = tid / LPR, part = tid % LPR;
    float mx = kNegInf;
    for (int c = part; c < B; c += LPR) mx = fmaxf(mx, s_s[r * SS + c]);
#pragma unroll
    for (int o = 1; o < LPR; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_old = m_s[r];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
    for (int c = part; c < B; c += LPR) sum += expf(s_s[r * SS + c] - m_new);
#pragma unroll
    for (int o = 1; o < LPR; o <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    __syncwarp();
    if (part == 0) {
      l_s[r] = l_s[r] * expf(m_old - m_new) + sum;
      m_s[r] = m_new;
    }
  }
  __syncthreads();
  if (tid < B && q0 + tid < seq)
    lse_b[q0 + tid] = m_s[tid] + logf(l_s[tid]);
}

// P and dS of one (query tile, key tile) pair for this thread's score
// tile, into p_s (when given) and ds_s.
template <int HD>
__device__ __forceinline__ void probs_and_ds(
    const float* q_s, const float* do_s, const float* k_s, const float* v_s,
    const float* lse_s, const float* delta_s, float* p_s, float* ds_s,
    int q0, int k0, int seq) {
  using C_ = Cfg<HD>;
  constexpr int R = C_::R, SS = C_::SS;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[R][R], dp[R][R];
  scores<HD, true>(q_s, k_s, do_s, v_s, s, dp);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = ty * R + i, c = tx + 16 * j;
      const bool live = k0 + c <= q0 + r && q0 + r < seq;
      const float p = live ? expf(s[i][j] - lse_s[r]) : 0.f;
      if (p_s != nullptr) p_s[r * SS + c] = p;
      ds_s[r * SS + c] = p * (dp[i][j] - delta_s[r]);
    }
}

// f32: dK and dV for one (key tile, KV head, row), summed over the group.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1) dkdv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int seq, int n_heads, int n_kv,
    float scale) {
  using C_ = Cfg<HD>;
  constexpr int B = C_::B, R = C_::R, DJ = C_::DJ, LD = C_::LD, SS = C_::SS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* k_s = reinterpret_cast<float*>(smem_raw);  // [B][LD]
  float* v_s = k_s + B * LD;
  float* q_s = v_s + B * LD;
  float* do_s = q_s + B * LD;
  float* p_s = do_s + B * LD;                         // [B][SS]
  float* ds_s = p_s + B * SS;                         // [B][SS]
  float* lse_s = ds_s + B * SS;                       // [B]
  float* delta_s = lse_s + B;                         // [B]

  const int kt = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int group = n_heads / n_kv;
  const int k0 = kt * B;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t q_pos = (size_t)n_heads * HD, kv_pos = (size_t)n_kv * HD;
  const size_t kv_off = (size_t)b * seq * kv_pos + (size_t)kh * HD;
  load_tile<HD, B>(k_s, k + kv_off, kv_pos, k0, seq, 1.f);
  load_tile<HD, B>(v_s, v + kv_off, kv_pos, k0, seq, 1.f);

  float acc_k[R][DJ], acc_v[R][DJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int n_qt = (seq + B - 1) / B;
  for (int g = 0; g < group; ++g) {
    const int h = kh * group + g;
    const size_t q_off = (size_t)b * seq * q_pos + (size_t)h * HD;
    const size_t st_off = ((size_t)b * n_heads + h) * seq;
    for (int qt = kt; qt < n_qt; ++qt) {
      const int q0 = qt * B;
      __syncthreads();  // the previous pair's tiles consumed
      load_tile<HD, B>(q_s, q + q_off, q_pos, q0, seq, scale);
      load_tile<HD, B>(do_s, dout + q_off, q_pos, q0, seq, 1.f);
      if (tid < B) {
        const bool ok = q0 + tid < seq;
        lse_s[tid] = ok ? lse[st_off + q0 + tid] : 0.f;
        delta_s[tid] = ok ? delta[st_off + q0 + tid] : 0.f;
      }
      __syncthreads();
      probs_and_ds<HD>(q_s, do_s, k_s, v_s, lse_s, delta_s, p_s, ds_s, q0,
                       k0, seq);
      __syncthreads();
      // dV += P^T dout, dK += dS^T (q * scale): rows ty*R + i are keys.
#pragma unroll 2
      for (int r = 0; r < B; ++r) {
        float pv[R], dsv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pv[i] = p_s[r * SS + ty * R + i];
          dsv[i] = ds_s[r * SS + ty * R + i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float o = do_s[r * LD + tx + 16 * j];
          const float x = q_s[r * LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            acc_v[i][j] += pv[i] * o;
            acc_k[i][j] += dsv[i] * x;
          }
        }
      }
    }
  }

  float* dkb = dk + kv_off;
  float* dvb = dv + kv_off;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int c = ty * R + i;
    if (k0 + c < seq) {
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        dkb[(size_t)(k0 + c) * kv_pos + tx + 16 * j] = acc_k[i][j];
        dvb[(size_t)(k0 + c) * kv_pos + tx + 16 * j] = acc_v[i][j];
      }
    }
  }
}

// f32: dQ for one (query tile, head, row); the longest tiles launch first.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1) dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int seq, int n_heads, int n_kv, float scale) {
  using C_ = Cfg<HD>;
  constexpr int B = C_::B, R = C_::R, DJ = C_::DJ, LD = C_::LD, SS = C_::SS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // [B][LD]
  float* do_s = q_s + B * LD;
  float* k_s = do_s + B * LD;
  float* v_s = k_s + B * LD;
  float* ds_s = v_s + B * LD;                         // [B][SS]
  float* lse_s = ds_s + 2 * B * SS;                   // [B] (layout of dkdv)
  float* delta_s = lse_s + B;                         // [B]

  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (n_heads / n_kv);
  const int q0 = qt * B;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t q_pos = (size_t)n_heads * HD, kv_pos = (size_t)n_kv * HD;
  const size_t q_off = (size_t)b * seq * q_pos + (size_t)h * HD;
  const size_t kv_off = (size_t)b * seq * kv_pos + (size_t)kh * HD;
  const size_t st_off = ((size_t)b * n_heads + h) * seq;
  load_tile<HD, B>(q_s, q + q_off, q_pos, q0, seq, scale);
  load_tile<HD, B>(do_s, dout + q_off, q_pos, q0, seq, 1.f);
  if (tid < B) {
    const bool ok = q0 + tid < seq;
    lse_s[tid] = ok ? lse[st_off + q0 + tid] : 0.f;
    delta_s[tid] = ok ? delta[st_off + q0 + tid] : 0.f;
  }

  float acc[R][DJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * B;
    __syncthreads();  // the previous tile's dS consumed
    load_tile<HD, B>(k_s, k + kv_off, kv_pos, k0, seq, 1.f);
    load_tile<HD, B>(v_s, v + kv_off, kv_pos, k0, seq, 1.f);
    __syncthreads();
    probs_and_ds<HD>(q_s, do_s, k_s, v_s, lse_s, delta_s, nullptr, ds_s, q0,
                     k0, seq);
    __syncthreads();
    // dQ += dS k: rows ty*R + i are queries.
#pragma unroll 2
    for (int c = 0; c < B; ++c) {
      float dsv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) dsv[i] = ds_s[(ty * R + i) * SS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float x = k_s[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][j] += dsv[i] * x;
      }
    }
  }

  float* dqb = dq + q_off;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty * R + i;
    if (q0 + r < seq) {
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        dqb[(size_t)(q0 + r) * q_pos + tx + 16 * j] =
            acc[i][j] * scale;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on wgmma fed by TMA.

constexpr int kTcThreads = 384;  // producer + two consumer warpgroups
constexpr int kStages = 2;       // ring depth
constexpr int kBT = 64;          // rows of a streamed tile (Q/dout or K/V)
constexpr int kSlab = kBT * 128; // bytes of one 64-column slab of it

template <int HD>
struct Tc {
  static constexpr bool SPLIT = HD == 256;     // consumers split hd columns
  static constexpr int DN = SPLIT ? 128 : HD;  // output columns a consumer owns
  static constexpr int ROWS = SPLIT ? 64 : 128;  // keys (dK/dV), queries (dQ)
  static constexpr int OWN = ROWS * HD * 2;    // bytes of a resident tile
  static constexpr int OWN_SLAB = ROWS * 128;  // ... of one of its slabs
  static constexpr int TILE = kBT * HD * 2;    // bytes of a streamed tile
  static constexpr int BARS = 8 * (1 + 2 * kStages);
  // dkdv: K | V | Q ring | dout ring | (lse, delta) ring | barriers
  static constexpr int KV_Q = 2 * OWN;
  static constexpr int KV_DO = KV_Q + kStages * TILE;
  static constexpr int KV_STATS = KV_DO + kStages * TILE;
  static constexpr int KV_BAR = KV_STATS + kStages * 2 * kBT * 4;
  static constexpr int KV_SMEM = KV_BAR + BARS + 1024;  // + base alignment
  // dq: Q | dout | K ring | V ring | barriers
  static constexpr int Q_K = 2 * OWN;
  static constexpr int Q_V = Q_K + kStages * TILE;
  static constexpr int Q_BAR = Q_V + kStages * TILE;
  static constexpr int Q_SMEM = Q_BAR + BARS + 1024;
};

// K-major descriptor of k-step kk (16 columns) of a tile whose 64-column
// slabs are `slab` bytes apart, from row offset `row_bytes`.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int slab, int kk,
                                           int row_bytes) {
  return sm90::smem_desc(tile + (kk / 4) * slab + row_bytes + (kk % 4) * 32,
                         16);
}

// MN-major (B operand) descriptor of k-step kk (16 rows) of a streamed
// 64-row tile, from column `col` (a multiple of 64).
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk, int col) {
  return sm90::smem_desc(tile + (col / 64) * kSlab + kk * 16 * 128, kSlab);
}

// Accumulator layout (m64nN): this thread holds rows r_lo and r_lo + 8 of
// the warpgroup's 64 (r_lo = 16 warp + lane / 4) and, for j < N / 8,
// columns 8j + 2 (lane % 4) + {0, 1}: d[4j + e] is row r_lo + 8 (e >> 1),
// column 8j + 2 (lane % 4) + (e & 1).  Two such column groups are the
// wgmma A fragment of one k-step (the forward's P).
__device__ __forceinline__ void to_frag(uint32_t (&f)[4][4], int j,
                                        const float (&x)[4]) {
  f[j / 2][2 * (j % 2)] = sm90::pack_bf16(x[0], x[1]);
  f[j / 2][2 * (j % 2) + 1] = sm90::pack_bf16(x[2], x[3]);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// (1) delta = rowsum(dout * out) for every (row, position, head), into
// [B, H, S]; HD / 8 neighbouring lanes a row, 8 bf16 each.
template <int HD>
__global__ void __launch_bounds__(256) delta_kernel(
    const __nv_bfloat16* __restrict__ out,
    const __nv_bfloat16* __restrict__ dout, float* __restrict__ delta,
    int rows, int seq, int n_heads) {
  constexpr int TPR = HD / 8;
  const int r = (blockIdx.x * 256 + threadIdx.x) / TPR;
  const int part = threadIdx.x % TPR;
  float acc = 0.f;
  if (r < rows) {
    const size_t off = static_cast<size_t>(r) * HD + part * 8;
    const uint4 a = *reinterpret_cast<const uint4*>(out + off);
    const uint4 d = *reinterpret_cast<const uint4*>(dout + off);
    const uint32_t av[4] = {a.x, a.y, a.z, a.w}, dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&av[i]));
      const float2 y = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&dv[i]));
      acc += x.x * y.x;
      acc += x.y * y.y;
    }
  }
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (part == 0 && r < rows) {
    const int h = r % n_heads, pos = (r / n_heads) % seq,
              b = r / n_heads / seq;
    delta[(static_cast<size_t>(b) * n_heads + h) * seq + pos] = acc;
  }
}

// (2) dK and dV for one (key tile, KV head x split, row): blockIdx.x =
// kh * splits + split, the split's heads group / splits consecutive ones.
// splits == 1 writes bf16 dk/dv; else f32 partials to part [2, splits, B,
// S, K, hd] (dK unscaled).
template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1) dkdv_kernel(
    const __grid_constant__ CUtensorMap q_map,   // boxes of kBT rows
    const __grid_constant__ CUtensorMap do_map,  // boxes of kBT rows
    const __grid_constant__ CUtensorMap k_map,   // boxes of ROWS rows
    const __grid_constant__ CUtensorMap v_map,   // boxes of ROWS rows
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    float* __restrict__ part, int seq, int n_heads, int n_kv, int splits,
    float scale, float scale_log2) {
  using C = Tc<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  float* stats = reinterpret_cast<float*>(smem_raw + (base - raw) +
                                          C::KV_STATS);
  const uint32_t k_s = base, v_s = base + C::OWN;
  const uint32_t kv_full = base + C::KV_BAR;
  auto q_st = [&](int st) { return base + C::KV_Q + st * C::TILE; };
  auto do_st = [&](int st) { return base + C::KV_DO + st * C::TILE; };
  auto full = [&](int st) { return kv_full + 8 * (1 + st); };
  auto empty = [&](int st) { return kv_full + 8 * (1 + kStages + st); };

  const int kh = blockIdx.x / splits, sp = blockIdx.x % splits;
  const int b = blockIdx.y, k0 = blockIdx.z * C::ROWS;  // longest first
  const int per = n_heads / n_kv / splits;  // heads of this block
  const int h0 = kh * (n_heads / n_kv) + sp * per;
  const int qt0 = k0 / kBT, per_head = (seq + kBT - 1) / kBT - qt0;
  const int n_iter = per * per_head;
  const int n_cons = C::SPLIT || k0 + 64 < seq ? 2 : 1;  // with keys

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      sm90::mbar_init(full(st), 1 + 32);  // TMA bytes + the warp's stats
      sm90::mbar_init(empty(st), 4 * n_cons);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int lane = tid % 32;
  if (wg == 0) {
    // ---- producer warp ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid < 32) {
      if (lane == 0) {
        sm90::mbar_expect_tx(kv_full, 2 * C::OWN);
#pragma unroll
        for (int s = 0; s < HD / 64; ++s) {
          sm90::tma_load(k_s + s * C::OWN_SLAB, &k_map, kv_full, 64 * s, kh,
                         k0, b);
          sm90::tma_load(v_s + s * C::OWN_SLAB, &v_map, kv_full, 64 * s, kh,
                         k0, b);
        }
      }
      for (int t = 0; t < n_iter; ++t) {
        const int st = t % kStages;
        const int h = h0 + t / per_head, q0 = (qt0 + t % per_head) * kBT;
        if (t >= kStages) sm90::mbar_wait(empty(st), (t / kStages - 1) & 1);
        if (lane == 0) {
          sm90::mbar_expect_tx(full(st), 2 * C::TILE);
#pragma unroll
          for (int s = 0; s < HD / 64; ++s) {
            sm90::tma_load(q_st(st) + s * kSlab, &q_map, full(st), 64 * s, h,
                           q0, b);
            sm90::tma_load(do_st(st) + s * kSlab, &do_map, full(st), 64 * s,
                           h, q0, b);
          }
        }
        const float* lrow = lse + (static_cast<size_t>(b) * n_heads + h) * seq;
        const float* drow =
            delta + (static_cast<size_t>(b) * n_heads + h) * seq;
        float* ls = stats + st * 2 * kBT;
#pragma unroll
        for (int i = lane; i < kBT; i += 32) {
          const bool ok = q0 + i < seq;
          ls[i] = ok ? lrow[q0 + i] : 0.f;
          ls[kBT + i] = ok ? drow[q0 + i] : 0.f;
        }
        sm90::mbar_arrive(full(st));
      }
    }
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int w = wg - 1;
    const int my_k0 = C::SPLIT ? k0 : k0 + 64 * w;  // this consumer's keys
    const int col0 = C::SPLIT ? 128 * w : 0;        // ... and dK/dV columns
    if (my_k0 < seq) {
      const int r_lo = 16 * (tid / 32) + lane / 4;
      const int krow = (my_k0 - k0) * 128;  // its keys' offset in K and V
      float acc_v[C::DN / 2], acc_k[C::DN / 2], s[32], dp[32];
      zero(acc_v);
      zero(acc_k);
      zero(s);
      zero(dp);
      sm90::mbar_wait(kv_full, 0);
      for (int t = 0; t < n_iter; ++t) {
        const int st = t % kStages;
        const int q0 = (qt0 + t % per_head) * kBT;
        sm90::mbar_wait(full(st), (t / kStages) & 1);
        if (q0 + kBT - 1 < my_k0) {  // above the diagonal: release only
          __syncwarp();
          if (lane == 0) sm90::mbar_arrive(empty(st));
          continue;
        }
        // S^T = K Q^T and dP^T = V dout^T (hd / 16 k-steps each).
        sm90::fence_regs(s);
        sm90::fence_regs(dp);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          sm90::wgmma_ss<64>(s, kmajor(k_s, C::OWN_SLAB, kk, krow),
                             kmajor(q_st(st), kSlab, kk, 0), kk > 0);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          sm90::wgmma_ss<64>(dp, kmajor(v_s, C::OWN_SLAB, kk, krow),
                             kmajor(do_st(st), kSlab, kk, 0), kk > 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait_all();
        sm90::fence_regs(s);
        sm90::fence_regs(dp);

        // P^T and dS^T; rows are keys, columns queries.
        const bool masked = my_k0 + 63 > q0 || q0 + kBT > seq;
        const float* ls = stats + st * 2 * kBT;
        uint32_t pf[4][4], df[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + 2 * (lane % 4);
          const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
          const float2 d2 = *reinterpret_cast<const float2*>(ls + kBT + c);
          float p[4], d[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float le = e & 1 ? l2.y : l2.x, de = e & 1 ? d2.y : d2.x;
            p[e] = exp2f(s[4 * j + e] * scale_log2 - le);
            d[e] = p[e] * (dp[4 * j + e] - de);
            if (masked) {
              const int key = my_k0 + r_lo + 8 * (e >> 1);
              const int qi = q0 + c + (e & 1);
              if (key > qi || qi >= seq) p[e] = d[e] = 0.f;
            }
          }
          to_frag(pf, j, p);
          to_frag(df, j, d);
        }

        // dV += P^T dout, dK += dS^T q (kBT / 16 k-steps over the queries).
        sm90::fence_regs(acc_v);
        sm90::fence_regs(acc_k);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBT / 16; ++kk) {
          sm90::wgmma_rs<C::DN>(acc_v, pf[kk], mnmajor(do_st(st), kk, col0));
          sm90::wgmma_rs<C::DN>(acc_k, df[kk], mnmajor(q_st(st), kk, col0));
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait_all();
        sm90::fence_regs(acc_v);
        sm90::fence_regs(acc_k);
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(empty(st));
      }

      // Epilogue: keys >= seq are not stored.
      const size_t plane = static_cast<size_t>(splits) * gridDim.y * seq *
                           n_kv * HD;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = my_k0 + r_lo + 8 * r;
        if (key >= seq) continue;
        const int col = col0 + 2 * (lane % 4);
        if (splits == 1) {
          const size_t o =
              ((static_cast<size_t>(b) * seq + key) * n_kv + kh) * HD + col;
#pragma unroll
          for (int j = 0; j < C::DN / 8; ++j) {
            *reinterpret_cast<uint32_t*>(dk + o + 8 * j) = sm90::pack_bf16(
                acc_k[4 * j + 2 * r] * scale, acc_k[4 * j + 2 * r + 1] * scale);
            *reinterpret_cast<uint32_t*>(dv + o + 8 * j) = sm90::pack_bf16(
                acc_v[4 * j + 2 * r], acc_v[4 * j + 2 * r + 1]);
          }
        } else {
          const size_t o =
              (((static_cast<size_t>(sp) * gridDim.y + b) * seq + key) * n_kv +
               kh) * HD + col;
#pragma unroll
          for (int j = 0; j < C::DN / 8; ++j) {
            *reinterpret_cast<float2*>(part + o + 8 * j) =
                make_float2(acc_k[4 * j + 2 * r], acc_k[4 * j + 2 * r + 1]);
            *reinterpret_cast<float2*>(part + plane + o + 8 * j) =
                make_float2(acc_v[4 * j + 2 * r], acc_v[4 * j + 2 * r + 1]);
          }
        }
      }
    }
  }
}

// (3) dk = bf16(scale * sum of the dK partials), dv = bf16(sum of the dV
// partials), summed in split order; n elements, four a thread.
__global__ void __launch_bounds__(256) reduce_kernel(
    const float* __restrict__ part, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int n, int splits, float scale) {
  const int i = 4 * (blockIdx.x * 256 + threadIdx.x);
  if (i >= n) return;
  const size_t plane = static_cast<size_t>(splits) * n;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
  for (int sp = 0; sp < splits; ++sp) {
    const float4 x =
        *reinterpret_cast<const float4*>(part + static_cast<size_t>(sp) * n + i);
    const float4 y = *reinterpret_cast<const float4*>(
        part + plane + static_cast<size_t>(sp) * n + i);
    a.x += x.x, a.y += x.y, a.z += x.z, a.w += x.w;
    c.x += y.x, c.y += y.y, c.z += y.z, c.w += y.w;
  }
  uint2 ok, ov;
  ok.x = sm90::pack_bf16(a.x * scale, a.y * scale);
  ok.y = sm90::pack_bf16(a.z * scale, a.w * scale);
  ov.x = sm90::pack_bf16(c.x, c.y);
  ov.y = sm90::pack_bf16(c.z, c.w);
  *reinterpret_cast<uint2*>(dk + i) = ok;
  *reinterpret_cast<uint2*>(dv + i) = ov;
}

// (4) dQ for one (query tile, head, row); the longest tiles launch first.
template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1) dq_kernel(
    const __grid_constant__ CUtensorMap q_map,   // boxes of ROWS rows
    const __grid_constant__ CUtensorMap do_map,  // boxes of ROWS rows
    const __grid_constant__ CUtensorMap k_map,   // boxes of kBT rows
    const __grid_constant__ CUtensorMap v_map,   // boxes of kBT rows
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int seq, int n_heads, int n_kv,
    float scale, float scale_log2) {
  using C = Tc<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base, do_s = base + C::OWN;
  const uint32_t q_full = base + C::Q_BAR;
  auto k_st = [&](int st) { return base + C::Q_K + st * C::TILE; };
  auto v_st = [&](int st) { return base + C::Q_V + st * C::TILE; };
  auto full = [&](int st) { return q_full + 8 * (1 + st); };
  auto empty = [&](int st) { return q_full + 8 * (1 + kStages + st); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * C::ROWS;  // longest first
  const int kh = h / (n_heads / n_kv);
  const int reach = min(q0 + C::ROWS, seq) - 1;  // the block's last row
  const int n_tiles = reach / kBT + 1;
  const int n_cons = C::SPLIT || q0 + 64 < seq ? 2 : 1;  // with rows

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      sm90::mbar_init(full(st), 1);
      sm90::mbar_init(empty(st), 4 * n_cons);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (wg == 0) {
    // ---- producer: one thread starts every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      sm90::mbar_expect_tx(q_full, 2 * C::OWN);
#pragma unroll
      for (int s = 0; s < HD / 64; ++s) {
        sm90::tma_load(q_s + s * C::OWN_SLAB, &q_map, q_full, 64 * s, h, q0,
                       b);
        sm90::tma_load(do_s + s * C::OWN_SLAB, &do_map, q_full, 64 * s, h,
                       q0, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) sm90::mbar_wait(empty(st), (t / kStages - 1) & 1);
        sm90::mbar_expect_tx(full(st), 2 * C::TILE);
#pragma unroll
        for (int s = 0; s < HD / 64; ++s) {
          sm90::tma_load(k_st(st) + s * kSlab, &k_map, full(st), 64 * s, kh,
                         t * kBT, b);
          sm90::tma_load(v_st(st) + s * kSlab, &v_map, full(st), 64 * s, kh,
                         t * kBT, b);
        }
      }
    }
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int w = wg - 1;
    const int q0c = C::SPLIT ? q0 : q0 + 64 * w;  // this consumer's rows
    const int col0 = C::SPLIT ? 128 * w : 0;      // ... and dQ columns
    if (q0c < seq) {
      const int lane = tid % 32, r_lo = 16 * (tid / 32) + lane / 4;
      const int qrow = (q0c - q0) * 128;
      const int my_reach = min(q0c + 63, seq - 1);
      float lr[2], dr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0c + r_lo + 8 * r;
        const size_t o = (static_cast<size_t>(b) * n_heads + h) * seq + row;
        lr[r] = row < seq ? lse[o] : 0.f;
        dr[r] = row < seq ? delta[o] : 0.f;
      }
      float acc[C::DN / 2], s[32], dp[32];
      zero(acc);
      zero(s);
      zero(dp);
      sm90::mbar_wait(q_full, 0);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        const int k0 = t * kBT;
        sm90::mbar_wait(full(st), (t / kStages) & 1);
        if (k0 > my_reach) {  // past this consumer's rows: release only
          __syncwarp();
          if (lane == 0) sm90::mbar_arrive(empty(st));
          continue;
        }
        // S = Q K^T and dP = dout V^T.
        sm90::fence_regs(s);
        sm90::fence_regs(dp);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          sm90::wgmma_ss<64>(s, kmajor(q_s, C::OWN_SLAB, kk, qrow),
                             kmajor(k_st(st), kSlab, kk, 0), kk > 0);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          sm90::wgmma_ss<64>(dp, kmajor(do_s, C::OWN_SLAB, kk, qrow),
                             kmajor(v_st(st), kSlab, kk, 0), kk > 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait_all();
        sm90::fence_regs(s);
        sm90::fence_regs(dp);

        // dS; rows are queries, columns keys.
        const bool masked = k0 + 63 > q0c;
        uint32_t df[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float d[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const float p = exp2f(s[4 * j + e] * scale_log2 - lr[r]);
            d[e] = p * (dp[4 * j + e] - dr[r]);
            if (masked && k0 + 8 * j + 2 * (lane % 4) + (e & 1) >
                              q0c + r_lo + 8 * r)
              d[e] = 0.f;
          }
          to_frag(df, j, d);
        }

        // dQ += dS K (kBT / 16 k-steps over the keys).
        sm90::fence_regs(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBT / 16; ++kk)
          sm90::wgmma_rs<C::DN>(acc, df[kk], mnmajor(k_st(st), kk, col0));
        sm90::wgmma_commit();
        sm90::wgmma_wait_all();
        sm90::fence_regs(acc);
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(empty(st));
      }

      // Epilogue: rows >= seq are not stored.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0c + r_lo + 8 * r;
        if (row >= seq) continue;
        __nv_bfloat16* o = dq +
                           ((static_cast<size_t>(b) * seq + row) * n_heads +
                            h) * HD + col0 + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < C::DN / 8; ++j)
          *reinterpret_cast<uint32_t*>(o + 8 * j) = sm90::pack_bf16(
              acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
      }
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The bf16 launches (0)-(4).  lse: the forward's base-2 lse when
// lse_given, else scratch that (0) fills; part: f32 scratch of
// 2 * splits * B * S * K * hd when splits > 1.
template <int HD>
int launch_tc(const void* q, const void* k, const void* v, const void* out,
              const void* dout, void* dq, void* dk, void* dv, float* lse,
              float* delta, float* part, int batch, int seq, int n_heads,
              int n_kv, int splits, int lse_given, float scale,
              cudaStream_t stream) {
  using C = Tc<HD>;
  using bf16 = __nv_bfloat16;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) %
      16)
    return (int)cudaErrorInvalidValue;  // TMA needs 16-byte aligned bases
  const int k_tiles = (seq + C::ROWS - 1) / C::ROWS;
  const size_t n_kvel = static_cast<size_t>(batch) * seq * n_kv * HD;
  if (k_tiles > 65535 || (splits > 1 && n_kvel > (size_t)INT32_MAX) ||
      (size_t)batch * seq * n_heads > (size_t)INT32_MAX / 32)
    return (int)cudaErrorInvalidValue;
  // A function's attributes are per device: set them once on each.
  static unsigned long long configured = 0;  // a bit per device
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device >= 64)
    return (int)cudaErrorInvalidDevice;
  if (!(configured >> device & 1)) {
    cudaError_t e = allow_smem(dkdv_kernel<HD>, C::KV_SMEM);
    if (e == cudaSuccess) e = allow_smem(dq_kernel<HD>, C::Q_SMEM);
    if (e != cudaSuccess) return (int)e;
    configured |= 1ull << device;
  }
  int rc = 0;
  if (!lse_given) {
    rc = sm90::launch<HD, true>(q, k, v, dq, batch, seq, seq, 0, n_heads,
                                n_kv, scale, stream, lse);
    if (rc != 0) return rc;
  }
  const int rows = batch * seq * n_heads;
  delta_kernel<HD><<<(rows * (HD / 8) + 255) / 256, 256, 0, stream>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), delta,
      rows, seq, n_heads);
  const float scale_log2 = scale * sm90::kLog2e;
  CUtensorMap q_map, do_map, k_map, v_map;
  rc = sm90::make_map(&q_map, q, HD, n_heads, seq, batch, kBT);
  if (rc == 0) rc = sm90::make_map(&do_map, dout, HD, n_heads, seq, batch, kBT);
  if (rc == 0) rc = sm90::make_map(&k_map, k, HD, n_kv, seq, batch, C::ROWS);
  if (rc == 0) rc = sm90::make_map(&v_map, v, HD, n_kv, seq, batch, C::ROWS);
  if (rc != 0) return rc;
  dkdv_kernel<HD><<<dim3(n_kv * splits, batch, k_tiles), kTcThreads,
                    C::KV_SMEM, stream>>>(
      q_map, do_map, k_map, v_map, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), part, seq, n_heads, n_kv, splits, scale,
      scale_log2);
  if (splits > 1) {
    const int n = static_cast<int>(n_kvel);
    reduce_kernel<<<(n / 4 + 255) / 256, 256, 0, stream>>>(
        part, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, splits,
        scale);
  }
  rc = sm90::make_map(&q_map, q, HD, n_heads, seq, batch, C::ROWS);
  if (rc == 0)
    rc = sm90::make_map(&do_map, dout, HD, n_heads, seq, batch, C::ROWS);
  if (rc == 0) rc = sm90::make_map(&k_map, k, HD, n_kv, seq, batch, kBT);
  if (rc == 0) rc = sm90::make_map(&v_map, v, HD, n_kv, seq, batch, kBT);
  if (rc != 0) return rc;
  dq_kernel<HD><<<dim3(n_heads, batch, k_tiles), kTcThreads, C::Q_SMEM,
                  stream>>>(q_map, do_map, k_map, v_map, lse, delta,
                            static_cast<bf16*>(dq), seq, n_heads, n_kv, scale,
                            scale_log2);
  return 0;
}

// The f32 launches: stats (lse, delta), dK/dV, dQ.
template <int HD>
int launch_f32(const float* q, const float* k, const float* v,
               const float* out, const float* dout, float* dq, float* dk,
               float* dv, float* lse, float* delta, int batch, int seq,
               int n_heads, int n_kv, float scale, cudaStream_t stream) {
  using C_ = Cfg<HD>;
  // A function's attributes are per device: set them once on each.
  static unsigned long long configured = 0;  // a bit per device
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device >= 64)
    return (int)cudaErrorInvalidDevice;
  if (!(configured >> device & 1)) {
    cudaError_t e = allow_smem(stats_kernel<HD>, C_::stats_bytes);
    if (e == cudaSuccess) e = allow_smem(dkdv_f32_kernel<HD>, C_::grad_bytes);
    if (e == cudaSuccess) e = allow_smem(dq_f32_kernel<HD>, C_::grad_bytes);
    if (e != cudaSuccess) return (int)e;
    configured |= 1ull << device;
  }
  const int tiles = (seq + C_::B - 1) / C_::B;
  stats_kernel<HD><<<dim3(tiles, n_heads, batch), kThreads, C_::stats_bytes,
                     stream>>>(q, k, out, dout, lse, delta, seq, n_heads,
                               n_kv, scale);
  dkdv_f32_kernel<HD><<<dim3(tiles, n_kv, batch), kThreads, C_::grad_bytes,
                        stream>>>(q, k, v, dout, lse, delta, dk, dv, seq,
                                  n_heads, n_kv, scale);
  dq_f32_kernel<HD><<<dim3(tiles, n_heads, batch), kThreads, C_::grad_bytes,
                      stream>>>(q, k, v, dout, lse, delta, dq, seq, n_heads,
                                n_kv, scale);
  return 0;
}

}  // namespace
}  // namespace flash_backward

// dtype: 0 = float32, 1 = bfloat16.  lse and delta are f32 [B, H, S] each,
// allocated by the caller: for bf16, lse is the training forward's base-2
// lse when lse_given, else scratch filled here; for f32 both are scratch
// (its stats kernel).  part: f32 scratch of 2 * splits * B * S * K * hd
// for bf16 with splits > 1 (splits divides H/K), else unused; f32 takes
// splits 1 and lse_given 0.  Returns cudaGetLastError() after the
// launches, or a CUDA error code for a shape the kernels do not take.
extern "C" int flash_backward_launch(const void* q, const void* k,
                                     const void* v, const void* out,
                                     const void* dout, void* dq, void* dk,
                                     void* dv, void* lse, void* delta,
                                     void* part, int batch, int seq,
                                     int n_heads, int n_kv, int hd, int dtype,
                                     int splits, int lse_given, float scale,
                                     void* stream) {
  if (n_kv <= 0 || n_heads % n_kv != 0 || seq <= 0 || batch <= 0 ||
      batch > 65535 || n_heads > 65535 || splits <= 0 ||
      (n_heads / n_kv) % splits != 0 || n_kv * splits > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  int rc = (int)cudaErrorInvalidValue;
  if (dtype == 0 && splits == 1 && !lse_given) {
    const float* q_f = static_cast<const float*>(q);
    const float* k_f = static_cast<const float*>(k);
    const float* v_f = static_cast<const float*>(v);
    const float* o_f = static_cast<const float*>(out);
    const float* do_f = static_cast<const float*>(dout);
    float* dq_f = static_cast<float*>(dq);
    float* dk_f = static_cast<float*>(dk);
    float* dv_f = static_cast<float*>(dv);
#define FLASH_BWD_F32(HDV)                                                    \
  rc = flash_backward::launch_f32<HDV>(q_f, k_f, v_f, o_f, do_f, dq_f, dk_f, \
                                       dv_f, lse_f, delta_f, batch, seq,     \
                                       n_heads, n_kv, scale, st)
    if (hd == 64) FLASH_BWD_F32(64);
    else if (hd == 128) FLASH_BWD_F32(128);
    else if (hd == 256) FLASH_BWD_F32(256);
#undef FLASH_BWD_F32
  } else if (dtype == 1) {
    float* part_f = static_cast<float*>(part);
#define FLASH_BWD_TC(HDV)                                                   \
  rc = flash_backward::launch_tc<HDV>(q, k, v, out, dout, dq, dk, dv, lse_f, \
                                      delta_f, part_f, batch, seq, n_heads, \
                                      n_kv, splits, lse_given, scale, st)
    if (hd == 64) FLASH_BWD_TC(64);
    else if (hd == 128) FLASH_BWD_TC(128);
    else if (hd == 256) FLASH_BWD_TC(256);
#undef FLASH_BWD_TC
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// The training forward: flash prefill in bf16 (flash_tile_sm90.cuh, the
// serving kernel's code) that also writes each row's base-2 lse, f32
// [B, H, S], for the backward.  Returns cudaGetLastError() after the
// launch, or a CUDA error code for a shape it does not take.
extern "C" int flash_forward_lse_launch(const void* q, const void* k,
                                        const void* v, void* out, void* lse,
                                        int batch, int seq, int n_heads,
                                        int n_kv, int hd, float scale,
                                        void* stream) {
  if (n_kv <= 0 || n_heads % n_kv != 0 || seq <= 0 || batch <= 0 ||
      batch > 65535 || n_heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  int rc = (int)cudaErrorInvalidValue;
#define FLASH_FWD_LSE(HDV)                                                  \
  rc = flash_tile_sm90::launch<HDV, true>(q, k, v, out, batch, seq, seq, 0, \
                                          n_heads, n_kv, scale, st, lse_f)
  if (hd == 64) FLASH_FWD_LSE(64);
  else if (hd == 128) FLASH_FWD_LSE(128);
  else if (hd == 256) FLASH_FWD_LSE(256);
#undef FLASH_FWD_LSE
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
