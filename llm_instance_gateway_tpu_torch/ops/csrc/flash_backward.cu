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
// above the diagonal masked, f32 softmax.  Layout: q, out, dout, dq
// [B, S, H, hd]; k, v, dk, dv [B, S, K, hd]; query head h reads KV head
// h / (H/K).  Any S: the ragged last tile is masked in every pass.
//
// Three kernels from one C entry, no atomics (so the gradients are bitwise
// the same from run to run):
//   (a) stats_kernel, one block per (query tile, head, row): the row
//       log-sum-exp lse [B, H, S] (f32, natural log), recomputed from q
//       and k by an online max/sum over the key tiles up to the diagonal
//       (the serving forward stays as it is and writes no statistics),
//       and delta = rowsum(dout * out) [B, H, S];
//   (c) dkdv_kernel, one block per (key tile, KV head, row): holds its K
//       and V tiles and the dK, dV accumulators on chip and loops over the
//       G query heads of its group and the query tiles at or below the
//       diagonal, recomputing P = exp(s - lse), dP = dout . v^T,
//       dS = P (dP - delta); dV += P^T dout, dK += dS^T (q * scale);
//   (d) dq_kernel, one block per (query tile, head, row): loops over the
//       key tiles up to the diagonal, dQ += dS k, times scale.
// Two routes through the same three passes:
// - bf16 at hd 64 and 128 (every model the port trains but Gemma) on the
//   tensor cores: mma.sync m16n8k16 with f32 accumulation, 64-row tiles,
//   four warps of 16 rows each; scores and dP stay in registers, P and dS
//   are rounded to bf16 there (a relative 2^-9, as the forward rounds P)
//   and feed the next product as its A operand without touching shared
//   memory;
// - f32 (the card's f32 parity checks, no TF32) and hd 256 on CUDA-core
//   FMAs in f32 from shared memory (bf16 widened where it lands, outputs
//   rounded once at the end), 256 threads as a 16 x 16 grid, each owning
//   a (tile/16) x (tile/16) score tile and a (tile/16) x (hd/16)
//   accumulator tile; tiles of 64 rows (32 at hd 256, to stay within
//   shared memory).
//
// Bound on an H100: five causal products (QK^T, dP, dV, dK, dQ), each
// 2 * B * H * S(S+1)/2 * hd flops, at 989 TFLOP/s (bf16), or the bytes of
// q, k, v, out, dout, dq, dk and dv at 3.35 TB/s, whichever is larger.
// What this simple design leaves on the table: it recomputes QK^T three
// times and dP twice (eight products for five); the tensor-core route
// uses mma.sync rather than wgmma (at most ~2/3 of the tensor cores' rate
// on Hopper), loads tiles synchronously without a TMA ring or cp.async
// double buffering, and holds four warps a block; with one KV head
// (Gemma-2B) the dK/dV pass has one block per key tile, too few to fill
// the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// Named, so a profile's kernel names say whose they are.
namespace flash_backward {
namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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
template <typename T, int HD, int B>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          size_t stride, int row0, int n,
                                          float mul) {
  for (int i = threadIdx.x; i < B * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    float x = 0.f;
    if (row0 + r < n) x = to_f(src[(size_t)(row0 + r) * stride + d]) * mul;
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

// (a) lse and delta for one (query tile, head, row).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1) stats_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ out, const T* __restrict__ dout,
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
  const T* kb = k + (size_t)b * seq * kv_pos + (size_t)kh * HD;
  float* lse_b = lse + ((size_t)b * n_heads + h) * seq;
  float* delta_b = delta + ((size_t)b * n_heads + h) * seq;

  load_tile<T, HD, B>(q_s, q + q_off, q_pos, q0, seq, scale);
  // delta = rowsum(dout * out): LPR neighbouring lanes per row.
  {
    const int r = tid / LPR, part = tid % LPR;
    float acc = 0.f;
    if (q0 + r < seq) {
      const size_t row = q_off + (size_t)(q0 + r) * q_pos;
      for (int d = part; d < HD; d += LPR)
        acc += to_f(dout[row + d]) * to_f(out[row + d]);
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
    load_tile<T, HD, B>(k_s, kb, kv_pos, k0, seq, 1.f);
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

// (c) dK and dV for one (key tile, KV head, row), summed over the group.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1) dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int seq, int n_heads, int n_kv,
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
  load_tile<T, HD, B>(k_s, k + kv_off, kv_pos, k0, seq, 1.f);
  load_tile<T, HD, B>(v_s, v + kv_off, kv_pos, k0, seq, 1.f);

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
      load_tile<T, HD, B>(q_s, q + q_off, q_pos, q0, seq, scale);
      load_tile<T, HD, B>(do_s, dout + q_off, q_pos, q0, seq, 1.f);
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

  T* dkb = dk + kv_off;
  T* dvb = dv + kv_off;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int c = ty * R + i;
    if (k0 + c < seq) {
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        dkb[(size_t)(k0 + c) * kv_pos + tx + 16 * j] = from_f<T>(acc_k[i][j]);
        dvb[(size_t)(k0 + c) * kv_pos + tx + 16 * j] = from_f<T>(acc_v[i][j]);
      }
    }
  }
}

// (d) dQ for one (query tile, head, row); the longest tiles launch first.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1) dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int seq, int n_heads, int n_kv, float scale) {
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
  load_tile<T, HD, B>(q_s, q + q_off, q_pos, q0, seq, scale);
  load_tile<T, HD, B>(do_s, dout + q_off, q_pos, q0, seq, 1.f);
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
    load_tile<T, HD, B>(k_s, k + kv_off, kv_pos, k0, seq, 1.f);
    load_tile<T, HD, B>(v_s, v + kv_off, kv_pos, k0, seq, 1.f);
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

  T* dqb = dq + q_off;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty * R + i;
    if (q0 + r < seq) {
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        dqb[(size_t)(q0 + r) * q_pos + tx + 16 * j] =
            from_f<T>(acc[i][j] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 at hd 64 and 128: the same three passes on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 accumulation).  128 threads, four
// warps each owning 16 rows of a 64-row tile; tiles stay bf16 in shared
// memory (rows padded by 8 values: conflict-free fragment loads).  Scores
// and dP stay in registers; P and dS are rounded to bf16 there and fed
// straight back as the A operand of the next product (the accumulator
// layout of two n-tiles is the A layout of one k-step), so only the
// operand tiles touch shared memory.

constexpr int kTcThreads = 128;
constexpr int kBT = 64;  // query and key tile rows

template <int HD>
struct Tc {
  static constexpr int LD = HD + 8;   // bf16 row stride of a tile
  static constexpr int NT = kBT / 8;  // n-tiles across a tile's rows
  static constexpr int DT = HD / 8;   // n-tiles across hd
  static constexpr size_t tile_bytes = (size_t)kBT * LD * 2;
  static constexpr size_t stats_bytes = 2 * tile_bytes;
  static constexpr size_t grad_bytes = 4 * tile_bytes + 2 * kBT * 4;
};

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}
__device__ __forceinline__ uint32_t pack_f(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row0, row0 + 64) of a bf16 [S, *, hd] operand into a tile, 16
// bytes a copy; rows at or past n load zeros.
template <int HD>
__device__ __forceinline__ void load_tile_tc(uint16_t* dst,
                                             const __nv_bfloat16* src,
                                             size_t stride, int row0, int n) {
  constexpr int VPR = HD / 8;
  for (int i = threadIdx.x; i < kBT * VPR; i += kTcThreads) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      x = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * Tc<HD>::LD + c) = x;
  }
}

// acc[j] += A[a0 + 16 rows][hd] . B[8j + 8 rows][hd]^T for j < NT: a warp's
// 16 x 64 score block over hd, both operands k-contiguous in their tiles.
template <int HD>
__device__ __forceinline__ void mma_abt(float (&acc)[Tc<HD>::NT][4],
                                        const uint16_t* a, int a0,
                                        const uint16_t* b) {
  constexpr int LD = Tc<HD>::LD;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const int k0 = ks * 16 + 2 * t;
    const uint32_t af[4] = {ld32(a + (a0 + g) * LD + k0),
                            ld32(a + (a0 + g + 8) * LD + k0),
                            ld32(a + (a0 + g) * LD + k0 + 8),
                            ld32(a + (a0 + g + 8) * LD + k0 + 8)};
#pragma unroll
    for (int j = 0; j < Tc<HD>::NT; ++j) {
      const uint16_t* bp = b + (8 * j + g) * LD + k0;
      mma16816(acc[j], af, ld32(bp), ld32(bp + 8));
    }
  }
}

// acc[j] += A . M[:, 8j .. 8j + 8] for j < DT, A a warp's 16 x 64 block
// as bf16 fragments (af[kk]: its columns 16kk .. 16kk + 16), M a 64 x hd
// tile (k = its rows).
template <int HD>
__device__ __forceinline__ void mma_am(float (&acc)[Tc<HD>::DT][4],
                                       const uint32_t (&af)[kBT / 16][4],
                                       const uint16_t* m) {
  constexpr int LD = Tc<HD>::LD;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kBT / 16; ++kk) {
    const uint16_t* r = m + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
    for (int j = 0; j < Tc<HD>::DT; ++j) {
      const uint16_t* c = r + 8 * j;
      mma16816(acc[j], af[kk], pack2(c[0], c[LD]),
               pack2(c[8 * LD], c[9 * LD]));
    }
  }
}

// The accumulator of a 16 x 64 block as the A fragments of its product
// with a 64-row tile.
template <int NT>
__device__ __forceinline__ void to_frags(const float (&c)[NT][4],
                                         uint32_t (&af)[NT / 2][4]) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    af[kk][0] = pack_f(c[2 * kk][0], c[2 * kk][1]);
    af[kk][1] = pack_f(c[2 * kk][2], c[2 * kk][3]);
    af[kk][2] = pack_f(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    af[kk][3] = pack_f(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
}

// (a) on the tensor cores: lse and delta for one (query tile, head, row).
template <int HD>
__global__ void __launch_bounds__(kTcThreads) stats_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ out,
    const __nv_bfloat16* __restrict__ dout, float* __restrict__ lse,
    float* __restrict__ delta, int seq, int n_heads, int n_kv, float scale) {
  using C_ = Tc<HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* q_s = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* k_s = q_s + kBT * C_::LD;

  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (n_heads / n_kv);
  const int q0 = qt * kBT;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const size_t q_pos = (size_t)n_heads * HD, kv_pos = (size_t)n_kv * HD;
  const size_t q_off = (size_t)b * seq * q_pos + (size_t)h * HD;
  const size_t st_off = ((size_t)b * n_heads + h) * seq;
  load_tile_tc<HD>(q_s, q + q_off, q_pos, q0, seq);
  {  // delta = rowsum(dout * out): two lanes a row
    const int r = tid / 2, part = tid % 2;
    float acc = 0.f;
    if (q0 + r < seq) {
      const size_t row = q_off + (size_t)(q0 + r) * q_pos;
      for (int d = part; d < HD; d += 2)
        acc += __bfloat162float(dout[row + d]) * __bfloat162float(out[row + d]);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (part == 0 && q0 + r < seq) delta[st_off + q0 + r] = acc;
  }
  // This thread's rows: g and g + 8 of the warp's 16.
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int row0 = q0 + 16 * w + g;
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kBT;
    __syncthreads();
    load_tile_tc<HD>(k_s, k + (size_t)b * seq * kv_pos + (size_t)kh * HD,
                     kv_pos, k0, seq);
    __syncthreads();
    float s[C_::NT][4];
    zero(s);
    mma_abt<HD>(s, q_s, 16 * w, k_s);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qi = row0 + 8 * half;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < C_::NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = k0 + 8 * j + 2 * t + e;
          float& x = s[j][2 * half + e];
          x = kj <= qi ? x * scale : kNegInf;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[half], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < C_::NT; ++j)
        sum += expf(s[j][2 * half] - m_new) + expf(s[j][2 * half + 1] - m_new);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[half] = l[half] * expf(m[half] - m_new) + sum;
      m[half] = m_new;
    }
  }
  if (t == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half)
      if (row0 + 8 * half < seq)
        lse[st_off + row0 + 8 * half] = m[half] + logf(l[half]);
  }
}

// P and dS of a warp's 16 x 64 block in place of its scores s and dP dp;
// rows are queries when `rows_are_queries`, else keys (the transposed
// products of the dK/dV kernel).  lse_s / delta_s are per query.
template <int NT, bool ROWS_ARE_QUERIES>
__device__ __forceinline__ void p_and_ds(float (&s)[NT][4], float (&dp)[NT][4],
                                         const float* lse_s,
                                         const float* delta_s, int row_loc,
                                         int q0, int k0, int seq, float scale) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row_loc + (e >= 2 ? 8 : 0), c = 8 * j + 2 * t + (e & 1);
      const int qi_loc = ROWS_ARE_QUERIES ? r : c;
      const int qi = q0 + qi_loc, kj = k0 + (ROWS_ARE_QUERIES ? c : r);
      const bool live = kj <= qi && qi < seq;
      const float p = live ? expf(s[j][e] * scale - lse_s[qi_loc]) : 0.f;
      dp[j][e] = p * (dp[j][e] - delta_s[qi_loc]);
      s[j][e] = p;
    }
}

template <int HD>
__device__ __forceinline__ void load_stats_tc(float* lse_s, float* delta_s,
                                              const float* lse,
                                              const float* delta,
                                              size_t st_off, int q0, int seq) {
  const int tid = threadIdx.x;
  if (tid < kBT) {
    const bool ok = q0 + tid < seq;
    lse_s[tid] = ok ? lse[st_off + q0 + tid] : 0.f;
    delta_s[tid] = ok ? delta[st_off + q0 + tid] : 0.f;
  }
}

// Rows of a warp's 16 x hd accumulator, times `mul`, to bf16 rows
// [row0 + 16 w ...) of a [S, *, hd] output (rows at or past seq skipped).
template <int HD>
__device__ __forceinline__ void store_rows_tc(__nv_bfloat16* dst,
                                              const float (&acc)[Tc<HD>::DT][4],
                                              size_t stride, int row, int seq,
                                              float mul) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (row + 8 * half >= seq) continue;
    __nv_bfloat16* p = dst + (size_t)(row + 8 * half) * stride + 2 * t;
#pragma unroll
    for (int j = 0; j < Tc<HD>::DT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * j) = __floats2bfloat162_rn(
          acc[j][2 * half] * mul, acc[j][2 * half + 1] * mul);
  }
}

// (c) on the tensor cores: dK and dV for one (key tile, KV head, row);
// each warp owns 16 keys and computes the transposed products S^T = K Q^T
// and dP^T = V dout^T, then dV += P^T dout and dK += dS^T q.
template <int HD>
__global__ void __launch_bounds__(kTcThreads) dkdv_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int seq, int n_heads, int n_kv,
    float scale) {
  using C_ = Tc<HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* k_s = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* v_s = k_s + kBT * C_::LD;
  uint16_t* q_s = v_s + kBT * C_::LD;
  uint16_t* do_s = q_s + kBT * C_::LD;
  float* lse_s = reinterpret_cast<float*>(do_s + kBT * C_::LD);
  float* delta_s = lse_s + kBT;

  const int kt = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int group = n_heads / n_kv;
  const int k0 = kt * kBT;
  const int w = threadIdx.x / 32, g = (threadIdx.x % 32) >> 2;
  const size_t q_pos = (size_t)n_heads * HD, kv_pos = (size_t)n_kv * HD;
  const size_t kv_off = (size_t)b * seq * kv_pos + (size_t)kh * HD;
  load_tile_tc<HD>(k_s, k + kv_off, kv_pos, k0, seq);
  load_tile_tc<HD>(v_s, v + kv_off, kv_pos, k0, seq);

  float acc_k[C_::DT][4], acc_v[C_::DT][4];
  zero(acc_k);
  zero(acc_v);
  const int n_qt = (seq + kBT - 1) / kBT;
  for (int gi = 0; gi < group; ++gi) {
    const int h = kh * group + gi;
    const size_t q_off = (size_t)b * seq * q_pos + (size_t)h * HD;
    const size_t st_off = ((size_t)b * n_heads + h) * seq;
    for (int qt = kt; qt < n_qt; ++qt) {
      const int q0 = qt * kBT;
      __syncthreads();
      load_tile_tc<HD>(q_s, q + q_off, q_pos, q0, seq);
      load_tile_tc<HD>(do_s, dout + q_off, q_pos, q0, seq);
      load_stats_tc<HD>(lse_s, delta_s, lse, delta, st_off, q0, seq);
      __syncthreads();
      float s[C_::NT][4], dp[C_::NT][4];
      zero(s);
      zero(dp);
      mma_abt<HD>(s, k_s, 16 * w, q_s);
      mma_abt<HD>(dp, v_s, 16 * w, do_s);
      p_and_ds<C_::NT, false>(s, dp, lse_s, delta_s, 16 * w + g, q0, k0, seq,
                              scale);
      uint32_t af[kBT / 16][4];
      to_frags(s, af);
      mma_am<HD>(acc_v, af, do_s);
      to_frags(dp, af);
      mma_am<HD>(acc_k, af, q_s);
    }
  }
  const int row = k0 + 16 * w + g;
  store_rows_tc<HD>(dk + kv_off, acc_k, kv_pos, row, seq, scale);
  store_rows_tc<HD>(dv + kv_off, acc_v, kv_pos, row, seq, 1.f);
}

// (d) on the tensor cores: dQ for one (query tile, head, row); the longest
// tiles launch first.
template <int HD>
__global__ void __launch_bounds__(kTcThreads) dq_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int seq,
    int n_heads, int n_kv, float scale) {
  using C_ = Tc<HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* q_s = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* do_s = q_s + kBT * C_::LD;
  uint16_t* k_s = do_s + kBT * C_::LD;
  uint16_t* v_s = k_s + kBT * C_::LD;
  float* lse_s = reinterpret_cast<float*>(v_s + kBT * C_::LD);
  float* delta_s = lse_s + kBT;

  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (n_heads / n_kv);
  const int q0 = qt * kBT;
  const int w = threadIdx.x / 32, g = (threadIdx.x % 32) >> 2;
  const size_t q_pos = (size_t)n_heads * HD, kv_pos = (size_t)n_kv * HD;
  const size_t q_off = (size_t)b * seq * q_pos + (size_t)h * HD;
  const size_t kv_off = (size_t)b * seq * kv_pos + (size_t)kh * HD;
  load_tile_tc<HD>(q_s, q + q_off, q_pos, q0, seq);
  load_tile_tc<HD>(do_s, dout + q_off, q_pos, q0, seq);
  load_stats_tc<HD>(lse_s, delta_s, lse, delta,
                    ((size_t)b * n_heads + h) * seq, q0, seq);

  float acc[C_::DT][4];
  zero(acc);
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kBT;
    __syncthreads();
    load_tile_tc<HD>(k_s, k + kv_off, kv_pos, k0, seq);
    load_tile_tc<HD>(v_s, v + kv_off, kv_pos, k0, seq);
    __syncthreads();
    float s[C_::NT][4], dp[C_::NT][4];
    zero(s);
    zero(dp);
    mma_abt<HD>(s, q_s, 16 * w, k_s);
    mma_abt<HD>(dp, do_s, 16 * w, v_s);
    p_and_ds<C_::NT, true>(s, dp, lse_s, delta_s, 16 * w + g, q0, k0, seq,
                           scale);
    uint32_t af[kBT / 16][4];
    to_frags(dp, af);
    mma_am<HD>(acc, af, k_s);
  }
  store_rows_tc<HD>(dq + q_off, acc, q_pos, q0 + 16 * w + g, seq, scale);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, void* dq, void* dk, void* dv, void* lse,
           void* delta, int batch, int seq, int n_heads, int n_kv,
           float scale, cudaStream_t stream) {
  float* lse_f = static_cast<float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  static bool configured = false;
  if constexpr (std::is_same<T, __nv_bfloat16>::value && HD <= 128) {
    using C_ = Tc<HD>;
    if (!configured) {
      cudaError_t e = allow_smem(stats_tc_kernel<HD>, C_::stats_bytes);
      if (e == cudaSuccess)
        e = allow_smem(dkdv_tc_kernel<HD>, C_::grad_bytes);
      if (e == cudaSuccess) e = allow_smem(dq_tc_kernel<HD>, C_::grad_bytes);
      if (e != cudaSuccess) return (int)e;
      configured = true;
    }
    const int tiles = (seq + kBT - 1) / kBT;
    const T* q_p = static_cast<const T*>(q);
    const T* k_p = static_cast<const T*>(k);
    const T* v_p = static_cast<const T*>(v);
    const T* do_p = static_cast<const T*>(dout);
    stats_tc_kernel<HD><<<dim3(tiles, n_heads, batch), kTcThreads,
                          C_::stats_bytes, stream>>>(
        q_p, k_p, static_cast<const T*>(out), do_p, lse_f, delta_f, seq,
        n_heads, n_kv, scale);
    dkdv_tc_kernel<HD><<<dim3(tiles, n_kv, batch), kTcThreads,
                         C_::grad_bytes, stream>>>(
        q_p, k_p, v_p, do_p, lse_f, delta_f, static_cast<T*>(dk),
        static_cast<T*>(dv), seq, n_heads, n_kv, scale);
    dq_tc_kernel<HD><<<dim3(tiles, n_heads, batch), kTcThreads,
                       C_::grad_bytes, stream>>>(
        q_p, k_p, v_p, do_p, lse_f, delta_f, static_cast<T*>(dq), seq,
        n_heads, n_kv, scale);
  } else {
    using C_ = Cfg<HD>;
    if (!configured) {
      cudaError_t e = allow_smem(stats_kernel<T, HD>, C_::stats_bytes);
      if (e == cudaSuccess)
        e = allow_smem(dkdv_kernel<T, HD>, C_::grad_bytes);
      if (e == cudaSuccess) e = allow_smem(dq_kernel<T, HD>, C_::grad_bytes);
      if (e != cudaSuccess) return (int)e;
      configured = true;
    }
    const int tiles = (seq + C_::B - 1) / C_::B;
    const T* q_p = static_cast<const T*>(q);
    const T* k_p = static_cast<const T*>(k);
    const T* v_p = static_cast<const T*>(v);
    const T* do_p = static_cast<const T*>(dout);
    stats_kernel<T, HD><<<dim3(tiles, n_heads, batch), kThreads,
                          C_::stats_bytes, stream>>>(
        q_p, k_p, static_cast<const T*>(out), do_p, lse_f, delta_f, seq,
        n_heads, n_kv, scale);
    dkdv_kernel<T, HD><<<dim3(tiles, n_kv, batch), kThreads, C_::grad_bytes,
                         stream>>>(q_p, k_p, v_p, do_p, lse_f, delta_f,
                                   static_cast<T*>(dk), static_cast<T*>(dv),
                                   seq, n_heads, n_kv, scale);
    dq_kernel<T, HD><<<dim3(tiles, n_heads, batch), kThreads, C_::grad_bytes,
                       stream>>>(q_p, k_p, v_p, do_p, lse_f, delta_f,
                                 static_cast<T*>(dq), seq, n_heads, n_kv,
                                 scale);
  }
  return 0;
}

}  // namespace
}  // namespace flash_backward

// dtype: 0 = float32, 1 = bfloat16.  lse and delta are f32 scratch of
// [B, H, S] each, allocated by the caller.  Returns cudaGetLastError()
// after the three launches, or a CUDA error code for a shape the kernels
// do not take.
extern "C" int flash_backward_launch(const void* q, const void* k,
                                     const void* v, const void* out,
                                     const void* dout, void* dq, void* dk,
                                     void* dv, void* lse, void* delta,
                                     int batch, int seq, int n_heads,
                                     int n_kv, int hd, int dtype,
                                     float scale, void* stream) {
  if (n_kv <= 0 || n_heads % n_kv != 0 || seq <= 0 || batch <= 0 ||
      batch > 65535 || n_heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = (int)cudaErrorInvalidValue;
#define FLASH_BWD_CASE(T, HDV)                                          \
  rc = flash_backward::launch<T, HDV>(q, k, v, out, dout, dq, dk, dv, lse, \
                                      delta, batch, seq, n_heads, n_kv,   \
                                      scale, st)
  if (dtype == 0) {
    if (hd == 64) FLASH_BWD_CASE(float, 64);
    else if (hd == 128) FLASH_BWD_CASE(float, 128);
    else if (hd == 256) FLASH_BWD_CASE(float, 256);
  } else if (dtype == 1) {
    if (hd == 64) FLASH_BWD_CASE(__nv_bfloat16, 64);
    else if (hd == 128) FLASH_BWD_CASE(__nv_bfloat16, 128);
    else if (hd == 256) FLASH_BWD_CASE(__nv_bfloat16, 256);
  }
#undef FLASH_BWD_CASE
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
