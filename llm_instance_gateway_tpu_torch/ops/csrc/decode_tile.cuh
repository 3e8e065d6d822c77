// Single-token decode attention over a row's cached K/V, the device code
// shared by decode_attention.cu (contiguous lanes) and
// paged_decode_attention.cu (a block pool read through block tables).
//
// q [B, H, hd], lengths [B] int32, out [B, H, hd].  Only positions
// < lengths[b] count; a row of length 0 writes zeros.  Query head h reads
// KV head h / (H/K).
//   - lanes (PAGED = false): k/v [B, S_max, K, hd];
//   - pool (PAGED = true): k/v [n_blocks + 1, P, K, hd], tables [B, M]
//     int32; position s of row b is offset s % P of physical block
//     tables[b, s / P].  Entries past the row's length are never read.
//
// One thread block per (KV head, row) loops over the row's positions in
// shared-memory tiles only up to lengths[b] — the skipping the TPU
// kernel's DMA clamp buys — and shares each K/V tile among the G = H/K
// query heads of the group; each position's hd values are read once, with
// 16-byte loads, straight from the lane or the pool block (no gathered
// copy of the lane).  The online-softmax state (m, l) and the f32
// accumulator stay on chip for the whole sweep.
// Matches the reference numerics: f32 logits and accumulator, p rounded to
// the value dtype before the PV product (p.astype(v.dtype)), l summed from
// the unrounded p, output acc / max(l, 1e-30).
//
// int8 storage (S = int8_t; decode_attention_quant.cu and
// paged_decode_attention_quant.cu): k/v hold int8 values with one f32
// scale per (position, KV head), k_scale/v_scale [B, S_max, K] (lanes) or
// [n_blocks + 1, P, K] (pool, read through the same table).  Each 16-byte
// load carries 16 values of one (position, head); the tile fill reads that
// position's scale once and stores from_f<T>((float)x * scale) — the Pallas
// kernel's (x.astype(f32) * s).astype(q.dtype) — into the same T tile, so
// scores, softmax and PV are the unquantized kernel's own code.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// Internal linkage: four kernel libraries include this header, and their
// template instances must not resolve to one another's once they load.
namespace decode_tile {
namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGMax = 8;  // query heads per KV head (Llama-3-8B: 4)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even, like astype
}

// s_max: lane length (lanes) or M * P (pool).  page / tables: pool only.
// S: storage type, T (k_scale / v_scale unused) or int8_t.
template <typename T, typename S, int HD, bool PAGED>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const T* __restrict__ q, const S* __restrict__ k,
    const S* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ lengths, T* __restrict__ out, int s_max,
    int page, int n_heads, int n_kv, float scale) {
  constexpr bool QUANT = sizeof(S) == 1;
  // Tile rows: K + V tiles (in T) take 32 KB of shared memory.
  constexpr int TS = 16384 / (HD * (int)sizeof(T));
  constexpr int VEC = 16 / (int)sizeof(S);  // stored values per 16-byte load
  constexpr int VPR = HD / VEC;             // 16-byte loads per row
  constexpr int PER = (kGMax * HD + kThreads - 1) / kThreads;

  __shared__ float q_s[kGMax][HD];
  __shared__ __align__(16) T k_s[TS][HD];
  __shared__ __align__(16) T v_s[TS][HD];
  __shared__ float p_s[kGMax][TS];
  __shared__ float m_s[kGMax], l_s[kGMax], c_s[kGMax];

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int g_n = n_heads / n_kv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  int len = lengths[b];
  len = len < 0 ? 0 : (len > s_max ? s_max : len);

  for (int i = tid; i < g_n * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    q_s[g][d] = to_f(q[((size_t)b * n_heads + kh * g_n + g) * HD + d]);
  }
  if (tid < g_n) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) acc[j] = 0.f;

  const size_t pos_stride = (size_t)n_kv * HD;
  const size_t head_off = (size_t)kh * HD;
  const int* row_table = PAGED ? tables + (size_t)b * (s_max / page) : nullptr;
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += TS) {
    const int n = min(TS, len - t0);
    for (int i = tid; i < n * VPR; i += kThreads) {
      const int t = i / VPR, c = i % VPR;
      const int pos = t0 + t;
      size_t cell;  // index of (position, head 0) in the lane or the pool
      if (PAGED)
        cell = (size_t)__ldg(row_table + pos / page) * page + pos % page;
      else
        cell = (size_t)b * s_max + pos;
      const size_t off = cell * pos_stride + head_off;
      if constexpr (QUANT) {
        const size_t si = cell * n_kv + kh;  // scale of (position, head)
        const float ks = __ldg(k_scale + si), vs = __ldg(v_scale + si);
        const uint4 kr = reinterpret_cast<const uint4*>(k + off)[c];
        const uint4 vr = reinterpret_cast<const uint4*>(v + off)[c];
        const int8_t* kb = reinterpret_cast<const int8_t*>(&kr);
        const int8_t* vb = reinterpret_cast<const int8_t*>(&vr);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          k_s[t][c * VEC + j] = from_f<T>((float)kb[j] * ks);
          v_s[t][c * VEC + j] = from_f<T>((float)vb[j] * vs);
        }
      } else {
        reinterpret_cast<uint4*>(&k_s[t][0])[c] =
            reinterpret_cast<const uint4*>(k + off)[c];
        reinterpret_cast<uint4*>(&v_s[t][0])[c] =
            reinterpret_cast<const uint4*>(v + off)[c];
      }
    }
    __syncthreads();

    // Scores: one warp per (group head, position) pair, lanes split hd.
    for (int pi = warp; pi < g_n * TS; pi += kWarps) {
      const int g = pi / TS, t = pi % TS;
      float s = kNegInf;
      if (t < n) {
        float part = 0.f;
#pragma unroll
        for (int d = lane; d < HD; d += 32) part += q_s[g][d] * to_f(k_s[t][d]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        s = part * scale;
      }
      if (lane == 0) p_s[g][t] = s;
    }
    __syncthreads();

    // Online softmax: one warp per group head.
    for (int g = warp; g < g_n; g += kWarps) {
      float mx = kNegInf;
      for (int t = lane; t < TS; t += 32) mx = fmaxf(mx, p_s[g][t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < TS; t += 32) {
        const float p = expf(p_s[g][t] - m_new);  // masked: exp(-1e30) = 0
        sum += p;
        p_s[g][t] = to_f(from_f<T>(p));  // p.astype(v.dtype)
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // Accumulator: thread owns (g, d) pairs tid + j * kThreads.
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = tid + j * kThreads;
      if (e < g_n * HD) {
        const int g = e / HD, d = e % HD;
        float a = acc[j] * c_s[g];
        for (int t = 0; t < n; ++t) a += p_s[g][t] * to_f(v_s[t][d]);
        acc[j] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = tid + j * kThreads;
    if (e < g_n * HD) {
      const int g = e / HD, d = e % HD;
      out[((size_t)b * n_heads + kh * g_n + g) * HD + d] =
          from_f<T>(acc[j] / fmaxf(l_s[g], 1e-30f));
    }
  }
}

// dtype: 0 = float32, 1 = bfloat16 (q and out; k/v too unless QUANT, where
// they are int8 with f32 scales).  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape the kernel does not take.
template <bool PAGED, bool QUANT>
int launch_any(const void* q, const void* k, const void* v,
               const void* k_scale, const void* v_scale, const void* tables,
               const void* lengths, void* out, int batch, int s_max, int page,
               int n_heads, int n_kv, int hd, int dtype, float scale,
               void* stream) {
  if (n_kv <= 0 || n_heads % n_kv != 0 || n_heads / n_kv > kGMax ||
      batch <= 0 || batch > 65535 || (PAGED && (page <= 0 || s_max % page)) ||
      (QUANT && (k_scale == nullptr || v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_kv, batch);
  bool launched = true;
#define DECODE_TILE_CASE(T, HDV)                                            \
  {                                                                         \
    using S = typename std::conditional<QUANT, int8_t, T>::type;            \
    decode_kernel<T, S, HDV, PAGED><<<grid, kThreads, 0, st>>>(             \
        static_cast<const T*>(q), static_cast<const S*>(k),                 \
        static_cast<const S*>(v), static_cast<const float*>(k_scale),       \
        static_cast<const float*>(v_scale),                                 \
        static_cast<const int*>(tables), static_cast<const int*>(lengths),  \
        static_cast<T*>(out), s_max, page, n_heads, n_kv, scale);           \
  }
  if (dtype == 0 && hd == 64) DECODE_TILE_CASE(float, 64)
  else if (dtype == 0 && hd == 128) DECODE_TILE_CASE(float, 128)
  else if (dtype == 0 && hd == 256) DECODE_TILE_CASE(float, 256)
  else if (dtype == 1 && hd == 64) DECODE_TILE_CASE(__nv_bfloat16, 64)
  else if (dtype == 1 && hd == 128) DECODE_TILE_CASE(__nv_bfloat16, 128)
  else if (dtype == 1 && hd == 256) DECODE_TILE_CASE(__nv_bfloat16, 256)
  else launched = false;
#undef DECODE_TILE_CASE
  if (!launched) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace decode_tile
