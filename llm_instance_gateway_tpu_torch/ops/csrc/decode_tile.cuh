// Single-token decode attention over a row's cached K/V, the device code
// shared by decode_attention.cu (contiguous lanes) and
// paged_decode_attention.cu (a block pool read through block tables), and
// by their int8 variants.  Replaces the body of the TPU kernels
// llm_instance_gateway_tpu/ops/pallas_decode_attention.py::_decode_kernel
// and ::_paged_kernel (pallas_call at :153 and :277).
//
// q [B, H, hd], lengths [B] int32, out [B, H, hd].  Only positions
// < lengths[b] count; a row of length 0 writes zeros.  Query head h reads
// KV head h / (H/K).
//   - lanes (PAGED = false): k/v [B, S_max, K, hd];
//   - pool (PAGED = true): k/v [n_blocks + 1, P, K, hd], tables [B, M]
//     int32; position s of row b is offset s % P of physical block
//     tables[b, s / P].  Entries past the row's length are never read.
// Numerics (both kernels below): f32 logits scaled by 1/sqrt(hd), an online
// f32 softmax with masked logits at -1e30, p rounded to the value dtype
// before the PV product (p.astype(v.dtype)), l summed from the unrounded
// p, output acc / max(l, 1e-30).
//
// Split-S (split_kernel + combine_kernel, launch_split; every library
// that includes this header).  The TPU kernel walks a row's positions as the sequential
// grid axis of one core.  On Hopper a block that walks a row alone is a
// chain of dependent tile latencies (one block per (KV head, row) took
// ~16 us per 64-position tile, 128 tiles in series for an 8192-long row),
// so each row is cut into splits of L positions and the grid is
// (KV head, row, split): block (kh, b, s) covers positions
// [s*L, min((s+1)*L, lengths[b])) and returns at once when that range is
// empty.  L comes from the host's shapes and the SM count only (never
// from lengths, which live on the device): see split_plan in
// ops/decode_attention.py.  Each live block keeps the G = H/K query heads
// of its group, shares every K/V tile among them, and writes one
// unnormalised f32 partial per head: its running max m, its sum l and its
// accumulator acc[hd].  combine_kernel merges a row's live splits,
// M = max m_i, out = sum exp(m_i - M) acc_i / max(sum exp(m_i - M) l_i,
// 1e-30), and writes zeros for a row with none.  p is rounded relative to
// the split's running maximum, not the row's, as any tiled sweep rounds
// relative to the maximum it has seen so far.
//
// Inside a split:
//   - K/V tiles of 16 KB each (64 positions at bf16 hd 128) are double
//     buffered: the next tile's 16-byte cp.async.cg copies are in flight
//     while this one is scored (cp.async rather than TMA: a tile is 1024
//     16-byte rows of scattered pool cells, which a tensor map of the pool
//     would have to describe per cell, and 128 threads start them with 8
//     instructions each).  int8 storage is staged in registers instead
//     (its tile fill dequantizes): the next tile's 16-byte loads and
//     scales issue right after the tile-landed barrier, and are
//     dequantized into the other buffer after the PV product, so the
//     loads stay in flight across the scores, softmax and PV.
//   - the pool's table entries for the split (L / P ints) are read once
//     into shared memory, so no 16-byte load waits on a table load;
//   - scores: R = 128 / TS threads per position each sweep 8 16-byte
//     chunks of the K row for all G heads (q from shared memory as
//     float4), one log2(R)-step shuffle per head (one step at bf16 hd 128);
//   - PV: each thread owns one 16-byte column chunk of V and 8 positions of
//     the tile, for all G heads, with no shuffles; the per-thread partial
//     sums meet once, at the end of the split, through shared memory;
//   - tile rows are stored with the 16-byte chunk index XORed with
//     (position & 7), so the score threads (a row each) and the PV threads
//     (a column chunk each) read distinct banks in every quarter warp; q's
//     per-thread segments are padded by 16 bytes for the same reason.
// Three __syncthreads() per tile: tile landed, scores written, softmax
// written.  ptxas: 140-150 registers (int8 storage: 158-168, under the
// 168 that 3 blocks of 128 threads leave), no spills, ~72 KB of shared
// memory at hd 128, so 3 blocks per SM.
//
// Bound on an H100: the K/V bytes the lengths cover at 3.35 TB/s.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 (700 W), device
// time per call (split + combine): 0.0580 ms for the paged table's 8 rows
// of up to 8192 positions (0.47 of the bound; 2.09 ms with one block per
// (KV head, row)), 0.0186 ms for the lane rows of up to 1024 (0.24; 0.261).
// Over int8 storage at the same shapes: 0.0709 ms paged (0.20 of its
// bound, half the bytes plus scales; 2.30 ms with one block per row) and
// 0.0209 ms lanes (0.11; 0.283).
//
// int8 storage (S = int8_t): k/v hold int8 values with one f32 scale per
// (position, KV head), k_scale/v_scale [B, S_max, K] (lanes) or
// [n_blocks + 1, P, K] (pool, read through the same table).  The tile fill
// stores from_f<T>((float)x * scale) — the Pallas kernel's
// (x.astype(f32) * s).astype(q.dtype) — into the same T tile, so scores,
// softmax and PV are the unquantized kernel's own code.  The splits are
// counted in tiles of T, since the dequantized tile is what a block holds
// (64 positions at bf16 hd 128, 8 KB of int8 per K or V tile).

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

// ---------------------------------------------------------------------------
// Split-S: split_kernel + combine_kernel
// ---------------------------------------------------------------------------

constexpr int kTileBytes = 16384;     // one K or V tile, in T
constexpr int kMaxSplitPages = 1024;  // table entries one split may hold

// T values <-> one 16-byte chunk.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static __forceinline__ void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ static __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  // bf16 is the upper half of an f32; the lower address is the low half.
  __device__ static __forceinline__ void unpack(const uint4& r, float* f) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static __forceinline__ unsigned pair(float a, float b) {
    return (unsigned)__bfloat16_as_ushort(__float2bfloat16(a)) |
           ((unsigned)__bfloat16_as_ushort(__float2bfloat16(b)) << 16);
  }
  __device__ static __forceinline__ uint4 pack(const float* f) {
    return make_uint4(pair(f[0], f[1]), pair(f[2], f[3]), pair(f[4], f[5]),
                      pair(f[6], f[7]));
  }
};

// The split kernel's geometry for value type T and head dim HD.
template <typename T, int HD>
struct Split {
  static constexpr int TS = kTileBytes / (HD * (int)sizeof(T));  // positions
  static constexpr int EV = Vec<T>::N;  // T values per 16-byte chunk
  static constexpr int NC = HD / EV;    // chunks per tile row
  static constexpr int R = kThreads / TS;   // score threads per position
  static constexpr int RP = kThreads / NC;  // PV threads per column chunk
  static constexpr int SEG = HD / R;        // dims per score thread
  static constexpr int QSEG = SEG + 4;      // q_s segment, padded (floats)
  static constexpr int QS = R * QSEG;       // q_s row (floats)
  static constexpr int TILE = TS * HD;      // T values per tile
  // K, V x 2 stages | q_s [kGMax][QS] | p_s [kGMax][TS] | m, l, corr | table
  static constexpr size_t kFixed =
      4 * (size_t)kTileBytes +
      sizeof(float) * ((size_t)kGMax * QS + (size_t)kGMax * TS + 3 * kGMax);
  static_assert(SEG == 8 * EV && TS == 8 * RP && NC >= 8 && R <= 8,
                "each score thread sweeps 8 chunks, each PV thread 8 rows");
  static_assert((size_t)RP * kGMax * HD * sizeof(float) <= 4 * kTileBytes,
                "the end-of-split reduction reuses the tile buffers");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Grid (n_kv, batch, n_split); part holds acc [B, H, n_split, HD], then m
// and l [B, H, n_split] (f32).  Blocks past a row's length write nothing.
template <typename T, typename S, int HD, bool PAGED>
__global__ void __launch_bounds__(kThreads, 3) split_kernel(
    const T* __restrict__ q, const S* __restrict__ k,
    const S* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ lengths, float* __restrict__ part, int s_max,
    int page, int n_heads, int n_kv, int split_len, int n_split,
    float scale) {
  using G = Split<T, HD>;
  constexpr bool QUANT = sizeof(S) == 1;
  constexpr int TS = G::TS, EV = G::EV, NC = G::NC, R = G::R, RP = G::RP;
  constexpr int NCS = HD * (int)sizeof(S) / 16;  // stored chunks per row
  constexpr int NR = QUANT ? TS * NCS / kThreads : 1;  // staged per thread

  extern __shared__ __align__(16) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);  // [stage][K, V][TS][HD]
  float* q_s = reinterpret_cast<float*>(smem + 4 * kTileBytes);
  float* p_s = q_s + kGMax * G::QS;  // [kGMax][TS]
  float* m_s = p_s + kGMax * TS;
  float* l_s = m_s + kGMax;
  float* c_s = l_s + kGMax;
  int* tab_s = reinterpret_cast<int*>(c_s + kGMax);

  const int kh = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int g_n = n_heads / n_kv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  int len = lengths[b];
  len = len < 0 ? 0 : (len > s_max ? s_max : len);
  const int split0 = sp * split_len;
  if (split0 >= len) return;
  const int end = min(split0 + split_len, len);
  const int n_tiles = (end - split0 + TS - 1) / TS;

  const size_t pos_stride = (size_t)n_kv * HD;
  const size_t head_off = (size_t)kh * HD;
  if constexpr (PAGED) {
    const int* row = tables + (size_t)b * (s_max / page) + split0 / page;
    for (int i = tid; i * page < end - split0; i += kThreads)
      tab_s[i] = __ldg(row + i);
  }
  for (int i = tid; i < g_n * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    q_s[g * G::QS + (d / G::SEG) * G::QSEG + d % G::SEG] =
        to_f(q[((size_t)b * n_heads + kh * g_n + g) * HD + d]);
  }
  if (tid < g_n) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kGMax][EV];
#pragma unroll
  for (int g = 0; g < kGMax; ++g)
#pragma unroll
    for (int e = 0; e < EV; ++e) acc[g][e] = 0.f;
  __syncthreads();  // the table, before the first fill reads it

  // Index of (position, head 0) in the lane or the pool.
  auto cell_of = [&](int pos) -> size_t {
    if constexpr (PAGED)
      return (size_t)tab_s[(pos - split0) / page] * page + pos % page;
    else
      return (size_t)b * s_max + pos;
  };
  // bf16/f32: positions [t0, t0 + n) straight into a stage, asynchronously.
  auto fill = [&](int t0, int n, T* kb, T* vb) {
    for (int i = tid; i < n * NC; i += kThreads) {
      const int t = i / NC, c = i % NC;
      const size_t off = cell_of(t0 + t) * pos_stride + head_off + c * EV;
      const int dst = t * HD + (c ^ (t & 7)) * EV;
      cp_async16(kb + dst, k + off);
      cp_async16(vb + dst, v + off);
    }
    cp_async_commit();
  };
  // int8: a tile's 16-byte chunks and scales staged in registers, then
  // dequantized into a stage.
  uint4 kr[NR], vr[NR];
  float ksr[NR], vsr[NR];
  auto load_raw = [&](int t0, int n) {
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int i = tid + j * kThreads, t = i / NCS, c = i % NCS;
      if (t < n) {
        const size_t cell = cell_of(t0 + t);
        const size_t off = cell * pos_stride + head_off + c * 16;
        kr[j] = __ldg(reinterpret_cast<const uint4*>(k + off));
        vr[j] = __ldg(reinterpret_cast<const uint4*>(v + off));
        ksr[j] = __ldg(k_scale + cell * n_kv + kh);
        vsr[j] = __ldg(v_scale + cell * n_kv + kh);
      }
    }
  };
  auto store_raw = [&](int n, T* kb, T* vb) {
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int i = tid + j * kThreads, t = i / NCS, c = i % NCS;
      if (t < n) {
        const int8_t* kq = reinterpret_cast<const int8_t*>(&kr[j]);
        const int8_t* vq = reinterpret_cast<const int8_t*>(&vr[j]);
#pragma unroll
        for (int u = 0; u < 16 / EV; ++u) {
          float kf[EV], vf[EV];  // pack rounds them to T
#pragma unroll
          for (int e = 0; e < EV; ++e) {
            kf[e] = (float)kq[u * EV + e] * ksr[j];
            vf[e] = (float)vq[u * EV + e] * vsr[j];
          }
          const int dst = t * HD + ((c * (16 / EV) + u) ^ (t & 7)) * EV;
          *reinterpret_cast<uint4*>(kb + dst) = Vec<T>::pack(kf);
          *reinterpret_cast<uint4*>(vb + dst) = Vec<T>::pack(vf);
        }
      }
    }
  };

  if constexpr (QUANT) {
    load_raw(split0, min(TS, end - split0));
    store_raw(min(TS, end - split0), tiles, tiles + G::TILE);
  } else {
    fill(split0, min(TS, end - split0), tiles, tiles + G::TILE);
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = split0 + it * TS, n = min(TS, end - t0);
    const T* kb = tiles + (it & 1) * 2 * G::TILE;
    const T* vb = kb + G::TILE;
    T* kn = tiles + ((it + 1) & 1) * 2 * G::TILE;
    T* vn = kn + G::TILE;
    const bool more = it + 1 < n_tiles;
    const int n1 = more ? min(TS, end - t0 - TS) : 0;
    if constexpr (!QUANT) cp_async_wait_all();
    // Tile `it` is in; every thread is done with tile it - 1's stage.
    __syncthreads();
    if (more) {
      if constexpr (QUANT)
        load_raw(t0 + TS, n1);
      else
        fill(t0 + TS, n1, kn, vn);
    }

    // Scores: thread (t, r) sweeps chunks [8r, 8r + 8) of K row t, each
    // chunk once for all G heads; rows t >= n are masked.
    {
      const int t = tid / R, r = tid % R;
      float dot[kGMax];
#pragma unroll
      for (int g = 0; g < kGMax; ++g) dot[g] = 0.f;
      const uint4* krow = reinterpret_cast<const uint4*>(kb + t * HD);
      const float* qseg = q_s + r * G::QSEG;
#pragma unroll
      for (int step = 0; step < 8; ++step) {
        const int j = (step + r * (8 / R)) & 7;  // the R threads' banks differ
        float kf[EV];
        Vec<T>::unpack(krow[(r * 8 + j) ^ (t & 7)], kf);
#pragma unroll
        for (int g = 0; g < kGMax; ++g) {
          if (g < g_n) {
            const float4* qv =
                reinterpret_cast<const float4*>(qseg + g * G::QS + j * EV);
#pragma unroll
            for (int e = 0; e < EV / 4; ++e) {
              const float4 qq = qv[e];
              dot[g] = fmaf(qq.x, kf[4 * e], dot[g]);
              dot[g] = fmaf(qq.y, kf[4 * e + 1], dot[g]);
              dot[g] = fmaf(qq.z, kf[4 * e + 2], dot[g]);
              dot[g] = fmaf(qq.w, kf[4 * e + 3], dot[g]);
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kGMax; ++g) {
        if (g < g_n) {
#pragma unroll
          for (int o = R / 2; o > 0; o >>= 1)
            dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
          if (r == g % R) p_s[g * TS + t] = t < n ? dot[g] * scale : kNegInf;
        }
      }
    }
    __syncthreads();

    // Online softmax: one warp per group head.
    for (int g = warp; g < g_n; g += kWarps) {
      float* ps = p_s + g * TS;
      float mx = kNegInf;
      for (int t = lane; t < TS; t += 32) mx = fmaxf(mx, ps[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < TS; t += 32) {
        const float p = expf(ps[t] - m_new);  // masked: exp(-1e30) = 0
        sum += p;
        ps[t] = to_f(from_f<T>(p));  // p.astype(v.dtype)
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

    // PV: thread (c, tp) owns column chunk c of V at rows tp + RP * j.
    {
      const int c = tid % NC, tp = tid / NC;
#pragma unroll
      for (int g = 0; g < kGMax; ++g) {
        if (g < g_n) {
          const float corr = c_s[g];
#pragma unroll
          for (int e = 0; e < EV; ++e) acc[g][e] *= corr;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int t = tp + j * RP;
        if (t < n) {
          float vf[EV];
          Vec<T>::unpack(reinterpret_cast<const uint4*>(vb + t * HD)[c ^ (t & 7)],
                         vf);
#pragma unroll
          for (int g = 0; g < kGMax; ++g) {
            if (g < g_n) {
              const float p = p_s[g * TS + t];
#pragma unroll
              for (int e = 0; e < EV; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
            }
          }
        }
      }
    }
    if constexpr (QUANT) {
      if (more) store_raw(n1, kn, vn);
    }
  }

  // The RP row phases' sums meet in the (now idle) tile buffers.
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [RP][g_n][HD]
  {
    const int c = tid % NC, tp = tid / NC;
#pragma unroll
    for (int g = 0; g < kGMax; ++g) {
      if (g < g_n) {
        float4* dst = reinterpret_cast<float4*>(
            red + ((size_t)tp * g_n + g) * HD + c * EV);
#pragma unroll
        for (int e = 0; e < EV / 4; ++e)
          dst[e] = make_float4(acc[g][4 * e], acc[g][4 * e + 1],
                               acc[g][4 * e + 2], acc[g][4 * e + 3]);
      }
    }
  }
  __syncthreads();
  const size_t n_parts = (size_t)gridDim.y * n_heads * n_split;
  const size_t row = ((size_t)b * n_heads + kh * g_n) * n_split + sp;
  for (int i = tid; i < g_n * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    float sum = 0.f;
#pragma unroll
    for (int tp = 0; tp < RP; ++tp) sum += red[((size_t)tp * g_n + g) * HD + d];
    part[(row + (size_t)g * n_split) * HD + d] = sum;
  }
  if (tid < g_n) {
    part[n_parts * HD + row + (size_t)tid * n_split] = m_s[tid];
    part[n_parts * (HD + 1) + row + (size_t)tid * n_split] = l_s[tid];
  }
}

// Grid (n_heads, batch), HD threads: merges row b's live splits
// ceil(lengths[b] / split_len) for query head h; none gives zeros.
template <typename T, int HD>
__global__ void __launch_bounds__(HD) combine_kernel(
    const float* __restrict__ part, const int* __restrict__ lengths,
    T* __restrict__ out, int s_max, int n_heads, int split_len,
    int n_split) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > s_max ? s_max : len);
  const int n_live = (len + split_len - 1) / split_len;
  const size_t n_parts = (size_t)gridDim.y * n_heads * n_split;
  const size_t row = ((size_t)b * n_heads + h) * n_split;
  const float* pm = part + n_parts * HD + row;
  const float* pl = pm + n_parts;
  const float* pa = part + row * HD + d;
  float mx = kNegInf;
  for (int i = 0; i < n_live; ++i) mx = fmaxf(mx, pm[i]);
  float num = 0.f, den = 0.f;
  for (int i = 0; i < n_live; ++i) {
    const float w = expf(pm[i] - mx);
    num = fmaf(w, pa[(size_t)i * HD], num);
    den = fmaf(w, pl[i], den);
  }
  out[((size_t)b * n_heads + h) * HD + d] = from_f<T>(num / fmaxf(den, 1e-30f));
}

// dtype: 0 = float32, 1 = bfloat16 (q, k/v and out alike; QUANT: k/v int8
// with f32 scales).  split_len: positions per split, a multiple of the
// tile (Split<T, HD>::TS) and, for the pool, of page.  part: f32 scratch
// of batch * n_heads * n_split * (hd + 2) values, n_split =
// ceil(s_max / split_len).  Launches split_kernel, then combine_kernel;
// returns cudaGetLastError() after each, or cudaErrorInvalidValue for a
// shape the kernels do not take.
template <bool PAGED, bool QUANT>
int launch_split(const void* q, const void* k, const void* v,
                 const void* k_scale, const void* v_scale, const void* tables,
                 const void* lengths, void* out, void* part, int batch,
                 int s_max, int page, int n_heads, int n_kv, int hd,
                 int dtype, float scale, int split_len, void* stream) {
  if (n_kv <= 0 || n_heads % n_kv != 0 || n_heads / n_kv > kGMax ||
      batch <= 0 || batch > 65535 || s_max <= 0 || split_len <= 0 ||
      part == nullptr ||
      (PAGED && (page <= 0 || s_max % page || split_len % page ||
                 split_len / page > kMaxSplitPages)) ||
      (QUANT && (k_scale == nullptr || v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int n_split = (s_max + split_len - 1) / split_len;
  if (n_split > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = (int)cudaErrorInvalidValue;
#define DECODE_SPLIT_CASE(T, HDV)                                             \
  {                                                                           \
    using S = typename std::conditional<QUANT, int8_t, T>::type;              \
    using G = Split<T, HDV>;                                                  \
    if (split_len % G::TS) return (int)cudaErrorInvalidValue;                 \
    static bool configured = false;                                           \
    if (!configured) {                                                        \
      const cudaError_t e = cudaFuncSetAttribute(                             \
          split_kernel<T, S, HDV, PAGED>,                                     \
          cudaFuncAttributeMaxDynamicSharedMemorySize,                        \
          (int)(G::kFixed + kMaxSplitPages * sizeof(int)));                   \
      if (e != cudaSuccess) return (int)e;                                    \
      configured = true;                                                      \
    }                                                                         \
    const size_t smem =                                                       \
        G::kFixed + (PAGED ? (size_t)(split_len / page) * sizeof(int) : 0);   \
    split_kernel<T, S, HDV, PAGED>                                            \
        <<<dim3(n_kv, batch, n_split), kThreads, smem, st>>>(                 \
            static_cast<const T*>(q), static_cast<const S*>(k),               \
            static_cast<const S*>(v), static_cast<const float*>(k_scale),     \
            static_cast<const float*>(v_scale),                               \
            static_cast<const int*>(tables),                                  \
            static_cast<const int*>(lengths), static_cast<float*>(part),      \
            s_max, page, n_heads, n_kv, split_len, n_split, scale);           \
    rc = (int)cudaGetLastError();                                             \
    if (rc != 0) return rc;                                                   \
    combine_kernel<T, HDV><<<dim3(n_heads, batch), HDV, 0, st>>>(             \
        static_cast<const float*>(part), static_cast<const int*>(lengths),    \
        static_cast<T*>(out), s_max, n_heads, split_len, n_split);            \
    rc = (int)cudaGetLastError();                                             \
  }
  if (dtype == 0 && hd == 64) DECODE_SPLIT_CASE(float, 64)
  else if (dtype == 0 && hd == 128) DECODE_SPLIT_CASE(float, 128)
  else if (dtype == 0 && hd == 256) DECODE_SPLIT_CASE(float, 256)
  else if (dtype == 1 && hd == 64) DECODE_SPLIT_CASE(__nv_bfloat16, 64)
  else if (dtype == 1 && hd == 128) DECODE_SPLIT_CASE(__nv_bfloat16, 128)
  else if (dtype == 1 && hd == 256) DECODE_SPLIT_CASE(__nv_bfloat16, 256)
#undef DECODE_SPLIT_CASE
  return rc;
}

}  // namespace
}  // namespace decode_tile
