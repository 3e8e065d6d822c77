// Flash-style attention of a query chunk against a key/value sequence, the
// device code shared by flash_prefill.cu (start = 0, S_kv = S) and
// chunk_attention.cu (a chunk at a runtime offset against a cache lane).
// launch_by_dtype dispatches by dtype: bfloat16 runs on the tensor cores
// (flash_tile_sm90.cuh: wgmma fed by TMA), float32 on the CUDA-core FMA
// kernel below.  f32 stays off the tensor cores on purpose: there they
// would run in TF32 (about 3 decimal digits), and the f32 path is what the
// card-vs-CPU reference checks hold to summation-order agreement.
//
// q/out [B, C, H, hd], k/v [B, S_kv, K, hd]; query head h reads KV head
// h / (H/K); scale 1/sqrt(hd).  Query row i sits at global position
// start + i and attends key positions j <= start + i with j < S_kv.
//
// The f32 kernel: one thread block per (64-row query tile, head, row)
// holds its scaled query tile, the online-softmax state and the output
// accumulator on chip while it streams 64-row K/V tiles only up to the
// tile's last reach, min(start + last row, S_kv - 1): tiles past it are
// never read, and rows whose position runs past the lane (a final chunk's
// pad queries) stop at S_kv instead of reading past it.  The tile that
// straddles the reach is masked; ragged tiles (C or S_kv not a multiple
// of 64) load zeros and mask.  The products run on CUDA-core FMAs from
// shared memory, with each thread owning a 4x4 score tile and a
// 4 x hd/16 accumulator tile.
// Numerics match the TPU kernels' shared _softmax_block: q * scale in f32,
// p kept in f32 for the PV product, output acc / max(l, 1e-30).  Key 0 is
// always live for every row, so no row's first tile is fully masked (no
// exp(0) of two -1e30s).

#pragma once

#include <cuda_runtime.h>

#include "flash_tile_sm90.cuh"

// Internal linkage: two kernel libraries include this header, and a
// template's function-local static (the smem attribute flag) would
// otherwise be one GNU-unique symbol shared by both.
namespace flash_tile {
namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // key rows per tile
constexpr int kThreads = 256;

template <int HD>
struct Smem {
  static constexpr int QS = HD + 1;   // f32 row stride (padded: no conflicts)
  static constexpr int SS = kBK + 1;  // f32 score row stride
  static constexpr int KS = HD + 2;   // K/V row stride (padded)
  static constexpr size_t kFloats = (size_t)kBQ * QS + (size_t)kBQ * SS + 3 * kBQ;
  static constexpr size_t bytes =
      kFloats * sizeof(float) + 2 * (size_t)kBK * KS * sizeof(float);
};

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int n_q, int s_kv,
    int start, int n_heads, int n_kv, float scale) {
  using L = Smem<HD>;
  constexpr int QS = L::QS, SS = L::SS, KS = L::KS;
  constexpr int DJ = HD / 16;  // accumulator columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // [kBQ][QS]
  float* s_s = q_s + kBQ * QS;                        // [kBQ][SS]
  float* m_s = s_s + kBQ * SS;                        // [kBQ]
  float* l_s = m_s + kBQ;                             // [kBQ]
  float* c_s = l_s + kBQ;                             // [kBQ]
  float* k_s = c_s + kBQ;                             // [kBK][KS]
  float* v_s = k_s + kBK * KS;                        // [kBK][KS]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (n_heads / n_kv);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t q_pos = (size_t)n_heads * HD;  // stride between positions
  const size_t kv_pos = (size_t)n_kv * HD;
  const float* qb = q + (size_t)b * n_q * q_pos + (size_t)h * HD;
  const float* kb = k + (size_t)b * s_kv * kv_pos + (size_t)kh * HD;
  const float* vb = v + (size_t)b * s_kv * kv_pos + (size_t)kh * HD;
  float* ob = out + (size_t)b * n_q * q_pos + (size_t)h * HD;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    float x = 0.f;
    if (q0 + r < n_q) x = qb[(size_t)(q0 + r) * q_pos + d] * scale;
    q_s[r * QS + d] = x;
  }
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  __syncthreads();

  // Last key this tile's stored rows can reach, clamped to the lane.
  const int last_row = min(q0 + kBQ, n_q) - 1;
  const int reach = min(start + last_row, s_kv - 1);
  for (int kt = 0; kt <= reach / kBK; ++kt) {
    const int k0 = kt * kBK;
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int c = i / HD, d = i % HD;
      float kx = 0.f, vx = 0.f;
      if (k0 + c < s_kv) {
        kx = kb[(size_t)(k0 + c) * kv_pos + d];
        vx = vb[(size_t)(k0 + c) * kv_pos + d];
      }
      k_s[c * KS + d] = kx;
      v_s[c * KS + d] = vx;
    }
    __syncthreads();

    // Scores: thread owns rows ty*4 + i, columns tx + 16*j.
    float sacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sacc[i][j] += qv[i] * kv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = tx + 16 * j;
        const bool live = k0 + c <= start + q0 + r && k0 + c < s_kv;
        s_s[r * SS + c] = live ? sacc[i][j] : kNegInf;
      }
    __syncthreads();

    // Online softmax: four neighbouring lanes per query row.
    {
      const int r = tid / 4, part = tid % 4;
      float mx = kNegInf;
      for (int c = part; c < kBK; c += 4) mx = fmaxf(mx, s_s[r * SS + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = part; c < kBK; c += 4) {
        const float p = expf(s_s[r * SS + c] - m_new);
        s_s[r * SS + c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // Accumulator: thread owns rows ty*4 + i, columns tx + 16*j.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = s_s[(ty * 4 + i) * SS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = v_s[c * KS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += pv[i] * vv;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r < n_q) {
      const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        ob[(size_t)(q0 + r) * q_pos + tx + 16 * j] = acc[i][j] / l;
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int n_q, int s_kv, int start, int n_heads, int n_kv, float scale,
           cudaStream_t stream) {
  const size_t smem = Smem<HD>::bytes;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((n_q + kBQ - 1) / kBQ, n_heads, batch);
  flash_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), n_q, s_kv,
      start, n_heads, n_kv, scale);
  return 0;
}

// dtype: 0 = float32 (the FMA kernel above), 1 = bfloat16 (the tensor-core
// kernel of flash_tile_sm90.cuh).  Returns cudaGetLastError() after the
// launch, or a CUDA error code for a shape the kernel does not take.
inline int launch_by_dtype(const void* q, const void* k, const void* v,
                           void* out, int batch, int n_q, int s_kv,
                           int start, int n_heads, int n_kv, int hd,
                           int dtype, float scale, void* stream) {
  if (n_kv <= 0 || n_heads % n_kv != 0 || n_q <= 0 || s_kv <= 0 ||
      start < 0 || batch > 65535 || n_heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = (int)cudaErrorInvalidValue;
#define FLASH_TILE_CASE(NS, HDV)                                          \
  rc = NS::launch<HDV>(q, k, v, out, batch, n_q, s_kv, start, n_heads,    \
                       n_kv, scale, st)
  if (dtype == 0) {
    if (hd == 64) FLASH_TILE_CASE(flash_tile, 64);
    else if (hd == 128) FLASH_TILE_CASE(flash_tile, 128);
    else if (hd == 256) FLASH_TILE_CASE(flash_tile, 256);
  } else if (dtype == 1) {
    if (hd == 64) FLASH_TILE_CASE(flash_tile_sm90, 64);
    else if (hd == 128) FLASH_TILE_CASE(flash_tile_sm90, 128);
    else if (hd == 256) FLASH_TILE_CASE(flash_tile_sm90, 256);
  }
#undef FLASH_TILE_CASE
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace flash_tile
