// Lane decode attention for Hopper (sm_90a): one query token per row
// against that row's contiguous cache lane.
//
// Replaces: llm_instance_gateway_tpu/ops/pallas_decode_attention.py::
//   decode_attention_pallas (kernel _decode_kernel, quant=False).
//
// q [B, H, hd], k/v [B, S_max, K, hd] (the cache lane layout, one layer),
// lengths [B] int32, out [B, H, hd].  Only positions < lengths[b] count;
// a row of length 0 writes zeros.  Query head h reads KV head h / (H/K).
//
// Bound on an H100: the bytes of K and V actually read,
// 2 * sum_b lengths[b] * K * hd * sizeof(T), at 3.35 TB/s (decode does
// 2 flops per byte; the tensor cores are never the limit).  The design
// meets it the way the TPU kernel's DMA clamp does:
//   - one thread block per (KV head, row); the block loops over S in tiles
//     only up to lengths[b], so a short row in a long lane reads only its
//     own prefix, never S_max;
//   - each K/V tile is read from device memory once, with 16-byte loads,
//     into shared memory, and shared by the G = H/K query heads of the
//     group;
//   - the online-softmax state (m, l) and the f32 accumulator stay on chip
//     (shared memory and registers) for the whole sweep.
// Matches the reference numerics: f32 logits and accumulator, p rounded to
// the value dtype before the PV product (p.astype(v.dtype)), l summed from
// the unrounded p, output acc / max(l, 1e-30).
// Known gap: at Llama-3-8B decode (B=8, K=8) the grid is 64 blocks on 132
// SMs, and each block walks its tiles in order; splitting S across blocks
// (a second reduction pass) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ lengths,
    T* __restrict__ out, int s_max, int n_heads, int n_kv, float scale) {
  // Tile rows: K + V tiles take 32 KB of shared memory.
  constexpr int TS = 16384 / (HD * (int)sizeof(T));
  constexpr int VEC = 16 / (int)sizeof(T);  // elements per 16-byte load
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
  const T* kb = k + (size_t)b * s_max * pos_stride + (size_t)kh * HD;
  const T* vb = v + (size_t)b * s_max * pos_stride + (size_t)kh * HD;
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += TS) {
    const int n = min(TS, len - t0);
    for (int i = tid; i < n * VPR; i += kThreads) {
      const int t = i / VPR, c = i % VPR;
      const size_t off = (size_t)(t0 + t) * pos_stride;
      reinterpret_cast<uint4*>(&k_s[t][0])[c] =
          reinterpret_cast<const uint4*>(kb + off)[c];
      reinterpret_cast<uint4*>(&v_s[t][0])[c] =
          reinterpret_cast<const uint4*>(vb + off)[c];
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

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, const void* lengths,
            void* out, int batch, int s_max, int n_heads, int n_kv,
            float scale, cudaStream_t stream) {
  decode_kernel<T, HD><<<dim3(n_kv, batch), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(out), s_max, n_heads, n_kv, scale);
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              const void* lengths, void* out, int batch, int s_max,
              int n_heads, int n_kv, float scale, cudaStream_t stream) {
  switch (hd) {
    case 64:
      launch<T, 64>(q, k, v, lengths, out, batch, s_max, n_heads, n_kv,
                    scale, stream);
      return 0;
    case 128:
      launch<T, 128>(q, k, v, lengths, out, batch, s_max, n_heads, n_kv,
                     scale, stream);
      return 0;
    case 256:
      launch<T, 256>(q, k, v, lengths, out, batch, s_max, n_heads, n_kv,
                     scale, stream);
      return 0;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, int batch, int s_max,
                                       int n_heads, int n_kv, int hd,
                                       int dtype, float scale, void* stream) {
  if (n_kv <= 0 || n_heads % n_kv != 0 || n_heads / n_kv > kGMax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0)
    rc = launch_hd<float>(hd, q, k, v, lengths, out, batch, s_max, n_heads,
                          n_kv, scale, st);
  else if (dtype == 1)
    rc = launch_hd<__nv_bfloat16>(hd, q, k, v, lengths, out, batch, s_max,
                                  n_heads, n_kv, scale, st);
  else
    rc = (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
