// Causal flash attention for prefill on Hopper (sm_90a).
//
// Replaces: llm_instance_gateway_tpu/ops/pallas_attention.py::
//   flash_attention_bhsd (kernels _flash_kernel + _softmax_block), reached
//   through the entry flash_attention.
//
// Takes the model layout directly (no transposes): q/out [B, S, H, hd],
// k/v [B, S, K, hd]; query head h reads KV head h / (H/K); scale 1/sqrt(hd).
// Purely causal, like the TPU kernel: it ignores positions and is exact for
// right-padded batches (pad rows are garbage the caller ignores).  Unlike
// the TPU gate (S % 128 == 0) it takes every S by masking the ragged last
// tile, so every prefill bucket from 16 to 1024 runs here.
//
// Bound on an H100: the causal flops, 2 * B * H * S * (S + 1) * hd (QK^T
// and PV over the lower triangle), at 989 TFLOP/s bf16, or the bytes of
// q, k, v and out at 3.35 TB/s, whichever is larger (at Llama-3-8B heads,
// bytes below S ~ 740 and flops above).
// The design keeps the [S, S] scores out of device memory, as the TPU kernel
// does: one thread block per (64-row query tile, head, row) holds its
// scaled f32 query tile, the online-softmax state and the f32 output
// accumulator on chip while it streams 64-row K/V tiles only up to the
// diagonal (tiles above it are never read); the diagonal tile is masked.
// The products run on CUDA-core FMAs from shared memory, with each thread
// owning a 4x4 score tile and a 4 x hd/16 accumulator tile; moving them to
// wgmma on the tensor cores is later work (this kernel is far from the
// flop bound).
// Numerics match the reference: q * scale in f32, K/V upcast exactly, p
// kept in f32 for the PV product, output acc / max(l, 1e-30).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // key rows per tile (== kBQ: the diagonal is one tile)
constexpr int kThreads = 256;

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
  return __float2bfloat16(x);
}

template <typename T, int HD>
struct Smem {
  static constexpr int QS = HD + 1;   // f32 row stride (padded: no conflicts)
  static constexpr int SS = kBK + 1;  // f32 score row stride
  static constexpr int KS = HD + 2;   // T row stride (padded)
  static constexpr size_t kFloats = (size_t)kBQ * QS + (size_t)kBQ * SS + 3 * kBQ;
  static constexpr size_t bytes =
      kFloats * sizeof(float) + 2 * (size_t)kBK * KS * sizeof(T);
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int seq, int n_heads,
    int n_kv, float scale) {
  using L = Smem<T, HD>;
  constexpr int QS = L::QS, SS = L::SS, KS = L::KS;
  constexpr int DJ = HD / 16;  // accumulator columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // [kBQ][QS]
  float* s_s = q_s + kBQ * QS;                        // [kBQ][SS]
  float* m_s = s_s + kBQ * SS;                        // [kBQ]
  float* l_s = m_s + kBQ;                             // [kBQ]
  float* c_s = l_s + kBQ;                             // [kBQ]
  T* k_s = reinterpret_cast<T*>(c_s + kBQ);          // [kBK][KS]
  T* v_s = k_s + kBK * KS;                            // [kBK][KS]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (n_heads / n_kv);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t q_pos = (size_t)n_heads * HD;  // stride between positions
  const size_t kv_pos = (size_t)n_kv * HD;
  const T* qb = q + (size_t)b * seq * q_pos + (size_t)h * HD;
  const T* kb = k + (size_t)b * seq * kv_pos + (size_t)kh * HD;
  const T* vb = v + (size_t)b * seq * kv_pos + (size_t)kh * HD;
  T* ob = out + (size_t)b * seq * q_pos + (size_t)h * HD;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    float x = 0.f;
    if (q0 + r < seq) x = to_f(qb[(size_t)(q0 + r) * q_pos + d]) * scale;
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

  // Key tiles up to and including the diagonal one.
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kBK;
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int c = i / HD, d = i % HD;
      T kx = from_f<T>(0.f), vx = from_f<T>(0.f);
      if (k0 + c < seq) {
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
      for (int j = 0; j < 4; ++j) kv[j] = to_f(k_s[(tx + 16 * j) * KS + d]);
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
        s_s[r * SS + c] = (k0 + c <= q0 + r) ? sacc[i][j] : kNegInf;
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
        const float vv = to_f(v_s[c * KS + tx + 16 * j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += pv[i] * vv;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r < seq) {
      const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        ob[(size_t)(q0 + r) * q_pos + tx + 16 * j] = from_f<T>(acc[i][j] / l);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int seq, int n_heads, int n_kv, float scale, cudaStream_t stream) {
  const size_t smem = Smem<T, HD>::bytes;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((seq + kBQ - 1) / kBQ, n_heads, batch);
  flash_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), seq, n_heads, n_kv,
      scale);
  return 0;
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* out,
              int batch, int seq, int n_heads, int n_kv, float scale,
              cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, out, batch, seq, n_heads, n_kv, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, out, batch, seq, n_heads, n_kv, scale,
                            stream);
    case 256:
      return launch<T, 256>(q, k, v, out, batch, seq, n_heads, n_kv, scale,
                            stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch, or a CUDA error code for a shape the kernel does not take.
extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, void* out, int batch,
                                    int seq, int n_heads, int n_kv, int hd,
                                    int dtype, float scale, void* stream) {
  if (n_kv <= 0 || n_heads % n_kv != 0 || seq <= 0 || batch > 65535 ||
      n_heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0)
    rc = launch_hd<float>(hd, q, k, v, out, batch, seq, n_heads, n_kv, scale,
                          st);
  else if (dtype == 1)
    rc = launch_hd<__nv_bfloat16>(hd, q, k, v, out, batch, seq, n_heads,
                                  n_kv, scale, st);
  else
    rc = (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
