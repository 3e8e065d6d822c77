// Lane decode attention for Hopper (sm_90a): one query token per row
// against that row's contiguous cache lane.
//
// Replaces: llm_instance_gateway_tpu/ops/pallas_decode_attention.py::
//   decode_attention_pallas (kernel _decode_kernel, quant=False).
//
// q [B, H, hd], k/v [B, S_max, K, hd] (the cache lane layout, one layer),
// lengths [B] int32, out [B, H, hd].
//
// Bound on an H100: the bytes of K and V actually read,
// 2 * sum_b lengths[b] * K * hd * sizeof(T), at 3.35 TB/s (decode does
// 2 flops per byte; the tensor cores are never the limit).  The design
// (decode_tile.cuh, shared with the paged kernel) meets it the way the TPU
// kernel's DMA clamp does: one block per (KV head, row) loops only up to
// lengths[b], reads each K/V tile once with 16-byte loads into shared
// memory and shares it among the H/K query heads of the group.
// Known gap: at Llama-3-8B decode (B=8, K=8) the grid is 64 blocks on 132
// SMs, and each block walks its tiles in order; splitting S across blocks
// (a second reduction pass) is later work.

#include "decode_tile.cuh"

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, int batch, int s_max,
                                       int n_heads, int n_kv, int hd,
                                       int dtype, float scale, void* stream) {
  return decode_tile::launch_any<false, false>(
      q, k, v, nullptr, nullptr, nullptr, lengths, out, batch, s_max, 1,
      n_heads, n_kv, hd, dtype, scale, stream);
}
