// int8 lane decode attention for Hopper (sm_90a): one query token per row
// against that row's int8 cache lane, dequantized in shared memory.
//
// Replaces: llm_instance_gateway_tpu/ops/pallas_decode_attention.py::
//   decode_attention_quant_pallas (kernel _decode_kernel, quant=True).
//
// q [B, H, hd] (f32 or bf16), k/v [B, S_max, K, hd] int8, k_scale/v_scale
// [B, S_max, K] f32 (one scale per position and KV head), lengths [B]
// int32, out [B, H, hd] in q's type.
//
// Bound on an H100: the bytes the rows' lengths cover,
// 2 * sum_b lengths[b] * K * (hd * 1 + 4) bytes (int8 values plus their
// scales), at 3.35 TB/s.  The design is the bf16 lane kernel's
// (decode_tile.cuh): one block per (KV head, row) loops only up to
// lengths[b]; the only change is the tile fill, which reads 16 int8 values
// per 16-byte load and writes them dequantized, in q's type, into the same
// shared-memory tile — what the TPU kernel does in VMEM before the MXU
// feed.  Known gap, as for bf16: at B=8, K=8 the grid is 64 blocks on 132
// SMs and each walks its row serially, so halving the bytes moves the time
// little until S is split across blocks.

#include "decode_tile.cuh"

// dtype: 0 = float32, 1 = bfloat16 (q and out).  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a shape the kernel does
// not take.
extern "C" int decode_attention_quant_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* lengths, void* out, int batch,
    int s_max, int n_heads, int n_kv, int hd, int dtype, float scale,
    void* stream) {
  return decode_tile::launch_any<false, true>(
      q, k, v, k_scale, v_scale, nullptr, lengths, out, batch, s_max, 1,
      n_heads, n_kv, hd, dtype, scale, stream);
}
