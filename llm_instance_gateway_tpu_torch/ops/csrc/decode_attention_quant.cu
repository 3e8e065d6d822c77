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
// (decode_tile.cuh): split-S, a block per (KV head, row, split) that loops
// only up to lengths[b], then a combine pass over the splits' f32
// partials.  The only change is the tile fill, which reads 16 int8 values
// per 16-byte load (staged in registers while the previous tile is
// scored) and writes them dequantized, in q's type, into the same
// shared-memory tile — what the TPU kernel does in VMEM before the MXU
// feed.

#include "decode_tile.cuh"

// dtype: 0 = float32, 1 = bfloat16 (q and out).  part: f32 scratch of
// batch * n_heads * ceil(s_max / split_len) * (hd + 2) values.  Launches the
// split kernel and the combine kernel; returns cudaGetLastError() after
// each, or cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int decode_attention_quant_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* lengths, void* out, void* part,
    int batch, int s_max, int n_heads, int n_kv, int hd, int dtype,
    float scale, int split_len, void* stream) {
  return decode_tile::launch_split<false, true>(
      q, k, v, k_scale, v_scale, nullptr, lengths, out, part, batch, s_max,
      1, n_heads, n_kv, hd, dtype, scale, split_len, stream);
}
