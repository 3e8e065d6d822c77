// int8 paged decode attention for Hopper (sm_90a): one query token per row
// against that row's K/V in an int8 block pool, read through its table,
// with the scales read through the same table.
//
// Replaces: llm_instance_gateway_tpu/ops/pallas_decode_attention.py::
//   paged_decode_attention_pallas with k_scale/v_scale (kernel
//   _paged_kernel, quant=True), reached from paged.decode_step_paged on an
//   int8 pool.
//
// q [B, H, hd] (f32 or bf16), pools k/v [n_blocks + 1, P, K, hd] int8,
// scale pools k_scale/v_scale [n_blocks + 1, P, K] f32, tables [B, M]
// int32, lengths [B] int32, out [B, H, hd] in q's type.  Physical block 0
// is the trash block; a length-0 row gives zeros.  P is any multiple of 16
// (the TPU's 32-row int8 floor is its own tiling rule).
//
// Bound on an H100: 2 * sum_b lengths[b] * K * (hd * 1 + 4) bytes at
// 3.35 TB/s.  Design: the bf16 paged kernel's (decode_tile.cuh) — split-S,
// each block (KV head, row, split) reads its split's table entries once
// and streams those physical blocks straight from the pool, only up to
// lengths[b], then a combine pass merges a row's splits — with the int8
// tile fill: one scale per (position, head), read through the same table,
// values dequantized into the shared tile in q's type.  split_len is a
// multiple of both the tile (in q's type) and P.

#include "decode_tile.cuh"

// dtype: 0 = float32, 1 = bfloat16 (q and out).  part: f32 scratch of
// batch * n_heads * ceil(max_blocks * page / split_len) * (hd + 2) values.
// Launches the split kernel and the combine kernel; returns
// cudaGetLastError() after each, or cudaErrorInvalidValue for a shape the
// kernels do not take.
extern "C" int paged_decode_attention_quant_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* lengths, void* out, void* part, int batch, int max_blocks,
    int page, int n_heads, int n_kv, int hd, int dtype, float scale,
    int split_len, void* stream) {
  return decode_tile::launch_split<true, true>(
      q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out, part, batch,
      max_blocks * page, page, n_heads, n_kv, hd, dtype, scale, split_len,
      stream);
}
