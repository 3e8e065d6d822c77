// Paged decode attention for Hopper (sm_90a): one query token per row
// against that row's K/V in a shared block pool, read through its table.
//
// Replaces: llm_instance_gateway_tpu/ops/pallas_decode_attention.py::
//   paged_decode_attention_pallas (kernel _paged_kernel, quant=False),
//   reached through the entry paged_decode_attention from
//   paged.decode_step_paged.  The int8 scale-pool variant is
//   paged_decode_attention_quant.cu.
//
// q [B, H, hd], pools k/v [n_blocks + 1, P, K, hd] (one layer; physical
// block 0 is the trash block), tables [B, M] int32, lengths [B] int32,
// out [B, H, hd].  Logical block m of row b is physical block
// tables[b, m]; positions < lengths[b] count, a length-0 row gives zeros.
//
// Bound on an H100: the bytes of K and V the rows' lengths cover,
// 2 * sum_b lengths[b] * K * hd * sizeof(T), at 3.35 TB/s, as for lanes.
// The TPU kernel exists to avoid gathering a contiguous copy of each
// row's lane before the read (gather write + kernel read, ~2x the bytes);
// this one does the same: each block (KV head, row) looks up tables[b, m]
// for the positions of its tile and streams them straight from the pool
// block, only up to lengths[b] (decode_tile.cuh, shared with the lane
// kernel).  The table lookups are 4 bytes per position, through the
// read-only cache.
//
// The grid is its limit: at B=8 it is 64 blocks on 132 SMs, and the
// block of the longest row walks it alone.  chip_smoke.py measured
// 2.09 ms at B=8 with rows up to 8192 positions on an H100 80GB HBM3
// (700 W), 77x the byte bound and slower than the plain PyTorch version
// (1.77 ms).  Splitting each row's positions across blocks, with a
// combine pass, is the planned fix.

#include "decode_tile.cuh"

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* lengths, void* out, int batch, int max_blocks, int page,
    int n_heads, int n_kv, int hd, int dtype, float scale, void* stream) {
  return decode_tile::launch_any<true, false>(
      q, k_pool, v_pool, nullptr, nullptr, tables, lengths, out, batch,
      max_blocks * page, page, n_heads, n_kv, hd, dtype, scale, stream);
}
