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
// 2 * sum_b lengths[b] * K * hd * sizeof(T), at 3.35 TB/s, as for lanes:
// 0.0270 ms at the paged serve's shape (B=8, P=64, M=128, lengths up to
// 8192 summing to 22031, bf16).  The TPU kernel exists to avoid gathering
// a contiguous copy of each row's lane before the read (gather write +
// kernel read, ~2x the bytes); this one does the same, streaming each
// position straight from its pool block.
//
// The design is split-S (decode_tile.cuh, shared with the lane kernel).
// The previous one, one block per (KV head, row), left the block of the
// 8192-long row to walk 128 tiles alone (64 blocks on 132 SMs): 2.09 ms,
// 77x the byte bound and slower than the plain PyTorch version (1.77 ms).
// Now each row is cut into splits of L positions (L a multiple of P and
// of the 64-position tile; 512 at that shape, so the long row runs on 16
// blocks per KV head), each split reads its L / P table entries once into
// shared memory, double buffers its K/V tiles with cp.async, and a
// combine pass merges the splits.
//
// Measured by chip_smoke.py at that shape on an NVIDIA H100 80GB HBM3
// (700 W): 0.0646 ms per call by CUDA events, 0.0580 ms of device time
// (torch.profiler: split 0.0541 + combine 0.0038), 0.42-0.47 of the byte
// bound, 32x faster than before; the plain version took 1.77 ms and
// gather + masked SDPA 0.301.

#include "decode_tile.cuh"

// dtype: 0 = float32, 1 = bfloat16.  part: f32 scratch of
// batch * n_heads * ceil(max_blocks * page / split_len) * (hd + 2) values.
// Launches the split kernel and the combine kernel; returns
// cudaGetLastError() after each, or cudaErrorInvalidValue for a shape the
// kernels do not take.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* lengths, void* out, void* part, int batch, int max_blocks,
    int page, int n_heads, int n_kv, int hd, int dtype, float scale,
    int split_len, void* stream) {
  return decode_tile::launch_split<true, false>(
      q, k_pool, v_pool, nullptr, nullptr, tables, lengths, out, part, batch,
      max_blocks * page, page, n_heads, n_kv, hd, dtype, scale, split_len,
      stream);
}
