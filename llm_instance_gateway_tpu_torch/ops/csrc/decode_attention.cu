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
// 2 flops per byte; the tensor cores are never the limit): 0.00446 ms at
// the lane serve's shape (B=8, S_max=1024, K=8, hd 128, bf16, lengths
// summing to 3619).  The design is split-S (decode_tile.cuh, shared with
// the paged kernel): each row's positions are cut into splits that run as
// blocks of their own, up to lengths[b] only — the skipping the TPU
// kernel's DMA clamp buys — and a combine pass merges the splits'
// partial softmaxes.  Inside a split, K/V tiles are double buffered with
// cp.async and shared among the H/K query heads of the group.  The
// previous design, one block per (KV head, row) walking the row alone
// (64 blocks on 132 SMs at B=8), took 0.261 ms there.
//
// Measured by chip_smoke.py at that shape on an NVIDIA H100 80GB HBM3
// (700 W): 0.0186 ms of device time per call (torch.profiler: split 0.0155
// + combine 0.0031), 0.24 of the bound, with 8 splits of 128 positions;
// CUDA events over back-to-back calls read 0.053 ms, the host's cost of a
// call (wrapper and two launches), against 0.10 for masked SDPA.

#include "decode_tile.cuh"

// dtype: 0 = float32, 1 = bfloat16.  part: f32 scratch of
// batch * n_heads * ceil(s_max / split_len) * (hd + 2) values.  Launches the
// split kernel and the combine kernel; returns cudaGetLastError() after
// each, or cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, void* part, int batch,
                                       int s_max, int n_heads, int n_kv,
                                       int hd, int dtype, float scale,
                                       int split_len, void* stream) {
  return decode_tile::launch_split<false, false>(
      q, k, v, nullptr, nullptr, nullptr, lengths, out, part, batch, s_max,
      1, n_heads, n_kv, hd, dtype, scale, split_len, stream);
}
