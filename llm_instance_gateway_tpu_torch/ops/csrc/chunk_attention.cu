// Chunk attention for chunk-stream and prefix-hit prefill on Hopper (sm_90a).
//
// Replaces: llm_instance_gateway_tpu/ops/pallas_attention.py::
//   chunk_attention_pallas (kernel _chunk_kernel over the shared
//   _softmax_block), reached through the entry chunk_attention from
//   transformer._chunk_attend.
//
// q/out [B, C, H, hd] (a chunk of C queries at global positions start..
// start+C-1), k/v [B, S_max, K, hd] (one lane view, the chunk's own K/V
// already written).  Chunk token i attends positions <= start + i; a final
// chunk's pad queries, whose positions run past S_max, attend the whole
// lane and never read past it.  start is a host int: the engine holds
// positions in numpy, so no device value steers the launch.
//
// Bound on an H100: the operations, 4 * H * hd * C * (start + (C + 1) / 2)
// for QK^T and PV over the live triangle-plus-rectangle, at 989 TFLOP/s
// bf16 (at C = 1024, start = 5120, H = 32, hd = 128: 9.45e10 operations,
// 0.096 ms); the K/V it must read there, 6144 positions x 8 heads x 128
// x 2 x 2 bytes = 25 MB, take 0.0075 ms at 3.35 TB/s.
// The design does what the TPU kernel's index-map clamp does: each block
// requests K/V tiles only up to min(start + its last row, S_max - 1), so
// the reads track the prompt's progress and not S_max, and the [C, S_max]
// scores never reach device memory.  bf16 runs on the tensor cores
// (flash_tile_sm90.cuh, shared with the flash prefill kernel: K/V tiles by
// TMA through a two-stage ring, QK^T and PV as wgmma); f32 on CUDA-core
// FMAs (flash_tile.cuh).  It takes every C (16..1024 on prefix hits, 1024
// for stream chunks) and every S_max, masking ragged tiles: on the card
// there is no XLA fallback.

#include "flash_tile.cuh"

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch, or a CUDA error code for a shape the kernel does not take.
extern "C" int chunk_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int batch,
                                      int chunk, int s_max, int start,
                                      int n_heads, int n_kv, int hd,
                                      int dtype, float scale, void* stream) {
  return flash_tile::launch_by_dtype(q, k, v, out, batch, chunk, s_max,
                                     start, n_heads, n_kv, hd, dtype, scale,
                                     stream);
}
