// Causal flash attention for prefill on Hopper (sm_90a).
//
// Replaces: llm_instance_gateway_tpu/ops/pallas_attention.py::
//   flash_attention_bhsd (kernels _flash_kernel + _softmax_block), reached
//   through the entry flash_attention.
//
// Takes the model layout directly (no transposes): q/out [B, S, H, hd],
// k/v [B, S, K, hd].  Purely causal, like the TPU kernel: it ignores
// positions and is exact for right-padded batches (pad rows are garbage
// the caller ignores).  Unlike the TPU gate (S % 128 == 0) it takes every
// S by masking the ragged last tile, so every prefill bucket from 16 to
// 1024 runs here.
//
// Bound on an H100: the causal flops, 2 * B * H * S * (S + 1) * hd (QK^T
// and PV over the lower triangle), at 989 TFLOP/s bf16, or the bytes of
// q, k, v and out at 3.35 TB/s, whichever is larger (at Llama-3-8B heads,
// bytes below S ~ 740 and flops above).
// The design keeps the [S, S] scores out of device memory, as the TPU kernel
// does: this is the chunk kernel at start 0 over the prompt's own K/V, so
// each block streams K/V tiles only up to the diagonal (tiles above it are
// never read) with the online-softmax state and f32 accumulator on chip.
// bf16 runs on the tensor cores (flash_tile_sm90.cuh: TMA ring, wgmma for
// QK^T and PV, 128-row query tiles, longest tiles launched first); f32 on
// CUDA-core FMAs (flash_tile.cuh).

#include "flash_tile.cuh"

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch, or a CUDA error code for a shape the kernel does not take.
extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, void* out, int batch,
                                    int seq, int n_heads, int n_kv, int hd,
                                    int dtype, float scale, void* stream) {
  return flash_tile::launch_by_dtype(q, k, v, out, batch, seq, seq, 0,
                                     n_heads, n_kv, hd, dtype, scale, stream);
}
