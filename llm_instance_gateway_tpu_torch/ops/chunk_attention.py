"""Chunk attention for chunk-stream and prefix-hit prefill: Hopper kernel,
plain version, wrapper.

Replaces ``llm_instance_gateway_tpu/ops/pallas_attention.py::
chunk_attention_pallas`` (kernel ``_chunk_kernel``, entry
``chunk_attention``).  The kernel is ``csrc/chunk_attention.cu`` (CUDA C++
for ``sm_90a``), on the flash prefill kernel's device code: bf16 on the
tensor cores (``csrc/flash_tile_sm90.cuh``: 128-row query tiles, K/V tiles
by TMA through a two-stage ring, QK^T and PV as ``wgmma``, online f32
softmax in registers), f32 on CUDA-core FMAs (``csrc/flash_tile.cuh``).
Each block requests K/V tiles only up to ``min(start + its last row,
S_max - 1)``, so reads track the prompt's progress, not S_max, and a final
chunk's pad queries past S_max never read past the lane.  Its bound on an
H100 is the operations ``4 * H * hd * C * (start + (C + 1) / 2)`` at
989 TFLOP/s (bf16).  The bf16 kernel rounds P to bf16 before PV, its one
departure from the TPU kernel (``tests/test_torch_flash_numerics.py``).

``start`` is a host ``int``.  ``chunk_attention`` dispatches on the
tensors' device only: CPU tensors take ``chunk_attention_reference`` (the
plain version), CUDA tensors launch the kernel or raise.  ``launches``
counts kernel launches.
"""

from __future__ import annotations

import math

import torch

from llm_instance_gateway_tpu_torch.ops import _build

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the count was last reset (plain int, host side).
launches = 0


def chunk_attention_reference(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor,
                              start: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: q [B, C, H, hd] at global
    positions start..start+C-1 against k/v [B, S_max, K, hd]; token i
    attends positions <= start+i.  Same numerics as the TPU kernel: q *
    scale in f32, K/V upcast, f32 softmax, f32 PV, output in q's dtype."""
    b, c, h, hd = q.shape
    s_max, n_kv = k_cache.shape[1], k_cache.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qg = q.float().reshape(b, c, n_kv, h // n_kv, hd) * scale
    logits = torch.einsum("bikgh,bjkh->bkgij", qg, k_cache.float())
    q_pos = int(start) + torch.arange(c, device=q.device)
    live = torch.arange(s_max, device=q.device)[None, :] <= q_pos[:, None]
    logits = torch.where(live, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgij,bjkh->bikgh", probs, v_cache.float())
    return out.reshape(b, c, h, hd).to(q.dtype)


def _check(q, k_cache, v_cache, start) -> None:
    if q.dim() != 4 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError("chunk_attention: q [B,C,H,hd], k/v [B,S_max,K,hd] "
                         f"expected, got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, c, h, hd = q.shape
    kb, s_max, n_kv, khd = k_cache.shape
    if kb != b or khd != hd or h % n_kv:
        raise ValueError("chunk_attention: q and the lane disagree on B, hd "
                         "or the head grouping")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"chunk_attention: head_dim {hd} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if not 0 <= start < 2 ** 31 - c or b > 65535 or h > 65535:
        raise ValueError(f"chunk_attention: start {start}, batch {b} or "
                         f"{h} heads out of range")
    if (q.dtype not in _DTYPES or k_cache.dtype != q.dtype
            or v_cache.dtype != q.dtype):
        raise ValueError(f"chunk_attention: dtype {q.dtype} (float32 or "
                         "bfloat16, all three alike)")
    for t in (q, k_cache, v_cache):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("chunk_attention: q, k, v must be contiguous "
                             "on one device")


def chunk_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, start: int) -> torch.Tensor:
    """Chunk-vs-lane attention: token i of the chunk (global position
    ``start`` + i) attends lane positions <= start + i.

    CPU tensors: the plain version.  CUDA tensors: the Hopper kernel, or
    ``ValueError`` for a shape it does not take."""
    global launches
    start = int(start)
    if q.device.type == "cpu":
        return chunk_attention_reference(q, k_cache, v_cache, start)
    if q.device.type != "cuda":
        raise ValueError(f"chunk_attention: unsupported device {q.device}")
    _check(q, k_cache, v_cache, start)
    b, c, h, hd = q.shape
    out = torch.empty_like(q)
    fn = _build.load("chunk_attention").chunk_attention_launch
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), b, c, k_cache.shape[1], start, h,
            k_cache.shape[2], hd, _DTYPES[q.dtype], 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "chunk_attention")
    launches += 1
    return out
