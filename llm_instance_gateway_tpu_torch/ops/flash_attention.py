"""Causal flash attention for prefill: Hopper kernel, plain version, wrapper.

Replaces ``llm_instance_gateway_tpu/ops/pallas_attention.py::
flash_attention_bhsd`` (and its entry ``flash_attention``).  The kernel is
``csrc/flash_prefill.cu`` (CUDA C++ for ``sm_90a``).  bf16 runs on the
tensor cores (``csrc/flash_tile_sm90.cuh``): one block per (128-row query
tile, head, row), a producer warpgroup loading K/V tiles by TMA through a
two-stage shared-memory ring, two consumer warpgroups running QK^T and PV
as ``wgmma`` with the online f32 softmax in registers, tiles above the
diagonal never loaded.  f32 runs on CUDA-core FMAs (``csrc/flash_tile.cuh``),
which keeps the card's f32 checks at summation-order agreement.  Either
way the [S, S] scores never reach device memory.  Its bound on an H100 is
the causal flops ``2*B*H*S*(S+1)*hd`` at 989 TFLOP/s (bf16) or its bytes
at 3.35 TB/s, whichever is larger.  The bf16 kernel rounds P to bf16 before
PV (a relative 2^-9 per probability), its one departure from the TPU
kernel; ``tests/test_torch_flash_numerics.py`` shows it within the card
checks' limit.

``flash_attention`` dispatches on the tensors' device only: a CPU tensor
takes ``flash_attention_reference`` (the plain version, used by the CPU
tests), a CUDA tensor launches the kernel or raises — there is no fallback
to the plain version or to a library kernel on the card.  ``launches``
counts kernel launches, so a run can show the serving path went through
the kernel.
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


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: causal GQA attention,
    q [B, S, H, hd], k/v [B, S, K, hd] -> [B, S, H, hd].  Same numerics as
    the TPU kernel: q * scale in f32, K/V upcast, f32 softmax, f32 PV,
    output cast to q's dtype."""
    b, s, h, hd = q.shape
    n_kv = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qg = q.float().reshape(b, s, n_kv, h // n_kv, hd) * scale
    logits = torch.einsum("bikgh,bjkh->bkgij", qg, k.float())
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    logits = torch.where(causal, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgij,bjkh->bikgh", probs, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention: q [B,S,H,hd], k/v [B,S,K,hd] "
                         f"expected, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, hd = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != hd:
        raise ValueError("flash_attention: q and k/v disagree on B, S or hd")
    if h % k.shape[2]:
        raise ValueError(f"flash_attention: {h} heads over {k.shape[2]} "
                         "KV heads")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if h // k.shape[2] > 65535 or b > 65535 or h > 65535:
        raise ValueError("flash_attention: grid too large")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtype {q.dtype} (float32 or "
                         "bfloat16, all three alike)")
    for t in (q, k, v):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("flash_attention: q, k, v must be contiguous "
                             "on one device")


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Causal prefill attention in the model layout (right-padded batches).

    CPU tensors: the plain version.  CUDA tensors: the Hopper kernel, or
    ``ValueError`` for a shape it does not take."""
    global launches
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v)
    b, s, h, hd = q.shape
    out = torch.empty_like(q)
    fn = _build.load("flash_prefill").flash_prefill_launch
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, h, k.shape[2], hd, _DTYPES[q.dtype], 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_prefill")
    launches += 1
    return out
