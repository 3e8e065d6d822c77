"""Lane decode attention: Hopper kernel, plain version, wrapper.

Replaces ``llm_instance_gateway_tpu/ops/pallas_decode_attention.py::
decode_attention_pallas`` (kernel ``_decode_kernel`` with quant=False, entry
``decode_attention``).  The kernel is ``csrc/decode_attention.cu`` (CUDA C++
for ``sm_90a``): one thread block per (KV head, row) walks that row's cache
lane in shared-memory tiles only up to ``lengths[b]`` — the same skipping
the TPU kernel's DMA clamp buys — and shares each K/V tile among the H/K
query heads of the group.  Its bound on an H100 is the K/V bytes actually
read, ``2 * sum(lengths) * K * hd * itemsize``, at 3.35 TB/s.

``decode_attention`` dispatches on the tensors' device only: CPU tensors
take ``decode_attention_reference`` (the plain version), CUDA tensors
launch the kernel or raise.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from llm_instance_gateway_tpu_torch.ops import _build

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 8  # query heads per KV head the kernel's shared memory holds
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the count was last reset (plain int, host side).
launches = 0


def decode_attention_reference(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor,
                               lengths: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: q [B, H, hd] against
    k/v [B, S_max, K, hd], positions < lengths[b] only; f32 logits, p cast
    to the value dtype before the PV product, l from the unrounded p; rows
    of length 0 give zeros."""
    b, s_max, n_kv, hd = k_cache.shape
    h = q.shape[1]
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, n_kv, h // n_kv, hd).float()
    logits = torch.einsum("bkgh,bskh->bkgs", qg, k_cache.float()) * scale
    lengths = lengths.to(device=q.device, dtype=torch.int64)
    live = torch.arange(s_max, device=q.device)[None] < lengths[:, None]
    logits = torch.where(live[:, None, None], logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    p = torch.where(live[:, None, None], p, 0.0)  # length-0 rows: all zero
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bkgs,bskh->bkgh", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return (acc / denom).reshape(b, h, hd).to(q.dtype)


def _check(q, k_cache, v_cache, lengths) -> None:
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError("decode_attention: q [B,H,hd], k/v [B,S_max,K,hd] "
                         f"expected, got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}")
    b, h, hd = q.shape
    kb, _, n_kv, khd = k_cache.shape
    if kb != b or khd != hd or h % n_kv:
        raise ValueError("decode_attention: q and the cache disagree on B, "
                         "hd or the head grouping")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {hd} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if h // n_kv > MAX_GROUP or b > 65535:
        raise ValueError(f"decode_attention: {h // n_kv} query heads per KV "
                         f"head (max {MAX_GROUP}) or batch {b} too large")
    if (q.dtype not in _DTYPES or k_cache.dtype != q.dtype
            or v_cache.dtype != q.dtype):
        raise ValueError(f"decode_attention: dtype {q.dtype} (float32 or "
                         "bfloat16, all three alike)")
    if lengths.dtype != torch.int32 or lengths.shape != (b,):
        raise ValueError("decode_attention: lengths must be int32 [B]")
    for t in (q, k_cache, v_cache, lengths):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("decode_attention: inputs must be contiguous "
                             "on one device")
    for t in (k_cache, v_cache):
        if t.data_ptr() % 16:
            raise ValueError("decode_attention: the cache must be 16-byte "
                             "aligned (the kernel loads 16-byte vectors)")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Cached single-token attention over contiguous lanes.

    CPU tensors: the plain version.  CUDA tensors: the Hopper kernel, or
    ``ValueError`` for a shape it does not take."""
    global launches
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    _check(q, k_cache, v_cache, lengths)
    b, h, hd = q.shape
    out = torch.empty_like(q)
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), b, k_cache.shape[1], h,
            k_cache.shape[2], hd, _DTYPES[q.dtype], 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "decode_attention")
    launches += 1
    return out
