"""Paged decode attention: Hopper kernel, plain version, wrapper.

Replaces ``llm_instance_gateway_tpu/ops/pallas_decode_attention.py::
paged_decode_attention_pallas`` (kernel ``_paged_kernel`` with
quant=False, entry ``paged_decode_attention``).  The kernel is
``csrc/paged_decode_attention.cu`` (CUDA C++ for ``sm_90a``, device code
shared with the lane kernel through ``csrc/decode_tile.cuh``), split-S as
the lane kernel is: a thread block per (KV head, row, split) reads its
split's ``tables[b, m]`` entries once and streams those physical blocks of
the pool only up to ``lengths[b]`` — never a gathered copy of the lane,
which is what the TPU kernel exists to avoid — and a combine pass merges
a row's splits.  ``split_plan`` sizes the splits in whole pool blocks.
Its bound on an H100 is the K/V bytes the lengths cover,
``2 * sum(lengths) * K * hd * itemsize``, at 3.35 TB/s.

``paged_decode_attention`` dispatches on the tensors' device only: CPU
tensors take ``paged_decode_attention_reference`` (the plain version: the
pool->lane gather, then the lane kernel's plain version), CUDA tensors
launch the kernel or raise.  ``launches`` counts kernel launches (one per
call: the split and combine kernels go out together).

Given scale pools (an int8 pool, the Pallas kernel's quant=True variant),
it takes ``csrc/paged_decode_attention_quant.cu`` instead: the same split
kernel and combine pass with the int8 lane variant's dequantizing tile,
the scales read through the same table, ``2 * sum(lengths) * K * (hd +
4)`` bytes.
Its plain version is gather, dequantize (the Pallas kernel's rounding),
then the lane plain version.  ``quant_launches`` counts its launches.  Any
block size that is a multiple of 16 is taken for int8 too: the TPU's
32-row int8 floor is a TPU tiling rule.
"""

from __future__ import annotations

import math

import torch

from llm_instance_gateway_tpu_torch.ops import _build
from llm_instance_gateway_tpu_torch.ops.attention import gather_pool_rows
from llm_instance_gateway_tpu_torch.ops.decode_attention import (
    MAX_GROUP,
    SUPPORTED_HEAD_DIMS,
    _check_scales,
    decode_attention_quant_reference,
    decode_attention_reference,
    sm_count,
    split_plan,
    split_scratch,
    tile_positions,
)

PAGE_MULTIPLE = 16  # block sizes the pool takes, bf16/f32 and int8 alike
MAX_SPLIT_BLOCKS = 1024  # table entries one split holds in shared memory
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the count was last reset (plain ints, host side):
# the bf16/f32 pool kernel and the int8 scale-pool kernel.
launches = 0
quant_launches = 0


def paged_decode_attention_reference(q: torch.Tensor, k_pool: torch.Tensor,
                                     v_pool: torch.Tensor,
                                     tables: torch.Tensor,
                                     lengths: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: each row's blocks gathered
    into its lane view, then the lane kernel's plain version (f32 logits,
    p cast to the value dtype before PV, length-0 rows give zeros)."""
    return decode_attention_reference(
        q, gather_pool_rows(k_pool, tables), gather_pool_rows(v_pool, tables),
        lengths)


def paged_decode_attention_quant_reference(
        q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
        tables: torch.Tensor, lengths: torch.Tensor, k_scale: torch.Tensor,
        v_scale: torch.Tensor) -> torch.Tensor:
    """The int8 kernel's function in plain PyTorch: int8 pools and their
    f32 scale pools gathered through the tables into lane views, then the
    int8 lane plain version (dequantize to q's dtype, f32 multiply, one
    rounding)."""
    return decode_attention_quant_reference(
        q, *(gather_pool_rows(p, tables)
             for p in (k_pool, v_pool, k_scale, v_scale)), lengths)


def _check(q, k_pool, v_pool, tables, lengths, kv_dtype=None) -> None:
    if (q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape
            or tables.dim() != 2):
        raise ValueError("paged_decode_attention: q [B,H,hd], pools "
                         "[n_blocks+1,P,K,hd], tables [B,M] expected, got "
                         f"{tuple(q.shape)}, {tuple(k_pool.shape)}, "
                         f"{tuple(tables.shape)}")
    b, h, hd = q.shape
    _, page, n_kv, khd = k_pool.shape
    if tables.shape[0] != b or khd != hd or h % n_kv:
        raise ValueError("paged_decode_attention: q, pools and tables "
                         "disagree on B, hd or the head grouping")
    if page % PAGE_MULTIPLE:
        raise ValueError(f"paged_decode_attention: block size {page} is not "
                         f"a multiple of {PAGE_MULTIPLE}")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"paged_decode_attention: head_dim {hd} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if h // n_kv > MAX_GROUP or b > 65535:
        raise ValueError(f"paged_decode_attention: {h // n_kv} query heads "
                         f"per KV head (max {MAX_GROUP}) or batch {b} too "
                         "large")
    kv_dtype = q.dtype if kv_dtype is None else kv_dtype
    if (q.dtype not in _DTYPES or k_pool.dtype != kv_dtype
            or v_pool.dtype != kv_dtype):
        raise ValueError(f"paged_decode_attention: dtype {q.dtype} / pool "
                         f"{k_pool.dtype} (q float32 or bfloat16; the pools "
                         f"{'int8' if kv_dtype == torch.int8 else 'alike'})")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32 \
            or lengths.shape != (b,):
        raise ValueError("paged_decode_attention: tables int32 [B,M] and "
                         "lengths int32 [B] expected")
    for t in (q, k_pool, v_pool, tables, lengths):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("paged_decode_attention: inputs must be "
                             "contiguous on one device")
    for t in (k_pool, v_pool):
        if t.data_ptr() % 16:
            raise ValueError("paged_decode_attention: the pools must be "
                             "16-byte aligned (the kernel loads 16-byte "
                             "vectors)")


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, tables: torch.Tensor,
                           lengths: torch.Tensor,
                           k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Cached single-token attention read through block tables; with
    ``k_scale``/``v_scale`` (f32 [n_blocks+1, P, K]) the pools are int8.

    CPU tensors: the plain version.  CUDA tensors: the Hopper kernel, or
    ``ValueError`` for a shape it does not take."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("paged_decode_attention: give both scale pools")
    if q.device.type == "cpu":
        if k_scale is not None:
            return paged_decode_attention_quant_reference(
                q, k_pool, v_pool, tables, lengths, k_scale, v_scale)
        return paged_decode_attention_reference(q, k_pool, v_pool, tables,
                                                lengths)
    if q.device.type != "cuda":
        raise ValueError(
            f"paged_decode_attention: unsupported device {q.device}")
    return paged_decode_attention_split(q, k_pool, v_pool, tables, lengths,
                                        k_scale=k_scale, v_scale=v_scale)


def paged_decode_attention_split(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, tables: torch.Tensor,
                                 lengths: torch.Tensor,
                                 split_len: int | None = None,
                                 k_scale: torch.Tensor | None = None,
                                 v_scale: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """The pool kernel on CUDA tensors (int8 pools given scale pools): the
    split kernel, then the combine kernel, from one C call.  ``split_len``
    (a multiple of the block size and of ``tile_positions``) defaults to
    ``split_plan``'s; another one serves to measure the plan."""
    global launches, quant_launches
    if (k_scale is None) != (v_scale is None):
        raise ValueError("paged_decode_attention: give both scale pools")
    quant = k_scale is not None
    _check(q, k_pool, v_pool, tables, lengths,
           kv_dtype=torch.int8 if quant else None)
    if quant:
        _check_scales(k_pool, k_scale, v_scale, "paged_decode_attention")
    b, h, hd = q.shape
    page, n_kv = k_pool.shape[1], k_pool.shape[2]
    s_max = tables.shape[1] * page
    tile = tile_positions(hd, q.dtype)
    if split_len is None and s_max >= 1:
        split_len = split_plan(b, n_kv, s_max, tile, sm_count(q.device),
                               page)[0]
    if (s_max < 1 or split_len < 1 or split_len % math.lcm(tile, page)
            or split_len // page > MAX_SPLIT_BLOCKS):
        raise ValueError(f"paged_decode_attention: tables [B, M>=1] expected "
                         f"and split_len {split_len} a positive multiple of "
                         f"{math.lcm(tile, page)} of at most "
                         f"{MAX_SPLIT_BLOCKS} blocks")
    out = torch.empty_like(q)
    part = split_scratch(b, h, hd, -(-s_max // split_len), q.device)
    name = ("paged_decode_attention_quant" if quant
            else "paged_decode_attention")
    ptrs = [q, k_pool, v_pool] + ([k_scale, v_scale] if quant else []) \
        + [tables, lengths, out, part]
    fn = getattr(_build.load(name), f"{name}_launch")
    rc = fn(*(t.data_ptr() for t in ptrs), b, tables.shape[1], page, h, n_kv,
            hd, _DTYPES[q.dtype], 1.0 / math.sqrt(hd), split_len,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, name)
    if quant:
        quant_launches += 1
    else:
        launches += 1
    return out
