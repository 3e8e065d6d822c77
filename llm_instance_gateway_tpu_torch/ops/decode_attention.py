"""Lane decode attention: Hopper kernel, plain version, wrapper.

Replaces ``llm_instance_gateway_tpu/ops/pallas_decode_attention.py::
decode_attention_pallas`` (kernel ``_decode_kernel`` with quant=False, entry
``decode_attention``).  The kernel is ``csrc/decode_attention.cu`` (CUDA C++
for ``sm_90a``), split-S: each row's positions are cut into splits of
``split_len`` positions (``split_plan``), each split is a thread block per
(KV head, row, split) that reads its positions only up to ``lengths[b]`` —
the same skipping the TPU kernel's DMA clamp buys — shares each K/V tile
among the H/K query heads of the group and writes an f32 partial softmax
into scratch the wrapper allocates; a combine pass merges a row's splits.
Both launches are made by the one C entry point.  Its bound on an H100 is
the K/V bytes actually read, ``2 * sum(lengths) * K * hd * itemsize``, at
3.35 TB/s.

``decode_attention`` dispatches on the tensors' device only: CPU tensors
take ``decode_attention_reference`` (the plain version), CUDA tensors
launch the kernel or raise.  ``launches`` counts kernel launches (one per
call: the split and combine kernels go out together).

Given scales (int8 lanes), it replaces ``decode_attention_quant_pallas``
(``_decode_kernel`` with quant=True) and launches
``csrc/decode_attention_quant.cu``: the same split kernel and combine pass
over int8 storage, each tile dequantized in shared memory — one f32 scale
per (position, KV head), each value ``(x.astype(f32) *
scale).astype(q.dtype)``, the Pallas kernel's rounding — so it reads half
the K/V bytes plus the scales, ``2 * sum(lengths) * K * (hd + 4)``.  The
splits are sized as for bf16/f32, in tiles of q's dtype (the dequantized
tile is what a block holds).  Its plain version dequantizes the same way
(``dequantize_kv``) and calls ``decode_attention_reference``.
``quant_launches`` counts its launches.
"""

from __future__ import annotations

import functools
import math

import torch

from llm_instance_gateway_tpu_torch.ops import _build

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 8  # query heads per KV head the kernel's shared memory holds
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Split-S geometry (csrc/decode_tile.cuh): a K or V tile is 16 KB of q's
# dtype (64 positions at bf16 hd 128); a split is at most SPLIT_TILES tiles
# long, and there are enough splits that full rows would fill the card
# SPLIT_WAVES times over at SPLIT_BLOCKS_PER_SM resident blocks per SM
# (one split block takes ~72 KB of shared memory).
TILE_BYTES = 16384
SPLIT_TILES = 8
SPLIT_BLOCKS_PER_SM = 3
SPLIT_WAVES = 2

# Kernel launches since the count was last reset (plain ints, host side):
# the bf16/f32 kernel and the int8 kernel.
launches = 0
quant_launches = 0


def tile_positions(hd: int, dtype: torch.dtype) -> int:
    """Positions per K/V tile of the split kernel for q's dtype."""
    return TILE_BYTES // (hd * dtype.itemsize)


@functools.lru_cache(maxsize=256)
def split_plan(batch: int, n_kv: int, s_max: int, tile: int, n_sm: int,
               page: int = 1) -> tuple[int, int]:
    """(split_len, n_split) for the split kernel: how many positions of a
    row one block covers, and how many splits cover S_max.

    From shapes the host knows and the card's SM count only — never from
    the lengths, which live on the device (reading them would add a host
    sync to every decode step).  split_len is a multiple of the tile and
    of the pool's block size ``page``; a split is at most SPLIT_TILES
    tiles, and there are at least enough splits for SPLIT_WAVES full waves
    of blocks if every row were S_max long.  B=8, K=8 on 132 SMs: 16
    splits of 512 at S_max 8192, 8 of 128 at 1024."""
    def cdiv(a, b):
        return -(-a // b)

    unit = math.lcm(tile, page)
    want = max(cdiv(s_max, SPLIT_TILES * tile),
               cdiv(SPLIT_WAVES * SPLIT_BLOCKS_PER_SM * n_sm, batch * n_kv))
    split_len = cdiv(cdiv(s_max, want), unit) * unit
    return split_len, cdiv(s_max, split_len)


_sm_counts: dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """The card's SM count, read once per device."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sm_counts[index]


def split_scratch(b: int, h: int, hd: int, n_split: int,
                  device: torch.device) -> torch.Tensor:
    """The split kernel's f32 partials: acc [B, H, n_split, hd], then m and
    l [B, H, n_split], in one buffer.  The wrapper drops it once both
    kernels are queued: the caching allocator hands its memory only to
    work queued later on the same stream."""
    return torch.empty(b * h * n_split * (hd + 2), dtype=torch.float32,
                       device=device)


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


def dequantize_kv(x: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """int8 values [..., hd] with f32 scales [...] -> ``dtype``, as the
    Pallas kernel dequantizes a tile: f32 multiply, then one rounding."""
    return (x.float() * scale.float()[..., None]).to(dtype)


def decode_attention_quant_reference(q: torch.Tensor, k_cache: torch.Tensor,
                                     v_cache: torch.Tensor,
                                     k_scale: torch.Tensor,
                                     v_scale: torch.Tensor,
                                     lengths: torch.Tensor) -> torch.Tensor:
    """The int8 kernel's function in plain PyTorch: k/v int8
    [B, S_max, K, hd] with f32 scales [B, S_max, K], dequantized to q's
    dtype (``dequantize_kv``), then ``decode_attention_reference``."""
    return decode_attention_reference(
        q, dequantize_kv(k_cache, k_scale, q.dtype),
        dequantize_kv(v_cache, v_scale, q.dtype), lengths)


def _check(q, k_cache, v_cache, lengths, kv_dtype=None) -> None:
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
    kv_dtype = q.dtype if kv_dtype is None else kv_dtype
    if (q.dtype not in _DTYPES or k_cache.dtype != kv_dtype
            or v_cache.dtype != kv_dtype):
        raise ValueError(f"decode_attention: dtype {q.dtype} / cache "
                         f"{k_cache.dtype} (q float32 or bfloat16; the cache "
                         f"{'int8' if kv_dtype == torch.int8 else 'alike'})")
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


def _check_scales(k_cache, k_scale, v_scale, what: str) -> None:
    """f32 scales, one per (position, KV head), contiguous beside the cache."""
    for sc in (k_scale, v_scale):
        if (sc.dtype != torch.float32 or sc.shape != k_cache.shape[:-1]
                or sc.device != k_cache.device or not sc.is_contiguous()):
            raise ValueError(f"{what}: scales must be contiguous float32 "
                             f"{tuple(k_cache.shape[:-1])} on the cache's "
                             f"device, got {sc.dtype} {tuple(sc.shape)}")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Cached single-token attention over contiguous lanes; with
    ``k_scale``/``v_scale`` (f32 [B, S_max, K]) the lanes are int8.

    CPU tensors: the plain version.  CUDA tensors: the Hopper kernel, or
    ``ValueError`` for a shape it does not take."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("decode_attention: give both scales")
    if q.device.type == "cpu":
        if k_scale is not None:
            return decode_attention_quant_reference(
                q, k_cache, v_cache, k_scale, v_scale, lengths)
        return decode_attention_reference(q, k_cache, v_cache, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    return decode_attention_split(q, k_cache, v_cache, lengths,
                                  k_scale=k_scale, v_scale=v_scale)


def decode_attention_split(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, lengths: torch.Tensor,
                           split_len: int | None = None,
                           k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """The lane kernel on CUDA tensors (int8 lanes given scales): the split
    kernel, then the combine kernel, from one C call.  ``split_len`` (a
    multiple of ``tile_positions``) defaults to ``split_plan``'s; another
    one serves to measure the plan."""
    global launches, quant_launches
    if (k_scale is None) != (v_scale is None):
        raise ValueError("decode_attention: give both scales")
    quant = k_scale is not None
    _check(q, k_cache, v_cache, lengths,
           kv_dtype=torch.int8 if quant else None)
    if quant:
        _check_scales(k_cache, k_scale, v_scale, "decode_attention")
    b, h, hd = q.shape
    s_max = k_cache.shape[1]
    tile = tile_positions(hd, q.dtype)
    if split_len is None and s_max >= 1:
        split_len = split_plan(b, k_cache.shape[2], s_max, tile,
                               sm_count(q.device))[0]
    if s_max < 1 or split_len < 1 or split_len % tile:
        raise ValueError(f"decode_attention: S_max {s_max} must be >= 1 and "
                         f"split_len {split_len} a positive multiple of "
                         f"{tile}")
    out = torch.empty_like(q)
    part = split_scratch(b, h, hd, -(-s_max // split_len), q.device)
    name = "decode_attention_quant" if quant else "decode_attention"
    ptrs = [q, k_cache, v_cache] + ([k_scale, v_scale] if quant else []) \
        + [lengths, out, part]
    fn = getattr(_build.load(name), f"{name}_launch")
    rc = fn(*(t.data_ptr() for t in ptrs), b, s_max, h, k_cache.shape[2], hd,
            _DTYPES[q.dtype], 1.0 / math.sqrt(hd), split_len,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, name)
    if quant:
        quant_launches += 1
    else:
        launches += 1
    return out
