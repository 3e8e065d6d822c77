"""Paged KV cache: a shared block pool with per-row block tables (port of
``models/paged.py``).

vLLM's PagedAttention memory model — the one the gateway's KV-threshold
routing was tuned against (``tpu:kv_cache_usage_perc`` = allocated blocks
over total blocks):

- one pool per K and V, ``[L, n_blocks + 1, block, K, hd]``, whose shape
  never depends on allocation state;
- per-row block tables ``[B, max_blocks_per_seq]`` int32 map logical blocks
  to physical ones; allocation and freeing live on the host (the engine
  owns the free list), the device only sees table contents change;
- physical block 0 is the TRASH block: unallocated table entries, inactive
  rows and a final chunk's pads past the table's span all write there, so
  every write stays inside the pool.  Several rows may hit the trash cell
  in one write; which garbage wins does not matter, so writes are plain
  index assignments (never ``accumulate=True``).

The decode step reads the pool through ``paged_decode_attention`` — the
Hopper kernel streams each row's physical blocks straight from the pool
(no gathered copy of the lane); the chunk path gathers the row's lane view
(``gather_pool_rows``, an index, as in the reference) and runs the chunk
kernel over it.  Every function updates the pools, tables and lengths IN
PLACE and returns the same dict.

int8 pools (``quantized=True``) keep f32 scale pools ``[L, n_blocks + 1,
block, K]`` beside the int8 data, indexed by the same physical block, so a
prefix-cache hit — a table repoint — carries the scales with no copy.
Values are quantized at the write seam (``_pool_update``), dequantized at
the chunk path's read seam (``_pool_rows``), and the decode step hands the
scale pools to the int8 kernel.  ``extend_step_paged`` (the speculative
verify) reads the gathered view as the chunk path does.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from llm_instance_gateway_tpu_torch.models.configs import ModelConfig
from llm_instance_gateway_tpu_torch.models.transformer import (
    _kv_dequantize,
    _kv_quantize,
    check_supported,
    chunk_forward,
    decode_forward,
    extend_forward,
    to_device,
)
from llm_instance_gateway_tpu_torch.ops.attention import gather_pool_rows
from llm_instance_gateway_tpu_torch.ops.paged_decode_attention import (
    paged_decode_attention,
)
from llm_instance_gateway_tpu_torch.parallel import sharding

Params = dict[str, Any]

TRASH_BLOCK = 0  # physical block 0: write target for inactive/unallocated


def init_paged_cache(cfg: ModelConfig, batch: int, max_len: int,
                     n_blocks: int, block: int, dtype=torch.bfloat16,
                     device="cuda", quantized: bool = False) -> Params:
    """Block pools + tables.  ``n_blocks`` EXCLUDES the trash block.
    ``quantized`` stores the pools int8 with f32 scale pools ``k_scale`` /
    ``v_scale`` ``[L, n_blocks + 1, block, K]``."""
    hd = cfg.resolved_head_dim
    max_blocks_per_seq = -(-max_len // block)
    shape = (cfg.n_layers, n_blocks + 1, block, cfg.n_kv_heads, hd)
    kv_dtype = torch.int8 if quantized else dtype
    cache = {
        "k": torch.zeros(shape, dtype=kv_dtype, device=device),
        "v": torch.zeros(shape, dtype=kv_dtype, device=device),
        "tables": torch.full((batch, max_blocks_per_seq), TRASH_BLOCK,
                             dtype=torch.int32, device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    if quantized:
        cache["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device)
        cache["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device)
    return cache


def _layer_pools(cache: Params, i: int) -> tuple:
    """Layer ``i``'s pools: (k, v), or (k, v, k_scale, v_scale) if int8."""
    names = ("k", "v", "k_scale", "v_scale") if "k_scale" in cache \
        else ("k", "v")
    return tuple(cache[n][i] for n in names)


def _pool_update(pools: tuple, k: torch.Tensor, v: torch.Tensor,
                 phys_block: torch.Tensor, offset: torch.Tensor) -> tuple:
    """Write fresh K/V ``[N, K, hd]`` into one layer's pools at
    (phys_block, offset) — the one write seam every paged step shares.  A
    4-tuple (k, v, k_scale, v_scale) is an int8 pool: values are quantized
    per (position, KV head) on the way in."""
    if len(pools) == 4:
        k_pool, v_pool, ks_pool, vs_pool = pools
        k_pool[phys_block, offset], ks_pool[phys_block, offset] = \
            _kv_quantize(k)
        v_pool[phys_block, offset], vs_pool[phys_block, offset] = \
            _kv_quantize(v)
        return pools
    k_pool, v_pool = pools
    k_pool[phys_block, offset] = k.to(k_pool.dtype)
    v_pool[phys_block, offset] = v.to(v_pool.dtype)
    return pools


def _pool_rows(pools: tuple, tables: torch.Tensor, dtype) -> tuple:
    """Gather each table row's blocks into its lane view — the one read
    seam of the chunk path.  int8 pools come back dequantized to ``dtype``
    (``_kv_dequantize``, the reference's arithmetic)."""
    rows = tuple(gather_pool_rows(p, tables) for p in pools)
    if len(rows) == 4:
        return (_kv_dequantize(rows[0], rows[2], dtype),
                _kv_dequantize(rows[1], rows[3], dtype))
    return rows


def decode_step_paged(cfg: ModelConfig, params: Params, cache: Params,
                      tokens: torch.Tensor, positions: torch.Tensor,
                      lora_bufs: Params | None = None,
                      slot_ids: torch.Tensor | None = None,
                      active: torch.Tensor | None = None):
    """One decode step over the paged pool; same semantics as
    ``transformer.decode_step``.  Each row writes its current position
    through its table; rows with ``active`` False write the trash block
    (a reserved row's table may already hold a streaming prompt's real
    blocks).  Positions must lie below the table span (the engine clamps).
    An int8 pool hands its scale pools to the int8 kernel.  A sharded
    pool (``Shards``) holds each shard's KV heads under the one table.
    Returns (logits [B, V] f32, cache)."""
    check_supported(cfg)
    b = tokens.shape[0]
    dev = tokens.device
    caches = sharding.parts(cache)
    block = caches[0]["k"].shape[2]
    tables = caches[0]["tables"]
    positions = positions.to(dev)
    pos = positions.long()
    lengths = (positions + 1).to(torch.int32)
    phys = tables[torch.arange(b, device=dev), pos // block].long()
    if active is not None:
        phys = torch.where(active.to(dev), phys, TRASH_BLOCK)
    offset = pos % block
    idx = [tuple(x.to(c["k"].device) for x in (phys, offset, lengths))
           for c in caches]

    def write_and_attend(i, s, q, k, v):
        phys, offset, lengths = idx[s]
        pools = _pool_update(_layer_pools(caches[s], i), k, v, phys, offset)
        return paged_decode_attention(q, pools[0], pools[1],
                                      caches[s]["tables"], lengths,
                                      *pools[2:])

    logits = decode_forward(cfg, params, tokens, positions, lora_bufs,
                            slot_ids, write_and_attend)
    for c, (*_, lengths) in zip(caches, idx):
        c["length"].copy_(lengths)
    return logits, cache


def extend_step_paged(cfg: ModelConfig, params: Params, cache: Params,
                      tokens: torch.Tensor, positions: torch.Tensor,
                      lora_bufs: Params | None = None,
                      slot_ids: torch.Tensor | None = None,
                      active: torch.Tensor | None = None):
    """C new tokens per row over the paged pool (parity with
    ``transformer.extend_step``): each row's tokens write through its
    block table and attend the row's gathered lane view (``_pool_rows``,
    the reference's read), causal within the new tokens and over the
    row's history.  Positions past the table span, and every position of
    a row with ``active`` False, write the trash block.  Returns (logits
    [B, C, V] f32, cache)."""
    check_supported(cfg)
    b, c = tokens.shape
    dev = tokens.device
    caches = sharding.parts(cache)
    block = caches[0]["k"].shape[2]
    tables = caches[0]["tables"]
    max_blocks = tables.shape[1]
    pos = positions.long()
    writable = pos < max_blocks * block
    if active is not None:
        writable = writable & active.to(dev)[:, None]
    rows = torch.arange(b, device=dev)[:, None]
    logical = (pos // block).clamp(0, max_blocks - 1)
    phys = torch.where(writable, tables[rows, logical].long(),
                       TRASH_BLOCK).reshape(-1)
    offset = (pos % block).reshape(-1)
    idx = [tuple(x.to(cc["k"].device) for x in (phys, offset))
           for cc in caches]

    def write_and_view(i, s, k, v):
        kh, hd = k.shape[2], k.shape[3]
        pools = _pool_update(_layer_pools(caches[s], i),
                             k.reshape(-1, kh, hd), v.reshape(-1, kh, hd),
                             *idx[s])
        return _pool_rows(pools, caches[s]["tables"], k.dtype)

    logits = extend_forward(cfg, params, tokens, positions, lora_bufs,
                            slot_ids, write_and_view)
    lengths = (positions[:, -1] + 1).to(torch.int32)
    for cc in caches:
        cc["length"].copy_(lengths.to(cc["length"].device))
    return logits, cache


def insert_prefill_paged(cache: Params, k_prompt: torch.Tensor,
                         v_prompt: torch.Tensor, row: int, phys_blocks,
                         table_row, length: int) -> Params:
    """Write a prefilled prompt's KV ``[L, 1, S_bucket, K, hd]`` into the
    pool blocks ``phys_blocks`` (``ceil(S_bucket / block)`` ints; wholly
    padding blocks point at the trash block) and set row ``row``'s table
    to ``table_row`` (the FULL new row: allocated blocks + trash tail).
    The trailing partial block carries bucket padding into a real block,
    masked by ``length``.  An int8 pool gets the prompt quantized, its
    scales written to the same blocks of the scale pools.  A sharded pool
    takes each shard's KV heads (every replica, zeros at its zero
    heads)."""
    lyr, _, s, _, hd = k_prompt.shape
    for cache_s, heads in sharding.kv_parts(cache):
        block = cache_s["k"].shape[2]
        kh = cache_s["k"].shape[3]
        dev = cache_s["k"].device
        phys = to_device(np.asarray(phys_blocks, np.int64), dev)
        n_b = phys.shape[0]
        pad = n_b * block - s
        for name, prompt in (("k", k_prompt), ("v", v_prompt)):
            new = torch.nn.functional.pad(sharding.local_heads(
                prompt[:, 0, :, heads], kh).to(dev), (0, 0, 0, 0, 0, pad))
            if f"{name}_scale" in cache_s:
                new, scales = _kv_quantize(new)
                cache_s[f"{name}_scale"][:, phys] = scales.reshape(
                    lyr, n_b, block, kh)
            cache_s[name][:, phys] = new.to(cache_s[name].dtype).reshape(
                lyr, n_b, block, kh, hd)
        cache_s["tables"][int(row)] = to_device(
            np.array(table_row, np.int32), dev)
        cache_s["length"][int(row)] = int(length)
    return cache


def prefill_with_cache_paged(cfg: ModelConfig, params: Params, cache: Params,
                             tokens, positions, row: int, lane_end: int,
                             last_index: int,
                             lora_bufs: Params | None = None,
                             lora_slot: int = -1):
    """Chunked prefill against the paged pool (parity with
    ``transformer.prefill_with_cache``): the chunk's K/V write through row
    ``row``'s table and its queries attend the row's gathered lane view.
    Positions past the table span route to the trash block — a clipped
    lookup would alias the row's LAST real block.  ``positions`` is a host
    array.  Returns (last_logits [V] f32, cache)."""
    check_supported(cfg)
    pos = np.asarray(positions, dtype=np.int64)  # numpy or a CPU tensor
    caches = sharding.parts(cache)
    block = caches[0]["k"].shape[2]
    max_blocks = caches[0]["tables"].shape[1]
    idx = []
    for c in caches:
        dev = c["k"].device
        table_row = c["tables"][int(row)]
        inside = to_device(pos < max_blocks * block, dev)
        logical = to_device(np.clip(pos // block, 0, max_blocks - 1), dev)
        phys = torch.where(inside, table_row[logical].long(), TRASH_BLOCK)
        idx.append((table_row, phys, to_device(pos % block, dev)))

    def write_and_view(i, s, k, v):
        table_row, phys, offset = idx[s]
        pools = _pool_update(_layer_pools(caches[s], i), k, v, phys, offset)
        return tuple(r[0] for r in _pool_rows(pools, table_row[None],
                                              k.dtype))

    last_logits = chunk_forward(cfg, params, tokens, pos, lora_bufs,
                                lora_slot, last_index, write_and_view)
    for c in caches:
        c["length"][int(row)] = int(lane_end)
    return last_logits, cache
