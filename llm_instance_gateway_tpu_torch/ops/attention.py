"""Attention ops in plain PyTorch (port of ``ops/attention.py``).

Grouped-query layout throughout: queries reshape to [.., K, G, hd] and
contract against the K KV heads without materializing repeated KV.  Scores
and softmax run in f32 (bf16 inputs are upcast exactly); masked logits are
``NEG_INF`` = -1e30, never -inf, so a fully masked row stays NaN-free.

These are the reference ops, held to the JAX functions by the CPU tests.
The serving path calls the kernel wrappers in ``flash_attention``,
``decode_attention``, ``chunk_attention`` and ``paged_decode_attention``
instead; ``gather_pool_rows`` is the one pool->lane read of the paged
model (an index, as in the reference, outside any kernel).
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _grouped(q: torch.Tensor, n_kv_heads: int) -> torch.Tensor:
    """[.., n_heads, hd] -> [.., n_kv, q_per_kv, hd]."""
    *lead, n_heads, hd = q.shape
    return q.reshape(*lead, n_kv_heads, n_heads // n_kv_heads, hd)


def prefill_attention(
    q: torch.Tensor,  # [B, S, n_heads, hd]
    k: torch.Tensor,  # [B, S, n_kv, hd]
    v: torch.Tensor,  # [B, S, n_kv, hd]
    positions: torch.Tensor | None = None,  # [B, S]
) -> torch.Tensor:
    """Causal self-attention over a full prompt.  Returns [B, S, n_heads, hd].

    With ``positions`` given, token i attends to j iff positions[j] <=
    positions[i] AND j <= i.
    """
    b, s, n_heads, hd = q.shape
    n_kv = k.shape[2]
    qg = _grouped(q, n_kv).float()  # [B,S,K,G,hd]
    logits = torch.einsum("bikgh,bjkh->bkgij", qg, k.float())
    logits = logits * (1.0 / math.sqrt(hd))
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    mask = mask[None, None, None]
    if positions is not None:
        valid = positions[:, None, :] <= positions[:, :, None]  # [B,Si,Sj]
        mask = mask & valid[:, None, None]
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgij,bjkh->bikgh", probs, v)
    return out.reshape(b, s, n_heads, hd)


def decode_attention(
    q: torch.Tensor,        # [B, n_heads, hd]
    k_cache: torch.Tensor,  # [B, S_max, n_kv, hd]
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # [B] valid tokens per sequence
) -> torch.Tensor:
    """Single-step cached attention over the whole static cache, positions
    >= lengths masked.  Returns [B, n_heads, hd].  (A row of length 0
    averages the cache, exactly like the reference's XLA op; the lane
    kernel's plain version in ``decode_attention.py`` gives zeros.)"""
    b, s_max, n_kv, hd = k_cache.shape
    qg = _grouped(q, n_kv).float()  # [B,K,G,hd]
    logits = torch.einsum("bkgh,bskh->bkgs", qg, k_cache.float())
    logits = logits * (1.0 / math.sqrt(hd))
    valid = (torch.arange(s_max, device=q.device)[None]
             < lengths[:, None].to(q.device))
    logits = torch.where(valid[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgs,bskh->bkgh", probs, v_cache)
    return out.reshape(b, q.shape[1], hd)


def xla_chunk_attention(
    q: torch.Tensor,        # [B, C, n_heads, hd] at contiguous positions
    k_cache: torch.Tensor,  # [B, S_max, n_kv, hd], incl. the chunk's own KV
    v_cache: torch.Tensor,
    start: int,             # global position of chunk token 0
) -> torch.Tensor:
    """Chunk-vs-cache attention: chunk token i (global position start+i)
    attends cache positions <= start+i.  Returns [B, C, n_heads, hd]."""
    b, c, n_heads, hd = q.shape
    s_max, n_kv = k_cache.shape[1], k_cache.shape[2]
    qg = _grouped(q, n_kv).float()
    logits = torch.einsum("bikgh,bjkh->bkgij", qg, k_cache.float())
    logits = logits * (1.0 / math.sqrt(hd))
    q_pos = int(start) + torch.arange(c, device=q.device)
    mask = torch.arange(s_max, device=q.device)[None, :] <= q_pos[:, None]
    logits = torch.where(mask[None, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgij,bjkh->bikgh", probs, v_cache)
    return out.reshape(b, c, n_heads, hd)


def gather_pool_rows(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Paged-pool gather ``[n_blocks+1, P, ...] x [B, M] -> [B, M*P, ...]``:
    each table row's physical blocks concatenated into its lane view.
    Rank-generic (scale pools ``[n_blocks+1, P, K]`` included)."""
    g = pool[tables.long()]  # [B, M, P, ...]
    return g.reshape(g.shape[0], g.shape[1] * g.shape[2], *g.shape[3:])
