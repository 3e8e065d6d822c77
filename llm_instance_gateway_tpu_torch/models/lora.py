"""Multi-LoRA serving slots (port of ``models/lora.py``).

Adapters live in pre-allocated buffers ``[n_layers, n_slots, d, r_max]`` so
one decode batch multiplexes adapters and the base model per row.  Ranks
below ``r_max`` are zero-padded (exactly zero contribution); the per-slot
``scale`` holds alpha/r.  Slot id -1 means "no adapter": its one-hot row is
all zero, so base rows get an exact 0 delta.

``write_adapter``/``clear_adapter`` write one slot IN PLACE, so every
buffer keeps its address (the engine's CUDA graph of the decode block reads
them by address); the manager calls them only for a slot no live row reads.
``load_adapter``/``unload_adapter`` are their functional forms (new
buffers), like the reference's updates.
The delta is plain torch ops (einsum), not a kernel.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

TARGETS = ("q", "k", "v", "o", "gate", "up", "down")


def target_dims(cfg) -> dict[str, tuple[int, int]]:
    """(d_in, d_out) per LoRA target for this architecture."""
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    return {
        "q": (d, cfg.n_heads * hd),
        "k": (d, cfg.n_kv_heads * hd),
        "v": (d, cfg.n_kv_heads * hd),
        "o": (cfg.n_heads * hd, d),
        "gate": (d, cfg.d_ff),
        "up": (d, cfg.d_ff),
        "down": (cfg.d_ff, d),
    }


def init_lora_buffers(cfg, dtype=torch.bfloat16,
                      device="cuda") -> dict[str, Any]:
    """All-zero slot buffers (zero delta == base model for every slot)."""
    dims = target_dims(cfg)
    bufs: dict[str, Any] = {
        "scale": torch.zeros((cfg.max_lora_slots,), dtype=torch.float32,
                             device=device)}
    for t in TARGETS:
        d_in, d_out = dims[t]
        bufs[f"{t}_a"] = torch.zeros(
            (cfg.n_layers, cfg.max_lora_slots, d_in, cfg.max_lora_rank),
            dtype=dtype, device=device)
        bufs[f"{t}_b"] = torch.zeros(
            (cfg.n_layers, cfg.max_lora_slots, cfg.max_lora_rank, d_out),
            dtype=dtype, device=device)
    return bufs


def _f32(x) -> torch.Tensor:
    """An f32 CPU (or device) tensor of ``x`` (numpy or torch)."""
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.from_numpy(np.asarray(x, np.float32))


def write_adapter(bufs: dict[str, Any], cfg, slot: int,
                  adapter: dict[str, Any], alpha: float, rank: int) -> None:
    """Write an adapter into ``slot`` of ``bufs`` in place.

    ``adapter`` maps target -> {"a": [n_layers, d_in, r], "b": [n_layers,
    r, d_out]} (numpy or torch) with r <= max_lora_rank; missing targets
    stay zero.  alpha/r lands in the per-slot scale vector.  The weights
    go to the device as f32 (asynchronously from pinned host tensors, the
    host tier's form) and round to the buffers' dtype there."""
    if not 0 <= slot < cfg.max_lora_slots:
        raise ValueError(f"slot {slot} out of range [0, {cfg.max_lora_slots})")
    if rank > cfg.max_lora_rank:
        raise ValueError(f"rank {rank} exceeds max_lora_rank {cfg.max_lora_rank}")
    dims = target_dims(cfg)
    staged = {}
    for t in TARGETS:  # check every target before the first write
        if t not in adapter:
            continue
        d_in, d_out = dims[t]
        a, b = _f32(adapter[t]["a"]), _f32(adapter[t]["b"])
        if tuple(a.shape) != (cfg.n_layers, d_in, rank):
            raise ValueError(
                f"{t}.a shape {tuple(a.shape)} != {(cfg.n_layers, d_in, rank)}")
        if tuple(b.shape) != (cfg.n_layers, rank, d_out):
            raise ValueError(
                f"{t}.b shape {tuple(b.shape)} != {(cfg.n_layers, rank, d_out)}")
        staged[t] = (a, b)
    for t in TARGETS:
        a_buf, b_buf = bufs[f"{t}_a"], bufs[f"{t}_b"]
        a_buf[:, slot] = 0.0
        b_buf[:, slot] = 0.0
        if t in staged:
            a, b = staged[t]
            a_buf[:, slot, :, :rank] = a.to(a_buf.device, non_blocking=True)
            b_buf[:, slot, :rank, :] = b.to(b_buf.device, non_blocking=True)
    bufs["scale"][slot] = alpha / rank


def clear_adapter(bufs: dict[str, Any], cfg, slot: int) -> None:
    """Zero ``slot`` of ``bufs`` in place (base-model passthrough)."""
    for t in TARGETS:
        bufs[f"{t}_a"][:, slot] = 0.0
        bufs[f"{t}_b"][:, slot] = 0.0
    bufs["scale"][slot] = 0.0


def load_adapter(bufs: dict[str, Any], cfg, slot: int, adapter: dict[str, Any],
                 alpha: float, rank: int) -> dict[str, Any]:
    """``write_adapter`` into a copy of ``bufs``; returns the new buffers."""
    out = {k: v.clone() for k, v in bufs.items()}
    write_adapter(out, cfg, slot, adapter, alpha, rank)
    return out


def unload_adapter(bufs: dict[str, Any], cfg, slot: int) -> dict[str, Any]:
    """``clear_adapter`` on a copy of ``bufs``; returns the new buffers."""
    out = {k: v.clone() for k, v in bufs.items()}
    clear_adapter(out, cfg, slot)
    return out


def lora_delta(
    x: torch.Tensor,          # [B, S, d_in] or [B, d_in]
    a: torch.Tensor,          # [n_slots, d_in, r]
    b: torch.Tensor,          # [n_slots, r, d_out]
    scale: torch.Tensor,      # [n_slots] f32
    slot_ids: torch.Tensor,   # [B] int, -1 = no adapter
) -> torch.Tensor:
    """Per-row multi-adapter delta: scale[s] * (x @ a[s]) @ b[s],
    s = slot_ids[row], through a one-hot mix (slot -1 -> exact 0)."""
    n_slots = a.shape[0]
    onehot = (slot_ids[:, None].to(x.device)
              == torch.arange(n_slots, device=x.device)[None]).to(x.dtype)
    a_sel = torch.einsum("bs,sir->bir", onehot, a)  # [B, d_in, r]
    b_sel = torch.einsum("bs,sro->bro", onehot, b)  # [B, r, d_out]
    s_sel = (onehot.float() @ scale).to(x.dtype)    # [B]
    if x.dim() == 3:
        mid = torch.einsum("bsi,bir->bsr", x, a_sel)
        delta = torch.einsum("bsr,bro->bso", mid, b_sel)
        return delta * s_sel[:, None, None]
    mid = torch.einsum("bi,bir->br", x, a_sel)
    delta = torch.einsum("br,bro->bo", mid, b_sel)
    return delta * s_sel[:, None]


def layer_slice(bufs: dict[str, Any], layer: int) -> dict[str, Any]:
    """Per-layer view {t_a: [n_slots, d_in, r], t_b, scale}."""
    out = {"scale": bufs["scale"]}
    for t in TARGETS:
        out[f"{t}_a"] = bufs[f"{t}_a"][layer]
        out[f"{t}_b"] = bufs[f"{t}_b"][layer]
    return out
