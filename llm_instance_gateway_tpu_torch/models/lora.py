"""Multi-LoRA serving slots (port of ``models/lora.py``).

Adapters live in pre-allocated buffers ``[n_layers, n_slots, d, r_max]`` so
one decode batch multiplexes adapters and the base model per row.  Ranks
below ``r_max`` are zero-padded (exactly zero contribution); the per-slot
``scale`` holds alpha/r.  Slot id -1 means "no adapter": its one-hot row is
all zero, so base rows get an exact 0 delta.

``load_adapter``/``unload_adapter`` return NEW buffers (the slot's leaves
are cloned, then written), like the reference's functional updates: the
engine thread keeps reading a consistent set while an admin thread loads.
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


def load_adapter(bufs: dict[str, Any], cfg, slot: int, adapter: dict[str, Any],
                 alpha: float, rank: int) -> dict[str, Any]:
    """Write an adapter into ``slot``; returns updated buffers.

    ``adapter`` maps target -> {"a": [n_layers, d_in, r], "b": [n_layers,
    r, d_out]} (numpy or torch) with r <= max_lora_rank; missing targets
    stay zero.  alpha/r lands in the per-slot scale vector."""
    if not 0 <= slot < cfg.max_lora_slots:
        raise ValueError(f"slot {slot} out of range [0, {cfg.max_lora_slots})")
    if rank > cfg.max_lora_rank:
        raise ValueError(f"rank {rank} exceeds max_lora_rank {cfg.max_lora_rank}")
    dims = target_dims(cfg)
    out = dict(bufs)
    for t in TARGETS:
        d_in, d_out = dims[t]
        a_buf = np.zeros((cfg.n_layers, d_in, cfg.max_lora_rank), np.float32)
        b_buf = np.zeros((cfg.n_layers, cfg.max_lora_rank, d_out), np.float32)
        if t in adapter:
            a = np.asarray(adapter[t]["a"], np.float32)
            b = np.asarray(adapter[t]["b"], np.float32)
            if a.shape != (cfg.n_layers, d_in, rank):
                raise ValueError(
                    f"{t}.a shape {a.shape} != {(cfg.n_layers, d_in, rank)}")
            if b.shape != (cfg.n_layers, rank, d_out):
                raise ValueError(
                    f"{t}.b shape {b.shape} != {(cfg.n_layers, rank, d_out)}")
            a_buf[:, :, :rank] = a
            b_buf[:, :rank, :] = b
        for key, host in ((f"{t}_a", a_buf), (f"{t}_b", b_buf)):
            new = out[key].clone()
            new[:, slot] = torch.from_numpy(host).to(new.device, new.dtype)
            out[key] = new
    scale = out["scale"].clone()
    scale[slot] = alpha / rank
    out["scale"] = scale
    return out


def unload_adapter(bufs: dict[str, Any], cfg, slot: int) -> dict[str, Any]:
    """Zero a slot (slot becomes base-model passthrough)."""
    out = dict(bufs)
    for key in [f"{t}_{ab}" for t in TARGETS for ab in ("a", "b")] + ["scale"]:
        new = out[key].clone()
        if key == "scale":
            new[slot] = 0.0
        else:
            new[:, slot] = 0.0
        out[key] = new
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
