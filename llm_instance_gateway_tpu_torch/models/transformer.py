"""Decoder-only transformer (port of ``models/transformer.py``, dense path).

Same parameter tree as the reference — layer-stacked leaves
(``params["layers"]["wq"]`` is ``[n_layers, d, H*hd]``), ``x @ w`` with
``[in, out]`` weights — so weights cross between the packages as arrays
(``models/weights.py``).  The layer scan is a Python loop over the stacked
leaves.  bf16 params/activations on the card, f32 norms/softmax/logits.

Attention goes through the kernel wrappers: ``flash_attention`` for
prefill and ``decode_attention`` for the cached step, which launch the
Hopper kernels on CUDA tensors and take their plain versions on CPU
tensors.  Every projection adds the per-row LoRA delta.

Differences from the JAX functions, by design:
- ``decode_step`` and ``insert_prefill`` update the cache tensors IN PLACE
  (the reference donates the cache to XLA for the same effect) and return
  the same dict with a new ``length``;
- inactive rows' KV writes are masked explicitly (the reference parks them
  at the out-of-bounds index ``s_max``, which XLA drops; torch would raise
  on the CPU and corrupt memory on the card).
Only the dense Llama path is ported: MoE, q/k/v biases and int8 caches
raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from llm_instance_gateway_tpu_torch.models import lora as lora_lib
from llm_instance_gateway_tpu_torch.models.configs import ModelConfig
from llm_instance_gateway_tpu_torch.ops.decode_attention import decode_attention
from llm_instance_gateway_tpu_torch.ops.flash_attention import flash_attention
from llm_instance_gateway_tpu_torch.ops.layers import apply_rope, rms_norm, swiglu

Params = dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    if cfg.n_experts:
        raise NotImplementedError(
            "MoE models (n_experts > 0) are not ported yet: ROADMAP Queue 1 "
            "item 13 (model families)")
    if cfg.attention_bias:
        raise NotImplementedError(
            "q/k/v attention biases (Qwen2) are not ported yet: ROADMAP "
            "Queue 1 item 13 (model families)")
    if not (cfg.use_flash_attention and cfg.use_pallas_decode):
        raise NotImplementedError(
            "the port's attention always runs through its kernel wrappers "
            "(plain versions on CPU tensors); use_flash_attention / "
            "use_pallas_decode = False is not served")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                device="cuda") -> Params:
    """Random weights with the reference's distributions (normal /
    sqrt(fan_in), embeddings normal * 0.02, norms one), drawn on ``device``
    from a seeded ``torch.Generator`` one layer at a time, so a Llama-3-8B
    init never holds more than one layer's f32 draw."""
    check_supported(cfg)
    hd = cfg.resolved_head_dim
    d, f, v = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    n_l = cfg.n_layers
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(shape, mult):
        out = torch.empty(shape, dtype=dtype, device=device)
        parts = out if len(shape) == 3 else out[None]
        for part in parts:
            part.copy_(torch.randn(part.shape, generator=gen, device=device,
                                   dtype=torch.float32) * mult)
        return out

    def dense(shape, fan_in):
        return draw(shape, 1.0 / math.sqrt(fan_in))

    layers: Params = {
        "attn_norm": torch.ones((n_l, d), dtype=dtype, device=device),
        "mlp_norm": torch.ones((n_l, d), dtype=dtype, device=device),
        "wq": dense((n_l, d, cfg.n_heads * hd), d),
        "wk": dense((n_l, d, cfg.n_kv_heads * hd), d),
        "wv": dense((n_l, d, cfg.n_kv_heads * hd), d),
        "wo": dense((n_l, cfg.n_heads * hd, d), cfg.n_heads * hd),
        "w_gate": dense((n_l, d, f), d),
        "w_up": dense((n_l, d, f), d),
        "w_down": dense((n_l, f, d), f),
    }
    params: Params = {
        "embed": draw((v, d), 0.02),
        "layers": layers,
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((d, v), d)
    return params


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device="cuda",
                      quantized: bool = False) -> Params:
    """Contiguous-lane decode cache ``[L, B, S_max, K, hd]``."""
    if quantized:
        raise NotImplementedError(
            "int8 KV caches are not ported yet: ROADMAP Queue 1 item 10")
    hd = cfg.resolved_head_dim
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _project(x, w, layer_lora, target, slot_ids):
    """x @ w plus the per-row LoRA delta for ``target``."""
    out = x @ w
    if layer_lora is not None:
        out = out + lora_lib.lora_delta(
            x, layer_lora[f"{target}_a"], layer_lora[f"{target}_b"],
            layer_lora["scale"], slot_ids)
    return out


def _mlp(cfg: ModelConfig, lp: Params, x, layer_lora, slot_ids):
    gate = _project(x, lp["w_gate"], layer_lora, "gate", slot_ids)
    up = _project(x, lp["w_up"], layer_lora, "up", slot_ids)
    return _project(swiglu(gate, up, cfg.gelu_mlp), lp["w_down"], layer_lora,
                    "down", slot_ids)


def _embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor):
    h = params["embed"][tokens.long()]
    if cfg.embedding_scale:
        h = h * torch.tensor(math.sqrt(cfg.d_model)).to(h.dtype)
    return h


def _logits(cfg: ModelConfig, params: Params, h):
    h = rms_norm(h, params["final_norm"], cfg.norm_eps,
                 plus_one=cfg.norm_plus_one)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (h @ head).float()


def _layer(params: Params, i: int) -> Params:
    return {name: leaf[i] for name, leaf in params["layers"].items()}


def _no_slots(b: int, device) -> torch.Tensor:
    return torch.full((b,), -1, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def prefill_layer(cfg: ModelConfig, lp: Params, h: torch.Tensor,
                  positions: torch.Tensor, layer_lora: Params | None = None,
                  slot_ids: torch.Tensor | None = None):
    """One decoder block over a full sequence.  Returns (h, (k, v))."""
    b, s, _ = h.shape
    if slot_ids is None:
        slot_ids = _no_slots(b, h.device)
    hd = cfg.resolved_head_dim
    hn = rms_norm(h, lp["attn_norm"], cfg.norm_eps, plus_one=cfg.norm_plus_one)
    q = _project(hn, lp["wq"], layer_lora, "q", slot_ids).reshape(
        b, s, cfg.n_heads, hd)
    k = _project(hn, lp["wk"], layer_lora, "k", slot_ids).reshape(
        b, s, cfg.n_kv_heads, hd)
    v = _project(hn, lp["wv"], layer_lora, "v", slot_ids).reshape(
        b, s, cfg.n_kv_heads, hd).contiguous()
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
    # Right-padded batches: causal tiling alone keeps real positions exact
    # (the kernel ignores positions, like the TPU kernel).
    attn = flash_attention(q, k, v)
    h = h + _project(attn.reshape(b, s, -1), lp["wo"], layer_lora, "o",
                     slot_ids)
    hn2 = rms_norm(h, lp["mlp_norm"], cfg.norm_eps, plus_one=cfg.norm_plus_one)
    h = h + _mlp(cfg, lp, hn2, layer_lora, slot_ids)
    return h, (k, v)


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            positions: torch.Tensor, lora_bufs: Params | None = None,
            slot_ids: torch.Tensor | None = None):
    """Full-prompt forward.  Returns (logits [B,S,V] f32, k [L,B,S,K,hd], v)."""
    check_supported(cfg)
    b, s = tokens.shape
    if slot_ids is None:
        slot_ids = _no_slots(b, tokens.device)
    h = _embed(cfg, params, tokens)
    hd = cfg.resolved_head_dim
    kv_shape = (cfg.n_layers, b, s, cfg.n_kv_heads, hd)
    k_all = torch.empty(kv_shape, dtype=h.dtype, device=h.device)
    v_all = torch.empty(kv_shape, dtype=h.dtype, device=h.device)
    for i in range(cfg.n_layers):
        layer_lora = (None if lora_bufs is None
                      else lora_lib.layer_slice(lora_bufs, i))
        h, (k, v) = prefill_layer(cfg, _layer(params, i), h, positions,
                                  layer_lora=layer_lora, slot_ids=slot_ids)
        k_all[i] = k
        v_all[i] = v
    return _logits(cfg, params, h), k_all, v_all


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------


def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                tokens: torch.Tensor, positions: torch.Tensor,
                lora_bufs: Params | None = None,
                slot_ids: torch.Tensor | None = None,
                active: torch.Tensor | None = None):
    """One decode step for every slot.  Returns (logits [B,V] f32, cache).

    ``active`` [B] bool gates the KV WRITE: an inactive row's cache cell is
    rewritten with its own old value, so its lane stays unchanged without a
    host sync (positions at or past ``S_max`` never write either).  The
    cache tensors are updated in place.
    """
    check_supported(cfg)
    b = tokens.shape[0]
    dev = tokens.device
    if slot_ids is None:
        slot_ids = _no_slots(b, dev)
    hd = cfg.resolved_head_dim
    s_max = cache["k"].shape[2]
    h = _embed(cfg, params, tokens)
    positions = positions.to(dev)
    lengths = (positions + 1).to(torch.int32)
    pos = positions.long()
    writes = pos < s_max
    if active is not None:
        writes = writes & active.to(dev)
    write_pos = pos.clamp(max=s_max - 1)
    rows = torch.arange(b, device=dev)
    keep = writes[:, None, None]
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        layer_lora = (None if lora_bufs is None
                      else lora_lib.layer_slice(lora_bufs, i))
        hn = rms_norm(h, lp["attn_norm"], cfg.norm_eps,
                      plus_one=cfg.norm_plus_one)
        q = _project(hn, lp["wq"], layer_lora, "q", slot_ids).reshape(
            b, cfg.n_heads, hd)
        k = _project(hn, lp["wk"], layer_lora, "k", slot_ids).reshape(
            b, cfg.n_kv_heads, hd)
        v = _project(hn, lp["wv"], layer_lora, "v", slot_ids).reshape(
            b, cfg.n_kv_heads, hd)
        q = apply_rope(q[:, None], positions[:, None], cfg.rope_theta,
                       cfg.rope_scaling)[:, 0].contiguous()
        k = apply_rope(k[:, None], positions[:, None], cfg.rope_theta,
                       cfg.rope_scaling)[:, 0]
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        k_cache[rows, write_pos] = torch.where(
            keep, k.to(k_cache.dtype), k_cache[rows, write_pos])
        v_cache[rows, write_pos] = torch.where(
            keep, v.to(v_cache.dtype), v_cache[rows, write_pos])
        attn = decode_attention(q, k_cache, v_cache, lengths)
        h = h + _project(attn.reshape(b, -1), lp["wo"], layer_lora, "o",
                         slot_ids)
        hn2 = rms_norm(h, lp["mlp_norm"], cfg.norm_eps,
                       plus_one=cfg.norm_plus_one)
        h = h + _mlp(cfg, lp, hn2, layer_lora, slot_ids)
    cache["length"] = lengths
    return _logits(cfg, params, h), cache


def insert_prefill(cache: Params, k_prompt: torch.Tensor,
                   v_prompt: torch.Tensor, slot: int, length: int) -> Params:
    """Insert a prefilled sequence's KV ``[L, 1, S, K, hd]`` into decode
    slot ``slot`` (in place).  ``length`` is the true prompt length; the
    padded tail is garbage, masked by ``cache['length']``."""
    s = min(k_prompt.shape[2], cache["k"].shape[2])
    cache["k"][:, slot, :s] = k_prompt[:, 0, :s].to(cache["k"].dtype)
    cache["v"][:, slot, :s] = v_prompt[:, 0, :s].to(cache["v"].dtype)
    length_vec = cache["length"].clone()
    length_vec[slot] = length
    cache["length"] = length_vec
    return cache
