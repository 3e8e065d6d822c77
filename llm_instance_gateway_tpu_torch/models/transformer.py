"""Decoder-only transformer (port of ``models/transformer.py``).

Every family of the reference through ``ModelConfig`` flags: Llama, Gemma
(tied embeddings, sqrt(d) embedding scale, (1+w) RMSNorm, GeLU gate),
Qwen2 (q/k/v biases, ``_attn_proj``) and Mixtral (the top-k MoE MLP,
``_moe_mlp``).

Same parameter tree as the reference — layer-stacked leaves
(``params["layers"]["wq"]`` is ``[n_layers, d, H*hd]``), ``x @ w`` with
``[in, out]`` weights — so weights cross between the packages as arrays
(``models/weights.py``).  The layer scan is a Python loop over the stacked
leaves.  bf16 params/activations on the card, f32 norms/softmax/logits.

Attention goes through the kernel wrappers: ``flash_attention`` for
prefill, ``decode_attention`` (given the scales of an int8 cache, its
int8 kernel) for the cached step and ``chunk_attention`` for chunked prefill
(``prefill_with_cache``, shared with the paged pool's chunk path in
``models/paged.py``), which launch the Hopper kernels on CUDA tensors and
take their plain versions on CPU tensors.  Every projection goes through
``ops/quant.matmul`` (dense or int8 ``{"q","s"}`` leaves) and adds the
per-row LoRA delta (expert weights take none, as in the reference).

int8 KV caches (``quantized=True``) store K/V int8 with one f32 scale per
(position, KV head) (``_kv_quantize``; prompt KV is computed in the
activation dtype and quantized where it lands).  A chunk's attention runs
the chunk kernel over the slot's lane dequantized to the activation dtype
(``_kv_dequantize``, one lane per layer); the JAX package sends that view
to XLA instead, for fusion the card's eager path does not have — the same
function either way.

The shard grid (``parallel/sharding.py``): every forward takes a
``Shards`` params tree as well as a plain one.  Each layer then runs its
attention once per tensor shard, on the shard's heads (the kernel
wrappers called once per shard), and its MLP once per shard, on the
shard's ffn columns — or its experts' (``expert`` shards: the layer view
carries the first expert, ``_experts``) — and sums the shards' ``wo``
and ``w_down`` partials onto the residual: two reductions a layer
(``_attn_block``, ``_mlp_block``); norms and residuals are replicated.
A plain tree is the one-shard case, the same arithmetic.  Caches are then
``Shards`` too, each tensor shard's holding its KV heads, and the
prefill's KV comes back whole.  Over ``data`` a decode, extend or chunk
step runs each data group's grid on its rows (``_per_data_group``, the
logits back whole on group 0's device) and a prefill on the group its
caller names; over ``fsdp`` a layer's split weights are gathered as the
shard loop takes the layer (``_Shards.layer``) and ``lm_head`` before
the head.  ``prefill``'s ``attention_fn`` seam runs
sequence blocks on the ``sequence`` groups with the ring's attention
(``parallel/long_context.py``).  Across processes a ``Shards`` holds this
process's shards: the loops run over them, the residual enters each
block through the column-parallel copy and leaves it through the
row-parallel sum over the processes (``parallel/collectives.py``), and
the embedding, norms and head run on every process, so each holds the
whole ``[B, V]`` logits.

Differences from the JAX functions, by design:
- ``decode_step``, ``insert_prefill`` and ``prefill_with_cache`` update the
  cache tensors IN PLACE (the reference donates the cache to XLA for the
  same effect), ``length`` included, and return the same dict;
- writes the reference parks at out-of-bounds indices, which XLA drops
  (inactive rows at ``s_max``, a final chunk's pads past ``s_max``), are
  masked or skipped explicitly: torch would raise on the CPU and corrupt
  memory on the card;
- a chunk's ``positions`` are a host array: the engine holds them in
  numpy, so where the chunk starts and which cells it writes are decided
  without a device read;
- ``cache["length"]`` (like every cache tensor) keeps its address: the
  engine's CUDA graph of the decode block writes it in place, and host
  arrays reach the card through ``to_device`` (pinned memory, no wait
  for the work already queued, such as a decode block in flight);
- the MoE top-k breaks ties toward the lower expert index, as
  ``jax.lax.top_k`` does (``_top_k``; ``torch.topk`` promises no order),
  and the grouped dispatch's exact fallback, the reference's
  ``lax.cond``, is a device-side select in the forwards the engine
  captures as CUDA graphs (decode, extend) and a host read of the
  overflow flag in the eager ones (prefill, chunk): ``_moe_grouped``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any

import numpy as np
import torch

from llm_instance_gateway_tpu_torch.models import lora as lora_lib
from llm_instance_gateway_tpu_torch.models.configs import ModelConfig
from llm_instance_gateway_tpu_torch.ops.chunk_attention import chunk_attention
from llm_instance_gateway_tpu_torch.ops.decode_attention import decode_attention
from llm_instance_gateway_tpu_torch.ops.flash_attention import flash_attention
from llm_instance_gateway_tpu_torch.ops.layers import apply_rope, rms_norm, swiglu
from llm_instance_gateway_tpu_torch.ops.quant import (
    QUANT_TARGETS,
    expert_matmul,
    expert_mix,
    expert_mix_down,
    int8_max,
    quantize_weight,
)
from llm_instance_gateway_tpu_torch.ops.quant import matmul as q_matmul
from llm_instance_gateway_tpu_torch.parallel import collectives, sharding

Params = dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    if not (cfg.use_flash_attention and cfg.use_pallas_decode):
        raise NotImplementedError(
            "the port's attention always runs through its kernel wrappers "
            "(plain versions on CPU tensors); use_flash_attention / "
            "use_pallas_decode = False is not served")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                device="cuda", quantize: bool = False) -> Params:
    """Random weights with the reference's distributions (normal /
    sqrt(fan_in), embeddings normal * 0.02, norms one, q/k/v biases zero),
    drawn on ``device`` from a seeded ``torch.Generator`` one layer at a
    time (expert stacks too), so a Llama-3-8B init never holds more than
    one layer's f32 draw.

    ``quantize`` returns ``quantize_params``' int8 tree without ever
    holding the dense one: each layer of a projection is drawn in
    ``dtype`` and quantized before the next is drawn, so Mixtral-8x7B
    (~93 GB in bf16) builds its ~47 GB int8 tree on an 80 GB card.  The
    draws and the arithmetic are the dense path's, so the tree is
    bit-identical to ``quantize_params(init_params(...))``."""
    check_supported(cfg)
    hd = cfg.resolved_head_dim
    d, f, v = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    n_l = cfg.n_layers
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(shape, mult):
        return (torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32) * mult).to(dtype)

    def draw(shape, mult, quant=False):
        if len(shape) == 2:  # embed, lm_head: one draw
            w = randn(shape, mult)
            return quantize_weight(w) if quant else w
        if quant:
            out = {"q": torch.empty(shape, dtype=torch.int8, device=device),
                   "s": torch.empty(shape[:-2] + shape[-1:],
                                    dtype=torch.float32, device=device)}
        else:
            out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0]):
            part = randn(shape[1:], mult)
            if quant:
                qs = quantize_weight(part)
                out["q"][i], out["s"][i] = qs["q"], qs["s"]
            else:
                out[i] = part
        return out

    def dense(shape, fan_in, name=None):
        return draw(shape, 1.0 / math.sqrt(fan_in),
                    quantize and name in (*QUANT_TARGETS, "lm_head"))

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    layers: Params = {
        "attn_norm": torch.ones((n_l, d), dtype=dtype, device=device),
        "mlp_norm": torch.ones((n_l, d), dtype=dtype, device=device),
    }
    for name, d_in, d_out in (("wq", d, cfg.n_heads * hd),
                              ("wk", d, cfg.n_kv_heads * hd),
                              ("wv", d, cfg.n_kv_heads * hd),
                              ("wo", cfg.n_heads * hd, d)):
        layers[name] = dense((n_l, d_in, d_out), d_in, name)
    if cfg.attention_bias:
        # Qwen2-family q/k/v biases (zero, as the reference inits them).
        layers["wq_b"] = zeros(n_l, cfg.n_heads * hd)
        layers["wk_b"] = zeros(n_l, cfg.n_kv_heads * hd)
        layers["wv_b"] = zeros(n_l, cfg.n_kv_heads * hd)
    experts = (cfg.n_experts,) if cfg.n_experts else ()
    if experts:
        layers["router"] = dense((n_l, d, cfg.n_experts), d)
    for name, d_in, d_out in (("w_gate", d, f), ("w_up", d, f),
                              ("w_down", f, d)):
        layers[name] = dense((n_l, *experts, d_in, d_out), d_in, name)
    params: Params = {
        "embed": draw((v, d), 0.02),
        "layers": layers,
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((d, v), d, "lm_head")
    return params


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device="cuda",
                      quantized: bool = False) -> Params:
    """Contiguous-lane decode cache ``[L, B, S_max, K, hd]``.  ``quantized``
    stores K/V int8 with f32 scales ``k_scale``/``v_scale`` of shape
    ``[L, B, S_max, K]`` (one per position and KV head)."""
    hd = cfg.resolved_head_dim
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, hd)
    kv_dtype = torch.int8 if quantized else dtype
    cache = {
        "k": torch.zeros(shape, dtype=kv_dtype, device=device),
        "v": torch.zeros(shape, dtype=kv_dtype, device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    if quantized:
        cache["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device)
        cache["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device)
    return cache


def _kv_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., hd] -> (int8 [..., hd], f32 scale [...]): symmetric per-vector
    max-abs quantization (one scale per position per KV head).
    ``torch.round`` rounds half to even, as ``jnp.round`` does.  The scale
    is a true f32 division (``int8_max``): a product with the reciprocal
    rounds otherwise than the reference's division in ~5% of cases and
    would break the round trip the int8 handoff relies on (dequantize,
    quantize again: the same values).  The int8 wire lane quantizes with
    this function too, so its bytes are the cache's."""
    xf = x.float()
    s = (xf.abs().amax(dim=-1) / int8_max(xf.device)).clamp_min(1e-8)
    q = torch.round(xf / s[..., None]).clamp(-127, 127).to(torch.int8)
    return q, s


def _kv_dequantize(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    """The reference's dequantize for lanes read outside the decode kernel:
    both factors in ``dtype``, one product (the decode kernels multiply in
    f32 instead, as the Pallas kernel does; the two agree at f32)."""
    return q.to(dtype) * s[..., None].to(dtype)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _project(x, w, layer_lora, target, slot_ids):
    """x @ w plus the per-row LoRA delta for ``target`` (w may be int8)."""
    out = q_matmul(x, w)
    if layer_lora is not None:
        out = out + lora_lib.lora_delta(
            x, layer_lora[f"{target}_a"], layer_lora[f"{target}_b"],
            layer_lora["scale"], slot_ids)
    return out


def _attn_proj(lp: Params, target: str, x, layer_lora, slot_ids):
    """The q/k/v projection plus its LoRA delta, then the Qwen2-family
    bias where the config declares one (the bias keys exist in the layer
    params iff ``attention_bias``), in the reference's order."""
    out = _project(x, lp[f"w{target}"], layer_lora, target, slot_ids)
    bias = lp.get(f"w{target}_b")
    return out if bias is None else out + bias


def _mlp(cfg: ModelConfig, lp: Params, x, layer_lora, slot_ids,
         host_flag: bool = False):
    """The gated MLP, or with ``cfg.n_experts`` the MoE MLP
    (``host_flag``: see ``_moe_grouped``)."""
    if cfg.n_experts:
        return _moe_mlp(cfg, lp, x, host_flag)
    gate = _project(x, lp["w_gate"], layer_lora, "gate", slot_ids)
    up = _project(x, lp["w_up"], layer_lora, "up", slot_ids)
    return _project(swiglu(gate, up, cfg.gelu_mlp), lp["w_down"], layer_lora,
                    "down", slot_ids)


def _moe_mlp(cfg: ModelConfig, lp: Params, x, host_flag: bool = False):
    """Top-k mixture-of-experts MLP (Mixtral), the reference's gate: the
    dense all-experts mix when the capacity tile would not beat it (cap >=
    t) or, in exact mode, when the tile is under 8 rows (routine routing
    collisions overflow it, and an exact-mode overflow pays grouped plus
    dense); the grouped capacity dispatch otherwise.  The choice depends on
    the token count only, so a captured block takes one path for good.
    No LoRA on expert weights, as in the reference.  ``lp`` may hold a
    slice of the experts (an ``expert`` shard's, ``_experts``): the gate,
    the capacity and the path stay the global ones, and the result is the
    slice's share of the sum over experts."""
    t = math.prod(x.shape[:-1])
    cap = _moe_capacity(cfg, t)
    if cap >= t or (cfg.moe_exact_fallback and cap < 8):
        return _moe_dense(cfg, lp, x)
    return _moe_grouped(cfg, lp, x, host_flag)


def _moe_capacity(cfg: ModelConfig, t: int) -> int:
    """Per-expert capacity tile for ``t`` tokens: ceil(t*k/E * factor),
    the factor at least 2.0 in exact mode (its overflow pays grouped plus
    dense, so it must stay rare at every size); a tile of 16 or more
    rounds up to a multiple of 8; never more than ``t``."""
    e, k = cfg.n_experts, cfg.n_experts_per_token
    f = cfg.moe_capacity_factor
    if cfg.moe_exact_fallback:
        f = max(f, 2.0)
    cap = int(-(-t * k * f // e))
    if cap >= 16:
        cap = (cap + 7) // 8 * 8
    return min(t, cap)


def _top_k(logits: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values and
    their indices, a tie going to the lower index.  A stable descending
    sort keeps tied entries in index order (``torch.topk`` promises no
    order for ties)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(cfg: ModelConfig, lp: Params, x):
    """Router logits (a product in x's dtype, then f32), top-k, and the
    gates: an f32 softmax over the chosen k.  Returns (topi, gates)."""
    logits = (x @ lp["router"]).float()
    topv, topi = _top_k(logits, cfg.n_experts_per_token)
    return topi, torch.softmax(topv, dim=-1)


def _experts(lp: Params) -> tuple[int, int]:
    """(first, count) of the experts a layer's stacks hold: all of them,
    or an ``expert`` shard's slice, whose layer view carries its offset
    (``_Shards.layer``)."""
    w = lp["w_gate"]
    return (lp.get("expert_offset", 0),
            (w["q"] if isinstance(w, dict) else w).shape[0])


def _moe_dense(cfg: ModelConfig, lp: Params, x):
    """Every expert over every token, mixed by the top-k gates scattered
    to a dense [..., E] vector (the gates of the experts ``lp`` holds)."""
    topi, gates = _route(cfg, lp, x)
    e0, n_loc = _experts(lp)
    experts = torch.arange(e0, e0 + n_loc, device=x.device)
    dense_gates = ((topi[..., None] == experts).float()
                   * gates[..., None]).sum(-2)
    hidden = expert_mix(x, lp["w_gate"])
    up = expert_mix(x, lp["w_up"])
    per_expert = expert_mix_down(swiglu(hidden, up, cfg.gelu_mlp),
                                 lp["w_down"])
    return torch.einsum("...ed,...e->...d", per_expert,
                        dense_gates.to(x.dtype))


def _moe_grouped(cfg: ModelConfig, lp: Params, x, host_flag: bool = False):
    """Grouped capacity dispatch: each token's k assignments land in
    per-expert tiles [E, cap, d], three batched products run each expert
    over its tile, and a gather plus a gate-weighted sum combines them.

    An assignment's row in its expert's tile is its rank among that
    expert's assignments; one past the tile overflows and clips onto the
    tile's last row with its contribution zeroed, so ``index_add_`` (CUDA
    atomics) gives each kept cell exactly one non-zero add and the result
    stays deterministic.  With ``moe_exact_fallback`` an overflow anywhere
    makes the whole batch the dense result (the reference's ``lax.cond``):
    ``host_flag`` reads the flag on the host and computes the dense mix
    only when it is set (the eager prefill and chunk forwards: one sync a
    layer); otherwise both are computed and ``torch.where`` selects on the
    device, which a CUDA graph can hold (the decode and extend forwards).

    An ``expert`` shard (``lp`` holding a slice, ``_experts``) builds the
    tiles of its own experts only, ``[E_local, cap, d]``, from the global
    routing: ranks and the overflow flag come from every expert's counts,
    so every shard takes the same branch, and its result is its experts'
    share of the sum."""
    shape = x.shape
    d = shape[-1]
    xf = x.reshape(-1, d)
    t = xf.shape[0]
    e, k = cfg.n_experts, cfg.n_experts_per_token
    e0, n_loc = _experts(lp)
    topi, gates = _route(cfg, lp, xf)  # [T, k]
    cap = _moe_capacity(cfg, t)
    flat_expert = topi.reshape(-1)  # [T*k], token-major
    assign = (flat_expert[:, None]
              == torch.arange(e, device=x.device)).to(torch.int32)
    pos = ((torch.cumsum(assign, dim=0) - 1) * assign).sum(-1)
    kept = pos < cap
    local = flat_expert - e0
    mine = kept if n_loc == e else kept & (local >= 0) & (local < n_loc)
    flat_idx = local.clamp(0, n_loc - 1) * cap + pos.clamp(0, cap - 1)
    keep_col = mine[:, None].to(xf.dtype)
    xk = xf[:, None].expand(t, k, d).reshape(t * k, d)
    x_e = torch.zeros((n_loc * cap, d), dtype=xf.dtype, device=xf.device)
    x_e.index_add_(0, flat_idx, xk * keep_col)
    x_e = x_e.reshape(n_loc, cap, d)
    hidden = expert_matmul(x_e, lp["w_gate"])
    up = expert_matmul(x_e, lp["w_up"])
    out_e = expert_matmul(swiglu(hidden, up, cfg.gelu_mlp), lp["w_down"])
    gathered = out_e.reshape(n_loc * cap, d)[flat_idx] * keep_col
    y = (gathered.reshape(t, k, d) * gates.to(xf.dtype)[..., None]).sum(1)
    if cfg.moe_exact_fallback:
        overflow = (~kept).any()
        if not host_flag:
            y = torch.where(overflow, _moe_dense(cfg, lp, xf), y)
        elif bool(overflow):
            y = _moe_dense(cfg, lp, xf)
    return y.reshape(shape)


def _embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor):
    h = params["embed"][tokens.long()]
    if cfg.embedding_scale:
        h = h * torch.tensor(math.sqrt(cfg.d_model)).to(h.dtype)
    return h


def _logits(cfg: ModelConfig, params: Params, h):
    h = rms_norm(h, params["final_norm"], cfg.norm_eps,
                 plus_one=cfg.norm_plus_one)
    head = (params["embed"].T if cfg.tie_embeddings
            else sharding.whole(params["lm_head"]))  # gathered over fsdp
    return q_matmul(h, head).float()


def _layer(params: Params, i: int) -> Params:
    """Layer ``i`` of the stacked leaves; an int8 ``{"q","s"}`` leaf is
    sliced part by part."""
    return {name: ({part: t[i] for part, t in leaf.items()}
                   if isinstance(leaf, dict) else leaf[i])
            for name, leaf in params["layers"].items()}


def to_device(x, device) -> torch.Tensor:
    """A host array (or CPU tensor) on ``device``.  To a card the copy
    goes through pinned memory without waiting: a copy from pageable
    memory would first wait for everything queued on the stream."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _no_slots(b: int, device) -> torch.Tensor:
    return torch.full((b,), -1, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# The layer blocks, over every tensor shard
# ---------------------------------------------------------------------------


class _Shards:
    """The shards a forward iterates: the trees of sequence group
    ``group`` of a ``Shards`` params tree (``parallel/sharding.py``; one
    data group's) with their local config, or the one tree of a plain
    one.  The residual stream is a list with one entry per shard (one
    tensor, repeated, when the shards share a device).  Attention runs on
    the first ``n_attn`` shards (expert 0's tensor shards), the MLP on all
    of them.  Leaves split over ``fsdp`` are gathered as a layer is
    taken (``layer``); across cards layer i+1's gathers are issued on a
    side stream per card while layer i computes."""

    def __init__(self, cfg: ModelConfig, params, lora_bufs, group: int = 0):
        sharded = isinstance(params, sharding.Shards)
        self.tp = params.tp if sharded else None
        self.group = group
        self.trees = params.groups[group] if sharded else [params]
        self.cfg = cfg if self.tp is None else self.tp.cfg
        self.n = len(self.trees)
        self.n_attn = 1 if self.tp is None else self.tp.n_attn
        if isinstance(lora_bufs, sharding.Shards):
            self.loras = lora_bufs.groups[group]
        else:
            self.loras = [lora_bufs] * self.n
        # fsdp across cards: side streams and the gathers issued ahead.
        self._side = None
        self._ahead: dict = {}
        if (self.tp is not None and self.tp.f > 1 and not self.tp.one_device
                and self.tp.devices[0].type == "cuda"):
            self._side = {d: torch.cuda.Stream(device=d)
                          for d in set(self.tp.devices)}

    def layer(self, i: int) -> list:
        """Layer ``i``'s params and LoRA slice, per shard; an ``expert``
        shard's layer view carries its first expert (``_experts``).  Its
        fsdp leaves come gathered: across cards from the gathers issued
        when layer i-1 was taken (each card's stream waits on their
        event), and layer i+1's are issued now."""
        if self._side is None:
            return self._take(i)
        got = self._ahead.pop(i, None) or self._issue(i)
        if i + 1 < self.cfg.n_layers:
            self._ahead[i + 1] = self._issue(i + 1)
        out, events = got
        for dev, ev in events.items():
            torch.cuda.current_stream(dev).wait_event(ev)
        for lp, ll in out:
            for x in list(lp.values()) + list((ll or {}).values()):
                for t in (x.values() if isinstance(x, dict) else [x]):
                    if isinstance(t, torch.Tensor) and t.is_cuda:
                        t.record_stream(torch.cuda.current_stream(t.device))
        return out

    def _issue(self, i: int):
        """Layer ``i`` taken on the side streams (the gathers queued
        there), with an event per card marking their end."""
        for dev, stream in self._side.items():
            stream.wait_stream(torch.cuda.current_stream(dev))
        with sharding.gather_streams(self._side):
            out = self._take(i)
        events = {}
        for dev, stream in self._side.items():
            events[dev] = torch.cuda.Event()
            events[dev].record(stream)
        return out, events

    def _take(self, i: int) -> list:
        out = []
        for s, (tree, lora) in enumerate(zip(self.trees, self.loras)):
            lp = _layer(tree, i)
            if self.tp is not None and self.tp.moe:
                lp["expert_offset"] = self.tp.expert_offset(s)
            out.append((lp, None if lora is None
                        else lora_lib.layer_slice(lora, i)))
        return out

    def on(self, x) -> list:
        """``x`` on every shard's device."""
        if self.tp is None:
            return [x]
        return [self.tp.on(s, x, self.group) for s in range(self.n)]

    def residual(self, hs: list, parts: list, attn: bool = False) -> list:
        if self.tp is None:
            return [hs[0] + parts[0]]
        return self.tp.residual(hs, parts, attn)

    def enter(self, hs: list, attn: bool = False) -> list:
        """The residual as it enters the shards' block (across processes
        the column-parallel copy, ``TensorParallel.enter``)."""
        return hs if self.tp is None else self.tp.enter(hs, attn)

    def embed(self, cfg: ModelConfig, tokens: torch.Tensor) -> list:
        if self.tp is None or self.tp.one_device:
            return [_embed(cfg, self.trees[0], tokens)] * self.n
        return [_embed(cfg, tree, tok)
                for tree, tok in zip(self.trees, self.on(tokens))]

    def logits(self, cfg: ModelConfig, hs: list):
        return _logits(cfg, self.trees[0], hs[0])

    def current(self, s: int):
        """Shard ``s``'s card made the current device, where the shards
        span cards: a kernel wrapper launches on the current device, into
        the stream of its tensors' device (a launch from another card
        would run unordered with the work that made its inputs)."""
        if self.tp is None or self.tp.one_device:
            return contextlib.nullcontext()
        dev = self.tp.device(s, self.group)
        return (torch.cuda.device(dev) if dev.type == "cuda"
                else contextlib.nullcontext())


def _attn_qkv(sh: _Shards, layer: list, hs: list, sids: list, lead: tuple,
              rope) -> list:
    """A layer's attention inputs per attention shard (``layer``:
    ``_Shards.layer``'s params and LoRA slice per shard): the norm, the
    q/k/v projections of the shard's heads and ``rope(s, q, k)``.
    Returns ``(q, k, v)`` per shard, each ``[*lead, heads, hd]``."""
    c = sh.cfg
    hd = c.resolved_head_dim
    hs = sh.enter(hs, attn=True)
    out = []
    for s, (lp, ll) in enumerate(layer[:sh.n_attn]):
        hn = rms_norm(hs[s], lp["attn_norm"], c.norm_eps,
                      plus_one=c.norm_plus_one)
        q = _attn_proj(lp, "q", hn, ll, sids[s]).reshape(*lead, c.n_heads, hd)
        k = _attn_proj(lp, "k", hn, ll, sids[s]).reshape(
            *lead, c.n_kv_heads, hd)
        v = _attn_proj(lp, "v", hn, ll, sids[s]).reshape(
            *lead, c.n_kv_heads, hd)
        out.append((*rope(s, q, k), v))
    return out


def _attn_out(sh: _Shards, layer: list, hs: list, sids: list, lead: tuple,
              attns: list) -> list:
    """The row-parallel ``wo`` partial of each attention shard's output
    (``[*lead, ...]``), reduced onto the residual of every shard."""
    parts = [_project(attn.reshape(*lead, -1), lp["wo"], ll, "o", sids[s])
             for s, ((lp, ll), attn) in enumerate(zip(layer, attns))]
    return sh.residual(hs, parts + [None] * (sh.n - len(parts)), attn=True)


def _attn_block(sh: _Shards, layer: list, hs: list, sids: list,
                lead: tuple, rope, attend) -> list:
    """A layer's attention over every attention shard: ``_attn_qkv``,
    ``attend(s, q, k, v)`` (the kernel wrapper over the shard's heads,
    returning ``[*lead, ...]``) with the shard's card current, and
    ``_attn_out``."""
    attns = []
    for s, qkv in enumerate(_attn_qkv(sh, layer, hs, sids, lead, rope)):
        with sh.current(s):
            attns.append(attend(s, *qkv))
    return _attn_out(sh, layer, hs, sids, lead, attns)


def _mlp_block(sh: _Shards, layer: list, hs: list, sids: list,
               host_flag: bool = False) -> list:
    """A layer's MLP over every shard (its ffn columns, or its experts'
    ffn columns), the row-parallel partials reduced onto the residual."""
    c = sh.cfg
    parts = []
    entered = sh.enter(hs)
    for s, (lp, ll) in enumerate(layer):
        hn = rms_norm(entered[s], lp["mlp_norm"], c.norm_eps,
                      plus_one=c.norm_plus_one)
        parts.append(_mlp(c, lp, hn, ll, sids[s], host_flag))
    return sh.residual(hs, parts)


def _rope_seq(cfg: ModelConfig, positions: list):
    """RoPE over [..., S, heads, hd] at each shard's positions."""
    def rope(s, q, k):
        return (apply_rope(q, positions[s], cfg.rope_theta, cfg.rope_scaling),
                apply_rope(k, positions[s], cfg.rope_theta,
                           cfg.rope_scaling))
    return rope


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def prefill_layer(shs: list, i: int, hs: list, positions: list,
                  sids: list, k_all: torch.Tensor, v_all: torch.Tensor,
                  attention_fn=None) -> list:
    """Decoder block ``i`` over a full sequence, or over its sequence
    blocks, on every shard: ``shs[j]`` is block j's ``_Shards`` and
    ``hs[j]`` / ``positions[j]`` / ``sids[j]`` its per-shard residual,
    positions and slot ids.  Each block's K/V lands at its rows and each
    shard's heads of ``k_all`` / ``v_all`` ``[L, B, S, K, hd]`` (None:
    written nowhere, the training forward's case).  Attention
    is the flash kernel per shard (one block), or ``attention_fn(s, qs,
    ks, vs)`` over tensor shard ``s``'s q/k/v of every block, returning
    each block's output.  Where the sequence spans processes the blocks
    are this process's (the first one ``shs[0].group``): the K/V of every
    block comes over the sequence group (``collectives.exchange``), and
    ``attention_fn(s, qs, ks, vs, first=...)`` gets this process's
    queries and every block's K/V.  Returns the residual per block and
    shard."""
    tp = shs[0].tp
    seq = None if tp is None or attention_fn is None else tp.seq_group
    layers = [sh.layer(i) for sh in shs]
    leads = [tuple(h[0].shape[:2]) for h in hs]
    qkvs = [_attn_qkv(sh, layer, h, sid, lead, _rope_seq(sh.cfg, pos))
            for sh, layer, h, sid, lead, pos in zip(shs, layers, hs, sids,
                                                    leads, positions)]
    attns = [[None] * shs[0].n_attn for _ in shs]
    for s in range(shs[0].n_attn):
        qs, ks, vs = ([qkv[s][x] for qkv in qkvs] for x in range(3))
        if seq is not None:
            # The sequence spans processes: every block's K/V from every
            # process, one exchange a layer (its backward hands each
            # process the gradient of its own blocks).
            kv = collectives.exchange(torch.stack(
                [torch.cat(ks, dim=1), torch.cat(vs, dim=1)]), 2, seq)
            ks, vs = (list(x.chunk(tp.n, dim=1)) for x in kv)
        if k_all is not None and (tp is None or s == 0 or tp.kv_split):
            # Training writes no KV; a replicated KV head is written once.
            heads = slice(None) if tp is None else tp.kv_heads(s)
            start = 0
            for k, v in zip(ks, vs):
                rows = slice(start, start + k.shape[1])
                start += k.shape[1]
                k_all[i, :, rows, heads] = k.to(k_all.device)
                v_all[i, :, rows, heads] = v.to(v_all.device)
        if attention_fn is None:
            # Right-padded batches: causal tiling alone keeps real
            # positions exact (the kernel ignores positions, like the TPU
            # kernel).
            with shs[0].current(s):
                attns[0][s] = flash_attention(qs[0], ks[0],
                                              vs[0].contiguous())
            continue
        outs = (attention_fn(s, qs, ks, vs) if seq is None else
                attention_fn(s, qs, ks, vs, first=shs[0].group))
        for j, out in enumerate(outs):
            attns[j][s] = out
    hs = [_attn_out(sh, layer, h, sid, lead, attn)
          for sh, layer, h, sid, lead, attn in zip(shs, layers, hs, sids,
                                                   leads, attns)]
    return [_mlp_block(sh, layer, h, sid, host_flag=True)
            for sh, layer, h, sid in zip(shs, layers, hs, sids)]


def prefill(cfg: ModelConfig, params: Params, tokens, positions,
            lora_bufs: Params | None = None,
            slot_ids: torch.Tensor | None = None, attention_fn=None,
            data_group: int = 0):
    """Full-prompt forward.  Returns (logits [B,S,V] f32, k [L,B,S,K,hd], v).

    ``params`` may be a ``Shards`` tree (the shard grid): the KV comes
    back whole, every shard's heads in order on the first shard's device.
    ``attention_fn`` swaps the attention (the reference's seam, which
    ``parallel/long_context.py`` uses for the ring): ``tokens`` and
    ``positions`` are then lists of sequence blocks ``[B, S_j]``, block j
    run on sequence group j of the params, and ``attention_fn(s, qs, ks,
    vs)`` maps tensor shard ``s``'s q/k/v of every block to each block's
    attention output (``prefill_layer``); the logits come back whole on
    the first shard's device too.  Over ``data`` the prefill runs on
    data group ``data_group``'s grid (its slot's), the inputs moved to
    its devices and the results left there.  Where ``sequence`` spans
    processes the blocks are this process's (``TensorParallel.
    seq_local``): the K/V comes back whole (every block's, exchanged) and
    the logits of this process's blocks only."""
    check_supported(cfg)
    params = sharding.in_group(params, data_group)
    lora_bufs = sharding.in_group(lora_bufs, data_group)
    blocks = list(tokens) if attention_fn is not None else [tokens]
    pos_blocks = list(positions) if attention_fn is not None else [positions]
    tp = params.tp if isinstance(params, sharding.Shards) else None
    ring = attention_fn is not None and tp is not None
    first = tp.seq_local[0] if ring else 0
    n_seq = tp.n if ring and tp.seq_group is not None else len(blocks)
    if data_group:
        devs = [params.tp.device(0, first + j) for j in range(len(blocks))]
        blocks = [t.to(d) for t, d in zip(blocks, devs)]
        pos_blocks = [p.to(d) for p, d in zip(pos_blocks, devs)]
        slot_ids = None if slot_ids is None else slot_ids.to(devs[0])
    b = blocks[0].shape[0]
    if slot_ids is None:
        slot_ids = _no_slots(b, blocks[0].device)
    shs = [_Shards(cfg, params, lora_bufs, group=first + j)
           for j in range(len(blocks))]
    hs = [sh.embed(cfg, tok) for sh, tok in zip(shs, blocks)]
    hd = cfg.resolved_head_dim
    s = sum(tok.shape[1] for tok in blocks) * n_seq // len(blocks)
    kv_shape = (cfg.n_layers, b, s, cfg.n_kv_heads, hd)
    dev0 = hs[0][0].device
    k_all = torch.empty(kv_shape, dtype=hs[0][0].dtype, device=dev0)
    v_all = torch.empty(kv_shape, dtype=hs[0][0].dtype, device=dev0)
    pos = [sh.on(p) for sh, p in zip(shs, pos_blocks)]
    sids = [sh.on(slot_ids) for sh in shs]
    for i in range(cfg.n_layers):
        hs = prefill_layer(shs, i, hs, pos, sids, k_all, v_all, attention_fn)
    logits = [sh.logits(cfg, h).to(dev0) for sh, h in zip(shs, hs)]
    return (logits[0] if len(logits) == 1 else torch.cat(logits, dim=1),
            k_all, v_all)


# ---------------------------------------------------------------------------
# The data groups
# ---------------------------------------------------------------------------


def _per_data_group(step, cfg: ModelConfig, params, cache, tokens,
                    positions, lora_bufs, slot_ids, active):
    """``step`` (``decode_step`` / ``extend_step``) on each data group's
    block of rows, with the group's params, cache and LoRA buffers, its
    rows' inputs moved to its devices; the logits come back whole on
    group 0's device.  A group's cache holds its rows only, so row r of
    the batch is row ``r - g * rows`` of group g's lanes."""
    per = tokens.shape[0] // len(cache.data)
    dev0 = sharding.parts(cache)[0]["k"].device
    out = []
    for g, cg in enumerate(cache.data):
        dev = sharding.parts(cg)[0]["k"].device
        rows = slice(g * per, (g + 1) * per)

        def mine(x):
            return None if x is None else x[rows].to(dev)
        logits, _ = step(cfg, sharding.in_group(params, g), cg,
                         mine(tokens), mine(positions),
                         lora_bufs=sharding.in_group(lora_bufs, g),
                         slot_ids=mine(slot_ids), active=mine(active))
        out.append(logits.to(dev0))
    return torch.cat(out)


def _data_slot(cache, slot: int) -> tuple:
    """(data group, its cache, the row there) of lane row ``slot``."""
    per = sharding.parts(cache)[0]["length"].shape[0]
    g = int(slot) // per
    return g, cache.data[g], int(slot) - g * per


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------


def decode_forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   positions: torch.Tensor, lora_bufs: Params | None,
                   slot_ids: torch.Tensor | None, write_and_attend):
    """The layer loop both decode steps share (lanes here, the paged pool
    in ``models/paged.py``): each row's token at ``positions[b]`` writes
    its K/V and attends its cache through ``write_and_attend(layer,
    shard, q [B, H, hd], k [B, K, hd], v) -> attn [B, H, hd]`` (the
    shard's heads).  Returns the logits [B, V] (f32)."""
    b = tokens.shape[0]
    if slot_ids is None:
        slot_ids = _no_slots(b, tokens.device)
    sh = _Shards(cfg, params, lora_bufs)
    pos, sids = sh.on(positions[:, None]), sh.on(slot_ids)
    theta, scaling = cfg.rope_theta, cfg.rope_scaling

    def rope(s, q, k):
        return (apply_rope(q[:, None], pos[s], theta, scaling)[:, 0]
                .contiguous(),
                apply_rope(k[:, None], pos[s], theta, scaling)[:, 0])

    hs = sh.embed(cfg, tokens)
    for i in range(cfg.n_layers):
        layer = sh.layer(i)
        hs = _attn_block(sh, layer, hs, sids, (b,), rope,
                         lambda s, q, k, v, i=i: write_and_attend(i, s, q, k,
                                                                  v))
        hs = _mlp_block(sh, layer, hs, sids)
    return sh.logits(cfg, hs)


def _on_caches(caches: list, *xs) -> list:
    """``xs`` on each shard cache's device (themselves where they lie)."""
    return [tuple(x.to(c["k"].device) for x in xs) for c in caches]


def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                tokens: torch.Tensor, positions: torch.Tensor,
                lora_bufs: Params | None = None,
                slot_ids: torch.Tensor | None = None,
                active: torch.Tensor | None = None):
    """One decode step for every slot.  Returns (logits [B,V] f32, cache).

    ``active`` [B] bool gates the KV WRITE: an inactive row's cache cell is
    rewritten with its own old value, so its lane stays unchanged without a
    host sync (positions at or past ``S_max`` never write either).  On an
    int8 cache the row's int8 cells and scales alike keep their old values,
    and attention runs the int8 kernel.  The cache tensors are updated in
    place.  ``params`` and ``cache`` may be sharded (``Shards``): each
    shard writes and attends its own KV heads, each data group its rows.
    """
    check_supported(cfg)
    if sharding.n_data(cache) > 1:
        return _per_data_group(decode_step, cfg, params, cache, tokens,
                               positions, lora_bufs, slot_ids, active), cache
    b = tokens.shape[0]
    dev = tokens.device
    caches = sharding.parts(cache)
    s_max = caches[0]["k"].shape[2]
    positions = positions.to(dev)
    lengths = (positions + 1).to(torch.int32)
    pos = positions.long()
    writes = pos < s_max
    if active is not None:
        writes = writes & active.to(dev)
    write_pos = pos.clamp(max=s_max - 1)
    rows = torch.arange(b, device=dev)
    names = ("k", "v", "k_scale", "v_scale") if "k_scale" in caches[0] \
        else ("k", "v")
    idx = _on_caches(caches, rows, write_pos, writes, lengths)

    def write(dst, new, rows, write_pos, writes):
        keep = writes.view(-1, *([1] * (new.dim() - 1)))
        dst[rows, write_pos] = torch.where(keep, new.to(dst.dtype),
                                           dst[rows, write_pos])

    def write_and_attend(i, s, q, k, v):
        lanes = [caches[s][n][i] for n in names]
        rows, write_pos, writes, lengths = idx[s]
        for j, new in enumerate((k, v)):
            if len(lanes) == 4:  # int8: values and their scales
                new, scale = _kv_quantize(new)
                write(lanes[j + 2], scale, rows, write_pos, writes)
            write(lanes[j], new, rows, write_pos, writes)
        return decode_attention(q, lanes[0], lanes[1], lengths, *lanes[2:])

    logits = decode_forward(cfg, params, tokens, positions, lora_bufs,
                            slot_ids, write_and_attend)
    for c, (*_, lengths) in zip(caches, idx):
        c["length"].copy_(lengths)
    return logits, cache


# ---------------------------------------------------------------------------
# Multi-token cached step (the speculative verify and the draft's catch-up)
# ---------------------------------------------------------------------------


def extend_attend(q: torch.Tensor, k_read: torch.Tensor,
                  v_read: torch.Tensor, positions: torch.Tensor):
    """C queries per row against the row's whole lane view: q [B, C, H,
    hd], k/v [B, S, K, hd], query i of row b attending lane positions <=
    ``positions[b, i]``.  The reference's XLA einsums, not a kernel: f32
    scores divided by sqrt(hd) (a tensor divisor, so the card divides as
    the reference does), masked to -1e30, f32 softmax cast to q's dtype
    for the value product.  Returns [B, C, H*hd]."""
    b, c, n_heads, hd = q.shape
    s, n_kv = k_read.shape[1], k_read.shape[2]
    qg = q.reshape(b, c, n_kv, n_heads // n_kv, hd)
    scores = torch.einsum("bikgh,bjkh->bkgij", qg.float(), k_read.float())
    scores = scores / torch.full((), hd, dtype=torch.float32,
                                 device=q.device).sqrt()
    mask = (torch.arange(s, device=q.device)[None, None, :]
            <= positions[:, :, None])
    scores = torch.where(mask[:, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgij,bjkh->bikgh", probs,
                        v_read.to(q.dtype)).reshape(b, c, -1)


def extend_forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   positions: torch.Tensor, lora_bufs: Params | None,
                   slot_ids: torch.Tensor | None, write_and_view):
    """The layer loop both extend steps share (lanes here, the paged pool
    in ``models/paged.py``): row b's C tokens at ``positions[b]`` write
    their K/V and attend the row's lane view through
    ``write_and_view(layer, shard, k [B, C, K, hd], v) -> (k_read [B, S,
    K, hd], v_read)`` (the shard's heads).  Returns the logits [B, C, V]
    (f32)."""
    b, c = tokens.shape
    if slot_ids is None:
        slot_ids = _no_slots(b, tokens.device)
    sh = _Shards(cfg, params, lora_bufs)
    pos, sids = sh.on(positions), sh.on(slot_ids)

    def attend(i, s, q, k, v):
        k_read, v_read = write_and_view(i, s, k, v)
        return extend_attend(q, k_read, v_read, pos[s])

    hs = sh.embed(cfg, tokens)
    for i in range(cfg.n_layers):
        layer = sh.layer(i)
        hs = _attn_block(sh, layer, hs, sids, (b, c), _rope_seq(sh.cfg, pos),
                         lambda s, q, k, v, i=i: attend(i, s, q, k, v))
        hs = _mlp_block(sh, layer, hs, sids)
    return sh.logits(cfg, hs)


def extend_step(cfg: ModelConfig, params: Params, cache: Params,
                tokens: torch.Tensor, positions: torch.Tensor,
                lora_bufs: Params | None = None,
                slot_ids: torch.Tensor | None = None,
                active: torch.Tensor | None = None):
    """C new tokens per row in one forward (port of ``extend_step``):
    ``tokens`` [B, C] write their K/V into row b's lane at ``positions``
    [B, C] and attend every lane position <= their own, causal within the
    new tokens and over the lane's history.  ``active`` [B] bool gates the
    WRITES as in ``decode_step``: an inactive row's cells are rewritten
    with their own old values (the reference's out-of-range address,
    whose update XLA drops), so a frozen row's lane, which may belong to
    a streaming prompt, stays unchanged.  On an int8 cache the new K/V are
    quantized where they land (``_kv_quantize``) and the read is the lane
    dequantized (``_kv_dequantize``).  The cache is updated in place.
    Returns (logits [B, C, V] f32, cache): logits[:, i] is the next-token
    distribution after tokens[:, i].  Over ``data`` each group runs its
    rows."""
    check_supported(cfg)
    if sharding.n_data(cache) > 1:
        return _per_data_group(extend_step, cfg, params, cache, tokens,
                               positions, lora_bufs, slot_ids, active), cache
    b = tokens.shape[0]
    dev = tokens.device
    caches = sharding.parts(cache)
    s_max = caches[0]["k"].shape[2]
    pos = positions.long()
    writes = pos < s_max
    if active is not None:
        writes = writes & active.to(dev)[:, None]
    write_pos = pos.clamp(max=s_max - 1)
    rows = torch.arange(b, device=dev)[:, None]
    quant = "k_scale" in caches[0]
    idx = _on_caches(caches, rows, write_pos, writes)

    def write(dst, new, rows, write_pos, writes):
        keep = writes.view(*writes.shape, *([1] * (new.dim() - 2)))
        dst[rows, write_pos] = torch.where(keep, new.to(dst.dtype),
                                           dst[rows, write_pos])

    def write_and_view(i, s, k, v):
        views = []
        for name, new in (("k", k), ("v", v)):
            lane = caches[s][name][i]
            if not quant:
                write(lane, new, *idx[s])
                views.append(lane)
                continue
            scales = caches[s][f"{name}_scale"][i]
            new, scale = _kv_quantize(new)
            write(scales, scale, *idx[s])
            write(lane, new, *idx[s])
            views.append(_kv_dequantize(lane, scales, k.dtype))
        return tuple(views)

    logits = extend_forward(cfg, params, tokens, positions, lora_bufs,
                            slot_ids, write_and_view)
    lengths = (positions[:, -1] + 1).to(torch.int32)
    for c in caches:
        c["length"].copy_(lengths.to(c["length"].device))
    return logits, cache


# ---------------------------------------------------------------------------
# Chunked prefill (prompts beyond the largest bucket, prefix-hit suffixes)
# ---------------------------------------------------------------------------


def _chunk_attend(q, lane_k, lane_v, start: int):
    """Chunk-vs-lane attention, shared by the lane and paged chunk paths:
    q [1, C, H, hd] against one lane view [S, K, hd] (an int8 lane arrives
    dequantized to q's dtype) through the chunk kernel's wrapper.  Returns
    [1, C, H*hd]."""
    c = q.shape[1]
    return chunk_attention(q.contiguous(), lane_k[None], lane_v[None],
                           start).reshape(1, c, -1)


def chunk_forward(cfg: ModelConfig, params: Params, tokens, pos: np.ndarray,
                  lora_bufs: Params | None, lora_slot: int, last_index: int,
                  write_and_view):
    """The layer loop both chunk paths share: chunk token i at global
    position ``pos[i]`` writes its K/V and attends the lane view through
    ``write_and_view(layer, shard, k [C, K, hd], v) -> (lane_k, lane_v)``
    (the shard's heads; lane views in the activation dtype, dequantized
    from an int8 cache).  Returns the last real token's logits [V] (f32).
    ``pos`` is a host int64 array: where the chunk starts and which cells
    it writes are decided on the host, so no device value steers them."""
    sh = _Shards(cfg, params, lora_bufs)
    dev = sh.trees[0]["embed"].device
    c = pos.shape[0]
    slot_ids = torch.full((1,), int(lora_slot), dtype=torch.int32, device=dev)
    hs = [h[None] for h in sh.embed(cfg, to_device(tokens, dev))]
    pos2d, sids = sh.on(to_device(pos, dev)[None]), sh.on(slot_ids)
    start = int(pos[0])

    def attend(i, s, q, k, v):
        lane_k, lane_v = write_and_view(i, s, k[0], v[0])
        return _chunk_attend(q, lane_k, lane_v, start)

    for i in range(cfg.n_layers):
        layer = sh.layer(i)
        hs = _attn_block(sh, layer, hs, sids, (1, c),
                         _rope_seq(sh.cfg, pos2d),
                         lambda s, q, k, v, i=i: attend(i, s, q, k, v))
        hs = _mlp_block(sh, layer, hs, sids, host_flag=True)
    last = int(last_index)
    return sh.logits(cfg, [hs[0][0, last:last + 1]])[0]


def prefill_with_cache(cfg: ModelConfig, params: Params, cache: Params,
                       tokens, positions, slot: int, lane_end: int,
                       last_index: int, lora_bufs: Params | None = None,
                       lora_slot: int = -1):
    """Chunked prefill: one prompt chunk against cache lane ``slot``.

    The chunk's K/V land in the lane at their absolute positions and its
    queries attend everything cached so far plus causally within the
    chunk (the chunk kernel), so N chunks reproduce a monolithic prefill.
    A padded final chunk's pad positions continue past the prompt; those
    at or past ``S_max`` write nothing (the reference's scatter drops them
    as out of bounds), decided on the host from ``positions`` — so no
    index ever leaves the lane and nothing syncs.  On an int8 cache the
    chunk's K/V are quantized where they land and the chunk attends the
    lane dequantized (``_kv_dequantize``).  The cache is updated in place.
    Over ``data`` the chunk runs on the slot's data group.
    Returns (last_logits [V] f32, cache)."""
    check_supported(cfg)
    if sharding.n_data(cache) > 1:
        g, cg, row = _data_slot(cache, slot)
        logits, _ = prefill_with_cache(
            cfg, sharding.in_group(params, g), cg, tokens, positions, row,
            lane_end, last_index, sharding.in_group(lora_bufs, g), lora_slot)
        return logits.to(sharding.parts(cache)[0]["k"].device), cache
    pos = np.asarray(positions, dtype=np.int64)  # numpy or a CPU tensor
    caches = sharding.parts(cache)
    s_max = caches[0]["k"].shape[2]
    inside = np.nonzero(pos < s_max)[0]
    idx = [(to_device(inside, c["k"].device),
            to_device(pos[inside], c["k"].device)) for c in caches]
    slot = int(slot)
    quant = "k_scale" in caches[0]

    def write_and_view(i, s, k, v):
        rows, cells = idx[s]
        k_lane = caches[s]["k"][i][slot]  # [S_max, K, hd], a view
        v_lane = caches[s]["v"][i][slot]
        if not quant:
            k_lane[cells] = k.index_select(0, rows).to(k_lane.dtype)
            v_lane[cells] = v.index_select(0, rows).to(v_lane.dtype)
            return k_lane, v_lane
        views = []
        for name, lane, new in (("k", k_lane, k), ("v", v_lane, v)):
            scales = caches[s][f"{name}_scale"][i][slot]
            lane[cells], scales[cells] = _kv_quantize(new.index_select(0, rows))
            views.append(_kv_dequantize(lane, scales, new.dtype))
        return tuple(views)

    last_logits = chunk_forward(cfg, params, tokens, pos, lora_bufs,
                                lora_slot, last_index, write_and_view)
    for c in caches:
        c["length"][slot] = int(lane_end)
    return last_logits, cache


def insert_prefill(cache: Params, k_prompt: torch.Tensor,
                   v_prompt: torch.Tensor, slot: int, length: int) -> Params:
    """Insert a prefilled sequence's KV ``[L, 1, S, K, hd]`` into decode
    slot ``slot`` (in place), quantized on an int8 cache.  ``length`` is the
    true prompt length; the padded tail is garbage, masked by
    ``cache['length']``.  A sharded cache takes each shard's KV heads,
    in the slot's data group."""
    if sharding.n_data(cache) > 1:
        _, cg, row = _data_slot(cache, slot)
        insert_prefill(cg, k_prompt, v_prompt, row, length)
        return cache
    for c, heads in sharding.kv_parts(cache):
        s = min(k_prompt.shape[2], c["k"].shape[2])
        for name, prompt in (("k", k_prompt), ("v", v_prompt)):
            new = prompt[:, 0, :s, heads].to(c[name].device)
            if f"{name}_scale" in c:
                new, c[f"{name}_scale"][:, slot, :s] = _kv_quantize(new)
            c[name][:, slot, :s] = new.to(c[name].dtype)
        c["length"][slot] = length
    return cache
