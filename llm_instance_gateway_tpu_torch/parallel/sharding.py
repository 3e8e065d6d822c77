"""Megatron tensor parallelism as per-shard trees (port of
``parallel/sharding.py``: ``param_specs``, ``cache_specs``,
``paged_cache_specs``, ``lora_specs`` and ``shard_pytree``).

The reference annotates one tree with ``PartitionSpec``s and lets GSPMD
place the blocks; here a sharded tree is a ``Shards`` list with one
ordinary port tree per ``tensor`` shard — the tree of the local config
(``TensorParallel.cfg``: ``n_heads / t`` query heads, ``n_kv_heads / t``
KV heads or all of them when they are replicated, ``d_ff / t``) — and
one process drives every shard (``models/transformer.py``'s shard loop).

The splits, the reference's:

- column-parallel, over the output axis: ``wq`` / ``wk`` / ``wv`` (by
  heads, with the Qwen biases) and ``w_gate`` / ``w_up`` (over F, for
  expert stacks too);
- row-parallel, over the input axis: ``wo`` and ``w_down``; their
  partial products are summed across shards (``TensorParallel.residual``),
  the one reduction after ``wo`` and the one after ``w_down`` per layer;
- int8 ``{"q", "s"}`` leaves as ``shard_pytree`` splits them: ``q`` as
  the dense weight, the per-output-channel scale with a column split and
  whole on a row split;
- KV caches (lanes, the paged pool, the int8 scales) over their KV-head
  axis, replicated when ``n_kv_heads % t != 0`` (MQA, ``cache_specs``);
- LoRA: a column target keeps ``a`` whole and splits ``b`` on d_out
  (``lora_specs``); a row target (``o``, ``down``) splits ``a`` on d_in
  and keeps ``b`` whole — ``(x_s @ a_s) @ b`` is linear, so each shard
  adds its delta to its partial before the reduction and the sum is the
  reference's ``(x @ a) @ b``;
- everything else (embeddings, ``lm_head``, norms, the MoE router)
  whole on every shard: sampling, penalties and logprobs see the full
  ``[B, V]`` logits on the first shard's device, and every shard routes
  the same tokens to the same experts.

Shards on one device share their whole leaves (one tensor, not a copy),
and their split leaves are views of the caller's tree; a replicated KV
cache is one cache, and the paged tables and lengths are one tensor.
Shards on distinct cards hold copies, and the reduction is
``torch.cuda.nccl.all_reduce`` over the per-card partials (single-process
NCCL): a shard set is either on one device or on as many devices as
shards.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from llm_instance_gateway_tpu_torch.models import lora as lora_lib
from llm_instance_gateway_tpu_torch.models.configs import ModelConfig
from llm_instance_gateway_tpu_torch.ops.quant import is_quantized
from llm_instance_gateway_tpu_torch.ops.sharded_attention import mesh_supports

# Layer leaves split on their last (output) axis, on axis -2 (input).
_COLUMN = ("wq", "wk", "wv", "wq_b", "wk_b", "wv_b", "w_gate", "w_up")
_ROW = ("wo", "w_down")
_KV_LEAVES = ("wk", "wv", "wk_b", "wv_b")
_LORA_COLUMN = ("q", "k", "v", "gate", "up")
_LORA_ROW = ("o", "down")


def local_cfg(cfg: ModelConfig, t: int) -> ModelConfig:
    """The config of one shard of a ``tensor=t`` split."""
    kv_split = cfg.n_kv_heads % t == 0
    return dataclasses.replace(
        cfg, n_heads=cfg.n_heads // t,
        n_kv_heads=cfg.n_kv_heads // t if kv_split else cfg.n_kv_heads,
        d_ff=cfg.d_ff // t, head_dim=cfg.resolved_head_dim)


class TensorParallel:
    """How ``cfg`` splits over a mesh's ``tensor`` axis, and the per-layer
    reduction.  Raises ``ValueError`` for a layout the kernels cannot run
    shard-local (``mesh_supports``) and for a split that leaves uneven
    ffn columns."""

    def __init__(self, cfg: ModelConfig, mesh):
        t = mesh.shape["tensor"]
        if not mesh_supports(cfg, mesh):
            raise ValueError(
                f"tensor={t} does not split {cfg.name}'s "
                f"{cfg.n_heads}:{cfg.n_kv_heads} head layout group-aligned "
                "(query heads must split evenly, and tensor must divide the "
                "KV heads or the KV head be one): the port runs attention "
                "only through its kernels, one call per shard, and has no "
                "XLA-style fallback for such a layout")
        if cfg.d_ff % t:
            raise ValueError(f"tensor={t} does not divide d_ff={cfg.d_ff}")
        self.t = t
        self.devices = list(mesh.devices)
        distinct = len(set(self.devices))
        if distinct not in (1, t):
            raise ValueError(
                f"tensor={t} over {distinct} distinct devices: the shards "
                "must sit all on one device or each on its own")
        self.one_device = distinct == 1
        self.kv_split = cfg.n_kv_heads % t == 0
        self.cfg = local_cfg(cfg, t)

    def kv_heads(self, s: int) -> slice:
        """Shard ``s``'s KV heads in the full layout."""
        if not self.kv_split:
            return slice(None)
        k = self.cfg.n_kv_heads
        return slice(s * k, (s + 1) * k)

    def residual(self, hs: list, parts: list) -> list:
        """The residual stream per shard after a row-parallel block:
        ``hs[s] + sum(parts)``, summed in shard order on one device, by
        one NCCL all-reduce across cards."""
        if self.one_device:
            total = parts[0]
            for p in parts[1:]:
                total = total + p
            return [hs[0] + total] * self.t
        torch.cuda.nccl.all_reduce(parts)
        return [h + p for h, p in zip(hs, parts)]

    def on(self, s: int, x):
        """``x`` on shard ``s``'s device (itself where it lies there)."""
        if x is None or self.one_device:
            return x
        return x.to(self.devices[s])


class Shards(list):
    """One tree per ``tensor`` shard, in shard order, with the
    ``TensorParallel`` that split them."""

    def __init__(self, trees, tp: TensorParallel):
        super().__init__(trees)
        self.tp = tp


def parts(tree) -> list:
    """The per-shard trees of a sharded tree; ``[tree]`` for a plain one."""
    return list(tree) if isinstance(tree, Shards) else [tree]


def distinct(trees: list) -> list:
    """``trees`` without repeats, by identity (shards sharing one cache,
    or one tables tensor)."""
    seen, out = set(), []
    for t in trees:
        if id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


def _split(x: torch.Tensor, axis: int | None, s: int, t: int) -> torch.Tensor:
    if axis is None:
        return x
    n = x.shape[axis] // t
    return x.narrow(axis, s * n, n)


def _place(x, dev: torch.device, tp: TensorParallel):
    """A shard's leaf on its device: the view itself on one device (the
    tree is there already, ``_on_device``), a copy on another card."""
    if tp.one_device:
        return x
    return x.to(dev).contiguous()


def _on_device(tree, tp: TensorParallel):
    """Shards on one device: the whole tree moved there once (a no-op for
    a tree already there), so their leaves are views of one copy."""
    if not tp.one_device:
        return tree
    if isinstance(tree, dict):
        return {k: _on_device(v, tp) for k, v in tree.items()}
    return tree.to(tp.devices[0])


def _leaf(x, axis: int | None, s: int, tp: TensorParallel):
    """Shard ``s`` of a leaf split on ``axis`` (None: whole); an int8
    leaf's scale follows a column split and stays whole on a row split."""
    dev = tp.devices[s]
    if is_quantized(x):
        scale_axis = -1 if axis == -1 else None
        return {"q": _place(_split(x["q"], axis, s, tp.t), dev, tp),
                "s": _place(_split(x["s"], scale_axis, s, tp.t), dev, tp)}
    return _place(_split(x, axis, s, tp.t), dev, tp)


def _layer_axis(name: str, tp: TensorParallel) -> int | None:
    if name in _KV_LEAVES and not tp.kv_split:
        return None
    if name in _COLUMN:
        return -1
    if name in _ROW:
        return -2
    return None


def shard_params(params: dict, tp: TensorParallel) -> Shards:
    """The per-shard trees of a port params tree (dense or int8)."""
    params = _on_device(params, tp)
    trees = []
    for s in range(tp.t):
        tree = {k: _leaf(v, None, s, tp) for k, v in params.items()
                if k != "layers"}
        tree["layers"] = {name: _leaf(leaf, _layer_axis(name, tp), s, tp)
                          for name, leaf in params["layers"].items()}
        trees.append(tree)
    return Shards(trees, tp)


def _lora_axis(key: str, tp: TensorParallel) -> int | None:
    target, _, part = key.rpartition("_")
    if target in ("k", "v") and not tp.kv_split:
        return None
    if target in _LORA_COLUMN and part == "b":
        return -1
    if target in _LORA_ROW and part == "a":
        return -2
    return None


def shard_lora(bufs: dict, tp: TensorParallel) -> Shards:
    """The per-shard LoRA slot buffers of a full buffer tree."""
    bufs = _on_device(bufs, tp)
    return Shards([{k: _leaf(v, _lora_axis(k, tp), s, tp)
                    for k, v in bufs.items()} for s in range(tp.t)], tp)


def _adapter_part(adapter: dict, s: int, tp: TensorParallel) -> dict:
    """Shard ``s`` of an adapter's ``{target: {"a", "b"}}`` weights."""
    out = {}
    for t, ab in adapter.items():
        out[t] = {}
        for part in ("a", "b"):
            x = ab[part]
            x = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
            out[t][part] = _split(x, _lora_axis(f"{t}_{part}", tp), s, tp.t)
    return out


def write_adapter(bufs, cfg: ModelConfig, slot: int, adapter: dict,
                  alpha: float, rank: int) -> None:
    """``lora.write_adapter`` on every shard of ``bufs`` (a plain tree:
    the one write)."""
    if not isinstance(bufs, Shards):
        lora_lib.write_adapter(bufs, cfg, slot, adapter, alpha, rank)
        return
    tp = bufs.tp
    for s, part in enumerate(bufs):
        lora_lib.write_adapter(part, tp.cfg, slot,
                               _adapter_part(adapter, s, tp), alpha, rank)


def clear_adapter(bufs, cfg: ModelConfig, slot: int) -> None:
    """``lora.clear_adapter`` on every shard of ``bufs``."""
    if not isinstance(bufs, Shards):
        lora_lib.clear_adapter(bufs, cfg, slot)
        return
    for part in bufs:
        lora_lib.clear_adapter(part, bufs.tp.cfg, slot)


def shard_cache(make: Callable[[ModelConfig, torch.device], dict],
                tp: TensorParallel) -> Shards:
    """Per-shard caches, ``make(local cfg, device)`` each: KV heads split
    over the shards, or (MQA) replicated — one cache on one device.
    Shards on one device share the paged tables and the lengths."""
    trees: list[dict] = []
    for s, dev in enumerate(tp.devices):
        if s and tp.one_device and not tp.kv_split:
            trees.append(trees[0])
            continue
        cache = make(tp.cfg, dev)
        if s and tp.one_device:
            for name in ("tables", "length"):
                if name in cache:
                    cache[name] = trees[0][name]
        trees.append(cache)
    return Shards(trees, tp)


def kv_parts(cache) -> list[tuple[dict, slice]]:
    """(cache, its KV heads in the full layout) per distinct shard cache;
    ``[(cache, slice(None))]`` for a plain one."""
    if not isinstance(cache, Shards):
        return [(cache, slice(None))]
    out, seen = [], set()
    for s, c in enumerate(cache):
        if id(c) not in seen:
            seen.add(id(c))
            out.append((c, cache.tp.kv_heads(s)))
    return out
