"""The attention kernels under a tensor-parallel mesh (port of
``ops/sharded_attention.py``).

Attention is embarrassingly parallel over (batch row, KV-head group), so
a shard's call over its local heads IS the global computation restricted
to them: the sharded forward (``models/transformer.py``) calls each
kernel wrapper once per shard, on that shard's q heads and KV heads
(``parallel/sharding.py`` lays the weights and caches out per shard), and
the reduction tensor parallelism needs stays in ``wo``.  The wrappers are
the single-device ones, unchanged — all six serving kernels (flash
prefill, chunk, lane decode bf16 and int8, paged decode bf16 and int8),
where the reference's ``shard_map`` wrappers cover flash prefill and lane
decode and read the pool and the chunk through XLA einsums.

A contiguous split of the query heads is group-aligned iff ``tensor``
divides ``n_kv_heads`` (each shard gets whole KV groups) or
``n_kv_heads == 1`` (MQA: the one KV head is replicated and every local
query head maps to it); ``mesh_supports`` gates on exactly that, as the
reference's does.  The reference serves every other layout through XLA
attention.  The port has no such route (on a CUDA tensor a wrapper
launches its kernel or raises), so it serves them through a head plan
(``head_plan``) that keeps every shard's kernel call group-aligned, as
vLLM does:

- the KV heads are padded with zero heads to ``K'``: ``K`` itself where
  ``tensor`` divides it or it divides ``tensor``, else the smallest
  multiple of ``tensor`` above ``K`` (``K > t``) or the smallest divisor
  of ``tensor`` above it (``K < t``);
- with ``K' >= t`` each shard holds ``K' / t`` KV heads and all ``G =
  H / K`` query heads of each (a zero KV head's query heads are zero
  heads too);
- with ``K' < t`` the ``r = t / K'`` shards of each KV head hold a
  replica of it and ``G' = ceil(G / r)`` of its query heads each, the
  group padded with zero heads from ``G`` to ``r G'``.

Every shard then holds the same local layout (``G'`` query heads per KV
head); Qwen2.5-7B's 28:4 at tensor=8 is 4:1 a shard, each KV head on two
shards and each group of 7 padded to 8.  A zero query head has zero
``wq`` columns, bias and LoRA ``q`` columns and meets only zero ``wo``
rows (and LoRA ``o`` rows), so it adds nothing; a zero KV head has zero
``wk`` / ``wv`` columns and biases, so its cache holds zeros (an int8
zero quantizes to 0 at the 1e-8 scale floor).  Training runs on the plan
too (``training/train.py``): the zero heads' gradients are zeroed and a
replicated KV head's summed over the shards that hold it.

Over ``data`` each data group calls the wrappers on its own block of
rows (the reference's ``cache_specs``: the batch over ``data``).  The
reference cannot place a batch that ``data`` does not divide (its
``jax.device_put`` of the cache raises), so the port refuses such a
``decode_slots`` at ``Engine(...)``, by name, as a matter of parity.
"""

from __future__ import annotations

import dataclasses

from llm_instance_gateway_tpu_torch.models.configs import ModelConfig


def mesh_supports(cfg: ModelConfig, mesh) -> bool:
    """True iff the kernels can run shard-local on this mesh with a
    contiguous head split (the reference's gate).

    Requirements (see module docstring): the ``tensor`` split must be
    group-aligned for GQA, and query heads must split evenly.  ``data``
    is gated on the batch, not the layout (``Engine``: ``decode_slots``
    divisible by ``data``).  Every other layout serves through
    ``head_plan``'s padded and replicated heads.
    """
    t = mesh.shape.get("tensor", 1)
    if t == 1:
        return True
    if cfg.n_heads % t != 0:
        return False
    return cfg.n_kv_heads == 1 or cfg.n_kv_heads % t == 0


@dataclasses.dataclass(frozen=True)
class HeadPlan:
    """The heads each of ``tensor`` shards holds, in its local order:
    ``q_heads[s]`` and ``kv_heads[s]`` are global head indices, -1 a zero
    (padding) head.  Every shard holds ``n_heads`` query heads and
    ``n_kv_heads`` KV heads, ``n_heads / n_kv_heads`` query heads per
    local KV head."""

    n_heads_global: int
    n_kv_heads_global: int
    q_heads: tuple
    kv_heads: tuple

    @property
    def t(self) -> int:
        return len(self.q_heads)

    @property
    def n_heads(self) -> int:
        return len(self.q_heads[0])

    @property
    def n_kv_heads(self) -> int:
        return len(self.kv_heads[0])

    @property
    def padded(self) -> bool:
        """Whether any shard holds a zero head."""
        return any(h < 0 for heads in self.q_heads + self.kv_heads
                   for h in heads)

    @property
    def replicas(self) -> int:
        """Shards holding each KV head (1: every shard its own)."""
        return self.kv_heads.count(self.kv_heads[0])

    @property
    def contiguous(self) -> bool:
        """Whether this is the reference's contiguous split (no zero
        heads, and no KV head on some shards but not all): exactly where
        ``mesh_supports`` holds."""
        return not self.padded and (self.replicas == 1
                                    or self.n_kv_heads_global == 1)

    def describe(self) -> str:
        """The layout by name: ``H:K over tensor=t, local h:k`` with its
        replicas and padding."""
        out = (f"{self.n_heads_global}:{self.n_kv_heads_global} over "
               f"tensor={self.t}, {self.n_heads}:{self.n_kv_heads} a shard")
        if self.replicas > 1 and self.n_kv_heads_global > 1:
            out += f", each KV head on {self.replicas} shards"
        if self.padded:
            n_q = sum(h < 0 for heads in self.q_heads for h in heads)
            n_kv = sum(h < 0 for heads in self.kv_heads for h in heads)
            out += f", {n_q} zero query heads and {n_kv} zero KV heads"
        return out


def head_plan(cfg: ModelConfig, t: int) -> HeadPlan:
    """The heads of each of ``t`` tensor shards (module docstring): a
    contiguous split where ``mesh_supports``, else padded and replicated
    KV heads and padded query groups, every shard group-aligned."""
    h, k = cfg.n_heads, cfg.n_kv_heads
    g = h // k
    if k % t == 0 or t % k == 0:
        kp = k
    elif k > t:
        kp = -(-k // t) * t
    else:
        kp = min(d for d in range(k, t + 1) if t % d == 0)
    if kp >= t:
        n = kp // t
        kv = [tuple(x if x < k else -1 for x in range(s * n, (s + 1) * n))
              for s in range(t)]
        q = [tuple(x * g + j if x >= 0 else -1 for x in heads
                   for j in range(g)) for heads in kv]
    else:
        r = t // kp
        gl = -(-g // r)
        kv = [((s // r) if s // r < k else -1,) for s in range(t)]
        q = [tuple(x * g + (s % r) * gl + j
                   if x >= 0 and (s % r) * gl + j < g else -1
                   for j in range(gl)) for s, (x,) in enumerate(kv)]
    return HeadPlan(h, k, tuple(q), tuple(kv))
