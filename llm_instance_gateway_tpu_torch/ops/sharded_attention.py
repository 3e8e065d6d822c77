"""The attention kernels under a tensor-parallel mesh (port of
``ops/sharded_attention.py``).

Attention is embarrassingly parallel over (batch row, KV-head group), so
a shard's call over its local heads IS the global computation restricted
to them: the sharded forward (``models/transformer.py``) calls each
kernel wrapper once per shard, on that shard's q heads and KV heads
(``parallel/sharding.py`` lays the caches out per shard), and the
reduction tensor parallelism needs stays in ``wo``.  The wrappers are the
single-device ones, unchanged — all six serving kernels (flash prefill,
chunk, lane decode bf16 and int8, paged decode bf16 and int8), where the
reference's ``shard_map`` wrappers cover flash prefill and lane decode and
read the pool and the chunk through XLA einsums.

A contiguous split of the query heads is group-aligned iff ``tensor``
divides ``n_kv_heads`` (each shard gets whole KV groups) or
``n_kv_heads == 1`` (MQA: the one KV head is replicated and every local
query head maps to it); ``mesh_supports`` gates on exactly that.  The
reference serves other layouts through XLA attention; the port has no
such route (on a CUDA tensor a wrapper launches its kernel or raises), so
the engine refuses them at construction.

Over ``data`` each data group calls the wrappers on its own block of
rows (the reference's ``_batch_axis``: the batch over ``data`` when it
divides).  The reference replicates a batch that ``data`` does not
divide and falls back to XLA attention; the port has no such route
either, so ``Engine(...)`` refuses a ``decode_slots`` that ``data`` does
not divide, by name.
"""

from __future__ import annotations

from llm_instance_gateway_tpu_torch.models.configs import ModelConfig


def mesh_supports(cfg: ModelConfig, mesh) -> bool:
    """True iff the kernels can run shard-local on this mesh.

    Requirements (see module docstring): the ``tensor`` split must be
    group-aligned for GQA, and query heads must split evenly.  ``data``
    is gated on the batch, not the layout (``Engine``: ``decode_slots``
    divisible by ``data``).
    """
    t = mesh.shape.get("tensor", 1)
    if t == 1:
        return True
    if cfg.n_heads % t != 0:
        return False
    return cfg.n_kv_heads == 1 or cfg.n_kv_heads % t == 0
