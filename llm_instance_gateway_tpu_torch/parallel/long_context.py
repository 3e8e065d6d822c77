"""Long-context prefill: the full model forward with ring attention (port
of ``parallel/long_context.py``).

A prompt splits over the mesh's ``sequence`` axis into n blocks; each
block runs the projections, the MLP and the norms on its own sequence
group of the shard grid (``parallel/sharding.py``: the params replicated
over ``sequence``, split over ``tensor`` and ``expert`` inside a group),
and attention rotates K/V blocks around the ring per tensor shard
(``parallel/ring_attention.py``).  RoPE runs at the global positions.

Usage::

    fn = make_sharded_prefill(cfg, mesh)
    logits, k, v = fn(params, *shard_inputs(mesh, tokens, positions))

Constraints, the reference's: right-padded batches (the ring is causal
only) and a sequence length divisible by ``sequence``.  The logits and
the prompt KV come back whole on the first shard's device (the
reference's ``gather_kv``), ready to insert into the decode cache, which
sequence group 0 holds: decode ignores the ``sequence`` axis.  Over
``data`` a ring prefill runs inside one data group (its slot's): the
sequence blocks sit on that group's devices, as the reference's
``MeshConfig(sequence=n, data=8 // n)`` meshes place them.
"""

from __future__ import annotations

import torch

from llm_instance_gateway_tpu_torch.models import transformer
from llm_instance_gateway_tpu_torch.models.configs import ModelConfig
from llm_instance_gateway_tpu_torch.parallel import sharding
from llm_instance_gateway_tpu_torch.parallel.ring_attention import (
    ring_attention_blocks,
)


def _ring(s, qs, ks, vs):
    """``prefill``'s attention seam: tensor shard ``s``'s blocks around
    the ring (each shard attends its own heads)."""
    return ring_attention_blocks(qs, ks, vs, causal=True)


def make_sharded_prefill(cfg: ModelConfig, mesh):
    """The sequence-parallel prefill over ``mesh``: ``fn(params, tokens,
    positions, lora_bufs=None, slot_ids=None) -> (logits [B, S, V] f32, k
    [L, B, S, K, hd], v)``, with ``params`` and ``lora_bufs`` sharded over
    the mesh (``sharding.shard_params`` / ``shard_lora``) and ``tokens`` /
    ``positions`` its sequence blocks (``shard_inputs``) in data group
    ``data_group``."""
    n = mesh.shape["sequence"]

    def fn(params, tokens, positions, lora_bufs=None, slot_ids=None,
           data_group=0):
        groups = sharding.in_group(params, data_group).groups
        if len(tokens) != n or len(groups) != n:
            raise ValueError(f"sequence={n} takes {n} blocks over {n} "
                             f"sequence groups, got {len(tokens)} over "
                             f"{len(groups)}")
        return transformer.prefill(cfg, params, tokens, positions,
                                   lora_bufs=lora_bufs, slot_ids=slot_ids,
                                   attention_fn=_ring, data_group=data_group)
    return fn


def shard_inputs(mesh, tokens: torch.Tensor, positions: torch.Tensor,
                 data_group: int = 0):
    """``tokens`` and ``positions`` ``[B, S]`` as n sequence blocks ``[B,
    S / n]``, block j on the device of sequence shard j (tensor, expert
    and fsdp shard 0 of data group ``data_group``).  Raises
    ``ValueError`` when n does not divide S."""
    n = mesh.shape["sequence"]
    if tokens.shape[1] % n:
        raise ValueError(f"sequence length {tokens.shape[1]} is not "
                         f"divisible by sequence={n}")
    devices = [mesh.devices[mesh.device_index(data=data_group, sequence=j)]
               for j in range(n)]
    return tuple([blk.to(dev) for blk, dev in zip(x.chunk(n, dim=1),
                                                   devices)]
                 for x in (tokens, positions))
