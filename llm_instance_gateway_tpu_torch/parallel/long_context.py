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
sequence group 0 holds: decode ignores the ``sequence`` axis.  Where
``sequence`` spans processes each process runs its own blocks
(``shard_inputs`` gives them), the K/V comes whole to every process (the
exchange in ``transformer.prefill_layer``), each inserts it into its own
replicated cache, and ``logits_row`` hands every process the row its
sampler reads from the process that computed it.  Over
``data`` a ring prefill runs inside one data group (its slot's): the
sequence blocks sit on that group's devices, as the reference's
``MeshConfig(sequence=n, data=8 // n)`` meshes place them.
"""

from __future__ import annotations

import torch

from llm_instance_gateway_tpu_torch.models import transformer
from llm_instance_gateway_tpu_torch.models.configs import ModelConfig
from llm_instance_gateway_tpu_torch.parallel import collectives, sharding
from llm_instance_gateway_tpu_torch.parallel.ring_attention import (
    ring_attention_blocks,
)


def ring_attend(s, qs, ks, vs, first: int = 0):
    """``prefill``'s attention seam: tensor shard ``s``'s blocks around
    the ring (each shard attends its own heads); ``qs`` from block
    ``first`` on where the sequence spans processes."""
    return ring_attention_blocks(qs, ks, vs, causal=True, first=first)


def make_sharded_prefill(cfg: ModelConfig, mesh):
    """The sequence-parallel prefill over ``mesh``: ``fn(params, tokens,
    positions, lora_bufs=None, slot_ids=None) -> (logits [B, S, V] f32, k
    [L, B, S, K, hd], v)``, with ``params`` and ``lora_bufs`` sharded over
    the mesh (``sharding.shard_params`` / ``shard_lora``) and ``tokens`` /
    ``positions`` its sequence blocks (``shard_inputs``) in data group
    ``data_group``: across processes this process's blocks, and the
    logits theirs (``logits_row``)."""
    n = mesh.shape["sequence"]

    def fn(params, tokens, positions, lora_bufs=None, slot_ids=None,
           data_group=0):
        tree = sharding.in_group(params, data_group)
        mine = len(tree.tp.seq_local)
        if len(tokens) != mine or len(tree.groups) != n:
            raise ValueError(f"sequence={n} takes {mine} blocks over {n} "
                             f"sequence groups, got {len(tokens)} over "
                             f"{len(tree.groups)}")
        return transformer.prefill(cfg, params, tokens, positions,
                                   lora_bufs=lora_bufs, slot_ids=slot_ids,
                                   attention_fn=ring_attend,
                                   data_group=data_group)
    return fn


def shard_inputs(mesh, tokens: torch.Tensor, positions: torch.Tensor,
                 data_group: int = 0):
    """``tokens`` and ``positions`` ``[B, S]`` as n sequence blocks ``[B,
    S / n]``, block j on the device of sequence shard j (the first of
    data group ``data_group``'s positions at that block: tensor, expert
    and fsdp shard 0 in one process); across processes this process's
    blocks only, on its device.  Raises ``ValueError`` when n does not
    divide S."""
    n = mesh.shape["sequence"]
    if tokens.shape[1] % n:
        raise ValueError(f"sequence length {tokens.shape[1]} is not "
                         f"divisible by sequence={n}")
    devices: dict = {}
    for i in range(mesh.size):
        c = mesh.coords(i)
        if c[0] == data_group and mesh.local(i):
            devices.setdefault(c[-1], mesh.devices[i])
    return tuple([blk.to(devices[j]) for j, blk in enumerate(x.chunk(n, dim=1))
                  if j in devices]
                 for x in (tokens, positions))


def logits_row(tree, logits: torch.Tensor, pos: int) -> torch.Tensor:
    """The logits ``[B, V]`` at prompt position ``pos`` of a ring
    prefill's ``logits`` over ``tree`` (the sharded params it ran on): a
    slice where this process holds every block, else the row of the
    process whose block holds ``pos``, broadcast over the sequence group
    to every process (each samples the same first token)."""
    tp = tree.tp
    if tp.seq_group is None:
        return logits[:, pos]
    s_loc = logits.shape[1] // len(tp.seq_local)
    owner = pos // s_loc
    row = (logits[:, pos - tp.seq_local[0] * s_loc]
           if owner in tp.seq_local else torch.empty_like(logits[:, 0]))
    return collectives.broadcast(row, owner // len(tp.seq_local),
                                 tp.seq_group)
