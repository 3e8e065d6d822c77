"""The shard grid: ``data`` groups, parameters split over ``fsdp``,
Megatron tensor parallelism, MoE experts over ``expert`` and parameter
replicas over ``sequence``, as per-shard trees (port of
``parallel/sharding.py``: ``param_specs``, ``cache_specs``,
``paged_cache_specs``, ``lora_specs`` and ``shard_pytree``).

The reference annotates one tree with ``PartitionSpec``s and lets GSPMD
place the blocks; here a sharded tree is a ``Shards`` list with one
ordinary port tree per shard — the tree of the local config
(``TensorParallel.cfg``: ``n_heads / t`` query heads, ``n_kv_heads / t``
KV heads or all of them when they are replicated, ``d_ff / t``) — and
one process drives every shard (``models/transformer.py``'s shard loop).
``TensorParallel`` is the grid's one home: which shard sits on which
device, the local config, and the reduction after a row-parallel block.

The grid, over a mesh's ``data`` (d), ``fsdp`` (f), ``tensor`` (t),
``expert`` (e) and ``sequence`` (n) axes (``pipe`` is the pipelined
trainer's, ``parallel/pipeline.py``; serving refuses it):

- ``data``: each data group is a whole grid of the axes below, holding
  its own contiguous block of ``decode_slots / d`` lane rows (the
  reference's ``cache_specs``: ``P(None, "data", ...)`` for ``k``, ``v``,
  ``length`` and the int8 scales).  ``Shards.data[g]`` is group g's
  ``Shards`` (``data[0]`` the list itself); on one device its trees are
  group 0's and its cache a view of its rows of one cache, on distinct
  cards copies.  A decode, extend or chunk step runs each group on its
  rows (``models/transformer.py``);
- ``fsdp``: every leaf ``param_specs`` or ``lora_specs`` puts over
  ``fsdp`` is an ``FsdpLeaf``, split in f contiguous pieces along that
  axis: the ``D`` rows of ``wq`` / ``wk`` / ``wv`` / ``w_gate`` / ``w_up``
  (expert stacks too), the ``D`` columns of ``wo`` / ``w_down``, the rows
  of ``lm_head`` and the LoRA ``o_b`` / ``down_b`` d_out.  An int8 leaf
  follows ``shard_pytree``: ``q`` splits as the dense weight, the scale
  takes the spec minus its contracted axis (split for ``wo`` / ``w_down``,
  whole for the others).  Piece i sits on the device of fsdp position i;
  indexing a layer gathers it whole on position 0's device, which alone
  computes (the other positions only store): a ``torch.cat`` of views on
  one device, one single-process ``torch.cuda.nccl.all_gather`` across
  cards.  Everything else (norms, biases, embeddings, the router, the
  caches) sits on position 0's devices only: the reference replicates it
  over ``fsdp`` (``paged_cache_specs``' docstring), and computing once
  needs one copy;
- a *group* of the grid is the t shards of one sequence block, times e
  for an MoE model: shard ``s`` is tensor shard ``s % t`` of expert shard
  ``s // t`` (expert 0's shards first).  Attention runs on the first t
  (expert 0's, replicated over ``expert``), the MLP on all of them; the
  one reduction a block sums the group's partials;
- expert stacks (``w_gate`` / ``w_up`` / ``w_down`` ``[L, E, ...]``, the
  int8 ``{"q", "s"}`` stacks and their ``[L, E, F]`` scales too) split E
  over ``expert``, E/e local experts a shard, and keep F over ``tensor``;
  the router stays whole, so every shard routes the same tokens to the
  same global experts and takes the share of its own
  (``TensorParallel.expert_offset``).  A model without experts serves on
  an ``expert`` mesh as on expert=1: the axis only replicates it, as
  GSPMD would, and the port computes it once, on expert 0's shards;
- ``sequence`` replicates everything: group j is group 0's trees on the
  devices of sequence block j (``Shards.groups``), used by the ring
  prefill alone (``parallel/long_context.py``); decode, bucketed prefill
  and chunks run on group 0, whose devices also hold the KV cache.
  Across processes every process holds whole trees of its sequence
  blocks (``seq_local``) and a KV cache of its own: after the ring each
  inserts the whole prompt's K/V (exchanged over ``seq_group``) and
  decodes on its replica, every process computing the same tokens.

The splits inside a group, the reference's:

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
  axis, replicated when ``n_kv_heads % t != 0`` (MQA, ``cache_specs``),
  one per tensor shard of group 0;
- LoRA: a column target keeps ``a`` whole and splits ``b`` on d_out
  (``lora_specs``); a row target (``o``, ``down``) splits ``a`` on d_in
  and keeps ``b`` whole — ``(x_s @ a_s) @ b`` is linear, so each shard
  adds its delta to its partial before the reduction and the sum is the
  reference's ``(x @ a) @ b``;
- everything else (embeddings, ``lm_head``, norms, the MoE router)
  whole on every shard: sampling, penalties and logprobs see the full
  ``[B, V]`` logits on the first shard's device.

Shards on one device share their whole leaves (one tensor, not a copy),
their split leaves are views of the caller's tree, and every sequence
and data group is group 0 itself; a replicated KV cache is one cache, and
the paged tables and lengths are one tensor.  Shards on distinct cards
hold copies, and the reduction is ``torch.cuda.nccl.all_reduce`` over the
per-card partials (single-process NCCL): a mesh is either on one device
or on as many devices as shards.

Across processes (a mesh whose positions belong to processes,
``parallel/mesh.py``) a ``Shards`` holds this process's shards only
(``TensorParallel.shards``: their indices in the group, in order), as
copies on its one device: whole leaves one copy its shards share, split
leaves and fsdp pieces one copy each, so the caller's tree can be freed.
A row-parallel block sums the local partials in shard order and then the
processes' sums (``collectives.reduce`` over the attention or the MLP
group); an ``FsdpLeaf`` holds its local pieces and gathers the others
through ``collectives.gather`` on every process, each of which computes
(the one-process rule that fsdp position 0 alone computes cannot hold:
every process needs the replicated result).  ``tensor``, ``expert`` and
``fsdp`` and ``sequence`` may span processes, and ``data`` in training,
one data group a process; ``pipe`` may not (the pipelined trainer over
processes is queued).  With ``expert`` across processes each process
attends over its tensor shards of its first expert (attention is
replicated over ``expert``) and the attention reduction spans ``tensor``
alone.  Across processes every shard sits on the process's one device
(``TensorParallel.device``), whichever sequence block it serves.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
from typing import Callable

import torch

from llm_instance_gateway_tpu_torch.models import lora as lora_lib
from llm_instance_gateway_tpu_torch.models.configs import ModelConfig
from llm_instance_gateway_tpu_torch.ops.quant import is_quantized
from llm_instance_gateway_tpu_torch.ops.sharded_attention import mesh_supports
from llm_instance_gateway_tpu_torch.parallel import collectives

# Layer leaves split on their last (output) axis, on axis -2 (input).
_COLUMN = ("wq", "wk", "wv", "wq_b", "wk_b", "wv_b", "w_gate", "w_up")
_ROW = ("wo", "w_down")
_KV_LEAVES = ("wk", "wv", "wk_b", "wv_b")
# MoE expert stacks ``[L, E, ...]``: E (axis 1) over ``expert``.
_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")
_LORA_COLUMN = ("q", "k", "v", "gate", "up")
_LORA_ROW = ("o", "down")
# The attention block's layer leaves and LoRA targets (the rest is the
# MLP block's).
_ATTN_NAMES = ("attn_norm", "wq", "wk", "wv", "wo", "wq_b", "wk_b", "wv_b",
               "q", "k", "v", "o")
# The leaves ``param_specs`` / ``lora_specs`` put over ``fsdp``, and the
# axis they split on: ``D`` of every projection, d_out of the row
# targets' LoRA ``b``; ``lm_head`` [D, V] on its rows.
_FSDP_LAYER = {"wq": -2, "wk": -2, "wv": -2, "w_gate": -2, "w_up": -2,
               "wo": -1, "w_down": -1}
_FSDP_LORA = {"o_b": -1, "down_b": -1}
_FSDP_TOP = {"lm_head": -2}


def local_cfg(cfg: ModelConfig, t: int) -> ModelConfig:
    """The config of one shard of a ``tensor=t`` split (``n_experts``
    stays global: routing indexes every expert)."""
    kv_split = cfg.n_kv_heads % t == 0
    return dataclasses.replace(
        cfg, n_heads=cfg.n_heads // t,
        n_kv_heads=cfg.n_kv_heads // t if kv_split else cfg.n_kv_heads,
        d_ff=cfg.d_ff // t, head_dim=cfg.resolved_head_dim)


class TensorParallel:
    """The shard grid of ``cfg`` over a mesh's ``data``, ``fsdp``,
    ``tensor``, ``expert`` and ``sequence`` axes (module docstring): where
    each shard sits, the local config and the reduction after a
    row-parallel block.  One object describes data group ``data_index``
    (``group(g)`` gives group g's) and this process's shards of it
    (``shards``, indices into the group; every shard in one process).
    Methods take a shard's position in ``shards``.  Raises ``ValueError``
    for a layout the kernels cannot run shard-local (``mesh_supports``),
    for a split that leaves uneven ffn columns, experts or fsdp pieces,
    for shards on some but not all distinct devices, and, across
    processes, for a process whose shards are not one block of the grid
    on one device or whose axes cannot span processes."""

    def __init__(self, cfg: ModelConfig, mesh):
        shape = mesh.shape
        t, e, n = shape["tensor"], shape["expert"], shape["sequence"]
        d, f = shape.get("data", 1), shape.get("fsdp", 1)
        if f > 1:
            split = {"d_model": cfg.d_model}
            if not cfg.tie_embeddings:
                split["lm_head rows"] = cfg.d_model
            for what, size in split.items():
                if size % f:
                    raise ValueError(f"fsdp={f} does not divide {what}="
                                     f"{size}")
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
        self.moe = bool(cfg.n_experts) and e > 1
        if self.moe and cfg.n_experts % e:
            raise ValueError(f"expert={e} does not divide {cfg.name}'s "
                             f"{cfg.n_experts} experts")
        self.t, self.e, self.n = t, e, n
        self.d, self.f = d, f
        self.mesh = mesh
        # Shards a group: expert 0's t tensor shards, then the others'.
        self.g = t * e if self.moe else t
        self.local_experts = cfg.n_experts // e if self.moe else cfg.n_experts
        self.devices = list(mesh.devices)
        self.multi = mesh.spans_processes
        if self.multi:
            self._own(mesh)
        else:
            self.data_index, self.shards = 0, list(range(self.g))
            self.fsdp_local = list(range(f))
            self.seq_local = list(range(n))
            self.attn_group = self.mlp_group = None
            self.fsdp_group = self.data_group = None
            self.seq_group = self.rows_group = None
        local = {self.devices[i] for i in range(len(self.devices))
                 if mesh.local(i)}
        distinct = len(local)
        if distinct not in (1, mesh.size) or (self.multi and distinct > 1):
            raise ValueError(
                f"mesh {dict(shape)} over {distinct} distinct devices in "
                "this process: the shards must sit all on one device or "
                "each on its own (across processes: a process's on one)")
        self.one_device = distinct == 1
        self.kv_split = cfg.n_kv_heads % t == 0
        self.cfg = local_cfg(cfg, t)
        # Attention runs on the shards of this process's first expert.
        first = self.shards[0] // t
        self.n_attn = sum(1 for s in self.shards if s // t == first)

    def _own(self, mesh) -> None:
        """This process's part of the grid: its data group, its shards,
        fsdp positions and sequence blocks (a block: every local shard at
        every local fsdp position and sequence block) and its process
        groups."""
        shape = mesh.shape
        if shape["pipe"] > 1:
            raise ValueError(
                f"pipe={shape['pipe']} on a mesh across processes: the "
                "pipelined trainer over processes (stage activations sent "
                "point to point) is the next slice queued in ROADMAP.md")
        if not self.moe and shape["expert"] > 1:
            raise ValueError(
                "expert > 1 across processes for a model without experts "
                "(the axis would only replicate it)")
        seen = set()
        for i in range(mesh.size):
            if mesh.local(i):
                dd, ff, _, tt, ee, jj = mesh.coords(i)
                seen.add((dd, ff, (ee * self.t + tt) if self.moe else tt,
                          jj))
                self.local_device = mesh.devices[i]
        groups = sorted({x[0] for x in seen})
        if len(groups) > 1:
            raise ValueError(
                f"data={self.d} puts {len(groups)} data groups in one "
                "process; give each process one")
        self.data_index = groups[0]
        self.shards = sorted({x[2] for x in seen})
        self.fsdp_local = sorted({x[1] for x in seen})
        self.seq_local = sorted({x[3] for x in seen})
        if len(seen) != (len(self.shards) * len(self.fsdp_local)
                         * len(self.seq_local)):
            raise ValueError(
                f"mesh {dict(shape)}: process {mesh.rank}'s positions are "
                "not one block of shards by fsdp positions by sequence "
                "blocks")
        self.attn_group = mesh.group("tensor")
        self.mlp_group = mesh.group("tensor", "expert") if self.moe \
            else self.attn_group
        self.fsdp_group = mesh.group("fsdp")
        self.data_group = mesh.group("data")
        self.seq_group = mesh.group("sequence")
        self.rows_group = mesh.group("data", "sequence")

    def group(self, g: int) -> "TensorParallel":
        """Data group ``g``'s grid (this one's, on that group's devices)."""
        if g == self.data_index:
            return self
        out = copy.copy(self)
        out.data_index = g
        return out

    def _device(self, s: int, j: int = 0, f: int | None = None):
        """Shard ``s`` (an index into the group)'s device in sequence group
        ``j`` at fsdp position ``f`` (default: this process's first);
        across processes this process's one device."""
        if self.multi:
            return self.local_device
        return self.devices[self.mesh.device_index(
            data=self.data_index,
            fsdp=self.fsdp_local[0] if f is None else f,
            tensor=s % self.t, expert=s // self.t, sequence=j)]

    def device(self, k: int, j: int = 0, f: int | None = None):
        """Local shard ``k``'s device in sequence group ``j`` and at fsdp
        position ``f`` of this data group (the mesh's axis order, the last
        axis fastest)."""
        return self._device(self.shards[k], j, f)

    def expert_offset(self, k: int) -> int:
        """The first global expert local shard ``k`` holds."""
        return ((self.shards[k] // self.t) * self.local_experts
                if self.moe else 0)

    def kv_heads(self, k: int) -> slice:
        """Local attention shard ``k``'s KV heads in the full layout."""
        if not self.kv_split:
            return slice(None)
        n, ti = self.cfg.n_kv_heads, self.shards[k] % self.t
        return slice(ti * n, (ti + 1) * n)

    def residual(self, hs: list, parts: list, attn: bool = False) -> list:
        """The residual stream per shard of a group after a row-parallel
        block: ``hs[s] + sum(parts)``, where a ``None`` part adds nothing
        (the attention of expert shards past the first); summed in shard
        order on one device (or a group of one shard), then over the
        processes (the attention's group or the MLP's, ``attn``), by one
        NCCL all-reduce across cards."""
        if self.one_device or len(parts) == 1:
            live = [p for p in parts if p is not None]
            total = live[0]
            for p in live[1:]:
                total = total + p
            total = collectives.reduce(
                total, self.attn_group if attn else self.mlp_group)
            return [hs[0] + total] * len(hs)
        parts = [torch.zeros_like(h) if p is None else p
                 for h, p in zip(hs, parts)]
        torch.cuda.nccl.all_reduce(parts)
        return [h + p for h, p in zip(hs, parts)]

    def enter(self, hs: list, attn: bool = False) -> list:
        """The residual per shard as it enters a column-parallel block:
        across processes through ``collectives.copy`` (once per distinct
        tensor), so its gradient sums every process's shards."""
        group = self.attn_group if attn else self.mlp_group
        if group is None:
            return hs
        done: dict = {}
        for h in hs:
            if id(h) not in done:
                done[id(h)] = collectives.copy(h, group)
        return [done[id(h)] for h in hs]

    def on(self, k: int, x, j: int = 0):
        """``x`` on local shard ``k``'s device of group ``j`` (itself where
        it lies there)."""
        if x is None or self.one_device:
            return x
        return x.to(self.device(k, j))


class Shards(list):
    """One tree per local shard of sequence group 0, in shard order, with
    the ``TensorParallel`` that split them; ``groups[j]`` is group j's
    trees (``groups[0]`` the list itself) and ``data[g]`` data group g's
    ``Shards``, each of one data group (without ``data``: this one;
    across processes None for the groups of other processes)."""

    def __init__(self, trees, tp: TensorParallel, groups=None, data=None):
        super().__init__(trees)
        self.tp = tp
        self.groups = [list(self)] + list(groups or [])[1:]
        self.data = list(data) if data else [self]


def parts(tree) -> list:
    """The per-shard trees of a sharded tree (data group 0's);
    ``[tree]`` for a plain one."""
    return list(tree) if isinstance(tree, Shards) else [tree]


def n_data(tree) -> int:
    """The data groups of a sharded tree (1 for a plain one)."""
    return len(tree.data) if isinstance(tree, Shards) else 1


def in_group(tree, g: int):
    """Data group ``g``'s part of a sharded tree; a plain tree (or None)
    is every group's."""
    return tree.data[g] if isinstance(tree, Shards) else tree


def distinct(trees: list) -> list:
    """``trees`` without repeats, by identity (shards sharing one cache,
    or one tables tensor)."""
    seen, out = set(), []
    for t in trees:
        if id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


# -- fsdp ---------------------------------------------------------------

_local = threading.local()


@contextlib.contextmanager
def gather_streams(streams: dict):
    """Within it, an fsdp gather across cards runs on ``streams`` (device
    -> stream): the shard loop issues layer i+1's gather there while
    layer i computes on the current streams."""
    prev = getattr(_local, "streams", None)
    _local.streams = streams
    try:
        yield
    finally:
        _local.streams = prev


def _gather(pieces: list, axis: int, one_device: bool,
            group=None) -> torch.Tensor:
    """``pieces`` concatenated along ``axis`` on the first piece's
    device: a ``torch.cat`` on one device (then, across processes, the
    fsdp gather of every process's), one single-process NCCL all-gather
    across cards (on the ``gather_streams`` where set)."""
    if one_device:
        x = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=axis)
        return collectives.gather(x, axis, group)
    streams = getattr(_local, "streams", None)
    shape = tuple(pieces[0].shape)
    ins = [p.contiguous() for p in pieces]
    outs = []
    for p in ins:
        with (torch.cuda.stream(streams[p.device]) if streams
              else contextlib.nullcontext()):
            outs.append(torch.empty((len(ins),) + shape, dtype=p.dtype,
                                    device=p.device))
    torch.cuda.nccl.all_gather(
        ins, outs, streams=(None if streams is None
                            else [streams[p.device] for p in ins]))
    pos = len(shape) + axis
    full = shape[:pos] + (len(ins) * shape[pos],) + shape[pos + 1:]
    return outs[0].movedim(0, pos).reshape(full)


class FsdpLeaf:
    """A leaf split over ``fsdp``: ``pieces[i]`` is fsdp position
    ``positions[i]``'s contiguous piece along ``axis`` (negative), on its
    device, of ``total`` pieces (across processes a process holds its own
    positions only, and ``group`` gathers the rest).  Indexing a layer
    (``leaf[i]``, what ``_layer`` and ``lora.layer_slice`` do) gathers
    that layer whole (on position 0's device in one process, on every
    process across them); ``gather()`` the whole leaf; an assignment (the
    LoRA slot writes) writes each local piece its part, so every buffer
    keeps its address."""

    def __init__(self, pieces: list, axis: int, one_device: bool,
                 group=None, positions=None, total: int | None = None):
        self.pieces = pieces
        self.axis = axis
        self.one_device = one_device
        self.group = group
        self.positions = list(positions or range(len(pieces)))
        self.total = total or len(pieces)

    @property
    def shape(self) -> tuple:
        shape = list(self.pieces[0].shape)
        shape[self.axis] *= self.total
        return tuple(shape)

    @property
    def device(self) -> torch.device:
        return self.pieces[0].device

    def __getitem__(self, i: int) -> torch.Tensor:
        if not isinstance(i, int):
            raise TypeError("an fsdp leaf is indexed by layer only")
        return _gather([p[i] for p in self.pieces], self.axis,
                       self.one_device, self.group)

    def gather(self) -> torch.Tensor:
        return _gather(list(self.pieces), self.axis, self.one_device,
                       self.group)

    def __setitem__(self, key, value) -> None:
        n = self.pieces[0].shape[self.axis]
        for f, p in zip(self.positions, self.pieces):
            part = value
            if isinstance(value, torch.Tensor) and value.dim() and (
                    value.shape[self.axis] == n * self.total):
                part = value.narrow(self.axis, f * n, n).to(p.device)
            p[key] = part


def whole(x):
    """A leaf whole: an ``FsdpLeaf`` gathered (an int8 leaf part by
    part), anything else itself."""
    if isinstance(x, FsdpLeaf):
        return x.gather()
    if is_quantized(x):
        return {k: whole(v) for k, v in x.items()}
    return x


def _fsdp(x, axis: int | None, s: int, j: int, tp: TensorParallel, place,
          positions=None):
    """Shard ``s``'s leaf ``x`` (group ``j``) split over ``fsdp`` on
    ``axis`` (None: not split; placed on this process's first fsdp
    position's device), its pieces at ``positions`` (default: this
    process's) placed by ``place(x, device)``; an int8 leaf's scale
    splits only where its spec keeps the axis (not the contracted one,
    -2)."""
    if is_quantized(x):
        return {"q": _fsdp(x["q"], axis, s, j, tp, place, positions),
                "s": _fsdp(x["s"], axis if axis == -1 else None, s, j, tp,
                           place, positions)}
    if axis is None or tp.f == 1:
        return place(x, tp._device(s, j))
    positions = tp.fsdp_local if positions is None else positions
    return FsdpLeaf([place(_split(x, axis, f, tp.f), tp._device(s, j, f))
                     for f in positions], axis, tp.one_device,
                    tp.fsdp_group, positions, tp.f)


def _split(x: torch.Tensor, axis: int | None, s: int, t: int) -> torch.Tensor:
    if axis is None:
        return x
    n = x.shape[axis] // t
    return x.narrow(axis, s * n, n)


def _placer(tp: TensorParallel):
    """``place(x, device)`` for a shard's leaf: the view itself on one
    device in one process (the tree is there already, ``_on_device``), a
    copy on another card; across processes a contiguous copy of its own,
    so the caller's tree can be freed.  One region of the source on one
    device is placed once: shards share their whole leaves (an fsdp piece
    of ``lm_head`` too, whose view each shard cuts anew) as one tensor."""
    memo: dict = {}

    def place(x, dev):
        key = (x.data_ptr(), x.dtype, tuple(x.shape), x.stride(),
               str(x.device), str(dev))
        if key not in memo:
            if tp.multi:
                y = torch.empty(x.shape, dtype=x.dtype, device=dev).copy_(x)
            elif tp.one_device:
                y = x
            else:
                y = x.to(dev).contiguous()
            memo[key] = (x, y)
        return memo[key][1]
    return place


def _on_device(tree, tp: TensorParallel):
    """Shards on one device in one process: the whole tree moved there
    once (a no-op for a tree already there), so their leaves are views of
    one copy."""
    if not tp.one_device or tp.multi:
        return tree
    if isinstance(tree, dict):
        return {k: _on_device(v, tp) for k, v in tree.items()}
    return tree.to(tp.devices[0])


def _leaf(x, axis: int | None, s: int, tp: TensorParallel,
          expert: bool = False):
    """Shard ``s``'s part of a leaf split on ``axis`` over ``tensor``
    (None: whole) and, for an expert stack, on axis 1 over ``expert``;
    an int8 leaf's scale follows a column split and stays whole on a row
    split, and follows the expert split.  Not yet placed (``_fsdp``)."""
    ti = s % tp.t

    def cut(y, ax):
        if expert:
            y = _split(y, 1, s // tp.t, tp.e)
        return _split(y, ax, ti, tp.t)

    if is_quantized(x):
        return {"q": cut(x["q"], axis), "s": cut(x["s"], -1 if axis == -1
                                                  else None)}
    return cut(x, axis)


def _layer_axis(name: str, tp: TensorParallel) -> int | None:
    if name in _KV_LEAVES and not tp.kv_split:
        return None
    if name in _COLUMN:
        return -1
    if name in _ROW:
        return -2
    return None


def _grid(tp: TensorParallel, tree: Callable[[int, int], dict],
          shares: Callable[[int], int]) -> Shards:
    """The ``Shards`` of ``tree(s, j)`` over this process's shards and
    every sequence group of one data group; on one device group j is
    group 0, and shard ``s`` takes shard ``shares(s)``'s tree where the
    two hold the same leaves."""
    groups = []
    for j in range(1 if tp.one_device else tp.n):
        made: dict = {}
        group = []
        for s in tp.shards:
            key = shares(s) if tp.one_device else s
            if key not in made:
                made[key] = tree(s, j)
            group.append(made[key])
        groups.append(group)
    groups += [groups[0]] * (tp.n - len(groups))
    return Shards(groups[0], tp, groups)


def _data_grid(tp: TensorParallel,
               grid: Callable[[TensorParallel], Shards]) -> Shards:
    """``grid(tp of group g)`` for every data group, joined in one
    ``Shards`` (``data[g]``); on one device every group's trees are group
    0's; across processes only this process's group is made."""
    if tp.multi:
        out: list = [None] * tp.d
        out[tp.data_index] = grid(tp)
        mine = out[tp.data_index]
        return Shards(list(mine), tp, mine.groups, out)
    out = [grid(tp)]
    for g in range(1, tp.d):
        tg = tp.group(g)
        out.append(Shards(list(out[0]), tg, out[0].groups)
                   if tp.one_device else grid(tg))
    return Shards(list(out[0]), tp, out[0].groups, out)


def _param_tree(params: dict, s: int, j: int, tp: TensorParallel, place,
                positions=None) -> dict:
    """Shard ``s``'s params tree (group ``j``)."""
    out = {k: _fsdp(v, _FSDP_TOP.get(k), s, j, tp, place, positions)
           for k, v in params.items() if k != "layers"}
    out["layers"] = {
        name: _fsdp(_leaf(leaf, _layer_axis(name, tp), s, tp,
                          tp.moe and name in _EXPERT_LEAVES),
                    _FSDP_LAYER.get(name), s, j, tp, place, positions)
        for name, leaf in params["layers"].items()}
    return out


def shard_params(params: dict, tp: TensorParallel) -> Shards:
    """The per-shard trees of a port params tree (dense or int8)."""
    params = _on_device(params, tp)
    place = _placer(tp)
    return _data_grid(tp, lambda tg: _grid(
        tg, lambda s, j: _param_tree(params, s, j, tg, place), lambda s: s))


def _lora_axis(key: str, tp: TensorParallel) -> int | None:
    target, _, part = key.rpartition("_")
    if target in ("k", "v") and not tp.kv_split:
        return None
    if target in _LORA_COLUMN and part == "b":
        return -1
    if target in _LORA_ROW and part == "a":
        return -2
    return None


def _lora_tree(bufs: dict, s: int, j: int, tp: TensorParallel, place,
               positions=None) -> dict:
    """Shard ``s``'s LoRA slot buffers (group ``j``)."""
    return {k: _fsdp(_leaf(v, _lora_axis(k, tp), s, tp), _FSDP_LORA.get(k),
                     s, j, tp, place, positions)
            for k, v in bufs.items()}


def shard_lora(bufs: dict, tp: TensorParallel) -> Shards:
    """The per-shard LoRA slot buffers of a full buffer tree (an expert
    shard's are its tensor shard's: expert stacks take no LoRA)."""
    bufs = _on_device(bufs, tp)
    place = _placer(tp)
    return _data_grid(tp, lambda tg: _grid(
        tg, lambda s, j: _lora_tree(bufs, s, j, tg, place),
        lambda s: s % tg.t))


def _tensors(leaf) -> list:
    """The tensors of a leaf: an ``FsdpLeaf``'s local pieces, an int8
    leaf's parts."""
    if isinstance(leaf, FsdpLeaf):
        return list(leaf.pieces)
    if isinstance(leaf, dict):
        return [t for v in leaf.values() for t in _tensors(v)]
    return [leaf]


def tensor_replicated(tree: Shards, attn: bool) -> list:
    """The distinct local tensors of a params or LoRA ``Shards`` that
    every tensor shard holds whole and uses inside its attention block
    (``attn``; their gradients summed over the attention group) or its
    MLP block (over the MLP group, which spans ``expert`` too): the layer
    leaves ``tensor`` does not split (norms, the router, replicated K/V
    projections) and the LoRA buffers it does not split, ``scale`` aside.
    Across processes each process's gradient of them is its shards'
    part."""
    tp = tree.tp

    def block(name: str) -> bool:
        return (name in _ATTN_NAMES) == attn

    out, seen = [], set()
    for t in tree:
        if "layers" in t:
            leaves = [leaf for name, leaf in t["layers"].items()
                      if _layer_axis(name, tp) is None and block(name)]
        else:
            leaves = [v for k, v in t.items()
                      if k != "scale" and _lora_axis(k, tp) is None
                      and block(k.rpartition("_")[0])]
        for x in (x for leaf in leaves for x in _tensors(leaf)):
            if id(x) not in seen:
                seen.add(id(x))
                out.append(x)
    return out


def _walk(tree, path=()):
    """(path, leaf) over a nested dict, an ``FsdpLeaf`` or a tensor being
    a leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    else:
        yield path, tree


def unshard(tree: Shards, like: dict) -> dict:
    """The whole tree a params or LoRA ``Shards`` holds, on the host in
    every process: ``like`` (a whole tree of the same layout, the one that
    was sharded for instance) copied and overwritten with every shard's
    values, gathered from every process.  For checks and exports."""
    tp = tree.tp
    mine = {}
    for s, t in zip(tp.shards, tree):
        for path, leaf in _walk(t):
            if isinstance(leaf, FsdpLeaf):
                for f, p in zip(leaf.positions, leaf.pieces):
                    mine[(path, s, f)] = p.detach().cpu()
            else:
                mine[(path, s, None)] = leaf.detach().cpu()
    everyone = [mine]
    if tp.multi:
        everyone = [None] * torch.distributed.get_world_size()
        torch.distributed.all_gather_object(everyone, mine)
    got = {k: v for part in everyone for k, v in part.items()}
    out = map_tree(like, lambda x: x.detach().cpu().clone())
    make = _lora_tree if "scale" in like else _param_tree
    for s in range(tp.g):
        views = make(out, s, 0, tp, lambda x, dev: x, list(range(tp.f)))
        for path, leaf in _walk(views):
            if isinstance(leaf, FsdpLeaf):
                for f, p in zip(leaf.positions, leaf.pieces):
                    if (path, s, f) in got:
                        p.copy_(got[(path, s, f)])
            elif (path, s, None) in got:
                leaf.copy_(got[(path, s, None)])
    return out


def map_tree(tree, fn):
    """``fn`` over every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: map_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _adapter_part(adapter: dict, s: int, tp: TensorParallel) -> dict:
    """Tensor shard ``s``'s part of an adapter's ``{target: {"a", "b"}}``
    weights."""
    out = {}
    for t, ab in adapter.items():
        out[t] = {}
        for part in ("a", "b"):
            x = ab[part]
            x = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
            out[t][part] = _split(x, _lora_axis(f"{t}_{part}", tp), s, tp.t)
    return out


def _all_trees(bufs: Shards) -> list[tuple[int, dict]]:
    """(tensor shard, tree) for every distinct local tree of every
    sequence and data group."""
    out, seen = [], set()
    for data in bufs.data:
        if data is None:
            continue
        for group in data.groups:
            for s, tree in zip(bufs.tp.shards, group):
                if id(tree) not in seen:
                    seen.add(id(tree))
                    out.append((s % bufs.tp.t, tree))
    return out


def write_adapter(bufs, cfg: ModelConfig, slot: int, adapter: dict,
                  alpha: float, rank: int) -> None:
    """``lora.write_adapter`` on every shard of ``bufs`` (a plain tree:
    the one write)."""
    if not isinstance(bufs, Shards):
        lora_lib.write_adapter(bufs, cfg, slot, adapter, alpha, rank)
        return
    tp = bufs.tp
    for s, part in _all_trees(bufs):
        lora_lib.write_adapter(part, tp.cfg, slot,
                               _adapter_part(adapter, s, tp), alpha, rank)


def clear_adapter(bufs, cfg: ModelConfig, slot: int) -> None:
    """``lora.clear_adapter`` on every shard of ``bufs``."""
    if not isinstance(bufs, Shards):
        lora_lib.clear_adapter(bufs, cfg, slot)
        return
    for _, part in _all_trees(bufs):
        lora_lib.clear_adapter(part, bufs.tp.cfg, slot)


def _cache_rows(cache: dict, start: int, n: int) -> dict:
    """Lane rows ``[start, start + n)`` of a lane cache, as views (``k``,
    ``v`` and the int8 scales on axis 1, ``length`` on axis 0)."""
    return {name: x.narrow(0 if name == "length" else 1, start, n)
            for name, x in cache.items()}


def shard_cache(make: Callable[..., dict], tp: TensorParallel,
                rows: int | None = None) -> Shards:
    """Per-shard caches, one per local attention shard of group 0
    (``TensorParallel.n_attn``), ``make(local cfg, device)`` each: KV heads split over the shards, or (MQA)
    replicated — one cache on one device.  Shards on one device share the
    paged tables and the lengths.  Over ``data`` (lanes only) ``rows`` is
    the whole batch: data group g holds rows ``[g * rows / d, (g + 1) *
    rows / d)``, made by ``make(local cfg, device, rows / d)`` on its
    devices, or (one device) views of one cache of every row."""
    if tp.d > 1 and (rows is None or rows % tp.d):
        raise ValueError(f"data={tp.d} needs a batch it divides, got "
                         f"{rows}")

    def grid(tg, n_rows=None):
        trees: list[dict] = []
        for s in range(tg.n_attn):
            if s and tg.one_device and not tg.kv_split:
                trees.append(trees[0])
                continue
            cache = (make(tg.cfg, tg.device(s)) if n_rows is None
                     else make(tg.cfg, tg.device(s), n_rows))
            if s and tg.one_device:
                for name in ("tables", "length"):
                    if name in cache:
                        cache[name] = trees[0][name]
            trees.append(cache)
        return Shards(trees, tg)

    if tp.d == 1:
        return grid(tp)
    per = rows // tp.d
    if not tp.one_device:
        out = [grid(tp.group(g), per) for g in range(tp.d)]
    else:
        full = grid(tp, rows)
        views: dict = {}
        out = [Shards([views.setdefault((id(c), g),
                                        _cache_rows(c, g * per, per))
                       for c in full], tp.group(g))
               for g in range(tp.d)]
    return Shards(list(out[0]), tp, None, out)


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
