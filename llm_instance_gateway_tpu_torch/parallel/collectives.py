"""Collectives over a ``torch.distributed`` process group: what GSPMD
inserts between the reference's shards when a mesh spans processes (the
JAX package has no such module; XLA places its all-reduces and
all-gathers itself).

Four operations, each over a ``Group`` (a process group, its ranks and its
backend; ``None`` when the axis stays inside one process, where each is
the identity):

- ``reduce``: the row-parallel sum.  All-reduce forward, identity
  backward: the loss is replicated on every rank, so each rank's upstream
  gradient is already the whole ``d loss / d sum`` (an all-reduce there,
  as ``torch.distributed.nn.functional.all_reduce`` does, multiplies every
  gradient below it by the group's size);
- ``copy``: the column-parallel entry.  Identity forward, all-reduce
  backward: each rank's shards see only their part of the gradient of the
  activation that enters them;
- ``gather``: the fsdp gather.  All-gather forward along an axis,
  reduce-scatter backward divided by the group's size: every fsdp position
  computes the same rows with the gathered weight, so the reduce-scatter's
  sum counts each row's gradient once per position;
- ``exchange``: the ring's K/V exchange over ``sequence``.  All-gather
  forward along an axis, reduce-scatter backward NOT divided: each
  sequence position's queries differ, so the gradient of a block's K/V
  is the plain sum of what every position's queries sent it;
- ``all_reduce``: a plain sum, for counts (no gradient);
- ``broadcast``: one member's tensor on every member (no gradient): the
  ring's last real row, which one sequence position holds.

The backend is the mesh's (``parallel/mesh.py``): NCCL between cards that
no two processes share, gloo otherwise.  Over gloo a CUDA tensor is staged
through a pinned host buffer of its own dtype (a transport detail: the sum
is the same dtype's, and every kernel still runs on the card).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Group:
    """A process group of the mesh: its handle, its ranks (in the mesh's
    order) and its backend (``"nccl"`` or ``"gloo"``)."""

    handle: object
    ranks: tuple[int, ...]
    backend: str

    @property
    def size(self) -> int:
        return len(self.ranks)


def _staged(group: Group, x: torch.Tensor):
    """(the tensor the collective runs on, a function that moves a result
    back to ``x``'s device, whether buffers are pinned): ``x`` itself
    unless a CUDA tensor meets gloo."""
    if group.backend != "gloo" or not x.is_cuda:
        return x, lambda y: y, False
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    return host, lambda y: y.to(x.device, non_blocking=True), True


def _all_reduce(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of ``x`` over the group (a new tensor)."""
    buf, back, _ = _staged(group, x.contiguous().clone())
    dist.all_reduce(buf, group=group.handle)
    return back(buf)


def _gather_into(out: torch.Tensor, x: torch.Tensor, group: Group) -> None:
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, x, group=group.handle)


def _scatter_into(out: torch.Tensor, x: torch.Tensor, group: Group) -> None:
    fn = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    fn(out, x, group=group.handle)


def _all_gather(x: torch.Tensor, axis: int, group: Group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``axis``, in rank order."""
    first = x.movedim(axis, 0).contiguous()
    buf, back, pinned = _staged(group, first)
    out = torch.empty((group.size * buf.shape[0],) + tuple(buf.shape[1:]),
                      dtype=buf.dtype, device=buf.device, pin_memory=pinned)
    _gather_into(out, buf, group)
    return back(out).movedim(0, axis)


def _reduce_scatter(x: torch.Tensor, axis: int,
                    group: Group) -> torch.Tensor:
    """This rank's block along ``axis`` of the sum of ``x`` over the
    group."""
    first = x.movedim(axis, 0).contiguous()
    buf, back, pinned = _staged(group, first)
    out = torch.empty((buf.shape[0] // group.size,) + tuple(buf.shape[1:]),
                      dtype=buf.dtype, device=buf.device, pin_memory=pinned)
    _scatter_into(out, buf, group)
    return back(out).movedim(0, axis)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        return _all_gather(x, axis, group)

    @staticmethod
    def backward(ctx, grad):
        g = ctx.group
        return _reduce_scatter(grad, ctx.axis, g) / g.size, None, None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        return _all_gather(x, axis, group)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.axis, ctx.group), None, None


def reduce(x: torch.Tensor, group: Group | None) -> torch.Tensor:
    """The row-parallel sum of ``x`` over ``group`` (identity backward)."""
    return x if group is None else _Reduce.apply(x, group)


def copy(x: torch.Tensor, group: Group | None) -> torch.Tensor:
    """``x`` entering a column-parallel region that spans ``group``
    (all-reduce backward); itself where no gradient can flow."""
    if group is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _Copy.apply(x, group)


def gather(x: torch.Tensor, axis: int, group: Group | None) -> torch.Tensor:
    """The fsdp gather of ``x``'s pieces along ``axis`` over ``group``
    (reduce-scatter over the group's size backward)."""
    return x if group is None else _Gather.apply(x, axis, group)


def all_reduce(x: torch.Tensor, group: Group | None) -> torch.Tensor:
    """A plain sum over ``group`` (counts, gradients after backward)."""
    return x if group is None else _all_reduce(x.detach(), group)


def exchange(x: torch.Tensor, axis: int,
             group: Group | None) -> torch.Tensor:
    """Every member's ``x`` concatenated along ``axis`` in the group's
    order (the sequence blocks in order); its backward hands each member
    the sum of the gradients of its block."""
    return x if group is None else _Exchange.apply(x, axis, group)


def broadcast(x: torch.Tensor, src: int, group: Group | None) -> torch.Tensor:
    """Member ``src``'s ``x`` (an index into ``group.ranks``) on every
    member: a tensor of ``x``'s shape and dtype, whatever the others
    hold."""
    if group is None:
        return x
    buf, back, _ = _staged(group, x.detach().contiguous().clone())
    dist.broadcast(buf, group.ranks[src], group=group.handle)
    return back(buf)
