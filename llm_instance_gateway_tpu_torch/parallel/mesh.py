"""Device meshes with named axes (port of ``parallel/mesh.py``).

The reference's six axes, in its order: ``data`` (request parallelism),
``fsdp`` (parameter sharding), ``pipe`` (layer stages), ``tensor`` (heads
and ffn columns inside a layer), ``expert`` (MoE experts) and
``sequence`` (ring attention).  A mesh here is a ``MeshConfig`` and the
torch devices its shards sit on, one per mesh position.

The port takes every axis.  Serving (``server/engine.py``) runs
``data`` (the decode rows split in contiguous blocks, one full shard grid
a block), ``fsdp`` (every weight split on its non-tensor axis, gathered
before use), ``tensor``, ``expert`` and ``sequence`` (the ring prefill,
``parallel/long_context.py``) and refuses ``pipe``, as the reference
does; training runs ``pipe`` (``parallel/pipeline.py``).  One process
drives every shard, as the reference's GSPMD engine does
(``initialize_distributed`` is queued in ROADMAP.md).  Devices sit in the
reference's axis order, ``data`` outermost and the last axis fastest: the
shard at (data d, fsdp f, pipe p, tensor t, expert e, sequence j) takes
device ``((((d*fsdp + f)*pipe + p)*tensor + t)*expert + e)*sequence +
j`` (``device_index``).  Without an explicit device list a mesh takes the
first ``total`` CUDA devices and refuses a size the host cannot give; an
explicit list may repeat a device (``["cuda:0", "cuda:0"]``, ``["cpu",
"cpu"]``), which is how one card or the CPU hosts a mesh of two.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

AXES = ("data", "fsdp", "pipe", "tensor", "expert", "sequence")
# The axes ``make_mesh`` takes: all of them (serving refuses ``pipe`` at
# ``Engine(...)``, as the reference does).
SERVED_AXES = AXES


@dataclass(frozen=True)
class MeshConfig:
    data: int = 1
    fsdp: int = 1
    pipe: int = 1
    tensor: int = 1
    expert: int = 1
    sequence: int = 1

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.data, self.fsdp, self.pipe, self.tensor, self.expert,
                self.sequence)

    @property
    def total(self) -> int:
        return math.prod(self.shape)

    @staticmethod
    def for_devices(n: int, tensor: int | None = None, sequence: int = 1,
                    expert: int = 1) -> "MeshConfig":
        """Sensible inference default: fill ``tensor`` with what's left."""
        if tensor is None:
            tensor = max(1, n // (sequence * expert))
        data = n // (tensor * sequence * expert)
        return MeshConfig(data=data, tensor=tensor, expert=expert,
                          sequence=sequence)


@dataclass(frozen=True)
class Mesh:
    """A ``MeshConfig`` over devices (in the reference's axis order, the
    last axis fastest)."""

    config: MeshConfig
    devices: tuple[torch.device, ...]

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(AXES, self.config.shape))

    @property
    def size(self) -> int:
        return self.config.total

    def device_index(self, data: int = 0, fsdp: int = 0, pipe: int = 0,
                     tensor: int = 0, expert: int = 0,
                     sequence: int = 0) -> int:
        """The position in ``devices`` of the shard at these coordinates
        (the reference's axis order, the last axis fastest)."""
        idx = 0
        for n, i in zip(self.config.shape,
                        (data, fsdp, pipe, tensor, expert, sequence)):
            idx = idx * n + i
        return idx


def parse_axes(spec: str) -> MeshConfig:
    """``--mesh``'s ``AXIS=N[,AXIS=N...]`` (the reference's parsing)."""
    axes = {}
    for part in spec.split(","):
        k, _, v = part.partition("=")
        axes[k.strip()] = int(v)
    unknown = sorted(set(axes) - set(AXES))
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown} (axes: "
                         f"{','.join(AXES)})")
    return MeshConfig(**axes)


def make_mesh(cfg: MeshConfig, devices=None) -> Mesh:
    """The mesh of ``cfg`` over ``devices`` (default: the first
    ``cfg.total`` CUDA devices).  Raises ``ValueError`` on a device count
    that does not match."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    if cfg.total != len(devices):
        raise ValueError(f"mesh shape {cfg.shape} needs {cfg.total} "
                         f"devices, have {len(devices)}")
    return Mesh(cfg, tuple(torch.device(d) for d in devices))
