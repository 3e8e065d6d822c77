"""Device meshes with named axes (port of ``parallel/mesh.py``).

The reference's six axes, in its order: ``data`` (request parallelism),
``fsdp`` (parameter sharding), ``pipe`` (layer stages), ``tensor`` (heads
and ffn columns inside a layer), ``expert`` (MoE experts) and
``sequence`` (ring attention).  A mesh here is a ``MeshConfig`` and the
torch devices its shards sit on, one per mesh position.

This port serves the ``tensor`` axis (``parallel/sharding.py``): one
process drives every shard, as the reference's GSPMD engine does.  Any
other axis larger than 1 is refused by ``make_mesh``; ROADMAP queues
them.  Without an explicit device list a mesh takes the first
``total`` CUDA devices and refuses a size the host cannot give; an
explicit list may repeat a device (``["cuda:0", "cuda:0"]``, ``["cpu",
"cpu"]``), which is how one card or the CPU hosts a ``tensor=2`` mesh.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

AXES = ("data", "fsdp", "pipe", "tensor", "expert", "sequence")
# The axes this slice serves; the others are queued in ROADMAP.md.
SERVED_AXES = ("tensor",)


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
    ``cfg.total`` CUDA devices).  Raises ``ValueError`` on an axis this
    port does not serve yet and on a device count that does not match."""
    for axis, n in zip(AXES, cfg.shape):
        if n > 1 and axis not in SERVED_AXES:
            raise ValueError(
                f"mesh axis {axis}={n}: the port serves the tensor axis "
                "only; the other axes are queued in ROADMAP.md")
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    if cfg.total != len(devices):
        raise ValueError(f"mesh shape {cfg.shape} needs {cfg.total} "
                         f"devices, have {len(devices)}")
    return Mesh(cfg, tuple(torch.device(d) for d in devices))
