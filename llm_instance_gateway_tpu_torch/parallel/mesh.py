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
does; training runs ``pipe`` (``parallel/pipeline.py``).  Devices sit in
the reference's axis order, ``data`` outermost and the last axis fastest:
the shard at (data d, fsdp f, pipe p, tensor t, expert e, sequence j)
takes device ``((((d*fsdp + f)*pipe + p)*tensor + t)*expert + e)*sequence
+ j`` (``device_index``).  Without an explicit device list a mesh takes
the first ``total`` CUDA devices and refuses a size the host cannot give;
an explicit list may repeat a device (``["cuda:0", "cuda:0"]``, ``["cpu",
"cpu"]``), which is how one card or the CPU hosts a mesh of two.

One process drives every shard unless ``initialize_distributed`` has
joined a world of N processes (the reference's env contract:
``TPU_GATEWAY_COORDINATOR`` / ``TPU_GATEWAY_PROCESS_ID`` /
``TPU_GATEWAY_NUM_PROCESSES``, or torchrun's ``MASTER_ADDR`` / ``RANK`` /
``WORLD_SIZE``).  Then ``make_mesh`` takes this process's devices (as
``jax.local_devices()``: ``cuda:{LOCAL_RANK}`` when the env gives it,
else the first ``total / N`` CUDA devices, or an explicit list) and learns
the others' from them: process p owns positions ``[p * total / N, (p + 1)
* total / N)``, the mesh records each position's device and owner
(``processes``), and each process holds and computes only its own shards
(``parallel/sharding.py``).  The collectives between processes
(``parallel/collectives.py``) run over one process group per set of
positions that differ only in ``tensor``, in ``tensor`` and ``expert``,
in ``fsdp``, in ``data``, in ``sequence`` (the ring's K/V exchange), in
``data`` and ``sequence`` (the training loss and gradient sums) or in
``pipe`` (a pipeline stage's neighbours, ``parallel/pipeline.py``), and
over every process (``group(*AXES)``: the serving engine's TTL verdicts)
(``Mesh.group``).  Where ``pipe`` > 1 a process owns one stage (pipe
across processes) or every stage (pipe inside it).  Their backend follows one
rule, logged when the mesh is made: NCCL when every process's positions
sit on CUDA devices no other process uses, else gloo (NCCL refuses two
ranks on one device, which is how one card hosts two processes).
"""

from __future__ import annotations

import datetime
import logging
import math
import os
import socket
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from llm_instance_gateway_tpu_torch.parallel.collectives import Group

logger = logging.getLogger(__name__)

AXES = ("data", "fsdp", "pipe", "tensor", "expert", "sequence")
# The axes ``make_mesh`` takes: all of them (serving refuses ``pipe`` at
# ``Engine(...)``, as the reference does).
SERVED_AXES = AXES
# The position sets a mesh across processes makes a process group for:
# the attention reduction (tensor), the MLP reduction (tensor and expert),
# the fsdp gather, the data-parallel sums, the ring's K/V exchange
# (sequence), the training sums over the batch's rows and positions
# (data and sequence), a pipeline stage's neighbours (pipe: the
# positions at the same coordinates in every stage, between which
# activations and their gradients go point to point) and every process
# (all the axes: the lockstep engine's agreement on its clock's
# decisions).
GROUP_AXES = (("tensor",), ("tensor", "expert"), ("fsdp",), ("data",),
              ("sequence",), ("data", "sequence"), ("pipe",), AXES)
# How long a collective (and the world's rendezvous) waits for its peers
# before it raises: a divergence between processes becomes a failure, not
# a hang.
COLLECTIVE_TIMEOUT_S = 600.0


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
    last axis fastest).  Across processes ``processes[i]`` owns position
    i, ``rank`` is this process and ``groups`` its process group per
    ``GROUP_AXES`` entry (None where those positions stay inside it)."""

    config: MeshConfig
    devices: tuple[torch.device, ...]
    processes: tuple[int, ...] | None = None
    rank: int = 0
    groups: dict = field(default_factory=dict, compare=False)

    @property
    def spans_processes(self) -> bool:
        return self.processes is not None and len(set(self.processes)) > 1

    def coords(self, idx: int) -> tuple[int, ...]:
        """Position ``idx``'s coordinates, one per axis (``device_index``'s
        inverse)."""
        out = []
        for n in reversed(self.config.shape):
            out.append(idx % n)
            idx //= n
        return tuple(reversed(out))

    def local(self, idx: int) -> bool:
        """Whether this process owns position ``idx``."""
        return self.processes is None or self.processes[idx] == self.rank

    def group(self, *axes: str) -> Group | None:
        """This process's group over the positions that differ from its own
        only in ``axes`` (a ``GROUP_AXES`` entry); None inside one
        process."""
        return self.groups.get(axes)

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


def world() -> tuple[int, int]:
    """(this process's rank, the number of processes): (0, 1) unless
    ``initialize_distributed`` joined a world."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def initialize_distributed() -> None:
    """Join a world of processes from the environment (idempotent, a
    no-op when nothing is set).  ``TPU_GATEWAY_COORDINATOR`` (host:port,
    with ``TPU_GATEWAY_PROCESS_ID`` / ``TPU_GATEWAY_NUM_PROCESSES``) is the
    explicit contract the manifests set; torchrun's ``MASTER_ADDR`` /
    ``RANK`` / ``WORLD_SIZE`` (``env://``) stands where the reference
    reads a TPU pod's own variables.  The world's group is gloo (host
    objects; the mesh picks the collectives' backend by its devices) and
    its collectives time out after ``COLLECTIVE_TIMEOUT_S``.  Init
    failures (an
    unreachable coordinator, a peer that never comes) propagate: serving on
    a partial world is worse than a crash-and-restart."""
    if dist.is_initialized():
        return
    coord = os.environ.get("TPU_GATEWAY_COORDINATOR")
    timeout = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)
    if coord:
        rank = int(os.environ["TPU_GATEWAY_PROCESS_ID"])
        size = int(os.environ["TPU_GATEWAY_NUM_PROCESSES"])
        dist.init_process_group("gloo", init_method=f"tcp://{coord}",
                                rank=rank, world_size=size, timeout=timeout)
        logger.info("torch.distributed initialized: process %s/%s via %s",
                    rank, size, coord)
    elif (os.environ.get("MASTER_ADDR")
          and int(os.environ.get("WORLD_SIZE", "1")) > 1):
        dist.init_process_group("gloo", init_method="env://",
                                timeout=timeout)
        logger.info("torch.distributed initialized from env://: process "
                    "%s/%s", dist.get_rank(), dist.get_world_size())


def local_devices(n: int) -> list[torch.device]:
    """This process's ``n`` devices (``jax.local_devices()``'s
    counterpart): ``cuda:{LOCAL_RANK}`` when the env gives it (one per
    process), else the first ``n`` CUDA devices."""
    local_rank = os.environ.get("LOCAL_RANK")
    if local_rank is not None:
        if n != 1:
            raise ValueError(f"LOCAL_RANK={local_rank} gives one device per "
                             f"process; this mesh needs {n}")
        return [torch.device("cuda", int(local_rank))]
    if torch.cuda.device_count() < n:
        raise ValueError(f"this process needs {n} CUDA devices, has "
                         f"{torch.cuda.device_count()}")
    return [torch.device("cuda", i) for i in range(n)]


def _backend(placements: list) -> str:
    """NCCL when every process's devices are CUDA devices no other process
    uses (``placements``: (host, devices) per process), else gloo."""
    seen: dict = {}
    for p, (host, devices) in enumerate(placements):
        for d in devices:
            if not d.startswith("cuda"):
                return "gloo"
            if seen.setdefault((host, str(torch.device(d))), p) != p:
                return "gloo"
    return "nccl"


def _make_groups(cfg: MeshConfig, processes: tuple[int, ...], rank: int,
                 backend: str) -> dict:
    """One process group per distinct set of processes that positions
    differing only in a ``GROUP_AXES`` entry span (every process creates
    every group, in one order); this process's per entry.  Raises
    ``ValueError`` where a process would sit in two such sets (a layout
    whose processes do not own whole blocks of the grid), or owns part of
    the ``pipe`` axis (more than one stage but not all)."""
    grid = Mesh(cfg, (), processes, rank)
    if cfg.pipe > 1:
        for p in sorted(set(processes)):
            stages = sorted({grid.coords(i)[2]
                             for i, q in enumerate(processes) if q == p})
            if len(stages) not in (1, cfg.pipe):
                raise ValueError(
                    f"mesh {dict(zip(AXES, cfg.shape))}: process {p} owns "
                    f"pipe coordinates {stages}, part of the pipe axis; a "
                    "process owns one pipeline stage (pipe across "
                    "processes) or all of them (pipe inside the process)")
    handles: dict = {}
    mine: dict = {}
    for axes in GROUP_AXES:
        sets: dict = {}
        for idx, p in enumerate(processes):
            key = tuple(c for a, c in zip(AXES, grid.coords(idx))
                        if a not in axes)
            sets.setdefault(key, set()).add(p)
        spans = sorted({tuple(sorted(v)) for v in sets.values()
                        if len(v) > 1})
        for ranks in spans:
            if ranks not in handles:
                handles[ranks] = dist.new_group(
                    list(ranks), backend=backend,
                    timeout=datetime.timedelta(
                        seconds=COLLECTIVE_TIMEOUT_S))
        own = [r for r in spans if rank in r]
        if len(own) > 1:
            raise ValueError(f"mesh {dict(zip(AXES, cfg.shape))}: process "
                             f"{rank} sits in two {'/'.join(axes)} groups "
                             f"{own}; give each process whole blocks")
        if own:
            mine[axes] = Group(handles[own[0]], own[0], backend)
    return mine


def make_mesh(cfg: MeshConfig, devices=None) -> Mesh:
    """The mesh of ``cfg`` over ``devices`` (default: the first
    ``cfg.total`` CUDA devices).  In a world of N processes ``devices``
    are this process's ``total / N`` (default: ``local_devices``), every
    process calls ``make_mesh`` with the same ``cfg``, and the mesh's
    process groups are made here.  Raises ``ValueError`` on a device
    count that does not match."""
    rank, size = world()
    if size == 1:
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        if cfg.total != len(devices):
            raise ValueError(f"mesh shape {cfg.shape} needs {cfg.total} "
                             f"devices, have {len(devices)}")
        return Mesh(cfg, tuple(torch.device(d) for d in devices))
    if cfg.total % size:
        raise ValueError(f"mesh shape {cfg.shape} ({cfg.total} positions) "
                         f"does not split over {size} processes")
    n_local = cfg.total // size
    if devices is None:
        devices = local_devices(n_local)
    if len(devices) != n_local:
        raise ValueError(f"mesh shape {cfg.shape} over {size} processes "
                         f"needs {n_local} devices each, have "
                         f"{len(devices)}")
    placements: list = [None] * size
    dist.all_gather_object(placements, (socket.gethostname(),
                                        [str(torch.device(d))
                                         for d in devices]))
    backend = _backend(placements)
    logger.info("mesh %s over %d processes: collectives over %s (%s)",
                dict(zip(AXES, cfg.shape)), size, backend,
                "each process on CUDA devices of its own"
                if backend == "nccl" else
                "a device shared by processes, or not CUDA")
    processes = tuple(p for p in range(size) for _ in range(n_local))
    return Mesh(cfg, tuple(torch.device(d) for _, devs in placements
                           for d in devs),
                processes, rank,
                _make_groups(cfg, processes, rank, backend))
