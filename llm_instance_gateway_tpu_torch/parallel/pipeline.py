"""GPipe pipeline parallelism over the ``pipe`` mesh axis (port of
``parallel/pipeline.py``).

The layer stack ``[L, ...]`` splits into ``pipe`` contiguous stages
(``stage_params``: ``[pp, L/pp, ...]``, views of the same tensors), stage i
on the devices whose ``pipe`` coordinate is i (``stage_param_specs``), and
the batch into M microbatches.  GPipe: microbatch j enters stage 0 at step
j and leaves the last stage at step j + pp - 1, M + pp - 1 steps in all.

The reference writes the schedule as one scanned program over a rotation
buffer ``[pp, mb, S, D]``: every step applies every stage to its slot
(a ``vmap`` over the stage axis), computing the pp - 1 warm-up and drain
slots as well and dropping their outputs, and rotates the buffer with a
collective-permute.  Here one process issues the schedule eagerly and
runs only the live (stage, microbatch) pairs, so a forward launches the
flash kernel exactly L x M times per shard and a backward the flash
backward kernel L x M times.  A microbatch's activation crosses to the
next stage by ``.to(next device)`` (a copy, differentiable); across cards
the stages' launches go to their own cards' streams, so stages overlap as
the schedule allows.  The backward falls out of autograd, as the
reference's falls out of the scan's transpose.

Each layer is ``transformer.prefill_layer`` — the block the unpipelined
forward runs — with its K/V written nowhere (training keeps no cache).
Inside a stage, ``tensor`` and ``data`` compose as in serving
(``parallel/sharding.py``'s grid over the stage's devices): the reference's
pp2tp4, dp2pp2tp2 and pp4tp2 meshes run with every shard on one device
(views, differentiable) or, forward only, across cards.  A train step
across cards runs ``pipe`` with ``tensor = data = 1``: its reductions
there would be single-process NCCL calls autograd cannot differentiate;
across cards ``tensor``, ``fsdp`` and ``data`` train one process per card
(``training/train.py``'s sharded recipe over ``parallel/collectives.py``).
The embedding and the head run outside the stages, on the first device.
"""

from __future__ import annotations

from typing import Any

import torch

from llm_instance_gateway_tpu_torch.models import transformer
from llm_instance_gateway_tpu_torch.models.configs import ModelConfig
from llm_instance_gateway_tpu_torch.ops.quant import is_quantized
from llm_instance_gateway_tpu_torch.parallel import sharding
from llm_instance_gateway_tpu_torch.parallel.mesh import Mesh, MeshConfig

Params = dict[str, Any]


def _map(fn, x):
    """``fn`` over a leaf, or over an int8 ``{"q", "s"}`` leaf's parts."""
    return {k: fn(v) for k, v in x.items()} if is_quantized(x) else fn(x)


def stage_params(cfg: ModelConfig, params: Params, pipe: int) -> Params:
    """Layer leaves ``[L, ...]`` as ``[pp, L/pp, ...]`` (views): stage i
    holds layers ``[i*L/pp, (i+1)*L/pp)``, the contiguous assignment.
    Non-layer params pass through; they run outside the stages.  Raises
    ``ValueError`` when ``pipe`` does not divide the layers."""
    if cfg.n_layers % pipe != 0:
        raise ValueError(
            f"n_layers={cfg.n_layers} not divisible by pipe={pipe}")
    per = cfg.n_layers // pipe
    staged = {name: _map(lambda x: x.reshape((pipe, per) + tuple(x.shape[1:])),
                         leaf)
              for name, leaf in params["layers"].items()}
    return {**params, "layers": staged}


def _stage_mesh(mesh: Mesh, i: int) -> Mesh:
    """Stage i's grid: the devices with pipe coordinate i, over the
    mesh's ``data``, ``tensor`` and ``expert`` axes."""
    c = mesh.config
    if c.fsdp > 1 or c.sequence > 1:
        raise ValueError(f"a pipelined mesh runs pipe with data, tensor and "
                         f"expert; fsdp={c.fsdp}, sequence={c.sequence} are "
                         "not served there")
    devices = [mesh.devices[mesh.device_index(data=d, pipe=i, tensor=t,
                                              expert=e)]
               for d in range(c.data) for t in range(c.tensor)
               for e in range(c.expert)]
    return Mesh(MeshConfig(data=c.data, tensor=c.tensor, expert=c.expert),
                tuple(devices))


def stage_param_specs(cfg: ModelConfig, staged: Params,
                      mesh: Mesh | None = None) -> Params:
    """The staged tree placed on ``mesh`` (the port's counterpart of the
    reference's ``P("pipe", ...)`` specs): stage i's layer leaves on the
    first device of the devices with pipe coordinate i, the non-layer
    params on the mesh's first device.  On one device the tree is
    returned as it is (views); across cards every layer leaf becomes the
    list of its stages' tensors."""
    if mesh is None or len(set(mesh.devices)) == 1:
        if mesh is not None:
            dev = mesh.devices[0]
            return sharding.map_tree(staged, lambda x: x.to(dev))
        return staged
    pipe = mesh.shape["pipe"]
    firsts = [_stage_mesh(mesh, i).devices[0] for i in range(pipe)]
    out = {k: sharding.map_tree(v, lambda x: x.to(mesh.devices[0]))
           for k, v in staged.items() if k != "layers"}
    # Copies, each stage's own (a view would keep the whole stack alive).
    out["layers"] = {
        name: [_map(lambda x, i=i, dev=dev: x[i].to(dev, copy=True), leaf)
               for i, dev in enumerate(firsts)]
        for name, leaf in staged["layers"].items()}
    return out


def _stage_tree(params: Params, i: int) -> Params:
    """Stage i's layers as an ordinary port tree (``{"layers": ...}``)."""
    return {"layers": {name: _map(lambda x: x[i], leaf)
                       for name, leaf in params["layers"].items()}}


class _Stage:
    """One stage of a forward: its layers over its grid (a plain tree, or
    one ``Shards`` per data group) and the device its output leaves
    from."""

    def __init__(self, cfg: ModelConfig, params: Params, i: int,
                 mesh: Mesh | None):
        tree = _stage_tree(params, i)
        self.cfg = cfg
        grid = None if mesh is None else _stage_mesh(mesh, i)
        if grid is None or grid.size == 1:
            self.groups = [tree]
            self.device = _first_leaf(tree).device
            return
        tp = sharding.TensorParallel(cfg, grid)
        sharded = sharding.shard_params(tree, tp)
        self.groups = [sharded.data[g] for g in range(tp.d)]
        self.device = tp.device(0)

    def __call__(self, h: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """The stage's layers over one microbatch ``[mb, S, D]`` (each data
        group on its rows); the output on the stage's device.  The stage's
        card is made current: a kernel wrapper launches on the current
        device, into the stream of its tensors' device."""
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                return self._run(h, pos)
        return self._run(h, pos)

    def _run(self, h: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        d = len(self.groups)
        if h.shape[0] % d:
            raise ValueError(f"microbatch of {h.shape[0]} rows over "
                             f"data={d}")
        per = h.shape[0] // d
        outs = []
        for g, tree in enumerate(self.groups):
            sh = transformer._Shards(self.cfg, tree, None)
            rows = slice(g * per, (g + 1) * per)
            dev = _first_leaf(sh.trees[0]).device
            x = h[rows].to(dev)
            hs = [sh.on(x)] if sh.tp is not None and not sh.tp.one_device \
                else [[x] * sh.n]
            p = [sh.on(pos[rows].to(dev))]
            sids = [sh.on(torch.full((per,), -1, dtype=torch.int32,
                                     device=dev))]
            n_layers = _first_leaf(sh.trees[0]).shape[0]
            for i in range(n_layers):
                hs = transformer.prefill_layer([sh], i, hs, p, sids, None,
                                               None)
            outs.append(hs[0][0].to(self.device))
        return outs[0] if d == 1 else torch.cat(outs)


def _first_leaf(tree: Params) -> torch.Tensor:
    leaf = next(iter(tree["layers"].values()))
    return leaf["q"] if is_quantized(leaf) else leaf


def pipeline_forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                     positions: torch.Tensor, pipe: int,
                     n_microbatches: int,
                     mesh: Mesh | None = None) -> torch.Tensor:
    """Pipelined full-prompt forward over a staged tree (``stage_params``,
    placed by ``stage_param_specs``).  Returns logits ``[B, S, V]`` f32 on
    the first device.  B must split into ``n_microbatches`` equal
    microbatches; with ``pipe == 1`` this is the plain layer loop and
    matches ``transformer.prefill``'s logits."""
    b, s = tokens.shape
    m = n_microbatches
    if mesh is not None and mesh.shape["pipe"] != pipe:
        raise ValueError(f"pipe={pipe} over a mesh of pipe="
                         f"{mesh.shape['pipe']}")
    if b % m != 0:
        raise ValueError(f"batch {b} not divisible by n_microbatches={m}")
    mb = b // m
    dev0 = params["embed"].device
    tokens, positions = tokens.to(dev0), positions.to(dev0)
    stages = [_Stage(cfg, params, i, mesh) for i in range(pipe)]
    h = transformer._embed(cfg, params, tokens)
    acts = [h[j * mb:(j + 1) * mb] for j in range(m)]
    pos = [positions[j * mb:(j + 1) * mb] for j in range(m)]
    # GPipe: at step t stage i runs microbatch t - i, the live pairs only.
    for t in range(m + pipe - 1):
        for i in range(pipe):
            j = t - i
            if 0 <= j < m:
                acts[j] = stages[i](acts[j].to(stages[i].device), pos[j])
    h = torch.cat([a.to(dev0) for a in acts])
    return transformer._logits(cfg, params, h)


def pipeline_lm_loss(cfg: ModelConfig, params: Params, tokens, positions,
                     pipe: int, n_microbatches: int,
                     mesh: Mesh | None = None) -> torch.Tensor:
    """``train.causal_lm_loss`` with the pipelined forward plugged in."""
    from llm_instance_gateway_tpu_torch.training import train

    return train.causal_lm_loss(
        cfg, params, tokens, positions,
        logits_fn=lambda p, t, pos: pipeline_forward(
            cfg, p, t, pos, pipe, n_microbatches, mesh=mesh))


def make_pipeline_train_step(cfg: ModelConfig, optimizer, pipe: int,
                             n_microbatches: int, mesh: Mesh | None = None):
    """Full-parameter train step over a staged tree: ``step(params,
    opt_state, tokens, positions) -> (params, opt_state, loss)``, AdamW
    (``optimizer = train.make_optimizer(staged)``) updating the staged
    leaves in place, as ``train.make_full_train_step`` does.  Raises
    ``ValueError`` for a mesh across cards with ``tensor`` or ``data``
    above 1."""
    from llm_instance_gateway_tpu_torch.training import train

    if mesh is not None and len(set(mesh.devices)) > 1 and (
            mesh.shape["tensor"] > 1 or mesh.shape["data"] > 1):
        raise ValueError(
            f"a pipelined train step across cards runs pipe with tensor=1 "
            f"and data=1 (got tensor={mesh.shape['tensor']}, "
            f"data={mesh.shape['data']}): their reductions across cards are "
            "NCCL calls autograd cannot differentiate; across cards train "
            "tensor and data one process per card "
            "(parallel/mesh.initialize_distributed, "
            "training/train.make_full_train_step over a Shards tree)")
    return train.make_step(optimizer, lambda p, tokens, positions:
                           pipeline_lm_loss(cfg, p, tokens, positions, pipe,
                                            n_microbatches, mesh=mesh))
