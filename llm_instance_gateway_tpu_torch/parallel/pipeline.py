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
collective-permute.  Here the schedule is issued eagerly and runs only the
live (stage, microbatch) pairs, so a forward launches the flash kernel
exactly L/pp x M times per stage and shard, and a backward the flash
backward kernel as often.

Each layer is ``transformer.prefill_layer`` — the block the unpipelined
forward runs — with its K/V written nowhere (training keeps no cache).
Inside a stage ``data``, ``fsdp``, ``tensor``, ``expert`` and
``sequence`` compose as in the sharded step (``parallel/sharding.py``'s
grid over the stage's positions; ``sequence`` replicates the stage, as the
reference's pipeline does, whose batch is split over ``data`` only).

One process: every shard on one device (views, differentiable), or,
forward only with ``tensor``, ``data`` or ``fsdp`` above 1, across cards.
A microbatch's activation crosses to the next stage by ``.to(next
device)`` (a copy, differentiable); across cards the stages' launches go to
their own cards' streams.  The embedding and the head run outside the
stages, on the first device, and the backward falls out of autograd, as
the reference's falls out of the scan's transpose.

Across processes (a mesh whose positions belong to processes,
``parallel/mesh.py``) a process owns one stage or all of them, and holds
only what its stages use (``stage_param_specs``): their layers as one
``Shards`` a stage, ``embed`` on the first stage, ``final_norm`` and
``lm_head`` on the last (a tied ``embed`` on both).  Stage 0 embeds its
rows of each microbatch (its data group's, where ``data`` spans
processes), every stage runs its layers, and a stage's output goes to the
process at the same coordinates in the next stage point to point
(``collectives.send`` / ``recv`` over the ``("pipe",)`` group); the last
stage applies the norm and the head.  The train step runs all forwards,
then all backwards in reverse microbatch order: the last stage
backpropagates its share of the global masked mean, every other stage
the surrogate ``<out_j, g_j>`` of the gradient ``g_j`` it received, and
each stage past the first sends back the whole gradient of its received
activation (the column-parallel copy's backward has summed it over
``tensor``).  Then the zero heads' gradients are zeroed and the
gradients summed over ``tensor`` (the replicated leaves, a replicated KV
head's copies: ``train.shard_grads``) and ``data``, a tied ``embed``'s
two copies exchange theirs, and AdamW steps each process's own leaves.
Every head layout the reference trains runs, the head plan's padded and
replicated heads too, on both routes.
"""

from __future__ import annotations

from typing import Any

import torch

from llm_instance_gateway_tpu_torch.models import transformer
from llm_instance_gateway_tpu_torch.models.configs import ModelConfig
from llm_instance_gateway_tpu_torch.ops.quant import is_quantized
from llm_instance_gateway_tpu_torch.parallel import collectives, sharding
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
    """Stage i's grid: the positions with pipe coordinate i, over the
    mesh's other axes; across processes with the world mesh's owners,
    rank and process groups (every group over axes without ``pipe`` keys
    on the pipe coordinate, so each is the stage's own)."""
    c = mesh.config
    idx = [mesh.device_index(data=d, fsdp=f, pipe=i, tensor=t, expert=e,
                             sequence=j)
           for d in range(c.data) for f in range(c.fsdp)
           for t in range(c.tensor) for e in range(c.expert)
           for j in range(c.sequence)]
    grid = MeshConfig(data=c.data, fsdp=c.fsdp, tensor=c.tensor,
                      expert=c.expert, sequence=c.sequence)
    devices = tuple(mesh.devices[k] for k in idx)
    if not mesh.spans_processes:
        return Mesh(grid, devices)
    return Mesh(grid, devices, tuple(mesh.processes[k] for k in idx),
                mesh.rank, {axes: g for axes, g in mesh.groups.items()
                            if "pipe" not in axes})


def _local_stages(mesh: Mesh) -> list[int]:
    """The pipe coordinates of this process's positions (one, or all)."""
    return sorted({mesh.coords(i)[2] for i in range(mesh.size)
                   if mesh.local(i)})


def stage_param_specs(cfg: ModelConfig, staged: Params,
                      mesh: Mesh | None = None) -> Params:
    """The staged tree placed on ``mesh`` (the port's counterpart of the
    reference's ``P("pipe", ...)`` specs).  One process: stage i's layer
    leaves on the first device of the devices with pipe coordinate i, the
    non-layer params on the mesh's first device; on one device the tree
    is returned as it is (views), across cards every layer leaf becomes
    the list of its stages' tensors.  Across processes: this process's
    part only, copies on its device — ``{"stages": {i: Shards}}`` for each
    stage i it owns (the stage's layers over its grid), with ``embed`` on
    the first stage, ``final_norm`` and ``lm_head`` on the last (a tied
    ``embed`` on both), so the caller's tree can be freed."""
    if mesh is not None and mesh.spans_processes:
        return _process_specs(cfg, staged, mesh)
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


def _process_device(mesh: Mesh) -> torch.device:
    """This process's one device (a stage across processes trains on
    one device a process, as the sharded step does)."""
    local = {mesh.devices[i] for i in range(mesh.size) if mesh.local(i)}
    if len(local) != 1:
        raise ValueError(
            f"a pipelined step across processes runs each process's "
            f"positions on one device, got {sorted(map(str, local))}: run "
            "one process a card")
    return next(iter(local))


def _process_specs(cfg: ModelConfig, staged: Params, mesh: Mesh) -> Params:
    pipe = mesh.shape["pipe"]
    mine = _local_stages(mesh)
    dev = _process_device(mesh)
    out: Params = {}
    first, last = mine[0] == 0, mine[-1] == pipe - 1
    keep = ({"embed"} if first else set()) | (
        {"final_norm", "embed" if cfg.tie_embeddings else "lm_head"}
        if last else set())
    for k in sorted(keep):
        out[k] = sharding.map_tree(staged[k],
                                   lambda x: x.to(dev, copy=True))
    out["stages"] = {}
    for i in mine:
        tp = sharding.TensorParallel(cfg, _stage_mesh(mesh, i))
        # A stage's own copy (its shards' views would keep the stack
        # alive); sharding across processes copies by itself.
        tree = {"layers": {name: _map(
            lambda x: x[i] if tp.multi else x[i].to(dev, copy=True), leaf)
            for name, leaf in staged["layers"].items()}}
        out["stages"][i] = sharding.shard_params(tree, tp)
    return out


def _stage_tree(params: Params, i: int) -> Params:
    """Stage i's layers as an ordinary port tree (``{"layers": ...}``)."""
    return {"layers": {name: _map(lambda x: x[i], leaf)
                       for name, leaf in params["layers"].items()}}


class _Stage:
    """One stage of a forward: its layers (a plain tree, or a ``Shards``
    over its grid: one ``Shards`` per data group, this process's only
    where ``data`` spans processes) and the device its output leaves
    from."""

    def __init__(self, cfg: ModelConfig, layers):
        self.cfg = cfg
        if not isinstance(layers, sharding.Shards):
            self.groups = [layers]
            self.device = _first_leaf(layers).device
            return
        tp = layers.tp
        self.groups = ([layers.data[tp.data_index]] if tp.multi
                       else [layers.data[g] for g in range(tp.d)])
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


def _stage(cfg: ModelConfig, params: Params, i: int,
           mesh: Mesh | None) -> _Stage:
    """Stage i of a one-process staged tree over its grid (shard views
    made per forward: on one device they are views of the staged
    leaves)."""
    tree = _stage_tree(params, i)
    grid = None if mesh is None else _stage_mesh(mesh, i)
    if grid is None or grid.size == 1:
        return _Stage(cfg, tree)
    return _Stage(cfg, sharding.shard_params(
        tree, sharding.TensorParallel(cfg, grid)))


def _first_leaf(tree: Params) -> torch.Tensor:
    leaf = next(iter(tree["layers"].values()))
    return leaf["q"] if is_quantized(leaf) else leaf


# ---------------------------------------------------------------------------
# Across processes
# ---------------------------------------------------------------------------


class _Link:
    """This process's point-to-point transfers to the neighbouring
    stages' processes over the ``("pipe",)`` group (``prev`` / ``next``:
    their indices in it, None at the ends), in the schedule's order; the
    sends stay pending until ``wait``.  ``j`` is the microbatch."""

    def __init__(self, group, prev: int | None, nxt: int | None):
        self.group, self.prev, self.next = group, prev, nxt
        self.pending: list = []

    def send_act(self, j: int, x: torch.Tensor) -> None:
        self.pending += collectives.send(x, self.next, self.group)

    def recv_act(self, j: int, shape: tuple, dtype, device) -> torch.Tensor:
        return collectives.recv(shape, dtype, device, self.prev, self.group)

    def send_grad(self, j: int, g: torch.Tensor) -> None:
        self.pending += collectives.send(g, self.prev, self.group)

    def recv_grad(self, j: int, like: torch.Tensor) -> torch.Tensor:
        return collectives.recv(tuple(like.shape), like.dtype, like.device,
                                self.next, self.group)

    def wait(self) -> None:
        collectives.wait_all(self.pending)


class _Processes:
    """A pipelined step's part in this process, over a mesh across
    processes: its stages (one, or all), the rows of each microbatch it
    computes (its data group's), its pipe neighbours and the groups its
    sums run over."""

    def __init__(self, cfg: ModelConfig, params: Params, pipe: int, m: int,
                 mesh: Mesh):
        if mesh.shape["pipe"] != pipe:
            raise ValueError(f"pipe={pipe} over a mesh of pipe="
                             f"{mesh.shape['pipe']}")
        if "stages" not in params:
            raise ValueError("a pipelined step across processes takes "
                             "stage_param_specs(cfg, staged, mesh)'s tree")
        self.cfg, self.params, self.pipe, self.m = cfg, params, pipe, m
        self.mine = sorted(params["stages"])
        self.shards = [params["stages"][i] for i in self.mine]
        self.stages = [_Stage(cfg, sh) for sh in self.shards]
        self.tp = self.shards[0].tp
        self.device = self.stages[0].device
        self.dtype = self.shards[0][0]["layers"]["attn_norm"].dtype
        # The batch's rows split over data only (sequence replicates).
        self.data = self.tp.data_group
        self.group = mesh.group("pipe")
        me = mesh.coords(next(i for i in range(mesh.size) if mesh.local(i)))

        def member(stage: int) -> int | None:
            if self.group is None or not 0 <= stage < pipe:
                return None
            at = dict(zip(("data", "fsdp", "pipe", "tensor", "expert",
                           "sequence"), me), pipe=stage)
            return self.group.ranks.index(
                mesh.processes[mesh.device_index(**at)])

        self.member = member
        self.first, self.last = self.mine[0], self.mine[-1]

    def rows(self, j: int, mb: int) -> slice:
        """This process's rows of microbatch j (its data group's block
        where ``data`` spans processes)."""
        if self.data is None:
            return slice(j * mb, (j + 1) * mb)
        per = mb // self.tp.d
        start = j * mb + self.tp.data_index * per
        return slice(start, start + per)

    def forward(self, tokens, positions, link: _Link, train: bool):
        """Every microbatch through this process's stages, in order:
        (received inputs, made gradient leaves when ``train``; outputs),
        one each per microbatch."""
        b, s = tokens.shape
        if b % self.m:
            raise ValueError(f"batch {b} not divisible by "
                             f"n_microbatches={self.m}")
        mb = b // self.m
        if self.data is not None and mb % self.tp.d:
            raise ValueError(f"microbatch of {mb} rows over "
                             f"data={self.tp.d}")
        ins, outs = [], []
        for j in range(self.m):
            rows = self.rows(j, mb)
            p = positions[rows].to(self.device)
            if self.first == 0:
                h = transformer._embed(self.cfg, self.params,
                                       tokens[rows].to(self.device))
                ins.append(None)
            else:
                h = link.recv_act(j, (rows.stop - rows.start, s,
                                      self.cfg.d_model), self.dtype,
                                  self.device)
                if train:
                    h.requires_grad_(True)
                ins.append(h)
            for stage in self.stages:
                h = stage(h, p)
            if self.last < self.pipe - 1:
                link.send_act(j, h)
            outs.append(h)
        return ins, outs

    def link(self) -> _Link:
        return _Link(self.group, self.member(self.first - 1),
                     self.member(self.last + 1))

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """The last stage's ``x`` on every stage."""
        return collectives.broadcast(x, self.member(self.pipe - 1),
                                     self.group)

    def logits(self, tokens, positions) -> torch.Tensor:
        """``pipeline_forward``'s logits ``[B, S, V]`` f32, whole on every
        process: the last stage's rows gathered over ``data``, then
        broadcast over ``pipe``."""
        link = self.link()
        with torch.no_grad():
            _, outs = self.forward(tokens, positions, link, train=False)
            link.wait()
            b, s = tokens.shape
            v = self.cfg.padded_vocab
            if self.last == self.pipe - 1:
                got = torch.stack([transformer._logits(self.cfg, self.params,
                                                       h) for h in outs])
                got = collectives._all_gather(got, 1, self.data) \
                    if self.data is not None else got
                got = got.reshape(b, s, v)
            else:
                got = torch.zeros((b, s, v), dtype=torch.float32,
                                  device=self.device)
            return self.broadcast(got)

    def train_grads(self, tokens, positions, leaves: list) -> torch.Tensor:
        """The forward and the backward of a train step: every leaf's
        ``.grad`` summed over this process's microbatches (None where the
        backward does not reach it); returns the loss on every process."""
        from llm_instance_gateway_tpu_torch.training import train

        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        in_pos, target_pos = positions[:, :-1], positions[:, 1:]
        mb = tokens.shape[0] // self.m
        # The count of real targets is the whole batch's: every process
        # holds every row, so it needs no collective.
        count = (target_pos > 0).float().sum().to(self.device).clamp_min(1.0)
        link = self.link()
        ins, outs = self.forward(inputs, in_pos, link, train=True)
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for j in reversed(range(self.m)):
            x = [ins[j]] if ins[j] is not None else []
            if self.last == self.pipe - 1:
                rows = self.rows(j, mb)
                logits = transformer._logits(self.cfg, self.params, outs[j])
                t, _ = train._masked_sum(logits,
                                         targets[rows].to(self.device),
                                         target_pos[rows].to(self.device))
                total = total + t.detach()
                torch.autograd.backward(t / count, inputs=leaves + x)
                del logits, t
            else:
                g = link.recv_grad(j, outs[j])
                torch.autograd.backward(outs[j], g, inputs=leaves + x)
            outs[j] = None
            if x:
                link.send_grad(j, x[0].grad)
                ins[j] = None
        link.wait()
        if self.last != self.pipe - 1:
            return self.broadcast(total)
        total = collectives.all_reduce(total, self.data)
        return self.broadcast(total / count)

    def sum_grads(self, leaves: list) -> None:
        """After the backward: each stage's gradients made the whole
        stage's over ``tensor`` (``train.shard_grads``: zero heads masked,
        KV-head replicas and replicated leaves summed), every leaf's
        summed over ``data``, and a tied ``embed``'s two copies (the first
        and the last stage's, on different processes) each the sum of
        both."""
        from llm_instance_gateway_tpu_torch.training import train

        for sh in self.shards:
            train.shard_grads(sh)
        if self.data is not None:
            for t in leaves:
                t.grad = collectives.all_reduce(t.grad, self.data)
        if self.cfg.tie_embeddings and self.group is not None:
            _tie_grads(self)


def _tie_grads(run: _Processes) -> None:
    """A tied ``embed``'s gradient: the first stage's (the embedding's)
    and the last stage's (the head's) copies each take the sum of both,
    sent point to point between the two processes (middle stages hold no
    copy)."""
    ends = {0: run.pipe - 1, run.pipe - 1: 0}
    own = run.first if run.first in ends else run.last
    if own not in ends:
        return
    me, other = run.member(own), run.member(ends[own])
    embed = run.params["embed"]
    # The lower member sends first, the higher receives first: under NCCL
    # two sends facing each other on one pair would each wait for the
    # other's receive.
    pending = collectives.send(embed.grad, other, run.group) \
        if me < other else []
    theirs = collectives.recv(tuple(embed.shape), embed.grad.dtype,
                              embed.device, other, run.group)
    if me > other:
        pending = collectives.send(embed.grad, other, run.group)
    collectives.wait_all(pending)
    embed.grad = embed.grad + theirs


def unstage(cfg: ModelConfig, tree: Params, like: Params, mesh: Mesh,
            value=None) -> Params:
    """The whole staged tree on the host in every process, from a tree
    across processes (``stage_param_specs``'): ``like`` (the whole
    ``stage_params`` tree) copied and overwritten with ``value(leaf)``
    (default: the leaf) of every stage's shards, ``embed`` from the first
    stage and ``final_norm`` / ``lm_head`` from the last.  Collective
    over the world.  For checks and exports."""
    value = value or (lambda x: x)
    pipe = mesh.shape["pipe"]
    mine = {}
    stages = tree["stages"]
    for i, sh in stages.items():
        for key, x in sharding.shard_values(sh, value).items():
            mine[(i,) + key] = x
    for k in ("embed", "final_norm", "lm_head"):
        owner = 0 if k == "embed" else pipe - 1
        if k in tree and owner in stages:
            mine[("top", k)] = value(tree[k]).detach().cpu()
    everyone = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(everyone, mine)
    got = {k: v for part in everyone for k, v in part.items()}
    out = sharding.map_tree(like, lambda x: x.detach().cpu().clone())
    for k in ("embed", "final_norm", "lm_head"):
        if ("top", k) in got:
            out[k].copy_(got[("top", k)])
    tp = next(iter(stages.values())).tp  # every stage's grid is alike
    for i in range(pipe):
        part = {key[1:]: x for key, x in got.items() if key[0] == i}
        sharding.fill_whole(_stage_tree(out, i), part, tp)
    return out


def _process_step(cfg: ModelConfig, optimizer, pipe: int, m: int,
                  mesh: Mesh):
    """The train step across processes (module docstring)."""
    from llm_instance_gateway_tpu_torch.training import train

    def step(params, opt_state, tokens, positions):
        run = _Processes(cfg, params, pipe, m, mesh)
        leaves = train._leaves(params)
        train._check_held(optimizer, leaves)
        with torch.enable_grad():
            for t in leaves:
                t.requires_grad_(True)
                t.grad = None
            loss = run.train_grads(tokens, positions, leaves)
        for t in leaves:
            if t.grad is None:
                t.grad = torch.zeros_like(t)
        run.sum_grads(leaves)
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return params, opt_state, loss

    return step


# ---------------------------------------------------------------------------
# The entry points
# ---------------------------------------------------------------------------


def pipeline_forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                     positions: torch.Tensor, pipe: int,
                     n_microbatches: int,
                     mesh: Mesh | None = None) -> torch.Tensor:
    """Pipelined full-prompt forward over a staged tree (``stage_params``,
    placed by ``stage_param_specs``).  Returns logits ``[B, S, V]`` f32 on
    the first device (across processes: on every process's device).  B
    must split into ``n_microbatches`` equal microbatches; with ``pipe ==
    1`` this is the plain layer loop and matches ``transformer.prefill``'s
    logits."""
    b, s = tokens.shape
    m = n_microbatches
    if mesh is not None and mesh.shape["pipe"] != pipe:
        raise ValueError(f"pipe={pipe} over a mesh of pipe="
                         f"{mesh.shape['pipe']}")
    if b % m != 0:
        raise ValueError(f"batch {b} not divisible by n_microbatches={m}")
    if mesh is not None and mesh.spans_processes:
        return _Processes(cfg, params, pipe, m, mesh).logits(tokens,
                                                             positions)
    mb = b // m
    dev0 = params["embed"].device
    tokens, positions = tokens.to(dev0), positions.to(dev0)
    stages = [_stage(cfg, params, i, mesh) for i in range(pipe)]
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
    """``train.causal_lm_loss`` with the pipelined forward plugged in (its
    value only across processes, where the train step runs its own
    backward)."""
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
    leaves in place, as ``train.make_full_train_step`` does.  Across
    processes ``params`` is ``stage_param_specs``' part of this process
    and the loss comes back on every process.  Raises ``ValueError`` for
    one process across cards with ``tensor``, ``data`` or ``fsdp`` above
    1 (one process a card serves those).  Every head layout the
    reference trains runs (the head plan's, ``ops/sharded_attention.
    head_plan``): in one process each forward cuts the stages' shards
    anew from the staged leaves, so a padded shard's copy passes its real
    heads' gradients back and its zero heads, constants, take none, and a
    KV head's replicas (views of one region) are summed by autograd;
    across processes ``train.shard_grads`` masks and sums them."""
    from llm_instance_gateway_tpu_torch.training import train

    if mesh is not None and mesh.spans_processes:
        return _process_step(cfg, optimizer, pipe, n_microbatches, mesh)
    if mesh is not None and len(set(mesh.devices)) > 1 and (
            mesh.shape["tensor"] > 1 or mesh.shape["data"] > 1
            or mesh.shape["fsdp"] > 1):
        raise ValueError(
            f"a pipelined train step across cards in one process runs pipe "
            f"with tensor=1 and data=1 and fsdp=1 (got "
            f"tensor={mesh.shape['tensor']}, data={mesh.shape['data']}, "
            f"fsdp={mesh.shape['fsdp']}): their reductions across cards in "
            "one process are NCCL calls autograd cannot differentiate; run "
            "one process a card instead (parallel/mesh."
            "initialize_distributed, make_mesh over the world, "
            "stage_param_specs and make_pipeline_train_step over that mesh: "
            "each stage in processes of its own, its activations and their "
            "gradients sent point to point)")
    return train.make_step(optimizer, lambda p, tokens, positions:
                           pipeline_lm_loss(cfg, p, tokens, positions, pipe,
                                            n_microbatches, mesh=mesh))
