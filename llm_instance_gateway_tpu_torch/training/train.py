"""Train steps: full-parameter and LoRA-only fine-tuning on one device
(port of ``training/train.py``).

``make_lora_train_step`` freezes the base model and differentiates only the
adapter slot buffers — the loop that produces the adapters the serving
stack hot-swaps (``save_trained_adapter`` writes the ``.npz`` that
``/v1/load_lora_adapter`` takes).  The zero-padded rank lanes of a slot get
exactly zero gradients, so they stay zero.

Attention's gradient is a kernel on the card: ``ops/flash_attention.py``
sends a grad-requiring call through ``FlashAttention``, whose backward
launches ``csrc/flash_backward.cu`` (the plain backward on CPU tensors).

Differences from the reference, by design:
- the optimizer is ``torch.optim.AdamW`` with ``optax.adamw``'s constants
  (betas 0.9 / 0.999, eps 1e-8 outside the square root, none inside) and
  ``weight_decay`` always passed (torch's default is 0.01, optax's 0.0);
- the steps update the parameters (or the LoRA buffers) and the
  optimizer's state IN PLACE — the reference returns new trees — and
  return the loss as a device tensor, so a step never waits for the host;
  ``opt_state`` is passed through for the reference's call shape (the
  optimizer keeps its own state, ``optimizer.state``);
- a leaf the loss does not reach gets a zero gradient, not ``None``, so
  the update (weight decay included) touches every leaf as optax's does.
The pipelined trainer is ``parallel/pipeline.py`` (GPipe over ``pipe``,
its loss through ``logits_fn``, its step through ``make_step``).

The sharded recipe (the reference's: params over ``fsdp``, ``tensor``
and ``expert``, the batch over ``data`` and ``sequence``, the optimizer
state like the params): the steps take a ``parallel/sharding.Shards``
tree as well as a plain one, and ``make_optimizer`` of a ``Shards`` holds
the AdamW state of its leaves only.  In one process the shards are views
of the caller's tree on one device (the caller's tree is what updates);
across processes each process holds, computes and updates its own
shards, one device each (``parallel/mesh.initialize_distributed``).  The
loss is the reference's global masked mean: the masked sum of each data
group's rows over the count of real targets, both summed over ``data``
and ``sequence`` (``collectives.reduce``: its backward is the identity,
the loss being replicated).  Where ``sequence`` spans processes each
process runs the forward of its blocks of the row, the ring's attention
reading every block's K/V through the exchange (``collectives.
exchange``, whose backward sums each block's K/V gradient over the
processes), and takes its targets from the whole row it is handed
(``_ring_sum``).  After the backward a process sums over ``data`` and
``sequence`` every leaf's gradient, and the gradients of the leaves
every shard of a block holds whole (``sharding.tensor_replicated``) over
that block's group: the attention's over ``tensor``, the MLP's (its norm,
the router) over ``tensor`` and ``expert``, so replicated leaves come out
equal on every rank; the fsdp gather's backward leaves each piece its
own.  ``pipe`` across processes is refused by name (queued in
ROADMAP.md).
"""

from __future__ import annotations

from typing import Any

import torch

from llm_instance_gateway_tpu_torch.models import lora as lora_lib
from llm_instance_gateway_tpu_torch.models import transformer
from llm_instance_gateway_tpu_torch.models.configs import ModelConfig
from llm_instance_gateway_tpu_torch.parallel import (
    collectives,
    long_context,
    sharding,
)
from llm_instance_gateway_tpu_torch.server.lora_manager import save_adapter

# optax.adamw's defaults (b1, b2, eps; eps_root is 0).
BETAS = (0.9, 0.999)
EPS = 1e-8


def causal_lm_loss(cfg: ModelConfig, params, tokens, positions, lora_bufs=None,
                   slot_ids=None, logits_fn=None) -> torch.Tensor:
    """Next-token cross-entropy, masked to real (non-pad) positions.

    Position 0 repeated marks padding (the serving convention); the mask
    keeps pad targets out of the mean.  ``logits_fn(params, tokens,
    positions) -> [B, S, V]`` swaps the forward, so the shift/mask
    convention stays defined in one place.  A ``Shards`` ``params`` takes
    the sharded recipe (module docstring)."""
    if logits_fn is None and isinstance(params, sharding.Shards):
        return _sharded_loss(cfg, params, tokens, positions, lora_bufs,
                             slot_ids)
    if logits_fn is None:
        def logits_fn(p, t, pos):
            return transformer.prefill(
                cfg, p, t, pos, lora_bufs=lora_bufs, slot_ids=slot_ids)[0]

    logits = logits_fn(params, tokens[:, :-1], positions[:, :-1])
    total, count = _masked_sum(logits, tokens[:, 1:], positions[:, 1:])
    return total / count.clamp_min(1.0)


def _masked_sum(logits: torch.Tensor, targets, target_positions) -> tuple:
    """(the negative log-likelihood of ``targets`` summed over the real
    ones, whose positions are not 0, their count)."""
    mask = (target_positions > 0).float()
    logp = torch.log_softmax(logits, dim=-1)
    token_logp = logp.gather(-1, targets.long()[..., None])[..., 0]
    return -(token_logp * mask).sum(), mask.sum()


def _check_trainable(tp: sharding.TensorParallel) -> None:
    """The sharded step's layouts: each process's shards on one device,
    ``pipe`` left to the pipelined trainer (across processes
    ``TensorParallel`` refuses it)."""
    if not tp.one_device:
        raise ValueError(
            "a sharded train step runs each process's shards on one device: "
            "across cards run one process per card "
            "(parallel/mesh.initialize_distributed)")
    if tp.mesh.shape["pipe"] > 1:
        raise ValueError("pipe > 1 is the pipelined trainer's "
                         "(parallel/pipeline.make_pipeline_train_step)")


def _ring_sum(cfg: ModelConfig, params: sharding.Shards, tok, pos,
              lora_bufs, sids, group: int) -> tuple:
    """``_masked_sum`` of this process's sequence blocks, the sequence
    spanning processes: the forward's inputs (the row but its last token)
    right-padded to a multiple of ``sequence`` (pads at position 0, which
    the causal ring keeps out of every real query and the mask out of the
    sum), this process's blocks run through the ring, each position's
    target the next token of the whole row (a block's last position's is
    the next block's first)."""
    tp = params.tp
    inputs = (tok[:, :-1], pos[:, :-1], tok[:, 1:], pos[:, 1:])
    pad = -inputs[0].shape[1] % tp.n
    if pad:
        inputs = tuple(torch.nn.functional.pad(x, (0, pad)) for x in inputs)
    s_loc = inputs[0].shape[1] // tp.n
    mine = [slice(j * s_loc, (j + 1) * s_loc) for j in tp.seq_local]
    x, xp, targets, target_pos = inputs
    logits = transformer.prefill(
        cfg, params, [x[:, m] for m in mine], [xp[:, m] for m in mine],
        lora_bufs=lora_bufs, slot_ids=sids,
        attention_fn=long_context.ring_attend, data_group=group)[0]
    span = slice(mine[0].start, mine[-1].stop)
    return _masked_sum(logits.to(tok.device), targets[:, span],
                       target_pos[:, span])


def _sharded_loss(cfg: ModelConfig, params: sharding.Shards, tokens,
                  positions, lora_bufs, slot_ids) -> torch.Tensor:
    """The global masked mean over a ``Shards`` tree: each data group (this
    process's, across processes) its rows, across processes over
    ``sequence`` each process its blocks of them (``_ring_sum``), the sum
    and the count of real targets summed over ``data`` and
    ``sequence``."""
    tp = params.tp
    _check_trainable(tp)
    b = tokens.shape[0]
    if b % tp.d:
        raise ValueError(f"a batch of {b} rows over data={tp.d}")
    per = b // tp.d
    dev = tp.device(0)
    total = count = None
    for g in ([tp.data_index] if tp.multi else range(tp.d)):
        rows = slice(g * per, (g + 1) * per)
        tok, pos = tokens[rows].to(dev), positions[rows].to(dev)
        sids = None if slot_ids is None else slot_ids[rows].to(dev)
        if tp.seq_group is not None:
            t, c = _ring_sum(cfg, params, tok, pos, lora_bufs, sids, g)
        else:
            logits = transformer.prefill(
                cfg, params, tok[:, :-1], pos[:, :-1], lora_bufs=lora_bufs,
                slot_ids=sids, data_group=g)[0].to(dev)
            t, c = _masked_sum(logits, tok[:, 1:], pos[:, 1:])
        total, count = ((t, c) if total is None
                        else (total + t, count + c))
    count = collectives.all_reduce(count, tp.rows_group)
    return collectives.reduce(total, tp.rows_group) / count.clamp_min(1.0)


def _leaves(tree) -> list:
    """The distinct floating tensors of a nested dict, a ``Shards`` (its
    local trees, an ``FsdpLeaf``'s local pieces) or a list (a staged
    leaf's stages across cards), in the tree's order."""
    out, seen = [], set()
    for leaf in _walk(tree):
        if leaf.is_floating_point() and id(leaf) not in seen:
            seen.add(id(leaf))
            out.append(leaf)
    return out


def _walk(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
        return
    if isinstance(tree, sharding.FsdpLeaf):
        yield from tree.pieces
        return
    values = tree if isinstance(tree, (list, tuple)) else tree.values()
    for v in values:
        yield from _walk(v)


def make_optimizer(params, lr: float = 1e-4,
                   weight_decay: float = 0.0) -> torch.optim.AdamW:
    """``optax.adamw(lr, weight_decay=weight_decay)`` over the floating
    leaves of ``params`` (a parameter tree or LoRA buffers): AdamW with
    optax's constants, the weight decay passed explicitly."""
    return torch.optim.AdamW(_leaves(params), lr=lr, betas=BETAS, eps=EPS,
                             weight_decay=weight_decay)


def _check_held(optimizer: torch.optim.Optimizer, leaves: list) -> None:
    held = {id(p) for group in optimizer.param_groups for p in group["params"]}
    if held != {id(t) for t in leaves}:
        raise ValueError("the optimizer does not hold exactly this tree's "
                         "leaves (build it with make_optimizer(tree))")


def _set_grads(loss: torch.Tensor, leaves: list, tree=None) -> None:
    """Each leaf's ``.grad``: d loss / d leaf, zeros where the loss does
    not reach it; for a ``Shards`` ``tree``, summed over the processes
    that hold the leaf's other parts (module docstring)."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for t, g in zip(leaves, grads):
        t.grad = torch.zeros_like(t) if g is None else g
    if not isinstance(tree, sharding.Shards):
        return
    tp = tree.tp
    for attn, group in ((True, tp.attn_group), (False, tp.mlp_group)):
        if group is not None:
            for t in sharding.tensor_replicated(tree, attn):
                t.grad = collectives.all_reduce(t.grad, group)
    if tp.rows_group is not None:
        for t in leaves:
            t.grad = collectives.all_reduce(t.grad, tp.rows_group)


def make_step(optimizer: torch.optim.Optimizer, loss_fn):
    """A full-parameter train step over ``loss_fn(params, tokens,
    positions)``: ``step(params, opt_state, tokens, positions) ->
    (params, opt_state, loss)``, every floating leaf of ``params``
    trained, in place."""

    def step(params, opt_state, tokens, positions):
        leaves = _leaves(params)
        _check_held(optimizer, leaves)
        with torch.enable_grad():
            for t in leaves:
                t.requires_grad_(True)
            loss = loss_fn(params, tokens, positions)
            _set_grads(loss, leaves, params)
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return params, opt_state, loss.detach()

    return step


def make_full_train_step(cfg: ModelConfig, optimizer: torch.optim.Optimizer):
    """Full-parameter train step: ``step(params, opt_state, tokens,
    positions) -> (params, opt_state, loss)``.  ``optimizer`` is
    ``make_optimizer(params)``; the step updates ``params`` in place."""
    return make_step(optimizer, lambda p, tokens, positions: causal_lm_loss(
        cfg, p, tokens, positions))


def make_lora_train_step(cfg: ModelConfig, optimizer: torch.optim.Optimizer):
    """Adapter-only train step: ``step(params, lora_bufs, opt_state, tokens,
    positions, slot_ids) -> (lora_bufs, opt_state, loss)``.  The base
    ``params`` are frozen inputs (the step sets no ``requires_grad`` on
    them, so a bf16 or int8 base tree serves as it is); ``optimizer`` is
    ``make_optimizer(lora_bufs)``; the step updates ``lora_bufs`` in place."""

    def step(params, lora_bufs, opt_state, tokens, positions, slot_ids):
        _check_held(optimizer, _leaves(lora_bufs))
        scales = _leaves([t["scale"] for t in sharding.parts(lora_bufs)])
        held = {id(t) for t in scales}
        trainable = [t for t in _leaves(lora_bufs) if id(t) not in held]
        with torch.enable_grad():
            for t in trainable:
                t.requires_grad_(True)
            loss = causal_lm_loss(cfg, params, tokens, positions,
                                  lora_bufs=lora_bufs, slot_ids=slot_ids)
            _set_grads(loss, trainable, lora_bufs)
        # The scale vector is serving metadata (alpha/r), not a trainable:
        # an explicit zero gradient keeps it in the update, as optax's
        # zeroed leaf does, so weight decay > 0 decays it there too.
        for t in scales:
            t.grad = torch.zeros_like(t)
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return lora_bufs, opt_state, loss.detach()

    return step


def extract_adapter(cfg: ModelConfig, lora_bufs, slot: int,
                    rank: int) -> dict[str, Any]:
    """One trained slot back out as a rank-r adapter weight dict
    ``{target: {"a": [L, d_in, r], "b": [L, r, d_out]}}`` (the inverse of
    ``models.lora.write_adapter``): detached f32 numpy arrays on the host
    (a bf16 buffer's values exactly)."""
    weights: dict[str, Any] = {}
    for t in lora_lib.TARGETS:
        a = lora_bufs[f"{t}_a"][:, slot, :, :rank]
        b = lora_bufs[f"{t}_b"][:, slot, :rank, :]
        weights[t] = {"a": a.detach().float().cpu().numpy(),
                      "b": b.detach().float().cpu().numpy()}
    return weights


def save_trained_adapter(path: str, cfg: ModelConfig, lora_bufs, slot: int,
                         rank: int, alpha: float) -> None:
    """Write slot ``slot`` as the ``.npz`` adapter that
    ``/v1/load_lora_adapter`` and ``load_adapter_checkpoint`` read."""
    save_adapter(path, extract_adapter(cfg, lora_bufs, slot, rank), alpha,
                 rank)
