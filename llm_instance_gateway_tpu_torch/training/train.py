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
The sharded recipe (params over an fsdp/tensor mesh, one jitted program)
and the pipelined trainer (``parallel/pipeline.py``) need more than one
card and are not ported here; ``logits_fn`` stays for the latter.
"""

from __future__ import annotations

from typing import Any

import torch

from llm_instance_gateway_tpu_torch.models import lora as lora_lib
from llm_instance_gateway_tpu_torch.models import transformer
from llm_instance_gateway_tpu_torch.models.configs import ModelConfig
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
    convention stays defined in one place."""
    if logits_fn is None:
        def logits_fn(p, t, pos):
            return transformer.prefill(
                cfg, p, t, pos, lora_bufs=lora_bufs, slot_ids=slot_ids)[0]

    logits = logits_fn(params, tokens[:, :-1], positions[:, :-1])
    targets = tokens[:, 1:].long()
    mask = (positions[:, 1:] > 0).float()
    logp = torch.log_softmax(logits, dim=-1)
    token_logp = logp.gather(-1, targets[..., None])[..., 0]
    return -(token_logp * mask).sum() / mask.sum().clamp_min(1.0)


def _leaves(tree) -> list:
    """The floating tensors of a nested dict, in the tree's order."""
    if isinstance(tree, torch.Tensor):
        return [tree] if tree.is_floating_point() else []
    return [leaf for v in tree.values() for leaf in _leaves(v)]


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


def _set_grads(loss: torch.Tensor, leaves: list) -> None:
    """Each leaf's ``.grad``: d loss / d leaf, zeros where the loss does
    not reach it."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for t, g in zip(leaves, grads):
        t.grad = torch.zeros_like(t) if g is None else g


def make_full_train_step(cfg: ModelConfig, optimizer: torch.optim.Optimizer):
    """Full-parameter train step: ``step(params, opt_state, tokens,
    positions) -> (params, opt_state, loss)``.  ``optimizer`` is
    ``make_optimizer(params)``; the step updates ``params`` in place."""

    def step(params, opt_state, tokens, positions):
        leaves = _leaves(params)
        _check_held(optimizer, leaves)
        with torch.enable_grad():
            for t in leaves:
                t.requires_grad_(True)
            loss = causal_lm_loss(cfg, params, tokens, positions)
            _set_grads(loss, leaves)
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return params, opt_state, loss.detach()

    return step


def make_lora_train_step(cfg: ModelConfig, optimizer: torch.optim.Optimizer):
    """Adapter-only train step: ``step(params, lora_bufs, opt_state, tokens,
    positions, slot_ids) -> (lora_bufs, opt_state, loss)``.  The base
    ``params`` are frozen inputs (the step sets no ``requires_grad`` on
    them, so a bf16 or int8 base tree serves as it is); ``optimizer`` is
    ``make_optimizer(lora_bufs)``; the step updates ``lora_bufs`` in place."""

    def step(params, lora_bufs, opt_state, tokens, positions, slot_ids):
        _check_held(optimizer, _leaves(lora_bufs))
        trainable = [t for key, t in lora_bufs.items() if key != "scale"]
        with torch.enable_grad():
            for t in trainable:
                t.requires_grad_(True)
            loss = causal_lm_loss(cfg, params, tokens, positions,
                                  lora_bufs=lora_bufs, slot_ids=slot_ids)
            _set_grads(loss, trainable)
        # The scale vector is serving metadata (alpha/r), not a trainable:
        # an explicit zero gradient keeps it in the update, as optax's
        # zeroed leaf does, so weight decay > 0 decays it there too.
        lora_bufs["scale"].grad = torch.zeros_like(lora_bufs["scale"])
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
