"""Weight-only int8 quantization for serving (port of ``ops/quant.py``).

Quantized leaves are dicts ``{"q": int8 [..., in, out], "s": f32 [..., out]}``
in place of the dense tensor: symmetric per-output-channel scales over the
``in`` axis.  ``models.transformer`` routes every projection and the
``lm_head`` through ``matmul``, so dense and quantized trees share one
forward.  Scope, as in the reference: the seven per-layer projections
(dense ``[L, in, out]`` and MoE expert stacks ``[L, E, in, out]``, whose
scales are per (expert, out)) and ``lm_head``; embeddings, norms, the MoE
router and LoRA buffers stay dense.

``matmul`` is ``(x @ q.to(x.dtype)) * s.to(x.dtype)``, the reference's
arithmetic, and the ``expert_*`` contractions apply their scales after
the contraction the same way.  These are plain matrix products outside
any Pallas kernel in the JAX package, so they stay ``torch.matmul`` here.  Where XLA fuses the
int8 -> bf16 widening into the MXU feed, eager PyTorch writes and re-reads
a widened copy of each weight per call, so on the card int8 weights halve
the bytes at rest but not the bytes a decode step moves; a fused int8-weight
GEMM kernel is later work.
"""

from __future__ import annotations

from typing import Any

import torch

QUANT_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


# 127 as a 0-dim f32 tensor, one per device: the int8 quantizers' divisor.
_INT8_MAX: dict[torch.device, torch.Tensor] = {}


def int8_max(device: torch.device) -> torch.Tensor:
    """The int8 quantizers' divisor on ``device``, made on first use.  It
    is an f32 tensor, not a Python scalar: on the card ``t / 127.0``
    becomes ``t * fl(1 / 127)``, which rounds otherwise than the
    reference's division.  It must not be first made under a CUDA-graph
    capture (its fill would only be recorded); the decode graphs' eager
    warm-up and the prefills that precede any capture make it."""
    t = _INT8_MAX.get(device)
    if t is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("int8_max first made under graph capture")
        t = _INT8_MAX.setdefault(
            device, torch.full((), 127.0, dtype=torch.float32, device=device))
    return t


def quantize_weight(w: torch.Tensor) -> dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization (last axis = out),
    dividing by ``int8_max``."""
    wf = w.float()
    scale = (wf.abs().amax(dim=-2, keepdim=True) / int8_max(wf.device)
             ).clamp_min(1e-8)
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return {"q": q, "s": scale.squeeze(-2)}


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def matmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x @ w for dense tensors or quantized {"q","s"} leaves."""
    if is_quantized(w):
        return (x @ w["q"].to(x.dtype)) * w["s"].to(x.dtype)
    return x @ w


def _expert_einsum(product, scale_expand: int | None, x: torch.Tensor,
                   w: Any) -> torch.Tensor:
    """One expert-weight contraction, dense or int8: the per-(expert, out)
    scale applies after the contraction (exact: the scaled axis is never
    contracted), expanded at ``scale_expand`` where the output carries a
    capacity axis between the expert and channel axes."""
    if not is_quantized(w):
        return product(x, w)
    y = product(x, w["q"].to(x.dtype))
    s = w["s"].to(x.dtype)
    return y * (s if scale_expand is None else s.unsqueeze(scale_expand))


def _mix(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``...d,edf->...ef`` as one batched product over the weights as
    stored (``torch.einsum`` would permute the [E, d, f] stack into a
    copy)."""
    y = torch.matmul(x.reshape(-1, x.shape[-1]), w)  # [E, N, f]
    return y.transpose(0, 1).reshape(*x.shape[:-1], *y.shape[::2])


def _mix_down(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``...ef,efd->...ed``, likewise."""
    y = torch.bmm(x.reshape(-1, *x.shape[-2:]).transpose(0, 1), w)
    return y.transpose(0, 1).reshape(*x.shape[:-2], *y.shape[::2])


def expert_matmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """Per-expert tile product ``ecd,edf->ecf``: [E, C, din] x [E, din,
    dout] -> [E, C, dout] (the grouped dispatch's three products)."""
    return _expert_einsum(torch.bmm, -2, x, w)


def expert_mix(x: torch.Tensor, w: Any) -> torch.Tensor:
    """Dense all-experts up-projection ``...d,edf->...ef``: [..., din] x
    [E, din, f] -> [..., E, f]."""
    return _expert_einsum(_mix, None, x, w)


def expert_mix_down(x: torch.Tensor, w: Any) -> torch.Tensor:
    """Dense all-experts down-projection ``...ef,efd->...ed``: [..., E, f]
    x [E, f, d] -> [..., E, d] (the e axes align)."""
    return _expert_einsum(_mix_down, None, x, w)


def _quantize_stacked(w: torch.Tensor) -> dict[str, torch.Tensor]:
    """``quantize_weight`` of a layer-stacked [L, in, out] or [L, E, in,
    out] leaf, one layer at a time: the scale reduces over ``in`` only, so
    the result is bit-identical to the stacked call, and an 8B ``w_gate``
    never holds a whole-stack f32 copy (7.5 GB) — one layer's (235 MB) at
    most."""
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty(w.shape[:-2] + w.shape[-1:], dtype=torch.float32,
                    device=w.device)
    for i in range(w.shape[0]):
        part = quantize_weight(w[i])
        q[i], s[i] = part["q"], part["s"]
    return {"q": q, "s": s}


def quantize_params(params: dict) -> dict:
    """A NEW params tree with the big projections and ``lm_head``
    int8-quantized; the caller's tree is left as it was (its leaves are
    shared, not copied)."""
    out = dict(params)
    layers = dict(params["layers"])
    for name in QUANT_TARGETS:
        w = layers.get(name)
        if w is None or is_quantized(w):
            continue
        layers[name] = _quantize_stacked(w)
    out["layers"] = layers
    head = params.get("lm_head")
    if head is not None and not is_quantized(head):
        out["lm_head"] = quantize_weight(head)
    return out


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def quantized_bytes(params: dict) -> tuple[int, int]:
    """(bytes_now, bytes_if_dense_bf16) for the weight tree — memory audit."""
    now = dense = 0
    for leaf in _leaves(params):
        now += leaf.numel() * leaf.element_size()
        dense += leaf.numel() * (2 if leaf.dtype == torch.int8
                                 else leaf.element_size())
    return now, dense
