"""Seeded weights and adapters, made on the device in a few large draws.

The tree is the port's layout (``{"embed", "layers": {...}, "final_norm",
"lm_head"}``, layer leaves stacked ``[L, ...]``, expert stacks ``[L, E,
in, out]``, int8 leaves ``{"q": int8, "s": f32 per output channel}``), so
it goes to ``api_http.make_server(params=...)`` as it is.  Every leaf has
a generator of its own, seeded from the run's seed and the leaf's name, so
the reference can draw any leaf again, bit for bit, after the program is
gone.  Weights are drawn in the dtype they are served in; int8 weights are
drawn as int8 (uniform over [-127, 127]) with f32 scales, since a bf16
Mixtral (~93 GB) does not fit the card.
"""
from __future__ import annotations

import hashlib
import math

import torch

ATTN_TARGETS = ("q", "k", "v", "o")
MLP_TARGETS = ("gate", "up", "down")
QUANT_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
# Standard deviation of integers uniform over [-127, 127].
INT8_STD = math.sqrt((255 ** 2 - 1) / 12)


def _gen(seed: int, name: str, device) -> torch.Generator:
    h = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return torch.Generator(device=device).manual_seed(
        int.from_bytes(h[:8], "little") & (2**63 - 1))


def dims(model: dict) -> dict:
    """The sizes the tree needs, from a configuration's ``model`` (the
    published config's keys)."""
    h = model["num_attention_heads"]
    hd = model.get("head_dim") or model["hidden_size"] // h
    return {
        "d": model["hidden_size"], "f": model["intermediate_size"],
        "L": model["num_hidden_layers"], "H": h,
        "K": model["num_key_value_heads"], "hd": hd,
        "V": model["vocab_size"], "E": model.get("num_local_experts", 0),
        "k_experts": model.get("num_experts_per_tok", 0),
        "bias": model.get("model_type") == "qwen2",
        "eps": model["rms_norm_eps"], "theta": model["rope_theta"],
    }


def leaf_shapes(model: dict) -> dict:
    """Leaf name -> (shape, fan_in or None); ``layers.`` names stacked."""
    m = dims(model)
    d, f, n_l, e = m["d"], m["f"], m["L"], m["E"]
    qd, kd = m["H"] * m["hd"], m["K"] * m["hd"]
    ex = (e,) if e else ()
    out = {
        "embed": ((m["V"], d), None),
        "lm_head": ((d, m["V"]), d),
        "layers.wq": ((n_l, d, qd), d), "layers.wk": ((n_l, d, kd), d),
        "layers.wv": ((n_l, d, kd), d), "layers.wo": ((n_l, qd, d), qd),
        "layers.w_gate": ((n_l, *ex, d, f), d),
        "layers.w_up": ((n_l, *ex, d, f), d),
        "layers.w_down": ((n_l, *ex, f, d), f),
    }
    if e:
        out["layers.router"] = ((n_l, d, e), d)
    if m["bias"]:
        out["layers.wq_b"] = ((n_l, qd), None)
        out["layers.wk_b"] = ((n_l, kd), None)
        out["layers.wv_b"] = ((n_l, kd), None)
    return out


def make_leaf(name: str, model: dict, seed: int, device, dtype,
              int8: bool):
    """One leaf, drawn from its own generator."""
    shape, fan_in = leaf_shapes(model)[name]
    gen = _gen(seed, name, device)
    short = name.split(".")[-1]
    if int8 and (short in QUANT_LEAVES or name == "lm_head"):
        q = torch.randint(-127, 128, shape, generator=gen, device=device,
                          dtype=torch.int8)
        s = torch.rand(shape[:-2] + shape[-1:], generator=gen, device=device,
                       dtype=torch.float32)
        s = (0.75 + 0.5 * s) / (INT8_STD * math.sqrt(fan_in))
        return {"q": q, "s": s}
    w = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    if name == "embed":
        return w.mul_(0.02)
    if fan_in is None:  # q/k/v biases
        return w.mul_(0.5)
    return w.mul_(1.0 / math.sqrt(fan_in))


def make_params(model: dict, seed: int, device, dtype, int8: bool) -> dict:
    """The whole tree, in the port's layout."""
    m = dims(model)
    layers = {
        "attn_norm": torch.ones((m["L"], m["d"]), dtype=dtype, device=device),
        "mlp_norm": torch.ones((m["L"], m["d"]), dtype=dtype, device=device),
    }
    params = {"layers": layers,
              "final_norm": torch.ones((m["d"],), dtype=dtype, device=device)}
    for name in leaf_shapes(model):
        leaf = make_leaf(name, model, seed, device, dtype, int8)
        if name.startswith("layers."):
            layers[name.split(".", 1)[1]] = leaf
        else:
            params[name] = leaf
    return params


def adapter_targets(model: dict) -> tuple:
    """The port applies no LoRA to expert weights (as its reference), so a
    mixture of experts' adapters hold the attention targets only."""
    return ATTN_TARGETS if dims(model)["E"] else ATTN_TARGETS + MLP_TARGETS


def target_dims(model: dict) -> dict:
    m = dims(model)
    qd, kd = m["H"] * m["hd"], m["K"] * m["hd"]
    d, f = m["d"], m["f"]
    return {"q": (d, qd), "k": (d, kd), "v": (d, kd), "o": (qd, d),
            "gate": (d, f), "up": (d, f), "down": (f, d)}


def make_adapter(model: dict, seed: int, index: int, rank: int, device,
                 dtype) -> dict:
    """Adapter ``index``: ``{target: {"a": [L, in, r], "b": [L, r, out]}}``
    as f32 CPU tensors holding values of ``dtype`` (the slot buffers' type,
    so the port stores them exactly).  ``b`` is not zero: a delta of about
    half the base projection's size, so a dropped delta shows."""
    n_l = dims(model)["L"]
    out = {}
    for t in adapter_targets(model):
        d_in, d_out = target_dims(model)[t]
        gen = _gen(seed, f"adapter{index}.{t}", device)
        a = torch.randn((n_l, d_in, rank), generator=gen, device=device,
                        dtype=dtype) * (1.0 / math.sqrt(d_in))
        b = torch.randn((n_l, rank, d_out), generator=gen, device=device,
                        dtype=dtype) * (0.5 / math.sqrt(rank))
        out[t] = {"a": a.float().cpu(), "b": b.float().cpu()}
    return out


def adapter_name(index: int) -> str:
    return f"tenant{index}"
