"""The yardstick: the card's published peaks and the operations and bytes
the traffic needs, counted from the model's sizes and the requests'
lengths, never from what the implementation happens to do.

Peaks are NVIDIA's data sheet figures for one H100 SXM (dense, without
sparsity, at the full 700 W limit): 989 TFLOP/s in bf16 and 3.35 TB/s of
HBM.
"""
from __future__ import annotations

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
KV_BYTES = 2  # bf16 keys and values


def body_params_per_token(m: dict) -> int:
    """Weights a token's pass multiplies by, outside the output head:
    attention's four projections and the MLP (a mixture of experts: the
    router and the ``k_experts`` experts it picks)."""
    d, f = m["d"], m["f"]
    attn = d * (m["H"] * m["hd"]) * 2 + d * (m["K"] * m["hd"]) * 2
    mlp = 3 * d * f
    if m["E"]:
        mlp = m["k_experts"] * mlp + d * m["E"]
    return m["L"] * (attn + mlp)


def head_params(m: dict) -> int:
    return m["d"] * m["V"]


def attn_flops(m: dict, ctx: int) -> float:
    """QK and PV products of one query against ``ctx`` keys, all layers."""
    return 4.0 * m["L"] * m["H"] * m["hd"] * ctx


def attn_flops_span(m: dict, first: int, last: int) -> float:
    """``attn_flops`` summed over the queries at positions ``first`` ..
    ``last - 1`` of a causal pass (query p sees p + 1 keys)."""
    n = last - first
    if n <= 0:
        return 0.0
    keys = n * (first + last + 1) / 2.0
    return 4.0 * m["L"] * m["H"] * m["hd"] * keys


def prefill_flops(m: dict, reused: int, n: int) -> float:
    """A prompt of ``n`` tokens whose first ``reused`` came from the prefix
    cache: the rest through the body, the last through the head."""
    return (2.0 * body_params_per_token(m) * (n - reused)
            + 2.0 * head_params(m) + attn_flops_span(m, reused, n))


def decode_flops(m: dict, ctx: int) -> float:
    """One decoded token whose step attends over ``ctx`` positions."""
    return (2.0 * (body_params_per_token(m) + head_params(m))
            + attn_flops(m, ctx))


def kv_bytes(m: dict, ctx: int) -> float:
    """Keys and values one decode step reads for a row of ``ctx``
    positions, each byte once, all layers."""
    return 2.0 * m["L"] * m["K"] * m["hd"] * KV_BYTES * ctx
