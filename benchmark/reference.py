"""The plain reference: a decoder's forward pass in float32 PyTorch
operations, with no kernel, cache or batching of the port's.

It imports nothing of ``llm_instance_gateway_tpu_torch`` and takes nothing
the port made: it reads the tree ``benchmark/weights.py`` draws (int8
leaves dequantized here, per output channel) and the adapters' weights as
the benchmark made them.  The layer equations are the published ones of
the two families the benchmark runs: Qwen2 (RMSNorm, rotary embedding in
the split-halves convention, grouped-query attention with q/k/v biases,
SwiGLU) and Mixtral (the same attention without biases, and a top-2
mixture of SwiGLU experts whose gates are a softmax over the two chosen
router logits, ties to the lower expert).  LoRA adds ``(x @ a) @ b *
alpha / rank`` to a projection; a mixture of experts carries adapters on
attention only.

``control`` (one of ``CONTROLS``) computes the weight products in a lower
precision: each dequantized weight matrix, and for fp8 each product's
input rows, rounded as that precision holds them.
"""
from __future__ import annotations

import math

import torch

ROW_BLOCK = 1024


def _matrix(leaf, i: int, transform=None) -> torch.Tensor:
    """Layer ``i`` of a stacked leaf as f32 ([..., in, out]); an int8 leaf
    ``{"q", "s"}`` times its per-output-channel scale."""
    if isinstance(leaf, dict):
        w = leaf["q"][i].float() * leaf["s"][i].float().unsqueeze(-2)
    else:
        w = leaf[i].float()
    return w if transform is None else transform(w)


def _head(leaf, transform=None) -> torch.Tensor:
    if isinstance(leaf, dict):
        w = leaf["q"].float() * leaf["s"].float().unsqueeze(-2)
    else:
        w = leaf.float()
    return w if transform is None else transform(w)


def fp8_per_channel(w: torch.Tensor) -> torch.Tensor:
    """w rounded to float8 e4m3 with one f32 scale per output channel."""
    s = (w.abs().amax(dim=-2, keepdim=True) / 448.0).clamp_min(1e-12)
    return (w / s).to(torch.float8_e4m3fn).float() * s


def fp8_per_row(x: torch.Tensor) -> torch.Tensor:
    """A product's input rows rounded to float8 e4m3, one scale a row (a
    token), as an fp8 GEMM takes them."""
    s = (x.abs().amax(dim=-1, keepdim=True) / 448.0).clamp_min(1e-12)
    return (x / s).to(torch.float8_e4m3fn).float() * s


def int4_per_channel(w: torch.Tensor) -> torch.Tensor:
    """w rounded to symmetric int4 ([-7, 7]) per output channel."""
    s = (w.abs().amax(dim=-2, keepdim=True) / 7.0).clamp_min(1e-12)
    return torch.round(w / s).clamp(-7, 7) * s


# A control: (weights, inputs of the weight products).  bf16 is served,
# so the step below computes the projections, experts and head in fp8,
# both operands; int8 weights (activations bf16) step down to int4 weights.
CONTROLS = {"fp8": (fp8_per_channel, fp8_per_row),
            "int4": (int4_per_channel, None)}


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, heads, hd]; pairs (x_i, x_{i + hd/2})."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = pos.float()[:, None] * inv  # [S, hd/2]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v) -> torch.Tensor:
    """Causal grouped-query attention; q [S, H, hd], k/v [S, K, hd]; query
    rows in blocks so the scores stay small."""
    s, h, hd = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)  # [H, S, hd]
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for r0 in range(0, s, ROW_BLOCK):
        r1 = min(s, r0 + ROW_BLOCK)
        qb = q[r0:r1].transpose(0, 1) / math.sqrt(hd)  # [H, b, hd]
        sc = qb @ k[:, :r1].transpose(1, 2)  # [H, b, r1]
        mask = (torch.arange(r0, r1, device=q.device)[:, None]
                < torch.arange(r1, device=q.device)[None])
        sc.masked_fill_(mask, float("-inf"))
        out[r0:r1] = (torch.softmax(sc, dim=-1) @ v[:, :r1]).transpose(0, 1)
    return out


class Model:
    """A tree (``benchmark/weights.make_params``' layout) and its sizes
    (``weights.dims``).  ``logits`` runs several sequences together, a
    layer at a time, so each layer's weights are widened to f32 once."""

    def __init__(self, m: dict, params: dict, control=None):
        self.m = m
        self.p = params
        self.t, self.a = control or (None, None)

    def _in(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.a is None else self.a(x)

    def _w(self, name: str, i: int, expert: int | None = None):
        leaf = self.p["layers"][name]
        if expert is not None:
            leaf = ({k: v[:, expert] for k, v in leaf.items()}
                    if isinstance(leaf, dict) else leaf[:, expert])
        return _matrix(leaf, i, self.t)

    @staticmethod
    def _lora(x, i, target, adapter):
        if adapter is None or target not in adapter["w"]:
            return 0.0
        ab = adapter["w"][target]
        a = ab["a"][i].to(x.device, torch.float32)
        b = ab["b"][i].to(x.device, torch.float32)
        return (x @ a) @ b * adapter["scale"]

    def _proj(self, xs, w, i, target, adapters):
        return [self._in(x) @ w + self._lora(x, i, target, ad)
                for x, ad in zip(xs, adapters)]

    def _moe(self, x, i) -> torch.Tensor:
        m = self.m
        logits = x @ self.p["layers"]["router"][i].float()
        _, order = torch.sort(logits, dim=-1, descending=True, stable=True)
        top = order[:, :m["k_experts"]]
        gates = torch.softmax(torch.gather(logits, 1, top), dim=-1)
        out = torch.zeros_like(x)
        for e in range(m["E"]):
            rows, slot = torch.nonzero(top == e, as_tuple=True)
            if rows.numel() == 0:
                continue
            xe = self._in(x[rows])
            h = (torch.nn.functional.silu(xe @ self._w("w_gate", i, e))
                 * (xe @ self._w("w_up", i, e)))
            y = self._in(h) @ self._w("w_down", i, e)
            out.index_add_(0, rows, y * gates[rows, slot][:, None])
        return out

    def logits(self, seqs: list, rows: list, adapters: list) -> list:
        """f32 logits ``[len(rows[j]), vocab]`` at positions ``rows[j]`` of
        one causal pass over each token list ``seqs[j]``; ``adapters[j]``
        is ``{"w": {target: {"a", "b"}}, "scale": alpha / rank}`` or None
        (the base model)."""
        m, p = self.m, self.p
        dev = p["embed"].device
        lay = p["layers"]
        xs = [p["embed"][torch.tensor(t, dtype=torch.long,
                                      device=dev)].float() for t in seqs]
        pos = [torch.arange(len(t), device=dev) for t in seqs]
        for i in range(m["L"]):
            hn = [_rms(x, lay["attn_norm"][i], m["eps"]) for x in xs]
            qkv = []
            for name, t in (("wq", "q"), ("wk", "k"), ("wv", "v")):
                out = self._proj(hn, self._w(name, i), i, t, adapters)
                if m["bias"]:
                    out = [o + lay[name + "_b"][i].float() for o in out]
                qkv.append(out)
            att = []
            for q, k, v, ps in zip(*qkv, pos):
                s = len(ps)
                att.append(_attention(
                    _rope(q.view(s, m["H"], m["hd"]), ps, m["theta"]),
                    _rope(k.view(s, m["K"], m["hd"]), ps, m["theta"]),
                    v.view(s, m["K"], m["hd"])).reshape(s, -1))
            wo = self._w("wo", i)
            xs = [x + o for x, o in
                  zip(xs, self._proj(att, wo, i, "o", adapters))]
            hn = [_rms(x, lay["mlp_norm"][i], m["eps"]) for x in xs]
            if m["E"]:
                y = self._moe(torch.cat(hn), i)
                xs = [x + part for x, part in
                      zip(xs, torch.split(y, [len(h) for h in hn]))]
            else:
                g = self._proj(hn, self._w("w_gate", i), i, "gate", adapters)
                u = self._proj(hn, self._w("w_up", i), i, "up", adapters)
                act = [torch.nn.functional.silu(a) * b for a, b in zip(g, u)]
                xs = [x + d for x, d in zip(xs, self._proj(
                    act, self._w("w_down", i), i, "down", adapters))]
        head = _head(p["lm_head"], self.t)
        return [self._in(_rms(x[torch.tensor(r, device=dev)],
                              p["final_norm"], m["eps"])) @ head
                for x, r in zip(xs, rows)]


def served_gaps(ref: torch.Tensor, served: list) -> torch.Tensor:
    """Per served token, how far its reference logit lies below the
    reference's best at that position."""
    idx = torch.tensor(served, device=ref.device)[:, None]
    return ref.max(dim=-1).values - ref.gather(1, idx)[:, 0]
