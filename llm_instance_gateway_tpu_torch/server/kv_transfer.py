"""Cross-engine prefill/decode disaggregation: the KV-block handoff plane
(port of ``server/kv_transfer.py``).

Disaggregated serving runs prefill and decode on SEPARATE replicas, so a
long prefill never takes device time from co-resident decode slots.
``Engine.prefill_only()`` produces a handoff on a prefill-role replica (no
decode slot touched); ``Engine.attach_prefilled()`` admits it into decode
on a decode-role replica, skipping prefill.

- ``PrefillHandoff``: a prefilled request's KV (raw compute dtype or
  int8-quantized, per layer) plus the sampling carry: the first sampled
  token, its logprob info, and what rebuilds the ``Request`` on the decode
  side (sampling params, stop ids, the original OpenAI body).
- The wire (``to_bytes``/``from_bytes``) is the reference's, byte for byte:
  magic, a little-endian u32 header length, one JSON header, then the raw
  little-endian array payloads.  No pickle: handoffs cross trust boundaries
  between replicas, and a JAX replica and a torch replica read each
  other's handoffs.

The arrays are host torch tensors.  A ``"bfloat16"`` payload is raw bf16
bits read and written through an int16 view, so neither side needs
``ml_dtypes``.

Quantization note (token parity): the int8 wire lane quantizes with the
engine's KV-cache quantizer itself (``transformer._kv_quantize``:
symmetric per-(position, KV head) max-abs, f32 scales, half-to-even
rounding), where the KV lives, so an export from the card copies int8 to
the host, not the compute dtype.  Dequantize then re-quantize is
value-stable (the largest element maps to exactly +-127, so the scale
round-trips), which keeps an int8 decode engine's cache bit-identical to
collocated serving when fed either wire lane.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass

import numpy as np
import torch

from llm_instance_gateway_tpu_torch.models.transformer import _kv_quantize

_MAGIC = b"LIGKVH1\n"

# Wire dtypes are whitelisted: the header is attacker-influencable text.
_WIRE_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                "bfloat16": torch.bfloat16, "int8": torch.int8}
_WIRE_NAMES = {dt: name for name, dt in _WIRE_DTYPES.items()}


def _torch_dtype(name: str) -> torch.dtype:
    if name not in _WIRE_DTYPES:
        raise ValueError(f"unsupported handoff dtype {name!r}")
    return _WIRE_DTYPES[name]


def _dtype_name(t: torch.Tensor) -> str:
    if t.dtype not in _WIRE_NAMES:
        raise ValueError(f"unsupported handoff dtype {t.dtype}")
    return _WIRE_NAMES[t.dtype]


def _le_bytes(t: torch.Tensor) -> bytes:
    """A host tensor's raw little-endian bytes (bf16 through an int16
    view: numpy has no bfloat16)."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


@dataclass
class PrefillHandoff:
    """One prefilled request, serializable across an engine boundary.

    KV layout: ``k``/``v`` are ``[L, n, Kh, hd]`` host tensors trimmed to
    the true prompt length (no bucket padding crosses the wire).
    ``kv_format`` is ``"raw"`` (the prefill's compute dtype, recorded in
    ``kv_dtype``) or ``"int8"`` (``k``/``v`` int8 + ``k_scale``/``v_scale``
    f32 ``[L, n, Kh]``).
    """

    request_id: str
    prompt_tokens: list[int]
    n: int
    adapter: str | None
    max_new_tokens: int
    sampling: dict
    stop_token_ids: list[int]
    # Tokenized multi-token stop strings: the decode hop's device-side stop
    # automata need the suffixes the prefill hop validated.
    stop_sequences: list[list[int]]
    logprobs: int | None
    # Sampling carry: the prefill's sampled first token and its logprob info.
    first_token: int
    first_lp: float | None
    first_top_vals: list[float] | None
    first_top_ids: list[int] | None
    t_submit: float
    kv_format: str
    kv_dtype: str
    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None
    # Original OpenAI request body (dict): the decode hop shapes the client
    # envelope (stream, stop, model name) from it.
    body: dict | None = None
    # The request's trace id rides the wire so the decode hop can tag its
    # work with the same id when a transport drops the header.
    trace_id: str | None = None

    # -- KV access ----------------------------------------------------------

    def kv_arrays(self, device=None) -> tuple[torch.Tensor, torch.Tensor]:
        """(k, v) as float tensors ``[L, n, Kh, hd]`` ready for a cache
        insert, on ``device`` (default: where they are).  The int8 lane
        moves as int8 and dequantizes to f32 there (the product is the
        same IEEE f32 on the host and the card); the decode engine's insert
        re-quantizes if ITS cache is int8."""
        def moved(t):
            return t if device is None else t.to(device)

        if self.kv_format == "int8":
            k = moved(self.k).float() * moved(self.k_scale)[..., None]
            v = moved(self.v).float() * moved(self.v_scale)[..., None]
            return k, v
        return moved(self.k), moved(self.v)

    def first_lp_info(self):
        """(lp, top_vals, top_ids) numpy tuple or None: the shape
        ``Engine._store_logprobs`` consumes."""
        if self.first_lp is None:
            return None
        return (np.float32(self.first_lp),
                np.asarray(self.first_top_vals, np.float32),
                np.asarray(self.first_top_ids, np.int32))

    # -- wire format --------------------------------------------------------

    def to_bytes(self) -> bytes:
        arrays = [("k", self.k), ("v", self.v)]
        if self.kv_format == "int8":
            arrays += [("k_scale", self.k_scale), ("v_scale", self.v_scale)]
        # Key order is the reference's: the header bytes are part of the
        # wire contract.
        meta = {
            "request_id": self.request_id,
            "prompt_tokens": list(map(int, self.prompt_tokens)),
            "n": self.n,
            "adapter": self.adapter,
            "max_new_tokens": self.max_new_tokens,
            "sampling": self.sampling,
            "stop_token_ids": list(map(int, self.stop_token_ids)),
            "stop_sequences": [list(map(int, s))
                               for s in self.stop_sequences],
            "logprobs": self.logprobs,
            "first_token": self.first_token,
            "first_lp": self.first_lp,
            "first_top_vals": self.first_top_vals,
            "first_top_ids": self.first_top_ids,
            "t_submit": self.t_submit,
            "kv_format": self.kv_format,
            "kv_dtype": self.kv_dtype,
            "body": self.body,
            "trace_id": self.trace_id,
            "arrays": [
                {"name": name, "dtype": _dtype_name(a),
                 "shape": list(a.shape)}
                for name, a in arrays
            ],
        }
        head = json.dumps(meta).encode()
        out = [_MAGIC, struct.pack("<I", len(head)), head]
        out += [_le_bytes(a) for _, a in arrays]
        return b"".join(out)

    @classmethod
    def from_bytes(cls, data) -> "PrefillHandoff":
        """Parse a wire payload.  The arrays alias ``data`` when it is a
        writable buffer (a ``bytearray``); anything else is copied once."""
        if bytes(data[: len(_MAGIC)]) != _MAGIC:
            raise ValueError("not a PrefillHandoff payload (bad magic)")
        buf = data if isinstance(data, bytearray) else bytearray(data)
        off = len(_MAGIC)
        if off + 4 > len(buf):
            raise ValueError("truncated handoff payload")
        (head_len,) = struct.unpack_from("<I", buf, off)
        off += 4
        if off + head_len > len(buf):
            raise ValueError("truncated handoff payload")
        meta = json.loads(bytes(buf[off:off + head_len]).decode())
        off += head_len
        parsed: dict[str, torch.Tensor] = {}
        for spec in meta.pop("arrays"):
            dt = _torch_dtype(spec["dtype"])
            shape = [int(d) for d in spec["shape"]]
            if any(d < 0 for d in shape):
                # A negative dim makes nbytes negative: the truncation
                # check would pass and the cursor would move BACKWARDS,
                # aliasing array payloads.
                raise ValueError(f"negative dimension in handoff shape "
                                 f"{shape}")
            count = int(np.prod(shape, dtype=np.int64))
            nbytes = count * dt.itemsize
            if off + nbytes > len(buf):
                raise ValueError("truncated handoff payload")
            if count == 0:
                parsed[spec["name"]] = torch.empty(shape, dtype=dt)
            else:
                parsed[spec["name"]] = torch.frombuffer(
                    buf, dtype=dt, count=count, offset=off).reshape(shape)
            off += nbytes
        samp = meta.get("sampling") or {}
        if samp.get("logit_bias"):
            # JSON stringifies int keys; restore them.
            samp["logit_bias"] = {
                int(k): float(v) for k, v in samp["logit_bias"].items()}
        return cls(
            request_id=meta["request_id"],
            prompt_tokens=[int(t) for t in meta["prompt_tokens"]],
            n=int(meta["n"]),
            adapter=meta["adapter"],
            max_new_tokens=int(meta["max_new_tokens"]),
            sampling=samp,
            stop_token_ids=[int(t) for t in meta["stop_token_ids"]],
            stop_sequences=[[int(t) for t in s]
                            for s in meta.get("stop_sequences") or []],
            logprobs=meta["logprobs"],
            first_token=int(meta["first_token"]),
            first_lp=meta["first_lp"],
            first_top_vals=meta["first_top_vals"],
            first_top_ids=meta["first_top_ids"],
            t_submit=float(meta.get("t_submit") or 0.0),
            kv_format=meta["kv_format"],
            kv_dtype=meta["kv_dtype"],
            k=parsed["k"],
            v=parsed["v"],
            k_scale=parsed.get("k_scale"),
            v_scale=parsed.get("v_scale"),
            body=meta.get("body"),
            trace_id=meta.get("trace_id"),
        )


def export_handoff(request, k, v, n: int, first_token: int, lp_info=None,
                   quantize: str | None = None) -> PrefillHandoff:
    """Build a handoff from a prefill's outputs.

    ``k``/``v`` are the prefill's ``[L, 1, S_bucket, Kh, hd]`` tensors, on
    the card or the host; only the first ``n`` positions reach the host (on
    the card the copy waits for the prefill).  ``quantize="int8"`` halves
    the wire (per-(position, KV head) f32 scales, the engine's int8 KV
    math), quantizing before the copy.
    """
    if quantize not in (None, "int8"):
        raise ValueError(f"quantize={quantize!r}: only 'int8' (or None)")
    k_n = torch.as_tensor(k)[:, 0, :n]
    v_n = torch.as_tensor(v)[:, 0, :n]
    sp = request.sampling
    samp = {
        "temperature": sp.temperature,
        "top_k": sp.top_k,
        "top_p": sp.top_p,
        "seed": sp.seed,
        "presence_penalty": sp.presence_penalty,
        "frequency_penalty": sp.frequency_penalty,
        "logit_bias": ({str(t): float(b) for t, b in sp.logit_bias.items()}
                       if sp.logit_bias else None),
    }
    first_lp = first_top_vals = first_top_ids = None
    if lp_info is not None and request.logprobs is not None:
        lp, top_v, top_i = lp_info
        first_lp = float(np.asarray(lp))
        first_top_vals = np.asarray(top_v, np.float32).tolist()
        first_top_ids = np.asarray(top_i, np.int32).tolist()
    # One carry dict for both wire lanes: a new carried field reaches the
    # int8 AND the raw handoffs.
    carry = dict(
        request_id=request.request_id,
        prompt_tokens=list(request.prompt_tokens), n=n,
        adapter=request.adapter,
        max_new_tokens=request.max_new_tokens,
        sampling=samp, stop_token_ids=list(request.stop_token_ids),
        stop_sequences=[list(s) for s in request.stop_sequences],
        logprobs=request.logprobs, first_token=int(first_token),
        first_lp=first_lp, first_top_vals=first_top_vals,
        first_top_ids=first_top_ids, t_submit=request.t_submit,
        kv_dtype=_dtype_name(k_n),
    )
    if quantize == "int8":
        kq, ks = (t.cpu() for t in _kv_quantize(k_n))
        vq, vs = (t.cpu() for t in _kv_quantize(v_n))
        return PrefillHandoff(**carry, kv_format="int8",
                              k=kq, v=vq, k_scale=ks, v_scale=vs)
    return PrefillHandoff(**carry, kv_format="raw", k=k_n.cpu(),
                          v=v_n.cpu())


def make_request(handoff: PrefillHandoff):
    """Rebuild the engine ``Request`` a handoff describes (decode side)."""
    from llm_instance_gateway_tpu_torch.server.engine import (
        Request,
        SamplingParams,
    )

    s = handoff.sampling
    bias = s.get("logit_bias")
    if bias:
        # export_handoff stringifies keys for the JSON header; normalize
        # here so a handoff attached WITHOUT a wire round trip carries the
        # same int-keyed dict the engine validates.
        bias = {int(k): float(v) for k, v in bias.items()}
    return Request(
        prompt_tokens=list(handoff.prompt_tokens),
        max_new_tokens=handoff.max_new_tokens,
        sampling=SamplingParams(
            temperature=float(s.get("temperature", 0.0)),
            top_k=int(s.get("top_k", 0)),
            top_p=float(s.get("top_p", 1.0)),
            seed=s.get("seed"),
            presence_penalty=float(s.get("presence_penalty", 0.0)),
            frequency_penalty=float(s.get("frequency_penalty", 0.0)),
            logit_bias=bias,
        ),
        adapter=handoff.adapter,
        stop_token_ids=tuple(handoff.stop_token_ids),
        stop_sequences=tuple(tuple(s) for s in handoff.stop_sequences),
        request_id=handoff.request_id,
        logprobs=handoff.logprobs,
    )
