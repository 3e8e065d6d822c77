"""Model-server HTTP API on the standard library's ``ThreadingHTTPServer``
(port of ``server/api_http.py``; aiohttp is not installed where the port
runs on the card).

- ``POST /v1/completions``          OpenAI completions (prompt string or
                                    token ids), JSON or SSE ``stream: true``;
                                    ``max_tokens``, ``temperature``,
                                    ``top_k``, ``top_p``, ``seed``, ``stop``,
                                    ``logprobs``, ``n`` / ``best_of``,
                                    ``echo``, ``presence_penalty``,
                                    ``frequency_penalty``, ``logit_bias``
- ``POST /v1/chat/completions``     chat (the tokenizer's chat template,
                                    else the role-prefix transcript),
                                    ``logprobs`` / ``top_logprobs``, ``n``,
                                    SSE ``chat.completion.chunk``
- ``POST /v1/prefill``              disaggregation hop 1: prefill only; the
                                    answer is the serialized
                                    ``PrefillHandoff`` (octet-stream)
- ``POST /v1/attach``               hop 2: a handoff in, decode to the end;
                                    JSON or SSE, the completions or chat
                                    envelope the handoff's body asked for
- ``POST /v1/prefill/release``      ``{"request_id"}``: release abandoned
                                    hop-2 work
- ``GET  /v1/models``               base model + resident adapters
- ``POST /v1/load_lora_adapter``    ``{"lora_name", "lora_path"}`` (.npz
                                    or an Orbax directory; promotes a
                                    host-tier copy)
- ``POST /v1/unload_lora_adapter``  ``{"lora_name"}``
- ``POST /v1/demote_lora_adapter``  slot -> host RAM (409 while in use)
- ``POST /v1/prefetch_lora_adapter`` disk -> host RAM, no slot taken
- ``POST /v1/evict_lora_adapter``   host RAM -> disk
- ``GET  /metrics``                 the ``tpu:*`` exposition the gateway
                                    scrapes, ``tpu:events_total`` included
- ``GET  /debug/traces``            recent request traces (``?trace_id=``,
                                    ``?since=``, ``?limit=``)
- ``GET  /debug/events``            the flight recorder (``?since=``,
                                    ``?kind=``, ``?limit=``)
- ``GET  /debug/usage``             per-adapter capacity attribution and
                                    the residency tiers
- ``GET  /debug/profile``           the step profiler's attribution and
                                    dispatch records (404 when off)
- ``GET  /debug/kv``                the KV ledger's payload (paged pool; 404
                                    on lanes)
- ``GET  /health``                  200, or 503 while draining

Tracing: every inference request adopts the ``x-lig-trace-id`` header (or
mints one), records its engine spans (queue wait, prefill, decode, handoff
serialize / deserialize / attach) on ``time.time()`` stamps, echoes the
id on every answer (error bodies included) and returns its spans in
``x-lig-spans`` for the gateway to merge.

    python -m llm_instance_gateway_tpu_torch.server.api_http --model llama3-8b \\
        --max-seq-len 8192 --paged-kv-block 64 --prefix-cache --stream-lanes 2

A disaggregated pair is a ``--role prefill`` server and a ``--role decode``
server (paged pool, prefix cache) behind the gateway's two-hop relay; a
role is advisory, and every server keeps the whole API.

``--model`` takes every preset of the reference's server: Llama, Gemma,
Mixtral (MoE) and Qwen2.  ``--quantize int8`` serves int8 weights
(``ops/quant.py``; random ones are built int8 a layer at a time, so
Mixtral-8x7B's fit the card) and
``--kv-quantize int8`` an int8 KV cache, on lanes or on the paged pool.
``--speculative K --draft-model NAME`` decodes speculatively with a draft
of that preset (random weights from seed 1; quantized too under
``--quantize int8``); such a server refuses penalties and ``logit_bias``.

Trained weights: ``--checkpoint DIR`` (and ``--draft-checkpoint DIR`` for
the draft) reads an HF directory (``config.json`` plus safetensors, the
route that runs on the card) or the JAX package's Orbax checkpoint (needs
``tensorstore``), through ``models/convert.load_serving_checkpoint``; a
checkpoint's architecture replaces the preset's, and the server answers
to both names.  ``--tokenizer DIR`` serves a local HF tokenizer and its
chat template (needs ``transformers``).  Without ``--checkpoint`` the
weights are random (seed ``--seed``).

A non-streamed request whose client hangs up is cancelled: while it waits
on the engine, the handler's thread polls the connection, and a socket
that is readable with nothing to read (end of file) cancels every
candidate of the request (the reference's ``asyncio.CancelledError``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import queue as queue_mod
import select
import signal
import socket
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from llm_instance_gateway_tpu_torch import events as events_mod
from llm_instance_gateway_tpu_torch import faultinject, tracing
from llm_instance_gateway_tpu_torch.models import transformer
from llm_instance_gateway_tpu_torch.models.configs import CONFIGS
from llm_instance_gateway_tpu_torch.models.convert import load_serving_checkpoint
from llm_instance_gateway_tpu_torch.ops.quant import quantize_params
from llm_instance_gateway_tpu_torch.parallel.mesh import make_mesh, parse_axes
from llm_instance_gateway_tpu_torch.server import metrics as metrics_mod
from llm_instance_gateway_tpu_torch.server.engine import (
    Engine,
    EngineConfig,
    EngineDraining,
    MAX_LOGIT_BIAS,
    Request,
    SamplingParams,
)
from llm_instance_gateway_tpu_torch.server.kv_transfer import PrefillHandoff
from llm_instance_gateway_tpu_torch.server.lora_manager import (
    AdapterBusyError,
    AdapterError,
    LoRAManager,
)
from llm_instance_gateway_tpu_torch.server.tokenizer import load_tokenizer

logger = logging.getLogger(__name__)

MAX_N = 8          # n / best_of cap (each candidate takes engine capacity)
MAX_LOGPROBS = 5   # sampling.LOGPROB_TOPK, the OpenAI completions maximum
# OpenAI chat accepts top_logprobs up to 20; the engine records a top-5, so
# more is accepted, truncated, and the cap noted in the answer.
OPENAI_MAX_TOP_LOGPROBS = 20

_FFFD = "�"
# A partial UTF-8 character pending completion is at most 3 bytes, which
# decode to at most that many replacement chars; a longer trailing run is
# genuine model output.
_MAX_PARTIAL_FFFD = 3

# Inference routes: each adopts or mints a trace id (``/v1/attach`` takes
# it from the header or else from the handoff).
_TRACED = ("/v1/completions", "/v1/chat/completions", "/v1/prefill",
           "/v1/prefill/release")


class HTTPError(Exception):
    def __init__(self, status: int, message: str,
                 trace_id: str | None = None):
        super().__init__(message)
        self.status = status
        self.trace_id = trace_id


def _text_delta(delta: str, fin) -> dict:
    return {"index": 0, "text": delta, "finish_reason": fin}


def _chat_delta(delta: str, fin) -> dict:
    return {"index": 0, "delta": ({"content": delta} if delta else {}),
            "finish_reason": fin}


def _usage(prompt_tokens: int, completion_tokens: int) -> dict:
    return {"prompt_tokens": prompt_tokens,
            "completion_tokens": completion_tokens,
            "total_tokens": prompt_tokens + completion_tokens}


class ClientGone(Exception):
    """The client of a request hung up while it waited on the engine."""


class ModelServer:
    """Request handling, independent of the transport below."""

    def __init__(self, engine: Engine | None, tokenizer, model_name: str,
                 lora_manager: LoRAManager | None = None,
                 aliases: set[str] | None = None):
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name
        # Further names of the base model (the --model preset when a
        # checkpoint brought its own name), so clients keep working across
        # a checkpoint swap.
        self.aliases = {model_name} | (aliases or set())
        self.lora = lora_manager
        # Per-process span ring served by /debug/traces.
        self.tracer = tracing.Tracer()
        # Flight recorder: admission rejections here, drain and KV
        # releases / evictions from the engine through its sink.
        self.events = events_mod.EventJournal()
        if engine is not None:
            engine.event_sink = self.events.emit
        # The handler thread's client socket (``client_gone``).
        self.client = threading.local()

    def client_gone(self) -> bool:
        """Whether this thread's client has hung up: its socket is
        readable and a peek reads end of file (an HTTP/1.0 client sends
        nothing after its body).  False without a socket (in-process
        callers)."""
        sock = getattr(self.client, "sock", None)
        if sock is None:
            return False
        poller = select.poll()  # no fd ceiling, unlike select.select
        poller.register(sock, select.POLLIN)
        try:
            if not poller.poll(0):
                return False
            return sock.recv(1, socket.MSG_PEEK) == b""
        except OSError:  # reset by the peer
            return True

    # -- tracing -------------------------------------------------------------
    @staticmethod
    def _engine_spans(req: Request, decode_start: float | None = None,
                      with_decode: bool = True) -> list:
        """Span triples from a finished request's wall-clock stamps: queue
        wait (submit -> prefill start), prefill (-> first token), decode
        (first token -> done; ``decode_start`` overrides its start on the
        attach hop, where the first token predates this engine)."""
        spans = []
        if req.t_submit and req.t_prefill_start:
            spans.append(("engine.queue_wait", req.t_submit,
                          max(req.t_submit, req.t_prefill_start)))
        if req.t_prefill_start and req.t_first_token:
            spans.append(("engine.prefill", req.t_prefill_start,
                          max(req.t_prefill_start, req.t_first_token)))
        if with_decode:
            start = decode_start or req.t_first_token
            end = req.t_done or time.time()
            if start and end >= start:
                spans.append(("engine.decode", start, end))
        return spans

    def _record_spans(self, trace_id: str, spans, status: str = "ok") -> dict:
        """Record spans locally; returns the headers that echo the trace id
        and carry the spans back to the gateway."""
        for name, s, e in spans:
            self.tracer.record(trace_id, name, s, e)
        self.tracer.annotate(trace_id, model=self.model_name, status=status)
        headers = {tracing.TRACE_HEADER: trace_id}
        if spans and self.tracer.sampled(trace_id):
            headers[tracing.SPANS_HEADER] = tracing.wire_spans(spans)
        return headers

    def _reject(self, status: int, message: str, trace_id: str,
                reason: str) -> HTTPError:
        """A capacity or lifecycle refusal, journaled so the flight
        recorder correlates it with the gateway's pick by trace id (plain
        400s are request defects, not system events)."""
        self.events.emit(events_mod.ADMISSION_REJECT, trace_id or "",
                         status=status, reason=reason)
        return HTTPError(status, message)

    # -- helpers -------------------------------------------------------------
    def _resolve_model(self, requested) -> str | None:
        if requested in ("", None) or requested in self.aliases:
            return None
        if self.lora is not None and requested in self.lora.running_adapters():
            return requested
        raise HTTPError(404, f"model {requested!r} is not served by this replica")

    def _encode_prompt(self, body: dict) -> list[int]:
        prompt = body.get("prompt", "")
        if isinstance(prompt, list) and prompt and isinstance(prompt[0], int):
            return list(prompt)
        if isinstance(prompt, list):
            prompt = " ".join(str(p) for p in prompt)
        return self.tokenizer.encode(str(prompt))

    def _echo_text(self, body: dict, prompt_tokens: list[int]) -> str:
        """The client's own prompt string round-trips exactly; token-id
        prompts are decoded."""
        prompt = body.get("prompt", "")
        if isinstance(prompt, str):
            return prompt
        return self.tokenizer.decode(prompt_tokens)

    def _encode_stops(self, stops: list[str]) -> tuple[tuple[int, ...], ...]:
        """Tokenized stops for the engine's device automata — an early
        freeze only; the text-level scan stays authoritative."""
        out = []
        for s in stops:
            ids = self.tokenizer.encode(s, add_bos=False)
            if ids and self.tokenizer.decode(list(ids)) == s:
                out.append(tuple(int(t) for t in ids))
        return tuple(out)

    @staticmethod
    def _parse_choice_params(body: dict) -> tuple[int, int, int | None,
                                                   list[str]]:
        """(n, best_of, logprobs, stops) with OpenAI validation rules, and
        the penalties and ``logit_bias`` checked against their ranges."""
        n = int(body.get("n", 1))
        best_of = int(body.get("best_of", max(n, 1)))
        if not 1 <= n <= MAX_N:
            raise ValueError(f"n must be in [1, {MAX_N}]")
        if not n <= best_of <= MAX_N:
            raise ValueError(f"best_of must be in [n, {MAX_N}]")
        logprobs = body.get("logprobs")
        if logprobs is not None:
            logprobs = int(logprobs)
            if not 0 <= logprobs <= MAX_LOGPROBS:
                raise ValueError(f"logprobs must be in [0, {MAX_LOGPROBS}]")
        stop = body.get("stop")
        if stop is None:
            stops: list[str] = []
        elif isinstance(stop, str):
            stops = [stop]
        elif isinstance(stop, list) and all(isinstance(s, str) for s in stop):
            stops = list(stop)
        else:
            raise ValueError("stop must be a string or a list of strings")
        if len(stops) > 4:
            raise ValueError("at most 4 stop sequences are supported")
        for name in ("presence_penalty", "frequency_penalty"):
            val = float(body.get(name) or 0.0)  # null == unset
            if not -2.0 <= val <= 2.0:
                raise ValueError(f"{name} must be in [-2, 2]")
        bias = body.get("logit_bias")
        if bias is not None:
            if not isinstance(bias, dict):
                raise ValueError("logit_bias must be an object")
            if len(bias) > MAX_LOGIT_BIAS:
                raise ValueError("logit_bias supports at most "
                                 f"{MAX_LOGIT_BIAS} entries")
            for k, v in bias.items():
                if not -100.0 <= float(v) <= 100.0:
                    raise ValueError("logit_bias values must be in "
                                     "[-100, 100]")
                int(k)  # token ids must be integral (ValueError otherwise)
        return n, best_of, logprobs, [s for s in stops if s]

    def _choice_params(self, body: dict):
        try:
            return self._parse_choice_params(body)
        except (ValueError, TypeError) as e:
            raise HTTPError(400, str(e)) from e

    def _make_request(self, body: dict, prompt_tokens: list[int], adapter,
                      stops: list[str], logprobs: int | None = None,
                      candidate: int = 0) -> Request:
        """One engine request; candidate ``i`` of a fan-out draws with
        ``seed + i``, so the choices differ yet the answer reproduces."""
        try:
            seed = body.get("seed")
            raw_bias = body.get("logit_bias") or None
            return Request(
                prompt_tokens=prompt_tokens,
                max_new_tokens=int(body.get("max_tokens", 64)),
                sampling=SamplingParams(
                    temperature=float(body.get("temperature", 0.0)),
                    top_k=int(body.get("top_k", 0)),
                    top_p=float(body.get("top_p", 1.0)),
                    seed=None if seed is None else int(seed) + candidate,
                    presence_penalty=float(body.get("presence_penalty")
                                           or 0.0),
                    frequency_penalty=float(body.get("frequency_penalty")
                                            or 0.0),
                    logit_bias=({int(k): float(v) for k, v in raw_bias.items()}
                                if raw_bias else None)),
                adapter=adapter,
                stop_sequences=self._encode_stops(stops),
                logprobs=logprobs,
            )
        except (ValueError, TypeError) as e:
            raise HTTPError(400, str(e)) from e

    def _chat_prompt(self, messages) -> tuple[str, bool]:
        """Chat messages -> (prompt text, add_bos).  The tokenizer's own
        chat template wins (the format the model was trained on), encoded
        with add_bos=False: templates render the BOS themselves.  A template
        that fails on the messages raises ValueError (400: the request is
        valid OpenAI but not for this model's template).  A tokenizer
        without a template (the byte tokenizer) gets the role-prefix
        transcript."""
        if not isinstance(messages, list) or not all(
                isinstance(m, dict) for m in messages):
            raise ValueError("messages must be a list of objects")
        apply = getattr(self.tokenizer, "apply_chat_template", None)
        if apply is not None:
            try:
                templated = apply(messages)
            except Exception as e:  # jinja TemplateError, TypeError, ...
                raise ValueError(
                    f"messages are not renderable by this model's chat "
                    f"template: {e}") from e
            if templated is not None:
                return templated, False
        return "\n".join(
            f"{m.get('role', 'user')}: {m.get('content', '')}"
            for m in messages
        ) + "\nassistant:", True

    @staticmethod
    def _parse_chat_logprobs(body: dict) -> tuple[bool, int, int]:
        """(logprobs flag, effective top-N, requested top-N): OpenAI's
        range [0, 20] is accepted, the effective N capped at the engine's
        top-5 (the answer notes the cap when it bit)."""
        lp_flag = bool(body.get("logprobs"))
        top_n = body.get("top_logprobs")
        if top_n is None:
            return lp_flag, 0, 0
        if not lp_flag:
            raise ValueError("top_logprobs requires logprobs: true")
        top_n = int(top_n)
        if not 0 <= top_n <= OPENAI_MAX_TOP_LOGPROBS:
            raise ValueError(
                f"top_logprobs must be in [0, {OPENAI_MAX_TOP_LOGPROBS}]")
        return lp_flag, min(top_n, MAX_LOGPROBS), top_n

    def _wait_with_stops(self, req: Request, stops: list[str],
                         timeout_s: float = 600.0, submit: bool = True,
                         candidates: list[Request] | None = None) -> Request:
        """generate(), cancelling the moment a stop string appears in the
        decoded text (the exact cut happens in ``_truncate_at_stop``);
        ``submit=False`` waits on a request admitted already.  Every
        0.25 s it looks at the client: one that hung up cancels every
        candidate of its request (``candidates``, default ``[req]``) and
        raises ``ClientGone`` (``_hang_up``).  Without stops it wakes only
        for that look and at the end, not for every token."""
        if submit:
            self.engine.submit(req)
        deadline = time.monotonic() + timeout_s
        if not stops:
            while not req.done.wait(0.25):
                if self.client_gone():
                    self._hang_up(candidates or [req])
                if time.monotonic() > deadline:
                    req.error = "generation timed out"
                    req.cancelled.set()
                    return req
            return req
        max_stop = max(len(s) for s in stops)
        text, consumed = "", 0
        while True:
            req.stream_event.wait(0.25)
            req.stream_event.clear()
            # ``Engine._finish`` sets ``done`` before ``stream_event``: the
            # last wake-up reads it set.
            done = req.done.is_set()
            if not done and self.client_gone():
                self._hang_up(candidates or [req])
            n = len(req.output_tokens)
            if n > consumed:
                piece = self.tokenizer.decode(req.output_tokens[consumed:n])
                if not (piece.endswith(_FFFD) and not done):
                    window_start = max(0, len(text) - max_stop + 1)
                    text += piece
                    consumed = n
                    if any(s in text[window_start:] for s in stops):
                        req.cancelled.set()
                        req.done.wait(30)
                        return req
            if done:
                return req
            if time.monotonic() > deadline:
                req.error = "generation timed out"
                req.cancelled.set()
                return req

    @staticmethod
    def _hang_up(reqs: list[Request]) -> None:
        """Cancel ``reqs``, whose client hung up, wait for the engine to
        finish them (freeing their slots) and raise ``ClientGone``."""
        for r in reqs:
            r.cancelled.set()
        for r in reqs:
            r.done.wait(30)
        raise ClientGone()

    def _truncate_at_stop(self, req: Request,
                          stops: list[str]) -> tuple[str, bool]:
        """Cut text AND the per-token records (tokens, logprobs, top
        logprobs) at the earliest stop match; returns (text, hit)."""
        full = self.tokenizer.decode(req.output_tokens)
        hits = [(full.index(s), s) for s in stops if s in full]
        if not hits:
            return full, False
        idx, _ = min(hits)
        # Smallest token count whose decode contains a stop (monotone in
        # the prefix length): everything from there on is dropped.
        lo, hi = 1, len(req.output_tokens)
        while lo < hi:
            mid = (lo + hi) // 2
            if any(s in self.tokenizer.decode(req.output_tokens[:mid])
                   for s in stops):
                hi = mid
            else:
                lo = mid + 1
        del req.output_tokens[lo:]
        del req.output_logprobs[lo:]
        del req.output_top_logprobs[lo:]
        req.finish_reason = "stop"
        return full[:idx], True

    @staticmethod
    def _held_back(cur: str, full: str) -> int:
        """How many trailing replacement chars of ``cur`` (a prefix decode)
        are partial-multi-byte artifacts rather than genuine U+FFFD: hold
        back the smallest trailing-U+FFFD suffix whose removal makes
        ``cur`` agree with the full decode, at most one UTF-8 char's
        pending bytes."""
        run = len(cur) - len(cur.rstrip(_FFFD))
        cap = min(run, _MAX_PARTIAL_FFFD)
        for hold in range(cap + 1):
            keep = len(cur) - hold
            if full[:keep] == cur[:keep]:
                return hold
        return cap

    def _per_token_records(self, req: Request, k: int,
                           text_limit: int | None = None):
        """Per-generated-token ``(piece, logprob, deduped_tops)`` rows, the
        one walk both logprobs envelopes build from.  A UTF-8 character
        split across byte tokens is attributed whole to its completing
        token (predecessors emit ""); a token that genuinely decodes to
        U+FFFD keeps its char.  The pieces concatenate to the full decode;
        ``text_limit`` clips the walk to the returned text (a stop cut is
        character-granular).  ``deduped_tops`` keeps the most probable id
        per surface string."""
        rows = []
        committed = ""
        n = len(req.output_tokens)
        full = None  # the full decode, made on the first U+FFFD tail
        for i in range(n):
            if text_limit is not None and len(committed) >= text_limit:
                break
            cur = self.tokenizer.decode(req.output_tokens[: i + 1])
            if i + 1 < n and cur.endswith(_FFFD):
                if full is None:
                    full = self.tokenizer.decode(req.output_tokens)
                hold = self._held_back(cur, full)
                if hold:
                    cur = cur[:-hold]
            piece = cur[len(committed):]
            if text_limit is not None:
                piece = piece[: max(0, text_limit - len(committed))]
            committed += piece
            lp = (req.output_logprobs[i]
                  if i < len(req.output_logprobs) else None)
            tops: dict[str, float] = {}
            if k > 0 and i < len(req.output_top_logprobs):
                for tok, v in req.output_top_logprobs[i].items():
                    key = self.tokenizer.decode([tok])
                    v = max(v, -1e9)
                    if key not in tops or v > tops[key]:
                        tops[key] = v
            rows.append((piece, None if lp is None else max(lp, -1e9), tops))
        return rows

    def _logprobs_json(self, req: Request, k: int,
                       text_limit: int | None = None) -> dict:
        """The completions ``logprobs`` object (tokens / token_logprobs /
        top_logprobs / text_offset)."""
        tokens, token_lps, tops, offsets = [], [], [], []
        offset = 0
        for piece, lp, top in self._per_token_records(req, k, text_limit):
            offsets.append(offset)
            offset += len(piece)
            tokens.append(piece)
            token_lps.append(lp)
            if k > 0:
                tops.append(top)
        return {"tokens": tokens, "token_logprobs": token_lps,
                "top_logprobs": tops if k > 0 else None,
                "text_offset": offsets}

    def _chat_logprobs_json(self, req: Request, top_n: int,
                            text_limit: int | None = None) -> dict:
        """The chat ``logprobs`` object: ``content[]`` entries with token /
        logprob / bytes (the piece's UTF-8) / top_logprobs."""
        content = []
        for piece, lp, top in self._per_token_records(req, top_n, text_limit):
            content.append({
                "token": piece,
                "logprob": lp,
                "bytes": list(piece.encode("utf-8", "surrogatepass")),
                "top_logprobs": [
                    {"token": k, "logprob": v,
                     "bytes": list(k.encode("utf-8", "surrogatepass"))}
                    for k, v in sorted(top.items(), key=lambda kv: -kv[1])
                ][:top_n],
            })
        return {"content": content}

    # -- submission ----------------------------------------------------------
    def _submit_error(self, e: Exception, trace_id: str,
                      full_message: str = "prefill queue is full") -> HTTPError:
        if isinstance(e, EngineDraining):
            return self._reject(503, str(e), trace_id, "draining")
        if isinstance(e, queue_mod.Full):
            return self._reject(429, full_message, trace_id, "queue_full")
        if isinstance(e, AdapterError):
            return HTTPError(404, str(e))
        return HTTPError(400, str(e))

    def _submit_all(self, reqs: list[Request], trace_id: str) -> None:
        """Submit every candidate before waiting on any, so the engine
        batches them (one grouped prefill under ``--prefill-batch``); if
        one submit fails, the ones already in are cancelled — decoding for
        nobody would amplify load just when capacity is short.  The
        engine loop waits on its ``_work`` condition while idle; holding
        that lock keeps it asleep until the last candidate is queued."""
        with self.engine._work:
            for r in reqs:
                try:
                    self.engine.submit(r)
                except (EngineDraining, ValueError, queue_mod.Full,
                        AdapterError) as e:
                    for other in reqs:
                        other.cancelled.set()
                    raise self._submit_error(e, trace_id) from e

    def _run_many(self, reqs: list[Request], stops: list[str],
                  trace_id: str, timeout_s: float = 600.0) -> None:
        self._submit_all(reqs, trace_id)
        for r in reqs:
            self._wait_with_stops(r, stops, timeout_s, submit=False,
                                  candidates=reqs)
        for r in reqs:
            if r.error:
                raise HTTPError(500, r.error)

    # -- endpoints -----------------------------------------------------------
    def completions(self, body: dict, trace_id: str):
        """(status, payload, headers) for JSON, or (200, SSE generator,
        headers) for ``stream: true``."""
        adapter = self._resolve_model(body.get("model", self.model_name))
        n, best_of, logprobs, stops = self._choice_params(body)
        prompt_tokens = self._encode_prompt(body)
        echo = bool(body.get("echo"))
        if echo and logprobs is not None:
            # OpenAI echo + logprobs returns prompt logprobs, which the
            # engine does not record.
            raise HTTPError(400, "echo is not supported together with "
                                 "logprobs")
        model = body.get("model", self.model_name)
        if body.get("stream"):
            if n > 1 or best_of > 1:
                raise HTTPError(400, "streaming supports n=1 / best_of=1")
            if logprobs is not None:
                raise HTTPError(400, "logprobs is not supported with "
                                     "streaming")
            req = self._make_request(body, prompt_tokens, adapter, stops)
            return self._stream(
                req, model, "text_completion", _text_delta, stops, trace_id,
                echo_prefix=self._echo_text(body, prompt_tokens)
                if echo else None)
        # Ranking best_of candidates needs their logprobs: record at least
        # the sampled tokens' when the client asked for none.
        record = logprobs if logprobs is not None else (
            0 if best_of > n else None)
        reqs = [self._make_request(body, list(prompt_tokens), adapter, stops,
                                   logprobs=record, candidate=i)
                for i in range(best_of)]
        self._run_many(reqs, stops, trace_id)
        texts = {id(r): self._truncate_at_stop(r, stops)[0] for r in reqs}
        # OpenAI usage: completion_tokens counts every candidate.
        completion_tokens = sum(len(r.output_tokens) for r in reqs)
        if best_of > n:
            # Keep the n candidates with the highest mean token logprob.
            def mean_lp(r: Request) -> float:
                return (sum(r.output_logprobs) / len(r.output_logprobs)
                        if r.output_logprobs else float("-inf"))

            reqs = sorted(reqs, key=mean_lp, reverse=True)[:n]
        prefix = self._echo_text(body, prompt_tokens) if echo else ""
        choices = []
        for i, r in enumerate(reqs):
            choice = {"index": i, "text": prefix + texts[id(r)],
                      "finish_reason": r.finish_reason}
            if logprobs is not None:
                choice["logprobs"] = self._logprobs_json(
                    r, logprobs, text_limit=len(texts[id(r)]))
            choices.append(choice)
        headers = self._record_spans(trace_id, self._engine_spans(reqs[0]),
                                     status=reqs[0].finish_reason or "ok")
        return 200, {
            "id": f"cmpl-{reqs[0].request_id}",
            "object": "text_completion",
            "created": int(time.time()),
            "model": model,
            "choices": choices,
            "usage": _usage(len(prompt_tokens), completion_tokens),
            "ttft_ms": round(reqs[0].ttft_s * 1000, 2),
        }, headers

    def chat(self, body: dict, trace_id: str):
        """``/v1/chat/completions``: as ``completions``, in the chat
        envelope."""
        adapter = self._resolve_model(body.get("model", self.model_name))
        try:
            prompt, add_bos = self._chat_prompt(body.get("messages", []))
            n, best_of, _, stops = self._parse_choice_params(body)
            lp_flag, top_n, top_req = self._parse_chat_logprobs(body)
        except (ValueError, TypeError) as e:
            raise HTTPError(400, str(e)) from e
        prompt_tokens = self.tokenizer.encode(prompt, add_bos=add_bos)
        record = top_n if lp_flag else None
        model = body.get("model", self.model_name)
        if body.get("stream"):
            if n > 1 or best_of > 1:
                raise HTTPError(400, "streaming supports n=1 / best_of=1")
            if record is not None:
                raise HTTPError(400, "logprobs are not supported with "
                                     "streaming chat completions")
            req = self._make_request(body, prompt_tokens, adapter, stops)
            return self._stream(req, model, "chat.completion.chunk",
                                _chat_delta, stops, trace_id)
        reqs = [self._make_request(body, list(prompt_tokens), adapter, stops,
                                   logprobs=record, candidate=i)
                for i in range(n)]
        self._run_many(reqs, stops, trace_id)
        choices = [self._chat_choice(i, r, stops, record, top_req)
                   for i, r in enumerate(reqs)]
        headers = self._record_spans(trace_id, self._engine_spans(reqs[0]),
                                     status=reqs[0].finish_reason or "ok")
        return 200, {
            "id": f"chatcmpl-{reqs[0].request_id}",
            "object": "chat.completion",
            "created": int(time.time()),
            "model": model,
            "choices": choices,
            "usage": _usage(len(prompt_tokens),
                            sum(len(r.output_tokens) for r in reqs)),
        }, headers

    def _chat_choice(self, index: int, req: Request, stops: list[str],
                     top_n: int | None, top_req: int) -> dict:
        text, _ = self._truncate_at_stop(req, stops)
        choice = {"index": index,
                  "message": {"role": "assistant", "content": text},
                  "finish_reason": req.finish_reason}
        if top_n is not None:
            choice["logprobs"] = self._chat_logprobs_json(
                req, top_n, text_limit=len(text))
            if top_req > top_n:
                # The client asked for more than the engine's top-5.
                choice["logprobs"]["top_logprobs_truncated_to"] = top_n
        return choice

    # -- disaggregation hops (server/kv_transfer.py) -------------------------
    def prefill(self, body: dict, trace_id: str):
        """Hop 1: prefill only; answers the serialized ``PrefillHandoff``.
        Takes a completions or a chat body.  Shapes a handoff cannot carry
        (candidate fan-out, echo) and prompts beyond the largest bucket
        answer 422: the gateway serves any non-200 single-hop."""
        adapter = self._resolve_model(body.get("model", self.model_name))
        try:
            n, best_of, logprobs, stops = self._parse_choice_params(body)
            if isinstance(body.get("messages"), list):
                prompt, add_bos = self._chat_prompt(body["messages"])
                prompt_tokens = self.tokenizer.encode(prompt, add_bos=add_bos)
                lp_flag, top_n, _ = self._parse_chat_logprobs(body)
                logprobs = top_n if lp_flag else None
            else:
                prompt_tokens = self._encode_prompt(body)
        except (ValueError, TypeError) as e:
            raise HTTPError(400, str(e)) from e
        if n > 1 or best_of > 1 or body.get("echo"):
            raise self._reject(422, "prefill hop supports single-candidate, "
                                    "non-echo requests", trace_id,
                               "prefill_unsupported")
        req = self._make_request(body, prompt_tokens, adapter, stops,
                                 logprobs=logprobs)
        try:
            handoff = self.engine.prefill_only(req)
        except (EngineDraining, queue_mod.Full, AdapterError) as e:
            raise self._submit_error(e, trace_id) from e
        except ValueError as e:  # e.g. beyond the largest bucket
            raise self._reject(422, str(e), trace_id,
                               "prefill_refused") from e
        except RuntimeError as e:
            raise HTTPError(500, str(e)) from e
        handoff.body = body  # envelope parameters ride to the decode hop
        handoff.trace_id = trace_id  # one id across both hops
        t_ser0, p0 = time.time(), time.perf_counter()
        wire = handoff.to_bytes()
        t_ser1, ser_s = time.time(), time.perf_counter() - p0
        self.engine.observe_handoff(ser_s)
        headers = self._record_spans(
            trace_id, self._engine_spans(req, with_decode=False)
            + [("handoff.serialize", t_ser0, t_ser1)], status="handoff")
        headers.update({"x-request-id": req.request_id,
                        "x-prefill-ttft-ms": f"{req.ttft_s * 1000:.2f}",
                        "x-handoff-serialize-ms": f"{ser_s * 1e3:.3f}"})
        return 200, wire, headers

    def attach(self, raw: bytearray, header_trace_id: str | None):
        """Hop 2: admit a handoff into decode and answer in the envelope
        its body asked for (completions or chat, SSE included), as
        collocated serving would.  The trace id comes from the header, or
        else from the handoff."""
        t_des0, p0 = time.time(), time.perf_counter()
        try:
            handoff = PrefillHandoff.from_bytes(raw)
        except Exception as e:
            raise HTTPError(400, f"malformed handoff: {e}",
                            header_trace_id or tracing.new_trace_id()) from e
        t_des1, p1 = time.time(), time.perf_counter()
        trace_id = (header_trace_id or handoff.trace_id
                    or tracing.new_trace_id())
        try:
            return self._attach(handoff, trace_id, (t_des0, t_des1, p0, p1))
        except HTTPError as e:
            e.trace_id = e.trace_id or trace_id
            raise

    def _attach(self, handoff: PrefillHandoff, trace_id: str, stamps):
        t_des0, t_des1, p0, p1 = stamps
        body = handoff.body or {}
        chat = isinstance(body.get("messages"), list)
        _, _, _, stops = self._choice_params(body)
        try:
            req = self.engine.attach_prefilled(handoff)
        except (EngineDraining, queue_mod.Full, AdapterError) as e:
            raise self._submit_error(
                e, trace_id, "attach admission queue is full") from e
        except ValueError as e:
            raise self._reject(422, str(e), trace_id, "attach_refused") from e
        t_att, p2 = time.time(), time.perf_counter()
        self.engine.observe_handoff(p2 - p0)
        headers = {tracing.TRACE_HEADER: trace_id,
                   "x-request-id": req.request_id,
                   "x-handoff-deserialize-ms": f"{(p1 - p0) * 1e3:.3f}",
                   "x-handoff-attach-ms": f"{(p2 - p1) * 1e3:.3f}"}
        attach_spans = [("handoff.deserialize", t_des0, t_des1),
                        ("handoff.attach", t_des1, t_att)]
        model = body.get("model", self.model_name)
        if body.get("stream"):
            for name, s, e in attach_spans:
                self.tracer.record(trace_id, name, s, e)
            status, stream, _ = self._stream(
                req, model, "chat.completion.chunk" if chat
                else "text_completion", _chat_delta if chat else _text_delta,
                stops, trace_id, decode_start=t_att, submitted=True)
            return status, stream, headers
        self._wait_with_stops(req, stops, submit=False)
        if req.error:
            raise HTTPError(500, req.error)
        headers.update(self._record_spans(
            trace_id, attach_spans + [("engine.decode", t_att,
                                       req.t_done or time.time())],
            status=req.finish_reason or "ok"))
        if chat:
            try:
                top_req = int(body.get("top_logprobs") or 0)
            except (TypeError, ValueError):
                top_req = 0
            # The prefill hop already capped the recorded top-k.
            return 200, {
                "id": f"chatcmpl-{req.request_id}",
                "object": "chat.completion",
                "created": int(time.time()),
                "model": model,
                "choices": [self._chat_choice(0, req, stops, req.logprobs,
                                              top_req)],
                "usage": _usage(len(req.prompt_tokens),
                                len(req.output_tokens)),
            }, headers
        text, _ = self._truncate_at_stop(req, stops)
        choice = {"index": 0, "text": text,
                  "finish_reason": req.finish_reason}
        if req.logprobs is not None:
            choice["logprobs"] = self._logprobs_json(
                req, req.logprobs, text_limit=len(text))
        return 200, {
            "id": f"cmpl-{req.request_id}",
            "object": "text_completion",
            "created": int(time.time()),
            "model": model,
            "choices": [choice],
            "usage": _usage(len(req.prompt_tokens), len(req.output_tokens)),
            "ttft_ms": round(req.ttft_s * 1000, 2),
        }, headers

    def release(self, body: dict, trace_id: str):
        """Best-effort release of abandoned hop-2 work: the gateway posts
        ``{"request_id"}`` when a decode hop failed after the handoff was
        delivered.  Unknown or finished ids answer ``released: false``
        (never admitted, done, or swept by ``--handoff-ttl-s``)."""
        if "request_id" not in body:
            raise HTTPError(400, "body must be JSON with request_id")
        request_id = body["request_id"]
        released = bool(self.engine.release_request(str(request_id)))
        if released:
            logger.info("released abandoned request %s", request_id)
        return 200, {"request_id": request_id, "released": released}, {
            tracing.TRACE_HEADER: trace_id}

    # -- streaming -----------------------------------------------------------
    def _stream(self, req: Request, model: str, object_name: str, make_delta,
                stops: list[str], trace_id: str, echo_prefix: str | None = None,
                decode_start: float | None = None, submitted: bool = False):
        """Submit (so saturation answers a real 429 before any header),
        then (200, the SSE generator, the trace header)."""
        req.streaming = True
        if not submitted:
            try:
                self.engine.submit(req)
            except (EngineDraining, ValueError, queue_mod.Full,
                    AdapterError) as e:
                raise self._submit_error(e, trace_id) from e
        return 200, self._sse(req, model, object_name, make_delta, stops,
                              trace_id, echo_prefix, decode_start), {
            tracing.TRACE_HEADER: trace_id}

    def _sse(self, req: Request, model: str, object_name: str, make_delta,
             stops: list[str], trace_id: str, echo_prefix: str | None,
             decode_start: float | None, timeout_s: float = 600.0):
        """Per-token SSE chunks (text deltas from prefix-diffed decodes; a
        trailing U+FFFD is held back).  With stops, emitted text lags by the
        longest stop minus one so no stop prefix leaks before the match.
        ``echo_prefix`` leads the stream as its own chunk.  A finished
        stream records its spans here (a stream cannot carry
        ``x-lig-spans``): they live on this server's /debug/traces."""
        def chunk(delta, fin, usage=False):
            payload = {"id": f"cmpl-{req.request_id}",
                       "object": object_name, "model": model,
                       "choices": [make_delta(delta, fin)]}
            if usage:
                payload["usage"] = _usage(len(req.prompt_tokens),
                                          len(req.output_tokens))
            return payload

        deadline = time.monotonic() + timeout_s
        holdback = max((len(s) for s in stops), default=1) - 1
        text, emitted, consumed = "", 0, 0
        try:
            if echo_prefix:
                yield chunk(echo_prefix, None)
            while True:
                req.stream_event.wait(0.25)
                req.stream_event.clear()
                done = req.done.is_set()  # read BEFORE the token count
                n = len(req.output_tokens)
                while consumed < n:
                    # Per-token growth of the decoded text.
                    cur = self.tokenizer.decode(req.output_tokens[:consumed + 1])
                    if cur.endswith(_FFFD) and consumed + 1 == n and not done:
                        break
                    consumed += 1
                    text = cur
                    if stops:
                        hit = [text.index(s) for s in stops if s in text]
                        if hit:
                            req.cancelled.set()
                            req.done.wait(30)
                            self._truncate_at_stop(req, stops)
                            cut = min(hit)
                            if cut > emitted:
                                yield chunk(text[emitted:cut], None)
                            yield chunk("", "stop", usage=True)
                            yield None
                            return
                    limit = len(text) - (0 if done and consumed == n
                                         else holdback)
                    if limit > emitted:
                        yield chunk(text[emitted:limit], None)
                        emitted = limit
                if done and consumed >= len(req.output_tokens):
                    if req.error:
                        yield {"error": {"message": req.error}}
                    else:
                        text = self.tokenizer.decode(req.output_tokens)
                        yield chunk(text[emitted:], req.finish_reason or "stop",
                                    usage=True)
                    yield None
                    return
                if time.monotonic() > deadline:
                    req.cancelled.set()
                    yield {"error": {"message": "generation timed out"}}
                    yield None
                    return
        finally:
            if not req.done.is_set():
                req.cancelled.set()  # client gone: free the slot
            else:
                self._record_spans(
                    trace_id, self._engine_spans(req,
                                                 decode_start=decode_start),
                    status=req.finish_reason or "ok")

    # -- admin ---------------------------------------------------------------
    def models(self):
        data = [{"id": self.model_name, "object": "model",
                 "root": self.model_name}]
        if self.lora is not None:
            data += [{"id": name, "object": "model", "root": self.model_name,
                      "parent": self.model_name}
                     for name in self.lora.running_adapters()]
        return 200, {"object": "list", "data": data}

    def _lora_name(self, body: dict, with_path: bool = False):
        if self.lora is None:
            raise HTTPError(400, "LoRA serving is not enabled")
        name, path = body.get("lora_name"), body.get("lora_path")
        if with_path:
            if not name or not path:
                raise HTTPError(400, "lora_name and lora_path are required")
            if name in self.aliases:
                # An alias would shadow the adapter in _resolve_model.
                raise HTTPError(409, f"adapter name {name!r} collides with "
                                     "the base model's served names")
        elif not name:
            raise HTTPError(400, "lora_name is required")
        return name, path

    def load_adapter(self, body: dict):
        name, path = self._lora_name(body, with_path=True)
        try:
            self.lora.load(name, checkpoint_path=path)
        except AdapterError as e:
            raise HTTPError(409, str(e)) from e
        except Exception as e:
            logger.exception("adapter load failed")
            raise HTTPError(500, f"failed to load adapter: {e}") from e
        return 200, {"status": "ok", "loaded": name}

    def unload_adapter(self, body: dict):
        name, _ = self._lora_name(body)
        try:
            removed = self.lora.unload(name)
        except AdapterBusyError as e:
            raise HTTPError(409, str(e)) from e
        if not removed:
            raise HTTPError(404, f"adapter {name!r} not loaded")
        return 200, {"status": "ok", "unloaded": name}

    def demote_adapter(self, body: dict):
        """Slot -> host RAM (409 while requests pin the slot: the planner
        retries on its next pass)."""
        name, _ = self._lora_name(body)
        try:
            demoted = self.lora.demote(name)
        except AdapterError as e:  # AdapterBusyError included
            raise HTTPError(409, str(e)) from e
        if not demoted:
            raise HTTPError(404, f"adapter {name!r} not slot-resident")
        return 200, {"status": "ok", "demoted": name, "tier": "host"}

    def prefetch_adapter(self, body: dict):
        """Disk -> host RAM without taking a slot; idempotent for names
        already in RAM."""
        name, path = self._lora_name(body, with_path=True)
        try:
            fetched = self.lora.prefetch(name, path)
        except AdapterError as e:
            raise HTTPError(409, str(e)) from e
        except Exception as e:
            logger.exception("adapter prefetch failed")
            raise HTTPError(500, f"failed to prefetch adapter: {e}") from e
        return 200, {"status": "ok", "prefetched": name,
                     "already_resident": not fetched}

    def evict_adapter(self, body: dict):
        """Host RAM -> disk (a slot-resident adapter is untouched: demote
        it first)."""
        name, _ = self._lora_name(body)
        if not self.lora.evict_host(name):
            raise HTTPError(404, f"adapter {name!r} not host-resident")
        return 200, {"status": "ok", "evicted": name}

    def metrics_text(self) -> str:
        snap = self.engine.metrics_snapshot()
        snap.setdefault("model_name", self.model_name)
        return (metrics_mod.render(snap)
                + "\n".join(self.events.render_prom("tpu:events_total"))
                + "\n")

    def debug_traces(self, query: dict | None = None):
        """This replica's recent traces (streams' decode spans live only
        here; the gateway's /debug/traces shows the merged view)."""
        return 200, tracing.debug_traces_payload(self.tracer, query or {})

    def debug_events(self, query: dict | None = None):
        return 200, events_mod.debug_events_payload(self.events, query or {})

    def debug_usage(self, query: dict | None = None):
        """Per-{adapter, phase} attribution (tuple keys flattened to
        ``"adapter|phase"``) beside the residency tiers."""
        snap = self.engine.metrics_snapshot()
        usage = snap.get("usage") or {}
        flat = dict(usage)
        for key in ("step_seconds", "tokens"):
            flat[key] = {f"{a}|{p}": v
                         for (a, p), v in (usage.get(key) or {}).items()}
        return 200, {
            "model": self.model_name,
            "role": snap.get("pool_role", "collocated"),
            "running_lora_adapters": snap.get("running_lora_adapters", []),
            "waiting_lora_adapters": snap.get("waiting_lora_adapters", []),
            "residency": snap.get("residency", {}),
            "usage": flat,
        }

    def debug_profile(self, query: dict | None = None):
        profiler = self.engine.profiler
        if profiler is None:
            raise HTTPError(404, "step profiler is disabled "
                                 "(EngineConfig.step_profile=False)")
        return 200, {"model": self.model_name, "role": self.engine.cfg.role,
                     **profiler.snapshot()}

    def debug_kv(self, query: dict | None = None):
        ledger = self.engine.kv_ledger
        if ledger is None:
            raise HTTPError(404, "kv ledger is disabled (EngineConfig."
                                 "kv_ledger=False or non-paged cache)")
        self.engine._kv_ledger_sync()
        return 200, {"model": self.model_name, "role": self.engine.cfg.role,
                     **ledger.snapshot()}


def make_handler(server: ModelServer):
    """The ``BaseHTTPRequestHandler`` class bound to ``server``.

    Deterministic fault injection (``faultinject.py``): when the
    ``LIG_FAULTS`` env var names a JSON schedule, it is read and armed
    here, once, and every request consults it before routing, so the
    fleet's chaos stack exercises the real server binary."""
    faults = None
    faults_path = os.environ.get("LIG_FAULTS")
    if faults_path:
        faults = faultinject.FaultSchedule.from_file(faults_path)
        faults.arm()
        logger.warning("fault injection armed from %s: %s", faults_path,
                       faults.describe())
    get_routes = {"/v1/models": lambda _q: server.models(),
                  "/debug/traces": server.debug_traces,
                  "/debug/events": server.debug_events,
                  "/debug/usage": server.debug_usage,
                  "/debug/profile": server.debug_profile,
                  "/debug/kv": server.debug_kv}
    post_routes = {"/v1/completions": server.completions,
                   "/v1/chat/completions": server.chat,
                   "/v1/prefill": server.prefill,
                   "/v1/prefill/release": server.release,
                   "/v1/load_lora_adapter": server.load_adapter,
                   "/v1/unload_lora_adapter": server.unload_adapter,
                   "/v1/demote_lora_adapter": server.demote_adapter,
                   "/v1/prefetch_lora_adapter": server.prefetch_adapter,
                   "/v1/evict_lora_adapter": server.evict_adapter}

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.0"  # SSE streams end when the socket closes

        def log_message(self, fmt, *args):  # route through logging
            logger.debug("%s " + fmt, self.address_string(), *args)

        def _send(self, status: int, body: bytes, ctype: str,
                  headers: dict | None = None) -> None:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for name, value in (headers or {}).items():
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(body)

        def _json(self, status: int, payload, headers=None) -> None:
            self._send(status, json.dumps(payload).encode(),
                       "application/json", headers)

        def _error(self, status: int, message: str,
                   trace_id: str | None = None) -> None:
            """The error envelope; a known trace id rides the body and the
            header, so failed requests stay correlatable."""
            error = {"message": message, "type": "invalid_request_error"}
            if trace_id:
                error["trace_id"] = trace_id
            self._json(status, {"error": error},
                       {tracing.TRACE_HEADER: trace_id} if trace_id else None)

        def _raw(self) -> bytearray:
            """The request body as a writable buffer (a handoff's arrays
            alias it instead of being copied)."""
            buf = bytearray(int(self.headers.get("Content-Length") or 0))
            view, got = memoryview(buf), 0
            while got < len(buf):
                n = self.rfile.readinto(view[got:])
                if not n:
                    break
                got += n
            return buf if got == len(buf) else buf[:got]

        def _body(self) -> dict:
            n = int(self.headers.get("Content-Length") or 0)
            try:
                body = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError as e:
                raise HTTPError(400, "invalid JSON body") from e
            if not isinstance(body, dict):
                raise HTTPError(400, "JSON body must be an object")
            return body

        def _faulted(self, path: str, has_body: bool) -> bool:
            """Apply the armed schedule's fault to this request: True when
            the fault answered it (or cut it) and the route must not run."""
            if faults is None:
                return False
            try:
                faultinject.apply(faults, path, self.connection,
                                  server.events)
            except faultinject.Injected as e:
                if has_body:  # unread bytes would reset the connection
                    self._raw()
                if e.status is None:
                    self.close_connection = True
                    faultinject.cut(self.connection)
                else:
                    self._send(e.status, e.text.encode(),
                               "text/plain; charset=utf-8")
                return True
            return False

        def do_GET(self):  # noqa: N802 - http.server's naming
            path, _, query = self.path.partition("?")
            if self._faulted(path, has_body=False):
                return
            if path == "/health":
                if server.engine.draining:
                    self._send(503, b"draining", "text/plain")
                else:
                    self._send(200, b"ok", "text/plain")
                return
            if path == "/metrics":
                self._send(200, server.metrics_text().encode(),
                           "text/plain; version=0.0.4")
                return
            fn = get_routes.get(path)
            if fn is None:
                self._error(404, f"no route {path}")
                return
            params = {k: v[0] for k, v in urllib.parse.parse_qs(
                query, keep_blank_values=True).items()}
            try:
                self._json(*fn(params))
            except HTTPError as e:
                self._error(e.status, str(e))

        def do_POST(self):  # noqa: N802 - http.server's naming
            path = self.path.split("?", 1)[0]
            if self._faulted(path, has_body=True):
                return
            trace_id = None
            if path in _TRACED:
                trace_id = (tracing.header_trace_id(self.headers)
                            or tracing.new_trace_id())
            server.client.sock = self.connection
            try:
                if path == "/v1/attach":  # a handoff is binary
                    result = server.attach(
                        self._raw(), tracing.header_trace_id(self.headers))
                elif path in post_routes:
                    body = self._body()
                    fn = post_routes[path]
                    result = fn(body, trace_id) if trace_id else fn(body)
                else:
                    self._error(404, f"no route {path}")
                    return
            except HTTPError as e:
                self._error(e.status, str(e), e.trace_id or trace_id)
                return
            except ClientGone:
                logger.info("%s: client hung up; request cancelled", path)
                return
            finally:
                server.client.sock = None
            # (status, payload[, headers]); the payload is JSON (dict), a
            # handoff (bytes) or an SSE generator.
            status, payload, *rest = result
            headers = rest[0] if rest else None
            if isinstance(payload, dict):
                self._json(status, payload, headers)
            elif isinstance(payload, bytes):
                self._send(status, payload, "application/octet-stream",
                           headers)
            else:
                self._stream(payload, headers)

        def _stream(self, chunks, headers=None) -> None:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            for name, value in (headers or {}).items():
                self.send_header(name, value)
            self.end_headers()
            try:
                for payload in chunks:
                    data = ("[DONE]" if payload is None
                            else json.dumps(payload))
                    self.wfile.write(f"data: {data}\n\n".encode())
                    self.wfile.flush()
            except OSError:
                chunks.close()  # client went away: the generator cancels

    return Handler


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="PyTorch/CUDA model server")
    p.add_argument("--model", default="llama3-tiny", choices=sorted(CONFIGS))
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights served without "
                        "--checkpoint")
    p.add_argument("--checkpoint", default=None, metavar="DIR",
                   help="serving checkpoint: an HF directory (config.json "
                        "plus model.safetensors, or shards with "
                        "model.safetensors.index.json) or the JAX "
                        "package's Orbax params dir (params/ plus "
                        "model_config.json, or a bare tree; needs "
                        "tensorstore); its architecture replaces --model's")
    p.add_argument("--tokenizer", default=None, metavar="DIR",
                   help="local HF tokenizer dir, chat template included "
                        "(needs transformers); the byte tokenizer otherwise")
    p.add_argument("--decode-slots", type=int, default=8)
    p.add_argument("--max-seq-len", type=int, default=1024)
    p.add_argument("--max-loras", type=int, default=4)
    p.add_argument("--host-cache-slots", type=int, default=8,
                   help="host-RAM adapter cache size (the middle tier of the "
                        "slot -> host -> disk residency ladder): demoted and "
                        "prefetched adapters park here, so promotion is one "
                        "host-to-device write instead of a file read; 0 "
                        "disables the tier")
    p.add_argument("--prefill-buckets", type=int, nargs="+", default=None,
                   metavar="N",
                   help="prefill bucket sizes; default powers of two from 16 "
                        "up to min(--max-seq-len, 1024)")
    p.add_argument("--decode-steps", type=int, default=8,
                   help="fused decode steps per host sync; superseded when "
                        "--adaptive-steps is set")
    p.add_argument("--adaptive-steps", type=int, default=8, metavar="CEILING",
                   help="adaptive multi-step dispatch ceiling; 0 = static "
                        "--decode-steps")
    p.add_argument("--no-device-stops", action="store_true",
                   help="disable the device-side stop-string automata")
    p.add_argument("--no-kv-ledger", action="store_true",
                   help="disable the KV block-lifecycle ledger "
                        "(tpu:kv_* families + /debug/kv; the A/B "
                        "for the kv_ledger_ratio bench)")
    p.add_argument("--prefill-batch", type=int, default=1,
                   help="group up to P same-bucket queued prompts into "
                        "one prefill program (contiguous-lane cache)")
    p.add_argument("--pipeline-decode", action="store_true",
                   help="overlap token readback with the next decode "
                        "block (finish detection lags one block)")
    p.add_argument("--stream-lanes", type=int, default=1,
                   help="concurrent chunk-stream lanes: how many prompts "
                        "longer than the largest bucket may stream into "
                        "reserved rows at once (round-robin)")
    p.add_argument("--paged-kv-block", type=int, default=None,
                   metavar="TOKENS",
                   help="enable the paged KV pool with this block size (a "
                        "multiple of 16 on the card, e.g. 64); kv metrics "
                        "then report allocated/total blocks")
    p.add_argument("--paged-kv-blocks", type=int, default=None, metavar="N",
                   help="paged pool size in blocks; below "
                        "slots*ceil(max_seq/block) oversubscribes memory for "
                        "short-sequence traffic")
    p.add_argument("--prefix-cache", action="store_true",
                   help="retain finished prompts' full KV blocks "
                        "(content-addressed, refcounted) so prompts sharing a "
                        "prefix prefill only their suffix; requires "
                        "--paged-kv-block")
    p.add_argument("--quantize", choices=("none", "int8"), default="none",
                   help="weight-only int8 quantization of the big "
                        "projections (per output channel)")
    p.add_argument("--kv-quantize", choices=("none", "int8"), default="none",
                   help="store the KV cache int8 with one scale per position "
                        "and KV head (lanes and the paged pool, prefix cache "
                        "included)")
    p.add_argument("--role", choices=("collocated", "prefill", "decode"),
                   default="collocated",
                   help="disaggregation role: 'prefill' replicas serve "
                        "/v1/prefill handoffs, 'decode' replicas admit them "
                        "via /v1/attach, 'collocated' (default) serves whole "
                        "requests; the role is advisory — every server keeps "
                        "the full API")
    p.add_argument("--handoff-ttl-s", type=float, default=60.0,
                   help="abandoned-handoff backstop: an attach-imported "
                        "request still parked in decode_wait this many "
                        "seconds after admission is presumed abandoned (its "
                        "gateway rerouted) and is released; 0 disables. The "
                        "gateway's POST /v1/prefill/release is the fast "
                        "path, this TTL the safety net.")
    p.add_argument("--speculative", type=int, default=0, metavar="K",
                   help="speculative decoding: a draft model proposes K "
                        "tokens per cycle, the target verifies them in one "
                        "multi-token forward; greedy requests keep exact "
                        "parity.  Requires --draft-model")
    p.add_argument("--draft-model", default=None, choices=sorted(CONFIGS),
                   help="model preset of the speculative draft (it must "
                        "share the target's vocabulary); random weights from "
                        "seed 1 without --draft-checkpoint")
    p.add_argument("--draft-checkpoint", default=None, metavar="DIR",
                   help="the draft's checkpoint, either form --checkpoint "
                        "takes; an HF or model_config.json architecture "
                        "replaces --draft-model's")
    p.add_argument("--mesh", default=None, metavar="AXIS=N[,AXIS=N...]",
                   help="serve sharded over a device mesh, e.g. 'tensor=2' "
                        "(axes: data,fsdp,pipe,tensor,expert,sequence; "
                        "parallel/mesh.py; the port serves tensor). On the "
                        "card it takes that many CUDA devices; with "
                        "--device cpu every shard sits on the CPU. Default: "
                        "single device.")
    p.add_argument("--no-cuda-graphs", action="store_true",
                   help="run the decode and spec blocks eagerly instead of "
                        "replaying CUDA graphs of them; a mesh whose shards "
                        "sit on distinct cards needs it")
    p.add_argument("--drain-grace", type=float, default=30.0, metavar="S")
    p.add_argument("-v", "--verbose", action="count", default=0)
    return p


def make_server(argv=None, params=None, draft_params=None,
                mesh_devices=None):
    """Build the engine and the HTTP server from CLI arguments; returns
    ``(httpd, engine, args)`` with the engine loop started.  The caller runs
    ``httpd.serve_forever()``.

    The steps follow the reference's ``main``: the tokenizer; the
    ``--checkpoint`` (whose architecture, if it brings one, replaces the
    preset's but keeps its LoRA slots and rank, and whose name is served
    beside the preset's); the vocabulary check, against the architecture
    served; int8; the draft (``--draft-checkpoint``'s architecture
    replaces ``--draft-model``'s); the engine, stopping on the tokenizer's
    EOS.  A checkpoint that cannot be read raises: nothing is served in
    its place.

    ``params`` reuses weights already on the device (same model, dtype and
    device) instead of drawing them, and ``draft_params`` the draft's
    under ``--speculative``; neither goes with its checkpoint flag.  With
    ``--quantize int8`` the engine gets new quantized trees and the
    caller's stay as they were; random weights are drawn, and checkpoints
    loaded, int8 a layer at a time (the same tree as quantizing the dense
    one, which need never fit the card).

    ``--mesh`` serves the model tensor-parallel (``parallel/``): the
    engine splits the weights, caches and adapter slots per shard.
    ``mesh_devices`` places the shards explicitly (``["cuda:0",
    "cuda:0"]`` holds a tensor=2 mesh on one card); by default they take
    the host's CUDA devices, or the CPU with ``--device cpu``."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.prefill_buckets and max(args.prefill_buckets) > args.max_seq_len:
        raise SystemExit(f"--prefill-buckets {max(args.prefill_buckets)} "
                         f"exceeds --max-seq-len {args.max_seq_len}")
    if args.paged_kv_blocks is not None and args.paged_kv_block is None:
        parser.error("--paged-kv-blocks requires --paged-kv-block")
    if args.prefix_cache and args.paged_kv_block is None:
        parser.error("--prefix-cache requires --paged-kv-block")
    if args.speculative > 0 and args.draft_model is None:
        parser.error("--speculative requires --draft-model")
    if args.draft_checkpoint and args.speculative <= 0:
        parser.error("--draft-checkpoint requires --speculative")
    if params is not None and args.checkpoint:
        raise ValueError("params= and --checkpoint both give the weights")
    if draft_params is not None and args.draft_checkpoint:
        raise ValueError("draft_params= and --draft-checkpoint both give "
                         "the draft's weights")
    if (args.device == "cuda" and args.paged_kv_block is not None
            and args.paged_kv_block % 16):
        parser.error("--paged-kv-block must be a multiple of 16 on the card "
                     "(the paged decode kernel's tile)")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")
    engine_cfg = EngineConfig(
        decode_slots=args.decode_slots, max_seq_len=args.max_seq_len,
        prefill_buckets=(
            tuple(sorted(args.prefill_buckets)) if args.prefill_buckets
            else tuple(b for b in (16, 32, 64, 128, 256, 512, 1024)
                       if b <= args.max_seq_len)
            or (min(args.max_seq_len, 1024),)),
        decode_steps_per_sync=args.decode_steps,
        adaptive_steps=args.adaptive_steps,
        device_stops=not args.no_device_stops,
        stream_lanes=args.stream_lanes,
        pipeline_decode=args.pipeline_decode,
        prefill_batch=args.prefill_batch,
        paged_kv_block=args.paged_kv_block,
        paged_kv_blocks=args.paged_kv_blocks,
        prefix_cache=args.prefix_cache,
        kv_ledger=not args.no_kv_ledger,
        kv_cache_quant=(None if args.kv_quantize == "none"
                        else args.kv_quantize),
        role=args.role,
        handoff_ttl_s=args.handoff_ttl_s,
        speculative_k=args.speculative,
    )
    cfg = dataclasses.replace(CONFIGS[args.model], max_lora_slots=args.max_loras)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    try:
        tokenizer = load_tokenizer(args.tokenizer)
    except ImportError as e:
        raise SystemExit(f"--tokenizer: {e}") from e
    quant = args.quantize == "int8"
    served_name = args.model
    if args.checkpoint:
        ckpt_cfg, params = load_serving_checkpoint(
            args.checkpoint, dtype=dtype, device=args.device, quantize=quant)
        if ckpt_cfg is not None:
            # The checkpoint's architecture; the preset keeps the serving
            # knobs (LoRA slots and rank).
            cfg = dataclasses.replace(ckpt_cfg, max_lora_slots=args.max_loras,
                                      max_lora_rank=cfg.max_lora_rank)
            served_name = cfg.name
            logger.info("model config restored from checkpoint: %s", cfg.name)
        logger.info("restored params from %s", args.checkpoint)
    # After the checkpoint may have replaced the architecture.
    if tokenizer.vocab_size > cfg.vocab_size:
        raise SystemExit(f"tokenizer vocab {tokenizer.vocab_size} exceeds "
                         f"model vocab {cfg.vocab_size}")
    if params is None:
        logger.warning("no --checkpoint: serving RANDOM weights (seed %d)",
                       args.seed)
        params = transformer.init_params(cfg, seed=args.seed, dtype=dtype,
                                         device=args.device, quantize=quant)
    draft_cfg = None
    if args.speculative > 0:
        draft_cfg = CONFIGS[args.draft_model]
        if args.draft_checkpoint:
            dc, draft_params = load_serving_checkpoint(
                args.draft_checkpoint, dtype=dtype, device=args.device,
                quantize=quant)
            if dc is not None:
                draft_cfg = dc
            logger.info("restored draft params from %s",
                        args.draft_checkpoint)
        elif draft_params is None:
            logger.warning("draft %s: RANDOM weights (seed 1)",
                           args.draft_model)
            draft_params = transformer.init_params(
                draft_cfg, seed=1, dtype=dtype, device=args.device,
                quantize=quant)
    if quant:
        target = params
        params = quantize_params(params)  # a no-op on an int8 tree
        if draft_params is not None:
            # A draft sharing the target's tree shares its quantized one.
            draft_params = (params if draft_params is target
                            else quantize_params(draft_params))
        logger.info("weights quantized to int8 (per output channel)")
    mesh = None
    if args.mesh:
        mesh_cfg = parse_axes(args.mesh)
        if mesh_devices is None and args.device == "cpu":
            mesh_devices = ["cpu"] * mesh_cfg.total
        mesh = make_mesh(mesh_cfg, mesh_devices)
        logger.info("serving sharded over mesh %s on %s", mesh.shape,
                    [str(d) for d in mesh.devices])
    lora_manager = LoRAManager(cfg, dtype=dtype, device=args.device,
                               host_cache_slots=args.host_cache_slots)
    engine = Engine(cfg, params, engine_cfg, lora_manager=lora_manager,
                    eos_id=tokenizer.eos_id, dtype=dtype, device=args.device,
                    draft_params=draft_params, draft_cfg=draft_cfg,
                    mesh=mesh, cuda_graphs=not args.no_cuda_graphs)
    engine.start()
    server = ModelServer(engine, tokenizer, served_name, lora_manager,
                         aliases={args.model})
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(server))
    httpd.daemon_threads = True
    return httpd, engine, args


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO)
    httpd, engine, args = make_server(argv)

    def _sigterm(*_):
        # Graceful termination: /health flips to 503, submits refuse, the
        # in-flight requests get --drain-grace seconds to finish.
        def _drain():
            logger.info("draining engine (grace %.0fs)", args.drain_grace)
            engine.drain(args.drain_grace)
            httpd.shutdown()
        threading.Thread(target=_drain, daemon=True).start()

    signal.signal(signal.SIGTERM, _sigterm)
    logger.info("serving %s on %s:%d (%s)", args.model, args.host, args.port,
                args.device)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        engine.stop()


if __name__ == "__main__":
    main()
