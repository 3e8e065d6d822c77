"""Model-server HTTP API on the standard library's ``ThreadingHTTPServer``
(port of ``server/api_http.py``; aiohttp is not installed where the port
runs on the card).

- ``POST /v1/completions``          OpenAI completions (prompt string or
                                    token ids), JSON or SSE ``stream: true``;
                                    ``max_tokens``, ``temperature``,
                                    ``top_k``, ``top_p``, ``seed``, ``stop``,
                                    ``presence_penalty``,
                                    ``frequency_penalty``, ``logit_bias``
- ``POST /v1/prefill``              disaggregation hop 1: prefill only; the
                                    answer is the serialized
                                    ``PrefillHandoff`` (octet-stream)
- ``POST /v1/attach``               hop 2: a handoff in, decode to the end;
                                    JSON or SSE, as ``/v1/completions``
- ``POST /v1/prefill/release``      ``{"request_id"}``: release abandoned
                                    hop-2 work
- ``GET  /v1/models``               base model + resident adapters
- ``POST /v1/load_lora_adapter``    ``{"lora_name", "lora_path"}`` (.npz)
- ``POST /v1/unload_lora_adapter``  ``{"lora_name"}``
- ``GET  /metrics``                 the ``tpu:*`` exposition the gateway scrapes
- ``GET  /debug/kv``                the KV ledger's payload (paged pool; 404
                                    on lanes)
- ``GET  /health``                  200, or 503 while draining

Parameters the port does not serve yet (chat, ``logprobs``, ``n`` /
``best_of``, ``echo``) answer 400 instead of being ignored.

    python -m llm_instance_gateway_tpu_torch.server.api_http --model llama3-8b \
        --max-seq-len 8192 --paged-kv-block 64 --prefix-cache --stream-lanes 2

A disaggregated pair is a ``--role prefill`` server and a ``--role decode``
server (paged pool, prefix cache) behind the gateway's two-hop relay; a
role is advisory, and every server keeps the whole API.

``--quantize int8`` serves int8 weights (``ops/quant.py``) and
``--kv-quantize int8`` an int8 KV cache, on lanes or on the paged pool.
``--speculative K --draft-model NAME`` decodes speculatively with a draft
of that preset (random weights from seed 1; quantized too under
``--quantize int8``); such a server refuses penalties and ``logit_bias``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import queue as queue_mod
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from llm_instance_gateway_tpu_torch.models import transformer
from llm_instance_gateway_tpu_torch.models.configs import CONFIGS
from llm_instance_gateway_tpu_torch.ops.quant import quantize_params
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

_UNSERVED_PARAMS = ("logprobs", "echo")


class HTTPError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class ModelServer:
    """Request handling, independent of the transport below."""

    def __init__(self, engine: Engine, tokenizer, model_name: str,
                 lora_manager: LoRAManager | None = None):
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.lora = lora_manager

    # -- helpers -----------------------------------------------------------
    def _resolve_model(self, requested) -> str | None:
        if requested in ("", None, self.model_name):
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

    @staticmethod
    def _parse_stops(body: dict) -> list[str]:
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
        return [s for s in stops if s]

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
    def _check_body(body: dict) -> None:
        """Refuse the body parameters the port does not serve yet, and
        check the penalties and ``logit_bias`` as the reference does."""
        if isinstance(body.get("messages"), list):
            raise ValueError("chat is not served by the torch port yet")
        for name in _UNSERVED_PARAMS:
            if body.get(name) not in (None, False, 0, 0.0, {}):
                raise ValueError(f"{name} is not served by the torch port yet")
        if int(body.get("n", 1)) != 1 or int(body.get("best_of", 1)) != 1:
            raise ValueError("n / best_of > 1 is not served by the torch "
                             "port yet")
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

    def _make_request(self, body: dict, prompt_tokens: list[int], adapter,
                      stops: list[str]) -> Request:
        self._check_body(body)
        seed = body.get("seed")
        raw_bias = body.get("logit_bias") or None
        return Request(
            prompt_tokens=prompt_tokens,
            max_new_tokens=int(body.get("max_tokens", 64)),
            sampling=SamplingParams(
                temperature=float(body.get("temperature", 0.0)),
                top_k=int(body.get("top_k", 0)),
                top_p=float(body.get("top_p", 1.0)),
                seed=None if seed is None else int(seed),
                presence_penalty=float(body.get("presence_penalty") or 0.0),
                frequency_penalty=float(body.get("frequency_penalty")
                                        or 0.0),
                logit_bias=({int(k): float(v) for k, v in raw_bias.items()}
                            if raw_bias else None)),
            adapter=adapter,
            stop_sequences=self._encode_stops(stops),
        )

    def _wait_with_stops(self, req: Request, stops: list[str],
                         timeout_s: float = 600.0,
                         submit: bool = True) -> Request:
        """generate(), cancelling the moment a stop string appears in the
        decoded text (the exact cut happens in ``_truncate_at_stop``);
        ``submit=False`` waits on a request admitted already (an attach)."""
        if submit:
            self.engine.submit(req)
        deadline = time.monotonic() + timeout_s
        max_stop = max((len(s) for s in stops), default=0)
        text, consumed = "", 0
        while True:
            req.stream_event.wait(0.25)
            req.stream_event.clear()
            done = req.done.is_set()
            n = len(req.output_tokens)
            if stops and n > consumed:
                piece = self.tokenizer.decode(req.output_tokens[consumed:n])
                if not (piece.endswith("�") and not done):
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

    def _truncate_at_stop(self, req: Request, stops: list[str]) -> str:
        """Cut text AND tokens at the earliest stop match."""
        full = self.tokenizer.decode(req.output_tokens)
        hits = [(full.index(s), s) for s in stops if s in full]
        if not hits:
            return full
        idx, _ = min(hits)
        lo, hi = 1, len(req.output_tokens)
        while lo < hi:
            mid = (lo + hi) // 2
            if any(s in self.tokenizer.decode(req.output_tokens[:mid])
                   for s in stops):
                hi = mid
            else:
                lo = mid + 1
        del req.output_tokens[lo:]
        req.finish_reason = "stop"
        return full[:idx]

    # -- endpoints ---------------------------------------------------------
    def completions(self, body: dict):
        """Returns (status, payload) for JSON, or a generator of SSE chunks
        (dicts, then None for ``[DONE]``) for ``stream: true``."""
        adapter = self._resolve_model(body.get("model", self.model_name))
        try:
            stops = self._parse_stops(body)
            req = self._make_request(body, self._encode_prompt(body), adapter,
                                     stops)
        except (ValueError, TypeError) as e:
            raise HTTPError(400, str(e)) from e
        model = body.get("model", self.model_name)
        if body.get("stream"):
            req.streaming = True
            self._submit(req)
            return self._sse(req, model, stops)
        try:
            if stops:
                self._wait_with_stops(req, stops)
            else:
                self.engine.generate(req)
        except (EngineDraining, ValueError, queue_mod.Full,
                AdapterError) as e:
            raise self._submit_error(e) from e
        return 200, self._completion(req, model, stops)

    def _completion(self, req: Request, model: str, stops: list[str]) -> dict:
        """The JSON envelope of a finished request."""
        if req.error:
            raise HTTPError(500, req.error)
        text = (self._truncate_at_stop(req, stops) if stops
                else self.tokenizer.decode(req.output_tokens))
        n_out = len(req.output_tokens)
        return {
            "id": f"cmpl-{req.request_id}",
            "object": "text_completion",
            "created": int(time.time()),
            "model": model,
            "choices": [{"index": 0, "text": text,
                         "finish_reason": req.finish_reason}],
            "usage": {"prompt_tokens": len(req.prompt_tokens),
                      "completion_tokens": n_out,
                      "total_tokens": len(req.prompt_tokens) + n_out},
            "ttft_ms": round(req.ttft_s * 1000, 2),
        }

    # -- disaggregation hops (server/kv_transfer.py) -------------------------
    def prefill(self, body: dict):
        """Hop 1: prefill only; answers the serialized ``PrefillHandoff``.
        Shapes a handoff cannot carry (candidate fan-out, echo) and prompts
        beyond the largest bucket answer 422, bodies the port refuses
        anywhere 400: the gateway serves any non-200 single-hop."""
        adapter = self._resolve_model(body.get("model", self.model_name))
        try:
            fan_out = (int(body.get("n", 1)) > 1
                       or int(body.get("best_of", 1)) > 1)
            if fan_out or body.get("echo"):
                raise HTTPError(422, "prefill hop supports single-candidate, "
                                     "non-echo requests")
            stops = self._parse_stops(body)
            req = self._make_request(body, self._encode_prompt(body), adapter,
                                     stops)
        except (ValueError, TypeError) as e:
            raise HTTPError(400, str(e)) from e
        try:
            handoff = self.engine.prefill_only(req)
        except ValueError as e:  # e.g. beyond the largest bucket
            raise HTTPError(422, str(e)) from e
        except (EngineDraining, queue_mod.Full, AdapterError) as e:
            raise self._submit_error(e) from e
        except RuntimeError as e:
            raise HTTPError(500, str(e)) from e
        handoff.body = body  # envelope parameters ride to the decode hop
        t0 = time.perf_counter()
        wire = handoff.to_bytes()
        ser_s = time.perf_counter() - t0
        self.engine.observe_handoff(ser_s)
        return 200, wire, {"x-request-id": req.request_id,
                           "x-prefill-ttft-ms": f"{req.ttft_s * 1000:.2f}",
                           "x-handoff-serialize-ms": f"{ser_s * 1e3:.3f}"}

    def attach(self, raw: bytearray):
        """Hop 2: admit a handoff into decode and answer in the
        completions envelope (SSE included), as collocated serving
        would."""
        t0 = time.perf_counter()
        try:
            handoff = PrefillHandoff.from_bytes(raw)
        except Exception as e:
            raise HTTPError(400, f"malformed handoff: {e}") from e
        t1 = time.perf_counter()
        body = handoff.body or {}
        try:
            self._check_body(body)
            stops = self._parse_stops(body)
        except (ValueError, TypeError) as e:
            raise HTTPError(400, str(e)) from e
        try:
            req = self.engine.attach_prefilled(handoff)
        except ValueError as e:
            raise HTTPError(422, str(e)) from e
        except (EngineDraining, queue_mod.Full, AdapterError) as e:
            raise self._submit_error(e) from e
        t2 = time.perf_counter()
        self.engine.observe_handoff(t2 - t0)
        headers = {"x-request-id": req.request_id,
                   "x-handoff-deserialize-ms": f"{(t1 - t0) * 1e3:.3f}",
                   "x-handoff-attach-ms": f"{(t2 - t1) * 1e3:.3f}"}
        model = body.get("model", self.model_name)
        if body.get("stream"):
            req.streaming = True
            return 200, self._sse(req, model, stops), headers
        if stops:
            self._wait_with_stops(req, stops, submit=False)
        elif not req.done.wait(600.0):
            req.error = "generation timed out"
            req.cancelled.set()
        return 200, self._completion(req, model, stops), headers

    def release(self, body: dict):
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
        return 200, {"request_id": request_id, "released": released}

    @staticmethod
    def _submit_error(e: Exception) -> HTTPError:
        if isinstance(e, EngineDraining):
            return HTTPError(503, str(e))
        if isinstance(e, queue_mod.Full):
            return HTTPError(429, "prefill queue is full")
        if isinstance(e, AdapterError):
            return HTTPError(404, str(e))
        return HTTPError(400, str(e))

    def _submit(self, req: Request) -> None:
        try:
            self.engine.submit(req)
        except (EngineDraining, ValueError, queue_mod.Full,
                AdapterError) as e:
            raise self._submit_error(e) from e

    def _sse(self, req: Request, model: str, stops: list[str],
             timeout_s: float = 600.0):
        """Per-token SSE chunks (text deltas from prefix-diffed decodes; a
        trailing U+FFFD is held back).  With stops, emitted text lags by the
        longest stop minus one so no stop prefix leaks before the match."""
        def chunk(delta, fin, usage=False):
            payload = {"id": f"cmpl-{req.request_id}",
                       "object": "text_completion", "model": model,
                       "choices": [{"index": 0, "text": delta,
                                    "finish_reason": fin}]}
            if usage:
                n_out = len(req.output_tokens)
                payload["usage"] = {
                    "prompt_tokens": len(req.prompt_tokens),
                    "completion_tokens": n_out,
                    "total_tokens": len(req.prompt_tokens) + n_out}
            return payload

        deadline = time.monotonic() + timeout_s
        holdback = max((len(s) for s in stops), default=1) - 1
        text, emitted, consumed = "", 0, 0
        try:
            while True:
                req.stream_event.wait(0.25)
                req.stream_event.clear()
                done = req.done.is_set()  # read BEFORE the token count
                n = len(req.output_tokens)
                while consumed < n:
                    # Per-token growth of the decoded text.
                    cur = self.tokenizer.decode(req.output_tokens[:consumed + 1])
                    if cur.endswith("�") and consumed + 1 == n and not done:
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

    def models(self):
        data = [{"id": self.model_name, "object": "model",
                 "root": self.model_name}]
        if self.lora is not None:
            data += [{"id": name, "object": "model", "root": self.model_name,
                      "parent": self.model_name}
                     for name in self.lora.running_adapters()]
        return 200, {"object": "list", "data": data,
                     "role": self.engine.cfg.role}

    def load_adapter(self, body: dict):
        if self.lora is None:
            raise HTTPError(400, "LoRA serving is not enabled")
        name, path = body.get("lora_name"), body.get("lora_path")
        if not name or not path:
            raise HTTPError(400, "lora_name and lora_path are required")
        if name == self.model_name:
            raise HTTPError(409, f"adapter name {name!r} collides with the "
                                 "base model's served names")
        try:
            self.lora.load(name, checkpoint_path=path)
        except AdapterError as e:
            raise HTTPError(409, str(e)) from e
        except Exception as e:
            logger.exception("adapter load failed")
            raise HTTPError(500, f"failed to load adapter: {e}") from e
        return 200, {"status": "ok", "loaded": name}

    def unload_adapter(self, body: dict):
        if self.lora is None:
            raise HTTPError(400, "LoRA serving is not enabled")
        name = body.get("lora_name")
        if not name:
            raise HTTPError(400, "lora_name is required")
        try:
            removed = self.lora.unload(name)
        except AdapterBusyError as e:
            raise HTTPError(409, str(e)) from e
        if not removed:
            raise HTTPError(404, f"adapter {name!r} not loaded")
        return 200, {"status": "ok", "unloaded": name}

    def debug_kv(self):
        ledger = self.engine.kv_ledger
        if ledger is None:
            raise HTTPError(404, "kv ledger is disabled (non-paged cache or "
                                 "EngineConfig.kv_ledger=False)")
        self.engine._kv_ledger_sync()
        return 200, {"model": self.model_name, "role": self.engine.cfg.role,
                     **ledger.snapshot()}

    def metrics_text(self) -> str:
        snap = self.engine.metrics_snapshot()
        snap.setdefault("model_name", self.model_name)
        return metrics_mod.render(snap)


def make_handler(server: ModelServer):
    """The ``BaseHTTPRequestHandler`` class bound to ``server``."""

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

        def _error(self, status: int, message: str) -> None:
            self._json(status, {"error": {"message": message,
                                          "type": "invalid_request_error"}})

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

        def do_GET(self):  # noqa: N802 - http.server's naming
            path = self.path.split("?", 1)[0]
            if path == "/health":
                if server.engine.draining:
                    self._send(503, b"draining", "text/plain")
                else:
                    self._send(200, b"ok", "text/plain")
            elif path == "/metrics":
                self._send(200, server.metrics_text().encode(),
                           "text/plain; version=0.0.4")
            elif path == "/v1/models":
                self._json(*server.models())
            elif path == "/debug/kv":
                try:
                    self._json(*server.debug_kv())
                except HTTPError as e:
                    self._error(e.status, str(e))
            else:
                self._error(404, f"no route {path}")

        def do_POST(self):  # noqa: N802 - http.server's naming
            path = self.path.split("?", 1)[0]
            routes = {"/v1/completions": server.completions,
                      "/v1/prefill": server.prefill,
                      "/v1/attach": server.attach,
                      "/v1/prefill/release": server.release,
                      "/v1/load_lora_adapter": server.load_adapter,
                      "/v1/unload_lora_adapter": server.unload_adapter}
            fn = routes.get(path)
            if fn is None:
                self._error(404, f"no route {path}")
                return
            try:
                # A handoff is binary; every other route takes JSON.
                result = fn(self._raw() if fn == server.attach
                            else self._body())
            except HTTPError as e:
                self._error(e.status, str(e))
                return
            # (status, payload[, headers]) or a bare SSE generator; the
            # payload is JSON (dict), a handoff (bytes) or SSE.
            status, payload, *rest = (result if isinstance(result, tuple)
                                      else (200, result))
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
                   help="seed of the random weights (no checkpoint loading "
                        "in the port yet)")
    p.add_argument("--decode-slots", type=int, default=8)
    p.add_argument("--max-seq-len", type=int, default=1024)
    p.add_argument("--max-loras", type=int, default=4)
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
                        "seed 1")
    p.add_argument("--drain-grace", type=float, default=30.0, metavar="S")
    p.add_argument("-v", "--verbose", action="count", default=0)
    return p


def make_server(argv=None, params=None, draft_params=None):
    """Build the engine and the HTTP server from CLI arguments; returns
    ``(httpd, engine, args)`` with the engine loop started.  The caller runs
    ``httpd.serve_forever()``.  ``params`` reuses weights already on the
    device (same model, dtype and device) instead of drawing them, and
    ``draft_params`` the draft's under ``--speculative``; with
    ``--quantize int8`` the engine gets new quantized trees and the
    caller's stay as they were."""
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
        kv_cache_quant=(None if args.kv_quantize == "none"
                        else args.kv_quantize),
        role=args.role,
        handoff_ttl_s=args.handoff_ttl_s,
        speculative_k=args.speculative,
    )
    cfg = dataclasses.replace(CONFIGS[args.model], max_lora_slots=args.max_loras)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    tokenizer = load_tokenizer(None)
    if tokenizer.vocab_size > cfg.vocab_size:
        raise SystemExit(f"tokenizer vocab {tokenizer.vocab_size} exceeds "
                         f"model vocab {cfg.vocab_size}")
    if params is None:
        logger.warning("serving RANDOM weights (seed %d)", args.seed)
        params = transformer.init_params(cfg, seed=args.seed, dtype=dtype,
                                         device=args.device)
    draft_cfg = None
    if args.speculative > 0:
        draft_cfg = CONFIGS[args.draft_model]
        if draft_params is None:
            logger.warning("draft %s: RANDOM weights (seed 1)",
                           args.draft_model)
            draft_params = transformer.init_params(
                draft_cfg, seed=1, dtype=dtype, device=args.device)
    if args.quantize == "int8":
        target = params
        params = quantize_params(params)
        if draft_params is not None:
            # A draft sharing the target's tree shares its quantized one.
            draft_params = (params if draft_params is target
                            else quantize_params(draft_params))
        logger.info("weights quantized to int8 (per output channel)")
    lora_manager = LoRAManager(cfg, dtype=dtype, device=args.device)
    engine = Engine(cfg, params, engine_cfg, lora_manager=lora_manager,
                    eos_id=tokenizer.eos_id, dtype=dtype, device=args.device,
                    draft_params=draft_params, draft_cfg=draft_cfg)
    engine.start()
    server = ModelServer(engine, tokenizer, args.model, lora_manager)
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
