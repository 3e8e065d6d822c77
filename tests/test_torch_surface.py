"""The torch port's OpenAI surface held to the JAX package's on the CPU.

The same numpy-seeded weights (``TINY_TEST``, f32, through the weight
bridge) and the same bodies go to the JAX ``ModelServer`` (aiohttp's test
client, as ``tests/test_openai_surface.py`` drives it) and to the port's
``ModelServer`` behind its stdlib ``ThreadingHTTPServer``: completions and
chat, ``logprobs`` 0/3/5, ``n`` / ``best_of``, ``echo``, stops beside
logprobs, streams.  Answers must have the same status and JSON keys,
identical greedy text and ``usage``, and logprobs within 1e-4 (f32).
Invalid bodies get the same status and message.  Seeded candidates cannot
match across packages (torch has no threefry), so they are held within the
port: candidate ``i`` of ``seed=s`` equals a single request with seed
``s+i``, and ``best_of`` keeps the best candidates of the same draw.
"""

import asyncio
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from llm_instance_gateway_tpu.models import transformer as jtf
from llm_instance_gateway_tpu.models.configs import TINY_TEST as JAX_TINY
from llm_instance_gateway_tpu.server import api_http as japi
from llm_instance_gateway_tpu.server import engine as jeng
from llm_instance_gateway_tpu.server.tokenizer import ByteTokenizer as JBytes

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch.models.configs import TINY_TEST  # noqa: E402
from llm_instance_gateway_tpu_torch.models.weights import params_from_numpy  # noqa: E402
from llm_instance_gateway_tpu_torch.server import api_http as tapi  # noqa: E402
from llm_instance_gateway_tpu_torch.server import engine as teng  # noqa: E402
from llm_instance_gateway_tpu_torch.server.tokenizer import ByteTokenizer  # noqa: E402

EOS = 257
ENGINE = dict(decode_slots=4, max_seq_len=64, prefill_buckets=(8, 16, 32),
              decode_steps_per_sync=2)
ATOL = 1e-4
CHAT = [{"role": "system", "content": "be brief"},
        {"role": "user", "content": "hi"}]


@pytest.fixture(scope="module")
def servers():
    """(JAX ModelServer, port URL, port ModelServer) over the same
    weights."""
    jw = jtf.init_params(JAX_TINY, jax.random.PRNGKey(0), jnp.float32)
    jengine = jeng.Engine(JAX_TINY, jw, jeng.EngineConfig(**ENGINE),
                          eos_id=EOS, dtype=jnp.float32)
    jengine.start()
    tengine = teng.Engine(TINY_TEST,
                          params_from_numpy(jax.tree.map(np.asarray, jw),
                                            "cpu"),
                          teng.EngineConfig(**ENGINE), eos_id=EOS,
                          dtype=torch.float32, device="cpu")
    tengine.start()
    tserver = tapi.ModelServer(tengine, ByteTokenizer(), "llama3-tiny")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), tapi.make_handler(tserver))
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield (japi.ModelServer(jengine, JBytes(), "llama3-tiny"),
           "http://127.0.0.1:%d" % httpd.server_address[1], tserver)
    httpd.shutdown()
    httpd.server_close()
    jengine.stop()
    tengine.stop()


def jax_post(server, path, body, raw=None):
    """(status, headers, body bytes) from the JAX server."""
    async def run():
        client = TestClient(TestServer(server.build_app()))
        await client.start_server()
        try:
            if raw is not None:
                resp = await client.post(path, data=raw)
            else:
                resp = await client.post(path, json=body)
            return resp.status, dict(resp.headers), await resp.read()
        finally:
            await client.close()

    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(run())
    finally:
        loop.close()


def port_post(url, body, raw=None, headers=None):
    """(status, headers, body bytes) from the port's server."""
    data = raw if raw is not None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as f:
            return f.status, dict(f.headers), f.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def both(servers, path, body, raw=None):
    jserver, url, _ = servers
    return (jax_post(jserver, path, body, raw),
            port_post(url + path, body, raw))


def sse(raw: bytes) -> list:
    lines = [ln[6:] for ln in raw.decode().splitlines()
             if ln.startswith("data: ")]
    assert lines[-1] == "[DONE]"
    return [json.loads(ln) for ln in lines[:-1]]


VOLATILE = ("id", "created", "ttft_ms")


def same_keys(a, b, path="$"):
    """The same JSON structure: dict keys at every level, list lengths."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (path, a, b)
        for k in a:
            same_keys(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            same_keys(x, y, f"{path}[{i}]")


def same_values(a, b, path="$"):
    """Equal JSON values, floats within ATOL, volatile envelope fields
    skipped."""
    if isinstance(a, dict):
        for k in a:
            if k not in VOLATILE:
                same_values(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        for i, (x, y) in enumerate(zip(a, b)):
            same_values(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, abs=ATOL), (path, a, b)
    else:
        assert a == b, (path, a, b)


def _stop_of(servers, path, body):
    """Two characters from the middle of the greedy answer: a stop that
    hits."""
    _, (status, _, raw) = both(servers, path, body)
    choice = json.loads(raw)["choices"][0]
    text = choice["message"]["content"] if "message" in choice \
        else choice["text"]
    assert len(text) >= 6
    return text[len(text) // 2:len(text) // 2 + 2]


COMPLETIONS = {
    "logprobs-0": {"prompt": "hello", "max_tokens": 6, "logprobs": 0},
    "logprobs-3": {"prompt": "hello", "max_tokens": 6, "logprobs": 3},
    "logprobs-5": {"prompt": "abc", "max_tokens": 8, "logprobs": 5},
    "n-2": {"prompt": "abc", "max_tokens": 5, "n": 2, "logprobs": 1},
    "best_of-3": {"prompt": "abc", "max_tokens": 5, "best_of": 3},
    "n-2-best_of-3": {"prompt": "xyz", "max_tokens": 4, "n": 2,
                      "best_of": 3, "logprobs": 2},
    "echo": {"prompt": "abc", "max_tokens": 4, "echo": True},
    "token-ids": {"prompt": [256, 104, 105], "max_tokens": 5,
                  "logprobs": 2},
    "token-ids-echo": {"prompt": [256, 104, 105], "max_tokens": 3,
                       "echo": True},
    "plain": {"prompt": "the", "max_tokens": 7},
}
CHATS = {
    "chat": {"messages": CHAT, "max_tokens": 6},
    "chat-logprobs": {"messages": CHAT, "max_tokens": 6, "logprobs": True},
    "chat-top-3": {"messages": CHAT, "max_tokens": 6, "logprobs": True,
                   "top_logprobs": 3},
    "chat-top-20": {"messages": CHAT, "max_tokens": 5, "logprobs": True,
                    "top_logprobs": 20},
    "chat-n-2": {"messages": CHAT, "max_tokens": 4, "n": 2},
}


@pytest.mark.parametrize("path,body", [
    *(("/v1/completions", b) for b in COMPLETIONS.values()),
    *(("/v1/chat/completions", b) for b in CHATS.values())],
    ids=[*COMPLETIONS, *CHATS])
def test_answers_equal_the_reference(servers, path, body):
    (js, _, jraw), (ts, _, traw) = both(servers, path, body)
    assert (js, ts) == (200, 200), (jraw, traw)
    want, got = json.loads(jraw), json.loads(traw)
    same_keys(want, got)
    same_values(want, got)


@pytest.mark.parametrize("path,body", [
    ("/v1/completions", {"prompt": "hello", "max_tokens": 16,
                         "logprobs": 3}),
    ("/v1/completions", {"prompt": "hello", "max_tokens": 16,
                         "logprobs": 0, "n": 2}),
    ("/v1/chat/completions", {"messages": CHAT, "max_tokens": 16,
                              "logprobs": True, "top_logprobs": 2})],
    ids=["completions", "completions-n-2", "chat"])
def test_stop_with_logprobs_equals_the_reference(servers, path, body):
    """A stop cuts the text and the logprob records alike (the kept token
    that completed the stop is clipped to the returned text)."""
    stop = _stop_of(servers, path, {k: v for k, v in body.items()
                                    if k not in ("logprobs", "top_logprobs",
                                                 "n")})
    body = dict(body, stop=[stop])
    (js, _, jraw), (ts, _, traw) = both(servers, path, body)
    assert (js, ts) == (200, 200), (jraw, traw)
    want, got = json.loads(jraw), json.loads(traw)
    same_keys(want, got)
    same_values(want, got)
    for choice in got["choices"]:
        assert choice["finish_reason"] == "stop"
        if path == "/v1/completions":
            assert "".join(choice["logprobs"]["tokens"]) == choice["text"]
        else:
            assert "".join(e["token"] for e in
                           choice["logprobs"]["content"]) == \
                choice["message"]["content"]
    assert got["usage"]["completion_tokens"] < 16 * len(got["choices"])


STREAMS = {
    "completions": ("/v1/completions", {"prompt": "hello", "max_tokens": 8}),
    "echo": ("/v1/completions", {"prompt": "abc", "max_tokens": 5,
                                 "echo": True}),
    "chat": ("/v1/chat/completions", {"messages": CHAT, "max_tokens": 8}),
    "chat-stop": ("/v1/chat/completions", {"messages": CHAT,
                                           "max_tokens": 16}),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_streams_equal_the_reference(servers, name):
    path, body = STREAMS[name]
    if name == "chat-stop":
        body = dict(body, stop=_stop_of(servers, path, body))
    body = dict(body, stream=True)
    (js, _, jraw), (ts, theaders, traw) = both(servers, path, body)
    assert (js, ts) == (200, 200)
    assert "text/event-stream" in theaders["Content-Type"]
    want, got = sse(jraw), sse(traw)
    chat = path.endswith("chat/completions")

    def text(chunks):
        return "".join(c["choices"][0]["delta"].get("content", "") if chat
                       else c["choices"][0]["text"] for c in chunks)

    assert text(got) == text(want) and text(got)
    for chunks in (want, got):
        assert {c["object"] for c in chunks} == {
            "chat.completion.chunk" if chat else "text_completion"}
        assert all(c["choices"][0]["finish_reason"] is None
                   for c in chunks[:-1])
    assert got[-1]["choices"][0]["finish_reason"] == \
        want[-1]["choices"][0]["finish_reason"]
    assert got[-1]["usage"] == want[-1]["usage"]
    same_keys(want[-1], got[-1])
    if name == "echo":
        assert got[0]["choices"][0]["text"] == "abc" == \
            want[0]["choices"][0]["text"]
    if chat:
        # An empty delta is {} in both.
        assert [c["choices"][0]["delta"] == {} for c in got[-1:]] == [
            c["choices"][0]["delta"] == {} for c in want[-1:]]


INVALID = {
    "n-9": ("/v1/completions", {"prompt": "x", "n": 9}),
    "n-0": ("/v1/completions", {"prompt": "x", "n": 0}),
    "best_of-below-n": ("/v1/completions", {"prompt": "x", "n": 3,
                                            "best_of": 2}),
    "best_of-9": ("/v1/completions", {"prompt": "x", "best_of": 9}),
    "logprobs-6": ("/v1/completions", {"prompt": "x", "logprobs": 6}),
    "logprobs-negative": ("/v1/completions", {"prompt": "x",
                                              "logprobs": -1}),
    "echo-logprobs": ("/v1/completions", {"prompt": "x", "echo": True,
                                          "logprobs": 1}),
    "stream-n": ("/v1/completions", {"prompt": "x", "n": 2,
                                     "stream": True}),
    "stream-best_of": ("/v1/completions", {"prompt": "x", "best_of": 2,
                                           "stream": True}),
    "stream-logprobs": ("/v1/completions", {"prompt": "x", "logprobs": 1,
                                            "stream": True}),
    "five-stops": ("/v1/completions", {"prompt": "x",
                                       "stop": ["a", "b", "c", "d", "e"]}),
    "stop-int": ("/v1/completions", {"prompt": "x", "stop": 3}),
    "penalty": ("/v1/completions", {"prompt": "x", "presence_penalty": 3}),
    "bias": ("/v1/completions", {"prompt": "x", "logit_bias": {"1": 200}}),
    "unknown-model": ("/v1/completions", {"prompt": "x", "model": "nope"}),
    "too-long": ("/v1/completions", {"prompt": "x" * 100}),
    "chat-top-without-flag": ("/v1/chat/completions",
                              {"messages": CHAT, "top_logprobs": 2}),
    "chat-top-21": ("/v1/chat/completions",
                    {"messages": CHAT, "logprobs": True,
                     "top_logprobs": 21}),
    "chat-stream-logprobs": ("/v1/chat/completions",
                             {"messages": CHAT, "logprobs": True,
                              "stream": True}),
    "chat-stream-n": ("/v1/chat/completions",
                      {"messages": CHAT, "n": 2, "stream": True}),
    "chat-n-9": ("/v1/chat/completions", {"messages": CHAT, "n": 9}),
    "chat-unknown-model": ("/v1/chat/completions",
                           {"messages": CHAT, "model": "nope"}),
    "invalid-json": ("/v1/completions", None),
    "chat-invalid-json": ("/v1/chat/completions", None),
}


@pytest.mark.parametrize("name", list(INVALID))
def test_invalid_bodies_answer_as_the_reference(servers, name):
    path, body = INVALID[name]
    raw = b"{not json" if body is None else None
    (js, jh, jraw), (ts, th, traw) = both(servers, path, body, raw)
    assert js == ts and js in (400, 404), (jraw, traw)
    want, got = json.loads(jraw)["error"], json.loads(traw)["error"]
    assert (got["message"], got["type"]) == (want["message"], want["type"])
    assert got.keys() == want.keys()  # trace_id included
    assert th["x-lig-trace-id"] == got["trace_id"]


# -- attribution of split and genuine U+FFFD characters ----------------------


def test_multibyte_char_attributed_whole(servers):
    """A UTF-8 character split across byte tokens is attributed whole to
    its completing token, in both logprobs forms (the reference's case)."""
    server = servers[2]
    req = teng.Request(prompt_tokens=[1], max_new_tokens=8)
    req.output_tokens = [ord("a"), 0xF0, 0x9F, 0x98, 0x80, ord("b")]
    req.output_logprobs = [-0.5] * 6
    req.output_top_logprobs = [{t: -0.5} for t in req.output_tokens]
    chat = server._chat_logprobs_json(req, top_n=1)["content"]
    pieces = [e["token"] for e in chat]
    assert pieces == ["a", "", "", "", "😀", "b"]
    assert bytes(b for e in chat for b in e["bytes"]).decode() == "a😀b"
    comp = server._logprobs_json(req, k=1)
    assert "".join(comp["tokens"]) == "a😀b"
    assert comp["text_offset"] == [0, 1, 1, 1, 1, 2]
    rows = server._per_token_records(req, 1)
    assert [r[0] for r in rows] == pieces


class _FFFDVocab:
    """id 0 -> 'a', id 1 -> a genuine U+FFFD char, id 2 -> 'b'."""

    def decode(self, ids):
        return "".join({0: "a", 1: "�", 2: "b"}[i] for i in ids)


def test_genuine_replacement_char_keeps_its_row():
    server = tapi.ModelServer(None, _FFFDVocab(), "m")
    req = teng.Request(prompt_tokens=[0], max_new_tokens=8)
    req.output_tokens = [0, 1, 2]
    req.output_logprobs = [-0.5] * 3
    req.output_top_logprobs = [{t: -0.5} for t in req.output_tokens]
    chat = server._chat_logprobs_json(req, top_n=1)["content"]
    assert [e["token"] for e in chat] == ["a", "�", "b"]
    assert chat[1]["bytes"] == list("�".encode())
    comp = server._logprobs_json(req, k=1)
    assert comp["tokens"] == ["a", "�", "b"]
    assert comp["text_offset"] == [0, 1, 2]


def test_trailing_genuine_fffd_run_not_held_back():
    server = tapi.ModelServer(None, _FFFDVocab(), "m")
    req = teng.Request(prompt_tokens=[0], max_new_tokens=8)
    req.output_tokens = [0, 1, 1, 1, 1, 0]
    req.output_logprobs = [-0.5] * 6
    req.output_top_logprobs = [{t: -0.5} for t in req.output_tokens]
    assert server._logprobs_json(req, k=0)["tokens"] == [
        "a", "�", "�", "�", "�", "a"]


def test_truncate_at_stop_cuts_the_logprob_records():
    """The stop cut drops the tokens' logprobs and top logprobs with them
    (they were left misaligned before)."""
    server = tapi.ModelServer(None, ByteTokenizer(), "m")
    req = teng.Request(prompt_tokens=[0], max_new_tokens=8, logprobs=2)
    req.output_tokens = [ord(c) for c in "abcXYdef"]
    req.output_logprobs = [-0.1 * i for i in range(8)]
    req.output_top_logprobs = [{t: -0.1} for t in req.output_tokens]
    text, hit = server._truncate_at_stop(req, ["XY", "ef"])
    assert (text, hit, req.finish_reason) == ("abc", True, "stop")
    assert len(req.output_tokens) == len(req.output_logprobs) == len(
        req.output_top_logprobs) == 5
    assert server._logprobs_json(req, 2, text_limit=3)["tokens"] == [
        "a", "b", "c"]


# -- seeded candidates, held within the port ---------------------------------


SEEDED = {"prompt": "abc", "max_tokens": 6, "temperature": 0.8, "seed": 11,
          "logprobs": 0}


def _port(servers, body, path="/v1/completions"):
    status, _, raw = port_post(servers[1] + path, body)
    assert status == 200, raw
    return json.loads(raw)


def test_candidates_draw_with_seed_plus_index(servers):
    many = _port(servers, dict(SEEDED, n=3))
    assert [c["index"] for c in many["choices"]] == [0, 1, 2]
    assert len({c["text"] for c in many["choices"]}) > 1
    for i, choice in enumerate(many["choices"]):
        one = _port(servers, dict(SEEDED, seed=11 + i))["choices"][0]
        assert (choice["text"], choice["logprobs"]["token_logprobs"]) == (
            one["text"], one["logprobs"]["token_logprobs"])
    assert many["usage"]["completion_tokens"] == 18


def test_best_of_keeps_the_best_of_the_same_draw(servers):
    four = _port(servers, dict(SEEDED, n=4))["choices"]
    ranked = sorted(four, key=lambda c: -np.mean(
        c["logprobs"]["token_logprobs"]))
    body = {k: v for k, v in SEEDED.items() if k != "logprobs"}
    best = _port(servers, dict(body, n=2, best_of=4))
    assert [c["text"] for c in best["choices"]] == [
        c["text"] for c in ranked[:2]]
    assert [c["index"] for c in best["choices"]] == [0, 1]
    assert "logprobs" not in best["choices"][0]
    assert best["usage"]["completion_tokens"] == 24


def test_chat_candidates_draw_with_seed_plus_index(servers):
    body = {"messages": CHAT, "max_tokens": 5, "temperature": 0.9,
            "seed": 3}
    many = _port(servers, dict(body, n=2), "/v1/chat/completions")
    for i, choice in enumerate(many["choices"]):
        one = _port(servers, dict(body, seed=3 + i), "/v1/chat/completions")
        assert choice["message"] == one["choices"][0]["message"]


def test_a_refused_candidate_cancels_its_siblings(servers):
    """A submit refused mid fan-out (429 here) cancels the candidates
    already submitted and journals the refusal."""
    _, _, tserver = servers
    engine = tserver.engine
    submitted = []
    real = engine.submit

    def submit(req):
        if len(submitted) == 2:
            import queue
            raise queue.Full
        submitted.append(req)
        return real(req)

    engine.submit = submit
    try:
        status, headers, raw = port_post(servers[1] + "/v1/completions", {
            "prompt": "abc", "max_tokens": 30, "n": 4})
    finally:
        del engine.submit
    assert status == 429, raw
    assert len(submitted) == 2
    assert all(r.cancelled.is_set() for r in submitted)
    for r in submitted:
        assert r.done.wait(60)
    event = tserver.events.events(kind="admission_reject")[-1]
    assert event["trace_id"] == headers["x-lig-trace-id"]
    assert event["attrs"] == {"status": 429, "reason": "queue_full"}


@pytest.mark.parametrize("path,body", [
    ("/v1/completions", {"prompt": "hi"}),
    ("/v1/chat/completions", {"messages": [{"role": "user",
                                            "content": "hi"}]})],
    ids=["completions", "chat"])
def test_streams_deliver_a_chunk_per_token(servers, path, body):
    """The SSE contract at adaptive 8 (``tests/test_decode_levers.py``'s
    ``test_sse_emits_one_chunk_per_token``, held on the port): 12 streamed
    tokens arrive in at least 8 deltas, not in a block's burst."""
    _, _, tserver = servers
    engine = teng.Engine(TINY_TEST, tserver.engine.params, teng.EngineConfig(
        decode_slots=2, max_seq_len=64, prefill_buckets=(8, 16, 32),
        adaptive_steps=8), eos_id=None, dtype=torch.float32, device="cpu")
    engine.start()
    server = tapi.ModelServer(engine, ByteTokenizer(), "llama3-tiny")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), tapi.make_handler(server))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        status, _, raw = port_post(
            "http://127.0.0.1:%d" % httpd.server_address[1] + path,
            dict(body, max_tokens=12, stream=True))
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()
    assert status == 200
    chunks = sse(raw)
    assert chunks[-1]["usage"]["completion_tokens"] == 12
    assert len(chunks) >= 8, len(chunks)
