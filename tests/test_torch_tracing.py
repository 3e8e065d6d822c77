"""Tracing, the flight recorder and the /debug endpoints of the torch port
on the CPU, held to the JAX package's.

- Trace ids are adopted or minted and echoed on every answer, errors
  included; ``x-lig-spans`` parses with the reference's ``parse_wire``;
  the hops carry the id (the handoff's own field when the header is gone).
- The port's ``Tracer``, ``EventJournal`` and ``StepProfiler`` give the
  reference's payloads for the same sequence of records.
- The engine's four event sites fire: drain, release, the handoff TTL
  sweep (admission stepped by hand, ``t_parked`` back-dated) and LRU
  prefix eviction.
- ``/debug/profile`` shares sum to 1.0, ``/debug/usage`` conserves the
  adapters' step seconds against the engine's.
- End to end: the unchanged gateway fronts a torch pod; its
  ``/debug/traces`` holds the pod's engine spans, and a refusal sits in
  the pod's ``/debug/events`` under the request's trace id.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from llm_instance_gateway_tpu import events as jevents
from llm_instance_gateway_tpu import tracing as jtracing
from llm_instance_gateway_tpu.server import profiler as jprofiler

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch import events as tevents  # noqa: E402
from llm_instance_gateway_tpu_torch import tracing as ttracing  # noqa: E402
from llm_instance_gateway_tpu_torch.models import lora as tlora  # noqa: E402
from llm_instance_gateway_tpu_torch.models import transformer  # noqa: E402
from llm_instance_gateway_tpu_torch.models.configs import TINY_TEST  # noqa: E402
from llm_instance_gateway_tpu_torch.server import api_http  # noqa: E402
from llm_instance_gateway_tpu_torch.server import engine as teng  # noqa: E402
from llm_instance_gateway_tpu_torch.server import kv_transfer as tkv  # noqa: E402
from llm_instance_gateway_tpu_torch.server import profiler as tprofiler  # noqa: E402
from llm_instance_gateway_tpu_torch.server.lora_manager import (  # noqa: E402
    LoRAManager,
)
from llm_instance_gateway_tpu_torch.server.tokenizer import ByteTokenizer  # noqa: E402

CFG = TINY_TEST
BASE = dict(decode_slots=2, max_seq_len=64, prefill_buckets=(8, 16, 32))
KV_SHAPE = (CFG.n_layers, 1, 32, CFG.n_kv_heads, CFG.resolved_head_dim)
HEX16 = set("0123456789abcdef")


@pytest.fixture(scope="module")
def params():
    return transformer.init_params(CFG, seed=0, dtype=torch.float32,
                                   device="cpu")


@pytest.fixture(scope="module")
def served(params):
    """A port server with an adapter loaded: (url, ModelServer)."""
    manager = LoRAManager(CFG, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(3)
    manager.load("tenant", weights={
        t: {"a": rng.standard_normal((CFG.n_layers, di, 2)) * 0.3,
            "b": rng.standard_normal((CFG.n_layers, 2, do)) * 0.3}
        for t, (di, do) in tlora.target_dims(CFG).items()},
        alpha=4.0, rank=2)
    engine = teng.Engine(CFG, params, teng.EngineConfig(**BASE),
                         lora_manager=manager, eos_id=None,
                         dtype=torch.float32, device="cpu")
    engine.start()
    server = api_http.ModelServer(engine, ByteTokenizer(), "llama3-tiny",
                                  manager)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                api_http.make_handler(server))
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield "http://127.0.0.1:%d" % httpd.server_address[1], server
    httpd.shutdown()
    httpd.server_close()
    engine.stop()


def post(url, body=None, raw=None, headers=None):
    data = raw if raw is not None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as f:
            return f.status, dict(f.headers), f.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as f:
            return f.status, json.loads(f.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


BODY = {"prompt": "trace me", "max_tokens": 5}


# -- trace ids and spans -----------------------------------------------------


@pytest.mark.parametrize("path,body", [
    ("/v1/completions", BODY),
    ("/v1/chat/completions", {"messages": [{"role": "user",
                                            "content": "hi"}],
                              "max_tokens": 3}),
    ("/v1/completions", dict(BODY, stream=True)),
    ("/v1/prefill/release", {"request_id": "nope"}),
    ("/v1/completions", {"prompt": "x", "n": 9}),
    ("/v1/completions", {"prompt": "x", "model": "nope"}),
    ("/v1/chat/completions", {"messages": [], "top_logprobs": 1}),
    ("/v1/prefill", {"prompt": "x", "n": 2}),
    ("/v1/prefill/release", {"id": 1})],
    ids=["completions", "chat", "stream", "release", "400", "404",
         "chat-400", "prefill-422", "release-400"])
@pytest.mark.parametrize("given", [True, False], ids=["adopted", "minted"])
def test_trace_id_is_echoed(served, path, body, given):
    url, _ = served
    headers = {"x-lig-trace-id": "feedc0de00000001"} if given else {}
    status, hdrs, raw = post(url + path, body, headers=headers)
    tid = hdrs["x-lig-trace-id"]
    if given:
        assert tid == "feedc0de00000001"
    else:
        assert len(tid) == 16 and set(tid) <= HEX16
    if status >= 400:
        assert json.loads(raw)["error"]["trace_id"] == tid


def test_spans_header_parses_and_lies_inside_the_request(served):
    url, server = served
    t0 = time.time()
    status, hdrs, raw = post(url + "/v1/completions", BODY)
    t1 = time.time()
    assert status == 200
    spans = jtracing.parse_wire(hdrs["x-lig-spans"])
    assert [s[0] for s in spans] == ["engine.queue_wait", "engine.prefill",
                                     "engine.decode"]
    for _, s, e in spans:
        assert t0 - 1e-3 <= s <= e <= t1 + 1e-3
    # The prefill span and the reported TTFT tell the same story.
    ttft = json.loads(raw)["ttft_ms"] / 1e3
    assert spans[1][2] - spans[0][1] == pytest.approx(ttft, abs=2e-3)
    trace = server.tracer.get(hdrs["x-lig-trace-id"])
    assert trace["model"] == "llama3-tiny" and trace["status"] == "length"
    assert [s["name"] for s in trace["spans"]] == [s[0] for s in spans]


def test_debug_traces_endpoint(served):
    url, _ = served
    _, hdrs, _ = post(url + "/v1/completions", BODY)
    tid = hdrs["x-lig-trace-id"]
    status, payload = get(url + f"/debug/traces?trace_id={tid}")
    assert status == 200 and payload.keys() == {"traces", "seq"}
    (trace,) = payload["traces"]
    assert trace.keys() == {"trace_id", "model", "path", "status", "seq",
                            "t_created", "spans"}
    assert trace["t_created"] == trace["spans"][0]["start"]
    _, page = get(url + f"/debug/traces?since={trace['seq'] - 1}")
    assert page.keys() == {"traces", "seq", "next_since"}
    assert [t["trace_id"] for t in page["traces"]] == [tid]
    _, none = get(url + "/debug/traces?trace_id=nope")
    assert none["traces"] == []


def test_streams_record_their_spans_at_the_end(served):
    url, server = served
    _, hdrs, raw = post(url + "/v1/completions", dict(BODY, stream=True))
    assert b"[DONE]" in raw and "x-lig-spans" not in hdrs
    tid = hdrs["x-lig-trace-id"]
    deadline = time.monotonic() + 10
    while server.tracer.get(tid) is None and time.monotonic() < deadline:
        time.sleep(0.01)  # the generator's finally runs after the last write
    names = [s["name"] for s in server.tracer.get(tid)["spans"]]
    assert names == ["engine.queue_wait", "engine.prefill", "engine.decode"]


def test_hops_carry_the_trace_id(served):
    """The prefill hop adds ``handoff.serialize`` and writes the id into
    the handoff; an attach with no header takes it from there and adds
    ``handoff.deserialize`` / ``handoff.attach`` before the decode."""
    url, server = served
    tid = "0123456789abcdef"
    status, hdrs, wire = post(url + "/v1/prefill", BODY,
                              headers={"x-lig-trace-id": tid})
    assert status == 200 and hdrs["x-lig-trace-id"] == tid
    assert [s[0] for s in jtracing.parse_wire(hdrs["x-lig-spans"])] == [
        "engine.queue_wait", "engine.prefill", "handoff.serialize"]
    assert float(hdrs["x-handoff-serialize-ms"]) >= 0
    assert tkv.PrefillHandoff.from_bytes(bytearray(wire)).trace_id == tid
    status, hdrs, raw = post(url + "/v1/attach", raw=wire)
    assert status == 200, raw
    assert hdrs["x-lig-trace-id"] == tid
    assert [s[0] for s in jtracing.parse_wire(hdrs["x-lig-spans"])] == [
        "handoff.deserialize", "handoff.attach", "engine.decode"]
    assert float(hdrs["x-handoff-attach-ms"]) >= 0
    assert {s["name"] for s in server.tracer.get(tid)["spans"]} >= {
        "handoff.serialize", "handoff.attach", "engine.decode"}
    # A header wins over the handoff's id; a malformed handoff echoes it.
    _, wire2 = post(url + "/v1/prefill", BODY)[1:]
    status, hdrs, _ = post(url + "/v1/attach", raw=wire2,
                           headers={"x-lig-trace-id": "aaaa"})
    assert (status, hdrs["x-lig-trace-id"]) == (200, "aaaa")
    status, hdrs, raw = post(url + "/v1/attach", raw=b"LIGKVH1\nxx",
                             headers={"x-lig-trace-id": "bbbb"})
    assert status == 400
    assert json.loads(raw)["error"]["trace_id"] == "bbbb" == \
        hdrs["x-lig-trace-id"]


def _records(tracer):
    """One fixed sequence of records and annotations."""
    tracer.record("t1", "engine.queue_wait", 10.0, 10.5)
    tracer.record("t2", "engine.prefill", 11.0, 11.25, tag="x")
    tracer.annotate("t1", model="m", status="ok")
    tracer.record("t1", "engine.decode", 10.5, 12.0)
    tracer.annotate("t2", model="m", path="/v1/completions")
    tracer.record("t3", "handoff.attach", 9.0, 9.125)


@pytest.mark.parametrize("query", [
    {}, {"trace_id": "t1"}, {"trace_id": "t9"}, {"since": "2"},
    {"since": "0", "limit": "1"}, {"since": "bad"}, {"limit": "2"},
    {"limit": "bad"}])
def test_tracer_payloads_equal_the_reference(query):
    ref, port = jtracing.Tracer(capacity=4), ttracing.Tracer(capacity=4)
    _records(ref)
    _records(port)
    assert ttracing.debug_traces_payload(port, query) == \
        jtracing.debug_traces_payload(ref, query)
    assert ttracing.wire_spans([("a", 1.0, 2.5)]) == \
        jtracing.wire_spans([("a", 1.0, 2.5)])


def test_event_journals_equal_the_reference():
    clock = iter(range(100, 200)).__next__
    clock2 = iter(range(100, 200)).__next__
    ref = jevents.EventJournal(capacity=3, clock=clock)
    port = tevents.EventJournal(capacity=3, clock=clock2)
    for journal in (ref, port):
        assert journal.render_prom("tpu:events_total") == [
            "# TYPE tpu:events_total counter", "tpu:events_total 0"]
        journal.emit(jevents.ADMISSION_REJECT, "t1", status=429,
                     reason="queue_full")
        journal.emit(jevents.ROLE_CHANGE, role="decode", draining=True)
        journal.emit(jevents.KV_RELEASE, request_id="r1", reason="ttl")
        journal.emit(jevents.KV_EVICT, n=3)
        journal.emit(jevents.KV_EVICT, n=1)
    assert (tevents.ADMISSION_REJECT, tevents.ROLE_CHANGE,
            tevents.KV_RELEASE, tevents.KV_EVICT) == (
        jevents.ADMISSION_REJECT, jevents.ROLE_CHANGE, jevents.KV_RELEASE,
        jevents.KV_EVICT)
    assert (port.seq, port.counts, port.events(limit=10)) == (
        ref.seq, ref.counts, ref.events(limit=10))
    assert port.render_prom("tpu:events_total") == \
        ref.render_prom("tpu:events_total")
    for query in ({}, {"since": "3"}, {"kind": "kv_evict"}, {"limit": "1"},
                  {"since": "x", "limit": "y"}):
        assert tevents.debug_events_payload(port, query) == \
            jevents.debug_events_payload(ref, query)


def test_step_profilers_equal_the_reference():
    ref = jprofiler.StepProfiler(capacity=4)
    port = tprofiler.StepProfiler(capacity=4)
    for prof in (ref, port):
        prof.note_dispatch("prefill", None, 0.02, active=1, total_slots=4,
                           n_steps=17)
        prof.note_dispatch("decode", 1.0, 0.01, active=2, total_slots=4,
                           n_steps=8)
        prof.note_idle()
        prof.note_dispatch("decode", 1.5, 0.01, active=1, total_slots=4,
                           n_steps=4)
        prof.note_padding(7)
        prof.note_dispatch("spec", 1.52, 0.03, active=3, total_slots=4,
                           n_steps=10)
        prof.note_dispatch("decode", 1.6, 0.01, active=3, total_slots=4)
    assert port.snapshot() == ref.snapshot()
    assert tprofiler.render_profile(port.hist_state()) == \
        jprofiler.render_profile(ref.hist_state())


# -- the engine's event sites ------------------------------------------------


def _engine(params, **overrides):
    eng = teng.Engine(CFG, params, teng.EngineConfig(**dict(BASE,
                                                            **overrides)),
                      eos_id=None, dtype=torch.float32, device="cpu")
    journal = tevents.EventJournal()
    eng.event_sink = journal.emit
    return eng, journal


def _step(engine) -> None:
    """One admission pass of the sync loop, on the caller's thread."""
    with torch.no_grad():
        engine._admit_and_insert(pipelined=False)


def test_drain_journals_a_role_change(params):
    eng, journal = _engine(params, role="decode")
    assert eng.drain(timeout_s=5.0) is True  # nothing in flight
    (event,) = journal.events()
    assert (event["kind"], event["attrs"]) == (
        "role_change", {"role": "decode", "draining": True})


def test_release_journals_a_kv_release(params):
    eng, journal = _engine(params)
    req = eng.submit(teng.Request(prompt_tokens=[1, 2, 3], max_new_tokens=4))
    assert eng.release_request(req.request_id) is True
    assert eng.release_request("nope") is False
    (event,) = journal.events()
    assert (event["kind"], event["attrs"]) == (
        "kv_release", {"request_id": req.request_id})


def test_ttl_sweep_journals_a_kv_release(params):
    """An import parked past ``handoff_ttl_s`` is swept with reason
    "ttl"; the clock moves by back-dating ``t_parked``."""
    eng, journal = _engine(params, paged_kv_block=8, handoff_ttl_s=5.0)
    for i in range(eng.cfg.decode_slots):
        eng.submit(teng.Request(prompt_tokens=[1, 2, 3 + i],
                                max_new_tokens=40))
    _step(eng)
    zeros = torch.zeros(KV_SHAPE)
    req = eng.attach_prefilled(tkv.export_handoff(
        teng.Request(prompt_tokens=list(range(3, 20)), max_new_tokens=8),
        zeros, zeros, n=17, first_token=1))
    _step(eng)
    assert [w.request for w in eng.decode_wait] == [req]
    _step(eng)
    assert journal.events(kind="kv_release") == []
    eng.decode_wait[0].t_parked -= 10.0
    _step(eng)
    assert req.finish_reason == "cancelled"
    (event,) = journal.events(kind="kv_release")
    assert event["attrs"] == {"request_id": req.request_id, "reason": "ttl"}


def test_prefix_eviction_journals_one_kv_evict_per_sync(params):
    """A pool of 10 eight-token blocks with the prefix cache: distinct
    17-token prompts leave two cached blocks each, so the fifth evicts."""
    eng, journal = _engine(params, paged_kv_block=8, paged_kv_blocks=10,
                           prefix_cache=True)
    eng.start()
    try:
        for i in range(6):
            req = eng.generate(teng.Request(
                prompt_tokens=[10 + i] * 17, max_new_tokens=3))
            assert req.error is None
        eng.metrics_snapshot()  # a scrape syncs the ledger too
    finally:
        eng.stop()
    evicts = journal.events(kind="kv_evict")
    assert evicts and all(e["attrs"]["n"] >= 1 for e in evicts)
    evicted = sum(e["attrs"]["n"] for e in evicts)
    assert evicted == sum(1 for e in eng.kv_ledger._ring
                          if e["kind"] == "evict")


# -- the /debug endpoints and /metrics ----------------------------------------


def test_debug_profile_shares_sum_to_one(served):
    url, _ = served
    for body in (BODY, dict(BODY, model="tenant")):
        assert post(url + "/v1/completions", body)[0] == 200
    status, payload = get(url + "/debug/profile")
    assert status == 200
    assert payload.keys() == {"model", "role", "capacity", "seq",
                              "padding_tokens", "attribution", "hist",
                              "records"}
    shares = payload["attribution"]["shares"]
    assert sum(shares.values()) == pytest.approx(1.0, abs=1e-9)
    assert shares["dispatch"] > 0
    rec = payload["records"][-1]
    assert {"seq", "phase", "wall_s", "gap_s", "active", "slots", "n_steps",
            "slot_churn"} <= rec.keys()
    assert rec["slots"] == BASE["decode_slots"]


def test_debug_profile_is_404_when_off(params):
    eng = teng.Engine(CFG, params, teng.EngineConfig(**dict(
        BASE, step_profile=False)), eos_id=None, dtype=torch.float32,
        device="cpu")
    server = api_http.ModelServer(eng, ByteTokenizer(), "m")
    with pytest.raises(api_http.HTTPError) as e:
        server.debug_profile({})
    assert e.value.status == 404


def test_debug_usage_conserves_step_seconds(served):
    url, _ = served
    for body in (BODY, dict(BODY, model="tenant"), BODY):
        assert post(url + "/v1/completions", body)[0] == 200
    status, payload = get(url + "/debug/usage")
    assert status == 200
    assert payload.keys() == {"model", "role", "running_lora_adapters",
                              "waiting_lora_adapters", "residency", "usage"}
    assert payload["residency"] == {"slot": ["tenant"], "host": []}
    usage = payload["usage"]
    adapters = {key.split("|")[0] for key in usage["step_seconds"]}
    assert {"tenant", "base"} <= adapters
    for phase, total in usage["engine_step_seconds"].items():
        charged = sum(v for key, v in usage["step_seconds"].items()
                      if key.endswith("|" + phase))
        assert charged == pytest.approx(total, rel=0.01), phase


def test_debug_events_and_events_total(served):
    url, server = served
    status, hdrs, _ = post(url + "/v1/prefill", {"prompt": "x", "echo": True})
    assert status == 422
    status, payload = get(url + "/debug/events?kind=admission_reject")
    assert status == 200 and payload.keys() == {"seq", "next_since",
                                                "events"}
    event = payload["events"][-1]
    assert event["trace_id"] == hdrs["x-lig-trace-id"]
    assert event["attrs"] == {"status": 422, "reason": "prefill_unsupported"}
    with urllib.request.urlopen(url + "/metrics", timeout=60) as f:
        text = f.read().decode()
    n = server.events.counts["admission_reject"]
    assert f'tpu:events_total{{kind="admission_reject"}} {n}' in text


# -- end to end behind the unchanged gateway ---------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


POOL_YAML = """\
kind: InferencePool
metadata: {{name: trace-pool, resourceVersion: "1"}}
spec: {{selector: {{app: trace-pool}}, targetPortNumber: {port}}}
---
kind: InferenceModel
metadata: {{name: llama3-tiny}}
spec: {{modelName: llama3-tiny, criticality: Critical, poolRef: {{name: trace-pool}}}}
"""


@pytest.mark.e2e
def test_gateway_merges_the_pods_spans_and_the_pod_journals_refusals(
        tmp_path):
    from tests.test_e2e_local import (
        _launch_module,
        _teardown_procs,
        _wait_http,
    )

    pod_port, gw_port = _free_port(), _free_port()
    pod = f"http://127.0.0.1:{pod_port}"
    gw = f"http://127.0.0.1:{gw_port}"
    config = tmp_path / "pool.yaml"
    config.write_text(POOL_YAML.format(port=pod_port))
    procs = []
    try:
        procs.append(_launch_module(
            ["llm_instance_gateway_tpu_torch.server.api_http", "--model",
             "llama3-tiny", "--device", "cpu", "--dtype", "float32",
             "--decode-slots", "2", "--max-seq-len", "128", "--host",
             "127.0.0.1", "--port", str(pod_port)], tmp_path / "pod.log",
            cwd=str(tmp_path)))
        procs.append(_launch_module(
            ["llm_instance_gateway_tpu.gateway.proxy", "--config",
             str(config), "--port", str(gw_port), "--pod",
             f"pod1=127.0.0.1:{pod_port}"], tmp_path / "gw.log",
            cwd=str(tmp_path)))
        _wait_http(pod + "/health", 120)
        _wait_http(gw + "/healthz", 120)
        time.sleep(2.0)  # one provider pod-refresh cycle
        status, hdrs, raw = post(gw + "/v1/chat/completions", {
            "model": "llama3-tiny", "max_tokens": 6, "logprobs": True,
            "top_logprobs": 2,
            "messages": [{"role": "user", "content": "hello"}]})
        assert status == 200, raw
        body = json.loads(raw)
        assert body["object"] == "chat.completion"
        assert len(body["choices"][0]["logprobs"]["content"]) == 6
        tid = hdrs["x-lig-trace-id"]
        _, traces = get(gw + f"/debug/traces?trace_id={tid}")
        names = {s["name"] for t in traces["traces"] for s in t["spans"]}
        assert {"engine.queue_wait", "engine.prefill",
                "engine.decode"} <= names, names
        _, pod_traces = get(pod + f"/debug/traces?trace_id={tid}")
        assert len(pod_traces["traces"]) == 1

        status, hdrs, _ = post(pod + "/v1/prefill",
                               {"prompt": "x", "n": 2},
                               headers={"x-lig-trace-id": "cafe0000beef0001"})
        assert status == 422
        _, events = get(pod + "/debug/events?kind=admission_reject")
        assert [e["trace_id"] for e in events["events"]] == [
            "cafe0000beef0001"]
        with urllib.request.urlopen(pod + "/metrics", timeout=60) as f:
            assert 'tpu:events_total{kind="admission_reject"} 1' in \
                f.read().decode()
    finally:
        _teardown_procs(procs)
