"""``LIG_FAULTS`` fault injection on a torch pod, held to the JAX package's.

- The port's schedule (``llm_instance_gateway_tpu_torch/faultinject.py``)
  against the reference's ``gateway/faultinject.FaultSchedule``: the same
  JSON schedules give the same ``to_dict``, ``describe()``, ``remaining``
  and ``active()`` over a grid of times from one injected clock; an
  unknown kind raises in both.
- Each HTTP kind on a tiny CPU torch server armed through ``LIG_FAULTS``:
  the statuses, a brownout's delay, a blackhole's 503 once its window has
  elapsed, a ``handoff_failure`` answer or disconnect on both hop routes,
  an SSE stream cut by ``midstream_disconnect``, and ``/metrics``,
  ``/health`` and ``/debug/*`` untouched.
- The ``fault_inject`` rows of ``/debug/events`` against the rows the JAX
  ``ModelServer`` (its ``build_app`` through aiohttp's test client, no
  engine: every fault is journaled before a handler runs) writes for the
  same schedule and requests.
"""

import asyncio
import contextlib
import http.client
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import pytest
from aiohttp.test_utils import TestClient, TestServer

from llm_instance_gateway_tpu.gateway import faultinject as jfi
from llm_instance_gateway_tpu.server import api_http as japi
from llm_instance_gateway_tpu.server.tokenizer import ByteTokenizer as JBytes

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch import faultinject as tfi  # noqa: E402
from llm_instance_gateway_tpu_torch.models import transformer  # noqa: E402
from llm_instance_gateway_tpu_torch.models.configs import TINY_TEST  # noqa: E402
from llm_instance_gateway_tpu_torch.server import api_http as tapi  # noqa: E402
from llm_instance_gateway_tpu_torch.server import engine as teng  # noqa: E402
from llm_instance_gateway_tpu_torch.server.tokenizer import ByteTokenizer  # noqa: E402

SCHEDULES = [
    {"seed": 3, "faults": [
        {"kind": "error", "start_s": 1.0, "duration_s": 2.0,
         "params": {"status": 429}},
        {"kind": "brownout", "pod": "pod-a", "start_s": 2.5,
         "params": {"delay_s": 0.5}},
        {"kind": "handoff_failure", "start_s": 0.0, "duration_s": 4.0,
         "params": {"mode": "disconnect"}}]},
    {"faults": [
        {"kind": "blackhole", "pod": "pod-b", "duration_s": 1.5},
        {"kind": "midstream_disconnect", "start_s": 0.5,
         "params": {"after_s": 0.1, "paths": ["/v1/chat/completions"]}},
        {"kind": "scrape_flap", "pod": "pod-a", "start_s": 3.0,
         "duration_s": 0.25}]},
    {"seed": 9, "faults": []},
]
PODS = ("", "pod-a", "pod-b")
PATHS = (None, "/v1/completions", "/v1/chat/completions", "/v1/prefill",
         "/v1/attach", "/v1/models")
KINDS = (None,) + tfi.FAULT_KINDS


class Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def _spec(f):
    return None if f is None else f.to_dict()


@pytest.mark.parametrize("index", range(len(SCHEDULES)))
def test_schedule_matches_reference(index):
    d = SCHEDULES[index]
    clock = Clock()
    port = tfi.FaultSchedule.from_dict(d, clock=clock)
    ref = jfi.FaultSchedule.from_dict(d, clock=clock)
    assert port.to_dict() == ref.to_dict()
    assert port.describe() == ref.describe()
    port.arm()
    ref.arm()
    for t in (100.0, 100.4, 100.5, 101.0, 102.0, 102.5, 102.9, 103.0,
              103.1, 103.25, 104.0, 1e9 + 99.0, 1e9 + 101.0):
        clock.t = t
        assert port.elapsed() == ref.elapsed()
        for pod in PODS:
            for path in PATHS:
                for kind in KINDS:
                    got = port.active(pod=pod, path=path, kind=kind)
                    want = ref.active(pod=pod, path=path, kind=kind)
                    assert _spec(got) == _spec(want), (t, pod, path, kind)
                    if got is not None:
                        assert port.remaining(got) == ref.remaining(want)
    clock.t = 200.0
    a = port.inject_now("error", duration_s=5.0, status=503)
    b = ref.inject_now("error", duration_s=5.0, status=503)
    assert a.to_dict() == b.to_dict()
    assert port.to_dict() == ref.to_dict()
    assert port.describe() == ref.describe()


def test_unknown_kind_raises_in_both():
    bad = {"faults": [{"kind": "meteor"}]}
    for mod in (tfi, jfi):
        with pytest.raises(ValueError, match="unknown fault kind 'meteor'"):
            mod.FaultSchedule.from_dict(bad)
    assert tfi.FaultSchedule.from_dict({}).describe() == "empty"


def test_from_file(tmp_path):
    path = tmp_path / "faults.json"
    path.write_text(json.dumps(SCHEDULES[0]))
    assert (tfi.FaultSchedule.from_file(str(path)).to_dict()
            == jfi.FaultSchedule.from_file(str(path)).to_dict())


# ---------------------------------------------------------------------------
# A tiny CPU torch server under LIG_FAULTS
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model_server():
    params = transformer.init_params(TINY_TEST, seed=0, dtype=torch.float32,
                                     device="cpu")
    engine = teng.Engine(
        TINY_TEST, params,
        teng.EngineConfig(decode_slots=2, max_seq_len=160,
                          prefill_buckets=(16, 32),
                          decode_steps_per_sync=1),
        eos_id=None, dtype=torch.float32, device="cpu")
    engine.start()
    yield tapi.ModelServer(engine, ByteTokenizer(), "llama3-tiny")
    engine.stop()


@contextlib.contextmanager
def armed(model_server, monkeypatch, tmp_path, schedule):
    """A server over ``model_server`` whose handler armed ``schedule``
    from ``LIG_FAULTS``; yields (host, port)."""
    path = tmp_path / f"faults-{time.monotonic_ns()}.json"
    path.write_text(json.dumps(schedule))
    monkeypatch.setenv("LIG_FAULTS", str(path))
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                tapi.make_handler(model_server))
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        yield httpd.server_address
    finally:
        httpd.shutdown()
        httpd.server_close()


def request(addr, method, path, body=None, timeout=60):
    """(status, body bytes, seconds), or (None, the error, seconds) when
    the connection was cut."""
    conn = http.client.HTTPConnection(*addr, timeout=timeout)
    data = None if body is None else json.dumps(body).encode()
    t0 = time.perf_counter()
    try:
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read()
        return resp.status, raw, time.perf_counter() - t0
    except (http.client.HTTPException, ConnectionError) as e:
        return None, e, time.perf_counter() - t0
    finally:
        conn.close()


def fault_rows(addr):
    status, raw, _ = request(addr, "GET", "/debug/events?kind=fault_inject")
    assert status == 200
    return [(e["kind"], e["attrs"]) for e in json.loads(raw)["events"]]


COMPLETION = {"prompt": "hi", "max_tokens": 2}


def test_error_status_scope(model_server, monkeypatch, tmp_path):
    sched = {"faults": [{"kind": "error", "params": {"status": 429}}]}
    with armed(model_server, monkeypatch, tmp_path, sched) as addr:
        for path in ("/v1/completions", "/v1/chat/completions"):
            status, raw, _ = request(addr, "POST", path, COMPLETION)
            assert (status, raw) == (429, b"injected fault")
        # Outside the kind's paths and outside /v1/: served.
        for path in ("/v1/models", "/metrics", "/health", "/debug/usage",
                     "/debug/traces"):
            status, _, _ = request(addr, "GET", path)
            assert status == 200, path
        rows = fault_rows(addr)
    assert rows[-2:] == [
        ("fault_inject", {"fault": "error", "path": p, "pod": ""})
        for p in ("/v1/completions", "/v1/chat/completions")]


def test_error_default_status_and_paths_param(model_server, monkeypatch,
                                              tmp_path):
    sched = {"faults": [{"kind": "error",
                         "params": {"paths": ["/v1/models", "/metrics"]}}]}
    with armed(model_server, monkeypatch, tmp_path, sched) as addr:
        assert request(addr, "GET", "/v1/models")[0] == 500
        # /metrics is listed but lies outside /v1/: never touched.
        assert request(addr, "GET", "/metrics")[0] == 200
        status, raw, _ = request(addr, "POST", "/v1/completions", COMPLETION)
        assert status == 200 and json.loads(raw)["choices"]


def test_error_window_closes(model_server, monkeypatch, tmp_path):
    sched = {"faults": [{"kind": "error", "duration_s": 0.3,
                         "params": {"status": 502}}]}
    with armed(model_server, monkeypatch, tmp_path, sched) as addr:
        assert request(addr, "POST", "/v1/completions", COMPLETION)[0] == 502
        time.sleep(0.35)
        assert request(addr, "POST", "/v1/completions", COMPLETION)[0] == 200


def test_brownout_delays_then_serves(model_server, monkeypatch, tmp_path):
    sched = {"faults": [{"kind": "brownout", "params": {"delay_s": 0.4}}]}
    with armed(model_server, monkeypatch, tmp_path, sched) as addr:
        status, raw, secs = request(addr, "POST", "/v1/completions",
                                    COMPLETION)
        assert status == 200 and json.loads(raw)["choices"]
        assert secs >= 0.4
        assert request(addr, "GET", "/metrics")[2] < 0.4


def test_blackhole_answers_503_after_its_window(model_server, monkeypatch,
                                                tmp_path):
    sched = {"faults": [{"kind": "blackhole", "duration_s": 0.2}]}
    with armed(model_server, monkeypatch, tmp_path, sched) as addr:
        status, raw, secs = request(addr, "POST", "/v1/completions",
                                    COMPLETION)
        # Hangs min(30, remaining + 1) s: just under 1.2 s here.
        assert (status, raw) == (503, b"blackhole fault elapsed")
        assert 0.9 <= secs < 5.0
        # The window is over: served.
        assert request(addr, "POST", "/v1/completions", COMPLETION)[0] == 200


@pytest.mark.parametrize("path", ["/v1/prefill", "/v1/attach"])
def test_handoff_failure_error(model_server, monkeypatch, tmp_path, path):
    sched = {"faults": [{"kind": "handoff_failure",
                         "params": {"status": 503}}]}
    with armed(model_server, monkeypatch, tmp_path, sched) as addr:
        status, raw, _ = request(addr, "POST", path, {"prompt": "hi"})
        assert (status, raw) == (503, b"injected handoff fault")
        # The completion routes are outside the kind's scope.
        assert request(addr, "POST", "/v1/completions", COMPLETION)[0] == 200
        assert fault_rows(addr)[-1] == (
            "fault_inject",
            {"fault": "handoff_failure", "path": path, "pod": ""})


@pytest.mark.parametrize("path", ["/v1/prefill", "/v1/attach"])
def test_handoff_failure_disconnect(model_server, monkeypatch, tmp_path,
                                    path):
    sched = {"faults": [{"kind": "handoff_failure",
                         "params": {"mode": "disconnect"}}]}
    with armed(model_server, monkeypatch, tmp_path, sched) as addr:
        status, err, _ = request(addr, "POST", path, {"prompt": "hi"})
        assert status is None, (status, err)
        # The server lives on.
        assert request(addr, "GET", "/health")[0] == 200


def test_midstream_disconnect_cuts_the_stream(model_server, monkeypatch,
                                              tmp_path):
    sched = {"faults": [{"kind": "midstream_disconnect",
                         "params": {"after_s": 0.05}}]}
    body = {"prompt": "x", "max_tokens": 150, "stream": True,
            "ignore_eos": True}
    with armed(model_server, monkeypatch, tmp_path, sched) as addr:
        status, raw, secs = request(addr, "POST", "/v1/completions", body)
        if status is not None:  # headers arrived, then the socket closed
            assert status == 200 and b"[DONE]" not in raw
        assert fault_rows(addr)[-1] == (
            "fault_inject",
            {"fault": "midstream_disconnect", "path": "/v1/completions"})
        # Unscoped routes stream to the end.
        conn = http.client.HTTPConnection(*addr, timeout=60)
        conn.request("GET", "/health")
        assert conn.getresponse().status == 200
        conn.close()


# ---------------------------------------------------------------------------
# The journal against the JAX server's
# ---------------------------------------------------------------------------

JOURNAL_SCHEDULE = {"faults": [
    {"kind": "error", "params": {"status": 418}},
    {"kind": "handoff_failure", "params": {"status": 502}},
    {"kind": "midstream_disconnect",
     "params": {"after_s": 5.0, "paths": ["/v1/chat/completions"]}},
    {"kind": "brownout", "params": {"delay_s": 0.01,
                                    "paths": ["/v1/models"]}},
    {"kind": "scrape_flap", "pod": "pod-a",
     "params": {"paths": ["/v1/unload_lora_adapter"]}},
]}
JOURNAL_REQUESTS = [
    ("POST", "/v1/completions", COMPLETION),
    ("POST", "/v1/prefill", {"prompt": "hi"}),
    ("POST", "/v1/attach", {"prompt": "hi"}),
    ("POST", "/v1/chat/completions",
     {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 2}),
    ("GET", "/v1/models", None),
    ("POST", "/v1/unload_lora_adapter", {"lora_name": "none"}),
    ("GET", "/metrics", None),
    ("GET", "/health", None),
]


def jax_rows(monkeypatch, tmp_path):
    path = tmp_path / "jax-faults.json"
    path.write_text(json.dumps(JOURNAL_SCHEDULE))
    monkeypatch.setenv("LIG_FAULTS", str(path))
    server = japi.ModelServer(None, JBytes(), "llama3-tiny")

    async def run():
        client = TestClient(TestServer(server.build_app()))
        await client.start_server()
        try:
            for method, p, body in JOURNAL_REQUESTS:
                try:
                    if method == "GET":
                        resp = await client.get(p)
                    else:
                        resp = await client.post(p, json=body)
                    await resp.read()
                except Exception:  # a handler with no engine may fail
                    pass
        finally:
            await client.close()

    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(run())
    finally:
        loop.close()
    return [(e["kind"], e["attrs"])
            for e in server.events.events(kind="fault_inject")]


def test_journal_rows_match_reference(model_server, monkeypatch, tmp_path):
    want = jax_rows(monkeypatch, tmp_path)
    with armed(model_server, monkeypatch, tmp_path,
               JOURNAL_SCHEDULE) as addr:
        since = json.loads(request(
            addr, "GET", "/debug/events?kind=fault_inject")[1])["events"]
        seq = since[-1]["seq"] if since else 0
        for method, p, body in JOURNAL_REQUESTS:
            request(addr, method, p, body)
        status, raw, _ = request(
            addr, "GET", f"/debug/events?kind=fault_inject&since={seq}")
    got = [(e["kind"], e["attrs"]) for e in json.loads(raw)["events"]]
    assert len(want) == 6
    assert got == want


def test_armed_server_logs_the_schedule(model_server, monkeypatch, tmp_path,
                                        caplog):
    sched = {"faults": [{"kind": "error", "start_s": 2.0,
                         "duration_s": 3.0}]}
    with caplog.at_level("WARNING", logger=tapi.logger.name):
        with armed(model_server, monkeypatch, tmp_path, sched):
            pass
    assert "error(pod=*, t=[2,5))" in caplog.text


def test_unarmed_server_is_untouched(model_server, monkeypatch):
    monkeypatch.delenv("LIG_FAULTS", raising=False)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                tapi.make_handler(model_server))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        url = "http://%s:%d" % httpd.server_address
        req = urllib.request.Request(
            url + "/v1/completions", data=json.dumps(COMPLETION).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as f:
            assert f.status == 200
    except urllib.error.HTTPError as e:  # pragma: no cover - diagnostics
        raise AssertionError(e.read()) from e
    finally:
        httpd.shutdown()
        httpd.server_close()
