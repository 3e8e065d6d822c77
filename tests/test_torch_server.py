"""The torch port's HTTP surface on the CPU (stdlib ``ThreadingHTTPServer``).

One in-process server at ``llama3-tiny`` (f32, random weights, ``--device
cpu``): completions as JSON and SSE, stop strings, the admin adapter
endpoints with an ``.npz`` adapter, /v1/models, /metrics, /health, and the
400s for parameters out of the reference's ranges or combinations it
refuses.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch.models import lora  # noqa: E402
from llm_instance_gateway_tpu_torch.models.configs import TINY_TEST  # noqa: E402
from llm_instance_gateway_tpu_torch.server import api_http  # noqa: E402
from llm_instance_gateway_tpu_torch.server.lora_manager import (  # noqa: E402
    load_adapter_checkpoint,
    save_adapter,
)


@pytest.fixture(scope="module")
def server():
    httpd, engine, _ = api_http.make_server([
        "--device", "cpu", "--dtype", "float32", "--host", "127.0.0.1",
        "--port", "0", "--max-seq-len", "128", "--decode-slots", "4"])
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield "http://127.0.0.1:%d" % httpd.server_address[1], engine
    httpd.shutdown()
    httpd.server_close()
    engine.stop()


def post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as f:
            return f.status, f.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def get(url):
    with urllib.request.urlopen(url, timeout=60) as f:
        return f.status, f.read().decode()


def sse_chunks(text):
    lines = [ln[6:] for ln in text.splitlines() if ln.startswith("data: ")]
    assert lines[-1] == "[DONE]"
    return [json.loads(ln) for ln in lines[:-1]]


def test_completion_json(server):
    url, _ = server
    status, text = post(url + "/v1/completions",
                        {"prompt": "hello", "max_tokens": 5})
    assert status == 200
    body = json.loads(text)
    assert body["object"] == "text_completion"
    assert body["usage"] == {"prompt_tokens": 6, "completion_tokens": 5,
                             "total_tokens": 11}
    assert body["choices"][0]["finish_reason"] == "length"


def test_greedy_is_deterministic_and_stream_matches(server):
    url, _ = server
    body = {"prompt": "abc", "max_tokens": 7, "temperature": 0.0}
    _, a = post(url + "/v1/completions", body)
    _, b = post(url + "/v1/completions", body)
    assert json.loads(a)["choices"] == json.loads(b)["choices"]
    status, text = post(url + "/v1/completions", {**body, "stream": True})
    assert status == 200
    chunks = sse_chunks(text)
    assert "".join(c["choices"][0]["text"] for c in chunks) == \
        json.loads(a)["choices"][0]["text"]
    assert chunks[-1]["choices"][0]["finish_reason"] == "length"
    assert chunks[-1]["usage"]["completion_tokens"] == 7


def test_seed_reproduces(server):
    url, _ = server
    body = {"prompt": "xyz", "max_tokens": 6, "temperature": 1.0, "seed": 42}
    _, a = post(url + "/v1/completions", body)
    _, b = post(url + "/v1/completions", body)
    assert json.loads(a)["choices"] == json.loads(b)["choices"]


def test_stop_string_truncates(server):
    url, _ = server
    body = {"prompt": "q", "max_tokens": 16}
    _, full = post(url + "/v1/completions", body)
    text = json.loads(full)["choices"][0]["text"]
    clean = [c for c in text[1:] if c.isascii()]
    assert clean, text  # random bytes: ~40% of ids are ASCII
    stop = clean[0]
    status, cut = post(url + "/v1/completions", {**body, "stop": stop})
    assert status == 200
    choice = json.loads(cut)["choices"][0]
    assert choice["text"] == text[:text.index(stop)]
    assert choice["finish_reason"] == "stop"
    _, streamed = post(url + "/v1/completions",
                       {**body, "stop": [stop], "stream": True})
    chunks = sse_chunks(streamed)
    assert "".join(c["choices"][0]["text"] for c in chunks) == choice["text"]
    assert chunks[-1]["choices"][0]["finish_reason"] == "stop"


@pytest.mark.parametrize("extra", [
    {"logprobs": 6}, {"n": 9}, {"echo": True, "logprobs": 1},
    {"presence_penalty": 2.5}, {"logit_bias": {"5": 101.0}}, {"stop": 3}])
def test_unserved_parameters_are_400(server, extra):
    """Parameters out of the reference's ranges (``logprobs`` > 5, ``n`` >
    8, penalties, biases), and ``echo`` together with ``logprobs``; in
    range they are served (``test_penalties_are_served``,
    ``tests/test_torch_surface.py``)."""
    url, _ = server
    status, text = post(url + "/v1/completions",
                        {"prompt": "hi", "max_tokens": 2, **extra})
    assert status == 400
    assert "error" in json.loads(text)


def test_penalties_are_served(server):
    """Presence / frequency penalties and ``logit_bias`` answer 200; a
    +100 bias forces its token at every step."""
    url, _ = server
    status, text = post(url + "/v1/completions", {
        "prompt": "hi", "max_tokens": 6, "presence_penalty": 0.5,
        "frequency_penalty": 1.0, "logit_bias": {"65": 100}})
    assert status == 200, text
    assert json.loads(text)["choices"][0]["text"] == "A" * 6


def test_errors(server):
    url, _ = server
    assert post(url + "/v1/completions",
                {"prompt": "hi", "model": "unknown"})[0] == 404
    assert post(url + "/v1/completions", {"prompt": "x" * 500})[0] == 400
    assert post(url + "/v1/nothing", {})[0] == 404


def test_adapter_lifecycle(server, tmp_path):
    url, engine = server
    rng = np.random.default_rng(0)
    weights = {t: {"a": rng.standard_normal((2, di, 4)).astype(np.float32),
                   "b": rng.standard_normal((2, 4, do)).astype(np.float32)}
               for t, (di, do) in lora.target_dims(TINY_TEST).items()}
    path = str(tmp_path / "tenant.npz")
    save_adapter(path, weights, alpha=8.0, rank=4)
    w2, alpha, rank = load_adapter_checkpoint(path)
    assert (alpha, rank) == (8.0, 4)
    np.testing.assert_array_equal(w2["q"]["a"], weights["q"]["a"])

    assert post(url + "/v1/load_lora_adapter",
                {"lora_name": "tenant", "lora_path": path})[0] == 200
    _, models = get(url + "/v1/models")
    assert [m["id"] for m in json.loads(models)["data"]] == [
        "llama3-tiny", "tenant"]
    base = json.loads(post(url + "/v1/completions",
                           {"prompt": "hey", "max_tokens": 6})[1])
    tuned = json.loads(post(url + "/v1/completions",
                            {"prompt": "hey", "max_tokens": 6,
                             "model": "tenant"})[1])
    assert tuned["model"] == "tenant"
    assert tuned["choices"] != base["choices"]  # the delta is applied
    _, metrics = get(url + "/metrics")
    assert 'adapter_ranks="tenant:4"' in metrics
    assert post(url + "/v1/unload_lora_adapter",
                {"lora_name": "tenant"})[0] == 200
    assert post(url + "/v1/unload_lora_adapter",
                {"lora_name": "tenant"})[0] == 404
    assert post(url + "/v1/load_lora_adapter", {"lora_name": "x"})[0] == 400
    assert post(url + "/v1/load_lora_adapter",
                {"lora_name": "llama3-tiny", "lora_path": path})[0] == 409


def test_metrics_and_health(server):
    url, _ = server
    assert get(url + "/health") == (200, "ok")
    _, text = get(url + "/metrics")
    for family in ("tpu:num_requests_running", "tpu:num_requests_waiting",
                   "tpu:kv_cache_usage_perc", "tpu:lora_requests_info",
                   "tpu:prefill_queue_size", "tpu:decode_step_seconds_bucket",
                   'tpu:pool_role{role="collocated"} 1'):
        assert family in text


def test_cli_defaults_mirror_the_reference():
    args = api_http.build_parser().parse_args([])
    assert (args.device, args.decode_slots, args.max_seq_len,
            args.adaptive_steps, args.max_loras) == ("cuda", 8, 1024, 8, 4)
    assert (args.role, args.handoff_ttl_s) == ("collocated", 60.0)


@pytest.mark.parametrize("role", ["prefill", "decode"])
def test_two_hop_roles_start_and_advertise(role):
    """A pod started as a prefill or decode replica serves, and shows its
    role in ``tpu:pool_role`` (the gateway's two-stage routing reads it);
    /v1/models answers the reference's payload, without a role; the
    handoff TTL reaches the engine."""
    httpd, engine, _ = api_http.make_server([
        "--device", "cpu", "--dtype", "float32", "--host", "127.0.0.1",
        "--port", "0", "--max-seq-len", "128", "--role", role,
        "--handoff-ttl-s", "7.5"])
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = "http://127.0.0.1:%d" % httpd.server_address[1]
    try:
        assert (engine.cfg.role, engine.cfg.handoff_ttl_s) == (role, 7.5)
        _, text = get(url + "/metrics")
        assert f'tpu:pool_role{{role="{role}"}} 1' in text
        assert json.loads(get(url + "/v1/models")[1]) == {
            "object": "list", "data": [{"id": "llama3-tiny",
                                        "object": "model",
                                        "root": "llama3-tiny"}]}
        status, _ = post(url + "/v1/completions",
                         {"prompt": "hi", "max_tokens": 2})
        assert status == 200
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()
