"""Presence / frequency penalties and ``logit_bias`` in the torch port, held
to the JAX engine on the CPU at f32 on ``TINY_TEST``.

The cases are those of ``tests/test_penalties.py``, each with the port's
greedy tokens equal to the JAX engine's token for token (same weights,
crossed by the weight bridge): the penalized decode block subtracts before
the argmax and counts generated tokens only (the prefill's first token
included, the prompt not).  Then the HTTP surface: the three parameters
answer 200 on ``/v1/completions`` and out-of-range values 400 with the
reference's texts; a penalized request through ``/v1/prefill`` ->
``/v1/attach`` equals collocated serving.
"""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_instance_gateway_tpu.models import transformer as jtf
from llm_instance_gateway_tpu.models.configs import TINY_TEST as JAX_TINY
from llm_instance_gateway_tpu.server import engine as jeng

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch.models import transformer as ttf  # noqa: E402
from llm_instance_gateway_tpu_torch.models.configs import TINY_TEST  # noqa: E402
from llm_instance_gateway_tpu_torch.models.weights import params_from_numpy  # noqa: E402
from llm_instance_gateway_tpu_torch.server import api_http  # noqa: E402
from llm_instance_gateway_tpu_torch.server import engine as teng  # noqa: E402

BASE = dict(decode_slots=3, max_seq_len=96, prefill_buckets=(8, 16))


@pytest.fixture(scope="module")
def params():
    jparams = jtf.init_params(JAX_TINY, jax.random.PRNGKey(0), jnp.float32)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def engines(params, **extra):
    """(JAX engine, port engine) over the same weights and config."""
    cfg = dict(BASE, **extra)
    return (jeng.Engine(JAX_TINY, params[0], jeng.EngineConfig(**cfg),
                        eos_id=None, dtype=jnp.float32),
            teng.Engine(TINY_TEST, params[1], teng.EngineConfig(**cfg),
                        eos_id=None, dtype=torch.float32, device="cpu"))


def run(mod, engine, jobs):
    """Serve ``jobs`` (dicts of SamplingParams fields, plus ``max_new`` and
    ``prompt``) one at a time; returns each one's tokens."""
    out = []
    engine.start()
    try:
        for job in jobs:
            job = dict(job)
            req = mod.Request(prompt_tokens=list(job.pop("prompt", (5, 6, 7))),
                              max_new_tokens=job.pop("max_new", 24),
                              sampling=mod.SamplingParams(**job))
            engine.generate(req, timeout_s=120)
            assert req.error is None, req.error
            out.append(list(req.output_tokens))
    finally:
        engine.stop()
    return out


def both(params, jobs, **extra):
    """The JAX engine's and the port's tokens for ``jobs``: equal."""
    je, te = engines(params, **extra)
    want, got = run(jeng, je, jobs), run(teng, te, jobs)
    assert got == want
    return got


def max_run(toks):
    best = cur = 1
    for a, b in zip(toks, toks[1:]):
        cur = cur + 1 if a == b else 1
        best = max(best, cur)
    return best


class TestPenalties:
    def test_large_presence_penalty_forbids_repeats(self, params):
        plain, pen = both(params, [{}, {"presence_penalty": 2.0}])
        assert pen != plain
        assert (max_run(pen) < max(max_run(plain), 2)
                or len(set(pen)) > len(set(plain)))

    def test_frequency_accumulates_per_occurrence(self, params):
        none, some = both(params, [{"max_new": 32},
                                   {"frequency_penalty": 1.5, "max_new": 32}])
        assert len(set(some)) > len(set(none))

    def test_zero_penalties_bitwise_unchanged(self, params):
        """Penalty-free rows run the plain block and never allocate the
        counts."""
        je, te = engines(params)
        a, b = run(teng, te, [{}, {}])
        assert a == b == run(jeng, je, [{}])[0]
        assert "counts" not in te._dev

    @pytest.mark.parametrize("paged", [False, True], ids=["lanes", "paged"])
    def test_pipelined_matches_sync(self, params, paged):
        extra = dict(paged_kv_block=8) if paged else {}
        job = [{"presence_penalty": 1.2, "frequency_penalty": 0.6}]
        sync = both(params, job, **extra)
        pipe = both(params, job, pipeline_decode=True,
                    decode_steps_per_sync=4, **extra)
        assert pipe == sync

    def test_counts_reset_on_slot_reuse(self, params):
        first, second = both(params, [{"presence_penalty": 2.0}] * 2,
                             decode_slots=1)
        assert second == first

    def test_spec_engine_rejects_penalties(self, params):
        dcfg = dataclasses.replace(
            TINY_TEST, name="pen-draft", d_model=32, n_layers=1, n_heads=2,
            n_kv_heads=1, d_ff=64, head_dim=16)
        spec = teng.Engine(
            TINY_TEST, params[1],
            teng.EngineConfig(decode_slots=2, max_seq_len=64,
                              prefill_buckets=(8,), speculative_k=2),
            eos_id=None, dtype=torch.float32, device="cpu",
            draft_params=ttf.init_params(dcfg, seed=7, dtype=torch.float32,
                                         device="cpu"),
            draft_cfg=dcfg)
        for sp in (teng.SamplingParams(presence_penalty=1.0),
                   teng.SamplingParams(frequency_penalty=0.5),
                   teng.SamplingParams(logit_bias={5: 1.0})):
            with pytest.raises(ValueError, match="penalties and logit_bias"):
                spec.submit(teng.Request(prompt_tokens=[5, 6],
                                         max_new_tokens=4, sampling=sp))


class TestLogitBias:
    def test_forced_and_banned_tokens(self, params):
        plain, forced = both(params, [{"max_new": 6},
                                      {"max_new": 6,
                                       "logit_bias": {99: 100.0}}])
        assert forced == [99] * 6
        banned = both(params, [{"max_new": 6,
                                "logit_bias": {plain[0]: -100.0}}])[0]
        assert banned[0] != plain[0]

    def test_bias_cap_rejected_at_submit(self, params):
        _, te = engines(params)
        with pytest.raises(ValueError, match="at most"):
            te.submit(teng.Request(
                prompt_tokens=[5], max_new_tokens=2,
                sampling=teng.SamplingParams(
                    logit_bias={i: 1.0
                                for i in range(teng.MAX_LOGIT_BIAS + 1)})))


def test_penalties_beside_unpenalized_rows(params):
    """Penalized, biased and plain rows in one batch, sync and pipelined,
    lanes and paged: each row's tokens are the JAX engine's."""
    jobs = [{"presence_penalty": 1.5, "frequency_penalty": 0.7,
             "logit_bias": {99: 100.0, 7: -100.0}}, {},
            {"frequency_penalty": 0.7, "prompt": (9, 10, 11, 12)},
            {"logit_bias": {40: 5.0}, "prompt": (3, 4)}]
    for extra in ({}, dict(pipeline_decode=True, decode_steps_per_sync=4),
                  dict(paged_kv_block=8, decode_steps_per_sync=2)):
        je, te = engines(params, decode_slots=4, **extra)
        want, got = [concurrent(mod, e, jobs)
                     for mod, e in ((jeng, je), (teng, te))]
        assert got == want, extra


def concurrent(mod, engine, jobs):
    """Submit every job before the loop starts (one admission for all);
    returns the tokens."""
    reqs = []
    for job in jobs:
        job = dict(job)
        reqs.append(mod.Request(
            prompt_tokens=list(job.pop("prompt", (5, 6, 7))),
            max_new_tokens=job.pop("max_new", 16),
            sampling=mod.SamplingParams(**job)))
        engine.submit(reqs[-1])
    engine.start()
    try:
        for r in reqs:
            assert r.done.wait(120) and r.error is None, r.error
    finally:
        engine.stop()
    return [list(r.output_tokens) for r in reqs]


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------


def _post(url, body=None, raw=None):
    data = raw if raw is not None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": ("application/octet-stream" if raw is not None
                         else "application/json")})
    try:
        with urllib.request.urlopen(req, timeout=120) as f:
            return f.status, f.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture(scope="module")
def servers(params):
    """A collocated (prefill-role) server and a decode-role one over the
    same weights, and a speculative one."""
    common = ["--model", "llama3-tiny", "--device", "cpu", "--dtype",
              "float32", "--host", "127.0.0.1", "--port", "0",
              "--decode-slots", "2", "--max-seq-len", "96"]
    made = [api_http.make_server(common + ["--role", "prefill"],
                                 params=params[1]),
            api_http.make_server(common + ["--role", "decode",
                                           "--paged-kv-block", "16"],
                                 params=params[1]),
            api_http.make_server(common + ["--speculative", "2",
                                           "--draft-model", "llama3-tiny"],
                                 params=params[1])]
    urls = []
    for httpd, _, _ in made:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        urls.append("http://127.0.0.1:%d" % httpd.server_address[1])
    yield urls
    for httpd, engine, _ in made:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()


PENALIZED = {"prompt": [5, 6, 7], "max_tokens": 12, "temperature": 0,
             "presence_penalty": 1.5, "frequency_penalty": 0.7,
             "logit_bias": {"99": 3.0, "7": -100}}


def test_http_serves_the_three_parameters(servers, params):
    """200 on /v1/completions, with the JAX engine's tokens (the byte
    tokenizer drops ids >= 256 from the text, so the text is compared with
    the decode of the JAX tokens)."""
    from llm_instance_gateway_tpu_torch.server.tokenizer import ByteTokenizer

    status, text = _post(servers[0] + "/v1/completions", PENALIZED)
    assert status == 200, text
    body = json.loads(text)
    assert body["usage"]["completion_tokens"] == 12
    want = run(jeng, engines(params, decode_slots=2)[0], [{
        "prompt": (5, 6, 7), "max_new": 12, "presence_penalty": 1.5,
        "frequency_penalty": 0.7, "logit_bias": {99: 3.0, 7: -100.0}}])[0]
    assert body["choices"][0]["text"] == ByteTokenizer().decode(want)


@pytest.mark.parametrize("extra,message", [
    ({"presence_penalty": 2.5}, "presence_penalty must be in [-2, 2]"),
    ({"frequency_penalty": -3}, "frequency_penalty must be in [-2, 2]"),
    ({"logit_bias": [1, 2]}, "logit_bias must be an object"),
    ({"logit_bias": {"5": 101}}, "logit_bias values must be in [-100, 100]"),
    ({"logit_bias": {str(i): 1 for i in range(33)}},
     "logit_bias supports at most 32 entries"),
    ({"logit_bias": {"x": 1}}, "invalid literal")],
    ids=["presence", "frequency", "bias-type", "bias-value", "bias-cap",
         "bias-id"])
def test_http_out_of_range_is_400(servers, extra, message):
    for path in ("/v1/completions", "/v1/prefill"):
        status, text = _post(servers[0] + path,
                             {"prompt": "hi", "max_tokens": 2, **extra})
        assert status == 400, text
        assert message in json.loads(text)["error"]["message"]


def test_http_speculative_server_refuses_penalties(servers):
    status, text = _post(servers[2] + "/v1/completions", PENALIZED)
    assert status == 400
    assert ("presence/frequency penalties and logit_bias are not supported "
            "on a speculative engine") in json.loads(text)["error"]["message"]
    status, _ = _post(servers[2] + "/v1/completions",
                      {"prompt": [5, 6, 7], "max_tokens": 4})
    assert status == 200


def test_two_hops_equal_collocated(servers):
    """A penalized request through /v1/prefill -> /v1/attach: the decode
    hop counts the carried first token (``_count_first_token`` on
    attach), so its tokens equal collocated serving's."""
    pre, dec, _ = servers
    status, coll = _post(pre + "/v1/completions", PENALIZED)
    assert status == 200
    status, wire = _post(pre + "/v1/prefill", PENALIZED)
    assert status == 200, wire
    status, body = _post(dec + "/v1/attach", raw=wire)
    assert status == 200, body
    assert (json.loads(body)["choices"] == json.loads(coll)["choices"])
