"""Speculative decoding in the torch port, held to the JAX package on the
CPU at f32 on ``TINY_TEST`` (same weights, crossed by the weight bridge).

- ``extend_step`` (lanes: f32, bf16 and int8) and ``extend_step_paged``
  against the JAX functions from the same primed cache: logits within
  1e-4 at f32, the written cells alike, and frozen rows writing nothing;
  the paged function also against the port's lane function over the same
  logical rows.
- The speculative engine (``speculative_k`` with a draft) against the JAX
  speculative engine: greedy tokens, ``spec_cycles`` and ``spec_emitted``
  exact, in the sync and pipelined loops, on lanes and on the paged pool,
  with int8 KV, grouped prefill, multi-step dispatch, a mixed-temperature
  batch, EOS inside a block and the perfect draft (the target's own
  params) — and against the port's plain engine's greedy tokens.  Every
  request is submitted before the loop starts, so admission is the same in
  both packages and the cycle counts are exact.
- Rows that must not speculate (a seeded sampled row, stop sequences,
  prompts streamed in chunks) and the config errors; the
  ``tpu:spec_*`` families and a speculative HTTP server.
"""

import dataclasses
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_instance_gateway_tpu.models import paged as jpg
from llm_instance_gateway_tpu.models import transformer as jtf
from llm_instance_gateway_tpu.models.configs import TINY_TEST as JAX_TINY
from llm_instance_gateway_tpu.server import engine as jeng
from llm_instance_gateway_tpu.server import metrics as jmetrics

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch.models import paged as tpg  # noqa: E402
from llm_instance_gateway_tpu_torch.models import transformer as ttf  # noqa: E402
from llm_instance_gateway_tpu_torch.models.configs import TINY_TEST  # noqa: E402
from llm_instance_gateway_tpu_torch.models.weights import (  # noqa: E402
    params_from_numpy,
    tensor_from_numpy,
)
from llm_instance_gateway_tpu_torch.server import api_http  # noqa: E402
from llm_instance_gateway_tpu_torch.server import engine as teng  # noqa: E402
from llm_instance_gateway_tpu_torch.server import metrics as tmetrics  # noqa: E402

LOGIT_TOL = 1e-4  # f32: summation order only


def _draft(cfg):
    """A smaller model sharing the target's vocabulary."""
    return dataclasses.replace(cfg, name="tiny-draft", d_model=32,
                               n_layers=1, n_heads=2, n_kv_heads=1, d_ff=64,
                               head_dim=16)


@pytest.fixture(scope="module")
def params():
    jp = jtf.init_params(JAX_TINY, jax.random.PRNGKey(0), jnp.float32)
    jd = jtf.init_params(_draft(JAX_TINY), jax.random.PRNGKey(7),
                         jnp.float32)
    return {"jax": (jp, jd),
            "port": tuple(params_from_numpy(jax.tree.map(np.asarray, t),
                                            "cpu") for t in (jp, jd))}


def _to_port(tree):
    return {k: tensor_from_numpy(np.asarray(v), "cpu")
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# extend_step / extend_step_paged
# ---------------------------------------------------------------------------


def _primed_lanes(jp, dtype, quantized, starts, s_max=32, seed=0):
    """A JAX lane cache with row b holding a prompt of ``starts[b]``
    tokens, and the same cache for the port."""
    rng = np.random.RandomState(seed)
    cache = jtf.init_decode_cache(JAX_TINY, len(starts), s_max, dtype=dtype,
                                  quantized=quantized)
    for row, n in enumerate(starts):
        prompt = jnp.asarray(rng.randint(1, 250, size=(1, n)), jnp.int32)
        _, k, v = jtf.prefill(JAX_TINY, jp, prompt, jnp.arange(n)[None])
        cache = jtf.insert_prefill(cache, k, v, row, n)
    return cache, _to_port(cache)


def _as_f32(x):
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
def test_extend_step_matches_jax(params, kv):
    """Logits and every cache cell after one extend_step over three rows,
    the middle one frozen: it writes nothing (its lane and scales stay as
    they were), in both packages."""
    dtype = jnp.bfloat16 if kv == "bf16" else jnp.float32
    jp = jax.tree.map(lambda a: a.astype(dtype), params["jax"][0])
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    starts = [5, 3, 7]
    jc, tc = _primed_lanes(jp, dtype, kv == "int8", starts)
    before = {k: v.clone() for k, v in tc.items()}
    rng = np.random.RandomState(1)
    c = 4
    tokens = rng.randint(1, 250, size=(3, c))
    positions = np.array([[s + i for i in range(c)] for s in starts])
    active = np.array([True, False, True])
    want, jc2 = jtf.extend_step(JAX_TINY, jp, jc, jnp.asarray(tokens),
                                jnp.asarray(positions),
                                active=jnp.asarray(active))
    got, tc2 = ttf.extend_step(TINY_TEST, tp, tc, torch.tensor(tokens),
                               torch.tensor(positions),
                               active=torch.tensor(active))
    # bf16: the two frameworks round activations at other places; 0.05 is
    # a few bf16 ulps of these logits and K/V cells (|x| up to ~4, where
    # an ulp is 2^-6).
    tol = 5e-2 if kv == "bf16" else LOGIT_TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=0)
    for name in tc:
        if name == "length":
            continue
        # the frozen row: bitwise unchanged
        assert torch.equal(tc2[name][:, 1], before[name][:, 1]), name
        cell_tol = {"bf16": 5e-2, "int8": 1}.get(kv, LOGIT_TOL)
        if name.endswith("_scale"):
            cell_tol = 1e-5
        np.testing.assert_allclose(_as_f32(tc2[name].float()),
                                   _as_f32(jc2[name]), atol=cell_tol, rtol=0)


def _primed_pool(jp, lane, starts, c, block=8, n_blocks=12, quantized=False):
    """A paged cache holding ``lane``'s rows (prefill + insert), tables
    covering each row's next ``c`` positions, in both packages."""
    b = len(starts)
    pool = jpg.init_paged_cache(JAX_TINY, b, lane["k"].shape[2], n_blocks,
                                block, dtype=jnp.float32, quantized=quantized)
    tables = np.zeros(pool["tables"].shape, np.int32)
    nxt = 1
    rng = np.random.RandomState(0)
    for row, n in enumerate(starts):
        prompt = jnp.asarray(rng.randint(1, 250, size=(1, n)), jnp.int32)
        _, k, v = jtf.prefill(JAX_TINY, jp, prompt, jnp.arange(n)[None])
        nb = -(-(n + c) // block)
        phys = list(range(nxt, nxt + nb))[::-1]  # not in logical order
        nxt += nb
        tables[row, :nb] = phys
        pool = jpg.insert_prefill_paged(
            dict(pool, tables=jnp.asarray(tables)), k, v, row,
            jnp.asarray(phys[:-(-n // block)], jnp.int32),
            jnp.asarray(tables[row]), n)
    return pool, _to_port(pool)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_extend_step_paged_matches_jax_and_lanes(params, quantized):
    """extend_step_paged against the JAX function (logits, pools), the
    frozen row writing only the trash block; and against the port's lane
    extend_step over the same logical rows."""
    jp, tp = params["jax"][0], params["port"][0]
    starts, c = [5, 7, 2], 3
    jlane, tlane = _primed_lanes(jp, jnp.float32, quantized, starts)
    jpool, tpool = _primed_pool(jp, jlane, starts, c, quantized=quantized)
    before = {k: v.clone() for k, v in tpool.items()}
    rng = np.random.RandomState(3)
    tokens = rng.randint(1, 250, size=(3, c))
    positions = np.array([[s + i for i in range(c)] for s in starts])
    active = np.array([True, True, False])
    want, jpool2 = jpg.extend_step_paged(
        JAX_TINY, jp, jpool, jnp.asarray(tokens), jnp.asarray(positions),
        active=jnp.asarray(active))
    got, tpool2 = tpg.extend_step_paged(
        TINY_TEST, tp, tpool, torch.tensor(tokens), torch.tensor(positions),
        active=torch.tensor(active))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_TOL, rtol=0)
    frozen = [int(b) for b in np.asarray(jpool["tables"])[2] if b]
    for name in ("k", "v") + (("k_scale", "v_scale") if quantized else ()):
        real = tpool2[name][:, 1:]  # the trash block holds garbage
        np.testing.assert_allclose(
            _as_f32(real.float()), _as_f32(jpool2[name][:, 1:]),
            atol=1 if name in ("k", "v") and quantized else 1e-5, rtol=0)
        for blk in frozen:
            assert torch.equal(tpool2[name][:, blk], before[name][:, blk])
    lane_logits, _ = ttf.extend_step(TINY_TEST, tp, tlane,
                                     torch.tensor(tokens),
                                     torch.tensor(positions),
                                     active=torch.tensor(active))
    np.testing.assert_allclose(got.numpy(), lane_logits.numpy(),
                               atol=LOGIT_TOL, rtol=0)


# ---------------------------------------------------------------------------
# the speculative engine
# ---------------------------------------------------------------------------

BASE = dict(decode_slots=3, max_seq_len=96, prefill_buckets=(8, 16))


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(1, 250, size=n)] for n in lengths]


def build(mod, params, spec_k=3, perfect=False, eos=None, lora=None,
          **extra):
    """An engine of ``mod`` (jeng or teng) over the shared weights: plain
    with ``spec_k`` 0, else speculative with the small draft or, with
    ``perfect``, the target's own params as the draft."""
    side = "jax" if mod is jeng else "port"
    target, small = params[side]
    cfg = mod.EngineConfig(**dict(BASE, speculative_k=spec_k, **extra))
    base_cfg = JAX_TINY if side == "jax" else TINY_TEST
    kw = {}
    if spec_k:
        kw = dict(draft_params=target if perfect else small,
                  draft_cfg=base_cfg if perfect else _draft(base_cfg))
    if side == "jax":
        return jeng.Engine(JAX_TINY, target, cfg, eos_id=eos,
                           dtype=jnp.float32, lora_manager=lora, **kw)
    return teng.Engine(TINY_TEST, target, cfg, eos_id=eos,
                       dtype=torch.float32, device="cpu", lora_manager=lora,
                       **kw)


def serve(mod, engine, prompts, max_new=12, temps=None, **req_kw):
    """Submit every prompt, then start the loop (one admission for all);
    returns the finished requests."""
    reqs = []
    for i, p in enumerate(prompts):
        t = 0.0 if temps is None else temps[i]
        reqs.append(mod.Request(prompt_tokens=list(p), max_new_tokens=max_new,
                                sampling=mod.SamplingParams(temperature=t),
                                **req_kw))
        engine.submit(reqs[-1])
    engine.start()
    try:
        for r in reqs:
            assert r.done.wait(180), "request timed out"
            assert r.error is None, r.error
    finally:
        engine.stop()
    return reqs


def tokens(reqs):
    return [list(r.output_tokens) for r in reqs]


def held_to_jax(params, prompts, max_new=12, temps=None, **kw):
    """The port's speculative engine against the JAX one (greedy rows'
    tokens, spec_cycles, spec_emitted) and against the port's plain
    engine; returns (port spec engine, its requests)."""
    je = build(jeng, params, **kw)
    want = serve(jeng, je, prompts, max_new, temps)
    te = build(teng, params, **kw)
    got = serve(teng, te, prompts, max_new, temps)
    greedy = [i for i in range(len(prompts))
              if temps is None or temps[i] <= 0.0]
    assert [tokens(got)[i] for i in greedy] == [tokens(want)[i]
                                                 for i in greedy]
    assert (te.spec_cycles, te.spec_emitted) == (je.spec_cycles,
                                                 je.spec_emitted)
    plain_kw = {k: v for k, v in kw.items() if k not in ("perfect",
                                                         "spec_k")}
    plain = tokens(serve(teng, build(teng, params, spec_k=0, **plain_kw),
                         prompts, max_new))
    assert [tokens(got)[i] for i in greedy] == [plain[i] for i in greedy]
    if kw.get("eos") is None:
        assert all(len(r.output_tokens) == max_new for r in got)
    return te, got


LOOPS = {
    "sync": {},
    "pipelined": dict(pipeline_decode=True),
    "paged-sync": dict(paged_kv_block=8),
    "paged-pipelined": dict(paged_kv_block=8, pipeline_decode=True,
                            decode_steps_per_sync=4),
    "multistep-sync": dict(spec_k=2, decode_steps_per_sync=8),
    "bench-shape": dict(decode_slots=4, pipeline_decode=True,
                        decode_steps_per_sync=8, prefill_batch=2),
    "int8-kv": dict(kv_cache_quant="int8"),
    "int8-kv-paged-pipelined": dict(kv_cache_quant="int8",
                                    paged_kv_block=8, pipeline_decode=True),
}


@pytest.mark.parametrize("loop", list(LOOPS))
def test_greedy_parity_with_small_draft(params, loop):
    te, _ = held_to_jax(params, _prompts(10, (5, 9, 14)), **LOOPS[loop])
    assert te.spec_cycles > 0 and te.spec_emitted > 0


def test_mixed_temperature_batch(params):
    """A sampled row beside greedy rows: the greedy rows keep parity, the
    sampled one gets its tokens (the two packages draw other noise), and
    the block runs one cycle per step (the mixed schedule)."""
    te, got = held_to_jax(params, _prompts(2, (6, 7, 8)),
                          temps=[0.0, 0.9, 0.0])
    assert len(got[1].output_tokens) == 12


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["sync", "pipelined"])
def test_perfect_draft_token_multiplier(params, pipelined):
    """Draft == target: every proposal is accepted, so the 15 tokens
    after the prefill's arrive in 4 cycles of K+1 = 4."""
    te, _ = held_to_jax(params, _prompts(1, (6,)), max_new=16, perfect=True,
                        decode_slots=1, pipeline_decode=pipelined)
    assert te.spec_emitted == 15
    assert 4 <= te.spec_cycles <= 6


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["sync", "pipelined"])
def test_eos_stops_inside_block(params, pipelined):
    """EOS accepted mid-cycle: the tokens after it are dropped and the row
    freezes, as in the JAX engine and the port's plain engine."""
    prompt = _prompts(14, (6,))
    ref = tokens(serve(teng, build(teng, params, spec_k=0, decode_slots=1),
                       prompt, 16))[0]
    eos = ref[6]
    te, got = held_to_jax(params, prompt, max_new=16, perfect=True,
                          decode_slots=1, eos=eos, pipeline_decode=pipelined)
    assert got[0].finish_reason == "stop"
    assert got[0].output_tokens == ref[:ref.index(eos) + 1]


def test_seeded_sampled_row_matches_plain_engine(params):
    """A seeded sampled row in a speculative engine draws its token from
    the verify's first position with the seeded noise of (seed, position):
    the port's plain engine's tokens."""
    prompts = _prompts(4, (5, 8))

    def run(spec_k):
        eng = build(teng, params, spec_k=spec_k)
        reqs = [teng.Request(prompt_tokens=p, max_new_tokens=10,
                             sampling=teng.SamplingParams(
                                 temperature=0.0 if i == 0 else 0.8,
                                 top_k=20, seed=None if i == 0 else 1234))
                for i, p in enumerate(prompts)]
        return tokens(serve_reqs(eng, reqs)), eng

    plain, _ = run(0)
    spec, eng = run(3)
    assert spec == plain
    assert eng.spec_cycles > 0


def serve_reqs(engine, reqs):
    for r in reqs:
        engine.submit(r)
    engine.start()
    try:
        for r in reqs:
            assert r.done.wait(180) and r.error is None, r.error
    finally:
        engine.stop()
    return reqs


def test_rows_that_do_not_speculate(params):
    """Stop-sequence rows and prompts beyond the largest bucket (chunk
    streams) never speculate: a batch of only such rows runs plain blocks
    (no spec cycle), with the plain engine's tokens."""
    long_prompt = _prompts(5, (40,))[0]
    stop_prompt = _prompts(6, (5,))[0]
    plain = build(teng, params, spec_k=0)
    ref = tokens(serve_reqs(plain, [
        teng.Request(prompt_tokens=long_prompt, max_new_tokens=8),
        teng.Request(prompt_tokens=stop_prompt, max_new_tokens=8)]))
    eng = build(teng, params)
    stop = tuple(ref[1][3:5])
    cut = next(j for j in range(1, 5) if tuple(ref[1][j - 1:j + 1]) == stop)
    got = serve_reqs(eng, [
        teng.Request(prompt_tokens=long_prompt, max_new_tokens=8),
        teng.Request(prompt_tokens=stop_prompt, max_new_tokens=8,
                     stop_sequences=(stop,))])
    assert tokens(got)[0] == ref[0]
    assert tokens(got)[1] == ref[1][:cut + 1]
    assert eng.spec_cycles == 0
    assert not eng._slot_spec_ok.any()


def test_logprobs_recorded_through_spec_path(params):
    eng = build(teng, params, spec_k=2, decode_slots=1)
    r = teng.Request(prompt_tokens=_prompts(3, (6,))[0], max_new_tokens=8,
                     logprobs=2)
    serve_reqs(eng, [r])
    assert eng.spec_cycles > 0
    assert len(r.output_logprobs) == 8
    assert len(r.output_top_logprobs) == 8
    assert all(len(d) == 2 for d in r.output_top_logprobs)


def test_adapter_rows_keep_parity(params):
    """LoRA rows speculate with a draft that has no adapter: the verify
    holds the target's (adapter) greedy tokens, equal to the JAX engine's
    and the plain engine's."""
    from llm_instance_gateway_tpu.models.lora import target_dims
    from llm_instance_gateway_tpu.server.lora_manager import LoRAManager as JL
    from llm_instance_gateway_tpu_torch.server.lora_manager import (
        LoRAManager as TL,
    )

    dims = target_dims(JAX_TINY)
    rng = np.random.RandomState(7)
    weights = {t: {"a": rng.randn(JAX_TINY.n_layers, dims[t][0], 4) * 0.3,
                   "b": rng.randn(JAX_TINY.n_layers, 4, dims[t][1]) * 0.3}
               for t in ("q", "v")}

    def run(mod, manager, spec_k):
        manager.load("ad", weights=weights, alpha=8.0, rank=4)
        eng = build(mod, params, spec_k=spec_k, lora=manager)
        reqs = [mod.Request(prompt_tokens=p, max_new_tokens=10,
                            adapter=a) for p, a in
                zip(_prompts(8, (5, 9, 6)), ("ad", None, "ad"))]
        serve_reqs(eng, reqs)
        return tokens(reqs), eng

    want, je = run(jeng, JL(JAX_TINY, dtype=jnp.float32), 3)
    got, te = run(teng, TL(TINY_TEST, dtype=torch.float32, device="cpu"), 3)
    plain, _ = run(teng, TL(TINY_TEST, dtype=torch.float32, device="cpu"), 0)
    assert got == want == plain
    assert (te.spec_cycles, te.spec_emitted) == (je.spec_cycles,
                                                 je.spec_emitted)


def test_config_errors(params):
    with pytest.raises(ValueError, match="draft_params"):
        teng.Engine(TINY_TEST, params["port"][0],
                    teng.EngineConfig(speculative_k=2), device="cpu")
    with pytest.raises(ValueError, match="token space"):
        teng.Engine(TINY_TEST, params["port"][0],
                    teng.EngineConfig(speculative_k=2), device="cpu",
                    draft_params=params["port"][0],
                    draft_cfg=dataclasses.replace(TINY_TEST,
                                                  vocab_size=640))


def test_spec_families_render_as_the_reference(params):
    """``tpu:spec_cycles`` and ``tpu:spec_tokens_per_cycle``: the port's
    exposition lines equal the reference's for the same engine state."""
    prompts = _prompts(10, (5, 9))
    lines = []
    for mod, render in ((jeng, jmetrics.render), (teng, tmetrics.render)):
        eng = build(mod, params)
        serve(mod, eng, prompts)
        text = render(eng.metrics_snapshot())
        lines.append([ln for ln in text.splitlines() if "tpu:spec_" in ln])
    assert lines[0] == lines[1]
    assert lines[1][0] == "# TYPE tpu:spec_cycles counter"
    assert len(lines[1]) == 4


def test_spec_block_profiler_ranges(params):
    """The eager spec block runs its draft and its verify inside profiler
    ranges (``spec_draft``, ``spec_verify``), once a cycle each, so a
    trace of the block splits a cycle's time between them."""
    from torch.profiler import ProfilerActivity, profile

    eng = build(teng, params)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng._spec_block(2, 3, False)
    names = [ev.name for ev in prof.events()]
    assert names.count("spec_draft") == 2
    assert names.count("spec_verify") == 2


def test_speculative_http_server():
    """``--speculative 3 --draft-model llama3-tiny`` on the CPU: completions
    answer, and /metrics carries the spec families."""
    httpd, engine, _ = api_http.make_server([
        "--device", "cpu", "--dtype", "float32", "--model", "llama3-tiny",
        "--host", "127.0.0.1", "--port", "0", "--max-seq-len", "96",
        "--decode-slots", "2", "--speculative", "3", "--draft-model",
        "llama3-tiny"])
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = "http://127.0.0.1:%d" % httpd.server_address[1]
    try:
        req = urllib.request.Request(
            url + "/v1/completions",
            data=json.dumps({"prompt": "speculate", "max_tokens": 9,
                             "temperature": 0}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as f:
            body = json.loads(f.read())
        assert body["usage"]["completion_tokens"] == 9
        with urllib.request.urlopen(url + "/metrics", timeout=60) as f:
            text = f.read().decode()
        assert engine.spec_cycles > 0
        assert f"tpu:spec_cycles {engine.spec_cycles}" in text
        assert "tpu:spec_tokens_per_cycle " in text
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()
    with pytest.raises(SystemExit):
        api_http.make_server(["--device", "cpu", "--speculative", "2"])
