"""Grouped prefill and pipelined dispatch in the torch port, held to the
JAX engine on the CPU at f32 on ``TINY_TEST``.

``prefill_batch`` and ``pipeline_decode`` change HOW prompts admit and how
decode blocks are dispatched, never WHAT a request generates: every greedy
stream below equals the JAX engine's token for token (its sync,
one-at-a-time engine is the reference), on lanes, on the paged pool with
the prefix cache and chunk streams, and with int8 KV.  The cases mirror the
reference's ``tests/test_prefill_batch.py`` and the pipelined cases of
``tests/test_engine.py``.  On the CPU the decode block runs eagerly on the
same fixed-address device buffers its CUDA graph replays on the card.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_instance_gateway_tpu.models import transformer as jtf
from llm_instance_gateway_tpu.models.configs import TINY_TEST as JAX_TINY
from llm_instance_gateway_tpu.models.lora import target_dims
from llm_instance_gateway_tpu.server import engine as jeng
from llm_instance_gateway_tpu.server.lora_manager import LoRAManager as JLoRA

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch.models.configs import TINY_TEST  # noqa: E402
from llm_instance_gateway_tpu_torch.models.weights import params_from_numpy  # noqa: E402
from llm_instance_gateway_tpu_torch.server import api_http  # noqa: E402
from llm_instance_gateway_tpu_torch.server import engine as teng  # noqa: E402
from llm_instance_gateway_tpu_torch.server.lora_manager import (  # noqa: E402
    LoRAManager as TLoRA,
)

# Mixed lengths: 4 land in the 16-bucket, 2 in the 32-bucket.
PROMPTS = [[5, 6, 7], [8, 9, 10, 11], [12, 13], [3, 4, 5, 6, 7],
           list(range(1, 20)), list(range(30, 55))]
LANES = dict(decode_slots=8, max_seq_len=128, prefill_buckets=(16, 32, 64),
             decode_steps_per_sync=4)
PAGED = dict(LANES, paged_kv_block=16)
MODES = [(1, False), (1, True), (4, False), (4, True)]
MODE_IDS = ["single-sync", "single-pipelined", "grouped-sync",
            "grouped-pipelined"]
PIPE = pytest.mark.parametrize("pipeline", [False, True],
                               ids=["sync", "pipelined"])


@pytest.fixture(scope="module")
def params():
    jparams = jtf.init_params(JAX_TINY, jax.random.PRNGKey(0), jnp.float32)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _adapter_weights():
    dims = target_dims(JAX_TINY)
    rng = np.random.RandomState(7)
    return {t: {"a": rng.randn(JAX_TINY.n_layers, dims[t][0], 4) * 0.05,
                "b": rng.randn(JAX_TINY.n_layers, 4, dims[t][1]) * 0.05}
            for t in ("q", "v")}


def port_engine(params, lora=False, eos=None, **cfg):
    tl = None
    if lora:
        tl = TLoRA(TINY_TEST, dtype=torch.float32, device="cpu")
        tl.load("ad-x", weights=_adapter_weights(), alpha=8.0, rank=4)
    return teng.Engine(TINY_TEST, params[1], teng.EngineConfig(**cfg),
                       lora_manager=tl, eos_id=eos, dtype=torch.float32,
                       device="cpu")


def jax_engine(params, lora=False, eos=None, **cfg):
    jl = None
    if lora:
        jl = JLoRA(JAX_TINY, dtype=jnp.float32)
        jl.load("ad-x", weights=_adapter_weights(), alpha=8.0, rank=4)
    return jeng.Engine(JAX_TINY, params[0], jeng.EngineConfig(**cfg),
                       lora_manager=jl, eos_id=eos, dtype=jnp.float32)


def requests(mod, jobs):
    """``jobs``: (prompt, max_new, adapter) or a dict of Request fields."""
    out = []
    for job in jobs:
        if isinstance(job, dict):
            out.append(mod.Request(**job))
        else:
            p, m, a = job
            out.append(mod.Request(prompt_tokens=list(p), max_new_tokens=m,
                                   adapter=a))
    return out


def serve(mod, engine, jobs, warm=()):
    """Run ``warm`` one by one, then submit ``jobs`` at once; returns the
    jobs' requests."""
    engine.start()
    try:
        for r in requests(mod, warm):
            engine.generate(r, timeout_s=180)
            assert r.error is None, r.error
        reqs = requests(mod, jobs)
        for r in reqs:
            engine.submit(r)
        for r in reqs:
            assert r.done.wait(180), "request timed out"
            assert r.error is None, r.error
        return reqs
    finally:
        engine.stop()


def tokens(reqs):
    return [list(r.output_tokens) for r in reqs]


def count_calls(engine, *names):
    """Wrap engine methods to count their calls (the paths really taken)."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(engine, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        setattr(engine, name, counted)
    return calls


_REF: dict[str, list] = {}


def reference(key, params, jobs, warm=(), lora=False, eos=None, **cfg):
    """The JAX engine's streams (sync, one prompt at a time), once per
    key for the whole module."""
    if key not in _REF:
        _REF[key] = tokens(serve(jeng, jax_engine(params, lora, eos, **cfg),
                                 jobs, warm))
    return _REF[key]


def lanes_jobs(adapters=(None,) * len(PROMPTS)):
    return [(p, 6, a) for p, a in zip(PROMPTS, adapters)]


# ---------------------------------------------------------------------------
# grouped prefill (tests/test_prefill_batch.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch,pipeline", MODES, ids=MODE_IDS)
def test_lanes_match_reference(params, batch, pipeline):
    want = reference("lanes", params, lanes_jobs(), **LANES)
    engine = port_engine(params, prefill_batch=batch,
                         pipeline_decode=pipeline, **LANES)
    calls = count_calls(engine, "_prefill_many_impl", "_process_block",
                        "_do_decode_step")
    assert tokens(serve(teng, engine, lanes_jobs())) == want
    assert (calls["_prefill_many_impl"] > 0) == (batch > 1)
    assert (calls["_process_block"] > 0) == pipeline
    assert (calls["_do_decode_step"] > 0) == (not pipeline)


@PIPE
def test_grouped_with_adapters_matches_reference(params, pipeline):
    adapters = ("ad-x", None, "ad-x", None, "ad-x", None)
    want = reference("adapters", params, lanes_jobs(adapters), lora=True,
                     **LANES)
    got = serve(teng, port_engine(params, lora=True, prefill_batch=4,
                                  pipeline_decode=pipeline, **LANES),
                lanes_jobs(adapters))
    assert tokens(got) == want
    # The adapter changes the output: the parity is not vacuous.
    assert want != reference("lanes", params, lanes_jobs(), **LANES)


SATURATED = dict(decode_slots=2, max_seq_len=128, prefill_buckets=(16, 32),
                 decode_steps_per_sync=4, decode_wait_cap=8)
SATURATED_JOBS = [([i + 1, i + 2, i + 3], 8, None) for i in range(8)]


@pytest.mark.parametrize("batch,pipeline", MODES, ids=MODE_IDS)
def test_saturated_slots_group_through_decode_wait(params, batch, pipeline):
    """More requests than slots: the overflow admits through (grouped)
    prefill-ahead and decode_wait, and matches the reference exactly."""
    want = reference("saturated", params, SATURATED_JOBS, **SATURATED)
    engine = port_engine(params, prefill_batch=batch,
                         pipeline_decode=pipeline, **SATURATED)
    calls = count_calls(engine, "_do_prefill_ahead_group", "_insert_waiting")
    assert tokens(serve(teng, engine, SATURATED_JOBS)) == want
    assert calls["_insert_waiting"] > 0  # rows came through decode_wait
    assert (calls["_do_prefill_ahead_group"] > 0) == (batch > 1)


class TestCollection:
    def _engine(self, params, prefill_batch=4, slots=8):
        return port_engine(params, decode_slots=slots, max_seq_len=128,
                           prefill_buckets=(16, 32),
                           prefill_batch=prefill_batch)

    def test_same_bucket_grouped_different_parks(self, params):
        engine = self._engine(params)
        head = teng.Request(prompt_tokens=[1, 2, 3], max_new_tokens=2)
        same = teng.Request(prompt_tokens=[4, 5], max_new_tokens=2)
        other = teng.Request(prompt_tokens=list(range(20)), max_new_tokens=2)
        tail = teng.Request(prompt_tokens=[6], max_new_tokens=2)
        for r in (same, other, tail):
            engine.prefill_queue.put_nowait(r)
        # The 16-bucket head takes its 16-bucket follower; the 32-bucket
        # prompt parks as _pending, the tail stays queued behind it (FIFO).
        assert engine._collect_prefill_group(head) == [head, same]
        assert engine._pending is other
        assert engine.prefill_queue.qsize() == 1

    def test_group_bounded_by_free_slots(self, params):
        engine = self._engine(params, prefill_batch=8, slots=2)
        head = teng.Request(prompt_tokens=[1], max_new_tokens=2)
        for i in range(2, 6):
            engine.prefill_queue.put_nowait(
                teng.Request(prompt_tokens=[i], max_new_tokens=2))
        assert len(engine._collect_prefill_group(head)) == 2
        assert engine.prefill_queue.qsize() == 3

    def test_cancelled_follower_skipped(self, params):
        engine = self._engine(params)
        head = teng.Request(prompt_tokens=[1, 2], max_new_tokens=2)
        dead = teng.Request(prompt_tokens=[3, 4], max_new_tokens=2)
        dead.cancelled.set()
        live = teng.Request(prompt_tokens=[5, 6], max_new_tokens=2)
        for r in (dead, live):
            engine.prefill_queue.put_nowait(r)
        assert engine._collect_prefill_group(head) == [head, live]
        assert dead.finish_reason == "cancelled"


class TestPagedGroupedAdmission:
    @PIPE
    def test_paged_grouped_matches_reference(self, params, pipeline):
        want = reference("paged", params, lanes_jobs(), **PAGED)
        got = serve(teng, port_engine(params, prefill_batch=4,
                                      pipeline_decode=pipeline, **PAGED),
                    lanes_jobs())
        assert tokens(got) == want

    @PIPE
    def test_tight_pool_parks_not_errors(self, params, pipeline):
        """A pool too small for the whole burst: grouped admission
        backpressures rows through decode_wait and still gives the
        unconstrained streams."""
        want = reference("paged", params, lanes_jobs(), **PAGED)
        engine = port_engine(params, prefill_batch=4,
                             pipeline_decode=pipeline,
                             **dict(PAGED, decode_slots=4, paged_kv_blocks=10))
        assert tokens(serve(teng, engine, lanes_jobs())) == want
        assert engine.metrics_snapshot()["kv_cache_usage_perc"] == 0.0


# Paged pool, prefix cache and two stream lanes: a cold request registers a
# 32-token prefix, then a burst of prefix hits, two prompts beyond the
# largest bucket (streamed in chunks) and more requests than slots.
PREFIX = list(np.random.RandomState(7).randint(1, 250, size=32))
STREAMS = dict(decode_slots=4, max_seq_len=128, prefill_buckets=(16, 32),
               decode_steps_per_sync=4, paged_kv_block=16,
               paged_kv_blocks=40, prefix_cache=True, stream_lanes=2)
STREAM_WARM = [(PREFIX + [11, 12, 13], 5, None)]
STREAM_JOBS = ([(PREFIX + [21 + i, 22, 23], 6, None) for i in range(3)]
               + [(list(np.random.RandomState(8).randint(1, 250, 40)), 6,
                   None),
                  (list(np.random.RandomState(9).randint(1, 250, 56)), 6,
                   None)]
               + [([40 + i, 41, 42], 6, None) for i in range(3)])


@pytest.mark.parametrize("batch,pipeline", MODES, ids=MODE_IDS)
def test_prefix_cache_and_streams_match_reference(params, batch, pipeline):
    want = reference("streams", params, STREAM_JOBS, STREAM_WARM, **STREAMS)
    engine = port_engine(params, prefill_batch=batch,
                         pipeline_decode=pipeline, **STREAMS)
    assert tokens(serve(teng, engine, STREAM_JOBS, STREAM_WARM)) == want
    assert engine.prefix_reused_tokens >= 3 * 32
    assert engine.metrics_snapshot()["stream_lanes_active"] == 0


# ---------------------------------------------------------------------------
# pipelined dispatch (tests/test_engine.py)
# ---------------------------------------------------------------------------

SMALL = dict(decode_slots=4, max_seq_len=64, prefill_buckets=(8, 16, 32))


@PIPE
def test_multistep_decode_matches_single_step(params, pipeline):
    """decode_steps_per_sync and pipelining change no greedy token."""
    job = [((7, 8, 9), 7, None)]
    want = reference("single-step", params, job, decode_steps_per_sync=1,
                     **SMALL)
    got = serve(teng, port_engine(params, decode_steps_per_sync=4,
                                  pipeline_decode=pipeline, **SMALL), job)
    assert tokens(got) == want


@PIPE
def test_device_side_eos_stops_mid_block(params, pipeline):
    """With K > max_new the device freezes the row at EOS: the output ends
    exactly at the stop token."""
    probe = reference("eos-probe", params, [((5, 6, 7), 3, None)], **SMALL)[0]
    eos = probe[1]  # the second token: EOS hits inside the first block
    got = serve(teng, port_engine(params, eos=eos, decode_slots=2,
                                  max_seq_len=64, prefill_buckets=(8, 16),
                                  decode_steps_per_sync=6,
                                  pipeline_decode=pipeline),
                [((5, 6, 7), 20, None)])[0]
    assert got.finish_reason == "stop"
    assert got.output_tokens == probe[:2]


def test_pipelined_concurrent_consistency(params):
    """Churn (slot reuse, mixed lengths) on a two-slot pipelined engine
    equals the reference's one-at-a-time streams."""
    prompts = [(5, 6, 7), (9, 9), (1, 2, 3, 4, 5, 6), (200, 100), (42,),
               (3, 3, 3)]
    jobs = [(p, 5 + (i % 3), None) for i, p in enumerate(prompts)]
    if "churn" not in _REF:
        _REF["churn"] = _sequential(params, jobs)
    want = _REF["churn"]
    got = serve(teng, port_engine(params, decode_slots=2, max_seq_len=64,
                                  prefill_buckets=(8, 16, 32),
                                  decode_steps_per_sync=3,
                                  pipeline_decode=True), jobs)
    assert tokens(got) == want


def _sequential(params, jobs):
    engine = jax_engine(params, **SMALL)
    engine.start()
    try:
        out = []
        for r in requests(jeng, jobs):
            engine.generate(r, timeout_s=180)
            out.append(list(r.output_tokens))
        return out
    finally:
        engine.stop()


def test_adaptive_pipelined_matches_reference(params):
    """The adaptive planner on a pipelined engine (its budget cap less the
    block in flight) changes no token either."""
    jobs = [(p, 9, None) for p in PROMPTS[:4]]
    want = reference("adaptive", params, jobs, **LANES)
    got = serve(teng, port_engine(params, pipeline_decode=True,
                                  **dict(LANES, adaptive_steps=8)), jobs)
    assert tokens(got) == want


def test_drain_on_paged_pipelined_engine(params):
    """Drain under the production shape (paged + pipelined + grouped):
    everything in flight, decode_wait parkers included, finishes."""
    engine = port_engine(params, decode_slots=2, max_seq_len=64,
                         prefill_buckets=(8, 16, 32), paged_kv_block=8,
                         pipeline_decode=True, decode_steps_per_sync=4,
                         prefill_batch=2, decode_wait_cap=2)
    engine.start()
    try:
        reqs = [teng.Request(prompt_tokens=[3 + i, 9, 4], max_new_tokens=10)
                for i in range(4)]  # 4 requests > 2 slots: parking happens
        for r in reqs:
            engine.submit(r)
        assert engine.drain(timeout_s=180) is True
        for r in reqs:
            assert r.done.is_set() and r.error is None, r.error
            assert len(r.output_tokens) == 10
        snap = engine.metrics_snapshot()
        assert snap["num_requests_running"] == 0
        assert snap["num_requests_waiting"] == 0
    finally:
        engine.stop()


@pytest.mark.parametrize("extra", [{}, {"paged_kv_block": 8}],
                         ids=["lanes", "paged"])
def test_cancel_mid_block_frees_the_row(params, extra):
    """A request cancelled while its blocks are in flight finishes as
    cancelled at the next processed block; its row is freed (and, paged,
    its blocks), and the engine keeps serving with the same streams."""
    engine = port_engine(params, decode_slots=2, max_seq_len=64,
                         prefill_buckets=(8, 16), decode_steps_per_sync=2,
                         pipeline_decode=True, **extra)
    engine.start()
    try:
        long = teng.Request(prompt_tokens=[256, 4], max_new_tokens=50)
        engine.submit(long)
        deadline = time.time() + 60
        while len(long.output_tokens) < 3 and time.time() < deadline:
            time.sleep(0.005)
        assert engine.release_request(long.request_id)
        assert long.done.wait(60) and long.finish_reason == "cancelled"
        assert len(long.output_tokens) < 50
        after = teng.Request(prompt_tokens=[7, 8, 9], max_new_tokens=7)
        engine.generate(after, timeout_s=60)
        assert after.error is None
        snap = engine.metrics_snapshot()
        assert snap["num_requests_running"] == 0
        assert snap["kv_cache_usage_perc"] == 0.0
    finally:
        engine.stop()
    want = reference("single-step", params, [((7, 8, 9), 7, None)],
                     decode_steps_per_sync=1, **SMALL)
    assert [after.output_tokens] == want


CHUNKED = dict(decode_slots=3, max_seq_len=128, prefill_buckets=(8,),
               decode_steps_per_sync=2, stream_lanes=2)
CHUNK_JOBS = [([5, 6, 7], 24, None),
              (list(np.random.RandomState(2).randint(1, 250, 56)), 24, None),
              (list(np.random.RandomState(3).randint(1, 250, 40)), 24, None)]


@pytest.mark.parametrize("batch", [1, 4], ids=["single", "grouped"])
def test_chunk_streams_beside_pipelined_blocks(params, batch):
    """Two long prompts stream chunk by chunk while pipelined blocks of a
    short request are in flight between chunks; every stream equals the
    reference's, and decode advanced between the chunks."""
    want = reference("chunked", params, CHUNK_JOBS, **CHUNKED)
    engine = port_engine(params, prefill_batch=batch, pipeline_decode=True,
                         **CHUNKED)
    generated = []
    step = engine._stream_step

    def traced(pipelined=False):
        generated.append(engine.total_generated)
        step(pipelined)

    engine._stream_step = traced
    assert tokens(serve(teng, engine, CHUNK_JOBS)) == want
    assert generated[-1] - generated[0] >= 5


@pytest.mark.parametrize("paged", [False, True], ids=["lanes", "pool"])
@pytest.mark.parametrize("batch", [1, 4], ids=["single", "grouped"])
def test_int8_kv_under_pipeline_matches_reference(params, paged, batch):
    cfg = dict(PAGED if paged else LANES, kv_cache_quant="int8")
    want = reference(f"int8-{paged}", params, lanes_jobs(), **cfg)
    got = serve(teng, port_engine(params, prefill_batch=batch,
                                  pipeline_decode=True, **cfg), lanes_jobs())
    assert tokens(got) == want


def test_stop_strings_and_ids_under_pipeline(params):
    """Device stop automata on a pipelined engine: the row's history is
    re-seeded on the device from its first token, and a stop sequence or
    a stop id ends both engines' streams at the same token."""
    base = reference("lanes", params, lanes_jobs(), **LANES)[4]
    jobs = [dict(prompt_tokens=PROMPTS[4], max_new_tokens=6,
                 stop_sequences=(tuple(base[2:4]),)),
            dict(prompt_tokens=PROMPTS[4], max_new_tokens=6,
                 stop_token_ids=(base[3],)),
            dict(prompt_tokens=PROMPTS[4], max_new_tokens=6,
                 stop_sequences=(tuple(base[0:2]),))]
    want = [base[:4], base[:4], base[:2]]
    got = serve(teng, port_engine(params, pipeline_decode=True,
                                  prefill_batch=4, **LANES), jobs)
    assert tokens(got) == want
    assert [r.finish_reason for r in got] == ["stop"] * 3


@pytest.mark.parametrize("batch", [1, 4], ids=["single", "grouped"])
def test_seeded_sampling_reproduces_across_dispatch_modes(params, batch):
    """A seeded sampled row draws from (seed, position) alone: the same
    tokens on the sync engine and on a pipelined (and grouped) one, with
    unseeded sampled rows beside it."""
    def jobs():
        seeded = teng.SamplingParams(temperature=0.9, top_k=20, seed=1234)
        free = teng.SamplingParams(temperature=0.9)
        return [dict(prompt_tokens=list(p), max_new_tokens=8,
                     sampling=seeded if i % 2 == 0 else free)
                for i, p in enumerate(PROMPTS[:4])]

    sync = serve(teng, port_engine(params, **LANES), jobs())
    piped = serve(teng, port_engine(params, prefill_batch=batch,
                                    pipeline_decode=True, **LANES), jobs())
    assert tokens(sync)[0::2] == tokens(piped)[0::2]
    assert all(len(r.output_tokens) == 8 for r in piped)


def test_logprobs_under_pipeline_match_reference(params):
    """The first token's logprobs come back with its first block; every
    token's logprob and top alternatives equal the reference's."""
    def jobs(mod):
        return [mod.Request(prompt_tokens=list(p), max_new_tokens=5,
                            logprobs=2) for p in PROMPTS[:3]]

    def run(mod, engine):
        engine.start()
        try:
            reqs = jobs(mod)
            for r in reqs:
                engine.submit(r)
            assert all(r.done.wait(180) and r.error is None for r in reqs)
            return reqs
        finally:
            engine.stop()

    want = run(jeng, jax_engine(params, **LANES))
    got = run(teng, port_engine(params, prefill_batch=4,
                                pipeline_decode=True, **LANES))
    assert tokens(got) == tokens(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.output_logprobs, w.output_logprobs,
                                   atol=1e-4)
        assert [sorted(d) for d in g.output_top_logprobs] == \
            [sorted(d) for d in w.output_top_logprobs]


# ---------------------------------------------------------------------------
# the fixed addresses a CUDA graph of the block needs, and the server flags
# ---------------------------------------------------------------------------


def test_decode_block_buffers_keep_their_addresses(params):
    """Everything the decode block reads keeps its address while the
    engine serves: its carry and parameter buffers, the paged tables and
    lengths (written in place), and the LoRA buffers across a load and an
    unload — which still take effect."""
    engine = port_engine(params, lora=True, pipeline_decode=True,
                         **dict(PAGED, decode_slots=2))
    addresses = lambda: ({k: v.data_ptr() for k, v in engine._dev.items()},
                         {k: v.data_ptr() for k, v in engine.cache.items()},
                         {k: v.data_ptr()
                          for k, v in engine.lora.buffers.items()})
    before = addresses()
    serve(teng, engine, [(PROMPTS[0], 6, "ad-x"), (PROMPTS[4], 6, None)])
    engine.lora.load("ad-y", weights=_adapter_weights(), alpha=4.0, rank=4)
    slot = engine.lora.slot_for("ad-y")
    assert float(engine.lora.buffers["scale"][slot]) == 1.0
    assert engine.lora.unload("ad-y")
    assert float(engine.lora.buffers["scale"][slot]) == 0.0
    assert not engine.lora.buffers["q_a"][:, slot].any()
    assert addresses() == before


def test_server_flags_build_a_grouped_pipelined_engine():
    httpd, engine, _ = api_http.make_server([
        "--device", "cpu", "--dtype", "float32", "--model", "llama3-tiny",
        "--host", "127.0.0.1", "--port", "0", "--prefill-batch", "4",
        "--pipeline-decode"])
    try:
        assert engine.cfg.prefill_batch == 4 and engine.cfg.pipeline_decode
        r = engine.generate(teng.Request(prompt_tokens=[256, 5, 6],
                                         max_new_tokens=4), timeout_s=120)
        assert r.error is None and len(r.output_tokens) == 4
    finally:
        httpd.server_close()
        engine.stop()
    defaults = api_http.build_parser().parse_args([])
    assert defaults.prefill_batch == 1 and defaults.pipeline_decode is False


def test_construction_serves_grouped_pipelined_config():
    """``prefill_batch`` and ``pipeline_decode`` are served, speculative
    decoding too (with a draft), so the list of unserved fields and its
    check are gone."""
    cfg = teng.EngineConfig(prefill_batch=4, pipeline_decode=True,
                            speculative_k=3)
    engine = teng.Engine(TINY_TEST, {}, cfg, device="cpu", draft_params={},
                         draft_cfg=TINY_TEST)
    assert engine.cfg.prefill_batch == 4 and engine._spec
    assert not hasattr(teng, "_UNSERVED")
    assert not hasattr(teng, "check_served")
