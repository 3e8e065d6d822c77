"""Parity of the torch port's sampling and serving engine with the JAX
reference, on the CPU at f32 on ``TINY_TEST``.

Greedy token streams must be IDENTICAL through both engines (stop strings
and max_tokens cuts included).  Sampled rows cannot match token for token
(torch has no threefry), so their kept top-k/top-p sets must match, and a
seed must reproduce inside the port.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_instance_gateway_tpu.gateway.metrics_client import families_to_metrics
from llm_instance_gateway_tpu.gateway.types import Metrics
from llm_instance_gateway_tpu.models import transformer as jtf
from llm_instance_gateway_tpu.models.configs import TINY_TEST as JAX_TINY
from llm_instance_gateway_tpu.server import engine as jeng
from llm_instance_gateway_tpu.server import sampling as jsamp
from llm_instance_gateway_tpu.server.lora_manager import LoRAManager as JLoRA
from llm_instance_gateway_tpu.utils import prom_parse

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch.models.configs import TINY_TEST  # noqa: E402
from llm_instance_gateway_tpu_torch.models.weights import params_from_numpy  # noqa: E402
from llm_instance_gateway_tpu_torch.server import engine as teng  # noqa: E402
from llm_instance_gateway_tpu_torch.server import metrics as tmetrics  # noqa: E402
from llm_instance_gateway_tpu_torch.server import sampling as tsamp  # noqa: E402
from llm_instance_gateway_tpu_torch.server.lora_manager import (  # noqa: E402
    LoRAManager as TLoRA,
)

EOS = 257
ENGINE_CFG = dict(decode_slots=3, max_seq_len=64, prefill_buckets=(8, 16, 32),
                  decode_steps_per_sync=4)


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def _logits(seed=0, b=4, v=320):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, v)).astype(np.float32)
    x[:, :6] += np.array([6.0, 5.8, 5.6, 5.4, 5.2, 5.0], np.float32)
    return x


class TestSampling:
    def test_greedy_matches_exactly_with_bias_and_vocab_pad(self):
        x = _logits(1)
        x[2, 300] = 50.0  # a padding id: masked by valid_vocab
        bias_ids = np.full((4, 3), -1, np.int32)
        bias_vals = np.zeros((4, 3), np.float32)
        bias_ids[1, 0], bias_vals[1, 0] = 17, 40.0  # forces id 17
        zeros = np.zeros(4, np.float32)
        want = jsamp.sample(jnp.asarray(x), jax.random.PRNGKey(0),
                            jnp.asarray(zeros), jnp.zeros(4, jnp.int32),
                            jnp.ones(4), valid_vocab=259,
                            bias_ids=jnp.asarray(bias_ids),
                            bias_vals=jnp.asarray(bias_vals))
        got = tsamp.sample(t(x), torch.Generator().manual_seed(0), t(zeros),
                           torch.zeros(4, dtype=torch.int64), torch.ones(4),
                           valid_vocab=259, bias_ids=t(bias_ids),
                           bias_vals=t(bias_vals))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got[1] == 17 and got[2] != 300

    @pytest.mark.parametrize("temp,top_k,top_p", [
        (1.0, 3, 1.0), (0.7, 0, 0.9), (1.3, 5, 0.8)])
    def test_kept_sets_match(self, temp, top_k, top_p):
        """The ids each side can emit over many draws equal the port's
        filtered set (top-k, then top-p, from one sort)."""
        x = _logits(2, b=1)
        n = 400
        logits = np.repeat(x, n, axis=0)
        temps = np.full(n, temp, np.float32)
        ks = np.full(n, top_k, np.int32)
        ps = np.full(n, top_p, np.float32)
        jax_ids = set(np.asarray(jsamp.sample(
            jnp.asarray(logits), jax.random.PRNGKey(1), jnp.asarray(temps),
            jnp.asarray(ks), jnp.asarray(ps), valid_vocab=259)).tolist())
        port_ids = set(tsamp.sample(
            t(logits), torch.Generator().manual_seed(1), t(temps), t(ks),
            t(ps), valid_vocab=259).tolist())
        _, masked = tsamp.filter_logits(t(x), t(temps[:1]), t(ks[:1]),
                                        t(ps[:1]), valid_vocab=259)
        kept = set(torch.nonzero(masked[0] > -1e29).flatten().tolist())
        assert 1 < len(kept) <= 6
        assert jax_ids == kept
        assert port_ids == kept

    def test_seed_reproduces_inside_the_port(self):
        x = _logits(3, b=3)
        args = (t(np.full(3, 1.0, np.float32)), torch.zeros(3, dtype=torch.int64),
                torch.ones(3))
        seeds = torch.tensor([7, 7, -1])
        pos = torch.tensor([5, 5, 5])
        a = tsamp.sample(t(x), torch.Generator().manual_seed(0), *args,
                         seeds=seeds, positions=pos)
        b = tsamp.sample(t(x[[1, 0, 2]]), torch.Generator().manual_seed(99),
                         *args, seeds=seeds, positions=pos)
        assert a[0] == b[1] and a[1] == b[0]  # batch mates do not matter
        draws = {int(tsamp.sample(t(x[:1]), None, *(v[:1] for v in args),
                                  seeds=torch.tensor([7]),
                                  positions=torch.tensor([p]))[0])
                 for p in range(40)}
        assert len(draws) > 1  # the position varies the draw
        u = tsamp.seeded_uniform(torch.tensor([3]), torch.tensor([9]), 4096)
        assert 0 < u.min() and u.max() < 1 and abs(u.mean() - 0.5) < 0.03

    def test_stop_automaton_matches(self):
        rng = np.random.default_rng(4)
        seqs = [(5, 6), (9,), (1, 2, 3)]
        assert tsamp.encode_stop_rows(seqs) == jsamp.encode_stop_rows(seqs)
        assert tsamp.encode_stop_rows([(1,)] * 5) is None
        assert tsamp.encode_stop_rows([tuple(range(9))]) is None
        ids, lens = jsamp.encode_stop_rows(seqs)
        stop_ids = np.array([ids] * 6, np.int32)
        stop_lens = np.array([lens] * 6, np.int32)
        hist = np.full((6, tsamp.STOP_LEN), -1, np.int32)
        jh, th = jnp.asarray(hist), t(hist)
        for _ in range(12):
            tok = rng.choice([1, 2, 3, 5, 6, 9, 11], 6).astype(np.int32)
            adv = rng.random(6) < 0.8
            jh = jsamp.stop_hist_update(jh, jnp.asarray(tok), jnp.asarray(adv))
            th = tsamp.stop_hist_update(th, t(tok), t(adv))
            np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
            np.testing.assert_array_equal(
                tsamp.stop_suffix_hit(th, t(stop_ids), t(stop_lens)).numpy(),
                np.asarray(jsamp.stop_suffix_hit(jh, jnp.asarray(stop_ids),
                                                 jnp.asarray(stop_lens))))

    def test_logprob_info_matches(self):
        x = _logits(5)
        sampled = np.array([0, 3, 100, 258], np.int32)
        jlp, jv, ji = jeng._logprob_info(jnp.asarray(x), jnp.asarray(sampled),
                                        259)
        tlp, tv, ti = tsamp.logprob_info(t(x), t(sampled), 259)
        np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


def _adapter(seed=0, rank=3):
    from llm_instance_gateway_tpu.models import lora as jlora

    rng = np.random.default_rng(seed)
    return {tg: {"a": rng.standard_normal((2, di, rank)).astype(np.float32) * .4,
                 "b": rng.standard_normal((2, rank, do)).astype(np.float32) * .4}
            for tg, (di, do) in jlora.target_dims(JAX_TINY).items()}


@pytest.fixture(scope="module")
def engines():
    jparams = jtf.init_params(JAX_TINY, jax.random.PRNGKey(0), jnp.float32)
    jlora = JLoRA(JAX_TINY, dtype=jnp.float32)
    tlora = TLoRA(TINY_TEST, dtype=torch.float32, device="cpu")
    for lm in (jlora, tlora):
        lm.load("tenant", weights=_adapter(), alpha=6.0, rank=3)
    je = jeng.Engine(JAX_TINY, jparams, jeng.EngineConfig(**ENGINE_CFG),
                     lora_manager=jlora, eos_id=EOS, dtype=jnp.float32)
    te = teng.Engine(TINY_TEST,
                     params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"),
                     teng.EngineConfig(**ENGINE_CFG), lora_manager=tlora,
                     eos_id=EOS, dtype=torch.float32, device="cpu")
    je.start()
    te.start()
    yield je, te
    je.stop()
    te.stop()


def _requests(mod, prompts):
    return [mod.Request(prompt_tokens=list(p), max_new_tokens=m,
                        adapter=a, stop_sequences=tuple(s))
            for p, m, a, s in prompts]


class TestEngineParity:
    def test_identical_greedy_streams(self, engines):
        """Same prompts through both engines: identical greedy tokens — base
        and adapter rows, more requests than slots (prefill-ahead parks in
        decode_wait), a max_tokens cut of 1, and a stop sequence."""
        je, te = engines
        prompts = [((256, 72, 105), 12, None, ()),
                   ((256, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10), 9, "tenant", ()),
                   ((256, 65), 1, None, ()),
                   ((256, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62,
                     63, 64, 65, 66, 67), 20, "tenant", ()),
                   ((256, 80, 81), 10, None, ())]
        ref = _requests(jeng, prompts)
        for r in ref:
            je.submit(r)
        for r in ref:
            assert r.done.wait(120) and r.error is None
        # A stop sequence cut from the reference's own stream (its 3rd and
        # 4th tokens) must end both engines' streams at the same place.
        stream = ref[0].output_tokens
        stop = (tuple(stream[2:4]),)
        prompts.append(((256, 72, 105), 12, None, stop))
        ref.append(jeng.Request(prompt_tokens=[256, 72, 105],
                                max_new_tokens=12, stop_sequences=stop))
        je.submit(ref[-1])
        assert ref[-1].done.wait(120)
        port = _requests(teng, prompts)
        for r in port:
            te.submit(r)
        for r in port:
            assert r.done.wait(120) and r.error is None
        assert [r.output_tokens for r in port] == [r.output_tokens for r in ref]
        assert [r.finish_reason for r in port] == [r.finish_reason for r in ref]
        assert port[-1].finish_reason == "stop"
        assert len(port[-1].output_tokens) <= 4
        assert [r.finish_reason for r in port[:3]] == ["length"] * 3
        assert [len(r.output_tokens) for r in port[:3]] == [12, 9, 1]

    def test_metrics_snapshot_keys_equal_reference(self, engines):
        je, te = engines
        assert set(te.metrics_snapshot()) == set(je.metrics_snapshot())

    def test_exposition_parses_in_the_gateway(self, engines):
        _, te = engines
        snap = te.metrics_snapshot()
        snap["model_name"] = "llama3-tiny"
        text = tmetrics.render(snap)
        metrics, errs = families_to_metrics(prom_parse.parse_text(text),
                                            Metrics())
        assert errs == []
        assert metrics.kv_tokens_capacity == 3 * 64
        assert metrics.max_active_adapters == TINY_TEST.max_lora_slots
        for family in ("tpu:decode_step_seconds", "tpu:dispatch_steps",
                       "tpu:adapter_step_seconds_total",
                       "tpu:dispatch_wall_seconds",
                       "tpu:adapter_residency_info"):
            assert family in text

    def test_adaptive_planner_powers_of_two(self, engines):
        _, te = engines
        te.cfg.adaptive_steps = 8
        try:
            r = te.generate(teng.Request(prompt_tokens=[256, 9], max_new_tokens=7),
                            timeout_s=60)
            assert r.error is None and len(r.output_tokens) == 7
            hist = te.metrics_snapshot()["dispatch_steps_hist"]
            # 6 tokens after the prefill's: 4 + 2 fused steps.
            assert hist["count"] >= 2
        finally:
            te.cfg.adaptive_steps = 0

    def test_drain_refuses_then_completes(self):
        te = teng.Engine(TINY_TEST,
                         params_from_numpy(jax.tree.map(np.asarray, jtf.init_params(
                             JAX_TINY, jax.random.PRNGKey(1), jnp.float32)),
                             "cpu"),
                         teng.EngineConfig(**ENGINE_CFG), eos_id=None,
                         dtype=torch.float32, device="cpu")
        te.start()
        try:
            r = te.submit(teng.Request(prompt_tokens=[256, 3], max_new_tokens=6))
            assert te.drain(30)
            assert r.done.is_set() and len(r.output_tokens) == 6
            with pytest.raises(teng.EngineDraining):
                te.submit(teng.Request(prompt_tokens=[256]))
        finally:
            te.stop()


@pytest.mark.parametrize("extra", [
    {}, {"paged_kv_block": 16, "prefix_cache": True}],
    ids=["lanes", "paged"])
def test_int8_kv_constructs(extra):
    """int8 KV is served on lanes and on the paged pool: the engine's
    cache holds int8 K/V with f32 scales, one per (position, KV head)."""
    cfg = teng.EngineConfig(kv_cache_quant="int8", **extra)
    eng = teng.Engine(TINY_TEST, {}, cfg, dtype=torch.float32,
                      device="cpu")
    for name in ("k", "v"):
        assert eng.cache[name].dtype == torch.int8
        assert eng.cache[f"{name}_scale"].dtype == torch.float32
        assert (eng.cache[f"{name}_scale"].shape
                == eng.cache[name].shape[:-1])
    assert ("tables" in eng.cache) == ("paged_kv_block" in extra)


class TestUnservedConfigRaises:
    @pytest.mark.parametrize("field,value", [("speculative_k", 2)])
    def test_construction_raises(self, field, value):
        """Speculative decoding is served: without a draft the engine
        raises the reference's error, with one it constructs (the draft's
        own lanes beside the target's) and reports the spec keys."""
        cfg = teng.EngineConfig(**{field: value})
        with pytest.raises(ValueError, match="requires draft_params"):
            teng.Engine(TINY_TEST, {}, cfg, device="cpu")
        eng = teng.Engine(TINY_TEST, {}, cfg, device="cpu",
                          draft_params={}, draft_cfg=TINY_TEST)
        assert eng.draft_cache["k"].shape == eng.cache["k"].shape
        snap = eng.metrics_snapshot()
        assert (snap["spec_cycles"], snap["spec_tokens_per_cycle"]) == (0, 0.0)

    @pytest.mark.parametrize("field,value", [
        ("role", "prefill"), ("role", "decode"), ("handoff_ttl_s", 5.0)])
    def test_disaggregation_fields_construct_and_serve(self, field, value):
        """Disaggregation is served: an engine with a two-hop role or a
        handoff TTL constructs, reports its role, and answers a request."""
        te = teng.Engine(
            TINY_TEST,
            params_from_numpy(jax.tree.map(np.asarray, jtf.init_params(
                JAX_TINY, jax.random.PRNGKey(2), jnp.float32)), "cpu"),
            teng.EngineConfig(**dict(ENGINE_CFG, **{field: value})),
            eos_id=None, dtype=torch.float32, device="cpu")
        assert getattr(te.cfg, field) == value
        assert te.metrics_snapshot()["pool_role"] == te.cfg.role
        te.start()
        try:
            r = te.generate(teng.Request(prompt_tokens=[256, 4],
                                         max_new_tokens=3), timeout_s=60)
            assert r.error is None and len(r.output_tokens) == 3
        finally:
            te.stop()

    def test_penalties_raise(self, engines):
        """Penalties are served (the JAX engine's tokens) and raise only on
        a speculative engine, in the reference's words."""
        je, te = engines
        out = []
        for mod, eng in ((jeng, je), (teng, te)):
            r = eng.generate(mod.Request(
                prompt_tokens=[1, 2], max_new_tokens=10,
                sampling=mod.SamplingParams(presence_penalty=0.5,
                                            frequency_penalty=0.5)),
                timeout_s=120)
            assert r.error is None, r.error
            out.append(r.output_tokens)
        assert out[1] == out[0]
        spec = teng.Engine(TINY_TEST, te.params,
                           teng.EngineConfig(speculative_k=2), device="cpu",
                           draft_params=te.params, draft_cfg=TINY_TEST)
        sp = teng.SamplingParams(presence_penalty=0.5)
        with pytest.raises(ValueError, match="penalties and logit_bias are "
                                             "not supported on a speculative"):
            spec.submit(teng.Request(prompt_tokens=[1, 2], sampling=sp))

    def test_unknown_adapter_fails_fast(self, engines):
        from llm_instance_gateway_tpu_torch.server.lora_manager import AdapterError

        _, te = engines
        with pytest.raises(AdapterError):
            te.submit(teng.Request(prompt_tokens=[1, 2], adapter="nope"))
        assert te.metrics_snapshot()["num_requests_waiting"] == 0


def test_cancel_frees_the_slot(engines):
    _, te = engines
    r = te.submit(teng.Request(prompt_tokens=[256, 4], max_new_tokens=60))
    deadline = time.time() + 60
    while not r.output_tokens and time.time() < deadline:
        time.sleep(0.01)
    assert te.release_request(r.request_id)
    assert r.done.wait(60) and r.finish_reason in ("cancelled", "length")
    assert te.metrics_snapshot()["num_requests_running"] == 0
