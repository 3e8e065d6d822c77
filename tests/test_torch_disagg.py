"""Disaggregated prefill/decode in the torch port, held against the JAX
package on the CPU at f32 on ``TINY_TEST``.

The contract: a prefill-role engine's ``prefill_only`` handoff, attached on
a second engine with ``attach_prefilled``, gives the greedy tokens of
collocated serving, exactly — across a real wire round trip, for the raw
and the int8 wire lanes, with and without an adapter, on lane, paged and
pipelined decode engines.  The wire is the reference's byte for byte, so
handoffs cross between the frameworks in both directions.  Release and the
TTL backstop are driven deterministically (the engine's admission is
stepped by hand, no sleeping against a short TTL).
"""

import dataclasses
import json
import socket
import struct
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_instance_gateway_tpu.models import lora as jlora
from llm_instance_gateway_tpu.models import transformer as jtf
from llm_instance_gateway_tpu.models.configs import TINY_TEST as JAX_TINY
from llm_instance_gateway_tpu.models.llama import CONFIGS as JAX_CONFIGS
from llm_instance_gateway_tpu.server import engine as jeng
from llm_instance_gateway_tpu.server import kv_transfer as jkv
from llm_instance_gateway_tpu.server.lora_manager import LoRAManager as JLoRA
from llm_instance_gateway_tpu.utils import prom_parse

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch.models import transformer as ttf  # noqa: E402
from llm_instance_gateway_tpu_torch.models.configs import TINY_TEST  # noqa: E402
from llm_instance_gateway_tpu_torch.models.weights import (  # noqa: E402
    params_from_numpy,
    tensor_from_numpy,
)
from llm_instance_gateway_tpu_torch.server import api_http  # noqa: E402
from llm_instance_gateway_tpu_torch.server import engine as teng  # noqa: E402
from llm_instance_gateway_tpu_torch.server import kv_transfer as tkv  # noqa: E402
from llm_instance_gateway_tpu_torch.server import metrics as tmetrics  # noqa: E402
from llm_instance_gateway_tpu_torch.server.lora_manager import (  # noqa: E402
    LoRAManager as TLoRA,
)
from llm_instance_gateway_tpu_torch.server.tokenizer import ByteTokenizer  # noqa: E402

CFG = TINY_TEST
PROMPT = tuple(range(3, 20))  # 17 tokens -> 2 full 8-token blocks
ADAPTER = "handoff-adapter"
BASE = dict(decode_slots=2, max_seq_len=64, prefill_buckets=(8, 16, 32))
KV_SHAPE = (CFG.n_layers, 1, 32, CFG.n_kv_heads, CFG.resolved_head_dim)


def adapter_weights(seed=7, rank=2):
    dims = jlora.target_dims(JAX_TINY)
    rng = np.random.RandomState(seed)
    return {t: {"a": rng.randn(CFG.n_layers, dims[t][0], rank) * 0.5,
                "b": rng.randn(CFG.n_layers, rank, dims[t][1]) * 0.5}
            for t in ("q", "v")}


def treq(prompt=PROMPT, max_new=8, adapter=None, **kw):
    return teng.Request(prompt_tokens=list(prompt), max_new_tokens=max_new,
                        adapter=adapter, **kw)


def jreq(prompt=PROMPT, max_new=8, adapter=None, **kw):
    return jeng.Request(prompt_tokens=list(prompt), max_new_tokens=max_new,
                        adapter=adapter, **kw)


@pytest.fixture(scope="module")
def jparams():
    return jtf.init_params(JAX_TINY, jax.random.PRNGKey(0), jnp.float32)


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


@pytest.fixture
def port(tparams):
    """Factory of port engines over the JAX weights; stops them all."""
    made = []

    def make(start=True, lora=False, **overrides):
        cfg = dict(BASE, **overrides)
        manager = None
        if lora:
            manager = TLoRA(CFG, dtype=torch.float32, device="cpu")
            manager.load(ADAPTER, weights=adapter_weights(), alpha=8.0, rank=2)
        eng = teng.Engine(CFG, tparams, teng.EngineConfig(**cfg),
                          lora_manager=manager, eos_id=None,
                          dtype=torch.float32, device="cpu")
        made.append(eng)
        if start:
            eng.start()
        return eng

    yield make
    for eng in made:
        eng.stop()


@pytest.fixture(scope="module")
def jax_side(jparams):
    """The JAX package's engines, the adapter loaded in each: a prefill-role
    engine, and collocated lane engines with a raw and an int8 KV cache
    (the references, and the decode side for port handoffs: lanes have no
    prefix cache, so an attach never feeds a later reference)."""
    def make(**overrides):
        manager = JLoRA(JAX_TINY, dtype=jnp.float32)
        manager.load(ADAPTER, weights=adapter_weights(), alpha=8.0, rank=2)
        eng = jeng.Engine(JAX_TINY, jparams,
                          jeng.EngineConfig(**dict(BASE, **overrides)),
                          lora_manager=manager, eos_id=None,
                          dtype=jnp.float32)
        eng.start()
        return eng

    side = {"pre": make(role="prefill"), "raw": make(),
            "int8": make(kv_cache_quant="int8"), "want": {}}
    yield side
    for name in ("pre", "raw", "int8"):
        side[name].stop()


def collocated(jax_side, kv=None, adapter=None, prompt=PROMPT, max_new=8):
    """The JAX package's collocated greedy tokens for one request."""
    key = (kv, adapter, tuple(prompt), max_new)
    if key not in jax_side["want"]:
        r = jax_side[kv or "raw"].generate(jreq(prompt, max_new, adapter),
                                           timeout_s=180)
        assert r.error is None, r.error
        jax_side["want"][key] = list(r.output_tokens)
    return jax_side["want"][key]


def attach_wire(dec, wire) -> teng.Request:
    req = dec.attach_prefilled(tkv.PrefillHandoff.from_bytes(wire))
    assert req.done.wait(180), "attach never finished"
    assert req.error is None, req.error
    return req


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------


def _kv(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(*KV_SHAPE).astype(np.float32),
            rng.randn(*KV_SHAPE).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


class TestWireFormat:
    def test_raw_roundtrip_exact(self):
        k, v = _kv()
        req = treq(max_new=5, adapter="a1", logprobs=2)
        h = tkv.export_handoff(req, _t(k), _t(v), n=17, first_token=42,
                               lp_info=(np.float32(-1.5),
                                        np.zeros(5, np.float32),
                                        np.arange(5, dtype=np.int32)))
        h2 = tkv.PrefillHandoff.from_bytes(h.to_bytes())
        assert h2.kv_format == "raw" and h2.kv_dtype == "float32"
        np.testing.assert_array_equal(h2.k.numpy(), k[:, 0, :17])
        np.testing.assert_array_equal(h2.v.numpy(), v[:, 0, :17])
        assert h2.prompt_tokens == list(PROMPT)
        assert (h2.first_token, h2.adapter, h2.logprobs) == (42, "a1", 2)
        lp, top_v, top_i = h2.first_lp_info()
        assert float(lp) == -1.5 and list(top_i) == [0, 1, 2, 3, 4]
        r2 = tkv.make_request(h2)
        assert r2.prompt_tokens == list(PROMPT)
        assert r2.max_new_tokens == 5
        assert r2.request_id == req.request_id

    def test_int8_roundtrip_and_stability(self):
        """int8 wire: close to the source values, and quantization-STABLE
        (dequantize then re-quantize gives the identical payload), with the
        same bytes as the engine's own KV quantizer."""
        k, v = _kv(1)
        h = tkv.export_handoff(treq(max_new=5), _t(k), _t(v), n=17,
                               first_token=1, quantize="int8")
        h2 = tkv.PrefillHandoff.from_bytes(h.to_bytes())
        assert h2.kv_format == "int8"
        assert h2.k.dtype == torch.int8 and h2.k_scale.dtype == torch.float32
        kd, vd = h2.kv_arrays()
        np.testing.assert_allclose(kd.numpy(), k[:, 0, :17], atol=0.02)
        np.testing.assert_allclose(vd.numpy(), v[:, 0, :17], atol=0.02)
        h3 = tkv.export_handoff(treq(max_new=5), kd[:, None], vd[:, None],
                                n=17, first_token=1, quantize="int8")
        assert torch.equal(h3.k, h2.k) and torch.equal(h3.k_scale, h2.k_scale)
        # the cache insert re-quantizes the dequantized lane identically
        q, s = ttf._kv_quantize(kd)
        assert torch.equal(q, h2.k) and torch.equal(s, h2.k_scale)
        raw = tkv.export_handoff(treq(max_new=5), _t(k), _t(v), n=17,
                                 first_token=1)
        assert len(h.to_bytes()) < len(raw.to_bytes()) * 0.6

    def test_sampling_params_survive_json(self):
        req = treq(max_new=4)
        req.sampling = teng.SamplingParams(
            temperature=0.7, top_k=5, top_p=0.9, seed=123,
            presence_penalty=0.5, logit_bias={7: -2.0, 9: 1.5})
        k, v = _kv(2)
        h = tkv.PrefillHandoff.from_bytes(tkv.export_handoff(
            req, _t(k), _t(v), n=17, first_token=3).to_bytes())
        sp = tkv.make_request(h).sampling
        assert sp.temperature == pytest.approx(0.7)
        assert sp.seed == 123 and sp.presence_penalty == 0.5
        assert sp.logit_bias == {7: -2.0, 9: 1.5}  # int keys restored

    def test_malformed_payloads_rejected(self):
        with pytest.raises(ValueError, match="magic"):
            tkv.PrefillHandoff.from_bytes(b"not a handoff at all")
        k, v = _kv(3)
        wire = tkv.export_handoff(treq(), _t(k), _t(v), n=17,
                                  first_token=1).to_bytes()
        with pytest.raises(ValueError, match="truncated"):
            tkv.PrefillHandoff.from_bytes(wire[: len(wire) // 2])
        magic_len = 8
        (head_len,) = struct.unpack_from("<I", wire, magic_len)
        head = json.loads(wire[magic_len + 4:magic_len + 4 + head_len])

        def tampered():
            new_head = json.dumps(head).encode()
            return (wire[:magic_len] + struct.pack("<I", len(new_head))
                    + new_head + wire[magic_len + 4 + head_len:])

        head["arrays"][0]["shape"][0] = -1
        with pytest.raises(ValueError, match="negative dimension"):
            tkv.PrefillHandoff.from_bytes(tampered())
        head["arrays"][0]["shape"][0] = 2
        head["arrays"][0]["dtype"] = "object"
        with pytest.raises(ValueError, match="unsupported handoff dtype"):
            tkv.PrefillHandoff.from_bytes(tampered())

    @pytest.mark.parametrize("dtype,quantize", [
        ("float32", None), ("bfloat16", None), ("float32", "int8"),
        ("bfloat16", "int8")],
        ids=["raw-f32", "raw-bf16", "int8-from-f32", "int8-from-bf16"])
    def test_bytes_equal_the_reference(self, dtype, quantize):
        """Same contents, same bytes, through either package's
        ``export_handoff``/``to_bytes``; each side parses the other's
        bytes back to the identical payload.  bf16 crosses as raw 16-bit
        words (no ml_dtypes on the port's side)."""
        k, v = _kv(4)
        if dtype == "bfloat16":
            k, v = (a.astype(jnp.bfloat16) for a in (k, v))
        lp = (np.float32(-0.75), np.linspace(-1, 0, 5).astype(np.float32),
              np.arange(5, dtype=np.int32))
        common = dict(max_new=6, adapter="a1", logprobs=3,
                      stop_token_ids=(5, 9), stop_sequences=((1, 2),),
                      request_id="abc123")
        sampling = dict(temperature=0.7, top_k=5, top_p=0.9, seed=11,
                        logit_bias={7: -2.0})
        jr = jreq(**common, sampling=jeng.SamplingParams(**sampling))
        tr = treq(**common, sampling=teng.SamplingParams(**sampling))
        jr.t_submit = tr.t_submit = 1234.5
        jh = jkv.export_handoff(jr, k, v, n=17, first_token=42, lp_info=lp,
                                quantize=quantize)
        th = tkv.export_handoff(tr, tensor_from_numpy(k, "cpu"),
                                tensor_from_numpy(v, "cpu"), n=17,
                                first_token=42, lp_info=lp, quantize=quantize)
        for h in (jh, th):
            h.body = {"prompt": "hello", "max_tokens": 6}
            h.trace_id = "t-1"
        jwire, twire = jh.to_bytes(), th.to_bytes()
        assert twire == jwire
        assert tkv.PrefillHandoff.from_bytes(jwire).to_bytes() == jwire
        assert jkv.PrefillHandoff.from_bytes(twire).to_bytes() == twire
        parsed = tkv.PrefillHandoff.from_bytes(jwire)
        want_dtype = {"int8": torch.int8}.get(quantize, {
            "float32": torch.float32, "bfloat16": torch.bfloat16}[dtype])
        assert parsed.k.dtype == want_dtype and parsed.kv_dtype == dtype


# ---------------------------------------------------------------------------
# handoffs across the two packages
# ---------------------------------------------------------------------------


class TestCrossFramework:
    @pytest.mark.parametrize("kv", [None, "int8"], ids=["raw", "int8"])
    def test_jax_handoff_attaches_on_the_port(self, kv, jax_side, port):
        """A JAX prefill replica's handoff decodes on a port decode
        engine (paged pool, prefix cache) to the collocated tokens."""
        h = jax_side["pre"].prefill_only(jreq(), timeout_s=180, quantize=kv)
        assert h.kv_format == (kv or "raw")
        dec = port(role="decode", paged_kv_block=8, prefix_cache=True,
                   kv_cache_quant=kv)
        req = attach_wire(dec, h.to_bytes())
        assert req.output_tokens == collocated(jax_side, kv)

    @pytest.mark.parametrize("kv", [None, "int8"], ids=["raw", "int8"])
    def test_port_handoff_attaches_on_jax(self, kv, jax_side, port):
        pre = port(role="prefill", kv_cache_quant=kv)
        h = pre.prefill_only(treq(), timeout_s=180)
        assert h.kv_format == (kv or "raw")
        req = jax_side[kv or "raw"].attach_prefilled(
            jkv.PrefillHandoff.from_bytes(h.to_bytes()))
        assert req.done.wait(180) and req.error is None, req.error
        assert req.output_tokens == collocated(jax_side, kv)


# ---------------------------------------------------------------------------
# two port engines
# ---------------------------------------------------------------------------


class TestTwoEngineParity:
    @pytest.mark.parametrize("kv", [None, "int8"], ids=["raw", "int8"])
    @pytest.mark.parametrize("adapter", [None, ADAPTER], ids=["base", "lora"])
    def test_disagg_matches_collocated(self, kv, adapter, jax_side, port):
        lora = adapter is not None
        pre = port(lora=lora, kv_cache_quant=kv, role="prefill")
        dec = port(lora=lora, kv_cache_quant=kv, role="decode",
                   paged_kv_block=8, prefix_cache=True)
        h = pre.prefill_only(treq(adapter=adapter), timeout_s=180)
        assert h.kv_format == (kv or "raw")  # int8 engines: the int8 lane
        req = attach_wire(dec, h.to_bytes())
        assert req.finish_reason == "length"
        assert req.output_tokens == collocated(jax_side, kv, adapter)
        assert req.ttft_s > 0  # stamped on the decode engine

    def test_lane_cache_decode_engine(self, jax_side, port):
        pre, dec = port(role="prefill"), port(role="decode")
        h = pre.prefill_only(treq(), timeout_s=180)
        assert attach_wire(dec, h.to_bytes()).output_tokens == collocated(
            jax_side)

    @pytest.mark.parametrize("paged", [False, True], ids=["lanes", "paged"])
    def test_pipelined_decode_engine(self, paged, jax_side, port):
        """The pipelined loop emits the carried first token once (it is
        scattered into the device carry, not materialized again), a
        repeat included."""
        extra = dict(paged_kv_block=8, prefix_cache=True) if paged else {}
        pre = port(role="prefill")
        dec = port(role="decode", pipeline_decode=True,
                   decode_steps_per_sync=4, **extra)
        wire = pre.prefill_only(treq(), timeout_s=180).to_bytes()
        want = collocated(jax_side)
        assert attach_wire(dec, wire).output_tokens == want
        assert attach_wire(dec, wire).output_tokens == want


# ---------------------------------------------------------------------------
# attach semantics
# ---------------------------------------------------------------------------


class TestAttachSemantics:
    def test_idempotent_attach_and_prefix_composition(self, jax_side, port,
                                                      monkeypatch):
        """A repeated attach maps the cached prefix blocks (refcounted,
        counted in prefix_reused_tokens) and scatters only its suffix
        (the mapped blocks' positions go to the trash block); local
        traffic sharing the prefix reuses the imported blocks."""
        scatters = []
        insert = teng.paged_lib.insert_prefill_paged

        def recording(cache, k, v, row, phys, table_row, length):
            scatters.append(list(phys))
            return insert(cache, k, v, row, phys, table_row, length)

        monkeypatch.setattr(teng.paged_lib, "insert_prefill_paged",
                            recording)
        pre = port(role="prefill")
        dec = port(role="decode", paged_kv_block=8, prefix_cache=True)
        wire = pre.prefill_only(treq(), timeout_s=180).to_bytes()
        r1 = attach_wire(dec, wire)
        assert len(dec._prefix_table) == 2  # 2 full blocks registered
        assert dec.prefix_reused_tokens == 0
        r2 = attach_wire(dec, wire)
        assert r2.output_tokens == r1.output_tokens == collocated(jax_side)
        assert len(dec._prefix_table) == 2  # no duplicate registration
        assert dec.prefix_reused_tokens == 16
        trash = teng.paged_lib.TRASH_BLOCK
        assert scatters[0][:2] != [trash, trash]
        assert scatters[1][:2] == [trash, trash]  # mapped, not re-written
        loc = dec.generate(treq(), timeout_s=180)
        assert loc.output_tokens == r1.output_tokens
        assert dec.prefix_reused_tokens == 32
        snap = dec.metrics_snapshot()
        assert snap["num_requests_running"] == 0
        assert snap["kv_parked_tokens"] == 0
        assert snap["kv_cache_usage_perc"] == 0.0

    def test_first_token_only_request_never_takes_a_slot(self, port):
        pre = port(role="prefill")
        dec = port(role="decode", paged_kv_block=8, prefix_cache=True)
        h = pre.prefill_only(treq(max_new=1), timeout_s=180)
        req = attach_wire(dec, h.to_bytes())
        assert req.output_tokens == [h.first_token]
        assert req.finish_reason == "length"
        assert dec._prefix_table == {}  # never inserted into the pool
        assert dec.kv_ledger.events.get("park", 0) == 0

    def test_prefill_only_rejects_beyond_bucket(self, port):
        pre = port(role="prefill")
        with pytest.raises(ValueError, match="largest bucket"):
            pre.prefill_only(treq(prompt=tuple(range(40))))

    def test_prefill_only_needs_no_free_slot(self, port):
        """A prefill-role engine serves handoffs while every decode slot is
        busy, and writes nothing into its own cache."""
        pre = port(role="prefill", decode_slots=1)
        blocker = pre.submit(treq(prompt=(1, 2, 3), max_new=40))
        h = pre.prefill_only(treq(max_new=4), timeout_s=180)
        assert h is not None and h.n == len(PROMPT)
        assert tuple(h.k.shape) == (CFG.n_layers, len(PROMPT),
                                    CFG.n_kv_heads, CFG.resolved_head_dim)
        blocker.cancelled.set()
        assert blocker.done.wait(60)

    def test_attach_validations(self, port):
        dec = port(role="decode")
        zeros = torch.zeros(KV_SHAPE[:2] + (72,) + KV_SHAPE[3:])

        def handoff(prompt, n, **kw):
            req = treq(prompt=prompt, max_new=2)
            req.sampling = teng.SamplingParams(**kw)
            return tkv.export_handoff(req, zeros, zeros, n=n, first_token=1)

        with pytest.raises(ValueError, match="max_seq_len"):
            dec.attach_prefilled(handoff(tuple(range(70)), 70))
        with pytest.raises(ValueError, match="length/prompt mismatch"):
            dec.attach_prefilled(handoff(PROMPT, 16))
        with pytest.raises(ValueError, match="outside the vocabulary"):
            dec.attach_prefilled(handoff(
                PROMPT, 17, logit_bias={CFG.vocab_size + 7: 1.0}))
        served = dec.attach_prefilled(handoff(PROMPT, 17,
                                              presence_penalty=0.5))
        assert served.done.wait(60) and served.error is None  # penalties
        wrong = handoff(PROMPT, 17)
        wrong.k = wrong.k[1:]  # another model's layer count
        with pytest.raises(ValueError, match="cache layout"):
            dec.attach_prefilled(wrong)
        unscaled = tkv.export_handoff(treq(), zeros, zeros, n=17,
                                      first_token=1, quantize="int8")
        unscaled.v_scale = None
        with pytest.raises(ValueError, match="scales"):
            dec.attach_prefilled(unscaled)
        assert dec.metrics_snapshot()["num_requests_waiting"] == 0

    def test_attach_unknown_adapter_fails_fast(self, port):
        dec = port(role="decode", lora=True)
        zeros = torch.zeros(KV_SHAPE)
        bad = tkv.export_handoff(treq(adapter="no-such-adapter"), zeros,
                                 zeros, n=17, first_token=1)
        with pytest.raises(Exception, match="no-such-adapter"):
            dec.attach_prefilled(bad)

    def test_draining_decode_engine_refuses_attach(self, port):
        pre, dec = port(role="prefill"), port(role="decode")
        h = pre.prefill_only(treq(), timeout_s=180)
        dec.drain(timeout_s=0.1)
        with pytest.raises(teng.EngineDraining):
            dec.attach_prefilled(h)


# ---------------------------------------------------------------------------
# grouped prefill beside hop requests (prefill_batch > 1)
# ---------------------------------------------------------------------------

OTHER = tuple(range(30, 50))  # 20 tokens: PROMPT's bucket (32)


def record_prefills(engine) -> list:
    """Every token row the engine's prefill programs run, padding kept."""
    rows = []
    for name in ("_prefill_impl", "_prefill_many_impl"):
        def recording(tokens, *args, _impl=getattr(engine, name), **kw):
            rows.extend(list(r) for r in np.asarray(tokens))
            return _impl(tokens, *args, **kw)
        setattr(engine, name, recording)
    return rows


def wait_queued(engine, n) -> None:
    deadline = time.monotonic() + 60
    while engine.prefill_queue.qsize() < n:
        assert time.monotonic() < deadline, "requests never queued"
        time.sleep(0.01)


class TestGroupedPrefillBesideHops:
    """A hop request queued behind a same-bucket local request never joins
    that request's grouped prefill: admission's own branch serves it."""

    def test_prefill_only_is_no_follower(self, port):
        pre = port(role="prefill", prefill_batch=4, start=False)
        local = pre.submit(treq(prompt=OTHER, max_new=4))
        out = {}
        hop = threading.Thread(target=lambda: out.update(
            h=pre.prefill_only(treq(max_new=4), timeout_s=180)))
        hop.start()
        wait_queued(pre, 2)
        pre.start()
        hop.join(180)
        h = out["h"]
        assert h is not None and h.n == len(PROMPT)
        assert h.prompt_tokens == list(PROMPT)
        assert local.done.wait(180) and local.error is None
        assert len(local.output_tokens) == 4

    def test_attach_is_no_follower(self, jax_side, port):
        pre = port(role="prefill")
        wire = pre.prefill_only(treq(), timeout_s=180).to_bytes()
        dec = port(role="decode", prefill_batch=4, start=False)
        rows = record_prefills(dec)
        local = dec.submit(treq(prompt=OTHER, max_new=4))
        req = dec.attach_prefilled(tkv.PrefillHandoff.from_bytes(wire))
        dec.start()
        assert req.done.wait(180) and req.error is None, req.error
        assert local.done.wait(180) and local.error is None, local.error
        assert req.output_tokens == collocated(jax_side)
        # One prefill row, the local request's: the attach ran none.
        assert [r[:len(OTHER)] for r in rows] == [list(OTHER)]


# ---------------------------------------------------------------------------
# release and the TTL backstop (admission stepped by hand: deterministic)
# ---------------------------------------------------------------------------


def _step(engine) -> None:
    """One admission pass of the sync loop, on the caller's thread."""
    with torch.no_grad():
        engine._admit_and_insert(pipelined=False)


def park_behind_blockers(dec, wire):
    """On an engine whose loop is not running: blockers take every slot,
    then the attach parks in decode_wait (the abandoned-work position).
    Returns (attached request, blockers)."""
    blockers = [dec.submit(treq(prompt=(1, 2, 3 + i), max_new=40))
                for i in range(dec.cfg.decode_slots)]
    _step(dec)
    assert all(s is not None for s in dec.slots)
    req = dec.attach_prefilled(tkv.PrefillHandoff.from_bytes(wire))
    _step(dec)
    assert [w.request for w in dec.decode_wait] == [req]
    assert req.output_tokens and not req.done.is_set()
    assert dec.metrics_snapshot()["kv_parked_tokens"] == 32
    return req, blockers


def _sweeps(engine):
    return [e["reason"] for e in engine.kv_ledger._ring
            if e["kind"] == "sweep"]


class TestReleaseAndTTL:
    def test_release_request_frees_parked_attach(self, port):
        pre = port(role="prefill")
        dec = port(role="decode", paged_kv_block=8, start=False)
        wire = pre.prefill_only(treq(), timeout_s=180).to_bytes()
        req, _ = park_behind_blockers(dec, wire)
        assert dec.release_request(req.request_id) is True
        _step(dec)
        assert req.done.is_set() and req.finish_reason == "cancelled"
        assert dec.metrics_snapshot()["kv_parked_tokens"] == 0
        assert _sweeps(dec) == ["cancelled"]
        assert dec.release_request(req.request_id) is False  # not live
        assert dec.release_request("no-such-id") is False

    def test_handoff_ttl_sweep_is_the_backstop(self, port):
        """An import parked past the TTL is released with no release call
        (ledger reason "ttl"); a parked prefill-ahead is never swept by
        age, and a TTL of 0 sweeps nothing.  The clock is moved by
        back-dating ``t_parked``."""
        pre = port(role="prefill")
        dec = port(role="decode", paged_kv_block=8, handoff_ttl_s=5.0,
                   start=False)
        wire = pre.prefill_only(treq(), timeout_s=180).to_bytes()
        req, _ = park_behind_blockers(dec, wire)
        local = dec.submit(treq(prompt=(9, 8, 7), max_new=4))
        _step(dec)  # no free slot: prefills ahead and parks
        attach_w, local_w = dec.decode_wait
        assert attach_w.from_handoff and not local_w.from_handoff
        _step(dec)
        assert not req.done.is_set()  # parked for less than the TTL
        attach_w.t_parked -= 10.0
        local_w.t_parked = time.time() - 1e3
        dec.cfg.handoff_ttl_s = 0.0
        _step(dec)
        assert not req.done.is_set()  # 0 disables the sweep
        dec.cfg.handoff_ttl_s = 5.0
        _step(dec)
        assert req.done.is_set() and req.finish_reason == "cancelled"
        assert [w.request for w in dec.decode_wait] == [local]
        assert not local.done.is_set()
        assert _sweeps(dec) == ["ttl"]
        assert dec.metrics_snapshot()["kv_parked_tokens"] == 8  # its bucket

    def test_ledger_conserves_while_an_import_sits_parked(self, port):
        """The KV ledger's block states sum to its budget while handoff KV
        sits parked outside the pool, and after everything drained."""
        pre = port(role="prefill")
        dec = port(role="decode", paged_kv_block=8, prefix_cache=True,
                   start=False)
        wire = pre.prefill_only(treq(max_new=4), timeout_s=180).to_bytes()
        req, blockers = park_behind_blockers(dec, wire)

        def conserved():
            snap = dec.metrics_snapshot()
            snap["model_name"] = "tiny"
            fams = prom_parse.parse_text(tmetrics.render(snap))
            states = {s.labels["state"]: s.value
                      for s in fams["tpu:kv_blocks"]}
            total = fams["tpu:kv_blocks_total"][0].value
            assert abs(sum(states.values()) - total) <= 1, (states, total)
            return states, fams

        states, _ = conserved()
        assert states["parked"] > 0 and states["active"] > 0
        dec.start()
        for r in blockers + [req]:
            assert r.done.wait(120) and r.error is None, r.error
        states, fams = conserved()
        assert states["parked"] == 0 and states["active"] == 0
        events = {s.labels["kind"]: s.value
                  for s in fams["tpu:kv_block_events_total"]}
        assert events.get("park", 0) >= 1 and events.get("unpark", 0) >= 1


# ---------------------------------------------------------------------------
# the three HTTP endpoints
# ---------------------------------------------------------------------------


def _post(url, payload, raw: bytes | None = None, timeout=120):
    data = raw if raw is not None else json.dumps(payload).encode()
    ctype = ("application/octet-stream" if raw is not None
             else "application/json")
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _serve(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return "http://127.0.0.1:%d" % httpd.server_address[1]


@pytest.fixture(scope="module")
def pair(tparams):
    """A prefill-role and a decode-role port server (the same weights)."""
    common = ["--model", "llama3-tiny", "--device", "cpu", "--dtype",
              "float32", "--host", "127.0.0.1", "--port", "0",
              "--decode-slots", "2", "--max-seq-len", "128"]
    made = [api_http.make_server(common + ["--role", "prefill"],
                                 params=tparams),
            api_http.make_server(common + ["--role", "decode",
                                           "--paged-kv-block", "16",
                                           "--prefix-cache"],
                                 params=tparams)]
    urls = [_serve(httpd) for httpd, _, _ in made]
    yield urls
    for httpd, engine, _ in made:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()


BODY = {"prompt": "disaggregate this prompt please", "max_tokens": 8,
        "temperature": 0}


class TestHTTP:
    def test_two_hops_answer_the_collocated_text(self, pair):
        pre, dec = pair
        status, coll, _ = _post(pre + "/v1/completions", BODY)
        assert status == 200
        coll = json.loads(coll)
        status, wire, headers = _post(pre + "/v1/prefill", BODY)
        assert status == 200, wire
        assert headers["Content-Type"] == "application/octet-stream"
        assert headers["x-request-id"]
        assert float(headers["x-prefill-ttft-ms"]) > 0
        status, body, hdrs = _post(dec + "/v1/attach", None, raw=wire)
        assert status == 200, body
        body = json.loads(body)
        assert hdrs["x-request-id"] == headers["x-request-id"]
        assert body["choices"][0]["text"] == coll["choices"][0]["text"]
        assert body["usage"] == coll["usage"]
        with urllib.request.urlopen(dec + "/metrics", timeout=60) as f:
            text = f.read().decode()
        assert 'tpu:pool_role{role="decode"} 1' in text
        count = [line for line in text.splitlines()
                 if line.startswith("tpu:handoff_seconds_count")]
        assert count and float(count[0].split()[-1]) >= 1

    def test_attach_streams_sse(self, pair):
        pre, dec = pair
        _, coll, _ = _post(pre + "/v1/completions", BODY)
        body = dict(BODY, stream=True)
        status, wire, _ = _post(pre + "/v1/prefill", body)
        assert status == 200
        status, raw, headers = _post(dec + "/v1/attach", None, raw=wire)
        assert status == 200
        assert "text/event-stream" in headers["Content-Type"]
        lines = raw.decode().splitlines()
        chunks = [json.loads(line[6:]) for line in lines
                  if line.startswith("data: {")]
        text = "".join(c["choices"][0]["text"] for c in chunks)
        assert text == json.loads(coll)["choices"][0]["text"]
        assert chunks[-1]["usage"]["completion_tokens"] == 8
        assert lines[-2:] == ["data: [DONE]", ""] or lines[-1] == (
            "data: [DONE]")

    @pytest.mark.parametrize("body,status", [
        ({"n": 2}, 422), ({"echo": True}, 422),
        ({"prompt": "x" * 200}, 422),  # beyond the largest bucket (128)
        ({"logprobs": 3}, 200), ({"presence_penalty": 2.5}, 400),
        ({"messages": [{"role": "user", "content": "hi"}], "logprobs": True,
          "top_logprobs": 2}, 200),
        ({"model": "no-such-model"}, 404)],
        ids=["n", "echo", "beyond-bucket", "logprobs", "penalty", "chat",
             "unknown-model"])
    def test_prefill_statuses(self, pair, body, status):
        """Refusals the gateway serves single-hop (any non-200); a body
        with logprobs and a chat body hand off, and the decode hop answers
        their envelope as collocated serving on the prefill pod does."""
        pre, dec = pair
        body = dict(BODY, **body)
        got, wire, _ = _post(pre + "/v1/prefill", body)
        assert got == status, wire
        if status != 200:
            return
        chat = "messages" in body
        _, coll, _ = _post(
            pre + ("/v1/chat/completions" if chat else "/v1/completions"),
            body)
        got, out, _ = _post(dec + "/v1/attach", None, raw=wire)
        assert got == 200, out
        coll, out = json.loads(coll), json.loads(out)
        assert (out["object"], out["usage"]) == (coll["object"],
                                                 coll["usage"])
        a, b = out["choices"][0], coll["choices"][0]
        assert a.keys() == b.keys() and "logprobs" in a
        if chat:
            assert a["message"] == b["message"]
            rows = list(zip(a["logprobs"]["content"],
                            b["logprobs"]["content"]))
            assert len(rows) == 8
            for x, y in rows:
                assert x["token"] == y["token"]
                assert x["logprob"] == pytest.approx(y["logprob"], abs=1e-4)
                assert [t["token"] for t in x["top_logprobs"]] == [
                    t["token"] for t in y["top_logprobs"]]
        else:
            assert a["text"] == b["text"]
            la, lb = a["logprobs"], b["logprobs"]
            assert la["tokens"] == lb["tokens"]
            assert la["text_offset"] == lb["text_offset"]
            np.testing.assert_allclose(la["token_logprobs"],
                                       lb["token_logprobs"], atol=1e-4)
            assert [d.keys() for d in la["top_logprobs"]] == [
                d.keys() for d in lb["top_logprobs"]]

    def test_attach_refusals(self, pair):
        pre, dec = pair
        status, _, _ = _post(dec + "/v1/attach", None, raw=b"LIGKVH1\nxx")
        assert status == 400
        zeros = torch.zeros((CFG.n_layers + 1,) + KV_SHAPE[1:])  # another model
        wrong = tkv.export_handoff(treq(prompt=(1, 2, 3)), zeros, zeros,
                                   n=3, first_token=5)
        status, text, _ = _post(dec + "/v1/attach", None,
                                raw=wrong.to_bytes())
        assert status == 422 and b"cache layout" in text

    def test_release_endpoint(self, tparams):
        """``POST /v1/prefill/release``: a live attach -> released true,
        then (finished) false; unknown ids false; no id 400."""
        dec = teng.Engine(CFG, tparams, teng.EngineConfig(**BASE),
                          eos_id=None, dtype=torch.float32, device="cpu")
        server = api_http.ModelServer(dec, ByteTokenizer(), "llama3-tiny")
        httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                    api_http.make_handler(server))
        url = _serve(httpd)
        try:
            zeros = torch.zeros(KV_SHAPE)
            req = dec.attach_prefilled(tkv.export_handoff(
                treq(), zeros, zeros, n=17, first_token=1))
            body = {"request_id": req.request_id}
            status, text, _ = _post(url + "/v1/prefill/release", body)
            assert status == 200
            assert json.loads(text) == dict(body, released=True)
            _step(dec)
            assert req.finish_reason == "cancelled"
            _, text, _ = _post(url + "/v1/prefill/release", body)
            assert json.loads(text)["released"] is False
            _, text, _ = _post(url + "/v1/prefill/release",
                               {"request_id": "nope"})
            assert json.loads(text)["released"] is False
            status, _, _ = _post(url + "/v1/prefill/release", {"id": 1})
            assert status == 400
        finally:
            httpd.shutdown()
            httpd.server_close()
            dec.stop()

    def test_full_queue_and_draining(self, tparams):
        """429 while the admission queue is full, 503 while draining, on
        both hops (an engine whose loop never runs keeps the queue full)."""
        dec = teng.Engine(CFG, tparams,
                          teng.EngineConfig(**dict(BASE, max_queue=1)),
                          eos_id=None, dtype=torch.float32, device="cpu")
        server = api_http.ModelServer(dec, ByteTokenizer(), "llama3-tiny")
        httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                    api_http.make_handler(server))
        url = _serve(httpd)
        try:
            zeros = torch.zeros(KV_SHAPE)
            wire = tkv.export_handoff(treq(), zeros, zeros, n=17,
                                      first_token=1).to_bytes()
            dec.attach_prefilled(tkv.PrefillHandoff.from_bytes(wire))
            body = {"prompt": "short", "max_tokens": 2}
            assert _post(url + "/v1/attach", None, raw=wire)[0] == 429
            assert _post(url + "/v1/prefill", body)[0] == 429
            dec.drain(timeout_s=0.0)
            assert _post(url + "/v1/attach", None, raw=wire)[0] == 503
            assert _post(url + "/v1/prefill", body)[0] == 503
        finally:
            httpd.shutdown()
            httpd.server_close()
            dec.stop()


# ---------------------------------------------------------------------------
# gateway end to end (subprocesses, real sockets)
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


POOL_YAML = """\
kind: InferencePool
metadata: {{name: {name}, resourceVersion: "1"}}
spec: {{selector: {{app: {name}}}, targetPortNumber: {port}}}
---
kind: InferenceModel
metadata: {{name: llama3-tiny}}
spec: {{modelName: llama3-tiny, criticality: Critical, poolRef: {{name: {name}}}}}
"""


@pytest.fixture(scope="module")
def gateway_stack(tmp_path_factory):
    """Two unchanged gateways with role-tagged membership: one fronts a
    torch prefill pod and a torch decode pod (subprocesses, seed-0 port
    weights), the other a JAX prefill pod (subprocess, the JAX server's
    seed-0 weights) and a torch decode pod holding the same JAX weights
    (in this process)."""
    from tests.test_e2e_local import (
        _launch_module,
        _teardown_procs,
        _wait_http,
    )

    tmp = tmp_path_factory.mktemp("torch_disagg_e2e")
    ports = {k: _free_port() for k in ("tpre", "tdec", "jpre", "gw1", "gw2")}
    torch_common = ["llm_instance_gateway_tpu_torch.server.api_http",
                    "--model", "llama3-tiny", "--device", "cpu", "--dtype",
                    "float32", "--decode-slots", "2", "--max-seq-len", "128",
                    "--host", "127.0.0.1"]
    decode_flags = ["--role", "decode", "--paged-kv-block", "16",
                    "--prefix-cache"]
    procs = []
    inproc = None

    def launch(args, log_name):
        procs.append(_launch_module(args, tmp / log_name, cwd=str(tmp)))

    try:
        launch(torch_common + ["--port", str(ports["tpre"]), "--role",
                               "prefill"], "tpre.log")
        launch(torch_common + ["--port", str(ports["tdec"])] + decode_flags,
               "tdec.log")
        launch(["llm_instance_gateway_tpu.server.api_http", "--model",
                "llama3-tiny", "--platform", "cpu", "--decode-slots", "2",
                "--max-seq-len", "128", "--dtype", "float32", "--port",
                str(ports["jpre"]), "--role", "prefill"], "jpre.log")
        # The JAX server's weights: llama3-tiny from PRNGKey(0), in f32.
        jcfg = dataclasses.replace(JAX_CONFIGS["llama3-tiny"],
                                   max_lora_slots=4)
        jw = jtf.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
        inproc = api_http.make_server(
            torch_common[1:] + ["--port", "0"] + decode_flags,
            params=params_from_numpy(jax.tree.map(np.asarray, jw), "cpu"))
        jdec = _serve(inproc[0])
        for key in ("tpre", "tdec", "jpre"):
            _wait_http(f"http://127.0.0.1:{ports[key]}/health", 120)
        pairs = {"gw1": (f"127.0.0.1:{ports['tpre']}",
                         f"127.0.0.1:{ports['tdec']}"),
                 "gw2": (f"127.0.0.1:{ports['jpre']}", jdec[len("http://"):])}
        for gw, (pre, dec) in pairs.items():
            config = tmp / f"{gw}.yaml"
            config.write_text(POOL_YAML.format(name=f"{gw}-pool",
                                               port=pre.split(":")[1]))
            launch(["llm_instance_gateway_tpu.gateway.proxy", "--config",
                    str(config), "--port", str(ports[gw]),
                    "--pod", f"pre1={pre},role=prefill",
                    "--pod", f"dec1={dec},role=decode"], f"{gw}.log")
        for gw in ("gw1", "gw2"):
            _wait_http(f"http://127.0.0.1:{ports[gw]}/healthz", 120)
        time.sleep(2.0)  # one provider pod-refresh cycle
    except Exception:
        _teardown_procs(procs)
        if inproc is not None:
            inproc[0].shutdown()
            inproc[0].server_close()
            inproc[1].stop()
        raise
    yield {k: f"http://127.0.0.1:{p}" for k, p in ports.items()} | {
        "jdec": jdec}
    _teardown_procs(procs)
    inproc[0].shutdown()
    inproc[0].server_close()
    inproc[1].stop()


E2E_BODY = {"model": "llama3-tiny", "prompt": "disaggregate this prompt please",
            "max_tokens": 8, "temperature": 0}


@pytest.mark.e2e
@pytest.mark.parametrize("gw,pre,dec", [("gw1", "tpre", "tdec"),
                                        ("gw2", "jpre", "jdec")],
                         ids=["torch-prefill", "jax-prefill"])
def test_gateway_two_hops_to_a_torch_decode_pod(gateway_stack, gw, pre, dec):
    """Through the unchanged gateway: ``x-served-by`` names both hops, and
    the text equals collocated serving on the prefill pod and on the
    decode pod."""
    urls = gateway_stack
    texts = []
    for pod in (pre, dec):
        status, body, _ = _post(urls[pod] + "/v1/completions", E2E_BODY)
        assert status == 200, body
        texts.append(json.loads(body)["choices"][0]["text"])
    status, body, headers = _post(urls[gw] + "/v1/completions", E2E_BODY)
    assert status == 200, body
    assert headers.get("x-served-by") == "pre1+dec1", headers
    body = json.loads(body)
    assert body["usage"]["completion_tokens"] == 8
    assert [body["choices"][0]["text"]] * 2 == texts
