"""The torch port's paged KV pool, prefix cache and paged serving against
the JAX reference, on the CPU at f32 on ``TINY_TEST``.

Inputs are made with numpy from a seed.  Tolerances: ops and the paged
kernel's plain version 1e-5, logits and pool bytes through the 2-layer
model 1e-4 (pools compared outside the trash block, whose garbage is
unspecified); greedy token streams, reuse counters and the KV ledger's
books must be identical.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_instance_gateway_tpu.gateway.metrics_client import families_to_metrics
from llm_instance_gateway_tpu.gateway.types import Metrics
from llm_instance_gateway_tpu.models import lora as jlora
from llm_instance_gateway_tpu.models import paged as jpaged
from llm_instance_gateway_tpu.models import transformer as jtf
from llm_instance_gateway_tpu.models.configs import TINY_TEST as JAX_TINY
from llm_instance_gateway_tpu.ops import attention as jatt
from llm_instance_gateway_tpu.ops.pallas_decode_attention import (
    paged_decode_attention_pallas,
)
from llm_instance_gateway_tpu.server import engine as jeng
from llm_instance_gateway_tpu.server import metrics as jmetrics
from llm_instance_gateway_tpu.server.lora_manager import LoRAManager as JLoRA
from llm_instance_gateway_tpu.utils import prom_parse

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch.models import paged as tpaged  # noqa: E402
from llm_instance_gateway_tpu_torch.models import transformer as ttf  # noqa: E402
from llm_instance_gateway_tpu_torch.models.configs import TINY_TEST  # noqa: E402
from llm_instance_gateway_tpu_torch.models.weights import (  # noqa: E402
    lora_from_numpy,
    params_from_numpy,
)
from llm_instance_gateway_tpu_torch.ops import attention as tatt  # noqa: E402
from llm_instance_gateway_tpu_torch.ops import (  # noqa: E402
    paged_decode_attention as tpd,
)
from llm_instance_gateway_tpu_torch.server import api_http  # noqa: E402
from llm_instance_gateway_tpu_torch.server import engine as teng  # noqa: E402
from llm_instance_gateway_tpu_torch.server import metrics as tmetrics  # noqa: E402
from llm_instance_gateway_tpu_torch.server.lora_manager import (  # noqa: E402
    LoRAManager as TLoRA,
)

OPS_ATOL = 1e-5
LOGITS_ATOL = 1e-4
P = 8  # block size of the model-level tests


def rnd(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the paged decode kernel's plain version
# ---------------------------------------------------------------------------


def pool_inputs(page=16, b=5, m=4, h=8, k=2, hd=128, seed=0):
    rng = np.random.default_rng(seed)
    n_blocks = b * m
    q = rnd(rng, b, h, hd)
    kp, vp = rnd(rng, n_blocks + 1, page, k, hd), rnd(rng, n_blocks + 1, page,
                                                       k, hd)
    tables = (rng.permutation(n_blocks) + 1).reshape(b, m).astype(np.int32)
    tables[1, 1:] = 0  # a short row: the trash block past its end
    lengths = np.array([0, 1, page + page // 2, m * page, 2 * page],
                       np.int32)[:b]
    return q, kp, vp, tables, lengths


class TestPagedKernelPlainVersion:
    def test_matches_pallas_interpret(self):
        """P=16, shuffled tables, the trash block, lengths 0 / 1 /
        mid-block / full."""
        q, kp, vp, tables, lengths = pool_inputs()
        want = paged_decode_attention_pallas(
            *map(jnp.asarray, (q, kp, vp, tables, lengths)), interpret=True)
        got = tpd.paged_decode_attention_reference(
            *map(t, (q, kp, vp, tables, lengths)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=OPS_ATOL)
        assert not got[0].any()  # a length-0 row gives zeros

    def test_entries_past_length_are_never_read(self):
        q, kp, vp, tables, lengths = pool_inputs(seed=1)
        clean = tpd.paged_decode_attention(*map(t, (q, kp, vp, tables,
                                                    lengths)))
        kp[0], vp[0] = 1e3, -1e3  # the trash block
        kp[tables[2, 2]], vp[tables[2, 2]] = 1e3, -1e3  # past row 2's end
        dirty = tpd.paged_decode_attention(*map(t, (q, kp, vp, tables,
                                                    lengths)))
        np.testing.assert_array_equal(clean.numpy(), dirty.numpy())

    def test_gather_pool_rows_matches_reference(self):
        _, kp, _, tables, _ = pool_inputs(seed=2)
        want = jatt.gather_pool_rows(jnp.asarray(kp), jnp.asarray(tables))
        got = tatt.gather_pool_rows(t(kp), t(tables))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        scales = kp[..., 0]  # rank-generic: a [n_blocks+1, P, K] scale pool
        np.testing.assert_array_equal(
            tatt.gather_pool_rows(t(scales), t(tables)).numpy(),
            np.asarray(jatt.gather_pool_rows(jnp.asarray(scales),
                                             jnp.asarray(tables))))

    def test_wrapper_takes_plain_version_on_cpu(self):
        args = tuple(map(t, pool_inputs(seed=3)))
        before = tpd.launches
        got = tpd.paged_decode_attention(*args)
        assert torch.equal(got, tpd.paged_decode_attention_reference(*args))
        assert tpd.launches == before

    def test_scale_pools_take_the_int8_plain_version(self):
        """Scale pools (an int8 pool) are served: on CPU tensors the
        wrapper takes the int8 plain version and launches nothing; a
        missing scale pool raises."""
        q, kp, vp, tables, lengths = map(t, pool_inputs(seed=4))
        kq, ks = ttf._kv_quantize(kp)
        vq, vs = ttf._kv_quantize(vp)
        before = (tpd.launches, tpd.quant_launches)
        got = tpd.paged_decode_attention(q, kq, vq, tables, lengths, ks, vs)
        assert torch.equal(got, tpd.paged_decode_attention_quant_reference(
            q, kq, vq, tables, lengths, ks, vs))
        assert (tpd.launches, tpd.quant_launches) == before
        with pytest.raises(ValueError, match="both scale pools"):
            tpd.paged_decode_attention(q, kq, vq, tables, lengths, ks)
        cache = tpaged.init_paged_cache(TINY_TEST, 2, 32, 8, 8, device="cpu",
                                        quantized=True)
        assert cache["k"].dtype == torch.int8
        assert cache["k_scale"].shape == cache["k"].shape[:-1]


# ---------------------------------------------------------------------------
# models/paged.py against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    jparams = jtf.init_params(JAX_TINY, jax.random.PRNGKey(0), jnp.float32)
    rng = np.random.default_rng(5)
    jbufs = jlora.init_lora_buffers(JAX_TINY, jnp.float32)
    adapter = {tg: {"a": rnd(rng, 2, di, 2) * 0.3, "b": rnd(rng, 2, 2, do) * 0.3}
               for tg, (di, do) in jlora.target_dims(JAX_TINY).items()}
    jbufs = jlora.load_adapter(jbufs, JAX_TINY, 0, adapter, alpha=4.0, rank=2)
    np_tree = jax.tree.map(np.asarray, (jparams, jbufs))
    return (jparams, jbufs, params_from_numpy(np_tree[0], "cpu"),
            lora_from_numpy(np_tree[1], "cpu"))


def assert_pools_close(tcache, jcache, atol=LOGITS_ATOL):
    """Pools agree outside the trash block (block 0)."""
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key][:, 1:].numpy(),
                                   np.asarray(jcache[key])[:, 1:], atol=atol)


def prefilled_pools(tiny):
    """Three prompts (9, 14, 5 tokens) prefilled in one bucket-16 batch and
    inserted into shuffled blocks of a 12-block pool, in both packages."""
    jparams, jbufs, _, _ = tiny
    rng = np.random.default_rng(6)
    lens = (9, 14, 5)
    tokens = np.zeros((3, 16), np.int32)
    positions = np.zeros((3, 16), np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(1, 250, n)
        positions[i, :n] = np.arange(n)
    slots = np.array([-1, 0, -1], np.int32)
    logits, k, v = jtf.prefill(JAX_TINY, jparams, jnp.asarray(tokens),
                               jnp.asarray(positions), lora_bufs=jbufs,
                               slot_ids=jnp.asarray(slots))
    phys = ([7, 2], [11, 4], [9, 0])  # row 2's second bucket block: trash
    tables = np.array([[7, 2, 0, 0], [11, 4, 0, 0], [9, 0, 0, 0]], np.int32)
    jcache = jpaged.init_paged_cache(JAX_TINY, 3, 32, 12, P, jnp.float32)
    tcache = tpaged.init_paged_cache(TINY_TEST, 3, 32, 12, P, torch.float32,
                                     "cpu")
    for i, n in enumerate(lens):
        jcache = jpaged.insert_prefill_paged(
            jcache, k[:, i:i + 1], v[:, i:i + 1], i, jnp.asarray(phys[i]),
            jnp.asarray(tables[i]), n)
        tcache = tpaged.insert_prefill_paged(
            tcache, t(k[:, i:i + 1]), t(v[:, i:i + 1]), i, phys[i],
            tables[i], n)
    first = np.asarray(jnp.argmax(logits[jnp.arange(3), np.array(lens) - 1],
                                  -1), np.int32)
    return jcache, tcache, np.array(lens, np.int32), first, slots


class TestPagedModel:
    def test_insert_prefill_paged_matches_reference(self, tiny):
        jcache, tcache, _, _, _ = prefilled_pools(tiny)
        assert_pools_close(tcache, jcache, atol=0)
        np.testing.assert_array_equal(tcache["tables"].numpy(),
                                      np.asarray(jcache["tables"]))
        np.testing.assert_array_equal(tcache["length"].numpy(),
                                      np.asarray(jcache["length"]))

    def test_decode_step_paged_matches_reference(self, tiny):
        """Four steps, an adapter row and an INACTIVE row: logits and pools
        agree each step, and the inactive row's block never changes (its
        writes go to the trash block)."""
        jparams, jbufs, tparams, tbufs = tiny
        jcache, tcache, pos, cur, slots = prefilled_pools(tiny)
        grown = np.array([[7, 2, 0, 0], [11, 4, 5, 0], [9, 0, 0, 0]], np.int32)
        jcache["tables"] = jnp.asarray(grown)  # row 1 grows past 16
        tcache["tables"] = t(grown)
        active = np.array([True, True, False])
        before = tcache["k"][:, 9].clone()
        for step in range(4):
            jlog, jcache = jpaged.decode_step_paged(
                JAX_TINY, jparams, jcache, jnp.asarray(cur), jnp.asarray(pos),
                lora_bufs=jbufs, slot_ids=jnp.asarray(slots),
                active=jnp.asarray(active))
            tlog, tcache = tpaged.decode_step_paged(
                TINY_TEST, tparams, tcache, t(cur), t(pos), lora_bufs=tbufs,
                slot_ids=t(slots), active=t(active))
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                       atol=LOGITS_ATOL, err_msg=f"step {step}")
            cur = np.asarray(jnp.argmax(jlog, -1), np.int32)
            pos = pos + active
        assert_pools_close(tcache, jcache)
        assert torch.equal(tcache["k"][:, 9], before)

    def test_prefill_with_cache_paged_matches_reference(self, tiny):
        """Two 16-token chunks of a 23-token prompt through a 3-block row
        (span 24): the final chunk's pads past the span go to the trash
        block; logits, pools and lengths agree, adapter row included."""
        jparams, jbufs, tparams, tbufs = tiny
        prompt = np.random.default_rng(7).integers(1, 250, 23)
        table = np.zeros((2, 3), np.int32)
        table[1] = [3, 6, 1]
        jcache = jpaged.init_paged_cache(JAX_TINY, 2, 24, 6, P, jnp.float32)
        tcache = tpaged.init_paged_cache(TINY_TEST, 2, 24, 6, P, torch.float32,
                                         "cpu")
        jcache["tables"] = jnp.asarray(table)
        tcache["tables"] = t(table)
        for start in (0, 16):
            c = min(16, 23 - start)
            toks = np.zeros(16, np.int32)
            toks[:c] = prompt[start:start + c]
            pos = start + np.arange(16, dtype=np.int32)
            jl, jcache = jpaged.prefill_with_cache_paged(
                JAX_TINY, jparams, jcache, jnp.asarray(toks), jnp.asarray(pos),
                jnp.int32(1), jnp.int32(start + c), jnp.int32(c - 1),
                lora_bufs=jbufs, lora_slot=jnp.int32(0))
            tl, tcache = tpaged.prefill_with_cache_paged(
                TINY_TEST, tparams, tcache, toks, pos, 1, start + c, c - 1,
                lora_bufs=tbufs, lora_slot=0)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=LOGITS_ATOL)
        assert_pools_close(tcache, jcache)
        np.testing.assert_array_equal(tcache["length"].numpy(),
                                      np.asarray(jcache["length"]))
        # The chunk path reads what a monolithic prefill computes.
        want, _, _ = ttf.prefill(TINY_TEST, tparams, t(prompt[None]),
                                 t(np.arange(23)[None]),
                                 lora_bufs=tbufs, slot_ids=t([0]))
        np.testing.assert_allclose(tl.numpy(), want[0, 22].numpy(),
                                   atol=LOGITS_ATOL)


# ---------------------------------------------------------------------------
# engine: paged pool and prefix cache against the JAX engine
# ---------------------------------------------------------------------------


def _adapter(seed=0, rank=3):
    rng = np.random.default_rng(seed)
    return {tg: {"a": rng.standard_normal((2, di, rank)).astype(np.float32) * .4,
                 "b": rng.standard_normal((2, rank, do)).astype(np.float32) * .4}
            for tg, (di, do) in jlora.target_dims(JAX_TINY).items()}


@pytest.fixture(scope="module")
def params():
    jparams = jtf.init_params(JAX_TINY, jax.random.PRNGKey(0), jnp.float32)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def engine_cfg(paged=True, n_blocks=None, slots=4, prefix=False, **kw):
    cfg = dict(decode_slots=slots, max_seq_len=64, prefill_buckets=(8, 16),
               paged_kv_block=P if paged else None,
               paged_kv_blocks=n_blocks, prefix_cache=prefix)
    cfg.update(kw)
    return cfg


def port_engine(params, lora=False, **kw):
    tlora = None
    if lora:
        tlora = TLoRA(TINY_TEST, dtype=torch.float32, device="cpu")
        tlora.load("tenant", weights=_adapter(), alpha=6.0, rank=3)
    return teng.Engine(TINY_TEST, params[1], teng.EngineConfig(**engine_cfg(**kw)),
                       lora_manager=tlora, eos_id=None, dtype=torch.float32,
                       device="cpu")


def jax_engine(params, lora=False, **kw):
    jl = None
    if lora:
        jl = JLoRA(JAX_TINY, dtype=jnp.float32)
        jl.load("tenant", weights=_adapter(), alpha=6.0, rank=3)
    return jeng.Engine(JAX_TINY, params[0], jeng.EngineConfig(**engine_cfg(**kw)),
                       lora_manager=jl, eos_id=None, dtype=jnp.float32)


def gen(engine, mod, prompt, max_new=6, adapter=None):
    req = mod.Request(prompt_tokens=list(prompt), max_new_tokens=max_new,
                      adapter=adapter)
    engine.generate(req, timeout_s=120)
    assert req.error is None, req.error
    return req.output_tokens


def gen_all(engine, mod, jobs):
    """Requests one after another (a deterministic allocator history)."""
    engine.start()
    try:
        return [gen(engine, mod, p, m, a) for p, m, a in jobs]
    finally:
        engine.stop()


def wait_usage_zero(engine):
    deadline = time.monotonic() + 10
    while (time.monotonic() < deadline
           and engine.metrics_snapshot()["kv_cache_usage_perc"] > 0):
        time.sleep(0.01)
    return engine.metrics_snapshot()["kv_cache_usage_perc"]


def ledger_books(snap):
    """The KV ledger's deterministic books (timestamps and sync counts
    depend on scrape timing, not on the allocator)."""
    kv = dict(snap["kv_ledger"])
    for key in ("ring", "syncs", "parked_share"):
        kv.pop(key)
    kv["prefixes"] = [{k: v for k, v in e.items() if k != "age_s"}
                      for e in kv["prefixes"]]
    return kv


LONG = tuple((i * 7) % 250 + 1 for i in range(40))  # > bucket 16: streamed


class TestPagedEngineParity:
    def test_paged_equals_lanes_and_reference(self, params):
        jobs = [((5, 6, 7), 8, None), ((11, 3), 8, "tenant"),
                (tuple(range(1, 14)), 8, None), (LONG, 6, "tenant")]
        paged = gen_all(port_engine(params, lora=True), teng, jobs)
        lanes = gen_all(port_engine(params, lora=True, paged=False), teng, jobs)
        ref = gen_all(jax_engine(params, lora=True), jeng, jobs)
        assert paged == lanes == ref

    def test_concurrent_batch_equals_solo(self, params):
        engine = port_engine(params)
        engine.start()
        try:
            solo = [gen(engine, teng, (3 + i, 9), 5) for i in range(4)]
            reqs = [teng.Request(prompt_tokens=[3 + i, 9], max_new_tokens=5)
                    for i in range(4)]
            for r in reqs:
                engine.submit(r)
            assert all(r.done.wait(120) for r in reqs)
            assert [r.output_tokens for r in reqs] == solo
        finally:
            engine.stop()

    def test_prefix_reuse_and_ledger_equal_reference(self, params):
        """One prompt sequence through both prefix-cache engines: the same
        tokens, the same ``prefix_reused_tokens`` after every request and
        the same ledger books — a streamed prompt registering blocks a
        bucketed one reuses, and an adapter's identical tokens never
        sharing the base model's blocks."""
        prefix = list(np.random.RandomState(7).randint(1, 250, size=32))
        jobs = [(prefix + [11, 12, 13, 14, 15], 5, None),  # streamed, cold
                (prefix + [21, 22, 23], 5, None),           # reuses 32
                (prefix[:8] + [31, 32, 33, 34], 5, None),   # bucketed, 8
                (prefix + [21, 22, 23], 5, "tenant"),       # no cross-reuse
                (prefix + [21, 22, 23], 5, "tenant")]       # reuses 32
        out, reused, books = {}, {}, {}
        for name, make, mod in (("port", port_engine, teng),
                                ("ref", jax_engine, jeng)):
            engine = make(params, lora=True, prefix=True, n_blocks=24, slots=3)
            engine.start()
            try:
                out[name], reused[name] = [], []
                for p, m, a in jobs:
                    out[name].append(gen(engine, mod, p, m, a))
                    reused[name].append(engine.prefix_reused_tokens)
                assert wait_usage_zero(engine) == 0.0
                books[name] = ledger_books(engine.metrics_snapshot())
            finally:
                engine.stop()
        assert out["port"] == out["ref"]
        assert reused["port"] == reused["ref"] == [0, 32, 40, 40, 72]
        assert books["port"] == books["ref"]
        states = books["port"]["states"]
        assert sum(states.values()) == books["port"]["blocks_total"]
        assert states["prefix_resident"] > 0 and states["active"] == 0


class TestPagedPool:
    def test_oversubscribed_pool_backpressures_admission(self, params):
        prompts = [(5, 6, 7), (8, 9), (1, 2, 3, 4)]
        want = gen_all(port_engine(params), teng,
                       [(p, 6, None) for p in prompts])
        tight = port_engine(params, n_blocks=6, slots=4)
        tight.start()
        try:
            reqs = [teng.Request(prompt_tokens=list(p), max_new_tokens=6)
                    for p in prompts]
            for r in reqs:
                tight.submit(r)
            assert all(r.done.wait(120) for r in reqs)
            assert [r.error for r in reqs] == [None, None, None]
            assert [r.output_tokens for r in reqs] == want
        finally:
            tight.stop()

    def test_finish_at_prefill_frees_blocks(self, params):
        tight = port_engine(params, n_blocks=2)
        tight.start()
        try:
            assert len(gen(tight, teng, [1, 2, 3], 1)) == 1
            assert wait_usage_zero(tight) == 0.0
            assert len(gen(tight, teng, (4, 5, 6), 6)) == 6  # pool reusable
        finally:
            tight.stop()

    def test_prompt_larger_than_pool_rejected_at_submit(self, params):
        tight = port_engine(params, n_blocks=2)
        with pytest.raises(ValueError, match="KV blocks"):
            tight.submit(teng.Request(prompt_tokens=list(range(1, 30))))

    def test_pool_exhaustion_fails_growing_request_cleanly(self, params):
        tight = port_engine(params, n_blocks=2, slots=2)
        tight.start()
        try:
            doomed = teng.Request(prompt_tokens=[1, 2, 3], max_new_tokens=30)
            tight.submit(doomed)
            assert doomed.done.wait(120)
            assert "kv pool exhausted" in (doomed.error or "")
            assert len(gen(tight, teng, (4, 5), 6)) == 6
        finally:
            tight.stop()

    def test_stream_holds_blocks_against_competitors(self, params):
        """A streamed prompt allocates its whole prompt's blocks at
        admission: short requests admitted between its chunks never drain
        the pool under it."""
        engine = port_engine(params, n_blocks=16, slots=2,
                             prefill_buckets=(8,))
        engine.start()
        try:
            long_req = teng.Request(prompt_tokens=list(range(1, 41)),
                                    max_new_tokens=4)
            engine.submit(long_req)
            shorts = [engine.submit(teng.Request(prompt_tokens=[3 + i, 5, 7],
                                                 max_new_tokens=6))
                      for i in range(6)]
            for r in [long_req] + shorts:
                assert r.done.wait(120) and r.error is None, r.error
            assert len(long_req.output_tokens) == 4
        finally:
            engine.stop()

    def test_sync_tables_copies_the_host_table(self, params):
        """The device table is a COPY of the allocator's host table: a host
        edit after a sync, or an in-place write to the device table, must
        not reach the other side (on the CPU ``torch.from_numpy`` would
        share the buffer)."""
        engine = port_engine(params)
        engine._tables_host[0, 0] = 5
        engine._tables_dirty = True
        engine._sync_tables()
        engine._tables_host[0, 0] = 9
        assert int(engine.cache["tables"][0, 0]) == 5
        engine.cache["tables"][1, 0] = 3
        assert engine._tables_host[1, 0] == 0

    def test_eviction_under_pressure_keeps_serving(self, params):
        engine = port_engine(params, prefix=True, n_blocks=12, slots=2)
        engine.start()
        try:
            for seed in range(7):  # 7 x 2 cached blocks > 12 in the pool
                prompt = np.random.RandomState(100 + seed).randint(1, 250, 24)
                assert len(gen(engine, teng, prompt, 3)) == 3
            snap = engine.metrics_snapshot()
            assert snap["kv_cache_usage_perc"] == 0.0  # cached blocks count free
            assert snap["kv_ledger"]["events"]["evict"] > 0
        finally:
            engine.stop()

    def test_admit_gate_accounts_for_pinning_matched_evictables(self, params):
        prefix = list(np.random.RandomState(13).randint(1, 250, size=16))
        engine = port_engine(params, prefix=True, n_blocks=6, slots=2)
        engine.start()
        try:
            gen(engine, teng, prefix + [7], 1)  # registers 2 full blocks
        finally:
            engine.stop()
        b = prefix + [8]  # needs 3 blocks, 2 matched
        held, engine._free_blocks = engine._free_blocks, []
        assert not engine._paged_can_admit(len(b), b, None)
        engine._free_blocks = held[:1]
        assert engine._paged_can_admit(len(b), b, None)

    def test_concurrent_shared_prefix_refcounts(self, params):
        prefix = list(np.random.RandomState(9).randint(1, 250, size=32))
        engine = port_engine(params, prefix=True, n_blocks=24, slots=3)
        engine.start()
        try:
            gen(engine, teng, prefix + [1, 2], 3)  # populate the cache
            a = engine.submit(teng.Request(prompt_tokens=prefix + [3, 4],
                                           max_new_tokens=24))
            b = engine.submit(teng.Request(prompt_tokens=prefix + [5, 6],
                                           max_new_tokens=3))
            assert b.done.wait(120) and b.error is None
            assert a.done.wait(120) and a.error is None
            assert len(a.output_tokens) == 24
            assert wait_usage_zero(engine) == 0.0
            led = engine.metrics_snapshot()["kv_ledger"]
            assert sum(led["states"].values()) == led["blocks_total"]
        finally:
            engine.stop()


class TestPagedExposition:
    @pytest.fixture(scope="class")
    def snaps(self, params):
        snaps = {}
        jobs = [((5, 6, 7, 8, 9, 10, 11, 12, 13), 4, None),
                ((5, 6, 7, 8, 9, 10, 11, 12, 14), 4, None)]
        for name, make, mod in (("port", port_engine, teng),
                                ("ref", jax_engine, jeng)):
            engine = make(params, prefix=True, n_blocks=24, slots=3)
            engine.start()
            try:
                for p, m, a in jobs:
                    gen(engine, mod, p, m, a)
                snaps[name] = engine.metrics_snapshot()
            finally:
                engine.stop()
        return snaps

    def test_metrics_snapshot_keys_equal_reference(self, snaps):
        assert set(snaps["port"]) == set(snaps["ref"])
        assert set(snaps["port"]["kv_ledger"]) == set(snaps["ref"]["kv_ledger"])

    def test_kv_families_equal_reference_and_parse(self, snaps):
        def families(text):
            return {line.split()[2] for line in text.splitlines()
                    if line.startswith("# TYPE tpu:kv_")
                    or line.startswith("# TYPE tpu:prefix_")}

        port_text = tmetrics.render({**snaps["port"], "model_name": "tiny"})
        ref_text = jmetrics.render({**snaps["ref"], "model_name": "tiny"})
        assert families(port_text) == families(ref_text)
        assert {"tpu:kv_blocks", "tpu:kv_block_events_total",
                "tpu:kv_prefix_hits_total", "tpu:prefix_reused_tokens",
                "tpu:kv_free_run_blocks"} <= families(port_text)
        metrics, errs = families_to_metrics(prom_parse.parse_text(port_text),
                                            Metrics())
        assert errs == []
        assert metrics.kv_tokens_capacity == 24 * P


class TestServerFlags:
    @pytest.mark.parametrize("argv,message", [
        (["--paged-kv-blocks", "8"], "requires --paged-kv-block"),
        (["--prefix-cache"], "requires --paged-kv-block"),
        (["--device", "cuda", "--paged-kv-block", "24"], "multiple of 16")])
    def test_flag_checks(self, argv, message, capsys):
        with pytest.raises(SystemExit):
            api_http.make_server(argv)
        assert message in capsys.readouterr().err

    def test_paged_server_serves_debug_kv(self, params):
        httpd, engine, args = api_http.make_server([
            "--device", "cpu", "--dtype", "float32", "--model", "llama3-tiny",
            "--max-seq-len", "128", "--paged-kv-block", "16",
            "--prefix-cache", "--stream-lanes", "2", "--port", "0",
            "--host", "127.0.0.1"])
        try:
            assert (args.paged_kv_block, args.stream_lanes) == (16, 2)
            assert engine.paged and engine.cfg.prefix_cache
            server = api_http.ModelServer(engine, None, "llama3-tiny")
            prompt = list(range(1, 40))
            for tail in (40, 41):
                gen(engine, teng, prompt + [tail], 3)
            status, body = server.debug_kv()
            assert status == 200 and body["model"] == "llama3-tiny"
            assert body["block_tokens"] == 16
            assert body["events"]["reuse_hit"] == 1
            text = server.metrics_text()
            assert "tpu:prefix_reused_tokens 32" in text
            assert 'tpu:kv_blocks{state="prefix_resident"}' in text
        finally:
            httpd.server_close()
            engine.stop()

    def test_lane_server_has_no_debug_kv(self, params):
        engine = port_engine(params, paged=False)
        with pytest.raises(api_http.HTTPError) as err:
            api_http.ModelServer(engine, None, "tiny").debug_kv()
        assert err.value.status == 404
