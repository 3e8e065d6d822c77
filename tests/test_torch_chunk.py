"""Chunk attention and chunk-stream prefill of the torch port against the
JAX reference, on the CPU at f32.

Inputs are made with numpy from a seed.  Tolerances: ops and kernel plain
versions 1e-5 (same math, different summation order and tiling), logits
and cache bytes through the 2-layer ``TINY_TEST`` model 1e-4; greedy token
streams must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_instance_gateway_tpu.models import lora as jlora
from llm_instance_gateway_tpu.models import transformer as jtf
from llm_instance_gateway_tpu.models.configs import TINY_TEST as JAX_TINY
from llm_instance_gateway_tpu.ops import attention as jatt
from llm_instance_gateway_tpu.ops.pallas_attention import chunk_attention_pallas
from llm_instance_gateway_tpu.server import engine as jeng

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch.models import transformer as ttf  # noqa: E402
from llm_instance_gateway_tpu_torch.models.configs import TINY_TEST  # noqa: E402
from llm_instance_gateway_tpu_torch.models.weights import (  # noqa: E402
    lora_from_numpy,
    params_from_numpy,
)
from llm_instance_gateway_tpu_torch.ops import attention as tatt  # noqa: E402
from llm_instance_gateway_tpu_torch.ops import chunk_attention as tch  # noqa: E402
from llm_instance_gateway_tpu_torch.server import engine as teng  # noqa: E402

OPS_ATOL = 1e-5
LOGITS_ATOL = 1e-4


def rnd(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a))


def chunk_inputs(c, s_max, h=4, k=2, hd=128, seed=0):
    rng = np.random.default_rng(seed)
    return rnd(rng, 1, c, h, hd), rnd(rng, 1, s_max, k, hd), rnd(rng, 1, s_max,
                                                                 k, hd)


class TestChunkKernelPlainVersion:
    """The chunk kernel's plain version against the Pallas kernel and the
    reference's XLA op."""

    @pytest.mark.parametrize("start", [0, 64, 128])
    def test_matches_pallas_interpret(self, start):
        q, k, v = chunk_inputs(128, 256, seed=start)
        want = chunk_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.int32(start),
                                      interpret=True)
        got = tch.chunk_attention_reference(t(q), t(k), t(v), start)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=OPS_ATOL)

    @pytest.mark.parametrize("c", [16, 32])
    def test_ragged_chunk_matches_xla_op(self, c):
        # C and S_max off the TPU kernel's 128 tiles: the TPU gate sends
        # them to XLA; on the card the kernel takes them, so its function
        # must hold here.
        q, k, v = chunk_inputs(c, 96, h=4, k=1, hd=16, seed=c)
        want = jatt.xla_chunk_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), 37)
        got = tch.chunk_attention_reference(t(q), t(k), t(v), 37)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=OPS_ATOL)

    def test_pad_queries_past_s_max_match_xla_op(self):
        # A final chunk's pads sit at positions past S_max: they attend the
        # whole lane (garbage the caller ignores), never past it.
        q, k, v = chunk_inputs(32, 96, seed=5)
        want = jatt.xla_chunk_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), 80)
        got = tch.chunk_attention_reference(t(q), t(k), t(v), 80)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=OPS_ATOL)

    def test_garbage_past_reach_is_ignored(self):
        q, k, v = chunk_inputs(16, 64, seed=6)
        clean = tch.chunk_attention_reference(t(q), t(k), t(v), 20)
        k[:, 36:], v[:, 36:] = 1e3, -1e3
        dirty = tch.chunk_attention_reference(t(q), t(k), t(v), 20)
        np.testing.assert_array_equal(clean.numpy(), dirty.numpy())

    def test_port_xla_op_matches_reference_op(self):
        q, k, v = chunk_inputs(24, 80, h=4, k=2, hd=16, seed=7)
        want = jatt.xla_chunk_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), 11)
        got = tatt.xla_chunk_attention(t(q), t(k), t(v), 11)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=OPS_ATOL)

    def test_wrapper_takes_plain_version_on_cpu(self):
        q, k, v = chunk_inputs(16, 48, seed=8)
        before = tch.launches
        got = tch.chunk_attention(t(q), t(k), t(v), 9)
        assert torch.equal(got, tch.chunk_attention_reference(t(q), t(k),
                                                               t(v), 9))
        assert tch.launches == before  # the plain version is no launch

    def test_wrapper_rejects_other_devices(self):
        q = torch.zeros((1, 16, 4, 128), device="meta")
        kv = torch.zeros((1, 64, 2, 128), device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            tch.chunk_attention(q, kv, kv, 0)


# ---------------------------------------------------------------------------
# prefill_with_cache
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    jparams = jtf.init_params(JAX_TINY, jax.random.PRNGKey(0), jnp.float32)
    rng = np.random.default_rng(3)
    jbufs = jlora.init_lora_buffers(JAX_TINY, jnp.float32)
    adapter = {tg: {"a": rnd(rng, 2, di, 2) * 0.3, "b": rnd(rng, 2, 2, do) * 0.3}
               for tg, (di, do) in jlora.target_dims(JAX_TINY).items()}
    jbufs = jlora.load_adapter(jbufs, JAX_TINY, 1, adapter, alpha=4.0, rank=2)
    to_np = jax.tree.map(np.asarray, (jparams, jbufs))
    return (jparams, jbufs, params_from_numpy(to_np[0], "cpu"),
            lora_from_numpy(to_np[1], "cpu"))


def chunks(prompt, chunk):
    for start in range(0, len(prompt), chunk):
        piece = prompt[start:start + chunk]
        toks = np.zeros((chunk,), np.int32)
        toks[:len(piece)] = piece
        yield start, len(piece), toks, start + np.arange(chunk, dtype=np.int32)


class TestPrefillWithCache:
    def test_chunks_reproduce_monolithic_prefill(self, tiny):
        _, _, tparams, _ = tiny
        prompt = list(np.random.default_rng(0).integers(1, 250, 23))
        n = len(prompt)
        want, wk, _ = ttf.prefill(TINY_TEST, tparams, t([prompt]),
                                  t(np.arange(n)[None]))
        cache = ttf.init_decode_cache(TINY_TEST, 2, 64, torch.float32, "cpu")
        for start, c, toks, pos in chunks(prompt, 8):
            last, cache = ttf.prefill_with_cache(
                TINY_TEST, tparams, cache, toks, pos, 1, start + c, c - 1)
        np.testing.assert_allclose(last.numpy(), want[0, n - 1].numpy(),
                                   atol=LOGITS_ATOL)
        np.testing.assert_allclose(cache["k"][:, 1, :n].numpy(),
                                   wk[:, 0].numpy(), atol=LOGITS_ATOL)
        assert int(cache["length"][1]) == n
        assert not cache["k"][:, 0].any()  # other lanes untouched

    def test_lane_bytes_equal_reference_past_s_max(self, tiny):
        """Same chunks through both packages, adapter row included: the
        final chunk's pads run past S_max = 24 (the reference drops those
        writes; the port must skip them), and every lane byte agrees."""
        jparams, jbufs, tparams, tbufs = tiny
        prompt = list(np.random.default_rng(1).integers(1, 250, 23))
        jcache = jtf.init_decode_cache(JAX_TINY, 2, 24, jnp.float32)
        tcache = ttf.init_decode_cache(TINY_TEST, 2, 24, torch.float32, "cpu")
        for start, c, toks, pos in chunks(prompt, 16):
            jl, jcache = jtf.prefill_with_cache(
                JAX_TINY, jparams, jcache, jnp.asarray(toks),
                jnp.asarray(pos), jnp.int32(0), jnp.int32(start + c),
                jnp.int32(c - 1), lora_bufs=jbufs, lora_slot=jnp.int32(1))
            tl, tcache = ttf.prefill_with_cache(
                TINY_TEST, tparams, tcache, toks, pos, 0, start + c, c - 1,
                lora_bufs=tbufs, lora_slot=1)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=LOGITS_ATOL)
        assert pos[-1] >= 24  # the final chunk ran past S_max
        for key in ("k", "v"):
            np.testing.assert_allclose(tcache[key].numpy(),
                                       np.asarray(jcache[key]),
                                       atol=LOGITS_ATOL)
        np.testing.assert_array_equal(tcache["length"].numpy(),
                                      np.asarray(jcache["length"]))

    def test_chunk_write_never_touches_other_cells(self, tiny):
        """Only the chunk's in-bounds positions of its own lane change."""
        _, _, tparams, _ = tiny
        cache = ttf.init_decode_cache(TINY_TEST, 3, 20, torch.float32, "cpu")
        cache["k"].fill_(7.0)
        cache["v"].fill_(7.0)
        pos = 12 + np.arange(16)  # positions 12..27: 20.. are past S_max
        ttf.prefill_with_cache(TINY_TEST, tparams, cache,
                               np.arange(1, 17), pos, 2, 16, 3)
        assert (cache["k"][:, :2] == 7.0).all()
        assert (cache["k"][:, 2, :12] == 7.0).all()
        assert (cache["k"][:, 2, 12:] != 7.0).all()


# ---------------------------------------------------------------------------
# engine: chunk streams
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def params():
    jparams = jtf.init_params(JAX_TINY, jax.random.PRNGKey(0), jnp.float32)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def run(mod, engine, prompts, max_new=6):
    engine.start()
    try:
        reqs = [mod.Request(prompt_tokens=list(p), max_new_tokens=max_new)
                for p in prompts]
        for r in reqs:
            engine.submit(r)
        for r in reqs:
            assert r.done.wait(120) and r.error is None, r.error
        return [r.output_tokens for r in reqs]
    finally:
        engine.stop()


class TestChunkStreams:
    def test_long_prompt_matches_reference_and_bucketed(self, params):
        """A prompt beyond the largest bucket streams through chunks: the
        same greedy tokens as the JAX engine's stream and as a port engine
        whose bucket covers it whole."""
        jparams, tparams = params
        prompt = list(np.random.RandomState(1).randint(1, 250, size=40))
        cfg = dict(decode_slots=2, max_seq_len=96, prefill_buckets=(16,),
                   decode_steps_per_sync=2)
        want = run(jeng, jeng.Engine(JAX_TINY, jparams, jeng.EngineConfig(**cfg),
                                     eos_id=None, dtype=jnp.float32), [prompt])
        got = run(teng, teng.Engine(TINY_TEST, tparams, teng.EngineConfig(**cfg),
                                    eos_id=None, dtype=torch.float32,
                                    device="cpu"), [prompt])
        whole = run(teng, teng.Engine(
            TINY_TEST, tparams,
            teng.EngineConfig(decode_slots=2, max_seq_len=96,
                              prefill_buckets=(64,)),
            eos_id=None, dtype=torch.float32, device="cpu"), [prompt])
        assert got == want == whole

    def test_two_lanes_interleave_with_decode(self, params):
        """Two long prompts stream at once (round-robin) while a short
        request decodes between chunks; every greedy stream equals the
        JAX engine's under the same config."""
        jparams, tparams = params
        rng = np.random.RandomState(2)
        prompts = [[5, 6, 7], list(rng.randint(1, 250, 56)),
                   list(rng.randint(1, 250, 40))]
        cfg = dict(decode_slots=3, max_seq_len=128, prefill_buckets=(8,),
                   decode_steps_per_sync=1, stream_lanes=2)
        want = run(jeng, jeng.Engine(JAX_TINY, jparams,
                                     jeng.EngineConfig(**cfg), eos_id=None,
                                     dtype=jnp.float32), prompts, max_new=24)
        te = teng.Engine(TINY_TEST, tparams, teng.EngineConfig(**cfg),
                         eos_id=None, dtype=torch.float32, device="cpu")
        lanes_seen, decoded_between = [], []
        step = te._stream_step

        def traced_step():
            lanes_seen.append(len(te._streams))
            decoded_between.append(te.total_generated)
            step()

        te._stream_step = traced_step
        got = run(teng, te, prompts, max_new=24)
        assert got == want
        assert max(lanes_seen) == 2  # both long prompts in flight together
        # Decode advanced between chunks (not one blocking burst).
        assert decoded_between[-1] - decoded_between[0] >= 5
        assert te.metrics_snapshot()["stream_lanes_active"] == 0

    def test_cancel_before_admission_runs_no_chunk(self, params):
        _, tparams = params
        te = teng.Engine(TINY_TEST, tparams,
                         teng.EngineConfig(decode_slots=1, max_seq_len=96,
                                           prefill_buckets=(8,)),
                         eos_id=None, dtype=torch.float32, device="cpu")
        req = teng.Request(prompt_tokens=list(range(1, 81)), max_new_tokens=10)
        req.cancelled.set()
        te.start()
        try:
            te.submit(req)
            assert req.done.wait(30)
            assert req.finish_reason == "cancelled" and req.output_tokens == []
        finally:
            te.stop()

    def test_unusable_bucket_config_rejected_at_submit(self, params):
        _, tparams = params
        te = teng.Engine(TINY_TEST, tparams,
                         teng.EngineConfig(decode_slots=1, max_seq_len=32,
                                           prefill_buckets=(64,)),
                         eos_id=None, dtype=torch.float32, device="cpu")
        with pytest.raises(ValueError, match="no usable prefill bucket"):
            te.submit(teng.Request(prompt_tokens=[1, 2], max_new_tokens=2))
