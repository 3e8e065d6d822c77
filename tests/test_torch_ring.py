"""Ring-attention prefill over the ``sequence`` mesh axis in the torch port
(``parallel/ring_attention.py``, ``parallel/long_context.py``, the
engine's ``_ring_prefill``), held to the JAX package on the CPU at f32,
every shard on the CPU and the reference on its virtual 8-device CPU
mesh.

- Ring attention: the port's ``ring_attention`` against the reference's
  at sequence 2 and 4, causal, with GQA (H:K = 4:1 and 4:2), and not
  causal; the loop that skips the blocks above the diagonal bitwise equal
  to the one that runs them all.
- The sharded prefill: ``make_sharded_prefill``'s logits and K/V against
  the reference's at ``sequence=4`` and ``tensor=2, sequence=4``, with
  mixed LoRA slots, on an MQA and a GQA layout; the distinct-device
  branches (per-group copies, the rotation as a copy) driven on the CPU.
- The engine: a 40-token prompt (buckets ``(8, 16)``, ``max_seq_len``
  64) on ``MeshConfig(tensor=4, sequence=2)`` gives the reference
  engine's greedy tokens on lanes, the paged pool with the prefix cache
  and the int8 pool, in the sync and the pipelined loop, through exactly
  one ring program, no chunk-stream chunk and no prefix registration;
  a prompt the ring cannot take (its padded length beyond
  ``max_seq_len``) still streams; an adapter row through the ring gives
  the covering bucket's tokens; the server flag serves the axis.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_instance_gateway_tpu.models.configs import TINY_TEST as JAX_TINY
from llm_instance_gateway_tpu.parallel import long_context as jlc
from llm_instance_gateway_tpu.parallel import mesh as jmesh
from llm_instance_gateway_tpu.parallel import sharding as jsh
from llm_instance_gateway_tpu.parallel.ring_attention import (
    ring_attention as jring,
)
from llm_instance_gateway_tpu.server import engine as jeng

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch.models import lora as tlora  # noqa: E402
from llm_instance_gateway_tpu_torch.models import transformer as ttf  # noqa: E402
from llm_instance_gateway_tpu_torch.models.configs import TINY_TEST  # noqa: E402
from llm_instance_gateway_tpu_torch.parallel import long_context as tlc  # noqa: E402
from llm_instance_gateway_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from llm_instance_gateway_tpu_torch.parallel import sharding as tsh  # noqa: E402
from llm_instance_gateway_tpu_torch.parallel.ring_attention import (  # noqa: E402
    ring_attention,
    ring_attention_blocks,
)
from llm_instance_gateway_tpu_torch.server import api_http as tapi  # noqa: E402
from llm_instance_gateway_tpu_torch.server import engine as teng  # noqa: E402
from llm_instance_gateway_tpu_torch.server.lora_manager import (  # noqa: E402
    LoRAManager as TLoRA,
)

F32 = torch.float32
# The reference test's own tolerance (tests/test_long_context.py).
TOL = 5e-4
GQA = dataclasses.replace(TINY_TEST, n_heads=8, n_kv_heads=4)
JAX_GQA = dataclasses.replace(JAX_TINY, n_heads=8, n_kv_heads=4)
MODELS = {"mqa": (TINY_TEST, JAX_TINY), "gqa": (GQA, JAX_GQA)}


def port_mesh(**axes):
    cfg = tmesh.MeshConfig(**axes)
    return tmesh.make_mesh(cfg, ["cpu"] * cfg.total)


def ref_mesh(**axes):
    cfg = jmesh.MeshConfig(**axes)
    return jmesh.make_mesh(cfg, devices=jax.devices()[:cfg.total])


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def to_jax(tree):
    return jax.tree.map(jnp.asarray, to_numpy(tree))


def adapter(cfg, seed: int, rank: int = 3):
    rng = np.random.default_rng(seed)
    return {t: {"a": rng.standard_normal((cfg.n_layers, d_in, rank))
                .astype(np.float32) * 0.1,
                "b": rng.standard_normal((cfg.n_layers, rank, d_out))
                .astype(np.float32) * 0.1}
            for t, (d_in, d_out) in tlora.target_dims(cfg).items()}


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.fixture
def distinct_devices(monkeypatch):
    """Every shard grid takes its shards as on distinct devices (copies
    per shard and per sequence group), and ``torch.cuda.nccl.all_reduce``
    is an in-place sum in shard order."""
    init = tsh.TensorParallel.__init__

    def as_distinct(self, cfg, mesh):
        init(self, cfg, mesh)
        self.one_device = False

    def all_reduce(parts):
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        for p in parts:
            p.copy_(total)

    monkeypatch.setattr(tsh.TensorParallel, "__init__", as_distinct)
    monkeypatch.setattr(torch.cuda.nccl, "all_reduce", all_reduce)


# ---------------------------------------------------------------------------
# Ring attention
# ---------------------------------------------------------------------------


def qkv(b, s, h, kv, hd, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))


@pytest.mark.parametrize("kv", [1, 2], ids=["4:1", "4:2"])
@pytest.mark.parametrize("n", [2, 4])
def test_ring_attention_matches_reference(n, kv):
    q, k, v = qkv(2, 32, 4, kv, 16, seed=n * 10 + kv)
    want = jax.jit(lambda q, k, v: jring(q, k, v, ref_mesh(sequence=n)))(
        q, k, v)
    got = ring_attention(*map(torch.from_numpy, (q, k, v)),
                         port_mesh(sequence=n))
    close(got, want)


def test_ring_attention_not_causal_matches_reference():
    q, k, v = qkv(2, 16, 4, 2, 8, seed=3)
    want = jax.jit(lambda q, k, v: jring(q, k, v, ref_mesh(sequence=4),
                                         causal=False))(q, k, v)
    got = ring_attention(*map(torch.from_numpy, (q, k, v)),
                         port_mesh(sequence=4), causal=False)
    close(got, want)


@pytest.mark.parametrize("n", [2, 4])
def test_skipping_blocks_above_the_diagonal_is_exact(n):
    """Blocks wholly above the diagonal add exactly zero: skipping them
    is bitwise the loop that runs them, with the K/V in bf16 too."""
    for dtype in (F32, torch.bfloat16):
        q, k, v = (torch.from_numpy(x).to(dtype)
                   for x in qkv(1, 8 * n, 8, 2, 16, seed=n))
        blocks = [list(x.chunk(n, dim=1)) for x in (q, k, v)]
        skipped = ring_attention_blocks(*blocks)
        full = ring_attention_blocks(*blocks, skip_masked=False)
        for a, b in zip(skipped, full):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The sharded prefill
# ---------------------------------------------------------------------------


def model_params(cfg):
    return ttf.init_params(cfg, seed=0, dtype=F32, device="cpu")


def lora_bufs(cfg):
    bufs = tlora.init_lora_buffers(cfg, dtype=F32, device="cpu")
    tlora.write_adapter(bufs, cfg, 0, adapter(cfg, 1), 8.0, 3)
    return bufs


@pytest.mark.parametrize("name", ["mqa", "gqa"])
@pytest.mark.parametrize("axes", [dict(sequence=4),
                                  dict(tensor=2, sequence=4)],
                         ids=["s4", "t2s4"])
def test_sharded_prefill_matches_reference(name, axes):
    cfg, jcfg = MODELS[name]
    params, bufs = model_params(cfg), lora_bufs(cfg)
    rng = np.random.default_rng(len(axes))
    b, s = 2, 32
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    positions = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    slots = np.array([0, -1], np.int32)

    jm = ref_mesh(**axes)
    jfn = jlc.make_sharded_prefill(jcfg, jm)
    jparams = jsh.shard_pytree(to_jax(params), jsh.param_specs(jcfg), jm)
    st, sp = jlc.shard_inputs(jm, jnp.asarray(tokens), jnp.asarray(positions))
    want = jfn(jparams, st, sp, lora_bufs=to_jax(bufs),
               slot_ids=jnp.asarray(slots))

    tm = port_mesh(**axes)
    grid = tsh.TensorParallel(cfg, tm)
    fn = tlc.make_sharded_prefill(cfg, tm)
    tok, pos = tlc.shard_inputs(tm, torch.from_numpy(tokens).long(),
                                torch.from_numpy(positions.copy()).long())
    assert [t.shape for t in tok] == [(b, s // 4)] * 4
    with torch.no_grad():
        got = fn(tsh.shard_params(params, grid), tok, pos,
                 lora_bufs=tsh.shard_lora(bufs, grid),
                 slot_ids=torch.from_numpy(slots))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        close(g, w)


def test_sharded_prefill_distinct_device_branches(distinct_devices):
    """Per-group copies and the rotation as a copy between devices give
    the one-device result (every device is the CPU here)."""
    cfg = GQA
    params, bufs = model_params(cfg), lora_bufs(cfg)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 16)))
    positions = torch.arange(16)[None].expand(2, 16).clone()
    slots = torch.tensor([0, -1])
    with torch.no_grad():
        want = ttf.prefill(cfg, params, tokens, positions, bufs, slots)
        tm = port_mesh(tensor=2, sequence=2)
        grid = tsh.TensorParallel(cfg, tm)
        assert not grid.one_device
        sp = tsh.shard_params(params, grid)
        assert sp.groups[1][0] is not sp.groups[0][0]
        got = tlc.make_sharded_prefill(cfg, tm)(
            sp, *tlc.shard_inputs(tm, tokens, positions),
            lora_bufs=tsh.shard_lora(bufs, grid), slot_ids=slots)
    for g, w in zip(got, want):
        close(g, w, 1e-5)


def test_sequence_shards_are_views_on_one_device():
    params = model_params(GQA)
    grid = tsh.TensorParallel(GQA, port_mesh(tensor=2, sequence=2))
    sp = tsh.shard_params(params, grid)
    assert len(sp.groups) == 2
    assert all(a is b for a, b in zip(sp.groups[0], sp.groups[1]))
    wq = sp[1]["layers"]["wq"]
    assert wq.data_ptr() != params["layers"]["wq"].data_ptr()
    assert wq.untyped_storage().data_ptr() == (
        params["layers"]["wq"].untyped_storage().data_ptr())


def test_shard_inputs_refuses_a_ragged_split():
    with pytest.raises(ValueError, match="not divisible by sequence=4"):
        tlc.shard_inputs(port_mesh(sequence=4), torch.zeros(1, 10),
                         torch.zeros(1, 10))
    # Blocks for another sequence size are refused by name too.
    m = port_mesh(sequence=2)
    sp = tsh.shard_params(model_params(TINY_TEST),
                          tsh.TensorParallel(TINY_TEST, m))
    tok, pos = tlc.shard_inputs(port_mesh(sequence=4),
                                torch.zeros(1, 16, dtype=torch.long),
                                torch.arange(16)[None])
    with pytest.raises(ValueError, match="sequence=2 takes 2 blocks"):
        tlc.make_sharded_prefill(TINY_TEST, m)(sp, tok, pos)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

PROMPT = [int(x) for x in np.random.RandomState(3).randint(1, 250, size=40)]
SHORT = list(range(5, 17))  # bucketed: one full 8-token block to share
RING_ENGINE = dict(decode_slots=2, max_seq_len=64, prefill_buckets=(8, 16))
MODES = {"lanes": {}, "paged": dict(paged_kv_block=8, prefix_cache=True),
         "int8_pool": dict(paged_kv_block=8, kv_cache_quant="int8")}


def submit_all(eng, prompts, max_new=6, adapters=None):
    """Submit every request before ``start()`` (one admission order),
    then serve them."""
    reqs = [teng.Request(prompt_tokens=list(p), max_new_tokens=max_new,
                         adapter=adapters[i] if adapters else None)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.start()
    try:
        for r in reqs:
            assert r.done.wait(240), "request never finished"
            assert r.error is None, r.error
    finally:
        eng.stop()
    return [list(r.output_tokens) for r in reqs]


def counted(eng) -> dict:
    """Wrap the engine's ring, chunk and prefix-registration entries with
    counters."""
    counts = {"ring": 0, "chunk": 0, "register": 0}

    def wrap(name, key):
        fn = getattr(eng, name)

        def call(*args, **kwargs):
            counts[key] += 1
            return fn(*args, **kwargs)
        setattr(eng, name, call)

    wrap("_ring", "ring")
    wrap("_chunk_fn", "chunk")
    wrap("_prefix_register_row", "register")
    return counts


@pytest.fixture(scope="module")
def reference_tokens():
    """The reference engine's greedy tokens per cache mode, on its
    ``MeshConfig(tensor=4, sequence=2)`` (the ring path)."""
    params = model_params(TINY_TEST)
    memo = {}

    def get(mode):
        if mode not in memo:
            eng = jeng.Engine(JAX_TINY, to_jax(params), jeng.EngineConfig(
                **RING_ENGINE, **MODES[mode]), eos_id=None,
                dtype=jnp.float32, mesh=ref_mesh(tensor=4, sequence=2))
            assert eng._ring is not None and eng._ring_usable(len(PROMPT))
            reqs = [jeng.Request(prompt_tokens=list(p), max_new_tokens=6)
                    for p in (PROMPT, SHORT)]
            for r in reqs:
                eng.submit(r)
            eng.start()
            try:
                for r in reqs:
                    assert r.done.wait(300) and r.error is None, r.error
            finally:
                eng.stop()
            memo[mode] = [list(r.output_tokens) for r in reqs]
        return memo[mode]
    return params, get


@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "pipelined"])
@pytest.mark.parametrize("mode", list(MODES))
def test_ring_engine_matches_reference(reference_tokens, mode, pipelined):
    params, get = reference_tokens
    want = get(mode)
    eng = teng.Engine(TINY_TEST, params, teng.EngineConfig(
        **RING_ENGINE, **MODES[mode], pipeline_decode=pipelined),
        eos_id=None, dtype=F32, device="cpu",
        mesh=port_mesh(tensor=4, sequence=2))
    assert eng._ring_pad == 16 and eng._ring_usable(len(PROMPT))
    counts = counted(eng)
    got = submit_all(eng, [PROMPT, SHORT])
    assert got == want
    assert counts["ring"] == 1 and counts["chunk"] == 0
    # Only the bucketed row calls the registration (a no-op without the
    # prefix cache); with it, the table holds that row's one full block
    # and none of the ring row's four.
    assert counts["register"] == 1
    if mode == "paged":
        assert len(eng._prefix_table) == 1


def test_prompt_the_ring_cannot_take_streams():
    """A prompt whose padded length exceeds ``max_seq_len`` chunk-streams
    on a sequence mesh, with the tokens of the unsharded engine."""
    params = model_params(TINY_TEST)
    prompt = list(range(1, 71))
    cfg = dict(decode_slots=2, max_seq_len=72, prefill_buckets=(8, 32))
    outs = []
    for mesh in (None, port_mesh(sequence=2)):
        eng = teng.Engine(TINY_TEST, params, teng.EngineConfig(**cfg),
                          eos_id=None, dtype=F32, device="cpu", mesh=mesh)
        if mesh is not None:
            assert eng._ring_pad == 32 and not eng._ring_usable(len(prompt))
            counts = counted(eng)
        outs.append(submit_all(eng, [prompt]))
    assert outs[0] == outs[1]
    assert counts["ring"] == 0 and counts["chunk"] == -(-len(prompt) // 32)


@pytest.mark.parametrize("axes", [dict(sequence=2),
                                  dict(tensor=2, sequence=2)],
                         ids=["s2", "t2s2"])
def test_ring_row_with_adapter_matches_covering_bucket(axes):
    """Base and adapter rows through the ring give the tokens of an
    unsharded engine whose bucket covers the prompt."""
    cfg = GQA
    params = model_params(cfg)
    weights = adapter(cfg, 11)
    outs = []
    for mesh, buckets in ((None, (8, 64)), (port_mesh(**axes), (8, 16))):
        manager = TLoRA(cfg, dtype=F32, device="cpu")
        manager.load("ring-adapter", weights=weights, alpha=8.0, rank=3)
        eng = teng.Engine(cfg, params, teng.EngineConfig(
            decode_slots=3, max_seq_len=64, prefill_buckets=buckets),
            lora_manager=manager, eos_id=None, dtype=F32, device="cpu",
            mesh=mesh)
        outs.append(submit_all(eng, [PROMPT, PROMPT, SHORT],
                               adapters=["ring-adapter", None,
                                         "ring-adapter"]))
    assert outs[1] == outs[0]
    assert outs[0][0] != outs[0][1]  # the adapter reached the ring row


def test_server_sequence_flag():
    httpd, eng, _ = tapi.make_server([
        "--device", "cpu", "--dtype", "float32", "--host", "127.0.0.1",
        "--port", "0", "--max-seq-len", "64", "--decode-slots", "2",
        "--prefill-buckets", "8", "16", "--mesh", "tensor=2,sequence=2"])
    try:
        assert eng._ring is not None and eng.tp.n == 2
        assert [str(d) for d in eng.mesh.devices] == ["cpu"] * 4
        counts = counted(eng)
        req = eng.generate(teng.Request(prompt_tokens=PROMPT,
                                        max_new_tokens=3))
        assert req.error is None and len(req.output_tokens) == 3
        assert counts["ring"] == 1 and counts["chunk"] == 0
    finally:
        httpd.server_close()
        eng.stop()
