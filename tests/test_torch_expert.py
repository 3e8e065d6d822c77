"""Mixtral's experts over the ``expert`` mesh axis in the torch port (the
shard grid of ``parallel/sharding.py``, the expert slices of
``models/transformer.py``'s MoE MLP), held to the JAX package on the CPU
at f32, every shard on the CPU.

- Shard shapes: each leaf's per-shard shape against the local block shape
  of the reference's ``NamedSharding`` for ``param_specs`` at
  ``expert=2``, ``sequence=2`` and ``tensor=2, expert=2`` (dense and int8
  trees, Mixtral-tiny and a GQA model without experts), every sequence
  group included.
- The forward on ``TINY_MOE_TEST`` at ``expert=2`` and ``tensor=2,
  expert=2``: logits within ``tests/test_torch_moe.py``'s tolerance of
  the reference's forward on the dense route (a small decode step), the
  grouped route (a prefill whose tiles do not overflow: no dense mix
  computed), the exact fallback with an overflow forced (a zero router:
  every token ties onto experts 0 and 1), read on the host (prefill) and
  selected on the device (a 16-row decode step), and int8 expert stacks;
  the distinct-device branches (copies, the attention's zero parts in the
  reduction) driven on the CPU.
- Engines: greedy tokens equal to the reference engine's on the same
  routes, and at ``sequence=2, expert=2`` a prompt beyond the largest
  bucket through the ring; an adapter served at ``tensor=2, expert=2``
  as at expert=1; a model without experts on ``expert=2`` served as on
  expert=1; an expert count the axis does not divide refused by name.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_instance_gateway_tpu.models import transformer as jtf
from llm_instance_gateway_tpu.models.configs import TINY_MOE_TEST as JAX_MOE
from llm_instance_gateway_tpu.models.configs import TINY_TEST as JAX_TINY
from llm_instance_gateway_tpu.parallel import mesh as jmesh
from llm_instance_gateway_tpu.parallel import sharding as jsh
from llm_instance_gateway_tpu.server import engine as jeng

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch.models import lora as tlora  # noqa: E402
from llm_instance_gateway_tpu_torch.models import transformer as ttf  # noqa: E402
from llm_instance_gateway_tpu_torch.models.configs import (  # noqa: E402
    TINY_MOE_TEST,
    TINY_TEST,
)
from llm_instance_gateway_tpu_torch.ops.quant import quantize_params  # noqa: E402
from llm_instance_gateway_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from llm_instance_gateway_tpu_torch.parallel import sharding as tsh  # noqa: E402
from llm_instance_gateway_tpu_torch.server import engine as teng  # noqa: E402
from llm_instance_gateway_tpu_torch.server.lora_manager import (  # noqa: E402
    LoRAManager as TLoRA,
)

F32 = torch.float32
# tests/test_torch_moe.py's tolerance.
TOL = 2e-5
GQA = dataclasses.replace(TINY_TEST, n_heads=8, n_kv_heads=4)
JAX_GQA = dataclasses.replace(JAX_TINY, n_heads=8, n_kv_heads=4)
AXES = {"e2": dict(expert=2), "t2e2": dict(tensor=2, expert=2)}


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


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def moe_params(route: str = "balanced", quant: bool = False):
    """Mixtral-tiny's weights: seeded, with a zero router for
    ``route="overflow"`` (every token ties onto experts 0 and 1)."""
    params = ttf.init_params(TINY_MOE_TEST, seed=0, dtype=F32, device="cpu")
    if route == "overflow":
        params["layers"]["router"].zero_()
    return quantize_params(params) if quant else params


@pytest.fixture
def distinct_devices(monkeypatch):
    """Every shard grid takes its shards as on distinct devices, and
    ``torch.cuda.nccl.all_reduce`` is an in-place sum in shard order."""
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
# Shard shapes against the reference's NamedShardings
# ---------------------------------------------------------------------------


def numpy_zeros(tree):
    if isinstance(tree, dict):
        return {k: numpy_zeros(v) for k, v in tree.items()}
    return np.zeros(tuple(tree.shape), np.int8 if tree.dtype == torch.int8
                    else np.float32)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat(v, key + "."))
        else:
            out[key] = tuple(v.shape)
    return out


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("name", ["moe", "gqa"])
@pytest.mark.parametrize("axes", [dict(expert=2), dict(sequence=2),
                                  dict(tensor=2, expert=2)],
                         ids=["e2", "s2", "t2e2"])
def test_param_shard_shapes(axes, name, quant):
    cfg, jcfg = (TINY_MOE_TEST, JAX_MOE) if name == "moe" else (GQA, JAX_GQA)
    params = ttf.init_params(cfg, seed=0, dtype=F32, device="cpu")
    params = quantize_params(params) if quant else params
    jm = ref_mesh(**axes)
    placed = jsh.shard_pytree(numpy_zeros(params), jsh.param_specs(jcfg), jm)
    want = flat(jax.tree.map(lambda x: np.zeros(x.sharding.shard_shape(
        x.shape)), placed))
    grid = tsh.TensorParallel(cfg, port_mesh(**axes))
    sharded = tsh.shard_params(params, grid)
    full = flat(params)
    # The port's by design: embeddings and lm_head whole on every shard,
    # and a replicated KV head's projections whole.
    kv = () if grid.kv_split else ("layers.wk", "layers.wv")
    differ = {k: v for k, v in full.items()
              if (k.split(".")[0] in ("embed", "lm_head") or k.startswith(kv))
              and axes.get("tensor", 1) > 1}
    shards = [tree for group in sharded.groups for tree in group]
    assert len(sharded.groups) == axes.get("sequence", 1)
    assert len(sharded) == (2 * axes.get("tensor", 1)
                            if name == "moe" and "expert" in axes
                            else axes.get("tensor", 1))
    for tree in shards:
        got = flat(tree)
        assert got.keys() == want.keys()
        for leaf, shape in got.items():
            if leaf in differ:
                assert shape == differ[leaf] != want[leaf], leaf
            else:
                assert shape == want[leaf], leaf


def test_expert_shards_hold_their_experts():
    """Shard s holds experts ``expert_offset(s)`` onward, as views of the
    caller's stacks on one device."""
    params = moe_params()
    grid = tsh.TensorParallel(TINY_MOE_TEST, port_mesh(tensor=2, expert=2))
    sharded = tsh.shard_params(params, grid)
    full = params["layers"]["w_down"]  # [L, E, F, D]
    f = full.shape[2] // 2
    for s, tree in enumerate(sharded):
        e0, ti = grid.expert_offset(s), s % 2
        assert e0 == (s // 2) * 4
        want = full[:, e0:e0 + 4, ti * f:(ti + 1) * f]
        got = tree["layers"]["w_down"]
        assert torch.equal(got, want)
        assert got.untyped_storage().data_ptr() == (
            full.untyped_storage().data_ptr())
        assert tree["layers"]["router"] is params["layers"]["router"]


# ---------------------------------------------------------------------------
# The forward against the reference's
# ---------------------------------------------------------------------------

ROUTES = {
    # (params, (B, S) of the prefill, rows of the decode step, input seed)
    "dense": ("balanced", (1, 4), 3, 1),
    "grouped": ("balanced", (2, 16), 16, 7),
    "overflow": ("overflow", (2, 16), 16, 8),
    "int8": ("int8", (2, 16), 16, 7),
}


@pytest.fixture(scope="module")
def reference_forward():
    """Per route: the port's weights, the inputs, and the reference's
    prefill and decode logits on them."""
    memo = {}

    def get(route):
        if route not in memo:
            kind, (b, s), rows, seed = ROUTES[route]
            params = moe_params(kind if kind != "int8" else "balanced",
                                quant=kind == "int8")
            rng = np.random.default_rng(seed)
            tokens = rng.integers(0, TINY_MOE_TEST.vocab_size,
                                  (b, s)).astype(np.int32)
            positions = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
            jp = to_jax(params)
            logits, k, v = jtf.prefill(JAX_MOE, jp, jnp.asarray(tokens),
                                       jnp.asarray(positions))
            dec_tokens = rng.integers(0, TINY_MOE_TEST.vocab_size,
                                      (rows,)).astype(np.int32)
            lens = (np.arange(rows) % s + 1).astype(np.int32)
            cache = jtf.init_decode_cache(JAX_MOE, rows, 32,
                                          dtype=jnp.float32)
            kk = np.asarray(k)[:, np.arange(rows) % b]
            vv = np.asarray(v)[:, np.arange(rows) % b]
            cache["k"] = cache["k"].at[:, :, :s].set(kk)
            cache["v"] = cache["v"].at[:, :, :s].set(vv)
            cache["length"] = jnp.asarray(lens)
            dec, _ = jtf.decode_step(JAX_MOE, jp, cache,
                                     jnp.asarray(dec_tokens),
                                     jnp.asarray(lens))
            memo[route] = (params, tokens, positions, dec_tokens, lens,
                           np.asarray(logits), (kk, vv), np.asarray(dec))
        return memo[route]
    return get


@pytest.mark.parametrize("axes", list(AXES))
@pytest.mark.parametrize("route", list(ROUTES))
def test_forward_matches_reference(reference_forward, monkeypatch, route,
                                   axes):
    (params, tokens, positions, dec_tokens, lens, want_prefill, (kk, vv),
     want_decode) = reference_forward(route)
    grid = tsh.TensorParallel(TINY_MOE_TEST, port_mesh(**AXES[axes]))
    assert grid.moe and grid.local_experts == 4
    sp = tsh.shard_params(params, grid)
    calls = {"dense": 0}
    dense = ttf._moe_dense

    def counted(*args, **kwargs):
        calls["dense"] += 1
        return dense(*args, **kwargs)

    monkeypatch.setattr(ttf, "_moe_dense", counted)
    with torch.no_grad():
        logits, _, _ = ttf.prefill(TINY_MOE_TEST, sp,
                                   torch.from_numpy(tokens).long(),
                                   torch.from_numpy(positions.copy()).long())
    close(logits, want_prefill)
    layers = TINY_MOE_TEST.n_layers * grid.g
    # The prefill reads the overflow flag on the host: the dense mix runs
    # on the dense route and on an overflow only, on every shard.
    assert calls["dense"] == {"dense": layers, "overflow": layers}.get(
        route, 0)
    rows = dec_tokens.shape[0]
    cache = tsh.shard_cache(
        lambda c, d: ttf.init_decode_cache(c, rows, 32, dtype=F32, device=d),
        grid)
    s = tokens.shape[1]
    for row in range(rows):
        ttf.insert_prefill(cache, torch.from_numpy(kk[:, row:row + 1]),
                           torch.from_numpy(vv[:, row:row + 1]), row, s)
    for c in tsh.distinct(list(cache)):
        c["length"].copy_(torch.from_numpy(lens))
    with torch.no_grad():
        dec, _ = ttf.decode_step(TINY_MOE_TEST, sp, cache,
                                 torch.from_numpy(dec_tokens).long(),
                                 torch.from_numpy(lens).long())
    close(dec, want_decode)


def test_overflow_flag_is_global(monkeypatch):
    """The exact fallback's flag comes from every expert's counts: with
    every token on expert 4 (an overflow on expert shard 1) and on one of
    experts 0-3 (within their tiles), expert shard 0 still takes the
    dense branch (read on the host: the dense mix is computed; selected
    on the device: its result), where its own tiles alone would not."""
    cfg = TINY_MOE_TEST
    lp = ttf._layer(moe_params(), 0)
    router = lp["router"].clone()
    router[0, :4], router[0, 4], router[0, 5:] = 0.0, 5.0, -10.0
    router[1:5, :4] = 10.0 * torch.eye(4)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((32, cfg.d_model)).astype(np.float32)
    x[:, 0] = 10.0
    x[:, 1:5] = 5.0 * np.eye(4, dtype=np.float32)[np.arange(32) % 4]
    x = torch.from_numpy(x)
    grid = tsh.TensorParallel(cfg, port_mesh(expert=2))
    shard0 = dict(ttf._layer(tsh.shard_params(moe_params(), grid)[0], 0),
                  router=router, expert_offset=0)
    topi, _ = ttf._route(cfg, shard0, x)
    assert ((topi == 4).any(-1) & (topi.amin(-1) < 4)).all()
    counts = torch.bincount(topi.amin(-1), minlength=4)
    assert counts.max() <= ttf._moe_capacity(cfg, 32) < 32
    dense = ttf._moe_dense(cfg, shard0, x)
    calls = []
    real = ttf._moe_dense
    monkeypatch.setattr(ttf, "_moe_dense",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = ttf._moe_grouped(cfg, shard0, x, True)
    assert calls == [1] and torch.equal(got, dense)
    assert torch.equal(ttf._moe_grouped(cfg, shard0, x, False), dense)
    assert calls == [1, 1]  # the device select computes both, always
    # Drop mode (no flag) computes no dense mix.
    drop = dataclasses.replace(cfg, moe_exact_fallback=False)
    ttf._moe_grouped(drop, shard0, x, True)
    assert calls == [1, 1]


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
def test_forward_distinct_device_branches(distinct_devices, quant):
    params = moe_params(quant=quant)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, TINY_MOE_TEST.vocab_size, (2, 16)))
    positions = torch.arange(16)[None].expand(2, 16).clone()
    with torch.no_grad():
        want = ttf.prefill(TINY_MOE_TEST, params, tokens, positions)
        grid = tsh.TensorParallel(TINY_MOE_TEST,
                                  port_mesh(tensor=2, expert=2))
        assert not grid.one_device
        got = ttf.prefill(TINY_MOE_TEST, tsh.shard_params(params, grid),
                          tokens, positions)
    for g, w in zip(got, want):
        close(g, w, 1e-5)


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

PROMPTS = [[5, 6, 7], [9, 8, 7, 6, 5, 4], list(range(20, 41)),
           list(range(60, 78))]
ENGINES = {
    # route: (params kind, engine config, prompts)
    "dense": ("balanced", dict(decode_slots=4, prefill_buckets=(8,)),
              PROMPTS[:2]),
    "grouped": ("balanced", dict(decode_slots=16, prefill_buckets=(32,)),
                PROMPTS),
    "overflow": ("overflow", dict(decode_slots=16, prefill_buckets=(32,)),
                 PROMPTS),
    "int8": ("int8", dict(decode_slots=16, prefill_buckets=(32,)), PROMPTS),
    # sequence x expert: a prompt beyond the largest bucket, on the pool.
    "ring": ("balanced", dict(decode_slots=2, prefill_buckets=(8, 16),
                              paged_kv_block=8),
             [list(range(3, 43)), PROMPTS[1]]),
}
ROUTE_ENGINES = ["dense", "grouped", "overflow", "int8"]


def serve(eng, prompts, max_new=6, adapters=None):
    """Submit every request before ``start()``, then serve them."""
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


def engine_params(kind):
    return moe_params(kind if kind != "int8" else "balanced",
                      quant=kind == "int8")


@pytest.fixture(scope="module")
def reference_engine():
    """The reference engine's greedy tokens per (route, mesh axes)."""
    memo = {}

    def get(route, axes):
        key = (route, tuple(sorted(axes.items())))
        if key not in memo:
            kind, ecfg, prompts = ENGINES[route]
            eng = jeng.Engine(JAX_MOE, to_jax(engine_params(kind)),
                              jeng.EngineConfig(max_seq_len=64, **ecfg),
                              eos_id=None, dtype=jnp.float32,
                              mesh=ref_mesh(**axes))
            reqs = [jeng.Request(prompt_tokens=list(p), max_new_tokens=6)
                    for p in prompts]
            for r in reqs:
                eng.submit(r)
            eng.start()
            try:
                for r in reqs:
                    assert r.done.wait(300) and r.error is None, r.error
            finally:
                eng.stop()
            memo[key] = [list(r.output_tokens) for r in reqs]
        return memo[key]
    return get


@pytest.mark.parametrize("axes", list(AXES))
@pytest.mark.parametrize("route", ROUTE_ENGINES)
def test_engine_matches_reference(reference_engine, route, axes):
    kind, ecfg, prompts = ENGINES[route]
    want = reference_engine(route, dict(expert=2))
    eng = teng.Engine(TINY_MOE_TEST, engine_params(kind), teng.EngineConfig(
        max_seq_len=64, pipeline_decode=route == "overflow", **ecfg),
        eos_id=None, dtype=F32, device="cpu", mesh=port_mesh(**AXES[axes]))
    assert eng.tp.moe and len(eng.params) == eng.tp.t * 2
    assert serve(eng, prompts) == want


def test_ring_over_expert_shards_matches_reference(reference_engine):
    """``sequence=2, expert=2``: a prompt beyond the largest bucket runs
    the ring with every block's MLP over the expert shards."""
    want = reference_engine("ring", dict(expert=2, sequence=2))
    kind, ecfg, prompts = ENGINES["ring"]
    eng = teng.Engine(TINY_MOE_TEST, engine_params(kind), teng.EngineConfig(
        max_seq_len=64, **ecfg), eos_id=None, dtype=F32, device="cpu",
        mesh=port_mesh(expert=2, sequence=2))
    ring = eng._ring
    calls = []
    eng._ring = lambda *a, **k: calls.append(1) or ring(*a, **k)
    assert serve(eng, prompts) == want
    assert calls == [1]


def test_adapter_at_tensor2_expert2_matches_expert1():
    """An adapter (attention and dense targets; expert stacks take none)
    served over the grid gives the unsharded engine's tokens."""
    rng = np.random.default_rng(11)
    weights = {t: {"a": rng.standard_normal((TINY_MOE_TEST.n_layers, d_in,
                                              3)).astype(np.float32) * 0.1,
                   "b": rng.standard_normal((TINY_MOE_TEST.n_layers, 3,
                                             d_out)).astype(np.float32) * 0.1}
               for t, (d_in, d_out) in tlora.target_dims(
                   TINY_MOE_TEST).items()}
    params = moe_params()
    outs = []
    for mesh in (None, port_mesh(tensor=2, expert=2)):
        manager = TLoRA(TINY_MOE_TEST, dtype=F32, device="cpu")
        manager.load("moe-adapter", weights=weights, alpha=8.0, rank=3)
        eng = teng.Engine(TINY_MOE_TEST, params, teng.EngineConfig(
            decode_slots=4, max_seq_len=64, prefill_buckets=(8, 32)),
            lora_manager=manager, eos_id=None, dtype=F32, device="cpu",
            mesh=mesh)
        outs.append(serve(eng, PROMPTS[:3],
                          adapters=["moe-adapter", None, "moe-adapter"]))
    assert outs[1] == outs[0]


def test_model_without_experts_serves_replicated():
    params = ttf.init_params(GQA, seed=0, dtype=F32, device="cpu")
    outs = []
    for mesh in (None, port_mesh(expert=2), port_mesh(tensor=2, expert=2)):
        eng = teng.Engine(GQA, params, teng.EngineConfig(
            decode_slots=3, max_seq_len=64, prefill_buckets=(8, 32)),
            eos_id=None, dtype=F32, device="cpu", mesh=mesh)
        if mesh is not None:
            assert not eng.tp.moe and len(eng.params) == eng.tp.t
        outs.append(serve(eng, PROMPTS[:3]))
    assert outs[1] == outs[0] and outs[2] == outs[0]


def test_uneven_expert_split_refused_by_name():
    with pytest.raises(ValueError, match="expert=3 does not divide"):
        tsh.TensorParallel(TINY_MOE_TEST, port_mesh(expert=3))
