"""Head layouts that ``mesh_supports`` refuses, served on a tensor mesh
by the torch port through its head plan (``ops/sharded_attention.
head_plan``: KV heads replicated over the shards that share them, query
groups and KV heads padded with zero heads, every shard's kernel call
group-aligned), held to the JAX package on the CPU at f32 with every
shard on the CPU.  The reference serves these layouts on its virtual
8-device CPU mesh through XLA attention.

Layouts:

- 14:2 (``TINY_QWEN_TEST``'s widths, seeded non-zero q/k/v biases) at
  tensor=4 (4:1 a shard, each KV head on two shards, each group of 7
  padded to 8) and tensor=8 (2:1, each KV head on four shards, 7 -> 8);
- 8:4 (``TINY_TEST``'s widths) at tensor=8 (1:1, each KV head on two
  shards, no padding);
- 6:3 (``TINY_TEST``'s) at tensor=2 (4:2 a shard: the fourth KV head is
  a zero head, with its two zero query heads).

Cases: the plan and the sharded weights (zero columns and ``wo`` rows at
zero heads); the sharded prefill, lane and paged decode, extend and
chunk logits against the unsharded forward and the JAX package's prefill
and decode, dense and int8 (weights and KV), with mixed LoRA slots; the
engine's greedy tokens against the JAX package's mesh engine on lanes
with an adapter and a chunk-streamed prompt, on the paged pool with the
prefix cache and on int8 lanes; an adapter hot-swapped at run time; a hop
from tensor=4 (the wire in tensor=1's layout, the attach filling every
replica); 6:3 at ``sequence=2, tensor=2`` (the ring) against the
reference's engine there and the port's ``sequence=1``; 14:2 at tensor=4
over two processes against one; and a planted non-zero ``wo`` row at a
zero head, which the logits check must catch.  Training on these layouts
is ``tests/test_torch_layouts_train.py``'s.

Tolerances: logits within ``ATOL`` (1e-5, f32 summation order); after a
step that writes an int8 KV cache within ``INT8_KV_ATOL`` (2e-3: a value
at a rounding boundary may quantize one step apart between the sharded
and unsharded K/V, ``tests/test_torch_mesh.py``'s reason); greedy tokens
exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_instance_gateway_tpu.models import transformer as jtf
from llm_instance_gateway_tpu.models.configs import TINY_QWEN_TEST as JAX_QWEN
from llm_instance_gateway_tpu.models.configs import TINY_TEST as JAX_TINY
from llm_instance_gateway_tpu.ops import sharded_attention as jsa
from llm_instance_gateway_tpu.parallel import mesh as jmesh
from llm_instance_gateway_tpu.server import engine as jeng
from llm_instance_gateway_tpu.server.lora_manager import LoRAManager as JLoRA

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch.models import lora as tlora  # noqa: E402
from llm_instance_gateway_tpu_torch.models import paged as tpaged  # noqa: E402
from llm_instance_gateway_tpu_torch.models import transformer as ttf  # noqa: E402
from llm_instance_gateway_tpu_torch.models.configs import (  # noqa: E402
    TINY_QWEN_TEST,
    TINY_TEST,
)
from llm_instance_gateway_tpu_torch.ops import sharded_attention as tsa  # noqa: E402
from llm_instance_gateway_tpu_torch.ops.quant import quantize_params  # noqa: E402
from llm_instance_gateway_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from llm_instance_gateway_tpu_torch.parallel import multihost_check  # noqa: E402
from llm_instance_gateway_tpu_torch.parallel import sharding as tsh  # noqa: E402
from llm_instance_gateway_tpu_torch.server import engine as teng  # noqa: E402
from llm_instance_gateway_tpu_torch.server import kv_transfer as tkv  # noqa: E402
from llm_instance_gateway_tpu_torch.server.lora_manager import (  # noqa: E402
    LoRAManager as TLoRA,
)

F32 = torch.float32
ATOL = 1e-5
INT8_KV_ATOL = 2e-3

# name -> (port cfg, JAX cfg); the tensor sizes each serves at.
MODELS = {
    "14:2": (dataclasses.replace(TINY_QWEN_TEST, n_heads=14, n_kv_heads=2),
             dataclasses.replace(JAX_QWEN, n_heads=14, n_kv_heads=2)),
    "8:4": (dataclasses.replace(TINY_TEST, n_heads=8, n_kv_heads=4),
            dataclasses.replace(JAX_TINY, n_heads=8, n_kv_heads=4)),
    "6:3": (dataclasses.replace(TINY_TEST, n_heads=6, n_kv_heads=3),
            dataclasses.replace(JAX_TINY, n_heads=6, n_kv_heads=3)),
}
LAYOUTS = [("14:2", 4), ("14:2", 8), ("8:4", 8), ("6:3", 2)]
IDS = [f"{name}-t{t}" for name, t in LAYOUTS]
# The plan each layout must get: (query heads, KV heads) per shard.
PLANS = {
    ("14:2", 4): (((0, 1, 2, 3), (4, 5, 6, -1), (7, 8, 9, 10),
                   (11, 12, 13, -1)), ((0,), (0,), (1,), (1,))),
    ("14:2", 8): (((0, 1), (2, 3), (4, 5), (6, -1), (7, 8), (9, 10),
                   (11, 12), (13, -1)), ((0,),) * 4 + ((1,),) * 4),
    ("8:4", 8): (tuple((s,) for s in range(8)),
                 tuple((s // 2,) for s in range(8))),
    ("6:3", 2): (((0, 1, 2, 3), (4, 5, -1, -1)), ((0, 1), (2, -1))),
}


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


def model_params(cfg, quant: bool = False):
    params = ttf.init_params(cfg, seed=0, dtype=F32, device="cpu")
    if cfg.attention_bias:  # non-zero biases, so a mis-split shows
        g = torch.Generator().manual_seed(5)
        for name in ("wq_b", "wk_b", "wv_b"):
            leaf = params["layers"][name]
            leaf.copy_(torch.randn(leaf.shape, generator=g) * 0.5)
    return quantize_params(params) if quant else params


def adapter(cfg, seed: int, rank: int = 3):
    rng = np.random.default_rng(seed)
    return {t: {"a": rng.standard_normal((cfg.n_layers, d_in, rank))
                .astype(np.float32) * 0.1,
                "b": rng.standard_normal((cfg.n_layers, rank, d_out))
                .astype(np.float32) * 0.1}
            for t, (d_in, d_out) in tlora.target_dims(cfg).items()}


def lora_bufs(cfg):
    bufs = tlora.init_lora_buffers(cfg, dtype=F32, device="cpu")
    tlora.write_adapter(bufs, cfg, 0, adapter(cfg, 1), 8.0, 3)
    tlora.write_adapter(bufs, cfg, 1, adapter(cfg, 2), 4.0, 3)
    return bufs


def close(a, b, atol=ATOL, scaled=False):
    a = a.detach().float().cpu()
    b = b.detach().float().cpu()
    assert a.shape == b.shape
    err = (a - b).abs().max().item()
    if scaled:
        atol *= max(1.0, b.abs().max().item())
    assert err <= atol, err


def heads_of(x, axis, heads, hd):
    """The full tree's ``x`` at ``heads`` along ``axis`` (zeros at -1)."""
    parts = [x.narrow(axis, h * hd, hd) if h >= 0
             else torch.zeros_like(x.narrow(axis, 0, hd)) for h in heads]
    return torch.cat(parts, dim=axis)


# ---------------------------------------------------------------------------
# The plan and the sharded weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,t", LAYOUTS, ids=IDS)
def test_head_plan(name, t):
    """The plan's local config, each shard's heads (``PLANS``) and the
    reference's gate (which refuses every one of these layouts for its
    kernels); every real query head held once, on a shard whose local KV
    head is its group's; the sharded weights zero at zero heads and the
    full tree's columns (``wo`` rows) elsewhere, LoRA ``b`` / ``o_a``
    too."""
    cfg, jcfg = MODELS[name]
    tp = tsh.TensorParallel(cfg, port_mesh(tensor=t))
    assert not tsa.mesh_supports(cfg, port_mesh(tensor=t))
    assert not jsa.mesh_supports(jcfg, ref_mesh(tensor=t))
    assert not tp.plan.contiguous
    assert (tp.plan.q_heads, tp.plan.kv_heads) == PLANS[name, t]
    h, k = cfg.n_heads, cfg.n_kv_heads
    g = h // k
    assert (tp.cfg.n_heads, tp.cfg.n_kv_heads) == (
        len(PLANS[name, t][0][0]), len(PLANS[name, t][1][0]))
    held = [q for heads in tp.plan.q_heads for q in heads if q >= 0]
    assert sorted(held) == list(range(h))
    local_g = tp.cfg.n_heads // tp.cfg.n_kv_heads
    for qs, kvs in zip(tp.plan.q_heads, tp.plan.kv_heads):
        for j, q in enumerate(qs):
            if q >= 0:
                assert q // g == kvs[j // local_g]
    params = model_params(cfg)
    hd = cfg.resolved_head_dim
    bufs = lora_bufs(cfg)
    sp, sl = tsh.shard_params(params, tp), tsh.shard_lora(bufs, tp)
    lay = params["layers"]
    for s, (tree, lt) in enumerate(zip(sp, sl)):
        q, kv = tp.plan.q_heads[s], tp.plan.kv_heads[s]
        for leaf, axis, heads in (("wq", -1, q), ("wo", -2, q),
                                  ("wk", -1, kv), ("wv", -1, kv)):
            assert torch.equal(tree["layers"][leaf],
                               heads_of(lay[leaf], axis, heads, hd)), leaf
        if cfg.attention_bias:
            for leaf, heads in (("wq_b", q), ("wk_b", kv), ("wv_b", kv)):
                assert torch.equal(tree["layers"][leaf],
                                   heads_of(lay[leaf], -1, heads, hd))
        for key, axis, heads in (("q_b", -1, q), ("o_a", -2, q),
                                 ("k_b", -1, kv), ("v_b", -1, kv)):
            assert torch.equal(lt[key], heads_of(bufs[key], axis, heads, hd))
    # Shards on one device that hold the same KV heads share one cache.
    cache = tsh.shard_cache(lambda c, d: ttf.init_decode_cache(
        c, 2, 16, dtype=F32, device=d), tp)
    by_heads = {}
    for s, c in enumerate(cache):
        assert by_heads.setdefault(tp.plan.kv_heads[s], c) is c
    assert len(tsh.distinct(list(cache))) == len(set(tp.plan.kv_heads))


def test_qwen_7b_plan_at_tensor8():
    """Qwen2.5-7B's 28:4 at tensor=8: 4:1 a shard, each KV head on two
    shards, each group of 7 padded to 8 (the preset the smoke serves)."""
    from llm_instance_gateway_tpu_torch.models.configs import CONFIGS

    plan = tsa.head_plan(CONFIGS["qwen2.5-7b"], 8)
    assert (plan.n_heads, plan.n_kv_heads, plan.replicas) == (4, 1, 2)
    assert plan.q_heads[1] == (4, 5, 6, -1) and plan.kv_heads[7] == (3,)
    for preset, cfg in CONFIGS.items():
        for t in (1, 2, 4, 8):
            assert tsa.head_plan(cfg, t).contiguous == tsa.mesh_supports(
                cfg, port_mesh(tensor=t)), (preset, t)


# ---------------------------------------------------------------------------
# The sharded forward
# ---------------------------------------------------------------------------

B, S, C = 3, 12, 5
SLOTS = [0, -1, 1]
LENS = [12, 7, 9]


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, 300, (B, S)))
    positions = torch.arange(S)[None].expand(B, S).clone()
    return tokens, positions


def _prefilled(cfg, params, k, v, quant, paged):
    """A cache (lanes or pool) holding each row's prompt KV, through the
    insert seam (``tests/test_torch_mesh.py``'s)."""
    tp = params.tp if isinstance(params, tsh.Shards) else None

    def make(c, d):
        if paged:
            return tpaged.init_paged_cache(c, B, 32, 12, 16, dtype=F32,
                                           device=d, quantized=quant)
        return ttf.init_decode_cache(c, B, 32, dtype=F32, device=d,
                                     quantized=quant)
    cache = make(cfg, "cpu") if tp is None else tsh.shard_cache(make, tp)
    for row in range(B):
        kr, vr = k[:, row:row + 1], v[:, row:row + 1]
        if paged:
            table = [1 + 2 * row, 2 + 2 * row]
            tpaged.insert_prefill_paged(cache, kr, vr, row, table[:1],
                                        table, LENS[row])
        else:
            ttf.insert_prefill(cache, kr, vr, row, LENS[row])
    return cache


def check_cache(full, sharded):
    """Every shard cache holds its real heads of the unsharded cache, and
    zeros at its zero heads (an int8 zero's scale at most the 1e-8
    floor)."""
    for c, heads in tsh.kv_parts(sharded):
        n = heads.stop - heads.start
        for name in full:
            x = full[name]
            if name in ("tables", "length"):
                assert torch.equal(c[name], x), name
                continue
            got = c[name]
            pad = got[:, :, :, n:].float().abs()
            if pad.numel():
                floor = 1e-8 if name.endswith("_scale") else 0.0
                assert pad.max() <= floor, name
            if x.dtype == torch.int8:
                diff = (got[:, :, :, :n].int() - x[:, :, :, heads].int())
                assert diff.abs().max() <= 1, name
            else:
                close(got[:, :, :, :n], x[:, :, :, heads], scaled=True)


@pytest.fixture(scope="module")
def jax_logits(inputs):
    """The JAX package's prefill and decode logits per (model, quant) on
    the same weights and adapter buffers (unsharded: the reference's mesh
    serves these layouts through XLA attention, the same function)."""
    tokens, positions = inputs
    memo = {}

    def get(name, quant):
        if (name, quant) not in memo:
            cfg, jcfg = MODELS[name]
            jp = to_jax(model_params(cfg, quant))
            jl = to_jax(lora_bufs(cfg))
            slots = jnp.asarray(SLOTS, jnp.int32)
            toks = jnp.asarray(tokens.numpy(), jnp.int32)
            pos = jnp.asarray(positions.numpy(), jnp.int32)
            logits, k, v = jtf.prefill(jcfg, jp, toks, pos, jl, slots)
            cache = jtf.init_decode_cache(jcfg, B, 32, dtype=jnp.float32)
            cache["k"] = cache["k"].at[:, :, :S].set(k)
            cache["v"] = cache["v"].at[:, :, :S].set(v)
            cache["length"] = jnp.asarray(LENS, jnp.int32)
            dec, _ = jtf.decode_step(jcfg, jp, cache, toks[:, -1],
                                     jnp.asarray(LENS, jnp.int32), jl, slots)
            memo[name, quant] = (np.asarray(logits), np.asarray(dec))
        return memo[name, quant]
    return get


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("name,t", LAYOUTS, ids=IDS)
def test_sharded_forward(inputs, jax_logits, name, t, quant):
    """Prefill, one decode step (lanes and pool, a row inactive), the
    extend verify and a chunk at the layout against the unsharded forward
    on the same weights, mixed LoRA slots, int8 weights and KV under
    ``quant``; prefill and lane decode logits against the JAX package's
    (dense KV: its decode reads a dense cache)."""
    tokens, positions = inputs
    cfg, _ = MODELS[name]
    params, lora = model_params(cfg, quant), lora_bufs(cfg)
    tp = tsh.TensorParallel(cfg, port_mesh(tensor=t))
    sp, sl = tsh.shard_params(params, tp), tsh.shard_lora(lora, tp)
    slot_ids = torch.tensor(SLOTS)
    want_prefill, want_decode = jax_logits(name, quant)
    tol = INT8_KV_ATOL if quant else ATOL
    with torch.no_grad():
        want = ttf.prefill(cfg, params, tokens, positions, lora, slot_ids)
        got = ttf.prefill(cfg, sp, tokens, positions, sl, slot_ids)
        close(got[0], want[0])
        close(got[0], torch.from_numpy(want_prefill))
        for a, b in zip(got[1:], want[1:]):
            close(a, b, scaled=True)
        dense = _prefilled(cfg, sp, *got[1:], False, False)
        dec, _ = ttf.decode_step(cfg, sp, dense, tokens[:, -1],
                                 torch.tensor(LENS), sl, slot_ids)
        close(dec, torch.from_numpy(want_decode))
        for paged in (False, True):
            full = _prefilled(cfg, params, *want[1:], quant, paged)
            shard = _prefilled(cfg, sp, *want[1:], quant, paged)
            check_cache(full, shard)
            step = tpaged.decode_step_paged if paged else ttf.decode_step
            extend = tpaged.extend_step_paged if paged else ttf.extend_step
            chunk = (tpaged.prefill_with_cache_paged if paged
                     else ttf.prefill_with_cache)
            tok, pos = tokens[:, -1], torch.tensor(LENS)
            active = torch.tensor([True, False, True])
            a, _ = step(cfg, params, full, tok, pos, lora, slot_ids, active)
            b, _ = step(cfg, sp, shard, tok, pos, sl, slot_ids, active)
            close(b, a, tol)
            check_cache(full, shard)
            vt = tokens[:, :C]
            vp = pos[:, None] + 1 + torch.arange(C)[None]
            a, _ = extend(cfg, params, full, vt, vp, lora, slot_ids)
            b, _ = extend(cfg, sp, shard, vt, vp, sl, slot_ids)
            close(b, a, tol)
            check_cache(full, shard)
            cpos = np.arange(LENS[1], LENS[1] + 8, dtype=np.int64)
            ctok = tokens[2, :8].numpy()
            a, _ = chunk(cfg, params, full, ctok, cpos, 1, LENS[1] + 5, 4,
                         lora, 0)
            b, _ = chunk(cfg, sp, shard, ctok, cpos, 1, LENS[1] + 5, 4, sl,
                         0)
            close(b, a, tol)
            check_cache(full, shard)


@pytest.mark.parametrize("t", [4, 8])
def test_planted_padded_wo_row_is_caught(inputs, t):
    """The logits check's reach: 14:2, a non-zero ``wo`` row at one zero
    query head of a real KV head's group (its attention output is the
    mean of that head's values, not zero) moves the prefill logits far
    beyond ``ATOL``."""
    tokens, positions = inputs
    cfg, _ = MODELS["14:2"]
    params = model_params(cfg)
    tp = tsh.TensorParallel(cfg, port_mesh(tensor=t))
    sp = tsh.shard_params(params, tp)
    s, j = next((s, j) for s, heads in enumerate(tp.plan.q_heads)
                for j, h in enumerate(heads)
                if h < 0 and tp.plan.kv_heads[s][0] >= 0)
    hd = cfg.resolved_head_dim
    with torch.no_grad():
        want = ttf.prefill(cfg, params, tokens, positions)[0]
        close(ttf.prefill(cfg, sp, tokens, positions)[0], want)
        wo = sp[s]["layers"]["wo"]
        wo[:, j * hd:(j + 1) * hd] = 0.2
        got = ttf.prefill(cfg, sp, tokens, positions)[0]
    assert (got - want).abs().max().item() > 1e3 * ATOL


# ---------------------------------------------------------------------------
# Engines against the reference's mesh engine
# ---------------------------------------------------------------------------

ENGINE = dict(decode_slots=3, max_seq_len=64, prefill_buckets=(8, 16, 32),
              decode_steps_per_sync=4)
PROMPTS = [[5, 6, 7, 11], [9, 8, 7, 6, 5, 4, 3, 2, 1, 30], [40, 41, 42],
           list(range(50, 70))]
LONG = list(range(100, 145))  # beyond the largest bucket: a chunk stream
ADAPTED = "layouts-adapter"
# mode -> (engine overrides, waves of (prompt, adapter)), each wave served
# after the one before it finished.
MODES = {
    # lanes, an adapter on two rows, a prompt streaming in chunks
    "lanes": (dict(), [list(zip(PROMPTS + [LONG],
                                [ADAPTED, None, ADAPTED, None, None]))]),
    # the pool with the prefix cache: the second wave's repeated prompt
    # hits the first's blocks
    "paged": (dict(paged_kv_block=8, prefix_cache=True, stream_lanes=2),
              [[(p, None) for p in PROMPTS],
               [(PROMPTS[3] + [3, 4], None), (LONG, None)]]),
    "int8_kv": (dict(kv_cache_quant="int8"), [[(p, None) for p in PROMPTS]]),
}


def _serve(eng, waves, max_new=8, request=teng.Request):
    """Greedy tokens of every ``(prompt, adapter)`` of each wave, a wave
    submitted once the one before it finished; the engine started here
    and stopped after."""
    out = []
    eng.start()
    try:
        for wave in waves:
            reqs = [request(prompt_tokens=list(p), max_new_tokens=max_new,
                            adapter=a) for p, a in wave]
            for r in reqs:
                eng.submit(r)
            for r in reqs:
                assert r.done.wait(300), "request never finished"
                assert r.error is None, r.error
            out += [list(r.output_tokens) for r in reqs]
    finally:
        eng.stop()
    return out


def _run(eng, prompts, max_new=6, request=teng.Request):
    return _serve(eng, [[(p, None) for p in prompts]], max_new, request)


def port_engine(cfg, params, t, overrides, weights=None, lora=False,
                mesh=None):
    manager = None
    if weights is not None or lora:
        manager = TLoRA(cfg, dtype=F32, device="cpu")
    if weights is not None:
        manager.load(ADAPTED, weights=weights, alpha=8.0, rank=3)
    return teng.Engine(cfg, params, teng.EngineConfig(**ENGINE, **overrides),
                       lora_manager=manager, eos_id=None, dtype=F32,
                       device="cpu",
                       mesh=mesh or (port_mesh(tensor=t) if t > 1 else None))


def reference_tokens(name, t, mode, params, weights):
    """The JAX package's mesh engine at ``tensor=t`` (XLA attention for
    these layouts)."""
    _, jcfg = MODELS[name]
    overrides, waves = MODES[mode]
    jm = ref_mesh(tensor=t)
    manager = None
    if weights is not None:
        manager = JLoRA(jcfg, dtype=jnp.float32, mesh=jm)
        manager.load(ADAPTED, weights=weights, alpha=8.0, rank=3)
    eng = jeng.Engine(jcfg, to_jax(params), jeng.EngineConfig(
        **ENGINE, **overrides), lora_manager=manager, eos_id=None,
        dtype=jnp.float32, mesh=jm)
    return _serve(eng, waves, request=jeng.Request)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name,t", LAYOUTS, ids=IDS)
def test_engine_matches_reference_mesh_engine(name, t, mode):
    """Greedy tokens at the layout equal the reference's mesh engine's:
    lanes with an adapter on two rows and a prompt streamed in chunks, the
    paged pool with prefix hits, int8 lanes."""
    cfg, _ = MODELS[name]
    params = model_params(cfg)
    overrides, waves = MODES[mode]
    adapted = any(a for wave in waves for _, a in wave)
    weights = adapter(cfg, 11) if adapted else None
    want = reference_tokens(name, t, mode, params, weights)
    eng = port_engine(cfg, params, t, overrides, weights)
    assert isinstance(eng.params, tsh.Shards) and not eng.tp.plan.contiguous
    assert _serve(eng, waves) == want
    if mode == "paged":
        assert eng.prefix_reused_tokens > 0


# ---------------------------------------------------------------------------
# An adapter hot-swapped at run time, and hops
# ---------------------------------------------------------------------------


def _zero_at_padding(tp, bufs):
    """Every shard's LoRA ``q_b`` columns and ``o_a`` rows at its zero
    query heads, and ``k_b`` / ``v_b`` at its zero KV heads, are zero."""
    hd = tp.hd
    for s, part in enumerate(bufs):
        for key, axis, heads in (("q_b", -1, tp.plan.q_heads[s]),
                                 ("o_a", -2, tp.plan.q_heads[s]),
                                 ("k_b", -1, tp.plan.kv_heads[s]),
                                 ("v_b", -1, tp.plan.kv_heads[s])):
            for j, h in enumerate(heads):
                if h < 0:
                    x = part[key].narrow(axis, j * hd, hd)
                    assert not x.abs().sum(), (key, s, j)


@pytest.mark.parametrize("name,t", [("14:2", 4), ("6:3", 2)],
                         ids=["14:2-t4", "6:3-t2"])
def test_adapter_hot_swap_keeps_padding_zero(name, t):
    """An adapter loaded into a running engine, unloaded and loaded again:
    its tokens equal tensor=1's, and the zero heads' LoRA rows stay zero
    through every write."""
    cfg, _ = MODELS[name]
    params = model_params(cfg)
    weights = adapter(cfg, 13)
    prompts = PROMPTS[:2]
    want = []
    for tt in (1, t):
        eng = port_engine(cfg, params, tt, {}, lora=True)
        if tt > 1:
            _zero_at_padding(eng.tp, eng.lora.buffers)
        eng.start()
        try:
            reqs = []
            for round_ in range(2):
                eng.lora.load("hot", weights=weights, alpha=8.0, rank=3)
                if tt > 1:
                    _zero_at_padding(eng.tp, eng.lora.buffers)
                rs = [teng.Request(prompt_tokens=list(p), max_new_tokens=6,
                                   adapter="hot") for p in prompts]
                for r in rs:
                    eng.submit(r)
                for r in rs:
                    assert r.done.wait(180) and r.error is None, r.error
                reqs.append([list(r.output_tokens) for r in rs])
                eng.lora.unload("hot")
                for part in tsh.parts(eng.lora.buffers):
                    assert not any(part[f"{x}_b"].abs().sum()
                                   for x in tlora.TARGETS)
            assert reqs[0] == reqs[1]
            want.append(reqs[0])
        finally:
            eng.stop()
    assert want[1] == want[0]


@pytest.fixture
def distinct_devices(monkeypatch):
    """Every ``TensorParallel`` takes its shards as on distinct devices (a
    cache per shard: each replica its own), and ``torch.cuda.nccl.
    all_reduce`` an in-place sum in shard order
    (``tests/test_torch_mesh.py``'s)."""
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


@pytest.mark.parametrize("paged", [None, 8], ids=["lanes", "paged"])
@pytest.mark.parametrize("replicas", ["shared", "distinct"])
def test_hop_from_tensor4(request, replicas, paged):
    """14:2: a handoff from a tensor=4 prefill replica is tensor=1's wire
    (the two real KV heads in order, within f32 rounding); attached to a
    tensor=4 decode replica it fills every replica of each KV head
    bitwise as a tensor=1 cache holds it (one cache per KV head on one
    device, a cache per shard on distinct ones), and decodes tensor=1's
    tokens."""
    if replicas == "distinct":
        request.getfixturevalue("distinct_devices")
    cfg, _ = MODELS["14:2"]
    params = model_params(cfg)
    prompt = PROMPTS[3]
    wires = []
    for t in (4, 1):
        pre = port_engine(cfg, params, t, dict(role="prefill"))
        pre.start()
        try:
            wires.append(pre.prefill_only(teng.Request(
                prompt_tokens=prompt, max_new_tokens=6)).to_bytes())
        finally:
            pre.stop()
    a, b = (tkv.PrefillHandoff.from_bytes(w) for w in wires)
    assert (a.first_token, a.n, a.kv_format) == (b.first_token, b.n,
                                                 b.kv_format)
    assert tuple(a.k.shape) == (cfg.n_layers, len(prompt), 2,
                                cfg.resolved_head_dim)
    for x, y in ((a.k, b.k), (a.v, b.v)):
        assert tuple(x.shape) == tuple(y.shape) and x.dtype == y.dtype
        close(torch.as_tensor(x), torch.as_tensor(y))
    decs = [port_engine(cfg, params, t, dict(paged_kv_block=paged))
            for t in (1, 4)]
    reqs = []
    for d in decs:
        # Not started: admission stepped by hand, nothing decodes yet.
        reqs.append(d.attach_prefilled(tkv.PrefillHandoff.from_bytes(
            wires[0])))
        d._admit_and_insert(False)
        assert reqs[-1].error is None
    full = decs[0].cache
    caches = tsh.parts(decs[1].cache)
    n_distinct = len(tsh.distinct(caches))
    assert n_distinct == (4 if replicas == "distinct" else 2)
    for c, heads in tsh.kv_parts(decs[1].cache):
        for key in ("k", "v"):
            assert torch.equal(c[key], full[key][:, :, :, heads])
    outs = []
    for d, req in zip(decs, reqs):
        d.start()
        try:
            assert req.done.wait(180) and req.error is None, req.error
        finally:
            d.stop()
        outs.append(list(req.output_tokens))
    assert outs[1] == outs[0]


# ---------------------------------------------------------------------------
# The ring, and two processes
# ---------------------------------------------------------------------------

RING_ENGINE = dict(decode_slots=2, max_seq_len=64, prefill_buckets=(8, 16))
RING_PROMPT = [int(x) for x in
               np.random.RandomState(3).randint(1, 250, size=40)]


@pytest.mark.parametrize("mode", ["lanes", "paged"])
def test_ring_sequence2_tensor2(mode):
    """6:3 at ``sequence=2, tensor=2`` (4:2 a shard, a zero KV head): a
    40-token prompt through exactly one ring program gives the reference
    engine's greedy tokens on its same mesh and the port's at
    ``sequence=1`` (the prompt streamed in chunks there)."""
    cfg, jcfg = MODELS["6:3"]
    params = model_params(cfg)
    extra = dict(paged_kv_block=8) if mode == "paged" else {}
    prompts = [RING_PROMPT, list(range(5, 17))]
    jeng_ = jeng.Engine(jcfg, to_jax(params), jeng.EngineConfig(
        **RING_ENGINE, **extra), eos_id=None, dtype=jnp.float32,
        mesh=ref_mesh(tensor=2, sequence=2))
    want = _run(jeng_, prompts, request=jeng.Request)
    got = {}
    for seq in (2, 1):
        eng = teng.Engine(cfg, params, teng.EngineConfig(
            **RING_ENGINE, **extra), eos_id=None, dtype=F32, device="cpu",
            mesh=port_mesh(tensor=2, sequence=seq))
        counts = {"ring": 0}
        if seq == 2:
            ring = eng._ring

            def counted(*args, **kwargs):
                counts["ring"] += 1
                return ring(*args, **kwargs)
            eng._ring = counted
        got[seq] = _run(eng, prompts)
        if seq == 2:
            assert counts["ring"] == 1
    assert got[2] == want
    assert got[1] == want


TWO_PROCESS_WORKER = r"""
import dataclasses, os, sys
sys.path.insert(0, os.environ["GRAFT_REPO"])
import torch
from llm_instance_gateway_tpu_torch.models.configs import TINY_QWEN_TEST
from llm_instance_gateway_tpu_torch.parallel import multihost_check
from llm_instance_gateway_tpu_torch.parallel.mesh import (
    initialize_distributed, make_mesh, parse_axes,
)
from llm_instance_gateway_tpu_torch.server.engine import (
    Engine, EngineConfig, Request, SamplingParams,
)

initialize_distributed()
cfg = dataclasses.replace(TINY_QWEN_TEST, n_heads=14, n_kv_heads=2)
mesh = make_mesh(parse_axes("tensor=4"), ["cpu"] * 2)
for extra in ({}, {"paged_kv_block": 8}):
    engine = Engine(cfg, multihost_check.load_tree(os.environ["GRAFT_WEIGHTS"]),
                    EngineConfig(decode_slots=2, max_seq_len=64,
                                 prefill_buckets=(8, 16), **extra),
                    eos_id=None, dtype=torch.float32, device="cpu",
                    mesh=mesh, cuda_graphs=False)
    assert not engine.tp.plan.contiguous and engine.tp.shards == (
        [0, 1] if mesh.rank == 0 else [2, 3]), engine.tp.shards
    reqs = [Request(prompt_tokens=list(p), max_new_tokens=6,
                    sampling=SamplingParams(temperature=0.0))
            for p in ([5, 6, 7], list(range(20, 40)))]
    for r in reqs:
        engine.submit(r)
    engine.start()
    try:
        for r in reqs:
            assert r.done.wait(120) and r.error is None, r.error
    finally:
        engine.stop()
    print("LAYOUTS OK " + ";".join(",".join(map(str, r.output_tokens))
                                   for r in reqs), flush=True)
"""


def test_two_processes_14_2_tensor4(tmp_path):
    """14:2 at tensor=4 over two processes (gloo, lockstep; two shards a
    process, the two replicas of each KV head in one process), on lanes
    and on the pool: both processes read back the tokens of the
    one-process tensor=4 engine and of tensor=1."""
    cfg, _ = MODELS["14:2"]
    params = model_params(cfg)
    path = str(tmp_path / "weights.npz")
    multihost_check.save_tree(path, to_numpy(params))
    outs = multihost_check.run_two_process(
        TWO_PROCESS_WORKER, n_local=2, timeout_s=240,
        env={"GRAFT_WEIGHTS": path})
    lines = [[ln.split(" ", 2)[2] for ln in out.splitlines()
              if ln.startswith("LAYOUTS OK")] for out in outs]
    assert len(lines[0]) == 2 and lines[0] == lines[1]
    prompts = [[5, 6, 7], list(range(20, 40))]
    for i, extra in enumerate(({}, {"paged_kv_block": 8})):
        for t in (4, 1):
            eng = teng.Engine(cfg, params, teng.EngineConfig(
                decode_slots=2, max_seq_len=64, prefill_buckets=(8, 16),
                **extra), eos_id=None, dtype=F32, device="cpu",
                mesh=port_mesh(tensor=t) if t > 1 else None)
            toks = _run(eng, prompts)
            assert lines[0][i] == ";".join(",".join(map(str, o))
                                           for o in toks), (extra, t)
