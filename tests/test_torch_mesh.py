"""Tensor-parallel serving in the torch port (``--mesh tensor=N``), held to
the port's unsharded forward and engine and to the JAX package's, on the
CPU at f32 with every shard on the CPU.

- Mesh rules: ``--mesh`` parsing, the device-count mismatch, the axes this
  slice refuses.
- Shard shapes: each leaf's per-shard shape against the local block shape
  of the reference's ``NamedSharding`` (``parallel/sharding.py`` specs on
  the virtual 8-device CPU mesh; placing arrays compiles nothing) for the
  params (dense and int8), lane and paged caches with int8 scales, and
  the LoRA buffers, at tensor 2 and 4.  Where the port splits otherwise
  by design (embeddings and ``lm_head`` whole; a replicated KV head's
  projections whole; a row target's LoRA ``a`` split on d_in), the test
  names the leaf and checks the port's shape.
- The gate: ``mesh_supports`` against the reference's for every preset at
  t in {1, 2, 4, 8}.
- The sharded forward at tensor 2 and 4: prefill, the lane decode step,
  the paged step, the lane and paged chunk, and the extend verify (lanes
  and pool), dense and with int8 weights plus an int8 KV cache, with mixed
  LoRA slots, on a narrow GQA config (8:4), ``TINY_TEST`` (MQA),
  ``TINY_QWEN_TEST`` (biases) and ``TINY_MOE_TEST``: logits within 1e-5
  of the unsharded forward, every shard's cache holding its heads of the
  unsharded cache; prefill and decode logits within 1e-5 of the JAX
  package's.
- Engines: greedy tokens at tensor=2 equal the JAX engine's under
  ``MeshConfig(tensor=2)`` on lanes with an adapter; tensor=2 equals the
  port's tensor=1 on paged with the prefix cache, spec, grouped plus
  pipelined dispatch, and Mixtral; hops tensor=2 -> tensor=1 and back.
- The distinct-card branches (per-shard copies, caches, tables and
  lengths, the reduction over the per-device list) driven on the CPU, the
  shards' one device taken as distinct and NCCL's in-place sum stood in
  for: the forward, engines and a hop as above.  The card tests run
  them with NCCL over two cards.
- Refusals by name: layouts outside ``mesh_supports``, other axes, and
  graphs across cards.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_instance_gateway_tpu.models import gemma, llama, mixtral, qwen
from llm_instance_gateway_tpu.models import transformer as jtf
from llm_instance_gateway_tpu.models.configs import TINY_TEST as JAX_TINY
from llm_instance_gateway_tpu.models.configs import TINY_MOE_TEST as JAX_MOE
from llm_instance_gateway_tpu.models.configs import TINY_QWEN_TEST as JAX_QWEN
from llm_instance_gateway_tpu.ops import sharded_attention as jsa
from llm_instance_gateway_tpu.parallel import mesh as jmesh
from llm_instance_gateway_tpu.parallel import sharding as jsh
from llm_instance_gateway_tpu.server import engine as jeng
from llm_instance_gateway_tpu.server.lora_manager import LoRAManager as JLoRA

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch.models import lora as tlora  # noqa: E402
from llm_instance_gateway_tpu_torch.models import paged as tpaged  # noqa: E402
from llm_instance_gateway_tpu_torch.models import transformer as ttf  # noqa: E402
from llm_instance_gateway_tpu_torch.models.configs import CONFIGS  # noqa: E402
from llm_instance_gateway_tpu_torch.models.configs import (  # noqa: E402
    TINY_MOE_TEST,
    TINY_QWEN_TEST,
    TINY_TEST,
)
from llm_instance_gateway_tpu_torch.ops import sharded_attention as tsa  # noqa: E402
from llm_instance_gateway_tpu_torch.ops.quant import quantize_params  # noqa: E402
from llm_instance_gateway_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from llm_instance_gateway_tpu_torch.parallel import sharding as tsh  # noqa: E402
from llm_instance_gateway_tpu_torch.server import api_http as tapi  # noqa: E402
from llm_instance_gateway_tpu_torch.server import engine as teng  # noqa: E402
from llm_instance_gateway_tpu_torch.server import kv_transfer as tkv  # noqa: E402
from llm_instance_gateway_tpu_torch.server.lora_manager import (  # noqa: E402
    LoRAManager as TLoRA,
)

F32 = torch.float32
JCONFIGS = {k: v for mod in (llama, gemma, mixtral, qwen)
            for k, v in mod.CONFIGS.items()}
ATOL = 1e-5
# Logits after a step that writes an int8 KV cache: the shards' new K/V
# differ from the unsharded ones by the reduction order (~1e-7), so a value
# at a rounding boundary quantizes one step apart (``check_cache`` bounds
# that: never more than one), and one step of a dequantized value (its
# vector's max / 127, ~0.05 here) moves the logits by ~3e-4 on this model.
INT8_KV_ATOL = 2e-3
GQA = dataclasses.replace(TINY_TEST, n_heads=8, n_kv_heads=4)
JAX_GQA = dataclasses.replace(JAX_TINY, n_heads=8, n_kv_heads=4)
MODELS = {"gqa": (GQA, JAX_GQA), "mqa": (TINY_TEST, JAX_TINY),
          "qwen": (TINY_QWEN_TEST, JAX_QWEN), "moe": (TINY_MOE_TEST, JAX_MOE)}


def cpu_mesh(t: int):
    return tmesh.make_mesh(tmesh.MeshConfig(tensor=t), ["cpu"] * t)


def tp_of(cfg, t: int):
    return tsh.TensorParallel(cfg, cpu_mesh(t))


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def adapter(cfg, seed: int, rank: int = 3):
    rng = np.random.default_rng(seed)
    return {t: {"a": rng.standard_normal((cfg.n_layers, d_in, rank))
                .astype(np.float32) * 0.1,
                "b": rng.standard_normal((cfg.n_layers, rank, d_out))
                .astype(np.float32) * 0.1}
            for t, (d_in, d_out) in tlora.target_dims(cfg).items()}


def model_params(cfg, quant: bool = False):
    params = ttf.init_params(cfg, seed=0, dtype=F32, device="cpu")
    if cfg.attention_bias:  # non-zero biases, so a mis-split shows
        g = torch.Generator().manual_seed(5)
        for name in ("wq_b", "wk_b", "wv_b"):
            leaf = params["layers"][name]
            leaf.copy_(torch.randn(leaf.shape, generator=g) * 0.5)
    return quantize_params(params) if quant else params


def lora_bufs(cfg):
    bufs = tlora.init_lora_buffers(cfg, dtype=F32, device="cpu")
    tlora.write_adapter(bufs, cfg, 0, adapter(cfg, 1), 8.0, 3)
    tlora.write_adapter(bufs, cfg, 1, adapter(cfg, 2), 4.0, 3)
    return bufs


# ---------------------------------------------------------------------------
# Mesh rules
# ---------------------------------------------------------------------------


class TestMeshRules:
    def test_parse_and_shape(self):
        cfg = tmesh.parse_axes("tensor=2")
        assert cfg == tmesh.MeshConfig(tensor=2)
        mesh = tmesh.make_mesh(tmesh.parse_axes("data=1, tensor=4"),
                               ["cpu"] * 4)
        assert mesh.shape == {"data": 1, "fsdp": 1, "pipe": 1, "tensor": 4,
                              "expert": 1, "sequence": 1}
        assert mesh.size == 4
        ref = jmesh.MeshConfig.for_devices(8, tensor=2)
        port = tmesh.MeshConfig.for_devices(8, tensor=2)
        assert port.shape == ref.shape and port.total == ref.total
        with pytest.raises(ValueError, match="unknown mesh axes"):
            tmesh.parse_axes("model=2")

    def test_device_count_mismatch(self):
        with pytest.raises(ValueError, match="devices"):
            tmesh.make_mesh(tmesh.MeshConfig(tensor=3), ["cpu"] * 2)
        # No explicit list: the host's CUDA devices (none here).
        with pytest.raises(ValueError, match="needs 2 devices, have"):
            tmesh.make_mesh(tmesh.MeshConfig(tensor=2))

    @pytest.mark.parametrize("axis", ["data", "fsdp", "pipe", "expert",
                                      "sequence"])
    def test_other_axes_refused(self, axis):
        with pytest.raises(ValueError,
                           match=f"mesh axis {axis}=2.*ROADMAP"):
            tmesh.make_mesh(tmesh.MeshConfig(**{axis: 2}), ["cpu"] * 2)


# ---------------------------------------------------------------------------
# Shard shapes against the reference's NamedShardings
# ---------------------------------------------------------------------------


def jax_local_shapes(tree, specs, t):
    """The reference's per-device block shapes: ``shard_pytree`` places a
    numpy tree on the first ``t`` virtual CPU devices."""
    mesh = jmesh.make_mesh(jmesh.MeshConfig(tensor=t),
                           devices=jax.devices()[:t])
    placed = jsh.shard_pytree(tree, specs, mesh)

    def shapes(x):
        if isinstance(x, dict):
            return {k: shapes(v) for k, v in x.items()}
        return tuple(x.sharding.shard_shape(x.shape))
    return shapes(placed)


def shard_shapes(tree):
    """Leaf shapes of each shard (a plain tree: one shard)."""
    def shapes(x):
        if isinstance(x, dict):
            return {k: shapes(v) for k, v in x.items()}
        return tuple(x.shape)
    return [shapes(t) for t in tsh.parts(tree)]


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat(v, key + "."))
        else:
            out[key] = v
    return out


def check_shapes(port_tree, want, expect_differ):
    """Every shard's leaf shapes against the reference's blocks; the
    leaves in ``expect_differ`` (name -> port shape) split by design
    otherwise."""
    want = flat(want)
    for shard in shard_shapes(port_tree):
        got = flat(shard)
        assert got.keys() == want.keys()
        for name in got:
            if name in expect_differ:
                assert got[name] == expect_differ[name], name
                assert got[name] != want[name], name
            else:
                assert got[name] == want[name], name


def numpy_zeros(tree):
    if isinstance(tree, dict):
        return {k: numpy_zeros(v) for k, v in tree.items()}
    return np.zeros(tuple(tree.shape), np.float32 if tree.dtype != torch.int8
                    else np.int8)


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("name", ["gqa", "mqa", "qwen", "moe"])
@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
def test_param_shard_shapes(name, t, quant):
    cfg, jcfg = MODELS[name]
    params = model_params(cfg, quant)
    tp = tp_of(cfg, t)
    want = jax_local_shapes(numpy_zeros(params), jsh.param_specs(jcfg), t)
    full = flat(shard_shapes(params)[0])
    differ = {"embed": full["embed"]}
    for leaf in ("lm_head", "lm_head.q", "lm_head.s"):
        if leaf in full:
            differ[leaf] = full[leaf]
    if not tp.kv_split:  # one replicated KV head: its projections whole
        for leaf, shape in full.items():
            path = leaf.split(".")
            if path[0] == "layers" and path[1] in ("wk", "wv", "wk_b",
                                                   "wv_b"):
                differ[leaf] = shape
    check_shapes(tsh.shard_params(params, tp), want, differ)


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("name", ["gqa", "mqa"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_cache_shard_shapes(name, t, quant):
    cfg, jcfg = MODELS[name]
    tp = tp_of(cfg, t)
    jm = jmesh.make_mesh(jmesh.MeshConfig(tensor=t), devices=jax.devices()[:t])
    lane = ttf.init_decode_cache(cfg, 4, 32, dtype=F32, device="cpu",
                                 quantized=quant)
    want = jax_local_shapes(numpy_zeros(lane),
                            jsh.cache_specs(jcfg, jm, quantized=quant), t)
    check_shapes(tsh.shard_cache(
        lambda c, d: ttf.init_decode_cache(c, 4, 32, dtype=F32, device=d,
                                           quantized=quant), tp), want, {})
    pool = tpaged.init_paged_cache(cfg, 4, 32, 8, 16, dtype=F32,
                                   device="cpu", quantized=quant)
    want = jax_local_shapes(numpy_zeros(pool), jsh.paged_cache_specs(
        jcfg, jm, quantized=quant), t)
    sharded = tsh.shard_cache(
        lambda c, d: tpaged.init_paged_cache(c, 4, 32, 8, 16, dtype=F32,
                                             device=d, quantized=quant), tp)
    check_shapes(sharded, want, {})
    # One device: the tables and lengths are one tensor for every shard.
    assert all(c["tables"] is sharded[0]["tables"] for c in sharded)
    assert all(c["length"] is sharded[0]["length"] for c in sharded)
    if not tp.kv_split:
        assert all(c is sharded[0] for c in sharded)


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("name", ["gqa", "mqa"])
def test_lora_shard_shapes(name, t):
    cfg, jcfg = MODELS[name]
    tp = tp_of(cfg, t)
    bufs = lora_bufs(cfg)
    want = jax_local_shapes(numpy_zeros(bufs), jsh.lora_specs(jcfg), t)
    dims = tlora.target_dims(tp.cfg)
    r, slots, n_l = cfg.max_lora_rank, cfg.max_lora_slots, cfg.n_layers
    differ = {f"{x}_a": (n_l, slots, dims[x][0], r) for x in ("o", "down")}
    if not tp.kv_split:
        differ.update({f"{x}_b": (n_l, slots, r, dims[x][1])
                       for x in ("k", "v")})
    check_shapes(tsh.shard_lora(bufs, tp), want, differ)


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", sorted(CONFIGS))
def test_mesh_supports_matches_reference(preset):
    for t in (1, 2, 4, 8):
        jm = jmesh.make_mesh(jmesh.MeshConfig(tensor=t),
                             devices=jax.devices()[:t])
        tm = tmesh.make_mesh(tmesh.MeshConfig(tensor=t), ["cpu"] * t)
        assert (tsa.mesh_supports(CONFIGS[preset], tm)
                == jsa.mesh_supports(JCONFIGS[preset], jm)), (preset, t)


# ---------------------------------------------------------------------------
# The sharded forward
# ---------------------------------------------------------------------------

B, S, C = 3, 12, 5
SLOTS = [0, -1, 1]
LENS = [12, 7, 9]


def close(a, b, atol=ATOL, scaled=False):
    """Within ``atol``; ``scaled`` (KV values, some of size ~10) takes it
    relative to the larger of 1 and the tensor's largest magnitude."""
    a = a.detach().float().cpu()
    b = b.detach().float().cpu()
    assert a.shape == b.shape
    err = (a - b).abs().max().item()
    if scaled:
        atol *= max(1.0, b.abs().max().item())
    assert err <= atol, err


def check_cache(full, sharded):
    """Every shard's cache holds its heads of the unsharded cache."""
    for c, heads in tsh.kv_parts(sharded):
        for name in full:
            x = full[name]
            if name in ("tables", "length"):
                assert torch.equal(c[name], x), name
            elif x.dtype == torch.int8:
                # The shards' K/V differ from the unsharded ones by the
                # reduction order (~1e-7): a value at a rounding boundary
                # may quantize one step apart, never more.
                diff = (c[name].int() - x[:, :, :, heads].int()).abs()
                assert diff.max() <= 1, name
            else:
                close(c[name], x[:, :, :, heads], scaled=True)


@pytest.fixture(scope="module")
def forward_cases():
    """(cfg, params, lora) per (model, quant), and the inputs."""
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, 300, (B, S)))
    positions = torch.arange(S)[None].expand(B, S).clone()
    out = {}
    for name, (cfg, _) in MODELS.items():
        for quant in (False, True):
            out[name, quant] = (cfg, model_params(cfg, quant),
                                lora_bufs(cfg))
    return out, tokens, positions


def _prefilled(cfg, params, k, v, quant, paged):
    """A cache (lanes or pool) for the model ``params`` (plain or
    sharded) holding each row's prompt KV ``k`` / ``v`` (whole heads),
    through the insert seam.  The sharded and unsharded caches take the
    same KV: an int8 cache quantizes it, and KV that differs by rounding
    may quantize one step apart (``check_cache``), which the steps after
    would carry into their logits."""
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
            blocks = [1 + 2 * row]
            table = blocks + [1 + 2 * row + 1]
            tpaged.insert_prefill_paged(cache, kr, vr, row, blocks, table,
                                        LENS[row])
        else:
            ttf.insert_prefill(cache, kr, vr, row, LENS[row])
    return cache


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("name", ["gqa", "mqa", "qwen", "moe"])
def test_sharded_forward(forward_cases, name, t, quant):
    cases, tokens, positions = forward_cases
    cfg, params, lora = cases[name, quant]
    tp = tp_of(cfg, t)
    sp, sl = tsh.shard_params(params, tp), tsh.shard_lora(lora, tp)
    slot_ids = torch.tensor(SLOTS)
    with torch.no_grad():
        # prefill
        want = ttf.prefill(cfg, params, tokens, positions, lora, slot_ids)
        got = ttf.prefill(cfg, sp, tokens, positions, sl, slot_ids)
        close(got[0], want[0])
        for a, b in zip(got[1:], want[1:]):
            close(a, b, scaled=True)
        for paged in (False, True):
            full = _prefilled(cfg, params, *want[1:], quant, paged)
            shard = _prefilled(cfg, sp, *want[1:], quant, paged)
            check_cache(full, shard)
            step = tpaged.decode_step_paged if paged else ttf.decode_step
            extend = tpaged.extend_step_paged if paged else ttf.extend_step
            chunk = (tpaged.prefill_with_cache_paged if paged
                     else ttf.prefill_with_cache)
            # one decode step, row 1 inactive
            tok = tokens[:, -1]
            pos = torch.tensor(LENS)
            active = torch.tensor([True, False, True])
            a, _ = step(cfg, params, full, tok, pos, lora, slot_ids, active)
            b, _ = step(cfg, sp, shard, tok, pos, sl, slot_ids, active)
            tol = INT8_KV_ATOL if quant else ATOL
            close(b, a, tol)
            check_cache(full, shard)
            # the extend verify (the target's spec forward)
            vt = tokens[:, :C]
            vp = pos[:, None] + 1 + torch.arange(C)[None]
            a, _ = extend(cfg, params, full, vt, vp, lora, slot_ids)
            b, _ = extend(cfg, sp, shard, vt, vp, sl, slot_ids)
            close(b, a, tol)
            check_cache(full, shard)
            # a chunk into row 1 (its cached prompt, then 5 more tokens)
            cpos = np.arange(LENS[1], LENS[1] + 8, dtype=np.int64)
            ctok = tokens[2, :8].numpy()
            a, _ = chunk(cfg, params, full, ctok, cpos, 1, LENS[1] + 5, 4,
                         lora, 0)
            b, _ = chunk(cfg, sp, shard, ctok, cpos, 1, LENS[1] + 5, 4, sl,
                         0)
            close(b, a, tol)
            check_cache(full, shard)


@pytest.fixture(scope="module")
def jax_logits(forward_cases):
    """The JAX package's prefill and decode logits per (model, quant),
    on the same numpy weights and adapter buffers."""
    cases, tokens, positions = forward_cases
    memo = {}

    def get(name, quant):
        if (name, quant) not in memo:
            cfg, params, lora = cases[name, quant]
            jcfg = MODELS[name][1]
            jp = jax.tree.map(jnp.asarray, to_numpy(params))
            jl = jax.tree.map(jnp.asarray, to_numpy(lora))
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
@pytest.mark.parametrize("name", ["gqa", "mqa", "qwen", "moe"])
def test_sharded_forward_matches_jax(forward_cases, jax_logits, name, quant):
    cases, tokens, positions = forward_cases
    cfg, params, lora = cases[name, quant]
    want_prefill, want_decode = jax_logits(name, quant)
    slot_ids = torch.tensor(SLOTS)
    for t in (2, 4):
        tp = tp_of(cfg, t)
        sp, sl = tsh.shard_params(params, tp), tsh.shard_lora(lora, tp)
        with torch.no_grad():
            logits, k, v = ttf.prefill(cfg, sp, tokens, positions, sl,
                                       slot_ids)
            close(logits, torch.from_numpy(want_prefill))
            cache = tsh.shard_cache(
                lambda c, d: ttf.init_decode_cache(c, B, 32, dtype=F32,
                                                   device=d), tp)
            for row in range(B):
                ttf.insert_prefill(cache, k[:, row:row + 1],
                                   v[:, row:row + 1], row, S)
            dec, _ = ttf.decode_step(cfg, sp, cache, tokens[:, -1],
                                     torch.tensor(LENS), sl, slot_ids)
            close(dec, torch.from_numpy(want_decode))


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

ENGINE = dict(decode_slots=3, max_seq_len=64, prefill_buckets=(8, 16, 32),
              decode_steps_per_sync=4)
PROMPTS = [[5, 6, 7, 11], [9, 8, 7, 6, 5, 4, 3, 2, 1, 30], [40, 41, 42],
           list(range(50, 70))]


def torch_engine(cfg, params, t=1, lora=None, draft=None, start=True,
                 **overrides):
    manager = None
    if lora is not None:
        manager = TLoRA(cfg, dtype=F32, device="cpu")
        manager.load("mesh-adapter", weights=lora, alpha=8.0, rank=3)
    kw = {}
    if draft is not None:
        kw = dict(draft_params=draft[1], draft_cfg=draft[0])
    eng = teng.Engine(cfg, params, teng.EngineConfig(**dict(ENGINE,
                                                            **overrides)),
                      lora_manager=manager, eos_id=None, dtype=F32,
                      device="cpu", mesh=cpu_mesh(t) if t > 1 else None,
                      **kw)
    if start:
        eng.start()
    return eng


def run_all(eng, prompts, max_new=8, adapters=None):
    reqs = [teng.Request(prompt_tokens=list(p), max_new_tokens=max_new,
                         adapter=(adapters[i] if adapters else None))
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    for r in reqs:
        assert r.done.wait(180), "request never finished"
        assert r.error is None, r.error
    return [list(r.output_tokens) for r in reqs]


ADAPTERS = ["mesh-adapter", None, "mesh-adapter", None]


def test_engine_matches_jax_mesh_engine_with_lora():
    cfg, jcfg = MODELS["gqa"]
    params = model_params(cfg)
    weights = adapter(cfg, 11)
    jm = jmesh.make_mesh(jmesh.MeshConfig(tensor=2),
                         devices=jax.devices()[:2])
    jlora = JLoRA(jcfg, dtype=jnp.float32, mesh=jm)
    jlora.load("mesh-adapter", weights=weights, alpha=8.0, rank=3)
    jengine = jeng.Engine(jcfg, jax.tree.map(jnp.asarray, to_numpy(params)),
                          jeng.EngineConfig(**ENGINE), lora_manager=jlora,
                          eos_id=None, dtype=jnp.float32, mesh=jm)
    jengine.start()
    try:
        jreqs = [jeng.Request(prompt_tokens=list(p), max_new_tokens=8,
                              adapter=a) for p, a in zip(PROMPTS, ADAPTERS)]
        for r in jreqs:
            jengine.submit(r)
        for r in jreqs:
            assert r.done.wait(300) and r.error is None, r.error
        want = [list(r.output_tokens) for r in jreqs]
    finally:
        jengine.stop()
    eng = torch_engine(cfg, params, t=2, lora=weights)
    try:
        assert isinstance(eng.params, tsh.Shards)
        assert isinstance(eng.lora.buffers, tsh.Shards)
        got = run_all(eng, PROMPTS, adapters=ADAPTERS)
    finally:
        eng.stop()
    assert got == want
    assert want[0] != run_all_base(cfg, params)[0]


def run_all_base(cfg, params):
    eng = torch_engine(cfg, params)
    try:
        return run_all(eng, PROMPTS)
    finally:
        eng.stop()


@pytest.mark.parametrize("mode", ["paged_prefix", "spec", "grouped_pipelined",
                                  "mixtral", "int8_lanes"])
def test_engine_tensor2_matches_tensor1(mode):
    cfg = GQA
    overrides, draft, quant, prompts = {}, None, False, PROMPTS
    if mode == "paged_prefix":
        overrides = dict(paged_kv_block=8, prefix_cache=True,
                         stream_lanes=2)
        prompts = PROMPTS + [PROMPTS[3] + [3, 4], list(range(1, 45))]
    elif mode == "spec":
        draft = (TINY_TEST, ttf.init_params(TINY_TEST, seed=1, dtype=F32,
                                            device="cpu"))
        overrides = dict(speculative_k=3)
    elif mode == "grouped_pipelined":
        overrides = dict(prefill_batch=3, pipeline_decode=True)
    elif mode == "mixtral":
        cfg = TINY_MOE_TEST
        overrides = dict(decode_slots=4)
    elif mode == "int8_lanes":
        quant = True
        overrides = dict(kv_cache_quant="int8")
    params = model_params(cfg, quant)
    results = []
    for t in (1, 2):
        eng = torch_engine(cfg, params, t=t, draft=draft, **overrides)
        try:
            if mode == "paged_prefix":
                first = run_all(eng, prompts[:4])
                rest = run_all(eng, prompts[4:])
                results.append((first + rest, eng.prefix_reused_tokens))
            else:
                results.append((run_all(eng, prompts), None))
                if mode == "spec":
                    results[-1] = (results[-1][0], eng.spec_cycles > 0)
        finally:
            eng.stop()
    assert results[1] == results[0]
    if mode == "paged_prefix":
        assert results[1][1] > 0


def test_penalized_rows_tensor2_match_tensor1():
    params = model_params(GQA)
    outs = []
    for t in (1, 2):
        eng = torch_engine(GQA, params, t=t)
        try:
            reqs = [teng.Request(prompt_tokens=list(p), max_new_tokens=8,
                                 sampling=teng.SamplingParams(
                                     presence_penalty=1.5,
                                     frequency_penalty=0.5))
                    for p in PROMPTS[:3]]
            for r in reqs:
                eng.submit(r)
            for r in reqs:
                assert r.done.wait(180) and r.error is None
            outs.append([r.output_tokens for r in reqs])
        finally:
            eng.stop()
    assert outs[0] == outs[1]


@pytest.mark.parametrize("direction", ["2to1", "1to2"])
def test_hops_across_tensor_sizes(direction):
    params = model_params(GQA)
    t_pre, t_dec = (2, 1) if direction == "2to1" else (1, 2)
    pre = torch_engine(GQA, params, t=t_pre, role="prefill")
    ref_pre = torch_engine(GQA, params, t=t_dec, role="prefill")
    dec = torch_engine(GQA, params, t=t_dec, paged_kv_block=8,
                       prefix_cache=True)
    colloc = torch_engine(GQA, params, t=t_dec)
    try:
        prompt = PROMPTS[3]
        h = pre.prefill_only(teng.Request(prompt_tokens=prompt,
                                          max_new_tokens=8))
        h_ref = ref_pre.prefill_only(teng.Request(prompt_tokens=prompt,
                                                  max_new_tokens=8))
        wire, wire_ref = h.to_bytes(), h_ref.to_bytes()
        # The unsharded wire: the same fields and KV layout (whole heads,
        # in order), the KV within f32 rounding of the other tensor
        # size's.
        a = tkv.PrefillHandoff.from_bytes(wire)
        b = tkv.PrefillHandoff.from_bytes(wire_ref)
        assert (a.first_token, a.n, a.kv_format, a.prompt_tokens) == (
            b.first_token, b.n, b.kv_format, b.prompt_tokens)
        for x, y in ((a.k, b.k), (a.v, b.v)):
            assert (tuple(x.shape), x.dtype) == (tuple(y.shape), y.dtype)
        close(torch.as_tensor(a.k), torch.as_tensor(b.k))
        close(torch.as_tensor(a.v), torch.as_tensor(b.v))
        req = dec.attach_prefilled(tkv.PrefillHandoff.from_bytes(wire))
        assert req.done.wait(180) and req.error is None, req.error
        want = run_all(colloc, [prompt])[0]
        assert req.output_tokens == want
    finally:
        for e in (pre, ref_pre, dec, colloc):
            e.stop()


def test_attach_scatters_heads_exactly():
    """A handoff attached to a tensor=2 pool lands each shard's heads
    bitwise where a tensor=1 pool holds them."""
    params = model_params(GQA)
    pre = torch_engine(GQA, params, role="prefill")
    # Not started: admission stepped by hand, nothing decodes after it.
    decs = [torch_engine(GQA, params, t=t, start=False, paged_kv_block=8)
            for t in (1, 2)]
    try:
        wire = pre.prefill_only(teng.Request(prompt_tokens=PROMPTS[1],
                                             max_new_tokens=2)).to_bytes()
        for d in decs:
            req = d.attach_prefilled(tkv.PrefillHandoff.from_bytes(wire))
            d._admit_and_insert(False)
            assert req.error is None
        full = decs[0].cache
        for c, heads in tsh.kv_parts(decs[1].cache):
            for name in ("k", "v"):
                assert torch.equal(c[name], full[name][:, :, :, heads])
            assert torch.equal(c["tables"], full["tables"])
    finally:
        pre.stop()


def test_lora_unload_and_reload_touch_every_shard():
    params = model_params(GQA)
    weights = adapter(GQA, 11)
    eng = torch_engine(GQA, params, t=2, lora=weights)
    try:
        with_adapter = run_all(eng, PROMPTS[:1], adapters=["mesh-adapter"])
        eng.lora.unload("mesh-adapter")
        for part in eng.lora.buffers:
            assert not any(part[f"{x}_b"].abs().sum() for x in tlora.TARGETS)
        eng.lora.load("mesh-adapter", weights=weights, alpha=8.0, rank=3)
        assert run_all(eng, PROMPTS[:1],
                       adapters=["mesh-adapter"]) == with_adapter
    finally:
        eng.stop()


# ---------------------------------------------------------------------------
# Refusals by name, and the server flag
# ---------------------------------------------------------------------------


def test_unsupported_layout_refused_by_name():
    cfg = dataclasses.replace(CONFIGS["qwen2.5-7b"], n_layers=1)
    with pytest.raises(ValueError, match=r"tensor=8 .*28:4 head layout"):
        tsh.TensorParallel(cfg, cpu_mesh(8))
    params = model_params(GQA)
    with pytest.raises(ValueError, match=r"tensor=8 .*8:4 head layout"):
        teng.Engine(GQA, params, teng.EngineConfig(**ENGINE), dtype=F32,
                    device="cpu", mesh=cpu_mesh(8))


def test_engine_axis_rules():
    params = model_params(GQA)
    devices = tuple(torch.device("cpu") for _ in range(2))
    with pytest.raises(ValueError, match="pipe=1"):
        teng.Engine(GQA, params, teng.EngineConfig(**ENGINE), dtype=F32,
                    device="cpu",
                    mesh=tmesh.Mesh(tmesh.MeshConfig(pipe=2), devices))
    with pytest.raises(ValueError, match="paged KV on a mesh requires data=1"):
        teng.Engine(GQA, params,
                    teng.EngineConfig(**dict(ENGINE, paged_kv_block=8)),
                    dtype=F32, device="cpu",
                    mesh=tmesh.Mesh(tmesh.MeshConfig(data=2), devices))
    with pytest.raises(ValueError, match="mesh axis sequence=2"):
        teng.Engine(GQA, params, teng.EngineConfig(**ENGINE), dtype=F32,
                    device="cpu",
                    mesh=tmesh.Mesh(tmesh.MeshConfig(sequence=2), devices))


def test_graphs_across_cards_refused_by_name():
    params = model_params(GQA)
    mesh = tmesh.make_mesh(tmesh.MeshConfig(tensor=2), ["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="CUDA graphs across cards"):
        teng.Engine(GQA, params, teng.EngineConfig(**ENGINE), dtype=F32,
                    device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="all on one device or each"):
        tsh.TensorParallel(GQA, tmesh.make_mesh(
            tmesh.MeshConfig(tensor=4), ["cpu", "cpu", "meta", "meta"]))


def test_shard_kernels_launch_from_their_own_card():
    """Across cards each shard's attention runs with its card current (a
    kernel wrapper launches on the current device); on one device, and
    on the CPU, nothing changes."""
    params = model_params(GQA)
    cards = tsh.TensorParallel(GQA, tmesh.make_mesh(
        tmesh.MeshConfig(tensor=2), ["cuda:0", "cuda:1"]))
    sh = ttf._Shards(GQA, tsh.Shards([params, params], cards), None)
    for s in range(2):
        ctx = sh.current(s)
        assert isinstance(ctx, torch.cuda.device) and ctx.idx == s
    for devices in (["cuda:0", "cuda:0"], ["cpu", "cpu"]):
        tp = tsh.TensorParallel(GQA, tmesh.make_mesh(
            tmesh.MeshConfig(tensor=2), devices))
        sh = ttf._Shards(GQA, tsh.Shards([params, params], tp), None)
        assert not isinstance(sh.current(1), torch.cuda.device)


def test_eager_engine_across_cards_not_refused():
    """``cuda_graphs=False`` lifts the refusal: the engine goes on to
    place the shards (which this CPU-only torch cannot)."""
    params = model_params(GQA)
    mesh = tmesh.make_mesh(tmesh.MeshConfig(tensor=2), ["cuda:0", "cuda:1"])
    with pytest.raises((AssertionError, RuntimeError)) as e:
        teng.Engine(GQA, params, teng.EngineConfig(**ENGINE), dtype=F32,
                    device="cpu", mesh=mesh, cuda_graphs=False)
    assert "CUDA graphs across cards" not in str(e.value)
    assert tapi.build_parser().parse_args(["--no-cuda-graphs"]).no_cuda_graphs


def test_server_mesh_flag():
    httpd, eng, args = tapi.make_server([
        "--device", "cpu", "--dtype", "float32", "--host", "127.0.0.1",
        "--port", "0", "--max-seq-len", "64", "--decode-slots", "2",
        "--mesh", "tensor=2"])
    try:
        assert eng.tp is not None and eng.tp.t == 2
        assert [str(d) for d in eng.mesh.devices] == ["cpu", "cpu"]
        req = eng.generate(teng.Request(prompt_tokens=[1, 2, 3],
                                        max_new_tokens=3))
        assert req.error is None and len(req.output_tokens) == 3
    finally:
        httpd.server_close()
        eng.stop()
    with pytest.raises(ValueError, match="mesh axis data=2"):
        tapi.make_server(["--device", "cpu", "--port", "0",
                          "--mesh", "data=2,tensor=1"])


# ---------------------------------------------------------------------------
# The distinct-card branches on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture
def distinct_devices(monkeypatch):
    """Every ``TensorParallel`` takes its shards as on distinct devices
    (copies, a cache, tables and lengths per shard), and
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


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("name", ["gqa", "mqa"])
def test_sharded_forward_distinct_device_branches(distinct_devices,
                                                  forward_cases, name, quant):
    assert not tp_of(GQA, 2).one_device
    test_sharded_forward(forward_cases, name, 2, quant)


@pytest.mark.parametrize("mode", ["paged_prefix", "spec"])
def test_engine_distinct_device_branches(distinct_devices, mode):
    test_engine_tensor2_matches_tensor1(mode)


def test_hop_distinct_device_branches(distinct_devices):
    test_hops_across_tensor_sizes("1to2")
