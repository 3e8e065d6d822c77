"""The ``data`` and ``fsdp`` mesh axes in the torch port, held to the JAX
package's engines on its virtual 8-device CPU mesh and to the port's own
``data=1`` / ``fsdp=1`` engines, on the CPU at f32 with every shard on
the CPU.

- ``data``: greedy tokens equal to the reference engine's at
  ``data=2, tensor=4`` (an 8:4 GQA model) and ``data=2, tensor=2,
  expert=2`` (``TINY_MOE_TEST``, the reference's own case), each with an
  adapter; speculative decoding, an int8 KV cache, grouped and
  pipelined admission, a chunk-streamed prompt and a ring prefill at
  ``data=2`` equal to ``data=1``; each data group's rows of one cache
  (views on one device) and the rows a prompt lands in; the refusals by
  name (a ``decode_slots`` that ``data`` does not divide, paged with
  ``data``).
- ``fsdp``: the pieces' shapes against the local blocks of the
  reference's ``param_specs`` / ``lora_specs`` (dense and int8) at
  ``fsdp=2`` and ``fsdp=2, tensor=2``; the gathered forward bitwise the
  unsplit one (the gather is a ``torch.cat`` of views: the same values
  in the same shapes); greedy tokens equal to the reference engine's at
  ``fsdp=2, tensor=2`` (lanes; the reference serves the pool too, and the
  port's pool engine is held to ``fsdp=1``); an adapter through the split
  ``o_b`` / ``down_b``.
- The distinct-card branches (per-group caches and copies, NCCL's gather
  and sum stood in for) driven on the CPU for both axes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_instance_gateway_tpu.models.configs import TINY_MOE_TEST as JAX_MOE
from llm_instance_gateway_tpu.models.configs import TINY_TEST as JAX_TINY
from llm_instance_gateway_tpu.parallel import mesh as jmesh
from llm_instance_gateway_tpu.parallel import sharding as jsh
from llm_instance_gateway_tpu.server import engine as jeng
from llm_instance_gateway_tpu.server.lora_manager import LoRAManager as JLoRA

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
GQA = dataclasses.replace(TINY_TEST, n_heads=8, n_kv_heads=4)
JAX_GQA = dataclasses.replace(JAX_TINY, n_heads=8, n_kv_heads=4)
MODELS = {"gqa": (GQA, JAX_GQA), "mqa": (TINY_TEST, JAX_TINY),
          "moe": (TINY_MOE_TEST, JAX_MOE)}
ENGINE = dict(decode_slots=4, max_seq_len=64, prefill_buckets=(8, 16, 32),
              decode_steps_per_sync=4)
PROMPTS = [[5, 6, 7, 11], [9, 8, 7, 6, 5, 4, 3, 2, 1, 30], [40, 41, 42],
           list(range(50, 70)), [3, 1, 4, 1, 5, 9, 2, 6]]
ADAPTERS = ["dp-adapter", None, "dp-adapter", None, "dp-adapter"]


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


def numpy_zeros(tree):
    if isinstance(tree, dict):
        return {k: numpy_zeros(v) for k, v in tree.items()}
    return np.zeros(tuple(tree.shape), np.float32 if tree.dtype != torch.int8
                    else np.int8)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat(v, key + "."))
        else:
            out[key] = v
    return out


def adapter(cfg, seed: int, rank: int = 3):
    rng = np.random.default_rng(seed)
    return {t: {"a": rng.standard_normal((cfg.n_layers, d_in, rank))
                .astype(np.float32) * 0.1,
                "b": rng.standard_normal((cfg.n_layers, rank, d_out))
                .astype(np.float32) * 0.1}
            for t, (d_in, d_out) in tlora.target_dims(cfg).items()}


def model_params(cfg, quant: bool = False):
    params = ttf.init_params(cfg, seed=0, dtype=F32, device="cpu")
    return quantize_params(params) if quant else params


def torch_engine(cfg, params, axes=None, lora=None, draft=None,
                 start=True, **overrides):
    manager = None
    if lora is not None:
        manager = TLoRA(cfg, dtype=F32, device="cpu")
        manager.load("dp-adapter", weights=lora, alpha=8.0, rank=3)
    kw = {}
    if draft is not None:
        kw = dict(draft_params=draft[1], draft_cfg=draft[0])
    eng = teng.Engine(cfg, params, teng.EngineConfig(**dict(ENGINE,
                                                            **overrides)),
                      lora_manager=manager, eos_id=None, dtype=F32,
                      device="cpu", mesh=port_mesh(**axes) if axes else None,
                      **kw)
    if start:
        eng.start()
    return eng


def run_all(eng, prompts, max_new=8, adapters=None, stop=True):
    try:
        reqs = [teng.Request(prompt_tokens=list(p), max_new_tokens=max_new,
                             adapter=(adapters[i] if adapters else None))
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        for r in reqs:
            assert r.done.wait(180), "request never finished"
            assert r.error is None, r.error
        return [list(r.output_tokens) for r in reqs]
    finally:
        if stop:
            eng.stop()


def jax_tokens(jcfg, params, axes, weights, prompts, adapters, **overrides):
    jm = ref_mesh(**axes)
    jlora = JLoRA(jcfg, dtype=jnp.float32, mesh=jm)
    jlora.load("dp-adapter", weights=weights, alpha=8.0, rank=3)
    jengine = jeng.Engine(jcfg, jax.tree.map(jnp.asarray, to_numpy(params)),
                          jeng.EngineConfig(**dict(ENGINE, **overrides)),
                          lora_manager=jlora, eos_id=None, dtype=jnp.float32,
                          mesh=jm)
    jengine.start()
    try:
        reqs = [jeng.Request(prompt_tokens=list(p), max_new_tokens=8,
                             adapter=a) for p, a in zip(prompts, adapters)]
        for r in reqs:
            jengine.submit(r)
        for r in reqs:
            assert r.done.wait(300) and r.error is None, r.error
        return [list(r.output_tokens) for r in reqs]
    finally:
        jengine.stop()


@pytest.fixture
def distinct_devices(monkeypatch):
    """Every shard grid takes its shards as on distinct devices (copies,
    a cache per data group and shard, fsdp pieces gathered by NCCL), with
    ``torch.cuda.nccl.all_reduce`` an in-place sum in shard order and
    ``all_gather`` the pieces stacked onto every output."""
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

    gathers = []

    def all_gather(ins, outs, streams=None):
        gathers.append(len(ins))
        for o in outs:
            o.copy_(torch.stack(ins))

    monkeypatch.setattr(tsh.TensorParallel, "__init__", as_distinct)
    monkeypatch.setattr(torch.cuda.nccl, "all_reduce", all_reduce)
    monkeypatch.setattr(torch.cuda.nccl, "all_gather", all_gather)
    return gathers


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

DATA_CASES = {"d2t4": ("gqa", dict(data=2, tensor=4)),
              "d2t2e2": ("moe", dict(data=2, tensor=2, expert=2))}


@pytest.mark.parametrize("case", list(DATA_CASES))
def test_data_engine_matches_jax_mesh_engine(case):
    name, axes = DATA_CASES[case]
    cfg, jcfg = MODELS[name]
    params = model_params(cfg)
    weights = adapter(cfg, 11)
    want = jax_tokens(jcfg, params, axes, weights, PROMPTS[:4],
                      ADAPTERS[:4])
    eng = torch_engine(cfg, params, axes, lora=weights, start=False)
    assert eng.tp.d == 2 and len(eng.params.data) == 2
    assert len(eng.lora.buffers.data) == 2 and len(eng.cache.data) == 2
    eng.start()
    got = run_all(eng, PROMPTS[:4], adapters=ADAPTERS[:4])
    assert got == want
    base = run_all(torch_engine(cfg, params, axes), PROMPTS[:1])
    assert got[0] != base[0]  # the adapter row took its adapter


DATA_MODES = {
    "spec": dict(speculative_k=3),
    "int8_lanes": dict(kv_cache_quant="int8"),
    "grouped_pipelined": dict(prefill_batch=3, pipeline_decode=True),
    "chunk_stream": dict(stream_lanes=2),
}


@pytest.mark.parametrize("mode", list(DATA_MODES))
def test_data2_matches_data1(mode):
    """Every lane path at ``data=2`` gives ``data=1``'s greedy tokens: the
    spec verify and draft lanes, int8 lanes, grouped prefill whose rows
    span both groups (one program per group) with pipelined dispatch,
    and prompts beyond the largest bucket streaming into a row of group
    1."""
    overrides = DATA_MODES[mode]
    draft = None
    prompts = PROMPTS
    if mode == "spec":
        draft = (TINY_TEST, ttf.init_params(TINY_TEST, seed=1, dtype=F32,
                                            device="cpu"))
    if mode == "chunk_stream":
        prompts = PROMPTS[:3] + [list(range(1, 45)), list(range(7, 50))]
    if mode == "grouped_pipelined":  # one bucket: groups of three
        prompts = [PROMPTS[0], PROMPTS[2], PROMPTS[4], [7, 7, 7], [1, 2]]
    params = model_params(GQA, quant=mode == "int8_lanes")
    out = []
    for axes in (None, dict(data=2)):
        eng = torch_engine(GQA, params, axes, draft=draft, start=False,
                           **overrides)
        groups = []
        impl = eng._prefill_many_impl
        eng._prefill_many_impl = lambda *a: groups.append(
            None if a[5] is None else sorted(set(a[5].tolist()))) or impl(*a)
        eng.start()
        out.append(run_all(eng, prompts))
        if mode == "spec":
            assert eng.spec_cycles > 0
        if mode == "grouped_pipelined" and axes:
            assert [0, 1] in groups  # a group spanning both data groups
    assert out[1] == out[0]


def test_ring_prefill_inside_a_data_group():
    """``data=2, sequence=2`` (the reference's ``MeshConfig(sequence=n,
    data=8 // n)`` layout): a prompt beyond the largest bucket runs one
    ring program in its row's data group, tokens equal to ``data=1``'s."""
    params = model_params(GQA)
    prompts = [PROMPTS[0], PROMPTS[1], list(range(1, 45))]
    out = []
    for axes in (dict(sequence=2), dict(data=2, sequence=2)):
        eng = torch_engine(GQA, params, axes, start=False, decode_slots=2)
        rings = []
        ring = eng._ring_prefill
        eng._ring_prefill = lambda *a: rings.append(a[-1]) or ring(*a)
        eng.start()
        out.append(run_all(eng, prompts))
        assert len(rings) == 1
    assert out[1] == out[0]


def test_data_groups_hold_their_rows():
    """On one device each data group's cache is its block of rows of one
    cache (views), its params group 0's trees; a prompt admitted into row
    3 lands in group 1's row 1 and nowhere else."""
    params = model_params(GQA)
    eng = torch_engine(GQA, params, dict(data=2, tensor=2), start=False)
    full = eng.cache.data[0][0]["k"]
    for g, cg in enumerate(eng.cache.data):
        for s, c in enumerate(cg):
            assert c["k"].shape[1] == 2
            assert c["k"].untyped_storage().data_ptr() == (
                eng.cache.data[0][s]["k"].untyped_storage().data_ptr())
        assert [t is u for t, u in zip(eng.params.data[g],
                                       eng.params.data[0])] == [True, True]
    eng._reserved_slots = {0, 1, 2}  # rows 0-2 held: the prompt takes 3
    req = teng.Request(prompt_tokens=[5, 6, 7, 8, 9], max_new_tokens=2)
    eng.submit(req)
    eng._admit_and_insert(False)
    assert req.error is None, req.error
    g1 = eng.cache.data[1]
    assert int(g1[0]["length"][1]) == 5
    assert all(int(c["length"][r]) == 0 for c in eng.cache.data[0]
               for r in range(2))
    assert g1[0]["k"][:, 1, :5].abs().sum() > 0
    assert full[:, :, :5].abs().sum() == 0  # group 0's rows untouched


def test_data_refusals_by_name():
    params = model_params(GQA)
    with pytest.raises(ValueError, match="decode_slots=3 is not divisible "
                                         "by data=2"):
        torch_engine(GQA, params, dict(data=2), decode_slots=3, start=False)
    with pytest.raises(ValueError, match="paged KV on a mesh requires "
                                         "data=1"):
        torch_engine(GQA, params, dict(data=2), paged_kv_block=8,
                     start=False)
    with pytest.raises(ValueError, match="pipe=1"):
        torch_engine(GQA, params, dict(pipe=2), start=False)


# ---------------------------------------------------------------------------
# fsdp
# ---------------------------------------------------------------------------


def port_shapes(tree):
    """Each leaf's piece shape (an ``FsdpLeaf``'s first piece)."""
    def shape(x):
        if isinstance(x, dict):
            return {k: shape(v) for k, v in x.items()}
        if isinstance(x, tsh.FsdpLeaf):
            assert len({tuple(p.shape) for p in x.pieces}) == 1
            return tuple(x.pieces[0].shape)
        return tuple(x.shape)
    return flat(shape(tree))


def ref_shapes(tree, specs, axes):
    placed = jsh.shard_pytree(numpy_zeros(tree), specs, ref_mesh(**axes))
    return flat(jax.tree.map(lambda x: tuple(x.sharding.shard_shape(
        x.shape)), placed, is_leaf=lambda x: hasattr(x, "sharding")))


FSDP_AXES = {"f2": dict(fsdp=2), "f2t2": dict(fsdp=2, tensor=2),
             "f2e2": dict(fsdp=2, expert=2)}


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("name,axes", [
    (name, axes) for name in ("gqa", "mqa", "moe") for axes in FSDP_AXES
    if name == "moe" or "e2" not in axes])
def test_fsdp_param_shard_shapes(name, axes, quant):
    axes = FSDP_AXES[axes]
    cfg, jcfg = MODELS[name]
    params = model_params(cfg, quant)
    grid = tsh.TensorParallel(cfg, port_mesh(**axes))
    want = ref_shapes(params, jsh.param_specs(jcfg), axes)
    sharded = tsh.shard_params(params, grid)
    full = port_shapes(params)
    # The port's by design (test_torch_mesh.py): embeddings whole on every
    # shard, lm_head whole over tensor (split over fsdp as the reference
    # splits it), a replicated KV head's projections whole over tensor.
    t = axes.get("tensor", 1)
    differ = {}
    if t > 1:
        differ["embed"] = full["embed"]
        for leaf in ("lm_head", "lm_head.q"):
            if leaf in full:
                differ[leaf] = (full[leaf][0] // 2, full[leaf][1])
        if "lm_head.s" in full:
            differ["lm_head.s"] = full["lm_head.s"]
        if not grid.kv_split:
            for leaf in full:
                if leaf.split(".")[:2] in (["layers", "wk"],
                                           ["layers", "wv"]):
                    shape = list(full[leaf])
                    if len(shape) == 3 and not leaf.endswith(".s"):
                        shape[1] //= 2  # fsdp still splits D
                    differ[leaf] = tuple(shape)
    split = 0
    for tree in sharded:
        got = port_shapes(tree)
        assert got.keys() == want.keys()
        for leaf, shape in got.items():
            if leaf in differ:
                assert shape == differ[leaf] != want[leaf], leaf
            else:
                assert shape == want[leaf], leaf
        split += sum(isinstance(x, tsh.FsdpLeaf)
                     for x in flat(tree).values())
    assert split > 0


@pytest.mark.parametrize("axes", ["f2", "f2t2"])
def test_fsdp_lora_shard_shapes(axes):
    axes = FSDP_AXES[axes]
    cfg, jcfg = MODELS["gqa"]
    bufs = tlora.init_lora_buffers(cfg, dtype=F32, device="cpu")
    grid = tsh.TensorParallel(cfg, port_mesh(**axes))
    want = ref_shapes(bufs, jsh.lora_specs(jcfg), axes)
    dims = tlora.target_dims(grid.cfg)
    r, slots, n_l = cfg.max_lora_rank, cfg.max_lora_slots, cfg.n_layers
    # The port's row targets split ``a`` on d_in over tensor.
    differ = ({f"{x}_a": (n_l, slots, dims[x][0], r) for x in ("o", "down")}
              if axes.get("tensor", 1) > 1 else {})
    for tree in tsh.shard_lora(bufs, grid):
        got = port_shapes(tree)
        assert isinstance(tree["o_b"], tsh.FsdpLeaf)
        for leaf, shape in got.items():
            if leaf in differ:
                assert shape == differ[leaf] != want[leaf], leaf
            else:
                assert shape == want[leaf], leaf


def _forward(cfg, params, lora, axes):
    """Prefill logits and one lane decode step's logits over a mesh (None:
    unsharded) with mixed adapter rows."""
    b, s = 2, 12
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(0, 300, (b, s)))
    positions = torch.arange(s)[None].expand(b, s).clone()
    slots = torch.tensor([0, -1])
    if axes:
        grid = tsh.TensorParallel(cfg, port_mesh(**axes))
        params, lora = (tsh.shard_params(params, grid),
                        tsh.shard_lora(lora, grid))

    def make(c, d, rows=b):
        return ttf.init_decode_cache(c, rows, 32, dtype=F32, device=d)
    cache = (tsh.shard_cache(make, grid, rows=b) if axes
             else make(cfg, "cpu"))
    with torch.no_grad():
        logits, k, v = ttf.prefill(cfg, params, tokens, positions,
                                   lora_bufs=lora, slot_ids=slots)
        for row in range(b):
            ttf.insert_prefill(cache, k[:, row:row + 1], v[:, row:row + 1],
                               row, s)
        step, _ = ttf.decode_step(cfg, params, cache, tokens[:, -1],
                                  torch.full((b,), s), lora_bufs=lora,
                                  slot_ids=slots)
    return logits, step


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("axes", ["f2", "f2t2"])
def test_fsdp_forward_is_bitwise_unsplit(axes, quant):
    """The gathered weights are the same values in the same shapes, so the
    forward at fsdp=2 equals fsdp=1's bitwise, adapters included."""
    axes = FSDP_AXES[axes]
    params = model_params(GQA, quant)
    lora = tlora.init_lora_buffers(GQA, dtype=F32, device="cpu")
    tlora.write_adapter(lora, GQA, 0, adapter(GQA, 2), 8.0, 3)
    base = dict(axes, fsdp=1)
    want = _forward(GQA, params, lora, base if base != {"fsdp": 1} else None)
    got = _forward(GQA, params, lora, axes)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


FSDP_ENGINES = {"lanes": {}, "paged": dict(paged_kv_block=8,
                                           prefix_cache=True)}


@pytest.mark.parametrize("mode", list(FSDP_ENGINES))
def test_fsdp_engine_matches_reference_and_fsdp1(mode):
    """``fsdp=2, tensor=2`` greedy tokens (adapter rows too) equal the
    reference engine's at the same mesh (lanes) and the port's at
    ``fsdp=1, tensor=2`` (lanes and the paged pool with the prefix
    cache)."""
    cfg, jcfg = MODELS["gqa"]
    params = model_params(cfg)
    weights = adapter(cfg, 11)
    overrides = FSDP_ENGINES[mode]
    axes = dict(fsdp=2, tensor=2)
    got = run_all(torch_engine(cfg, params, axes, lora=weights,
                               **overrides), PROMPTS, adapters=ADAPTERS)
    want = run_all(torch_engine(cfg, params, dict(tensor=2), lora=weights,
                                **overrides), PROMPTS, adapters=ADAPTERS)
    assert got == want
    if mode == "lanes":
        assert got == jax_tokens(jcfg, params, axes, weights, PROMPTS,
                                 ADAPTERS)


# ---------------------------------------------------------------------------
# The distinct-card branches on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("axes", ["f2", "f2t2"])
def test_fsdp_forward_distinct_device_branches(distinct_devices, axes):
    axes = FSDP_AXES[axes]
    params = model_params(GQA)
    lora = tlora.init_lora_buffers(GQA, dtype=F32, device="cpu")
    tlora.write_adapter(lora, GQA, 0, adapter(GQA, 2), 8.0, 3)
    grid = tsh.TensorParallel(GQA, port_mesh(**axes))
    assert not grid.one_device
    base = dict(axes, fsdp=1)
    want = _forward(GQA, params, lora, base if base != {"fsdp": 1} else None)
    got = _forward(GQA, params, lora, axes)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # Every projection of every layer and the head, per forward.
    assert len(distinct_devices) > 2 * GQA.n_layers


@pytest.mark.parametrize("axes", [dict(data=2), dict(data=2, tensor=2),
                                  dict(fsdp=2, data=2)],
                         ids=["d2", "d2t2", "f2d2"])
def test_engine_distinct_device_branches(distinct_devices, axes):
    """Per-group caches (each made with its rows) and copies: tokens equal
    to the unsharded engine's, an adapter row included."""
    params = model_params(GQA)
    weights = adapter(GQA, 11)
    eng = torch_engine(GQA, params, axes, lora=weights, start=False)
    assert not eng.tp.one_device
    rows = [tsh.parts(c)[0]["k"].shape[1] for c in eng.cache.data]
    assert rows == [2, 2]
    eng.start()
    got = run_all(eng, PROMPTS, adapters=ADAPTERS)
    want = run_all(torch_engine(GQA, params, lora=weights), PROMPTS,
                   adapters=ADAPTERS)
    assert got == want
