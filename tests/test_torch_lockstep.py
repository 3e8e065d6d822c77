"""Lockstep serving beyond the sync loop across processes: the pipelined
loop, the adaptive planner and the handoff TTL sweep of
``server/engine.py`` on a mesh that spans two OS processes (gloo, 4
positions a process on ``"cpu"``, ``parallel/multihost_check``), held to
the JAX package's one-process engine, to the port's one-process engine on
the same axes and, for the row that takes every path at once, to the
reference's own two-process run.  The reference's serve-check weights
(``init_params(PRNGKey(0))``) at f32, carried across as ``.npz``.

Rows, each one ``EngineConfig`` (``multihost_check.SERVE_ENGINE``: two
slots, one bucket of 16) over one mesh:

- (a) ``tensor=8``, ``pipeline_decode``;
- (b) ``tensor=8``, ``adaptive_steps=4``;
- (c) ``tensor=8``, both, with a 20-token prompt (a chunk stream) and a
  third request that parks in ``decode_wait`` until a slot frees: the
  planner's admission-pressure branch;
- (d) ``fsdp=2,tensor=4``, both, on the paged pool;
- (e) ``tensor=4,sequence=2``, ``pipeline_decode``, the 20-token prompt
  through the ring.

The TTL rows park a seeded handoff past ``handoff_ttl_s`` while both
slots are busy, with one process's engine clock frozen: the first
process's verdict is every process's, so with rank 1 frozen both release
it (``kv_release`` and the KV ledger say ``ttl``) and with rank 0 frozen
neither does and it decodes once a slot frees.  An idle engine with a TTL
set issues no broadcast.

Tolerances: none; tokens are greedy and exact.
"""

import dataclasses
import hashlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_instance_gateway_tpu.models import transformer as jtf
from llm_instance_gateway_tpu.models.configs import LLAMA3_8B as JLLAMA3_8B
from llm_instance_gateway_tpu.parallel import mesh as jmesh
from llm_instance_gateway_tpu.parallel import multihost_check as jcheck
from llm_instance_gateway_tpu.server import engine as jeng

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch.models.configs import LLAMA3_8B  # noqa: E402
from llm_instance_gateway_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from llm_instance_gateway_tpu_torch.parallel import multihost_check as mc  # noqa: E402
from llm_instance_gateway_tpu_torch.server import engine as teng  # noqa: E402

pytestmark = pytest.mark.e2e

LONG = list(range(20, 40))  # beyond the largest bucket (16)
WAITING = ([5, 6, 7], LONG, [9, 10, 11, 12])
BOTH = {"pipeline_decode": True, "adaptive_steps": 4}
ROWS = {
    "a": ("tensor=8", {"pipeline_decode": True}, mc.SERVE_PROMPTS),
    "b": ("tensor=8", {"adaptive_steps": 4}, mc.SERVE_PROMPTS),
    "c": ("tensor=8", BOTH, WAITING),
    "d": ("fsdp=2,tensor=4", {**BOTH, "paged_kv_block": 8}, WAITING),
    "e": ("tensor=4,sequence=2", {"pipeline_decode": True},
          (LONG, [5, 6, 7])),
}
TTL_ENGINE = {**BOTH, "paged_kv_block": 8, "handoff_ttl_s": 1e-3}
HANDOFF = dict(n=5, seed=7, max_new=6)
TTL_NEW = 12  # the busy slots' budget: they outlast the TTL
TTL = {"rank1_frozen": [1], "rank0_frozen": [0]}


def runs() -> list:
    out = [mc.serve_run(name, mesh, engine, prompts)
           for name, (mesh, engine, prompts) in ROWS.items()]
    out += [mc.serve_run(name, engine=TTL_ENGINE, max_new=TTL_NEW,
                         handoff=HANDOFF, frozen=frozen)
            for name, frozen in TTL.items()]
    out.append(mc.serve_run("idle", engine=TTL_ENGINE, prompts=(),
                            idle_s=0.3))
    return out


def run_named(name: str) -> dict:
    return next(run for run in runs() if run["name"] == name)


@pytest.fixture(scope="module")
def serve_weights(tmp_path_factory):
    """The reference's serve-check weights, as the reference tree and as
    the ``.npz`` the workers load."""
    jcfg = dataclasses.replace(JLLAMA3_8B, **mc.SERVE_CFG,
                               use_flash_attention=False,
                               use_pallas_decode=False)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    path = str(tmp_path_factory.mktemp("lockstep") / "weights.npz")
    mc.save_tree(path, jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, path


@pytest.fixture(scope="module")
def served(serve_weights):
    """Every run in one launch of two processes: run name -> each
    process's ``multihost_check.serve`` result."""
    todo = runs()
    got = mc.run_two_process_serves(todo, weights=serve_weights[2],
                                    timeout_s=120)
    return {run["name"]: [got[0][i], got[1][i]]
            for i, run in enumerate(todo)}


def same_on_both(res):
    a, b = ({k: v for k, v in r.items() if k != "wall_s"} for r in res)
    assert a == b, (a, b)
    assert not a["errors"], a["errors"]
    return a


def port_one_process(path, run) -> dict:
    """The port's one-process engine over the run's axes (every position
    on the CPU), serving it as the worker does, the clock frozen where the
    first process's was."""
    cfg = dataclasses.replace(LLAMA3_8B, **mc.SERVE_CFG)
    mesh_cfg = tmesh.parse_axes(run["mesh"])
    engine = teng.Engine(
        cfg, mc.load_tree(path),
        teng.EngineConfig(**{**mc.SERVE_ENGINE, **run["engine"]}),
        eos_id=None, dtype=torch.float32, seed=0, device="cpu",
        mesh=tmesh.make_mesh(mesh_cfg, ["cpu"] * mesh_cfg.total),
        cuda_graphs=False)
    handoff = mc.seeded_handoff(cfg, **run["handoff"]) if run["handoff"] \
        else None
    return mc.serve(engine, run["prompts"], run["max_new"], handoff=handoff,
                    freeze_clock=0 in run["frozen"])


def jax_tokens(jcfg, jparams, run) -> list:
    """The JAX package's one-process engine with the run's
    ``EngineConfig``: on its virtual mesh where the run takes the ring,
    else on one device."""
    axes = {k: int(v) for k, v in (
        part.split("=") for part in run["mesh"].split(","))}
    mesh = (jmesh.make_mesh(jmesh.MeshConfig(**axes),
                            devices=jax.devices()[:8])
            if axes.get("sequence", 1) > 1 else None)
    engine = jeng.Engine(jcfg, jparams, jeng.EngineConfig(
        **{**mc.SERVE_ENGINE, **run["engine"]}), eos_id=None,
        dtype=jnp.float32, seed=0, mesh=mesh)
    reqs = [jeng.Request(prompt_tokens=list(p), max_new_tokens=run["max_new"],
                         sampling=jeng.SamplingParams(temperature=0.0))
            for p in run["prompts"]]
    for r in reqs:
        engine.submit(r)
    engine.start()
    try:
        for r in reqs:
            assert r.done.wait(120) and r.error is None, r.error
    finally:
        engine.stop()
    return [list(map(int, r.output_tokens)) for r in reqs]


@pytest.mark.parametrize("row", sorted(ROWS))
def test_lockstep_row_serves_as_one_process(serve_weights, served, row):
    """Both processes read back the same tokens, the JAX package's
    one-process engine's and the port's one-process engine's on the same
    axes, through the paths the row names."""
    jcfg, jparams, path = serve_weights
    got = same_on_both(served[row])
    run = run_named(row)
    assert got["tokens"] == jax_tokens(jcfg, jparams, run), row
    assert got["tokens"] == port_one_process(path, run)["tokens"], row
    # No handoff parked: no TTL verdict to agree on (and at
    # tensor=4,sequence=2 the ring stays inside each process).
    assert got["broadcasts"] == 0, got["broadcasts"]
    paths, counts = got["paths"], got["dispatch_counts"]
    if row in ("c", "d"):  # a chunk stream, a park, blocks of 1 and more
        assert paths == {"ring": 0, "stream": 1, "park": 1}, paths
        assert counts[0] > 0 and sum(counts[1:]) > 0, counts
    elif row == "e":
        assert paths == {"ring": 1, "stream": 0, "park": 0}, paths
    elif row == "b":
        assert sum(counts[1:]) > 0, counts


# The reference's serve worker with row (c)'s EngineConfig and requests.
JAX_WORKER = r"""
import json, os, sys
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.environ["GRAFT_REPO"])
from llm_instance_gateway_tpu.parallel.mesh import (
    MeshConfig, initialize_distributed, make_mesh)
initialize_distributed()
import dataclasses
import jax.numpy as jnp
from llm_instance_gateway_tpu.models import transformer
from llm_instance_gateway_tpu.models.configs import LLAMA3_8B
from llm_instance_gateway_tpu.server.engine import (
    Engine, EngineConfig, Request, SamplingParams)

run = json.loads(os.environ["GRAFT_RUN"])
cfg = dataclasses.replace(LLAMA3_8B, **run["cfg"], use_flash_attention=False,
                          use_pallas_decode=False)
params = transformer.init_params(cfg, jax.random.PRNGKey(0),
                                 dtype=jnp.float32)
engine = Engine(cfg, params, EngineConfig(**run["engine"]), eos_id=None,
                dtype=jnp.float32, seed=0, mesh=make_mesh(MeshConfig(tensor=8)))
reqs = [Request(prompt_tokens=p, max_new_tokens=run["max_new"],
                sampling=SamplingParams(temperature=0.0))
        for p in run["prompts"]]
for r in reqs:
    engine.submit(r)
engine.start()
try:
    for r in reqs:
        assert r.done.wait(120) and r.error is None, r.error
finally:
    engine.stop()
print("REFERENCE LOCKSTEP " + json.dumps(
    [list(map(int, r.output_tokens)) for r in reqs]), flush=True)
"""


def test_row_c_is_the_reference_two_process_run(served, monkeypatch):
    """Row (c) (tensor=8 across the processes, the pipelined loop and the
    planner, a chunk stream and a park): the tokens of the reference's
    own two-process run of the same config, launched through its
    ``multihost_check.run_two_process``."""
    run = run_named("c")
    monkeypatch.setenv("GRAFT_RUN", json.dumps({
        "cfg": mc.SERVE_CFG, "engine": {**mc.SERVE_ENGINE, **run["engine"]},
        "prompts": run["prompts"], "max_new": run["max_new"]}))
    outs = jcheck.run_two_process(JAX_WORKER, timeout_s=120)
    want = [json.loads(line.split(" ", 2)[2])
            for out in outs for line in out.splitlines()
            if line.startswith("REFERENCE LOCKSTEP ")]
    assert len(want) == 2 and want[0] == want[1], outs[0][-2000:]
    assert same_on_both(served["c"])["tokens"] == want[0]


@pytest.mark.parametrize("case", sorted(TTL))
def test_ttl_verdict_is_the_first_process_s(serve_weights, served, case):
    """A handoff parked past the TTL while both slots are busy, one
    process's clock frozen: both processes take the first process's
    decision (released with rank 1 frozen, decoded with rank 0 frozen),
    through the verdict's broadcast, with the same tokens as the port's
    one-process engine under the first process's clock."""
    got = same_on_both(served[case])
    run = run_named(case)
    want = mc.seeded_handoff(dataclasses.replace(LLAMA3_8B, **mc.SERVE_CFG),
                             **HANDOFF)
    assert got["handoff_sha256"] == hashlib.sha256(
        want.to_bytes()).hexdigest()
    assert got["broadcasts"] > 0
    assert got["finish"][:2] == ["length", "length"]
    if case == "rank1_frozen":
        assert got["finish"][2] == "cancelled"
        assert got["tokens"][2] == [want.first_token]
        assert [e["reason"] for e in got["kv_release"]] == ["ttl"]
        assert got["ledger_sweeps"] == ["ttl"]
    else:
        assert got["finish"][2] == "length"
        assert len(got["tokens"][2]) == HANDOFF["max_new"]
        assert got["kv_release"] == [] and got["ledger_sweeps"] == []
    one = port_one_process(serve_weights[2], run)
    assert (got["tokens"], got["finish"]) == (one["tokens"], one["finish"])
    assert one["broadcasts"] == 0  # one process: nothing to agree on


def test_idle_engine_with_a_ttl_issues_no_broadcast(served):
    """An engine with ``handoff_ttl_s`` set and nothing parked, its loop
    idle for 0.3 s: no agreement collective on either process."""
    got = same_on_both(served["idle"])
    assert got["broadcasts"] == 0 and got["tokens"] == []


def test_engine_takes_a_shard_tree_of_its_own_mesh():
    """A second engine over a ``Shards`` another engine on the same mesh
    holds serves from that copy (the same tokens, no new shard tree); a
    tree cut for another mesh is refused by name."""
    from llm_instance_gateway_tpu_torch.models import transformer

    cfg = dataclasses.replace(LLAMA3_8B, **mc.SERVE_CFG)
    mesh = tmesh.make_mesh(tmesh.MeshConfig(tensor=2), ["cpu"] * 2)

    def engine(params, m=mesh, **extra):
        return teng.Engine(cfg, params, teng.EngineConfig(
            **{**mc.SERVE_ENGINE, **extra}), eos_id=None,
            dtype=torch.float32, device="cpu", mesh=m, cuda_graphs=False)

    first = engine(transformer.init_params(cfg, seed=0, dtype=torch.float32,
                                           device="cpu"))
    second = engine(first.params, **BOTH)
    assert second.params is first.params
    want = mc.serve(first, mc.SERVE_PROMPTS, 6)["tokens"]
    assert mc.serve(second, mc.SERVE_PROMPTS, 6)["tokens"] == want
    with pytest.raises(ValueError, match="another mesh"):
        engine(first.params, tmesh.make_mesh(tmesh.MeshConfig(fsdp=2),
                                             ["cpu"] * 2))
