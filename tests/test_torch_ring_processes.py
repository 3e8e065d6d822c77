"""Ring-attention serving with the ``sequence`` axis across processes
(``parallel/long_context.py``, ``parallel/collectives.exchange``, the
engine's ``_ring_prefill`` in lockstep), held to the JAX package on the
CPU at f32: OS processes joined over gloo (``parallel/multihost_check``),
every position on ``"cpu"``, the reference engine on its virtual
8-device mesh.

- The ring across processes is bitwise the one-process ring: each
  process folds its blocks over every block's K/V (exchanged) in the
  rotation's order, so its attention outputs, its blocks' logits and the
  whole prompt's K/V equal the one-process port ring's bit for bit; a
  block folded out of order (planted) does not.
- The engine: a 40-token prompt (buckets ``(8, 16)``) through exactly one
  ring program a process and a bucketed one, on lanes and on the paged
  pool with the prefix cache: every process reads back the JAX engine's
  greedy tokens on the same mesh.  Meshes: ``sequence=2`` (one position
  a process: the ring crosses the processes), ``tensor=2,sequence=2``
  over two processes (two positions each: tensor crosses them, the ring
  stays inside) and over four (both cross).
- A peer that dies mid-ring fails the other process by itself, long
  before the pair's deadline.

Tolerances: none; tokens are greedy and exact, the ring bitwise.
"""

import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_instance_gateway_tpu.models.configs import TINY_TEST as JAX_TINY
from llm_instance_gateway_tpu.parallel import mesh as jmesh
from llm_instance_gateway_tpu.server import engine as jeng

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch.models import transformer as ttf  # noqa: E402
from llm_instance_gateway_tpu_torch.models.configs import TINY_TEST  # noqa: E402
from llm_instance_gateway_tpu_torch.parallel import long_context as tlc  # noqa: E402
from llm_instance_gateway_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from llm_instance_gateway_tpu_torch.parallel import (  # noqa: E402
    multihost_check,
    sharding,
)
from llm_instance_gateway_tpu_torch.parallel.ring_attention import (  # noqa: E402
    ring_attention_blocks,
)

pytestmark = pytest.mark.e2e

GQA = dataclasses.replace(TINY_TEST, n_heads=8, n_kv_heads=4)
JAX_GQA = dataclasses.replace(JAX_TINY, n_heads=8, n_kv_heads=4)
PROMPT = [int(x) for x in np.random.RandomState(3).randint(1, 250, size=40)]
SHORT = list(range(5, 17))
RING_ENGINE = dict(decode_slots=2, max_seq_len=64, prefill_buckets=(8, 16))
MODES = {"lanes": {}, "paged": dict(paged_kv_block=8, prefix_cache=True)}
PADDED = 48  # PROMPT padded to the ring's multiple (16)

WORKER = r"""
import dataclasses, json, os, sys
sys.path.insert(0, os.environ["GRAFT_REPO"])
import numpy as np
import torch
from llm_instance_gateway_tpu_torch.models import transformer
from llm_instance_gateway_tpu_torch.models.configs import TINY_TEST
from llm_instance_gateway_tpu_torch.parallel import (
    collectives, long_context, sharding)
from llm_instance_gateway_tpu_torch.parallel.mesh import (
    initialize_distributed, make_mesh, parse_axes, world)
from llm_instance_gateway_tpu_torch.parallel.ring_attention import (
    ring_attention_blocks)
from llm_instance_gateway_tpu_torch.server.engine import (
    Engine, EngineConfig, Request, SamplingParams)

initialize_distributed()
rank, _ = world()
cfg = dataclasses.replace(TINY_TEST, n_heads=8, n_kv_heads=4)
mesh = make_mesh(parse_axes(os.environ["GRAFT_MESH"]),
                 ["cpu"] * int(os.environ["GRAFT_N_LOCAL"]))
params = transformer.init_params(cfg, seed=0, dtype=torch.float32,
                                 device="cpu")
tp = sharding.TensorParallel(cfg, mesh)
out = {"rank": rank, "seq_local": tp.seq_local, "shards": tp.shards,
       "exchanges": tp.seq_group is not None}
saved = {}

# The attention alone: this process's query blocks over every block's
# K/V, exchanged; and again with the sources folded out of order.
n = mesh.shape["sequence"]
q, k, v = (torch.from_numpy(x) for x in np.load(os.environ["GRAFT_QKV"])
           .values())
qs, ks, vs = (list(x.chunk(n, dim=1)) for x in (q, k, v))
mine = tp.seq_local
kv = collectives.exchange(torch.stack(
    [torch.cat([ks[j] for j in mine], 1), torch.cat([vs[j] for j in mine], 1)]),
    2, tp.seq_group)
ks_x, vs_x = (list(x.chunk(n, dim=1)) for x in kv)
for name, order in (("attn", 1), ("attn_reversed", -1)):
    got = ring_attention_blocks([qs[j] for j in mine], ks_x[::order],
                                vs_x[::order], first=mine[0])
    saved[name] = torch.cat(got, 1).numpy()

# The sharded prefill of PROMPT, padded, as the engine runs it.
prompt = json.loads(os.environ["GRAFT_PROMPT"])
tokens = torch.zeros((1, int(os.environ["GRAFT_PADDED"])), dtype=torch.long)
tokens[0, :len(prompt)] = torch.tensor(prompt)
positions = torch.arange(tokens.shape[1])[None]
sp = sharding.shard_params(params, tp)
with torch.no_grad():
    logits, kk, vv = long_context.make_sharded_prefill(cfg, mesh)(
        sp, *long_context.shard_inputs(mesh, tokens, positions))
    row = long_context.logits_row(sp, logits, len(prompt) - 1)
heads = tp.kv_heads(0)
saved.update(logits=logits.numpy(), row=row.numpy(),
             k=kk[:, :, :, heads].numpy(), v=vv[:, :, :, heads].numpy())
out["heads"] = [heads.start or 0, heads.stop or cfg.n_kv_heads]
np.savez(os.path.join(os.environ["GRAFT_OUT"], f"rank{rank}.npz"), **saved)

# The engine in lockstep, on lanes and on the pool.
for mode, extra in json.loads(os.environ["GRAFT_MODES"]).items():
    eng = Engine(cfg, params, EngineConfig(
        decode_slots=2, max_seq_len=64, prefill_buckets=(8, 16), **extra),
        eos_id=None, dtype=torch.float32, device="cpu", mesh=mesh,
        cuda_graphs=False)
    counts = {"ring": 0, "chunk": 0}
    for name, key in (("_ring", "ring"), ("_chunk_fn", "chunk")):
        def wrap(fn, key=key):
            def call(*a, **kw):
                counts[key] += 1
                return fn(*a, **kw)
            return call
        setattr(eng, name, wrap(getattr(eng, name)))
    reqs = [Request(prompt_tokens=list(p), max_new_tokens=6,
                    sampling=SamplingParams(temperature=0.0))
            for p in (prompt, list(range(5, 17)))]
    for r in reqs:
        eng.submit(r)
    eng.start()
    try:
        for r in reqs:
            assert r.done.wait(120) and r.error is None, r.error
    finally:
        eng.stop()
    out[mode] = {"tokens": [list(r.output_tokens) for r in reqs], **counts}
print("RING PROCESSES " + json.dumps(out), flush=True)
"""


def port_mesh(**axes):
    cfg = tmesh.MeshConfig(**axes)
    return tmesh.make_mesh(cfg, ["cpu"] * cfg.total)


def ref_mesh(**axes):
    cfg = jmesh.MeshConfig(**axes)
    return jmesh.make_mesh(cfg, devices=jax.devices()[:cfg.total])


def to_jax(tree):
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.detach().numpy())


@pytest.fixture(scope="module")
def params():
    return ttf.init_params(GQA, seed=0, dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def reference_tokens(params):
    """The JAX engine's greedy tokens on its ``axes`` mesh, per cache
    mode (the ring path for PROMPT, a bucket for SHORT)."""
    memo = {}

    def get(axes, mode):
        key = (tuple(sorted(axes.items())), mode)
        if key not in memo:
            eng = jeng.Engine(JAX_GQA, to_jax(params), jeng.EngineConfig(
                **RING_ENGINE, **MODES[mode]), eos_id=None,
                dtype=jnp.float32, mesh=ref_mesh(**axes))
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
            memo[key] = [list(r.output_tokens) for r in reqs]
        return memo[key]
    return get


def one_process(params, axes):
    """The one-process port ring over the same mesh: its attention on the
    worker's q/k/v and its sharded prefill of PROMPT."""
    m = port_mesh(**axes)
    sp = sharding.shard_params(params, sharding.TensorParallel(GQA, m))
    tokens = torch.zeros((1, PADDED), dtype=torch.long)
    tokens[0, :len(PROMPT)] = torch.tensor(PROMPT)
    with torch.no_grad():
        logits, k, v = tlc.make_sharded_prefill(GQA, m)(
            sp, *tlc.shard_inputs(m, tokens, torch.arange(PADDED)[None]))
    return logits.numpy(), k.numpy(), v.numpy()


def qkv_file(path, n):
    rng = np.random.default_rng(n)
    np.savez(path, q=rng.standard_normal((2, 16 * n, 8, 16), np.float32),
             k=rng.standard_normal((2, 16 * n, 2, 16), np.float32),
             v=rng.standard_normal((2, 16 * n, 2, 16), np.float32))
    with np.load(path) as z:
        return tuple(torch.from_numpy(z[x]) for x in ("q", "k", "v"))


CASES = {"s2": (dict(sequence=2), 2, 1),
         "t2s2": (dict(tensor=2, sequence=2), 2, 2),
         "t2s2x4": (dict(tensor=2, sequence=2), 4, 1)}


@pytest.mark.parametrize("case", list(CASES))
def test_ring_across_processes_serves_the_reference(params, reference_tokens,
                                                    tmp_path, case):
    axes, n_procs, n_local = CASES[case]
    n = axes["sequence"]
    q, k, v = qkv_file(str(tmp_path / "qkv.npz"), n)
    outs = multihost_check.run_processes(
        WORKER, n_procs, n_local=n_local, timeout_s=150,
        env={"GRAFT_MESH": ",".join(f"{a}={s}" for a, s in axes.items()),
             "GRAFT_QKV": str(tmp_path / "qkv.npz"),
             "GRAFT_PROMPT": json.dumps(PROMPT), "GRAFT_PADDED": str(PADDED),
             "GRAFT_MODES": json.dumps(MODES), "GRAFT_OUT": str(tmp_path)})
    res = [json.loads(line.split(" ", 2)[2]) for line in
           multihost_check.ok_lines(outs, "RING PROCESSES ")]
    assert any(r["exchanges"] for r in res) == (n_local == 1)

    # Bitwise the one-process ring, block for block.
    want_attn = torch.cat(ring_attention_blocks(
        *(list(x.chunk(n, dim=1)) for x in (q, k, v))), 1).numpy()
    logits, kk, vv = one_process(params, axes)
    s_loc = PADDED // n
    for r in res:
        got = np.load(str(tmp_path / f"rank{r['rank']}.npz"))
        mine = slice(r["seq_local"][0] * s_loc,
                     (r["seq_local"][-1] + 1) * s_loc)
        attn = slice(r["seq_local"][0] * 16, (r["seq_local"][-1] + 1) * 16)
        assert np.array_equal(got["attn"], want_attn[:, attn]), r["rank"]
        assert not np.array_equal(got["attn_reversed"], want_attn[:, attn])
        assert np.array_equal(got["logits"], logits[:, mine]), r["rank"]
        assert np.array_equal(got["row"], logits[:, len(PROMPT) - 1])
        heads = slice(*r["heads"])
        assert np.array_equal(got["k"], kk[:, :, :, heads]), r["rank"]
        assert np.array_equal(got["v"], vv[:, :, :, heads]), r["rank"]

    for mode in MODES:
        want = reference_tokens(axes, mode)
        for r in res:
            assert r[mode]["tokens"] == want, (case, mode, r["rank"])
            assert r[mode]["ring"] == 1 and r[mode]["chunk"] == 0


DEAD_WORKER = r"""
import dataclasses, os, sys
sys.path.insert(0, os.environ["GRAFT_REPO"])
import torch
from llm_instance_gateway_tpu_torch.models import transformer
from llm_instance_gateway_tpu_torch.models.configs import TINY_TEST
from llm_instance_gateway_tpu_torch.parallel import collectives
from llm_instance_gateway_tpu_torch.parallel.mesh import (
    MeshConfig, initialize_distributed, make_mesh, world)
from llm_instance_gateway_tpu_torch.server.engine import (
    Engine, EngineConfig, Request)

initialize_distributed()
rank, _ = world()
eng = Engine(TINY_TEST, transformer.init_params(
    TINY_TEST, dtype=torch.float32, device="cpu"),
    EngineConfig(decode_slots=2, max_seq_len=64, prefill_buckets=(8, 16)),
    eos_id=None, dtype=torch.float32, device="cpu",
    mesh=make_mesh(MeshConfig(sequence=2), ["cpu"]), cuda_graphs=False)
if rank == 1:  # dies at its second layer's exchange
    plain, calls = collectives.exchange, []

    def dying(*args):
        calls.append(1)
        if len(calls) == 2:
            os._exit(3)
        return plain(*args)
    collectives.exchange = dying
req = Request(prompt_tokens=list(range(1, 41)), max_new_tokens=4)
eng.submit(req)
eng.start()
try:
    assert req.done.wait(300), "the ring hung on a dead peer"
finally:
    eng.stop()
with open(os.path.join(os.environ["GRAFT_OUT"], f"rank{rank}.txt"), "w") as f:
    f.write(str(req.error))
"""


def test_dead_peer_mid_ring_fails_the_other_process(tmp_path):
    """Rank 1 exits inside the ring (its second layer's exchange): rank 0's
    collective fails, its request ends with the error, and the pair ends
    by itself well inside the deadline."""
    start = time.monotonic()
    with pytest.raises(RuntimeError, match="failed") as info:
        multihost_check.run_two_process(DEAD_WORKER, n_local=1,
                                        timeout_s=90,
                                        env={"GRAFT_OUT": str(tmp_path)})
    assert "timed out" not in str(info.value)
    assert time.monotonic() - start < 60
    error = (tmp_path / "rank0.txt").read_text()
    assert error not in ("", "None"), error
    assert not (tmp_path / "rank1.txt").exists()
