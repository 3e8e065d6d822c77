"""The port across processes (``parallel/mesh.initialize_distributed``,
``parallel/collectives.py``, ``parallel/multihost_check.py``) against the
JAX reference, on the CPU: two OS processes joined over gloo, each holding
4 mesh positions on ``"cpu"``, as the reference's two-process checks
(``tests/test_multihost.py``) give each process 4 virtual devices.  The
same configs, at f32, on the reference's ``init_params(PRNGKey(0))``
weights carried across through ``.npz`` files.

Tolerances, each for its reason:

- tokens: greedy and exact (the reference's serving check);
- ``LOSS_RTOL`` (1e-5, relative): the loss against the reference's jitted
  step on the whole batch, f32 summation order only;
- ``UPDATE_TOL`` (1e-3) over ``NOISE_FLOOR`` (1e-3 of a leaf's largest
  |grad|): ``tests/test_torch_train.py``'s update check (Adam turns a
  gradient at rounding noise into a +-lr step, so only updates whose
  reference gradient clears the floor are compared).  Adam's step does
  not see a gradient scaled uniformly, so the planted fault (a
  row-parallel sum that all-reduces its gradient too) is planted where
  ``tensor`` spans the processes: there it scales the block branches of
  the residual and not the residual itself, which the check sees.
"""

import dataclasses
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import yaml

from llm_instance_gateway_tpu.models import lora as jlora
from llm_instance_gateway_tpu.models import transformer as jtf
from llm_instance_gateway_tpu.models.configs import LLAMA3_8B as JLLAMA3_8B
from llm_instance_gateway_tpu.server import engine as jeng
from llm_instance_gateway_tpu.training import train as jtrain

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch.models.configs import LLAMA3_8B  # noqa: E402
from llm_instance_gateway_tpu_torch.parallel import (  # noqa: E402
    collectives,
    mesh as tmesh,
    multihost_check,
    sharding,
)
from llm_instance_gateway_tpu_torch.server import api_http as tapi  # noqa: E402
from llm_instance_gateway_tpu_torch.server import engine as teng  # noqa: E402
from llm_instance_gateway_tpu_torch.training import train as ttrain  # noqa: E402

pytestmark = pytest.mark.e2e

LOSS_RTOL = 1e-5
UPDATE_TOL = 1e-3
NOISE_FLOOR = 1e-3
LR = 1e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_multihost.py's configs: its train worker's and its serve
# worker's (multihost_check.SERVE_WORKER).
TRAIN_CFG = dict(name="multihost-dryrun", vocab_size=512, d_model=64,
                 n_layers=2, n_heads=4, n_kv_heads=4, d_ff=128, head_dim=16,
                 max_seq_len=64)
SERVE_CFG = dict(name="multihost-serve", vocab_size=256, d_model=64,
                 n_layers=2, n_heads=8, n_kv_heads=8, d_ff=128, head_dim=8,
                 max_seq_len=64)
SERVE_PROMPTS = ([5, 6, 7], [9, 10, 11, 12])


def jax_cfg(fields, **extra):
    return dataclasses.replace(JLLAMA3_8B, **fields, **extra)


def port_cfg(fields):
    return dataclasses.replace(LLAMA3_8B, **fields)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def flat(tree, prefix=""):
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = v
    return out


# ---------------------------------------------------------------------------
# the env contract
# ---------------------------------------------------------------------------


def test_initialize_distributed_is_a_noop_without_env(monkeypatch):
    for name in ("TPU_GATEWAY_COORDINATOR", "TPU_GATEWAY_PROCESS_ID",
                 "TPU_GATEWAY_NUM_PROCESSES", "MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    tmesh.initialize_distributed()
    assert not torch.distributed.is_initialized()
    assert tmesh.world() == (0, 1)
    mesh = tmesh.make_mesh(tmesh.MeshConfig(tensor=2), ["cpu", "cpu"])
    assert not mesh.spans_processes and mesh.local(1)
    assert mesh.group("tensor") is None
    assert collectives.reduce(torch.ones(2), None).tolist() == [1.0, 1.0]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def serve_weights(tmp_path_factory):
    """The reference's serve-check weights (``init_params(PRNGKey(0))``),
    as the reference tree and as the ``.npz`` the workers load."""
    jcfg = jax_cfg(SERVE_CFG, use_flash_attention=False,
                   use_pallas_decode=False)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    path = str(tmp_path_factory.mktemp("serve") / "weights.npz")
    multihost_check.save_tree(path, to_np(jparams))
    return jcfg, jparams, path


def jax_tokens(jcfg, jparams) -> str:
    engine = jeng.Engine(jcfg, jparams, jeng.EngineConfig(
        decode_slots=2, max_seq_len=64, prefill_buckets=(16,)),
        eos_id=None, dtype=jnp.float32, seed=0)
    reqs = [jeng.Request(prompt_tokens=list(p), max_new_tokens=6,
                         sampling=jeng.SamplingParams(temperature=0.0))
            for p in SERVE_PROMPTS]
    for r in reqs:
        engine.submit(r)
    engine.start()
    try:
        for r in reqs:
            assert r.done.wait(120) and r.error is None, r.error
    finally:
        engine.stop()
    return ";".join(",".join(map(str, r.output_tokens)) for r in reqs)


def port_tokens(path: str, axes: str) -> str:
    """The port's one-process engine over ``axes`` (every position on the
    CPU), on the weights at ``path``."""
    cfg = port_cfg(SERVE_CFG)
    mesh_cfg = tmesh.parse_axes(axes)
    engine = teng.Engine(
        cfg, multihost_check.load_tree(path),
        teng.EngineConfig(decode_slots=2, max_seq_len=64,
                          prefill_buckets=(16,)),
        eos_id=None, dtype=torch.float32, seed=0, device="cpu",
        mesh=tmesh.make_mesh(mesh_cfg, ["cpu"] * mesh_cfg.total),
        cuda_graphs=False)
    reqs = [teng.Request(prompt_tokens=list(p), max_new_tokens=6,
                         sampling=teng.SamplingParams(temperature=0.0))
            for p in SERVE_PROMPTS]
    for r in reqs:
        engine.submit(r)
    engine.start()
    try:
        for r in reqs:
            assert r.done.wait(120) and r.error is None, r.error
    finally:
        engine.stop()
    return ";".join(",".join(map(str, r.output_tokens)) for r in reqs)


def test_two_processes_serve_tensor8_as_one(serve_weights):
    """tensor=8 across two processes (every per-layer reduction crosses
    them): both read back the same tokens, the JAX package's one-process
    engine's and the port's one-process tensor=8 engine's."""
    jcfg, jparams, path = serve_weights
    tokens = multihost_check.run_two_process_serve(timeout_s=120,
                                                   weights=path)
    assert len(tokens) == 2 and tokens[0] == tokens[1]
    assert all(len(o.split(",")) == 6 for o in tokens[0].split(";"))
    assert tokens[0] == jax_tokens(jcfg, jparams)
    assert tokens[0] == port_tokens(path, "tensor=8")


def test_two_processes_serve_fsdp2_tensor4(serve_weights):
    """fsdp across the processes (each gathers the other's pieces), tensor
    inside each: the tokens of the one-process tensor=4 engine."""
    _, _, path = serve_weights
    tokens = multihost_check.run_two_process_serve(
        timeout_s=120, mesh="fsdp=2,tensor=4", weights=path)
    assert tokens[0] == tokens[1]
    assert tokens[0] == port_tokens(path, "tensor=4")


EXPERT_WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["GRAFT_REPO"])
import torch
from llm_instance_gateway_tpu_torch.models import transformer
from llm_instance_gateway_tpu_torch.models.configs import TINY_MOE_TEST
from llm_instance_gateway_tpu_torch.parallel.mesh import (
    initialize_distributed, make_mesh, parse_axes, world,
)
from llm_instance_gateway_tpu_torch.server.engine import (
    Engine, EngineConfig, Request, SamplingParams,
)

initialize_distributed()
mesh = make_mesh(parse_axes(os.environ["GRAFT_MESH"]), ["cpu"] * 2)
engine = Engine(TINY_MOE_TEST, transformer.init_params(
    TINY_MOE_TEST, seed=3, dtype=torch.float32, device="cpu"),
    EngineConfig(decode_slots=2, max_seq_len=64, prefill_buckets=(16,)),
    eos_id=None, dtype=torch.float32, device="cpu", mesh=mesh,
    cuda_graphs=False)
reqs = [Request(prompt_tokens=list(p), max_new_tokens=6,
                sampling=SamplingParams(temperature=0.0))
        for p in ([5, 6, 7], [9, 10, 11, 12])]
for r in reqs:
    engine.submit(r)
engine.start()
try:
    for r in reqs:
        assert r.done.wait(120) and r.error is None, r.error
finally:
    engine.stop()
print("EXPERT OK " + ";".join(",".join(map(str, r.output_tokens))
                              for r in reqs), flush=True)
"""


@pytest.mark.parametrize("axes", ["expert=4", "tensor=2,expert=2"])
def test_two_processes_serve_moe_with_experts_across(axes):
    """Mixtral-tiny with ``expert`` across the processes (expert=4: two
    experts' shards a process, each attending on its own; tensor=2,
    expert=2: tensor across, experts inside): the tokens of the
    one-process engine over the same mesh."""
    from llm_instance_gateway_tpu_torch.models import transformer
    from llm_instance_gateway_tpu_torch.models.configs import TINY_MOE_TEST

    outs = multihost_check.run_two_process(
        EXPERT_WORKER, n_local=2, timeout_s=120, env={"GRAFT_MESH": axes})
    got = [line.split(" ", 2)[2]
           for line in multihost_check.ok_lines(outs, "EXPERT OK")]
    assert got[0] == got[1]
    mesh_cfg = tmesh.parse_axes(axes)
    engine = teng.Engine(
        TINY_MOE_TEST, transformer.init_params(
            TINY_MOE_TEST, seed=3, dtype=torch.float32, device="cpu"),
        teng.EngineConfig(decode_slots=2, max_seq_len=64,
                          prefill_buckets=(16,)),
        eos_id=None, dtype=torch.float32, device="cpu",
        mesh=tmesh.make_mesh(mesh_cfg, ["cpu"] * mesh_cfg.total),
        cuda_graphs=False)
    reqs = [teng.Request(prompt_tokens=list(p), max_new_tokens=6,
                         sampling=teng.SamplingParams(temperature=0.0))
            for p in ([5, 6, 7], [9, 10, 11, 12])]
    for r in reqs:
        engine.submit(r)
    engine.start()
    try:
        for r in reqs:
            assert r.done.wait(120) and r.error is None, r.error
    finally:
        engine.stop()
    assert got[0] == ";".join(",".join(map(str, r.output_tokens))
                              for r in reqs)


HUNG_WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["GRAFT_REPO"])
import torch
from llm_instance_gateway_tpu_torch.models import transformer
from llm_instance_gateway_tpu_torch.models.configs import TINY_TEST
from llm_instance_gateway_tpu_torch.parallel.mesh import (
    MeshConfig, initialize_distributed, make_mesh, world,
)
from llm_instance_gateway_tpu_torch.server.engine import (
    Engine, EngineConfig, Request,
)

initialize_distributed()
rank, _ = world()
mesh = make_mesh(MeshConfig(tensor=2), ["cpu"])
engine = Engine(TINY_TEST, transformer.init_params(
    TINY_TEST, dtype=torch.float32, device="cpu"),
    EngineConfig(decode_slots=2, max_seq_len=64, prefill_buckets=(16,)),
    eos_id=None, dtype=torch.float32, device="cpu", mesh=mesh,
    cuda_graphs=False)
if rank == 0:  # the peer never submits: its collectives never come
    engine.submit(Request(prompt_tokens=[5, 6, 7], max_new_tokens=4))
engine.start()
import time
time.sleep(600)
"""


def test_hung_peer_fails_within_its_deadline():
    start = time.monotonic()
    with pytest.raises(RuntimeError, match="timed out|failed"):
        multihost_check.run_two_process(HUNG_WORKER, n_local=1,
                                        timeout_s=10)
    assert time.monotonic() - start < 25


REFUSE_WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["GRAFT_REPO"])
import torch
from llm_instance_gateway_tpu_torch.models import transformer
from llm_instance_gateway_tpu_torch.models.configs import (
    TINY_MOE_TEST, TINY_TEST,
)
from llm_instance_gateway_tpu_torch.parallel import sharding
from llm_instance_gateway_tpu_torch.parallel.mesh import (
    initialize_distributed, make_mesh, parse_axes, world,
)
from llm_instance_gateway_tpu_torch.server.engine import Engine, EngineConfig
from llm_instance_gateway_tpu_torch.training import train

initialize_distributed()
initialize_distributed()  # idempotent
assert world()[1] == 2

def params(cfg):
    return transformer.init_params(cfg, dtype=torch.float32, device="cpu")

def refused(case, fn):
    try:
        fn()
    except ValueError as e:
        print(f"REFUSED {case} -- {e}", flush=True)
    else:
        print(f"SERVED {case}", flush=True)

def serve(axes, **engine):
    mesh = make_mesh(parse_axes(axes), ["cpu"] * 2)
    refused(f"serve {axes} {engine}", lambda: Engine(
        TINY_TEST, params(TINY_TEST),
        EngineConfig(decode_slots=4, max_seq_len=64, prefill_buckets=(16,),
                     **engine),
        eos_id=None, dtype=torch.float32, device="cpu", mesh=mesh,
        cuda_graphs=False))

def trains(cfg, axes):
    mesh = make_mesh(parse_axes(axes), ["cpu"] * 2)
    def step():
        tree = sharding.shard_params(params(cfg),
                                     sharding.TensorParallel(cfg, mesh))
        opt = train.make_optimizer(tree)
        tok = torch.ones((2, 8), dtype=torch.int32)
        pos = torch.arange(8, dtype=torch.int32).repeat(2, 1)
        train.make_full_train_step(cfg, opt)(tree, opt.state, tok, pos)
    refused(f"train {axes}", step)

serve("data=2,tensor=2")
serve("tensor=2,sequence=2")
serve("tensor=4", pipeline_decode=True)
serve("tensor=4", adaptive_steps=4)
trains(TINY_MOE_TEST, "expert=4")
trains(TINY_TEST, "tensor=2,sequence=2")
trains(TINY_TEST, "pipe=2,tensor=2")
print("REFUSALS DONE", flush=True)
"""


def test_axes_that_cannot_span_processes_are_refused_by_name():
    out = multihost_check.run_two_process(REFUSE_WORKER, n_local=2,
                                          timeout_s=120)[0]
    assert "REFUSALS DONE" in out, out[-3000:]
    lines = {line.split(" -- ")[0]: line for line in out.splitlines()
             if line.startswith(("REFUSED", "SERVED"))}
    want = {
        "REFUSED serve data=2,tensor=2 {}": "data=2",
        "REFUSED serve tensor=4 {'pipeline_decode': True}": "pipeline_decode",
        "REFUSED serve tensor=4 {'adaptive_steps': 4}": "adaptive_steps",
        "REFUSED train pipe=2,tensor=2": "pipe=2",
    }
    for key, name in want.items():
        assert key in lines, (key, sorted(lines))
        assert name in lines[key] and "process" in lines[key], lines[key]
    # Served across processes since the ring and the expert gradients
    # span them.
    for key in ("SERVED serve tensor=2,sequence=2 {}",
                "SERVED train expert=4", "SERVED train tensor=2,sequence=2"):
        assert key in lines, (key, sorted(lines))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


TRAIN_WORKER = r"""
import dataclasses, json, os, sys
sys.path.insert(0, os.environ["GRAFT_REPO"])
import numpy as np
import torch
from llm_instance_gateway_tpu_torch.models.configs import LLAMA3_8B
from llm_instance_gateway_tpu_torch.parallel import (
    collectives, multihost_check, sharding,
)
from llm_instance_gateway_tpu_torch.parallel.mesh import (
    initialize_distributed, make_mesh, parse_axes, world,
)
from llm_instance_gateway_tpu_torch.training import train

initialize_distributed()
rank, _ = world()
cfg = dataclasses.replace(LLAMA3_8B, **json.loads(os.environ["GRAFT_CFG"]))
batch = np.load(os.environ["GRAFT_BATCH"])
tokens, positions, slots = (torch.from_numpy(batch[k])
                            for k in ("tokens", "positions", "slots"))
n_local = int(os.environ["GRAFT_N_LOCAL"])
lr = float(os.environ["GRAFT_LR"])


class Planted(torch.autograd.Function):
    # The fault the check must catch: a row-parallel sum whose backward
    # all-reduces the (already replicated) gradient again.
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return collectives._all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return collectives._all_reduce(grad, ctx.group), None


for run in os.environ["GRAFT_RUNS"].split(";"):
    name, axes, kind = run.split("|")
    if kind == "planted":
        collectives._Reduce = Planted
    mesh = make_mesh(parse_axes(axes), ["cpu"] * n_local)
    tp = sharding.TensorParallel(cfg, mesh)
    whole = multihost_check.load_tree(os.environ["GRAFT_WEIGHTS"])
    params = sharding.shard_params(whole, tp)
    if kind == "lora":
        bufs_whole = multihost_check.load_tree(os.environ["GRAFT_LORA"])
        bufs = sharding.shard_lora(bufs_whole, tp)
        opt = train.make_optimizer(bufs, lr=lr)
        _, _, loss = train.make_lora_train_step(cfg, opt)(
            params, bufs, opt.state, tokens, positions, slots)
        got = sharding.unshard(bufs, bufs_whole)
    else:
        opt = train.make_optimizer(params, lr=lr)
        _, _, loss = train.make_full_train_step(cfg, opt)(
            params, opt.state, tokens, positions)
        got = sharding.unshard(params, whole)
    if rank == 0:
        multihost_check.save_tree(
            os.path.join(os.environ["GRAFT_OUT"], name + ".npz"), got)
    print(f"MULTIHOST TRAIN {name} pid={rank} loss={loss.item()!r}",
          flush=True)
"""


def train_batch():
    """tests/test_multihost.py's batch ([4, 32] from RandomState(0)), its
    rows right-padded so the two data halves hold 31 + 27 and 19 + 11
    real targets; slots for the LoRA step."""
    rng = np.random.RandomState(0)
    tokens = rng.randint(1, TRAIN_CFG["vocab_size"], size=(4, 32))
    positions = np.zeros((4, 32), np.int32)
    for row, n in enumerate((32, 28, 20, 12)):
        positions[row, :n] = np.arange(n)
        tokens[row, n:] = 0
    return (tokens.astype(np.int32), positions,
            np.array([1, -1, 2, 1], np.int32))


def jax_lora(cfg):
    """Slot 1 at rank 3, slot 2 at rank 2 (seeded a and b)."""
    rng = np.random.default_rng(5)
    bufs = jlora.init_lora_buffers(cfg, jnp.float32)
    for slot, rank in ((1, 3), (2, 2)):
        adapter = {tg: {"a": rng.standard_normal((cfg.n_layers, di, rank)
                                                 ).astype(np.float32) * 0.3,
                        "b": rng.standard_normal((cfg.n_layers, rank, do)
                                                 ).astype(np.float32) * 0.3}
                   for tg, (di, do) in jlora.target_dims(cfg).items()}
        bufs = jlora.load_adapter(bufs, cfg, slot, adapter, alpha=6.0,
                                  rank=rank)
    return bufs


@pytest.fixture(scope="module")
def train_inputs(tmp_path_factory):
    """The reference's weights, adapter slots and batch as files, and its
    jitted steps' results on the whole batch: (paths, {kind: (loss, before,
    after, grads)})."""
    d = tmp_path_factory.mktemp("train")
    jcfg = jax_cfg(TRAIN_CFG)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    jbufs = jax_lora(jcfg)
    tokens, positions, slots = train_batch()
    paths = {"weights": str(d / "weights.npz"), "lora": str(d / "lora.npz"),
             "batch": str(d / "batch.npz"), "out": str(d)}
    multihost_check.save_tree(paths["weights"], to_np(jparams))
    multihost_check.save_tree(paths["lora"], to_np(jbufs))
    np.savez(paths["batch"], tokens=tokens, positions=positions, slots=slots)
    opt = optax.adamw(LR)
    full = jax.jit(jtrain.make_full_train_step(jcfg, opt))
    new, _, loss = full(jparams, opt.init(jparams), tokens, positions)
    grads = jax.grad(lambda p: jtrain.causal_lm_loss(
        jcfg, p, tokens, positions))(jparams)
    want = {"full": (float(loss), flat(to_np(jparams)), flat(to_np(new)),
                     flat(to_np(grads)))}
    lora_step = jax.jit(jtrain.make_lora_train_step(jcfg, opt))
    new_bufs, _, loss = lora_step(jparams, jbufs, opt.init(jbufs), tokens,
                                  positions, slots)
    grads = jax.grad(lambda b: jtrain.causal_lm_loss(
        jcfg, jparams, tokens, positions, lora_bufs=b,
        slot_ids=slots))(jbufs)
    grads = {**grads, "scale": jnp.zeros_like(jbufs["scale"])}
    want["lora"] = (float(loss), flat(to_np(jbufs)), flat(to_np(new_bufs)),
                    flat(to_np(grads)))
    return paths, want


def run_train_pair(paths: dict, runs: str, n_local: int) -> dict:
    """The train worker's runs (``name|axes|kind`` joined by ``;``): name ->
    (each process's loss, the reassembled tree after the step)."""
    outs = multihost_check.run_two_process(
        TRAIN_WORKER, n_local=n_local, timeout_s=120,
        env={"GRAFT_CFG": json.dumps(TRAIN_CFG), "GRAFT_LR": str(LR),
             "GRAFT_WEIGHTS": paths["weights"], "GRAFT_LORA": paths["lora"],
             "GRAFT_BATCH": paths["batch"], "GRAFT_OUT": paths["out"],
             "GRAFT_RUNS": runs})
    got = {}
    for run in runs.split(";"):
        name = run.split("|")[0]
        lines = multihost_check.ok_lines(outs, f"MULTIHOST TRAIN {name} ")
        losses = [float(line.rsplit("loss=", 1)[1]) for line in lines]
        tree = flat(multihost_check.load_tree(
            os.path.join(paths["out"], name + ".npz")))
        got[name] = (losses, {p: t.numpy() for p, t in tree.items()})
    return got


def update_errors(want, got_after: dict) -> dict:
    """path -> the largest |update / lr| error where the reference's
    gradient clears the noise floor."""
    _, before, after, grads = want
    errs = {}
    for path, w in after.items():
        g = np.abs(grads[path])
        sure = g > NOISE_FLOOR * max(g.max(), 1e-30)
        du_got = (got_after[path].astype(np.float64) - before[path]) / LR
        du_want = (w.astype(np.float64) - before[path]) / LR
        err = np.abs(du_got - du_want)[sure]
        errs[path] = float(err.max()) if err.size else 0.0
    return errs


def check_step(want, losses, tree, what):
    assert losses[0] == losses[1], (what, losses)
    assert abs(losses[0] - want[0]) <= LOSS_RTOL * abs(want[0]), (
        what, losses[0], want[0])
    assert set(tree) == set(want[2]), what
    errs = update_errors(want, tree)
    bad = {p: e for p, e in errs.items() if e >= UPDATE_TOL}
    assert not bad, (what, bad)


TRAIN_RUNS = {"data": ("data=2,tensor=4", "full"),
              "fsdp": ("fsdp=2,tensor=4", "full"),
              "lora": ("data=2,tensor=4", "lora")}


@pytest.fixture(scope="module")
def trained(train_inputs):
    paths, _ = train_inputs
    return run_train_pair(paths, ";".join(
        f"{name}|{axes}|{kind}" for name, (axes, kind) in TRAIN_RUNS.items()),
        n_local=4)


@pytest.mark.parametrize("name", sorted(TRAIN_RUNS))
def test_two_process_train_step_matches_reference(train_inputs, trained,
                                                  name):
    """One step with ``data`` or ``fsdp`` across the processes (tensor=4
    inside each): the loss both processes report is the reference's
    global masked mean, and the reassembled update its optax update."""
    _, want = train_inputs
    losses, tree = trained[name]
    check_step(want[TRAIN_RUNS[name][1]], losses, tree, name)


def test_tensor_across_processes_trains_and_a_doubled_backward_fails(
        train_inputs):
    """tensor=4 over two processes of two positions: the step matches the
    reference; with the row-parallel sum's backward all-reducing too (the
    gradient scaled by the group's size) the update check fails."""
    paths, want = train_inputs
    got = run_train_pair(paths, "tp|tensor=4|full;planted|tensor=4|planted",
                         n_local=2)
    check_step(want["full"], *got["tp"], "tensor across processes")
    losses, tree = got["planted"]
    assert losses[0] == losses[1]
    errs = update_errors(want["full"], tree)
    assert max(errs.values()) >= UPDATE_TOL, errs


@pytest.mark.parametrize("axes", ["data=2,tensor=4", "fsdp=2",
                                  "fsdp=2,tensor=4"])
def test_one_process_sharded_step_on_views(train_inputs, axes):
    """The sharded step in one process (every shard a view of the
    caller's tree on the CPU): the reference's loss and update, the
    caller's tree updated in place."""
    paths, want = train_inputs
    cfg = port_cfg(TRAIN_CFG)
    whole = multihost_check.load_tree(paths["weights"])
    mesh_cfg = tmesh.parse_axes(axes)
    mesh = tmesh.make_mesh(mesh_cfg, ["cpu"] * mesh_cfg.total)
    tree = sharding.shard_params(whole, sharding.TensorParallel(cfg, mesh))
    opt = ttrain.make_optimizer(tree, lr=LR)
    tokens, positions, _ = train_batch()
    _, _, loss = ttrain.make_full_train_step(cfg, opt)(
        tree, opt.state, torch.from_numpy(tokens),
        torch.from_numpy(positions))
    got = {p: t.detach().numpy() for p, t in flat(whole).items()}
    check_step(want["full"], [loss.item()] * 2, got, axes)


# ---------------------------------------------------------------------------
# the torch pod's manifest
# ---------------------------------------------------------------------------


def _deployment(path):
    with open(os.path.join(REPO, path)) as f:
        docs = [d for d in yaml.safe_load_all(f) if d]
    dep = next(d for d in docs if d["kind"] == "Deployment")
    return {c["name"]: c for c in dep["spec"]["template"]["spec"]
            ["containers"]}


def test_gpu_manifest_serves_the_jax_manifests_args():
    gpu = _deployment("deploy/model-server/gpu-server.yaml")
    tpu = _deployment("deploy/model-server/tpu-server.yaml")
    server = gpu["model-server"]
    assert server["command"] == [
        "python", "-m", "llm_instance_gateway_tpu_torch.server.api_http"]
    assert server["args"] == tpu["model-server"]["args"]
    args = tapi.build_parser().parse_args(server["args"])
    for flag in server["args"]:
        name = flag.split("=", 1)[0].lstrip("-").replace("-", "_")
        assert hasattr(args, name), flag
    assert args.port == 8000
    assert server["ports"] == tpu["model-server"]["ports"]
    assert server["resources"]["limits"]["nvidia.com/gpu"] == "1"
    assert (gpu["lora-adapter-sidecar"]["command"]
            == tpu["lora-adapter-sidecar"]["command"])
