"""The sharded train step with ``sequence`` and ``expert`` across
processes (``training/train.py``: ``_ring_sum``, ``_sharded_loss``,
``_set_grads``; ``parallel/collectives.exchange``), held to the JAX
package's jitted step on the whole batch, on the CPU at f32: OS processes
joined over gloo (``parallel/multihost_check``), every position on
``"cpu"``, the reference's ``init_params(PRNGKey(0))`` weights carried
across through ``.npz`` files.

Runs: ``sequence=2`` (one position a process: each runs the forward of
its half of the row, the ring reading the other half's K/V through the
exchange), full and LoRA; ``data=2,sequence=2`` over four processes (both
axes across) and over two (``data`` across, the sequence inside a
process); ``expert=2`` on Mixtral-tiny (four experts a process), full and
LoRA.  Planted: the exchange's backward divided by the group's size (the
fsdp gather's rule, wrong for ``sequence``) and, with ``expert`` across,
a row-parallel sum whose backward all-reduces too; each must fail the
gradient check.

Tolerances, each for its reason:

- ``LOSS_RTOL`` (1e-5, relative): the loss, f32 summation order only;
- ``GRAD_TOL`` (1e-4 of a leaf's largest |grad|): every gradient leaf,
  ``tests/test_torch_train.py``'s rule (the sums over processes change
  the summation order only);
- ``UPDATE_TOL`` (1e-3) over ``NOISE_FLOOR`` (1e-3 of a leaf's largest
  |grad|): the AdamW update over lr, ``tests/test_torch_multihost.py``'s
  rule (Adam turns a gradient at rounding noise into a +-lr step).
  Adam's first step hides a gradient scaled uniformly, which is why the
  planted faults are held to the gradients.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from llm_instance_gateway_tpu.models import lora as jlora
from llm_instance_gateway_tpu.models import transformer as jtf
from llm_instance_gateway_tpu.models.configs import LLAMA3_8B as JLLAMA3_8B
from llm_instance_gateway_tpu.models.configs import TINY_MOE_TEST as JTINY_MOE
from llm_instance_gateway_tpu.training import train as jtrain

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch.parallel import multihost_check  # noqa: E402

pytestmark = pytest.mark.e2e

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
UPDATE_TOL = 1e-3
NOISE_FLOOR = 1e-3
LR = 1e-3

# tests/test_torch_multihost.py's train config.
TRAIN_CFG = dict(name="multihost-dryrun", vocab_size=512, d_model=64,
                 n_layers=2, n_heads=4, n_kv_heads=4, d_ff=128, head_dim=16,
                 max_seq_len=64)
MODELS = {"llama": dataclasses.replace(JLLAMA3_8B, **TRAIN_CFG),
          "moe": JTINY_MOE}

WORKER = r"""
import dataclasses, json, os, sys
sys.path.insert(0, os.environ["GRAFT_REPO"])
import numpy as np
import torch
from llm_instance_gateway_tpu_torch.models.configs import (
    LLAMA3_8B, TINY_MOE_TEST)
from llm_instance_gateway_tpu_torch.parallel import (
    collectives, multihost_check, sharding)
from llm_instance_gateway_tpu_torch.parallel.mesh import (
    initialize_distributed, make_mesh, parse_axes, world)
from llm_instance_gateway_tpu_torch.training import train

initialize_distributed()
rank, _ = world()
models = {"llama": dataclasses.replace(
    LLAMA3_8B, **json.loads(os.environ["GRAFT_CFG"])), "moe": TINY_MOE_TEST}
n_local = int(os.environ["GRAFT_N_LOCAL"])
lr = float(os.environ["GRAFT_LR"])
out_dir = os.environ["GRAFT_OUT"]


Exchange = collectives._Exchange


class Divided(Exchange):
    # The fault for sequence: the fsdp gather's backward, divided by the
    # group's size.
    @staticmethod
    def backward(ctx, grad):
        g = Exchange.backward(ctx, grad)[0]
        return g / ctx.group.size, None, None


class Doubled(torch.autograd.Function):
    # The fault for expert: a row-parallel sum whose backward all-reduces
    # the (already replicated) gradient again.
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return collectives._all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return collectives._all_reduce(grad, ctx.group), None


plain = {"_Exchange": Exchange, "_Reduce": collectives._Reduce}
faults = {"divided": ("_Exchange", Divided), "doubled": ("_Reduce", Doubled)}


def grads_of(tree):
    # The leaves' gradients as a tree of the same layout.
    return sharding.Shards(
        [sharding.map_tree(t, lambda x: x.grad if x.grad is not None
                           else torch.zeros_like(x)) for t in tree], tree.tp)


for run in os.environ["GRAFT_RUNS"].split(";"):
    name, model, axes, kind, fault = run.split("|")
    for attr, cls in plain.items():
        setattr(collectives, attr, cls)
    if fault:
        setattr(collectives, *faults[fault])
    cfg = models[model]
    batch = np.load(os.path.join(out_dir, f"batch_{model}.npz"))
    tokens, positions, slots = (torch.from_numpy(batch[k])
                                for k in ("tokens", "positions", "slots"))
    mesh = make_mesh(parse_axes(axes), ["cpu"] * n_local)
    tp = sharding.TensorParallel(cfg, mesh)
    whole = multihost_check.load_tree(
        os.path.join(out_dir, f"weights_{model}.npz"))
    params = sharding.shard_params(whole, tp)
    if kind == "lora":
        like = multihost_check.load_tree(
            os.path.join(out_dir, f"lora_{model}.npz"))
        tree = sharding.shard_lora(like, tp)
        opt = train.make_optimizer(tree, lr=lr)
        step = train.make_lora_train_step(cfg, opt)
        args = (params, tree, opt.state, tokens, positions, slots)
    else:
        like, tree = whole, params
        opt = train.make_optimizer(tree, lr=lr)
        step = train.make_full_train_step(cfg, opt)
        args = (params, opt.state, tokens, positions)
    grads = {}
    adam = opt.step

    def step_and_keep(*a, **kw):
        grads["tree"] = sharding.unshard(grads_of(tree), like)
        return adam(*a, **kw)
    opt.step = step_and_keep
    loss = step(*args)[2]
    got = sharding.unshard(tree, like)
    if rank == 0:
        multihost_check.save_tree(os.path.join(out_dir, name + ".npz"), got)
        multihost_check.save_tree(os.path.join(out_dir, name + "_grads.npz"),
                                  grads["tree"])
    print(f"TRAIN PROCESSES {name} pid={rank} loss={loss.item()!r}",
          flush=True)
"""


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def flat(tree, prefix=""):
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(v)
    return out


def batch(vocab):
    """tests/test_torch_multihost.py's batch ([4, 32], rows right-padded to
    32, 28, 20 and 12 real tokens); slots for the LoRA step."""
    rng = np.random.RandomState(0)
    tokens = rng.randint(1, vocab, size=(4, 32))
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
def reference(tmp_path_factory):
    """The reference's weights, slots and batches as files, and its jitted
    steps on the whole batch: (dir, {(model, kind): (loss, before, after,
    grads)})."""
    d = tmp_path_factory.mktemp("train_processes")
    want = {}
    opt = optax.adamw(LR)
    for model, jcfg in MODELS.items():
        jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0),
                                  dtype=jnp.float32)
        jbufs = jax_lora(jcfg)
        tokens, positions, slots = batch(jcfg.vocab_size)
        multihost_check.save_tree(str(d / f"weights_{model}.npz"),
                                  to_np(jparams))
        multihost_check.save_tree(str(d / f"lora_{model}.npz"), to_np(jbufs))
        np.savez(str(d / f"batch_{model}.npz"), tokens=tokens,
                 positions=positions, slots=slots)
        new, _, loss = jax.jit(jtrain.make_full_train_step(jcfg, opt))(
            jparams, opt.init(jparams), tokens, positions)
        grads = jax.grad(lambda p: jtrain.causal_lm_loss(
            jcfg, p, tokens, positions))(jparams)
        want[model, "full"] = (float(loss), flat(to_np(jparams)),
                               flat(to_np(new)), flat(to_np(grads)))
        new, _, loss = jax.jit(jtrain.make_lora_train_step(jcfg, opt))(
            jparams, jbufs, opt.init(jbufs), tokens, positions, slots)
        grads = jax.grad(lambda b: jtrain.causal_lm_loss(
            jcfg, jparams, tokens, positions, lora_bufs=b,
            slot_ids=slots))(jbufs)
        grads = {**grads, "scale": jnp.zeros_like(jbufs["scale"])}
        want[model, "lora"] = (float(loss), flat(to_np(jbufs)),
                               flat(to_np(new)), flat(to_np(grads)))
    return d, want


def run_pair(d, runs: list, n_processes: int, n_local: int) -> dict:
    """The worker's runs (name, model, axes, kind, fault): name -> (each
    process's loss, the whole tree after the step, its gradients)."""
    outs = multihost_check.run_processes(
        WORKER, n_processes, n_local=n_local, timeout_s=150,
        env={"GRAFT_CFG": json.dumps(TRAIN_CFG), "GRAFT_LR": str(LR),
             "GRAFT_OUT": str(d),
             "GRAFT_RUNS": ";".join("|".join(r) for r in runs)})
    got = {}
    for name, *_ in runs:
        lines = multihost_check.ok_lines(outs, f"TRAIN PROCESSES {name} ")
        losses = [float(line.rsplit("loss=", 1)[1]) for line in lines]
        trees = [flat(multihost_check.load_tree(str(d / f"{name}{part}.npz")))
                 for part in ("", "_grads")]
        got[name] = (losses, *trees)
    return got


def grad_errors(want, grads: dict) -> dict:
    """path -> the largest |error| over the reference's largest |grad|."""
    return {p: float(np.abs(grads[p] - w).max() / max(np.abs(w).max(), 1e-6))
            for p, w in want[3].items()
            if np.issubdtype(w.dtype, np.floating)}


def update_errors(want, after: dict) -> dict:
    """path -> the largest |update / lr| error where the reference's
    gradient clears the noise floor."""
    _, before, want_after, grads = want
    errs = {}
    for path, w in want_after.items():
        g = np.abs(grads[path])
        sure = g > NOISE_FLOOR * max(g.max(), 1e-30)
        du_got = (after[path].astype(np.float64) - before[path]) / LR
        du_want = (w.astype(np.float64) - before[path]) / LR
        err = np.abs(du_got - du_want)[sure]
        errs[path] = float(err.max()) if err.size else 0.0
    return errs


# name -> (model, axes, kind, fault, processes, positions a process)
RUNS = {
    "sequence": ("llama", "sequence=2", "full", "", 2, 1),
    "sequence_lora": ("llama", "sequence=2", "lora", "", 2, 1),
    "sequence_divided": ("llama", "sequence=2", "full", "divided", 2, 1),
    "expert": ("moe", "expert=2", "full", "", 2, 1),
    "expert_lora": ("moe", "expert=2", "lora", "", 2, 1),
    "expert_doubled": ("moe", "expert=2", "full", "doubled", 2, 1),
    "data_sequence4": ("llama", "data=2,sequence=2", "full", "", 4, 1),
    "data_sequence2": ("llama", "data=2,sequence=2", "full", "", 2, 2),
}


@pytest.fixture(scope="module")
def trained(reference):
    d, _ = reference
    groups: dict = {}
    for name, (*run, procs, n_local) in RUNS.items():
        groups.setdefault((procs, n_local), []).append((name, *run))
    got = {}
    for (procs, n_local), runs in groups.items():
        got.update(run_pair(d, runs, procs, n_local))
    return got


@pytest.mark.parametrize("name", [n for n, r in RUNS.items() if not r[3]])
def test_step_across_processes_matches_reference(reference, trained, name):
    """One step: every process reports the reference's global masked mean,
    and the reassembled gradients and update are the reference's."""
    model, axes, kind, *_ = RUNS[name]
    want = reference[1][model, kind]
    losses, after, grads = trained[name]
    assert len(set(losses)) == 1, (name, losses)
    assert abs(losses[0] - want[0]) <= LOSS_RTOL * abs(want[0]), (
        name, losses[0], want[0])
    bad = {p: e for p, e in grad_errors(want, grads).items() if e > GRAD_TOL}
    assert not bad, (name, bad)
    bad = {p: e for p, e in update_errors(want, after).items()
           if e >= UPDATE_TOL}
    assert not bad, (name, bad)


@pytest.mark.parametrize("name", [n for n, r in RUNS.items() if r[3]])
def test_planted_backward_fails_the_gradient_check(reference, trained, name):
    """The exchange's backward divided by the group's size (sequence), a
    row-parallel sum's backward all-reduced (expert): the forward and the
    loss stay the reference's, the gradients do not."""
    model, axes, kind, *_ = RUNS[name]
    want = reference[1][model, kind]
    losses, _, grads = trained[name]
    assert abs(losses[0] - want[0]) <= LOSS_RTOL * abs(want[0])
    assert max(grad_errors(want, grads).values()) > 100 * GRAD_TOL, name
