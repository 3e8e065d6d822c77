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
LoRA; a head layout the reference's kernels do not split, 14:2 at
``tensor=4`` (Qwen-tiny's widths, seeded non-zero q/k/v biases; the head
plan's 4:1 a shard, each KV head on two shards, each group of 7 padded
with a zero head), full and LoRA, over four processes (one shard each,
each KV head's replicas in two processes) and over two (a KV head's
replicas inside one process), and beside ``sequence=2`` (full: a
process a tensor shard and both its sequence blocks, so each KV head's
replicas in two processes), ``data=2`` (LoRA) and ``fsdp=2`` (full), over
four processes of two positions; its zero heads' gradients and values
exactly 0, its replicas bitwise equal (``unshard`` checks them); 6:3 at
``tensor=2`` (4:2 a shard, the second shard's last KV head a zero head)
beside ``sequence=2`` (full), ``data=2`` (LoRA) and, on Mixtral-tiny's
widths, ``expert=2`` (full), over four processes.  Planted: the
exchange's backward divided by the group's size (the fsdp gather's rule,
wrong for ``sequence``), with ``expert`` across a row-parallel sum whose
backward all-reduces too, and at 14:2 each KV replica left with its own
process's gradient (``unsummed``, which ``unshard`` finds apart); each
must fail the gradient check.

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
from llm_instance_gateway_tpu.models.configs import TINY_QWEN_TEST as JQWEN
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
          "moe": JTINY_MOE,
          "qwen14": dataclasses.replace(JQWEN, n_heads=14, n_kv_heads=2),
          "llama63": dataclasses.replace(JLLAMA3_8B, **dict(
              TRAIN_CFG, n_heads=6, n_kv_heads=3)),
          "moe63": dataclasses.replace(JTINY_MOE, n_heads=6, n_kv_heads=3)}

WORKER = r"""
import dataclasses, json, os, sys
sys.path.insert(0, os.environ["GRAFT_REPO"])
import numpy as np
import torch
from llm_instance_gateway_tpu_torch.models.configs import (
    LLAMA3_8B, TINY_MOE_TEST, TINY_QWEN_TEST)
from llm_instance_gateway_tpu_torch.parallel import (
    collectives, multihost_check, sharding)
from llm_instance_gateway_tpu_torch.parallel.mesh import (
    initialize_distributed, make_mesh, parse_axes, world)
from llm_instance_gateway_tpu_torch.training import train

initialize_distributed()
rank, _ = world()
models = {"llama": dataclasses.replace(
    LLAMA3_8B, **json.loads(os.environ["GRAFT_CFG"])), "moe": TINY_MOE_TEST,
          "qwen14": dataclasses.replace(TINY_QWEN_TEST, n_heads=14,
                                        n_kv_heads=2)}
models["llama63"] = dataclasses.replace(models["llama"], n_heads=6,
                                        n_kv_heads=3)
models["moe63"] = dataclasses.replace(TINY_MOE_TEST, n_heads=6, n_kv_heads=3)
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


plain = {(collectives, "_Exchange"): Exchange,
         (collectives, "_Reduce"): collectives._Reduce,
         (train, "_sum_kv_replicas"): train._sum_kv_replicas}
# The fault for a replicated KV head: each replica keeps its own
# process's gradient.
faults = {"divided": (collectives, "_Exchange", Divided),
          "doubled": (collectives, "_Reduce", Doubled),
          "unsummed": (train, "_sum_kv_replicas", lambda tree: None)}


def grad_of(x):
    # A leaf's gradient (zeros where it took none), an fsdp leaf's piece
    # by piece.
    if isinstance(x, sharding.FsdpLeaf):
        return sharding.FsdpLeaf([grad_of(p) for p in x.pieces], x.axis,
                                 x.one_device, x.group, x.positions, x.total)
    return x.grad if x.grad is not None else torch.zeros_like(x)


def grads_of(tree):
    # The leaves' gradients as a tree of the same layout.
    return sharding.Shards([sharding.map_tree(t, grad_of) for t in tree],
                           tree.tp)


for run in os.environ["GRAFT_RUNS"].split(";"):
    name, model, axes, kind, fault = run.split("|")
    for (module, attr), cls in plain.items():
        setattr(module, attr, cls)
    if fault:
        setattr(*faults[fault])
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

    def zero_heads(value):
        # The largest |value| over every zero head's slice of this
        # process's head leaves.
        return max([value(x).narrow(axis, j * tp.hd, tp.hd).abs().max()
                    .item() for x, axis, js in sharding.zero_heads(tree)
                    for j in js] or [0.0])

    def whole(t):
        # unshard's tree, or the error it raises where a KV head's
        # replicas differ.
        try:
            return sharding.unshard(t, like)
        except ValueError as e:
            return str(e)

    def step_and_keep(*a, **kw):
        grads["tree"] = whole(grads_of(tree))
        grads["zero"] = zero_heads(lambda x: x.grad)
        return adam(*a, **kw)
    opt.step = step_and_keep
    loss = step(*args)[2]
    got = whole(tree)
    zero = [grads["zero"], zero_heads(lambda x: x)]
    differ = [t for t in (grads["tree"], got) if isinstance(t, str)]
    if rank == 0:
        for part, t in (("", got), ("_grads", grads["tree"])):
            if not isinstance(t, str):
                multihost_check.save_tree(
                    os.path.join(out_dir, name + part + ".npz"), t)
    print(f"TRAIN PROCESSES {name} pid={rank} zero={json.dumps(zero)} "
          f"differ={json.dumps(differ)} loss={loss.item()!r}", flush=True)
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
        if jcfg.attention_bias:  # non-zero biases, so a mis-split shows
            rng = np.random.default_rng(5)
            jparams["layers"] = {**jparams["layers"], **{
                name: jnp.asarray(rng.standard_normal(
                    jparams["layers"][name].shape).astype(np.float32) * 0.5)
                for name in ("wq_b", "wk_b", "wv_b")}}
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
    process's loss, the whole tree after the step, its gradients, each
    process's largest |gradient| and |value| at its zero heads, the
    errors ``unshard`` raised where a KV head's replicas differ; a tree
    it refused is None)."""
    outs = multihost_check.run_processes(
        WORKER, n_processes, n_local=n_local, timeout_s=240,
        env={"GRAFT_CFG": json.dumps(TRAIN_CFG), "GRAFT_LR": str(LR),
             "GRAFT_OUT": str(d),
             "GRAFT_RUNS": ";".join("|".join(r) for r in runs)})
    got = {}
    for name, *_ in runs:
        lines = multihost_check.ok_lines(outs, f"TRAIN PROCESSES {name} ")
        losses = [float(line.rsplit("loss=", 1)[1]) for line in lines]
        zero = [json.loads(line.split("zero=", 1)[1].split(" differ=")[0])
                for line in lines]
        differ = [json.loads(line.split(" differ=", 1)[1].split(" loss=")[0])
                  for line in lines]
        paths = [d / f"{name}{part}.npz" for part in ("", "_grads")]
        trees = [flat(multihost_check.load_tree(str(p))) if p.exists()
                 else None for p in paths]
        got[name] = (losses, *trees, zero, differ)
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
    "qwen14_t4_over4": ("qwen14", "tensor=4", "full", "", 4, 1),
    "qwen14_t4_lora_over4": ("qwen14", "tensor=4", "lora", "", 4, 1),
    "qwen14_t4_unsummed": ("qwen14", "tensor=4", "full", "unsummed", 4, 1),
    "qwen14_t4_over2": ("qwen14", "tensor=4", "full", "", 2, 2),
    "qwen14_t4_lora_over2": ("qwen14", "tensor=4", "lora", "", 2, 2),
    "qwen14_t4_sequence2": ("qwen14", "tensor=4,sequence=2", "full", "", 4,
                            2),
    "qwen14_data2_t4_lora": ("qwen14", "data=2,tensor=4", "lora", "", 4, 2),
    "qwen14_fsdp2_t4": ("qwen14", "fsdp=2,tensor=4", "full", "", 4, 2),
    "llama63_t2_sequence2": ("llama63", "tensor=2,sequence=2", "full", "", 4,
                             1),
    "llama63_data2_t2_lora": ("llama63", "data=2,tensor=2", "lora", "", 4,
                              1),
    "moe63_t2_expert2": ("moe63", "tensor=2,expert=2", "full", "", 4, 1),
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
    losses, after, grads, zero, differ = trained[name]
    assert len(set(losses)) == 1, (name, losses)
    # A KV head's replicas agree bitwise on every process.
    assert all(not x for x in differ), (name, differ)
    # A zero head's gradient and value stay exactly 0 on every process.
    assert all(z == [0.0, 0.0] for z in zero), (name, zero)
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
    row-parallel sum's backward all-reduced (expert), each KV replica
    left with its own process's gradient (14:2 at tensor=4): the forward
    and the loss stay the reference's, the gradients do not."""
    model, axes, kind, fault, *_ = RUNS[name]
    want = reference[1][model, kind]
    losses, _, grads, _, differ = trained[name]
    assert abs(losses[0] - want[0]) <= LOSS_RTOL * abs(want[0])
    if fault == "unsummed":
        # Each replica's update is its own: unshard finds them apart.
        assert all(any("replica of KV head" in x for x in d)
                   for d in differ), (name, differ)
        return
    assert max(grad_errors(want, grads).values()) > 100 * GRAD_TOL, name
