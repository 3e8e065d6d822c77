"""The pipelined trainer with its stages in processes of their own
(``parallel/pipeline.py`` across processes: activations and their
gradients sent point to point over the ``("pipe",)`` group), held to the
JAX package's jitted ``make_pipeline_train_step`` at the same mesh on its
virtual 8-device CPU mesh, on the CPU at f32: OS processes joined over
gloo (``parallel/multihost_check.run_processes``), every position on
``"cpu"``, the reference's ``init_params(PRNGKey(0))`` weights carried
across through ``.npz`` files.

Runs, each one step's loss, gradients and update and a second step's
loss: ``pp2tp4`` over two processes (a stage a process, tensor inside),
``dp2pp2tp2`` over four (data and pipe across) and over two (data
across, both stages in a process), ``pp4tp2`` over four, ``pipe=2,
tensor=2`` over four (one position a process: tensor across processes
inside a stage), ``fsdp=2,pipe=2,tensor=2`` over four (fsdp and pipe
across) and ``pipe=2,tensor=2,sequence=2`` over four (tensor across,
the sequence replicated inside), and Gemma-2B's tiny config (tied
embeddings, MQA) at ``pipe=2`` over two; over four, one position a
process: ``pipe=2,sequence=2``, Mixtral's tiny config at
``pipe=2,expert=2`` and a head layout the reference's kernels do not
split, 6:3 at ``pipe=2,tensor=2`` (the head plan's 4:2 a shard, the
second shard's last KV head a zero head with its two zero query
heads).  Each step launches flash and
the flash backward exactly (L/pp) x M times per local tensor shard and
local stage in every process.  ``pipeline_forward``'s logits at
``pp2tp4`` against the reference's sharded forward (rtol/atol 5e-4, the
reference test's).  Planted: the gradients sent back in the wrong
microbatch order, and a tied ``embed``'s gradient left unsummed between
the first and last stages; each must fail the gradient check.  Refused by
name: a process owning part of the pipe axis, and ``pipe`` in serving.
In one process (every shard on the CPU): ``fsdp=2,pipe=2,tensor=2`` and
``pipe=2,tensor=2,sequence=2``, which the reference trains too.

Tolerances (``tests/test_torch_train_processes.py``'s rules):

- ``LOSS_RTOL`` (1e-5, relative): the loss, f32 summation order only;
- ``GRAD_TOL`` (1e-4 of a leaf's largest |grad|): every gradient leaf;
- ``UPDATE_TOL`` (1e-3) over ``NOISE_FLOOR`` (1e-3 of a leaf's largest
  |grad|): the AdamW update over lr (Adam turns a gradient at rounding
  noise into a +-lr step).  Adam's first step hides a gradient scaled
  uniformly, which is why the planted faults are held to the gradients.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from llm_instance_gateway_tpu.models import transformer as jtf
from llm_instance_gateway_tpu.models.configs import GEMMA_2B as JGEMMA
from llm_instance_gateway_tpu.models.configs import TINY_MOE_TEST as JTINY_MOE
from llm_instance_gateway_tpu.models.configs import TINY_TEST as JTINY
from llm_instance_gateway_tpu.parallel import mesh as jmesh
from llm_instance_gateway_tpu.parallel import pipeline as jpipe
from llm_instance_gateway_tpu.parallel import sharding as jsh

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch.models.configs import TINY_TEST  # noqa: E402
from llm_instance_gateway_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from llm_instance_gateway_tpu_torch.parallel import multihost_check  # noqa: E402
from llm_instance_gateway_tpu_torch.parallel import pipeline as tpipe  # noqa: E402
from llm_instance_gateway_tpu_torch.parallel import sharding as tsh  # noqa: E402
from llm_instance_gateway_tpu_torch.training import train as ttrain  # noqa: E402

pytestmark = pytest.mark.e2e

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
UPDATE_TOL = 1e-3
NOISE_FLOOR = 1e-3
FWD_TOL = 5e-4  # tests/test_pipeline.py's sharded forward
LR = 1e-3

# tests/test_pipeline.py's config, Gemma-2B's tiny one at its depth, its
# widths at 6:3 heads, and Mixtral's tiny one.
MODELS = {"llama": dataclasses.replace(JTINY, name="tiny-pipe", n_layers=4),
          "gemma": dataclasses.replace(JGEMMA.tiny(), n_layers=4),
          "layout63": dataclasses.replace(JTINY, name="tiny-pipe",
                                          n_layers=4, n_heads=6,
                                          n_kv_heads=3),
          "moe": JTINY_MOE}

WORKER = r"""
import dataclasses, json, os, sys
sys.path.insert(0, os.environ["GRAFT_REPO"])
import numpy as np
import torch
from llm_instance_gateway_tpu_torch.models import transformer
from llm_instance_gateway_tpu_torch.models.configs import (
    GEMMA_2B, TINY_MOE_TEST, TINY_TEST)
from llm_instance_gateway_tpu_torch.ops import flash_attention as tfa
from llm_instance_gateway_tpu_torch.parallel import multihost_check, pipeline
from llm_instance_gateway_tpu_torch.parallel.mesh import (
    initialize_distributed, make_mesh, parse_axes, world)
from llm_instance_gateway_tpu_torch.server.engine import Engine, EngineConfig
from llm_instance_gateway_tpu_torch.training import train

initialize_distributed()
rank, size = world()
lr = float(os.environ["GRAFT_LR"])
out_dir = os.environ["GRAFT_OUT"]
models = {"llama": dataclasses.replace(TINY_TEST, name="tiny-pipe",
                                       n_layers=4),
          "gemma": dataclasses.replace(GEMMA_2B.tiny(), n_layers=4),
          "layout63": dataclasses.replace(TINY_TEST, name="tiny-pipe",
                                          n_layers=4, n_heads=6,
                                          n_kv_heads=3),
          "moe": TINY_MOE_TEST}

calls = {"forward": 0, "backward": 0}
fwd, bwd = tfa._forward, tfa.flash_attention_backward


def counted_forward(*a):
    calls["forward"] += 1
    return fwd(*a)


def counted_backward(*a, **k):
    calls["backward"] += 1
    return bwd(*a, **k)


tfa._forward, tfa.flash_attention_backward = counted_forward, counted_backward
Link, tie = pipeline._Link, pipeline._tie_grads


class Reversed(Link):
    # The fault: the gradients sent back in forward microbatch order (the
    # backward runs j = M-1 .. 0 and sends each as it is made).
    def send_grad(self, j, g):
        self.held = getattr(self, "held", []) + [g]
        if j == 0:
            for k, x in enumerate(reversed(self.held)):
                Link.send_grad(self, k, x)


faults = {"reversed": ("_Link", Reversed),
          "untied": ("_tie_grads", lambda run: None)}


def mesh_for(axes):
    cfg = parse_axes(axes)
    return make_mesh(cfg, ["cpu"] * (cfg.total // size))


for run in os.environ["GRAFT_RUNS"].split(";"):
    name, model, axes, m, kind, fault = run.split("|")
    m = int(m)
    pipeline._Link, pipeline._tie_grads = Link, tie
    if fault:
        setattr(pipeline, *faults[fault])
    cfg = models[model]
    batch = np.load(os.path.join(out_dir, "batch.npz"))
    tokens, positions = (torch.from_numpy(batch[k])
                         for k in ("tokens", "positions"))
    mesh = mesh_for(axes)
    pipe = mesh.shape["pipe"]
    like = pipeline.stage_params(cfg, multihost_check.load_tree(
        os.path.join(out_dir, f"weights_{model}.npz")), pipe)
    tree = pipeline.stage_param_specs(cfg, like, mesh)
    res = {"stages": sorted(tree["stages"])}
    if kind == "logits":
        with torch.no_grad():
            got = pipeline.pipeline_forward(cfg, tree, tokens, positions,
                                            pipe, m, mesh)
        res["equal_everywhere"] = True
        if rank == 0:
            np.save(os.path.join(out_dir, name + ".npy"), got.numpy())
        print(f"PIPE PROCESSES {name} pid={rank} " + json.dumps(res),
              flush=True)
        continue
    opt = train.make_optimizer(tree, lr=lr)
    step = pipeline.make_pipeline_train_step(cfg, opt, pipe, m, mesh)
    grads = {}
    adam = opt.step

    def step_and_keep(*a, **kw):
        if not grads:
            grads["tree"] = pipeline.unstage(
                cfg, tree, like, mesh, lambda x: x.grad)
        return adam(*a, **kw)
    opt.step = step_and_keep
    for k in calls:
        calls[k] = 0
    losses = [step(tree, None, tokens, positions)[2].item()]
    res["launches"] = dict(calls)
    after = pipeline.unstage(cfg, tree, like, mesh)
    losses.append(step(tree, None, tokens, positions)[2].item())
    res["losses"] = losses
    if "embed" in tree:
        res["embed_sum"] = float(tree["embed"].double().sum())
    if rank == 0:
        multihost_check.save_tree(os.path.join(out_dir, name + ".npz"), after)
        multihost_check.save_tree(os.path.join(out_dir, name + "_grads.npz"),
                                  grads["tree"])
    print(f"PIPE PROCESSES {name} pid={rank} " + json.dumps(res), flush=True)


def refused(case, fn):
    try:
        fn()
    except ValueError as e:
        print(f"REFUSED {case} -- {e}", flush=True)
    else:
        print(f"SERVED {case}", flush=True)


if os.environ.get("GRAFT_REFUSALS"):
    refused("pipe=4,tensor=2", lambda: mesh_for("pipe=4,tensor=2"))
    cfg = models["llama"]
    refused("serve pipe=2,tensor=2", lambda: Engine(
        cfg, transformer.init_params(cfg, dtype=torch.float32, device="cpu"),
        EngineConfig(decode_slots=4, max_seq_len=64, prefill_buckets=(16,)),
        eos_id=None, dtype=torch.float32, device="cpu",
        mesh=mesh_for("pipe=2,tensor=2"), cuda_graphs=False))
print("PIPE PROCESSES DONE", flush=True)
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


def batch():
    """Four rows of 16 tokens (numpy seed 0), right-padded to 16, 14, 10
    and 6 real tokens (pads at position 0, out of the loss's mask)."""
    rng = np.random.RandomState(0)
    tokens = rng.randint(1, 320, size=(4, 16)).astype(np.int32)
    positions = np.zeros((4, 16), np.int32)
    for row, n in enumerate((16, 14, 10, 6)):
        positions[row, :n] = np.arange(n)
        tokens[row, n:] = 0
    return tokens, positions


# name -> (model, axes, microbatches, kind, fault, processes,
#          flash launches per step in each process)
RUNS = {
    "pp2tp4": ("llama", "pipe=2,tensor=4", 4, "step", "", 2, 32),
    "pp2tp4_logits": ("llama", "pipe=2,tensor=4", 4, "logits", "", 2, None),
    "pp2tp4_reversed": ("llama", "pipe=2,tensor=4", 4, "step", "reversed",
                        2, 32),
    "dp2pp2tp2_over2": ("llama", "data=2,pipe=2,tensor=2", 2, "step", "", 2,
                        16),
    "gemma_pp2": ("gemma", "pipe=2", 2, "step", "", 2, 4),
    "gemma_pp2_untied": ("gemma", "pipe=2", 2, "step", "untied", 2, 4),
    "dp2pp2tp2_over4": ("llama", "data=2,pipe=2,tensor=2", 2, "step", "", 4,
                        8),
    "pp4tp2": ("llama", "pipe=4,tensor=2", 4, "step", "", 4, 8),
    "pp2tp2_over4": ("llama", "pipe=2,tensor=2", 2, "step", "", 4, 4),
    "fsdp2pp2tp2": ("llama", "fsdp=2,pipe=2,tensor=2", 2, "step", "", 4, 8),
    "pp2tp2sp2": ("llama", "pipe=2,tensor=2,sequence=2", 2, "step", "", 4,
                  4),
    "pp2sp2": ("llama", "pipe=2,sequence=2", 2, "step", "", 4, 4),
    "moe_pp2ep2": ("moe", "pipe=2,expert=2", 2, "step", "", 4, 2),
    "layout63_pp2tp2": ("layout63", "pipe=2,tensor=2", 2, "step", "", 4, 4),
}


def _axes(axes: str) -> dict:
    return {k: int(v) for k, v in (p.split("=") for p in axes.split(","))}


def _jax_mesh(axes: dict):
    cfg = jmesh.MeshConfig(**axes)
    return jmesh.make_mesh(cfg, devices=jax.devices()[:cfg.total])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's weights and batch as files, and at each run's mesh
    its jitted pipelined step twice and the gradients of the first:
    (dir, {(model, axes, m): (first loss, before, after, grads, second
    loss)}, {axes: logits})."""
    d = tmp_path_factory.mktemp("pipeline_processes")
    tokens, positions = batch()
    np.savez(str(d / "batch.npz"), tokens=tokens, positions=positions)
    params = {}
    for model, jcfg in MODELS.items():
        params[model] = jtf.init_params(jcfg, jax.random.PRNGKey(0),
                                        dtype=jnp.float32)
        multihost_check.save_tree(str(d / f"weights_{model}.npz"),
                                  to_np(params[model]))
    opt = optax.adamw(LR)
    want, logits, grads = {}, {}, {}
    for model, axes, m, kind, *_ in RUNS.values():
        jcfg = MODELS[model]
        key = (model, axes, m)
        ax = _axes(axes)
        mesh = _jax_mesh(ax)
        pp = ax["pipe"]
        staged = jsh.shard_pytree(
            jpipe.stage_params(jcfg, params[model], pp),
            jpipe.stage_param_specs(jcfg, jsh.param_specs(jcfg)), mesh)
        if kind == "logits":
            logits[axes] = np.asarray(jax.jit(
                lambda q, tk, ps: jpipe.pipeline_forward(
                    jcfg, q, tk, ps, pp, m, mesh=mesh))(
                staged, tokens, positions))
            continue
        if key in want:
            continue
        if (model, pp, m) not in grads:
            # The schedule's gradient does not depend on the mesh (only
            # its summation order does): one compile per (model, pp, M).
            grads[model, pp, m] = flat(to_np(jax.jit(jax.grad(
                lambda q, jcfg=jcfg, pp=pp, m=m: jpipe.pipeline_lm_loss(
                    jcfg, q, tokens, positions, pp, m)))(
                jpipe.stage_params(jcfg, params[model], pp))))
        step = jax.jit(jpipe.make_pipeline_train_step(jcfg, opt, pp, m,
                                                      mesh=mesh))
        new, state, loss = step(staged, opt.init(staged), tokens, positions)
        loss2 = step(new, state, tokens, positions)[2]
        want[key] = (float(loss), flat(to_np(staged)), flat(to_np(new)),
                     grads[model, pp, m], float(loss2))
    return d, want, logits


def run_group(d, names: list, n_processes: int, refusals: bool) -> tuple:
    """The worker's runs over ``n_processes``: (name -> (each process's
    result, the whole tree after the first step, its gradients), the
    processes' output)."""
    outs = multihost_check.run_processes(
        WORKER, n_processes, n_local=1, timeout_s=200,
        env={"GRAFT_LR": str(LR), "GRAFT_OUT": str(d),
             "GRAFT_REFUSALS": "1" if refusals else "",
             "GRAFT_RUNS": ";".join(
                 "|".join([name, *map(str, RUNS[name][:5])])
                 for name in names)})
    got = {}
    for name in names:
        lines = multihost_check.ok_lines(outs, f"PIPE PROCESSES {name} ")
        res = [json.loads(line.split(" ", 4)[4]) for line in lines]
        if RUNS[name][3] == "logits":
            got[name] = (res, np.load(str(d / f"{name}.npy")), None)
            continue
        trees = [flat(multihost_check.load_tree(str(d / f"{name}{part}.npz")))
                 for part in ("", "_grads")]
        got[name] = (res, *trees)
    return got, outs


@pytest.fixture(scope="module")
def trained(reference):
    d = reference[0]
    got, text = {}, {}
    for procs in (2, 4):
        names = [n for n, r in RUNS.items() if r[5] == procs]
        part, outs = run_group(d, names, procs, refusals=procs == 2)
        got.update(part)
        text[procs] = outs
    return got, text


def grad_errors(want, grads: dict) -> dict:
    """path -> the largest |error| over the reference's largest |grad|."""
    return {p: float(np.abs(grads[p] - w).max() / max(np.abs(w).max(), 1e-6))
            for p, w in want[3].items()}


def update_errors(want, after: dict) -> dict:
    """path -> the largest |update / lr| error where the reference's
    gradient clears the noise floor."""
    _, before, want_after, grads, _ = want
    errs = {}
    for path, w in want_after.items():
        g = np.abs(grads[path])
        sure = g > NOISE_FLOOR * max(g.max(), 1e-30)
        du_got = (after[path].astype(np.float64) - before[path]) / LR
        du_want = (w.astype(np.float64) - before[path]) / LR
        err = np.abs(du_got - du_want)[sure]
        errs[path] = float(err.max()) if err.size else 0.0
    return errs


def _want(reference, name):
    model, axes, m, *_ = RUNS[name]
    return reference[1][model, axes, m]


SOUND = [n for n, r in RUNS.items() if r[3] == "step" and not r[4]]


@pytest.mark.parametrize("name", SOUND)
def test_step_across_processes_matches_reference(reference, trained, name):
    """Every process reports the reference's loss at both steps; the
    reassembled gradients and update of the first step are the
    reference's; flash and its backward launch exactly as the schedule
    says in every process."""
    want = _want(reference, name)
    res, after, grads = trained[0][name]
    for step, ref in ((0, want[0]), (1, want[4])):
        losses = {r["losses"][step] for r in res}
        assert len(losses) == 1, (name, step, losses)
        got = losses.pop()
        assert abs(got - ref) <= LOSS_RTOL * abs(ref), (name, step, got, ref)
    bad = {p: e for p, e in grad_errors(want, grads).items() if e > GRAD_TOL}
    assert not bad, (name, bad)
    bad = {p: e for p, e in update_errors(want, after).items()
           if e >= UPDATE_TOL}
    assert not bad, (name, bad)
    per = RUNS[name][6]
    for r in res:
        assert r["launches"] == {"forward": per, "backward": per}, (name, r)


def test_every_stage_is_owned(reference, trained):
    """Each run's processes own one stage each, or all of them, and
    together every stage."""
    for name, (model, axes, *_) in RUNS.items():
        pipe = _axes(axes)["pipe"]
        owned = [r["stages"] for r in trained[0][name][0]]
        assert all(len(s) in (1, pipe) for s in owned), (name, owned)
        assert set().union(*owned) == set(range(pipe)), (name, owned)


def test_tied_embed_copies_stay_equal(trained):
    """Gemma's tied ``embed``: the first stage's and the last stage's
    copies equal after two steps (each took the sum of both gradients)."""
    res = trained[0]["gemma_pp2"][0]
    sums = [r["embed_sum"] for r in res]
    assert len(sums) == 2 and sums[0] == sums[1], sums


def test_logits_across_processes_match_reference(reference, trained):
    """``pipeline_forward`` at pp2tp4 over two processes: the logits whole
    on every process (broadcast from the last stage), within the
    reference test's 5e-4 of its sharded forward."""
    _, got, _ = trained[0]["pp2tp4_logits"]
    np.testing.assert_allclose(got, reference[2]["pipe=2,tensor=4"],
                               rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("name", ["pp2tp4_reversed", "gemma_pp2_untied"])
def test_planted_fault_fails_the_gradient_check(reference, trained, name):
    """The gradients sent back in forward microbatch order; a tied
    ``embed``'s gradient left unsummed between the first and last
    stages: the first loss stays the reference's, the gradients do not."""
    want = _want(reference, name)
    res, _, grads = trained[0][name]
    assert abs(res[0]["losses"][0] - want[0]) <= LOSS_RTOL * abs(want[0])
    assert max(grad_errors(want, grads).values()) > 100 * GRAD_TOL, name


def test_layouts_refused_by_name(trained):
    """A process owning part of the pipe axis (pipe=4 over two processes)
    and ``pipe`` in serving are refused, each naming what it refuses."""
    out = trained[1][2][0]
    assert "PIPE PROCESSES DONE" in out, out[-3000:]
    lines = {line.split(" -- ")[0]: line for line in out.splitlines()
             if line.startswith(("REFUSED", "SERVED"))}
    part = lines.get("REFUSED pipe=4,tensor=2", "")
    assert "part of the pipe axis" in part and "process 0" in part, lines
    serve = lines.get("REFUSED serve pipe=2,tensor=2", "")
    assert "pipe=1" in serve, lines


# ---------------------------------------------------------------------------
# One process: the meshes with fsdp and sequence the reference trains
# ---------------------------------------------------------------------------


def _to_np(tree):
    if isinstance(tree, dict):
        return {k: _to_np(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


@pytest.mark.parametrize("axes", ["fsdp=2,pipe=2,tensor=2",
                                  "pipe=2,tensor=2,sequence=2"])
def test_one_process_fsdp_and_sequence_match_reference(reference, axes):
    """Every shard on the CPU in one process: one step's loss, gradients
    and update against the reference's jitted step at the same mesh."""
    d, wants, _ = reference
    want = wants["llama", axes, 2]
    cfg = dataclasses.replace(TINY_TEST, name="tiny-pipe", n_layers=4)
    p = multihost_check.load_tree(str(d / "weights_llama.npz"))
    tokens, positions = (torch.from_numpy(x) for x in batch())
    mc = tmesh.MeshConfig(**_axes(axes))
    mesh = tmesh.make_mesh(mc, ["cpu"] * mc.total)
    staged = tpipe.stage_param_specs(cfg, tpipe.stage_params(cfg, p, 2),
                                     mesh)
    opt = ttrain.make_optimizer(staged, lr=LR)
    got = {}
    adam = opt.step

    def step_and_keep(*a, **kw):
        got.update(flat(_to_np(tsh.map_tree(
            staged, lambda x: x.grad))))
        return adam(*a, **kw)
    opt.step = step_and_keep
    _, _, loss = tpipe.make_pipeline_train_step(cfg, opt, 2, 2, mesh)(
        staged, None, tokens, positions)
    assert abs(loss.item() - want[0]) <= LOSS_RTOL * abs(want[0])
    bad = {k: e for k, e in grad_errors(want, got).items() if e > GRAD_TOL}
    assert not bad, (axes, bad)
    bad = {k: e for k, e in update_errors(want, flat(_to_np(staged))).items()
           if e >= UPDATE_TOL}
    assert not bad, (axes, bad)


def test_one_process_cross_card_fsdp_refused():
    """One process across cards with fsdp above 1: refused, naming the
    route that serves it (one process a card)."""
    cfg = dataclasses.replace(TINY_TEST, name="tiny-pipe", n_layers=4)
    mc = tmesh.MeshConfig(fsdp=2, pipe=2)
    mesh = tmesh.make_mesh(mc, [f"cpu:{i}" for i in range(mc.total)])
    with pytest.raises(ValueError, match="one process a card"):
        tpipe.make_pipeline_train_step(cfg, None, 2, 2, mesh=mesh)
