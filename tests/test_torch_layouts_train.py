"""Training on the head layouts the reference's kernels do not split,
by the torch port through its head plan (``ops/sharded_attention.
head_plan``: KV heads replicated over the shards that share them, query
groups and KV heads padded with zero heads), held to the JAX package on
the CPU at f32 with every shard on the CPU.  The reference trains these
layouts too: GSPMD splits the q/k/v columns evenly, even mid-head, so
its result on a mesh is the unsharded step's math, which is what the
port is held to.

Layouts (``tests/test_torch_layouts.py``'s): 14:2 (``TINY_QWEN_TEST``'s
widths, seeded non-zero q/k/v biases) at tensor=4 and tensor=8, 8:4
(``TINY_TEST``'s) at tensor=8, 6:3 at tensor=2.

Cases, one per layout and kind (full-parameter, LoRA) where it applies:
``unshard(shard_params(p)) == p`` exactly; one step in one process (the
sharded full and LoRA steps) against the reference's jitted step on the
whole batch (loss, every gradient leaf, the update, the caller's tree
equal to ``unshard``'s and every zero head's gradient exactly 0), and
against the reference's jitted step over ``shard_pytree(...,
param_specs / lora_specs)`` on its 8-device CPU mesh at the same
``tensor``; two steps with ``weight_decay=0.1`` against the reference's
two (zero heads stay exactly 0, a KV head's replicas agree bitwise); the
pipelined step at ``pipe=2,tensor=4`` on 14:2 against the reference's
``make_pipeline_train_step`` at the same mesh; 14:2 at tensor=4 beside
fsdp=2 (the padded copies' fsdp pieces written back); a contiguous layout
(14:2 at tensor=2) against the unsharded step.  Planted at 14:2,
tensor=4: ``unmasked`` (the zero heads' gradients left in) and
``unsummed`` (every shard holding its own copy of its heads, so the KV
replicas each keep their own shard's gradient); each must fail the
gradient check.

Tolerances (``tests/test_torch_train_processes.py``'s rules):

- ``LOSS_RTOL`` (1e-5, relative): the loss, f32 summation order only;
- ``GRAD_TOL`` (1e-4 of a leaf's largest |grad|): every gradient leaf;
- ``UPDATE_TOL`` (1e-3) over ``NOISE_FLOOR`` (1e-3 of a leaf's largest
  |grad|): the AdamW update over lr (Adam turns a gradient at rounding
  noise into a +-lr step).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from llm_instance_gateway_tpu.models.configs import TINY_QWEN_TEST as JAX_QWEN
from llm_instance_gateway_tpu.models.configs import TINY_TEST as JAX_TINY
from llm_instance_gateway_tpu.parallel import mesh as jmesh
from llm_instance_gateway_tpu.parallel import pipeline as jpipe
from llm_instance_gateway_tpu.parallel import sharding as jsh
from llm_instance_gateway_tpu.training import train as jtrain

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch.models import lora as tlora  # noqa: E402
from llm_instance_gateway_tpu_torch.models import transformer as ttf  # noqa: E402
from llm_instance_gateway_tpu_torch.models.configs import (  # noqa: E402
    TINY_QWEN_TEST,
    TINY_TEST,
)
from llm_instance_gateway_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from llm_instance_gateway_tpu_torch.parallel import pipeline as tpipe  # noqa: E402
from llm_instance_gateway_tpu_torch.parallel import sharding as tsh  # noqa: E402
from llm_instance_gateway_tpu_torch.training import train as ttrain  # noqa: E402

F32 = torch.float32
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
UPDATE_TOL = 1e-3
NOISE_FLOOR = 1e-3
LR = 1e-3
WEIGHT_DECAY = 0.1

# name -> (port cfg, JAX cfg), as tests/test_torch_layouts.py has them.
MODELS = {
    "14:2": (dataclasses.replace(TINY_QWEN_TEST, n_heads=14, n_kv_heads=2),
             dataclasses.replace(JAX_QWEN, n_heads=14, n_kv_heads=2)),
    "8:4": (dataclasses.replace(TINY_TEST, n_heads=8, n_kv_heads=4),
            dataclasses.replace(JAX_TINY, n_heads=8, n_kv_heads=4)),
    "6:3": (dataclasses.replace(TINY_TEST, n_heads=6, n_kv_heads=3),
            dataclasses.replace(JAX_TINY, n_heads=6, n_kv_heads=3)),
}
LAYOUTS = [("14:2", 4), ("14:2", 8), ("8:4", 8), ("6:3", 2)]
CASES = [(name, t, kind) for name, t in LAYOUTS for kind in ("full", "lora")]
IDS = [f"{name}-t{t}-{kind}" for name, t, kind in CASES]


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


def flat(tree, prefix=""):
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(v)
    return out


def model_params(cfg):
    params = ttf.init_params(cfg, seed=0, dtype=F32, device="cpu")
    if cfg.attention_bias:  # non-zero biases, so a mis-split shows
        g = torch.Generator().manual_seed(5)
        for name in ("wq_b", "wk_b", "wv_b"):
            leaf = params["layers"][name]
            leaf.copy_(torch.randn(leaf.shape, generator=g) * 0.5)
    return params


def lora_bufs(cfg):
    """``tests/test_torch_layouts.py``'s adapters: slot 0 (alpha 8) and
    slot 1 (alpha 4) at rank 3, seeded a and b at scale 0.1."""
    bufs = tlora.init_lora_buffers(cfg, dtype=F32, device="cpu")
    for slot, (seed, alpha) in enumerate(((1, 8.0), (2, 4.0))):
        rng = np.random.default_rng(seed)
        adapter = {t: {"a": rng.standard_normal((cfg.n_layers, d_in, 3))
                       .astype(np.float32) * 0.1,
                       "b": rng.standard_normal((cfg.n_layers, 3, d_out))
                       .astype(np.float32) * 0.1}
                   for t, (d_in, d_out) in tlora.target_dims(cfg).items()}
        tlora.write_adapter(bufs, cfg, slot, adapter, alpha, 3)
    return bufs


def batch():
    """Four rows of 16 tokens (numpy seed 0), right-padded to 16, 14, 10
    and 6 real tokens (pads at position 0, out of the loss's mask), and
    the rows' adapter slots."""
    rng = np.random.RandomState(0)
    tokens = rng.randint(1, 320, size=(4, 16)).astype(np.int32)
    positions = np.zeros((4, 16), np.int32)
    for row, n in enumerate((16, 14, 10, 6)):
        positions[row, :n] = np.arange(n)
        tokens[row, n:] = 0
    return tokens, positions, np.array([0, -1, 1, 0], np.int32)


def grad_errors(want: dict, got: dict) -> dict:
    """path -> the largest |error| over the reference's largest |grad|."""
    return {p: float(np.abs(got[p] - w).max() / max(np.abs(w).max(), 1e-6))
            for p, w in want.items()}


def update_errors(before: dict, want_after: dict, grads: dict,
                  after: dict) -> dict:
    """path -> the largest |update / lr| error where the reference's
    gradient clears the noise floor."""
    errs = {}
    for path, w in want_after.items():
        g = np.abs(grads[path])
        sure = g > NOISE_FLOOR * max(g.max(), 1e-30)
        du_got = (after[path].astype(np.float64) - before[path]) / LR
        du_want = (w.astype(np.float64) - before[path]) / LR
        err = np.abs(du_got - du_want)[sure]
        errs[path] = float(err.max()) if err.size else 0.0
    return errs


# ---------------------------------------------------------------------------
# The reference's steps
# ---------------------------------------------------------------------------


def _ref_steps(jcfg, kind: str, params, bufs, steps: int, weight_decay: float,
               mesh=None) -> tuple:
    """The reference's jitted step ``steps`` times on the whole batch (over
    ``shard_pytree`` on ``mesh`` where given): (losses, the trained tree
    flat)."""
    tokens, positions, slots = batch()
    opt = optax.adamw(LR, weight_decay=weight_decay)
    jp = jax.tree.map(jnp.asarray, to_numpy(params))
    jb = jax.tree.map(jnp.asarray, to_numpy(bufs))
    if mesh is not None:
        jp = jsh.shard_pytree(jp, jsh.param_specs(jcfg), mesh)
        jb = jsh.shard_pytree(jb, jsh.lora_specs(jcfg), mesh)
    losses = []
    if kind == "full":
        step = jax.jit(jtrain.make_full_train_step(jcfg, opt))
        state = opt.init(jp)
        for _ in range(steps):
            jp, state, loss = step(jp, state, tokens, positions)
            losses.append(float(loss))
        return losses, flat(jax.tree.map(np.asarray, jp))
    step = jax.jit(jtrain.make_lora_train_step(jcfg, opt))
    state = opt.init(jb)
    for _ in range(steps):
        jb, state, loss = step(jp, jb, state, tokens, positions, slots)
        losses.append(float(loss))
    return losses, flat(jax.tree.map(np.asarray, jb))


def _ref_grads(jcfg, kind: str, params, bufs) -> dict:
    tokens, positions, slots = batch()
    jp = jax.tree.map(jnp.asarray, to_numpy(params))
    jb = jax.tree.map(jnp.asarray, to_numpy(bufs))
    if kind == "full":
        g = jax.grad(lambda p: jtrain.causal_lm_loss(
            jcfg, p, tokens, positions))(jp)
    else:
        g = jax.grad(lambda b: jtrain.causal_lm_loss(
            jcfg, jp, tokens, positions, lora_bufs=b, slot_ids=slots))(jb)
        g = {**g, "scale": jnp.zeros_like(jb["scale"])}
    return flat(jax.tree.map(np.asarray, g))


_REF: dict = {}


def reference(name: str, kind: str, steps: int = 1,
              weight_decay: float = 0.0, t: int | None = None) -> tuple:
    """(losses, before, after, grads) of the reference (flat numpy trees),
    cached; ``t``: its step on the 8-device mesh at ``tensor=t``."""
    key = (name, kind, steps, weight_decay, t)
    if key not in _REF:
        cfg, jcfg = MODELS[name]
        params, bufs = model_params(cfg), lora_bufs(cfg)
        before = flat(to_numpy(params if kind == "full" else bufs))
        losses, after = _ref_steps(
            jcfg, kind, params, bufs, steps, weight_decay,
            None if t is None else ref_mesh(tensor=t))
        _REF[key] = (losses, before, after,
                     _ref_grads(jcfg, kind, params, bufs))
    return _REF[key]


# ---------------------------------------------------------------------------
# The port's sharded step in one process
# ---------------------------------------------------------------------------


def grad_of(x):
    """A leaf's gradient (zeros where it took none), an fsdp leaf's piece
    by piece."""
    if isinstance(x, tsh.FsdpLeaf):
        return tsh.FsdpLeaf([grad_of(p) for p in x.pieces], x.axis,
                            x.one_device, x.group, x.positions, x.total)
    return x.grad if x.grad is not None else torch.zeros_like(x)


def grads_of(tree: tsh.Shards) -> tsh.Shards:
    """The leaves' gradients as a tree of the same layout."""
    return tsh.Shards([tsh.map_tree(t, grad_of) for t in tree], tree.tp)


def zero_head_max(tree: tsh.Shards, value) -> float:
    """The largest |value(tensor)| over every zero head's slice of the
    shards' head leaves."""
    hd = tree.tp.hd
    return max([value(x).narrow(axis, j * hd, hd).abs().max().item()
                for x, axis, js in tsh.zero_heads(tree) for j in js] or [0.0])


def whole(tree: tsh.Shards, like: dict):
    """``unshard``'s whole tree, flat, or the ``ValueError`` it raises where
    a KV head's replicas differ."""
    try:
        return flat(to_numpy(tsh.unshard(tree, like)))
    except ValueError as e:
        return e


def port_steps(name: str, t: int, kind: str, steps: int = 1,
               weight_decay: float = 0.0, fsdp: int = 1) -> dict:
    """The port's sharded step ``steps`` times at ``tensor=t`` (beside
    ``fsdp``), every shard on the CPU: its losses, the first step's
    gradients (reassembled, ``whole``, and per shard), the trained tree
    (``unshard``'s and the caller's), the zero heads' largest |grad| and
    |value|."""
    cfg, _ = MODELS[name]
    tokens, positions, slots = (torch.from_numpy(x) for x in batch())
    params = model_params(cfg)
    tp = tsh.TensorParallel(cfg, port_mesh(tensor=t, fsdp=fsdp))
    sp = tsh.shard_params(params, tp)
    if kind == "full":
        caller, tree = params, sp
        opt = ttrain.make_optimizer(tree, lr=LR, weight_decay=weight_decay)
        step = ttrain.make_full_train_step(cfg, opt)

        def run():
            return step(tree, None, tokens, positions)[2]
    else:
        caller = lora_bufs(cfg)
        tree = tsh.shard_lora(caller, tp)
        opt = ttrain.make_optimizer(tree, lr=LR, weight_decay=weight_decay)
        step = ttrain.make_lora_train_step(cfg, opt)

        def run():
            return step(sp, tree, None, tokens, positions, slots)[2]
    like = copy.deepcopy(caller)
    got: dict = {}
    adam = opt.step

    def step_and_keep(*a, **kw):
        if "grads" not in got:
            got["grad_shards"] = grads_of(tree)
            got["grads"] = whole(got["grad_shards"], like)
            got["zero_grad"] = zero_head_max(tree, lambda x: x.grad)
        return adam(*a, **kw)
    opt.step = step_and_keep
    got["losses"] = [run().item() for _ in range(steps)]
    got["unshard"] = whole(tree, like)
    got["caller"] = flat(to_numpy(caller))
    got["zero_value"] = zero_head_max(tree, lambda x: x)
    got["tree"] = tree
    got["like"] = like
    return got


def check_grads(want: tuple, got: dict) -> None:
    """The gradient check: every zero head's gradient exactly 0, a KV
    head's replicas' gradients bitwise equal, and the reassembled
    gradients the reference's within GRAD_TOL."""
    assert got["zero_grad"] == 0.0, got["zero_grad"]
    # A replica differing from its first shard's: ``unshard`` raised.
    assert isinstance(got["grads"], dict), got["grads"]
    bad = {p: e for p, e in grad_errors(want[3], got["grads"]).items()
           if e > GRAD_TOL}
    assert not bad, bad


_PORT: dict = {}


def port(name: str, t: int, kind: str, steps: int = 1,
         weight_decay: float = 0.0, fsdp: int = 1) -> dict:
    key = (name, t, kind, steps, weight_decay, fsdp)
    if key not in _PORT:
        _PORT[key] = port_steps(name, t, kind, steps, weight_decay, fsdp)
    return _PORT[key]


# ---------------------------------------------------------------------------
# The cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,t,kind", CASES, ids=IDS)
def test_unshard_is_the_tree_exactly(name, t, kind):
    """``unshard(shard_params(p), p)`` (and of ``shard_lora``) gives ``p``
    back bit for bit: each real head from its first shard, the zero heads
    dropped, the replicas agreeing."""
    cfg, _ = MODELS[name]
    tp = tsh.TensorParallel(cfg, port_mesh(tensor=t))
    whole = model_params(cfg) if kind == "full" else lora_bufs(cfg)
    cut = tsh.shard_params if kind == "full" else tsh.shard_lora
    assert not tp.plan.contiguous
    like = tsh.map_tree(whole, lambda x: torch.full_like(x, float("nan")))
    got = flat(to_numpy(tsh.unshard(cut(whole, tp), like)))
    for path, w in flat(to_numpy(whole)).items():
        np.testing.assert_array_equal(got[path], w, err_msg=path)


@pytest.mark.parametrize("name,t,kind", CASES, ids=IDS)
def test_one_process_step_matches_reference(name, t, kind):
    """One sharded step in one process: the reference's loss, gradients and
    update on the whole batch; every zero head's gradient and value
    exactly 0; the caller's tree (written back) equal to ``unshard``'s."""
    want = reference(name, kind)
    got = port(name, t, kind)
    assert abs(got["losses"][0] - want[0][0]) <= LOSS_RTOL * abs(want[0][0])
    check_grads(want, got)
    assert got["zero_value"] == 0.0
    bad = {p: e for p, e in update_errors(want[1], want[2], want[3],
                                          got["unshard"]).items()
           if e >= UPDATE_TOL}
    assert not bad, bad
    for path, x in got["unshard"].items():
        np.testing.assert_array_equal(got["caller"][path], x, err_msg=path)


@pytest.mark.parametrize("name,t,kind", CASES, ids=IDS)
def test_step_matches_reference_on_its_mesh(name, t, kind):
    """The same step against the reference's jitted step over
    ``shard_pytree(..., param_specs / lora_specs)`` on its 8-device CPU
    mesh at ``tensor=t`` (GSPMD's even column split, mid-head where the
    heads do not divide): loss and update."""
    want = reference(name, kind, t=t)
    plain = reference(name, kind)
    got = port(name, t, kind)
    assert abs(got["losses"][0] - want[0][0]) <= LOSS_RTOL * abs(want[0][0])
    bad = {p: e for p, e in update_errors(want[1], want[2], plain[3],
                                          got["unshard"]).items()
           if e >= UPDATE_TOL}
    assert not bad, bad


@pytest.mark.parametrize("name,t,kind", CASES, ids=IDS)
def test_two_steps_with_weight_decay(name, t, kind):
    """Two steps at ``weight_decay=0.1``: both losses the reference's, its
    update after the first (the second step starts from each side's own
    first, so only the loss is compared there); every zero head stays
    exactly 0 and a KV head's replicas agree bitwise (``unshard``'s
    check)."""
    want = reference(name, kind, steps=2, weight_decay=WEIGHT_DECAY)
    got = port(name, t, kind, steps=2, weight_decay=WEIGHT_DECAY)
    for step in range(2):
        assert abs(got["losses"][step] - want[0][step]) <= (
            LOSS_RTOL * abs(want[0][step])), (step, got["losses"], want[0])
    assert got["zero_grad"] == 0.0 and got["zero_value"] == 0.0
    assert isinstance(got["unshard"], dict), got["unshard"]


@pytest.mark.parametrize("kind", ["full", "lora"])
def test_step_beside_fsdp(kind):
    """14:2 at tensor=4 beside fsdp=2 in one process (a padded shard's
    ``wq`` / ``wq_b`` / ``wo`` copies, those of ``wq`` and ``wo`` cut in
    fsdp pieces and written back piece by piece): the reference's loss,
    gradients and update on the whole batch; zero heads exactly 0; the
    caller's tree ``unshard``'s."""
    want = reference("14:2", kind)
    got = port("14:2", 4, kind, fsdp=2)
    assert abs(got["losses"][0] - want[0][0]) <= LOSS_RTOL * abs(want[0][0])
    check_grads(want, got)
    assert got["zero_value"] == 0.0
    bad = {p: e for p, e in update_errors(want[1], want[2], want[3],
                                          got["unshard"]).items()
           if e >= UPDATE_TOL}
    assert not bad, bad
    for path, x in got["unshard"].items():
        np.testing.assert_array_equal(got["caller"][path], x, err_msg=path)


def test_contiguous_layout_still_trains():
    """A layout the reference's kernels split (14:2 at tensor=2, 7:1 a
    shard, every head leaf a view of the caller's tree): loss, gradients
    and update the reference's, as on the padded layouts."""
    cfg, _ = MODELS["14:2"]
    assert tsh.TensorParallel(cfg, port_mesh(tensor=2)).plan.contiguous
    want = reference("14:2", "full")
    got = port_steps("14:2", 2, "full")
    assert abs(got["losses"][0] - want[0][0]) <= LOSS_RTOL * abs(want[0][0])
    check_grads(want, got)
    bad = {p: e for p, e in update_errors(want[1], want[2], want[3],
                                          got["caller"]).items()
           if e >= UPDATE_TOL}
    assert not bad, bad


def test_pipelined_step_14_2_pipe2_tensor4():
    """The pipelined trainer at ``pipe=2,tensor=4`` on 14:2 in one process
    (each forward cuts the stages' shards anew, a padded shard's copy
    passing its real heads' gradients back): loss, gradients and update
    against the reference's ``make_pipeline_train_step`` at the same
    mesh, two microbatches."""
    cfg, jcfg = MODELS["14:2"]
    tokens, positions, _ = batch()
    p = model_params(cfg)
    jp = jax.tree.map(jnp.asarray, to_numpy(p))
    opt = optax.adamw(LR)
    jstaged = jpipe.stage_params(jcfg, jp, 2)
    want_grads = flat(jax.tree.map(np.asarray, jax.jit(jax.grad(
        lambda q: jpipe.pipeline_lm_loss(jcfg, q, tokens, positions, 2, 2)))(
            jstaged)))
    mesh = ref_mesh(pipe=2, tensor=4)
    staged = jsh.shard_pytree(
        jstaged, jpipe.stage_param_specs(jcfg, jsh.param_specs(jcfg)), mesh)
    new, _, loss = jax.jit(jpipe.make_pipeline_train_step(
        jcfg, opt, 2, 2, mesh=mesh))(staged, opt.init(staged), tokens,
                                    positions)
    want_before = flat(jax.tree.map(np.asarray, jstaged))
    want_after = flat(jax.tree.map(np.asarray, new))

    tree = tpipe.stage_param_specs(cfg, tpipe.stage_params(cfg, p, 2),
                                   port_mesh(pipe=2, tensor=4))
    topt = ttrain.make_optimizer(tree, lr=LR)
    got = {}
    adam = topt.step

    def step_and_keep(*a, **kw):
        got.update(flat(to_numpy(tsh.map_tree(tree, lambda x: x.grad))))
        return adam(*a, **kw)
    topt.step = step_and_keep
    _, _, tloss = tpipe.make_pipeline_train_step(
        cfg, topt, 2, 2, mesh=port_mesh(pipe=2, tensor=4))(
            tree, None, torch.from_numpy(tokens), torch.from_numpy(positions))
    assert abs(tloss.item() - float(loss)) <= LOSS_RTOL * abs(float(loss))
    bad = {k: e for k, e in grad_errors(want_grads, got).items()
           if e > GRAD_TOL}
    assert not bad, bad
    bad = {k: e for k, e in update_errors(want_before, want_after, want_grads,
                                          flat(to_numpy(tree))).items()
           if e >= UPDATE_TOL}
    assert not bad, bad


# ---------------------------------------------------------------------------
# Planted faults
# ---------------------------------------------------------------------------


def _own_copies(self, x, axis, heads, hd):
    """A head cut that gives every shard a copy of its own (no two shards
    share a tensor, as when each shard sits in a process of its own)."""
    return tsh._take_heads(x, axis, heads, hd).clone()


def replica_errors(grad_shards: tsh.Shards, want: dict) -> dict:
    """(leaf, tensor shard, KV head) -> each replica's gradient's largest
    |error| against the reference's gradient of that head, over the
    reference leaf's largest |grad|."""
    tp, hd = grad_shards.tp, grad_shards.tp.hd
    out = {}
    for s in range(tp.t):
        for name in ("wk", "wv"):
            w = want[f"layers/{name}"]
            x = grad_shards[s]["layers"][name].detach().numpy()
            for j, h in enumerate(tp.plan.kv_heads[s]):
                if h >= 0:
                    err = np.abs(x[..., j * hd:(j + 1) * hd]
                                 - w[..., h * hd:(h + 1) * hd]).max()
                    out[name, s, h] = float(err / np.abs(w).max())
    return out


@pytest.mark.parametrize("fault", ["unmasked", "unsummed"])
def test_planted_fault_fails_the_gradient_check(monkeypatch, fault):
    """At 14:2, tensor=4, full-parameter: ``unmasked`` (the zero heads'
    gradients left in: their ``wo`` rows take the causal mean of V's
    gradient) and ``unsummed`` (every shard its own copy of its heads: each
    KV replica keeps its own shard's gradient, which ``unshard`` finds)
    fail the gradient check."""
    if fault == "unmasked":
        monkeypatch.setattr(ttrain, "_mask_zero_heads", lambda tree: None)
    else:
        monkeypatch.setattr(tsh._Placer, "heads", _own_copies)
    want = reference("14:2", "full")
    got = port_steps("14:2", 4, "full")
    assert abs(got["losses"][0] - want[0][0]) <= LOSS_RTOL * abs(want[0][0])
    with pytest.raises(AssertionError):
        check_grads(want, got)
    if fault == "unmasked":
        assert got["zero_grad"] > 0.0 and got["zero_value"] > 0.0
    else:
        with pytest.raises(ValueError, match="replica of KV head"):
            tsh.unshard(got["grad_shards"], got["like"])
        errs = replica_errors(got["grad_shards"], want[3])
        assert min(errs.values()) > 100 * GRAD_TOL, errs
