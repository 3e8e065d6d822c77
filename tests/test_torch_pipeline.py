"""The pipelined trainer (``parallel/pipeline.py``, GPipe over the
``pipe`` mesh axis) in the torch port, held to the JAX package's
``parallel/pipeline.py`` on the CPU at f32.

- Staging: ``stage_params``' shapes (views of the caller's leaves,
  contiguous stages), a layer count ``pipe`` does not divide refused;
  ``stage_param_specs`` on one device (the same views) and across
  devices (each stage's leaves on its pipe coordinate's first device).
- The forward: logits within 1e-5 of the reference's ``pipeline_forward``
  at pipe 1, 2 and 4 times M microbatches, the flash forward called
  exactly L x M times (the live (stage, microbatch) pairs only); a batch
  M does not divide refused.
- Gradients: loss and every leaf of the staged tree against ``jax.grad``
  of the reference's ``pipeline_lm_loss`` within the reference's own 2e-4
  (over each leaf's largest |gradient|), the flash backward called
  exactly L x M times; two AdamW steps against the reference's
  ``make_pipeline_train_step`` with optax (``tests/test_torch_train.py``'s
  update rule: updates over lr compared where the reference's |grad|
  clears a noise floor), each step from the reference's parameters and
  Adam moments (Adam turns a gradient at rounding noise into a step of
  +-lr, so two trajectories left alone part at once and the next step's
  gradients differ far beyond rounding).
- The reference's three sharded cases (pp2tp4, dp2pp2tp2, pp4tp2) with
  every shard on the CPU: logits against the reference's sharded
  forward on its virtual 8-device mesh, the gradients of dp2pp2tp2
  against the unsharded pipeline's, and its train step's loss falling.
- Across devices (the CPU's device indices taken as distinct): the
  stages' placement, a train step equal to the one-device step, and the
  refusal of a cross-card step with tensor or data above 1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from llm_instance_gateway_tpu.models.configs import TINY_TEST as JAX_TINY
from llm_instance_gateway_tpu.parallel import mesh as jmesh
from llm_instance_gateway_tpu.parallel import pipeline as jpipe
from llm_instance_gateway_tpu.parallel import sharding as jsh

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch.models import transformer as ttf  # noqa: E402
from llm_instance_gateway_tpu_torch.models.configs import TINY_TEST  # noqa: E402
from llm_instance_gateway_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from llm_instance_gateway_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from llm_instance_gateway_tpu_torch.parallel import pipeline as tpipe  # noqa: E402
from llm_instance_gateway_tpu_torch.training import train as ttrain  # noqa: E402

CFG = dataclasses.replace(TINY_TEST, name="tiny-pipe", n_layers=4)
JCFG = dataclasses.replace(JAX_TINY, name="tiny-pipe", n_layers=4)
F32 = torch.float32
FWD_TOL = 1e-5
GRAD_TOL = 2e-4  # the reference's test_pipeline_grads_match_plain
LOSS_TOL = 1e-5
UPDATE_TOL = 1e-3
NOISE_FLOOR = 1e-3
LR = 1e-3  # tests/test_torch_train.py's


def params():
    return ttf.init_params(CFG, seed=0, dtype=F32, device="cpu")


def to_jax(tree):
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.detach().cpu().numpy())


def inputs(b=4, s=16, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, CFG.vocab_size, (b, s)).astype(np.int32)
    positions = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    return tokens, positions


def t(x):
    return torch.from_numpy(np.asarray(x)).long()


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat(v, key + "."))
        else:
            out[key] = v
    return out


@pytest.fixture
def counted(monkeypatch):
    """Calls of the flash forward and backward (their plain versions here;
    the kernels on the card)."""
    calls = {"forward": 0, "backward": 0}
    fwd, bwd = tfa._forward, tfa.flash_attention_backward

    def forward(*a):
        calls["forward"] += 1
        return fwd(*a)

    def backward(*a, **k):
        calls["backward"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(tfa, "_forward", forward)
    monkeypatch.setattr(tfa, "flash_attention_backward", backward)
    return calls


def port_mesh(cfg, devices=None):
    return tmesh.make_mesh(cfg, devices or ["cpu"] * cfg.total)


# ---------------------------------------------------------------------------
# Staging
# ---------------------------------------------------------------------------


class TestStaging:
    def test_stage_params_shapes(self):
        p = params()
        staged = tpipe.stage_params(CFG, p, pipe=2)
        wq = staged["layers"]["wq"]
        assert wq.shape[:2] == (2, 2)
        want = jpipe.stage_params(JCFG, to_jax(p), pipe=2)
        for name, leaf in flat(staged).items():
            assert tuple(leaf.shape) == tuple(flat(want)[name].shape), name
        # Stage 0 holds layers [0, L/pp): contiguous, views of the leaves.
        assert torch.equal(wq[0, 1], p["layers"]["wq"][1])
        assert wq.untyped_storage().data_ptr() == (
            p["layers"]["wq"].untyped_storage().data_ptr())

    def test_indivisible_layers_rejected(self):
        with pytest.raises(ValueError, match="divisible"):
            tpipe.stage_params(CFG, params(), pipe=3)

    def test_staged_specs(self):
        """One device: the staged tree itself; distinct devices: each
        layer leaf the list of its stages, stage i's equal to
        ``staged[i]``."""
        staged = tpipe.stage_params(CFG, params(), pipe=2)
        one = tpipe.stage_param_specs(CFG, staged, port_mesh(
            tmesh.MeshConfig(pipe=2)))
        assert one["layers"]["wq"] is staged["layers"]["wq"]
        cards = tpipe.stage_param_specs(CFG, staged, port_mesh(
            tmesh.MeshConfig(pipe=2), ["cpu:0", "cpu:1"]))
        for name, leaf in staged["layers"].items():
            stages = cards["layers"][name]
            assert isinstance(stages, list) and len(stages) == 2
            for i in range(2):
                assert torch.equal(stages[i], leaf[i])


# ---------------------------------------------------------------------------
# The forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pipe,m", [(1, 1), (1, 2), (2, 2), (2, 4), (4, 4)],
                         ids=["pp1m1", "pp1m2", "pp2m2", "pp2m4", "pp4m4"])
def test_forward_matches_reference(counted, pipe, m):
    p = params()
    tokens, positions = inputs()
    want = jpipe.pipeline_forward(JCFG, jpipe.stage_params(JCFG, to_jax(p),
                                                           pipe),
                                  jnp.asarray(tokens), jnp.asarray(positions),
                                  pipe, m)
    with torch.no_grad():
        got = tpipe.pipeline_forward(CFG, tpipe.stage_params(CFG, p, pipe),
                                     t(tokens), t(positions), pipe, m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)
    assert counted["forward"] == CFG.n_layers * m
    with torch.no_grad():
        plain = ttf.prefill(CFG, p, t(tokens), t(positions))[0]
    assert torch.equal(got, plain) or pipe > 1 or m > 1


def test_indivisible_batch_rejected():
    staged = tpipe.stage_params(CFG, params(), pipe=2)
    tokens, positions = inputs(b=4)
    with pytest.raises(ValueError, match="microbatch"):
        tpipe.pipeline_forward(CFG, staged, t(tokens), t(positions), 2, 3)


# ---------------------------------------------------------------------------
# Gradients and the train step
# ---------------------------------------------------------------------------


def port_grads(staged, tokens, positions, pipe, m, mesh=None):
    leaves = ttrain._leaves(staged)
    for x in leaves:
        x.requires_grad_(True)
    loss = tpipe.pipeline_lm_loss(CFG, staged, t(tokens), t(positions), pipe,
                                  m, mesh=mesh)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for x in leaves:
        x.requires_grad_(False)
    by_leaf = {id(x): g for x, g in zip(leaves, grads)}
    return loss.detach(), {k: by_leaf[id(v)] for k, v in
                           flat(staged).items()}


def assert_grads_close(got: dict, want: dict, what: str) -> None:
    for path, w in want.items():
        w = np.asarray(w)
        g = got[path].reshape(w.shape).numpy()
        err = np.abs(g - w).max()
        assert err <= GRAD_TOL * max(np.abs(w).max(), 1e-6), (what, path,
                                                              err)


@pytest.mark.parametrize("pipe,m", [(1, 2), (2, 2), (4, 4)],
                         ids=["pp1m2", "pp2m2", "pp4m4"])
def test_grads_match_reference(counted, pipe, m):
    p = params()
    tokens, positions = inputs()
    jstaged = jpipe.stage_params(JCFG, to_jax(p), pipe)
    want_loss, want = jax.value_and_grad(lambda q: jpipe.pipeline_lm_loss(
        JCFG, q, tokens, positions, pipe, m))(jstaged)
    loss, got = port_grads(tpipe.stage_params(CFG, p, pipe), tokens,
                           positions, pipe, m)
    assert abs(loss.item() - float(want_loss)) < LOSS_TOL
    assert_grads_close(got, flat(want), f"pp{pipe}m{m}")
    assert counted["forward"] == CFG.n_layers * m
    assert counted["backward"] == CFG.n_layers * m


def _load_reference_state(staged, opt, jstaged, jstate) -> None:
    """The port's staged leaves and AdamW moments set to the reference's
    (optax's ``adamw`` state: ``ScaleByAdamState`` first)."""
    adam = jstate[0]
    mu, nu = flat(adam.mu), flat(adam.nu)
    for path, leaf in flat(staged).items():
        with torch.no_grad():
            leaf.copy_(torch.from_numpy(np.asarray(flat(jstaged)[path])))
        if int(adam.count):
            opt.state[leaf] = {
                "step": torch.tensor(float(adam.count)),
                "exp_avg": torch.from_numpy(np.array(mu[path])),
                "exp_avg_sq": torch.from_numpy(np.array(nu[path]))}


def test_two_adamw_steps_match_optax():
    pipe, m = 2, 2
    p = params()
    tokens, positions = inputs()
    jstaged = jpipe.stage_params(JCFG, to_jax(p), pipe)
    jopt = optax.adamw(LR, weight_decay=0.01)
    jstate = jopt.init(jstaged)
    jstep = jpipe.make_pipeline_train_step(JCFG, jopt, pipe, m)
    staged = tpipe.stage_params(CFG, p, pipe)
    topt = ttrain.make_optimizer(staged, lr=LR, weight_decay=0.01)
    tstep = tpipe.make_pipeline_train_step(CFG, topt, pipe, m)
    for i in range(2):
        _load_reference_state(staged, topt, jstaged, jstate)
        before = {k: np.asarray(v, np.float64)
                  for k, v in flat(jstaged).items()}
        jgrads = flat(jax.grad(lambda q: jpipe.pipeline_lm_loss(
            JCFG, q, tokens, positions, pipe, m))(jstaged))
        jstaged, jstate, jloss = jstep(jstaged, jstate, tokens, positions)
        staged, _, tloss = tstep(staged, None, t(tokens), t(positions))
        assert abs(tloss.item() - float(jloss)) < LOSS_TOL
        for path, w1 in flat(jstaged).items():
            g = np.abs(np.asarray(jgrads[path]))
            sure = g > NOISE_FLOOR * max(g.max(), 1e-30)
            du_t = (flat(staged)[path].detach().numpy() - before[path]) / LR
            du_j = (np.asarray(w1, np.float64) - before[path]) / LR
            err = np.abs(du_t - du_j)[sure]
            assert err.size == 0 or err.max() < UPDATE_TOL, (i, path,
                                                             err.max())
            assert np.abs(du_t).max() <= 2.0, (i, path)
    # In place: the caller's tree is the staged tree it trained.
    assert torch.equal(p["layers"]["wq"].reshape(staged["layers"]["wq"]
                                                 .shape),
                       staged["layers"]["wq"])


# ---------------------------------------------------------------------------
# The reference's sharded cases, every shard on the CPU
# ---------------------------------------------------------------------------

SHARDED = {"pp2tp4": (dict(pipe=2, tensor=4), 4),
           "dp2pp2tp2": (dict(data=2, pipe=2, tensor=2), 2),
           "pp4tp2": (dict(pipe=4, tensor=2), 4)}


@pytest.mark.parametrize("case", list(SHARDED))
def test_sharded_forward_matches_reference(counted, case):
    axes, m = SHARDED[case]
    p = params()
    tokens, positions = inputs()
    jm = jmesh.make_mesh(jmesh.MeshConfig(**axes),
                         devices=jax.devices()[:jmesh.MeshConfig(
                             **axes).total])
    jstaged = jsh.shard_pytree(
        jpipe.stage_params(JCFG, to_jax(p), axes["pipe"]),
        jpipe.stage_param_specs(JCFG, jsh.param_specs(JCFG)), jm)
    want = jax.jit(lambda q, tk, ps: jpipe.pipeline_forward(
        JCFG, q, tk, ps, axes["pipe"], m, mesh=jm))(
        jstaged, jnp.asarray(tokens), jnp.asarray(positions))
    mesh = port_mesh(tmesh.MeshConfig(**axes))
    staged = tpipe.stage_param_specs(
        CFG, tpipe.stage_params(CFG, p, axes["pipe"]), mesh)
    with torch.no_grad():
        got = tpipe.pipeline_forward(CFG, staged, t(tokens), t(positions),
                                     axes["pipe"], m, mesh=mesh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4,
                               atol=5e-4)
    # Every shard of every data group, once per live pair and layer.
    assert counted["forward"] == (CFG.n_layers * m * axes["tensor"]
                                  * axes.get("data", 1))


def test_sharded_train_step_learns():
    """dp2pp2tp2 on one device: the gradients through the shard views
    equal the unsharded pipeline's, and five steps lower the loss."""
    axes, m = SHARDED["dp2pp2tp2"]
    mesh = port_mesh(tmesh.MeshConfig(**axes))
    tokens, positions = inputs()
    _, want = port_grads(tpipe.stage_params(CFG, params(), 2), tokens,
                         positions, 2, m)
    staged = tpipe.stage_params(CFG, params(), 2)
    _, got = port_grads(staged, tokens, positions, 2, m, mesh=mesh)
    assert_grads_close(got, {k: v.numpy() for k, v in want.items()},
                       "dp2pp2tp2")
    opt = ttrain.make_optimizer(staged, lr=LR)
    step = tpipe.make_pipeline_train_step(CFG, opt, 2, m, mesh=mesh)
    losses = []
    for _ in range(5):
        staged, _, loss = step(staged, None, t(tokens), t(positions))
        losses.append(loss.item())
    assert losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# Across devices
# ---------------------------------------------------------------------------


def test_pipe_across_devices_matches_one_device():
    """``pipe=2`` over two distinct devices: the stages' leaves are lists
    (each stage's own tensors), the AdamW state per stage, and a train
    step equal to the one-device step's loss and update."""
    tokens, positions = inputs()
    outs = []
    for devices in (["cpu", "cpu"], ["cpu:0", "cpu:1"]):
        mesh = port_mesh(tmesh.MeshConfig(pipe=2), devices)
        staged = tpipe.stage_param_specs(
            CFG, tpipe.stage_params(CFG, params(), 2), mesh)
        opt = ttrain.make_optimizer(staged, lr=LR)
        step = tpipe.make_pipeline_train_step(CFG, opt, 2, 2, mesh=mesh)
        staged, _, loss = step(staged, None, t(tokens), t(positions))
        wq = staged["layers"]["wq"]
        outs.append((loss.item(), torch.stack(list(wq)) if isinstance(
            wq, list) else wq))
    assert isinstance(staged["layers"]["wq"], list)
    assert outs[0][0] == pytest.approx(outs[1][0], abs=LOSS_TOL)
    torch.testing.assert_close(outs[1][1], outs[0][1], rtol=0, atol=1e-6)


def test_cross_card_step_with_tensor_or_data_refused():
    for axes in (dict(pipe=2, tensor=2), dict(pipe=2, data=2)):
        cfg = tmesh.MeshConfig(**axes)
        mesh = port_mesh(cfg, [f"cpu:{i}" for i in range(cfg.total)])
        with pytest.raises(ValueError, match="tensor=1 and data=1"):
            tpipe.make_pipeline_train_step(CFG, None, 2, 2, mesh=mesh)
