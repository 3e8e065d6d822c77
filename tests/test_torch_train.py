"""The port's training (``training/train.py``) and flash-attention gradient
against the JAX reference, on the CPU at f32.

Inputs are made from a seed with numpy and cross through
``models/weights.py``.  Tolerances, each for its reason:

- ``BWD_TOL`` (2e-5, over each gradient's largest |value| or 1, whichever
  is larger): the plain flash
  backward against ``torch.autograd`` of the plain forward and against
  ``jax.vjp`` of the reference's ``prefill_attention`` (the Pallas kernel
  itself cannot be differentiated: its JVP rule raises) — f32 summation
  order only, over at most 129 keys.
- ``GRAD_TOL`` (1e-4, over each leaf's largest |gradient|, 1e-5 on the
  loss): the loss and every gradient leaf through two layers of a tiny
  model, softmax over the padded vocabulary and the MoE routing included —
  summation order only.
- ``UPDATE_TOL`` (1e-3): AdamW's update divided by lr, each side's from its
  own parameters, compared only where the reference's |grad| cleared
  ``NOISE_FLOOR`` (1e-3 of the leaf's largest |grad|) at every step so far:
  Adam turns a gradient at rounding noise (~1e-6 of the largest here) into
  a step of about +-lr whatever its size, so below the floor only a bound
  on the update is checked.  The gradients themselves are compared
  everywhere with ``GRAD_TOL``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from llm_instance_gateway_tpu.models import lora as jlora
from llm_instance_gateway_tpu.models import transformer as jtf
from llm_instance_gateway_tpu.models.configs import (
    GEMMA_2B as JAX_GEMMA_2B,
    TINY_MOE_TEST as JAX_TINY_MOE,
    TINY_QWEN_TEST as JAX_TINY_QWEN,
    TINY_TEST as JAX_TINY,
)
from llm_instance_gateway_tpu.ops import attention as jattn
from llm_instance_gateway_tpu.ops import quant as jquant
from llm_instance_gateway_tpu.server import engine as jeng
from llm_instance_gateway_tpu.server.lora_manager import LoRAManager as JLoRA
from llm_instance_gateway_tpu.training import train as jtrain

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch.models import lora as tlora  # noqa: E402
from llm_instance_gateway_tpu_torch.models.configs import (  # noqa: E402
    ModelConfig,
    TINY_TEST,
)
from llm_instance_gateway_tpu_torch.models.weights import (  # noqa: E402
    lora_from_numpy,
    params_from_numpy,
)
from llm_instance_gateway_tpu_torch.ops import flash_attention as fl  # noqa: E402
from llm_instance_gateway_tpu_torch.ops import quant as tquant  # noqa: E402
from llm_instance_gateway_tpu_torch.server import engine as teng  # noqa: E402
from llm_instance_gateway_tpu_torch.server.lora_manager import (  # noqa: E402
    LoRAManager as TLoRA,
    load_adapter_checkpoint,
)
from llm_instance_gateway_tpu_torch.training import train as ttrain  # noqa: E402

BWD_TOL = 2e-5
GRAD_TOL = 1e-4
LOSS_TOL = 1e-5
UPDATE_TOL = 1e-3
NOISE_FLOOR = 1e-3
LR = 1e-3


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def port_cfg(jax_cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jax_cfg))


def scaled_err(got, want) -> float:
    """Largest error over the largest |value|, or over 1 where that is
    smaller: a gradient that is zero in exact arithmetic (dq at S = 1,
    where delta cancels dP) comes out at rounding size."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1.0))


# ---------------------------------------------------------------------------
# flash attention backward
# ---------------------------------------------------------------------------


def attn_inputs(g: int, hd: int, s: int, seed: int = 0):
    """q [2, S, 8, hd], k/v [2, S, 8/G, hd], dout like q (numpy, f32)."""
    rng = np.random.default_rng(seed * 1000 + s * 10 + g + hd)
    h, kv = 8, 8 // g

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return (draw(2, s, h, hd), draw(2, s, kv, hd), draw(2, s, kv, hd),
            draw(2, s, h, hd))


BWD_CASES = [(g, hd, s) for g in (1, 4, 8) for hd in (16, 64, 128)
             for s in (1, 17, 127, 128, 129)]


@pytest.mark.parametrize("g,hd,s", BWD_CASES)
def test_flash_backward_matches_autograd_of_plain_forward(g, hd, s):
    """Through ``FlashAttention.apply`` (its CPU wiring: the plain forward,
    then ``flash_attention_backward_reference``) against autograd of
    ``flash_attention_reference``."""
    q, k, v, dout = (torch.from_numpy(a) for a in attn_inputs(g, hd, s))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fl.FlashAttention.apply(*leaves).backward(dout)
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(fl.flash_attention_reference(*ref), ref, dout)
    for name, t, w in zip("qkv", leaves, want):
        assert scaled_err(t.grad.numpy(), w.numpy()) < BWD_TOL, name


@pytest.mark.parametrize("g,hd,s", BWD_CASES)
def test_flash_backward_matches_jax_vjp(g, hd, s):
    """The plain backward against ``jax.vjp`` of the reference's
    ``prefill_attention`` (the function of the Pallas forward kernel)."""
    q, k, v, dout = attn_inputs(g, hd, s, seed=1)
    out, vjp = jax.vjp(jattn.prefill_attention, q, k, v)
    want = vjp(jnp.asarray(dout))
    tq, tk, tv, tdout = (torch.from_numpy(a) for a in (q, k, v, dout))
    tout = fl.flash_attention_reference(tq, tk, tv)
    assert scaled_err(tout.numpy(), np.asarray(out)) < BWD_TOL
    got = fl.flash_attention_backward(tq, tk, tv, tout, tdout)
    for name, gt, w in zip("qkv", got, want):
        assert scaled_err(gt.numpy(), np.asarray(w)) < BWD_TOL, name


def test_flash_attention_takes_the_function_only_under_grad():
    """Without grad (serving) the call stays off autograd; with grad on and
    an input that requires it, the output carries the Function's node."""
    q, k, v, _ = (torch.from_numpy(a) for a in attn_inputs(4, 16, 17))
    assert fl.flash_attention(q, k, v).grad_fn is None
    qg = q.clone().requires_grad_(True)
    out = fl.flash_attention(qg, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    with torch.no_grad():
        assert fl.flash_attention(qg, k, v).grad_fn is None


def test_raw_kernel_call_refuses_grad_inputs():
    """The raw forward launch would cut the graph (its output has no
    grad_fn), so it raises before it looks at the device."""
    q, k, v, _ = (torch.from_numpy(a) for a in attn_inputs(4, 16, 17))
    with pytest.raises(RuntimeError, match="requires grad"):
        fl.flash_prefill_kernel(q.requires_grad_(True), k, v)
    with torch.no_grad(), pytest.raises(ValueError, match="device"):
        fl.flash_prefill_kernel(q, k, v)  # grad off: on to the device check


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------


def padded_batch(lens=(12, 16, 7), s=16, seed=1, vocab=259):
    """Right-padded rows: token and position 0 past each row's length."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros((len(lens), s), np.int32)
    positions = np.zeros((len(lens), s), np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(1, vocab, n)
        positions[i, :n] = np.arange(n)
    return tokens, positions


def jax_params(jax_cfg, seed=0, biases=False):
    params = jtf.init_params(jax_cfg, jax.random.PRNGKey(seed), jnp.float32)
    if biases:  # Qwen's q/k/v biases, non-zero so their gradients matter
        rng = np.random.default_rng(seed + 100)
        layers = dict(params["layers"])
        for name in ("wq_b", "wk_b", "wv_b"):
            layers[name] = jnp.asarray(rng.standard_normal(
                layers[name].shape).astype(np.float32) * 0.1)
        params = {**params, "layers": layers}
    return params


def make_jax_lora(cfg, seed=0):
    """Slot 1 at rank 3 (a and b seeded), slot 2 at rank 2; r_max 4, so
    every slot has padded rank lanes."""
    rng = np.random.default_rng(seed)
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


def flat(tree, prefix=""):
    """path -> leaf of a nested dict (int8 {"q","s"} leaves included)."""
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = v
    return out


def port_value_and_grad(fn, tree):
    """(loss, path -> gradient) of ``fn(tree)`` over the tree's floating
    leaves, each made to require grad (zeros where the loss does not reach
    it, as jax.grad gives)."""
    leaves = {p: t for p, t in flat(tree).items() if t.is_floating_point()}
    for t in leaves.values():
        t.requires_grad_(True)
    loss = fn(tree)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    for t in leaves.values():
        t.requires_grad_(False)
    return loss.detach(), {
        p: (torch.zeros_like(t) if g is None else g).numpy()
        for (p, t), g in zip(leaves.items(), grads)}


def assert_grads_close(got: dict, want_tree, what: str) -> None:
    want = {p: np.asarray(v) for p, v in flat(want_tree).items()
            if np.issubdtype(np.asarray(v).dtype, np.floating)}
    assert set(got) == set(want), what
    for path, w in want.items():
        err = np.abs(got[path] - w).max()
        assert err <= GRAD_TOL * max(np.abs(w).max(), 1e-6), (what, path, err)


FULL_CONFIGS = {
    "llama": (JAX_TINY, False),
    "qwen": (JAX_TINY_QWEN, True),
    "gemma": (JAX_GEMMA_2B.tiny(), False),
    "mixtral": (JAX_TINY_MOE, False),
}


@pytest.mark.parametrize("family", sorted(FULL_CONFIGS))
def test_loss_and_full_gradients_match_reference(family):
    jax_cfg, biases = FULL_CONFIGS[family]
    cfg = port_cfg(jax_cfg)
    jparams = jax_params(jax_cfg, seed=3, biases=biases)
    tokens, positions = padded_batch(seed=5)
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jtrain.causal_lm_loss(jax_cfg, p, tokens, positions))(
            jparams)
    tparams = params_from_numpy(to_np(jparams), "cpu")
    loss, grads = port_value_and_grad(
        lambda p: ttrain.causal_lm_loss(cfg, p, torch.from_numpy(tokens),
                                        torch.from_numpy(positions)), tparams)
    assert abs(loss.item() - float(want_loss)) < LOSS_TOL
    assert_grads_close(grads, want_grads, family)


@pytest.mark.parametrize("base", ["f32", "int8"])
def test_loss_and_lora_gradients_match_reference(base):
    """Every LoRA leaf, ``scale`` included, over a frozen f32 base and over
    a frozen int8 base (``quantize_params`` on both sides)."""
    cfg = port_cfg(JAX_TINY)
    jparams = jax_params(JAX_TINY, seed=4)
    tparams = params_from_numpy(to_np(jparams), "cpu")
    if base == "int8":
        jparams, tparams = (jquant.quantize_params(jparams),
                            tquant.quantize_params(tparams))
    jbufs = make_jax_lora(JAX_TINY, seed=6)
    tokens, positions = padded_batch(seed=7)
    slots = np.array([1, -1, 2], np.int32)
    want_loss, want_grads = jax.value_and_grad(
        lambda b: jtrain.causal_lm_loss(JAX_TINY, jparams, tokens, positions,
                                        lora_bufs=b, slot_ids=slots))(jbufs)
    loss, grads = port_value_and_grad(
        lambda b: ttrain.causal_lm_loss(
            cfg, tparams, torch.from_numpy(tokens),
            torch.from_numpy(positions), lora_bufs=b,
            slot_ids=torch.from_numpy(slots)),
        lora_from_numpy(to_np(jbufs), "cpu"))
    assert abs(loss.item() - float(want_loss)) < LOSS_TOL
    assert_grads_close(grads, want_grads, base)


def test_loss_masks_padding_and_takes_logits_fn():
    """Pad targets add nothing: changing a pad token leaves the loss; an
    all-pad batch divides by 1, not 0; ``logits_fn`` replaces the forward."""
    cfg = port_cfg(JAX_TINY)
    tparams = params_from_numpy(to_np(jax_params(JAX_TINY, seed=8)), "cpu")
    tokens, positions = (torch.from_numpy(a) for a in padded_batch(seed=9))
    loss = ttrain.causal_lm_loss(cfg, tparams, tokens, positions)
    changed = tokens.clone()
    changed[2, 10] = 77  # row 2 has 7 real tokens
    assert ttrain.causal_lm_loss(cfg, tparams, changed, positions) == loss
    zero = ttrain.causal_lm_loss(cfg, tparams, tokens,
                                 torch.zeros_like(positions))
    assert zero.item() == 0.0
    calls = []

    def logits_fn(p, t, pos):
        calls.append(tuple(t.shape))
        return torch.zeros(t.shape + (cfg.padded_vocab,))

    uniform = ttrain.causal_lm_loss(cfg, tparams, tokens, positions,
                                    logits_fn=logits_fn)
    assert calls == [(3, 15)]
    assert abs(uniform.item() - np.log(cfg.padded_vocab)) < 1e-5


# ---------------------------------------------------------------------------
# two AdamW steps
# ---------------------------------------------------------------------------


class StepChecker:
    """Holds each side's update over lr to the other's where the
    reference's |grad| cleared the noise floor at every step so far (Adam's
    moments carry a noisy step on), and every update within the bound
    |u| + wd |p| <= 2 (Adam's |u| stays below ~1.4 over two steps)."""

    def __init__(self):
        self.sure: dict = {}

    def __call__(self, before: tuple, after: tuple, grads: dict,
                 what: str) -> None:
        (got0, want0), (got1, want1) = before, after
        for path, w1 in want1.items():
            g = np.abs(grads[path])
            sure = g > NOISE_FLOOR * max(g.max(), 1e-30)
            self.sure[path] = self.sure.get(path, sure) & sure
            du_got = (np.asarray(got1[path], np.float64) - got0[path]) / LR
            du_want = (np.asarray(w1, np.float64) - want0[path]) / LR
            err = np.abs(du_got - du_want)[self.sure[path]]
            assert err.size == 0 or err.max() < UPDATE_TOL, (what, path,
                                                             err.max())
            assert np.abs(du_got).max() <= 2.0, (what, path)


def _np_tree(tree) -> dict:
    return {p: (t.detach().numpy() if isinstance(t, torch.Tensor)
                else np.asarray(t)).astype(np.float64)
            for p, t in flat(tree).items()}


def test_two_full_adamw_steps_match_optax():
    cfg = port_cfg(JAX_TINY)
    jparams = jax_params(JAX_TINY, seed=10)
    tparams = params_from_numpy(to_np(jparams), "cpu")
    tokens, positions = padded_batch(seed=11)
    ttok, tpos = torch.from_numpy(tokens), torch.from_numpy(positions)
    jopt = optax.adamw(LR, weight_decay=0.01)
    jstate = jopt.init(jparams)
    jstep = jtrain.make_full_train_step(JAX_TINY, jopt)
    topt = ttrain.make_optimizer(tparams, lr=LR, weight_decay=0.01)
    tstep = ttrain.make_full_train_step(cfg, topt)
    check = StepChecker()
    for i in range(2):
        before = (_np_tree(tparams), _np_tree(jparams))
        jgrads = jax.grad(lambda p: jtrain.causal_lm_loss(
            JAX_TINY, p, tokens, positions))(jparams)
        _, tgrads = port_value_and_grad(
            lambda p: ttrain.causal_lm_loss(cfg, p, ttok, tpos), tparams)
        assert_grads_close(tgrads, jgrads, f"full step {i}")
        jparams, jstate, jloss = jstep(jparams, jstate, tokens, positions)
        tparams, topt_state, tloss = tstep(tparams, topt.state, ttok, tpos)
        assert abs(tloss.item() - float(jloss)) < LOSS_TOL
        check(before, (_np_tree(tparams), flat(jparams)),
              {p: np.asarray(g) for p, g in flat(jgrads).items()},
              f"full step {i}")
    assert topt_state is topt.state


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_two_lora_adamw_steps_match_optax(wd):
    """LoRA steps on slots 1 and 2 (base rows beside them): the update
    against optax's, ``scale`` untouched at wd 0 and decayed as optax decays
    it at wd 0.01, the padded rank lanes and the unused slots exactly zero."""
    cfg = port_cfg(JAX_TINY)
    jparams = jax_params(JAX_TINY, seed=12)
    tparams = params_from_numpy(to_np(jparams), "cpu")
    jbufs = make_jax_lora(JAX_TINY, seed=13)
    tbufs = lora_from_numpy(to_np(jbufs), "cpu")
    scale0 = tbufs["scale"].clone()
    tokens, positions = padded_batch(seed=14)
    slots = np.array([1, -1, 2], np.int32)
    ttok, tpos, tslots = (torch.from_numpy(a)
                          for a in (tokens, positions, slots))
    jopt = optax.adamw(LR, weight_decay=wd)
    jstate = jopt.init(jbufs)
    jstep = jtrain.make_lora_train_step(JAX_TINY, jopt)
    topt = ttrain.make_optimizer(tbufs, lr=LR, weight_decay=wd)
    tstep = ttrain.make_lora_train_step(cfg, topt)
    check = StepChecker()
    for i in range(2):
        before = (_np_tree(tbufs), _np_tree(jbufs))
        jgrads = jax.grad(lambda b: jtrain.causal_lm_loss(
            JAX_TINY, jparams, tokens, positions, lora_bufs=b,
            slot_ids=slots))(jbufs)
        jgrads = {**jgrads, "scale": jnp.zeros_like(jbufs["scale"])}
        _, tgrads = port_value_and_grad(
            lambda b: ttrain.causal_lm_loss(cfg, tparams, ttok, tpos,
                                            lora_bufs=b, slot_ids=tslots),
            tbufs)
        tgrads["scale"] = np.zeros_like(tgrads["scale"])
        assert_grads_close(tgrads, jgrads, f"lora step {i}")
        jbufs, jstate, jloss = jstep(jparams, jbufs, jstate, tokens,
                                     positions, slots)
        tbufs, _, tloss = tstep(tparams, tbufs, topt.state, ttok, tpos,
                                tslots)
        assert abs(tloss.item() - float(jloss)) < LOSS_TOL
        check(before, (_np_tree(tbufs), dict(jbufs)),
              {p: np.asarray(g) for p, g in jgrads.items()},
              f"lora step {i}")
    scale = tbufs["scale"].detach()
    want_scale = np.asarray(jbufs["scale"])
    if wd == 0.0:
        assert torch.equal(scale, scale0)
    else:
        # (1 - lr wd)^2 of the start, to the last bit or one ulp (torch
        # scales by 1 - lr wd, optax subtracts lr wd p: one rounding apart)
        assert not torch.equal(scale, scale0)
        np.testing.assert_allclose(scale.numpy(), want_scale, rtol=2.4e-7)
        np.testing.assert_allclose(
            scale.numpy(), scale0.numpy() * (1 - LR * wd) ** 2, rtol=5e-7)
    for t in tlora.TARGETS:
        a, b = tbufs[f"{t}_a"].detach(), tbufs[f"{t}_b"].detach()
        assert not a[:, 1, :, 3:].any() and not b[:, 1, 3:].any()  # rank 3
        assert not a[:, 2, :, 2:].any() and not b[:, 2, 2:].any()  # rank 2
        assert not a[:, 0].any() and not b[:, 3].any()  # never loaded
        assert not torch.equal(b[:, 1], torch.from_numpy(np.array(
            make_jax_lora(JAX_TINY, seed=13)[f"{t}_b"][:, 1])))


def test_optimizer_must_hold_the_tree():
    cfg = port_cfg(JAX_TINY)
    tbufs = lora_from_numpy(to_np(make_jax_lora(JAX_TINY)), "cpu")
    other = {k: v.clone() for k, v in tbufs.items()}
    step = ttrain.make_lora_train_step(cfg, ttrain.make_optimizer(other))
    tokens, positions = (torch.from_numpy(a) for a in padded_batch())
    with pytest.raises(ValueError, match="optimizer"):
        step({}, tbufs, None, tokens, positions, torch.tensor([1, 1, 1]))
    opt = ttrain.make_optimizer(tbufs, lr=0.5)
    group = opt.param_groups[0]
    assert (group["betas"], group["eps"], group["weight_decay"]) == (
        (0.9, 0.999), 1e-8, 0.0)


# ---------------------------------------------------------------------------
# export and serving of a trained adapter
# ---------------------------------------------------------------------------


def test_extract_adapter_matches_reference():
    jbufs = make_jax_lora(JAX_TINY, seed=15)
    tbufs = lora_from_numpy(to_np(jbufs), "cpu")
    for slot, rank in ((1, 3), (2, 2)):
        want = jtrain.extract_adapter(JAX_TINY, jbufs, slot, rank)
        got = ttrain.extract_adapter(port_cfg(JAX_TINY), tbufs, slot, rank)
        assert set(got) == set(want) == set(tlora.TARGETS)
        for t in want:
            for ab in ("a", "b"):
                np.testing.assert_array_equal(got[t][ab],
                                              np.asarray(want[t][ab]))


def test_trained_adapter_serves_as_the_jax_engine_does(tmp_path):
    """Three LoRA steps on slot 1 (a seeded, b zero) of a fresh buffer set,
    then ``save_trained_adapter``: the port's Engine, loading the .npz, and
    the JAX engine, given the same weights through the reference's
    ``models/lora.load_adapter``, give the same greedy tokens, and the
    adapter changes at least one answer of the base model."""
    cfg = TINY_TEST
    jparams = jax_params(JAX_TINY, seed=0)
    tparams = params_from_numpy(to_np(jparams), "cpu")
    rank, alpha = 3, 6.0
    bufs = tlora.init_lora_buffers(cfg, torch.float32, "cpu")
    rng = np.random.default_rng(16)
    tlora.write_adapter(bufs, cfg, 1, {
        t: {"a": rng.standard_normal((cfg.n_layers, di, rank)) * 0.3,
            "b": np.zeros((cfg.n_layers, rank, do))}
        for t, (di, do) in tlora.target_dims(cfg).items()}, alpha, rank)
    opt = ttrain.make_optimizer(bufs, lr=3e-2)
    step = ttrain.make_lora_train_step(cfg, opt)
    tokens, positions = (torch.from_numpy(a)
                         for a in padded_batch((16, 16), seed=17))
    losses = [step(tparams, bufs, opt.state, tokens, positions,
                   torch.tensor([1, 1]))[2].item() for _ in range(3)]
    assert losses[-1] < losses[0]
    path = str(tmp_path / "trained.npz")
    ttrain.save_trained_adapter(path, cfg, bufs, 1, rank, alpha)
    weights, got_alpha, got_rank = load_adapter_checkpoint(path)
    assert (got_alpha, got_rank) == (alpha, rank)

    engine_cfg = dict(decode_slots=2, max_seq_len=64,
                      prefill_buckets=(8, 16, 32), decode_steps_per_sync=4)
    jl = JLoRA(JAX_TINY, dtype=jnp.float32)
    jl.load("trained", weights=weights, alpha=alpha, rank=rank)
    tl = TLoRA(cfg, dtype=torch.float32, device="cpu")
    tl.load("trained", checkpoint_path=path)
    je = jeng.Engine(JAX_TINY, jparams, jeng.EngineConfig(**engine_cfg),
                     lora_manager=jl, eos_id=257, dtype=jnp.float32)
    te = teng.Engine(cfg, tparams, teng.EngineConfig(**engine_cfg),
                     lora_manager=tl, eos_id=257, dtype=torch.float32,
                     device="cpu")
    prompts = [(256, 5, 6, 7, 8), (256, 40, 41), (256, 100, 3, 99, 12, 13)]
    answers = {}
    for name, mod, eng in (("jax", jeng, je), ("port", teng, te)):
        eng.start()
        try:
            reqs = [mod.Request(prompt_tokens=list(p), max_new_tokens=10,
                                adapter=a)
                    for a in ("trained", None) for p in prompts]
            for r in reqs:
                eng.submit(r)
            for r in reqs:
                assert r.done.wait(120) and r.error is None
            answers[name] = [r.output_tokens for r in reqs]
        finally:
            eng.stop()
    assert answers["port"] == answers["jax"]
    trained, base = answers["port"][:3], answers["port"][3:]
    assert trained != base
