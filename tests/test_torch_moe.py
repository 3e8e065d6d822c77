"""The torch port's MoE MLP and expert contractions, held to the JAX
package on the CPU at f32 (a port of ``test_moe_grouped.py``).

Each case runs the reference's function and the port's on the same inputs
(seeded numpy, the reference's layer-0 Mixtral weights crossed by the
weight bridge) and holds them within ``TOL``:

- ``_moe_dense``, ``_moe_grouped`` and ``_moe_mlp`` on balanced routing,
  on forced overflow (every token to experts 0 and 1) with the exact
  fallback — selected on the device and read on the host — and in drop
  mode, where grouped must differ from dense;
- the dense/grouped gate at t = 1, 2, 8 and 16 in both modes, with the
  path not taken poisoned, and ``_moe_capacity`` over a sweep of t;
- the grouped path's matmul FLOPs below dense (``FlopCounterMode``, the
  counterpart of the reference's compiled cost analysis);
- ``expert_matmul`` / ``expert_mix`` / ``expert_mix_down``, dense and
  int8, and ``quantize_params`` on [L, E, in, out] stacks;
- top-k ties: a router with tied columns picks what ``jax.lax.top_k``
  picks (the lower index first).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_instance_gateway_tpu.models import transformer as jtf
from llm_instance_gateway_tpu.models.configs import TINY_MOE_TEST as JCFG
from llm_instance_gateway_tpu.ops import quant as jquant

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from llm_instance_gateway_tpu_torch.models import transformer as ttf  # noqa: E402
from llm_instance_gateway_tpu_torch.models.configs import ModelConfig  # noqa: E402
from llm_instance_gateway_tpu_torch.models.weights import params_from_numpy  # noqa: E402
from llm_instance_gateway_tpu_torch.ops import quant as tquant  # noqa: E402

TOL = 2e-5
CFG = ModelConfig(**dataclasses.asdict(JCFG))
KEYS = ("router", "w_gate", "w_up", "w_down")


def both(jcfg, **changes):
    """(reference config, port config) with the same changes."""
    return (dataclasses.replace(jcfg, **changes),
            dataclasses.replace(CFG, **changes))


@pytest.fixture(scope="module")
def layer():
    """Layer 0 of the reference's Mixtral-tiny weights, both packages."""
    params = jtf.init_params(JCFG, jax.random.PRNGKey(3), jnp.float32)
    jlp = {k: params["layers"][k][0] for k in KEYS}
    return jlp, params_from_numpy(jax.tree.map(np.asarray, jlp), "cpu")


def skewed(layer):
    """The router biased so EVERY token picks experts 0 and 1."""
    jlp, tlp = layer
    bias = np.zeros((CFG.d_model, CFG.n_experts), np.float32)
    bias[:, 0] = 0.5
    bias[:, 1] = 0.4
    return (dict(jlp, router=jnp.asarray(bias)),
            dict(tlp, router=torch.from_numpy(bias)))


def inputs(t, seed=0):
    x = np.random.default_rng(seed).standard_normal(
        (t, CFG.d_model)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def run(fn, jcfg, tcfg, layer, x, **kw):
    """(reference result, port result) as numpy."""
    jlp, tlp = layer
    jx, tx = x
    want = np.asarray(getattr(jtf, fn)(jcfg, jlp, jx))
    got = getattr(ttf, fn)(tcfg, tlp, tx, **kw).numpy()
    return want, got


class TestGroupedDispatch:
    @pytest.mark.parametrize("fn", ["_moe_dense", "_moe_grouped", "_moe_mlp"])
    def test_balanced_routing_matches_reference(self, layer, fn):
        want, got = run(fn, JCFG, CFG, layer, inputs(64))
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)

    def test_grouped_matches_dense_balanced(self, layer):
        x = inputs(64)[1]
        dense = ttf._moe_dense(CFG, layer[1], x)
        grouped = ttf._moe_grouped(CFG, layer[1], x)
        np.testing.assert_allclose(grouped.numpy(), dense.numpy(),
                                   rtol=TOL, atol=TOL)

    @pytest.mark.parametrize("host_flag", [False, True],
                             ids=["device-select", "host-read"])
    def test_overflow_falls_back_exactly(self, layer, host_flag):
        """Every token to experts (0, 1): capacity overflows and the
        fallback gives the dense result — bitwise the port's own dense,
        and the reference's within TOL."""
        lp = skewed(layer)
        x = inputs(64, seed=1)
        want, got = run("_moe_grouped", JCFG, CFG, lp, x,
                        host_flag=host_flag)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        dense = ttf._moe_dense(CFG, lp[1], x[1]).numpy()
        np.testing.assert_array_equal(got, dense)

    def test_no_fallback_drops_overflow_tokens(self, layer):
        """Drop mode: overflowed assignments contribute zero — the port
        equals the reference's dropping result and differs from dense."""
        jcfg, tcfg = both(JCFG, moe_exact_fallback=False)
        lp = skewed(layer)
        x = inputs(64, seed=1)
        want, got = run("_moe_grouped", jcfg, tcfg, lp, x)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        dense = ttf._moe_dense(tcfg, lp[1], x[1]).numpy()
        assert not np.allclose(got, dense)

    def test_prefill_uses_grouped_and_matches_dense_capacity(self, layer):
        """Prefill logits (grouped at T=64) equal a prefill whose capacity
        factor makes every tile hold every token (the dense path), and the
        reference's."""
        params = jtf.init_params(JCFG, jax.random.PRNGKey(3), jnp.float32)
        tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
        tokens = np.random.RandomState(0).randint(1, 250, size=(2, 32))
        positions = np.broadcast_to(np.arange(32), (2, 32))
        tt = torch.from_numpy(tokens.astype(np.int32))
        tpos = torch.from_numpy(positions.astype(np.int32).copy())
        logits, _, _ = ttf.prefill(CFG, tparams, tt, tpos)
        dense_cfg = dataclasses.replace(
            CFG, moe_capacity_factor=float(CFG.n_experts))
        logits_dense, _, _ = ttf.prefill(dense_cfg, tparams, tt, tpos)
        np.testing.assert_allclose(logits.numpy(), logits_dense.numpy(),
                                   rtol=2e-4, atol=2e-4)
        want, _, _ = jtf.prefill(JCFG, params, jnp.asarray(tokens),
                                 jnp.asarray(positions))
        np.testing.assert_allclose(logits.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)

    def test_grouped_flops_below_dense(self, layer):
        """Drop mode at cf 1.25, T=256: the expert products' FLOPs fall ~3x
        below dense (the fallback off, so dense is not counted in)."""
        cfg = dataclasses.replace(CFG, moe_exact_fallback=False)
        x = inputs(256)[1]

        def flops(fn):
            with FlopCounterMode(display=False) as counter:
                fn(cfg, layer[1], x)
            return counter.get_total_flops()

        dense, grouped = flops(ttf._moe_dense), flops(ttf._moe_grouped)
        assert grouped < 0.75 * dense, (grouped, dense)


class TestDecodeGate:
    def test_batched_decode_flops_near_dropless_ideal(self, layer):
        """16 slots in drop mode route grouped at <= ~1.3x the dropless
        ideal t*k expert-rows, not dense's E/k = 4x."""
        cfg = dataclasses.replace(CFG, moe_exact_fallback=False)
        t, d, f, k = 16, CFG.d_model, CFG.d_ff, CFG.n_experts_per_token
        with FlopCounterMode(display=False) as counter:
            ttf._moe_mlp(cfg, layer[1], inputs(t)[1])
        ideal_mlp = 6.0 * d * f * t * k
        overhead = 4.0 * t * d * CFG.n_experts + 16.0 * t * k * d
        assert counter.get_total_flops() <= 1.3 * ideal_mlp + overhead

    def test_exact_mode_keeps_headroom_at_decode_size(self):
        drop = dataclasses.replace(CFG, moe_exact_fallback=False)
        t, e, k = 16, CFG.n_experts, CFG.n_experts_per_token
        assert ttf._moe_capacity(drop, t) == -(-t * k * 125 // (e * 100))
        assert ttf._moe_capacity(CFG, t) == -(-t * k * 2 // e)
        assert ttf._moe_capacity(CFG, t) < t

    @pytest.mark.parametrize("t", [1, 2, 8, 16])
    @pytest.mark.parametrize("exact", [True, False], ids=["exact", "drop"])
    def test_gate_takes_the_reference_path(self, layer, monkeypatch, t,
                                           exact):
        """The path the reference's gate picks for t tokens, and the
        reference's result: exact mode stays dense through t=8 (cap < 8)
        and goes grouped at 16; drop mode is dense only where cap >= t
        (t=1).  On the dense path grouped is poisoned; on the grouped path
        it must run, and in drop mode dense is poisoned (exact mode's
        device-side fallback computes dense beside it)."""
        jcfg, tcfg = both(JCFG, moe_exact_fallback=exact)
        cap = ttf._moe_capacity(tcfg, t)
        dense_path = cap >= t or (exact and cap < 8)
        assert dense_path == (t < 16 if exact else t == 1)

        def boom(*a, **k):
            raise AssertionError("wrong MoE path taken")

        grouped = []
        real = ttf._moe_grouped

        def counted(*a, **k):
            grouped.append(t)
            return real(*a, **k)

        monkeypatch.setattr(ttf, "_moe_grouped",
                            boom if dense_path else counted)
        if not (dense_path or exact):
            monkeypatch.setattr(ttf, "_moe_dense", boom)
        want, got = run("_moe_mlp", jcfg, tcfg, layer, inputs(t, seed=t))
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        assert grouped == ([] if dense_path else [t])

    @pytest.mark.parametrize("exact", [True, False], ids=["exact", "drop"])
    def test_capacity_integers_match_reference(self, exact):
        jcfg, tcfg = both(JCFG, moe_exact_fallback=exact)
        for t in [*range(1, 70), 100, 128, 255, 256, 1000, 1024, 4096]:
            assert ttf._moe_capacity(tcfg, t) == jtf._moe_capacity(jcfg, t), t


class TestExpertProducts:
    @pytest.mark.parametrize("quantized", [False, True], ids=["dense", "int8"])
    @pytest.mark.parametrize("fn,xshape,wshape", [
        ("expert_matmul", (8, 5, 64), (8, 64, 128)),
        ("expert_mix", (3, 4, 64), (8, 64, 128)),
        ("expert_mix_down", (6, 8, 128), (8, 128, 64))])
    def test_matches_reference(self, fn, xshape, wshape, quantized):
        rng = np.random.default_rng(len(fn))
        x = rng.standard_normal(xshape).astype(np.float32)
        w = rng.standard_normal(wshape).astype(np.float32) * 0.1
        jw = jquant.quantize_weight(jnp.asarray(w)) if quantized \
            else jnp.asarray(w)
        tw = params_from_numpy(jax.tree.map(np.asarray, jw), "cpu")
        want = np.asarray(getattr(jquant, fn)(jnp.asarray(x), jw))
        got = getattr(tquant, fn)(torch.from_numpy(x), tw)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)

    def test_quantize_params_on_expert_stacks(self):
        """[L, E, in, out] leaves quantize one layer at a time to the
        reference's ``quantize_weight`` of the whole stack (scales per
        expert and output channel); the router stays dense."""
        params = jtf.init_params(JCFG, jax.random.PRNGKey(5), jnp.float32)
        tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
        got = tquant.quantize_params(tparams)["layers"]
        for name in ("w_gate", "w_up", "w_down"):
            want = jquant.quantize_weight(params["layers"][name])
            assert got[name]["s"].shape == want["s"].shape
            np.testing.assert_array_equal(got[name]["q"].numpy(),
                                          np.asarray(want["q"]))
            np.testing.assert_allclose(got[name]["s"].numpy(),
                                       np.asarray(want["s"]), rtol=1e-7)
        assert not tquant.is_quantized(got["router"])
        # The reference's int8 tree crosses the weight bridge as is: its
        # 4-D {"q", "s"} leaves and the dense router.
        crossed = params_from_numpy(jax.tree.map(
            np.asarray, jquant.quantize_params(params)), "cpu")["layers"]
        assert torch.equal(crossed["w_up"]["q"], got["w_up"]["q"])
        assert crossed["w_up"]["s"].dtype == torch.float32
        assert torch.equal(crossed["router"], tparams["layers"]["router"])

    def test_int8_moe_mlp_matches_reference(self, layer):
        jlp, _ = layer
        jq = {k: (jquant.quantize_weight(v) if k != "router" else v)
              for k, v in jlp.items()}
        tq = params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")
        for t in (8, 64):
            want, got = run("_moe_mlp", JCFG, CFG, (jq, tq), inputs(t))
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_ties_pick_the_lower_index(layer, k):
    """A router whose columns 1, 3, 5 (and 6, 7) are equal: every token's
    logits tie, and the port picks the experts ``jax.lax.top_k`` picks."""
    router = np.zeros((CFG.d_model, CFG.n_experts), np.float32)
    router[:, [1, 3, 5]] = 0.3
    router[:, [6, 7]] = -0.2
    x = np.abs(inputs(16)[0])
    logits = np.asarray(x) @ router
    want = np.asarray(jax.lax.top_k(jnp.asarray(logits), k)[1])
    got = ttf._top_k(torch.from_numpy(logits), k)[1].numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] == 1).all()
    jlp, tlp = layer
    cfg_j, cfg_t = both(JCFG, n_experts_per_token=k)
    lp = (dict(jlp, router=jnp.asarray(router)),
          dict(tlp, router=torch.from_numpy(router)))
    x = (jnp.asarray(x), torch.from_numpy(np.asarray(x)))
    for fn in ("_moe_dense", "_moe_grouped"):
        want, got = run(fn, cfg_j, cfg_t, lp, x)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
