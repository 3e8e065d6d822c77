"""Parity of the torch port's transformer with the JAX reference, on the CPU.

The reference's parameters and LoRA buffers cross through
``models/weights.py``; prefill logits and decode-step logits must agree at
f32 within ``ATOL``, with base and adapter rows in one batch and an
inactive row whose cache lane must stay untouched.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

from llm_instance_gateway_tpu.models import lora as jlora
from llm_instance_gateway_tpu.models import transformer as jtf
from llm_instance_gateway_tpu.models.configs import (
    GEMMA_2B,
    LLAMA2_7B,
    TINY_MOE_TEST,
    TINY_QWEN_TEST,
    TINY_TEST as JAX_TINY,
)

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch.models import transformer as ttf  # noqa: E402
from llm_instance_gateway_tpu_torch.models.configs import (  # noqa: E402
    TINY_TEST,
    ModelConfig,
)
from llm_instance_gateway_tpu_torch.models.weights import (  # noqa: E402
    lora_from_numpy,
    params_from_numpy,
    tensor_from_numpy,
)

ATOL = 1e-4  # f32 logits through 2 layers: summation order only


def port_cfg(jax_cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jax_cfg))


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def make_lora(cfg, seed=0):
    rng = np.random.default_rng(seed)
    bufs = jlora.init_lora_buffers(cfg, jnp.float32)
    for slot, rank in ((0, 2), (2, 4)):
        adapter = {tg: {"a": rng.standard_normal((cfg.n_layers, di, rank)
                                                 ).astype(np.float32) * 0.3,
                        "b": rng.standard_normal((cfg.n_layers, rank, do)
                                                 ).astype(np.float32) * 0.3}
                   for tg, (di, do) in jlora.target_dims(cfg).items()}
        bufs = jlora.load_adapter(bufs, cfg, slot, adapter, alpha=8.0,
                                  rank=rank)
    return bufs


@pytest.fixture(scope="module")
def tiny():
    jparams = jtf.init_params(JAX_TINY, jax.random.PRNGKey(0), jnp.float32)
    jbufs = make_lora(JAX_TINY)
    tparams = params_from_numpy(to_np(jparams), "cpu")
    tbufs = lora_from_numpy(to_np(jbufs), "cpu")
    return jparams, jbufs, tparams, tbufs


def batch_inputs(lens=(9, 16, 5), s=16, seed=1):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((len(lens), s), np.int32)
    positions = np.zeros((len(lens), s), np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(0, 259, n)
        positions[i, :n] = np.arange(n)
    return tokens, positions, np.array(lens, np.int32)


class TestPrefillDecodeParity:
    def test_prefill_logits_and_kv(self, tiny):
        jparams, jbufs, tparams, tbufs = tiny
        tokens, positions, _ = batch_inputs()
        slots = np.array([-1, 0, 2], np.int32)
        jl, jk, jv = jtf.prefill(JAX_TINY, jparams, jnp.asarray(tokens),
                                 jnp.asarray(positions), lora_bufs=jbufs,
                                 slot_ids=jnp.asarray(slots))
        tl, tk, tv = ttf.prefill(TINY_TEST, tparams, torch.from_numpy(tokens),
                                 torch.from_numpy(positions), lora_bufs=tbufs,
                                 slot_ids=torch.from_numpy(slots))
        assert tl.shape == (3, 16, TINY_TEST.padded_vocab)
        assert tk.shape == jk.shape
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)

    def test_four_decode_steps_mixed_rows_inactive_lane(self, tiny):
        """Base + two adapter rows and one INACTIVE row: logits agree every
        step, the caches agree, and the inactive row's lane never changes
        (the reference drops its writes at index s_max; the port masks)."""
        jparams, jbufs, tparams, tbufs = tiny
        tokens, positions, lens = batch_inputs(lens=(9, 14, 5, 11), seed=2)
        slots = np.array([-1, 0, 2, 0], np.int32)
        active = np.array([True, True, False, True])
        s_max = 32
        jl, jk, jv = jtf.prefill(JAX_TINY, jparams, jnp.asarray(tokens),
                                 jnp.asarray(positions), lora_bufs=jbufs,
                                 slot_ids=jnp.asarray(slots))
        jcache = jtf.init_decode_cache(JAX_TINY, 4, s_max, jnp.float32)
        tcache = ttf.init_decode_cache(TINY_TEST, 4, s_max, torch.float32,
                                       "cpu")
        for i, n in enumerate(lens):
            jcache = jtf.insert_prefill(jcache, jk[:, i:i + 1], jv[:, i:i + 1],
                                        i, int(n))
            tcache = ttf.insert_prefill(tcache, params_from_numpy(
                np.asarray(jk[:, i:i + 1]), "cpu"), params_from_numpy(
                np.asarray(jv[:, i:i + 1]), "cpu"), i, int(n))
        np.testing.assert_array_equal(tcache["k"].numpy(),
                                      np.asarray(jcache["k"]))
        lane_before = tcache["k"][:, 2].clone(), tcache["v"][:, 2].clone()
        cur = np.array(jnp.argmax(jl[jnp.arange(4), lens - 1], -1),
                         np.int32)
        pos = lens.copy()
        for step in range(4):
            jlog, jcache = jtf.decode_step(
                JAX_TINY, jparams, jcache, jnp.asarray(cur), jnp.asarray(pos),
                lora_bufs=jbufs, slot_ids=jnp.asarray(slots),
                active=jnp.asarray(active))
            tlog, tcache = ttf.decode_step(
                TINY_TEST, tparams, tcache, torch.from_numpy(cur),
                torch.from_numpy(pos), lora_bufs=tbufs,
                slot_ids=torch.from_numpy(slots),
                active=torch.from_numpy(active))
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                       atol=ATOL, err_msg=f"step {step}")
            np.testing.assert_array_equal(tcache["length"].numpy(),
                                          np.asarray(jcache["length"]))
            cur = np.array(jnp.argmax(jlog, -1), np.int32)
            pos = pos + active
        np.testing.assert_allclose(tcache["k"].numpy(),
                                   np.asarray(jcache["k"]), atol=ATOL)
        np.testing.assert_allclose(tcache["v"].numpy(),
                                   np.asarray(jcache["v"]), atol=ATOL)
        assert torch.equal(tcache["k"][:, 2], lane_before[0])
        assert torch.equal(tcache["v"][:, 2], lane_before[1])

    def test_write_past_lane_end_is_dropped(self, tiny):
        """A position at S_max writes nothing (XLA drops OOB scatters)."""
        _, _, tparams, _ = tiny
        cache = ttf.init_decode_cache(TINY_TEST, 2, 8, torch.float32, "cpu")
        _, cache = ttf.decode_step(TINY_TEST, tparams, cache,
                                   torch.tensor([3, 4]), torch.tensor([8, 2]))
        assert not cache["k"][:, 0].any()
        assert cache["k"][:, 1, 2].any()


def test_gemma_style_flags_prefill_parity():
    """Tied embeddings, sqrt(d) embedding scale, (1+w) norm and GeLU."""
    jcfg = dataclasses.replace(GEMMA_2B.tiny(), n_kv_heads=1)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(3), jnp.float32)
    tokens, positions, _ = batch_inputs(lens=(7, 12), s=12, seed=4)
    jl, _, _ = jtf.prefill(jcfg, jparams, jnp.asarray(tokens),
                           jnp.asarray(positions))
    tl, _, _ = ttf.prefill(port_cfg(jcfg), params_from_numpy(
        to_np(jparams), "cpu"), torch.from_numpy(tokens),
        torch.from_numpy(positions))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


FAMILIES = {"llama3-tiny": JAX_TINY, "llama2-tiny": LLAMA2_7B.tiny(),
            "gemma-tiny": GEMMA_2B.tiny(), "mixtral-tiny": TINY_MOE_TEST,
            "qwen-tiny": TINY_QWEN_TEST}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_init_params_tree_matches_reference(family):
    """The tree's keys, shapes and dtypes equal the reference's for every
    family: Qwen's ``wq_b``/``wk_b``/``wv_b``, Mixtral's ``router`` and 4-D
    expert stacks, Gemma's tied embeddings (no ``lm_head``)."""
    jcfg = FAMILIES[family]
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
    tcfg = port_cfg(jcfg)
    tparams = ttf.init_params(tcfg, seed=0, dtype=torch.bfloat16,
                              device="cpu")
    jflat = {jax.tree_util.keystr(p): v for p, v in
             jax.tree_util.tree_leaves_with_path(jparams)}
    tflat = {jax.tree_util.keystr(p): v for p, v in
             jax.tree_util.tree_leaves_with_path(tparams)}
    assert set(jflat) == set(tflat)
    for key, leaf in jflat.items():
        assert tuple(tflat[key].shape) == leaf.shape, key
        assert tflat[key].dtype == torch.bfloat16
    # Same distributions: unit norms, ~N(0, 1/fan_in) projections.
    assert torch.all(tparams["layers"]["attn_norm"] == 1)
    wq = tparams["layers"]["wq"].float()
    assert abs(wq.std().item() - 1 / np.sqrt(tcfg.d_model)) < 0.02
    if tcfg.attention_bias:
        assert not tparams["layers"]["wq_b"].any()  # zero, as the reference
    if tcfg.n_experts:
        assert tparams["layers"]["w_down"].dim() == 4
        w_down = tparams["layers"]["w_down"].float()
        assert abs(w_down.std().item() - 1 / np.sqrt(tcfg.d_ff)) < 0.02


def test_init_params_is_seeded():
    a = ttf.init_params(TINY_TEST, seed=5, dtype=torch.float32, device="cpu")
    b = ttf.init_params(TINY_TEST, seed=5, dtype=torch.float32, device="cpu")
    c = ttf.init_params(TINY_TEST, seed=6, dtype=torch.float32, device="cpu")
    assert torch.equal(a["layers"]["w_up"], b["layers"]["w_up"])
    assert not torch.equal(a["layers"]["w_up"], c["layers"]["w_up"])


def test_bf16_leaves_cross_bit_exact():
    arr = np.array([1.0, -2.5, 3.1415926, 1e-3], np.float32).astype(
        ml_dtypes.bfloat16)
    got = tensor_from_numpy(arr, "cpu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  arr.view(np.int16))


def test_int8_decode_cache_has_the_reference_layout():
    cache = ttf.init_decode_cache(TINY_TEST, 2, 16, device="cpu",
                                  quantized=True)
    want = jtf.init_decode_cache(JAX_TINY, 2, 16, quantized=True)
    assert set(cache) == set(want)
    for name, leaf in want.items():
        assert tuple(cache[name].shape) == leaf.shape, name
        assert str(cache[name].dtype).split(".")[-1] == str(leaf.dtype), name
