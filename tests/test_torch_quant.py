"""The torch port's int8 path against the JAX reference, on the CPU: int8
KV caches (lanes and the paged pool) and int8 weights (``ops/quant.py``).

Inputs are made with numpy from a seed and go through both packages.
Tolerances, stated per test:
- quantizers (``_kv_quantize``, ``quantize_weight``, ``quantize_params``):
  bit-identical int8 values and scales on identical f32 inputs, exact .5
  ties included (both round half to even);
- ``quant.matmul``: 1e-6 at f32;
- the int8 kernels' plain versions against the Pallas kernels in interpret
  mode: 2e-5 at f32 (as ``tests/test_pallas_decode.py``), and at bf16 one
  bf16 ulp (2^-7) of each output vector's largest value;
- through the 2-layer model at f32: int8 caches may differ by one step
  where the f32 K/V the two packages compute differ in their last bits (at
  most 1% of the cells, counted); scales 1e-5 relative (the max |x| / 127
  of f32 values that differ in their last bits); logits 1e-4 while the two
  int8 caches are identical, and 1e-2 once a cell has flipped (one step
  moves that key or value by its scale, ~1% of the vector's largest
  entry);
- greedy token streams through both engines: identical.
"""

import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

from llm_instance_gateway_tpu.models import lora as jlora
from llm_instance_gateway_tpu.models import paged as jpaged
from llm_instance_gateway_tpu.models import transformer as jtf
from llm_instance_gateway_tpu.models.configs import TINY_TEST as JAX_TINY
from llm_instance_gateway_tpu.ops import quant as jquant
from llm_instance_gateway_tpu.ops.pallas_decode_attention import (
    decode_attention_quant_pallas,
    paged_decode_attention_pallas,
)
from llm_instance_gateway_tpu.server import engine as jeng
from llm_instance_gateway_tpu.server.lora_manager import LoRAManager as JLoRA

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch.models import paged as tpaged  # noqa: E402
from llm_instance_gateway_tpu_torch.models import transformer as ttf  # noqa: E402
from llm_instance_gateway_tpu_torch.models.configs import TINY_TEST  # noqa: E402
from llm_instance_gateway_tpu_torch.models.weights import (  # noqa: E402
    lora_from_numpy,
    params_from_numpy,
)
from llm_instance_gateway_tpu_torch.ops import decode_attention as tdec  # noqa: E402
from llm_instance_gateway_tpu_torch.ops import (  # noqa: E402
    paged_decode_attention as tpd,
)
from llm_instance_gateway_tpu_torch.ops import quant as tquant  # noqa: E402
from llm_instance_gateway_tpu_torch.server import api_http  # noqa: E402
from llm_instance_gateway_tpu_torch.server import engine as teng  # noqa: E402
from llm_instance_gateway_tpu_torch.server.lora_manager import (  # noqa: E402
    LoRAManager as TLoRA,
)

F32_ATOL = 2e-5
LOGITS_ATOL = 1e-4
FLIPPED_LOGITS_ATOL = 1e-2
BF16_ULP = 2.0 ** -7
P = 8  # block size of the model-level paged tests


def t(a):
    return torch.from_numpy(np.array(a))


def rnd(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def with_ties(rng, *shape):
    """Vectors whose max |x| is 127, so the scale is exactly 1.0 and the
    half-integer entries are exact .5 ties for the rounding."""
    x = np.round(rnd(rng, *shape) * 40) + rng.choice([0.0, 0.5], shape)
    x = np.clip(x, -126.5, 126.5).astype(np.float32)
    x[..., 0] = 127.0
    return x


# ---------------------------------------------------------------------------
# quantizers and the int8 matmul
# ---------------------------------------------------------------------------


class TestQuantizers:
    @pytest.mark.parametrize("kind", ["ties", "normal", "zeros"])
    def test_kv_quantize_is_bit_identical(self, kind):
        rng = np.random.default_rng(0)
        x = {"ties": with_ties(rng, 3, 5, 2, 16),
             "normal": rnd(rng, 3, 5, 2, 16) * 3,
             "zeros": np.zeros((3, 5, 2, 16), np.float32)}[kind]
        jq, js = jtf._kv_quantize(jnp.asarray(x))
        tq, ts = ttf._kv_quantize(t(x))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        if kind == "ties":  # the ties really are ties, rounded to even
            halves = np.abs(x - np.trunc(x)) == 0.5
            assert halves.sum() > 50
            assert not (tq.numpy()[halves] % 2).any()

    def test_kv_dequantize_matches(self):
        rng = np.random.default_rng(1)
        q = rng.integers(-127, 128, (4, 3, 16)).astype(np.int8)
        s = np.abs(rnd(rng, 4, 3)) + 1e-3
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            want = np.asarray(jtf._kv_dequantize(jnp.asarray(q),
                                                 jnp.asarray(s), jdt),
                              np.float32)
            got = ttf._kv_dequantize(t(q), t(s), tdt).float().numpy()
            np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("kind", ["ties", "normal"])
    def test_quantize_weight_is_bit_identical(self, kind):
        rng = np.random.default_rng(2)
        w = (with_ties(rng, 2, 24, 16).transpose(0, 2, 1).copy()
             if kind == "ties" else rnd(rng, 2, 16, 24) * 0.1)
        want = jquant.quantize_weight(jnp.asarray(w))
        got = tquant.quantize_weight(t(w))
        assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
        np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
        np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))

    def test_quantize_params_layerwise_matches_and_keeps_the_caller_tree(self):
        jparams = jtf.init_params(JAX_TINY, jax.random.PRNGKey(0), jnp.float32)
        np_tree = jax.tree.map(np.asarray, jparams)
        tparams = params_from_numpy(np_tree, "cpu")
        before = {k: v.clone() for k, v in tparams["layers"].items()}
        want = jax.tree.map(np.asarray, jquant.quantize_params(jparams))
        got = tquant.quantize_params(tparams)
        for name in tquant.QUANT_TARGETS + ("lm_head",):
            g = got[name] if name == "lm_head" else got["layers"][name]
            w = want[name] if name == "lm_head" else want["layers"][name]
            assert tquant.is_quantized(g)
            assert g["s"].dtype == torch.float32
            np.testing.assert_array_equal(g["q"].numpy(), w["q"])
            np.testing.assert_array_equal(g["s"].numpy(), w["s"])
        for k, v in before.items():  # the caller's tree is untouched
            assert torch.equal(tparams["layers"][k], v)
        assert got["embed"] is tparams["embed"]
        assert tquant.quantized_bytes(got) == jquant.quantized_bytes(
            jquant.quantize_params(jparams))

    def test_bridge_keeps_scales_f32(self):
        jparams = jtf.init_params(JAX_TINY, jax.random.PRNGKey(1), jnp.float32)
        np_tree = jax.tree.map(np.asarray, jquant.quantize_params(jparams))
        got = params_from_numpy(np_tree, "cpu", dtype=torch.bfloat16)
        wq = got["layers"]["wq"]
        assert wq["q"].dtype == torch.int8 and wq["s"].dtype == torch.float32
        np.testing.assert_array_equal(wq["s"].numpy(),
                                      np_tree["layers"]["wq"]["s"])
        assert got["embed"].dtype == torch.bfloat16
        assert got["lm_head"]["s"].dtype == torch.float32

    @pytest.mark.parametrize("shape", [(5, 16), (2, 3, 16)])
    def test_matmul_matches(self, shape):
        rng = np.random.default_rng(3)
        x = rnd(rng, *shape)
        w = rnd(rng, 16, 24) * 0.2
        jw = jquant.quantize_weight(jnp.asarray(w))
        tw = tquant.quantize_weight(t(w))
        want = np.asarray(jquant.matmul(jnp.asarray(x), jw))
        got = tquant.matmul(t(x), tw)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
        np.testing.assert_array_equal(  # dense leaves: a plain product
            tquant.matmul(t(x), t(w)).numpy(), (t(x) @ t(w)).numpy())


# ---------------------------------------------------------------------------
# the int8 kernels' plain versions against the Pallas kernels (interpret)
# ---------------------------------------------------------------------------


def quant_lanes(seed, b=5, s_max=256, h=8, k=2, hd=128):
    rng = np.random.default_rng(seed)
    q = rnd(rng, b, h, hd)
    kq, ks = jtf._kv_quantize(jnp.asarray(rnd(rng, b, s_max, k, hd)))
    vq, vs = jtf._kv_quantize(jnp.asarray(rnd(rng, b, s_max, k, hd)))
    lengths = np.array([0, 1, 77, 200, 256], np.int32)[:b]
    return q, *map(np.asarray, (kq, vq, ks, vs)), lengths


def quant_pool(seed, page, b=5, m=4, h=8, k=2, hd=128):
    rng = np.random.default_rng(seed)
    n_blocks = b * m
    q = rnd(rng, b, h, hd)
    kq, ks = jtf._kv_quantize(jnp.asarray(rnd(rng, n_blocks + 1, page, k, hd)))
    vq, vs = jtf._kv_quantize(jnp.asarray(rnd(rng, n_blocks + 1, page, k, hd)))
    tables = (rng.permutation(n_blocks) + 1).reshape(b, m).astype(np.int32)
    tables[1, 1:] = 0  # a short row: the trash block past its end
    lengths = np.array([0, 1, page + page // 2, m * page, 2 * page - 3],
                       np.int32)[:b]
    return q, *map(np.asarray, (kq, vq, ks, vs)), tables, lengths


def assert_within_dtype(got, want, dtype):
    """f32: within F32_ATOL.  bf16: each output vector within one bf16 ulp
    of its largest value."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_ATOL)
        return
    err = np.abs(got - want).max(-1)
    assert (err <= BF16_ULP * np.abs(want).max(-1) + 1e-30).all(), err.max()


def as_dtype(q, dtype):
    """q as the numpy array JAX takes and the tensor the port takes, both
    in ``dtype`` (bf16 bits cross exactly)."""
    if dtype == "float32":
        return q, t(q)
    qb = np.asarray(q, np.float32).astype(ml_dtypes.bfloat16)
    return qb, t(qb.view(np.uint16)).view(torch.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
class TestQuantKernelPlainVersions:
    def test_lane_decode_matches_pallas_interpret(self, dtype):
        """G=4, hd=128, ragged lengths 0 / 1 / 77 / 200 / 256."""
        q, kq, vq, ks, vs, lengths = quant_lanes(seed=4)
        q, tq = as_dtype(q, dtype)
        want = decode_attention_quant_pallas(
            *map(jnp.asarray, (q, kq, vq, ks, vs, lengths)), interpret=True)
        got = tdec.decode_attention_quant_reference(
            tq, *map(t, (kq, vq, ks, vs, lengths)))
        assert got.dtype == getattr(torch, dtype)
        assert_within_dtype(got, want, dtype)
        assert not got[0].any()  # a length-0 row gives zeros

    @pytest.mark.parametrize("page", [32, 64])
    def test_paged_decode_matches_pallas_interpret(self, dtype, page):
        """Shuffled tables, the trash block, lengths 0 / 1 / mid-block /
        full / ragged."""
        q, kq, vq, ks, vs, tables, lengths = quant_pool(seed=5, page=page)
        q, tq = as_dtype(q, dtype)
        want = paged_decode_attention_pallas(
            *map(jnp.asarray, (q, kq, vq, tables, lengths, ks, vs)),
            interpret=True)
        got = tpd.paged_decode_attention_quant_reference(
            tq, *map(t, (kq, vq, tables, lengths, ks, vs)))
        assert_within_dtype(got, want, dtype)
        assert not got[0].any()

    def test_wrappers_take_plain_versions_on_cpu(self, dtype):
        tdt = getattr(torch, dtype)
        q, kq, vq, ks, vs, lengths = quant_lanes(seed=6)
        tq, kq, vq, ks, vs, lengths = (t(q).to(tdt),
                                       *map(t, (kq, vq, ks, vs, lengths)))
        before = (tdec.launches, tdec.quant_launches)
        got = tdec.decode_attention(tq, kq, vq, lengths, ks, vs)
        assert torch.equal(got, tdec.decode_attention_quant_reference(
            tq, kq, vq, ks, vs, lengths))
        with pytest.raises(ValueError, match="both scales"):
            tdec.decode_attention(tq, kq, vq, lengths, ks)
        assert (tdec.launches, tdec.quant_launches) == before
        q, kq, vq, ks, vs, tables, lengths = quant_pool(seed=7, page=16)
        args = (t(q).to(tdt), *map(t, (kq, vq, tables, lengths)))
        before = (tpd.launches, tpd.quant_launches)
        got = tpd.paged_decode_attention(*args, t(ks), t(vs))
        assert torch.equal(got, tpd.paged_decode_attention_quant_reference(
            *args, t(ks), t(vs)))
        assert (tpd.launches, tpd.quant_launches) == before


def test_swapped_head_scales_change_the_output():
    """The chip smoke's negative control, on the CPU: the plain version fed
    one KV head's scales in place of another's fails the scaled check
    (2^-6 of each output vector's largest value)."""
    q, kq, vq, ks, vs, lengths = quant_lanes(seed=8)
    args = list(map(t, (q, kq, vq, ks, vs, lengths)))
    want = tdec.decode_attention_quant_reference(*args)
    for i in (3, 4):
        args[i] = args[i].clone()
        args[i][..., 1] = args[i][..., 0]
    wrong = tdec.decode_attention_quant_reference(*args)
    num = (wrong - want).abs().amax(-1)
    scaled = (num / want.abs().amax(-1).clamp_min(1e-30)).max().item()
    assert scaled > 2.0 ** -6


# ---------------------------------------------------------------------------
# the model functions on int8 caches against the reference (TINY_TEST, f32)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    jparams = jtf.init_params(JAX_TINY, jax.random.PRNGKey(0), jnp.float32)
    rng = np.random.default_rng(5)
    jbufs = jlora.init_lora_buffers(JAX_TINY, jnp.float32)
    adapter = {tg: {"a": rnd(rng, 2, di, 2) * 0.3, "b": rnd(rng, 2, 2, do) * 0.3}
               for tg, (di, do) in jlora.target_dims(JAX_TINY).items()}
    jbufs = jlora.load_adapter(jbufs, JAX_TINY, 0, adapter, alpha=4.0, rank=2)
    np_tree = jax.tree.map(np.asarray, (jparams, jbufs))
    return (jparams, jbufs, params_from_numpy(np_tree[0], "cpu"),
            lora_from_numpy(np_tree[1], "cpu"))


def assert_int8_close(got, want, what, skip_trash=False):
    """int8 cells equal, or one step apart where the f32 inputs differ in
    their last bits; at most 1% of the cells may differ."""
    g = got.numpy().astype(np.int32)
    w = np.asarray(want).astype(np.int32)
    if skip_trash:
        g, w = g[:, 1:], w[:, 1:]
    diff = np.abs(g - w)
    assert diff.max() <= 1, (what, diff.max())
    assert (diff > 0).mean() <= 0.01, (what, int((diff > 0).sum()), diff.size)


def logits_atol(tcache, jcache, skip_trash=False) -> float:
    """LOGITS_ATOL while the int8 caches are identical (outside the paged
    pool's trash block), else the looser limit a one-step flip of an int8
    cell allows."""
    cut = 1 if skip_trash else 0
    same = all(np.array_equal(tcache[n][:, cut:].numpy(),
                              np.asarray(jcache[n])[:, cut:])
               for n in ("k", "v"))
    return LOGITS_ATOL if same else FLIPPED_LOGITS_ATOL


def assert_cache_close(tcache, jcache, skip_trash=False):
    for name in ("k", "v"):
        assert tcache[name].dtype == torch.int8
        assert_int8_close(tcache[name], jcache[name], name, skip_trash)
    for name in ("k_scale", "v_scale"):
        g, w = tcache[name].numpy(), np.asarray(jcache[name])
        if skip_trash:
            g, w = g[:, 1:], w[:, 1:]
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-12)


def prefill_both(tiny, lens=(9, 14, 5), bucket=16, seed=6):
    jparams, jbufs, _, _ = tiny
    rng = np.random.default_rng(seed)
    tokens = np.zeros((len(lens), bucket), np.int32)
    positions = np.zeros((len(lens), bucket), np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(1, 250, n)
        positions[i, :n] = np.arange(n)
    slots = np.array([-1, 0, -1], np.int32)[:len(lens)]
    logits, k, v = jtf.prefill(JAX_TINY, jparams, jnp.asarray(tokens),
                               jnp.asarray(positions), lora_bufs=jbufs,
                               slot_ids=jnp.asarray(slots))
    first = np.asarray(jnp.argmax(logits[jnp.arange(len(lens)),
                                         np.array(lens) - 1], -1), np.int32)
    return k, v, np.array(lens, np.int32), first, slots


class TestLaneModel:
    def lanes(self, tiny, s_max=32):
        k, v, lens, first, slots = prefill_both(tiny)
        jcache = jtf.init_decode_cache(JAX_TINY, 3, s_max, jnp.float32,
                                       quantized=True)
        tcache = ttf.init_decode_cache(TINY_TEST, 3, s_max, torch.float32,
                                       "cpu", quantized=True)
        for i, n in enumerate(lens):
            jcache = jtf.insert_prefill(jcache, k[:, i:i + 1], v[:, i:i + 1],
                                        i, int(n))
            tcache = ttf.insert_prefill(tcache, t(k[:, i:i + 1]),
                                        t(v[:, i:i + 1]), i, int(n))
        return jcache, tcache, lens, first, slots

    def test_quantized_layout(self):
        cache = ttf.init_decode_cache(TINY_TEST, 2, 16, torch.bfloat16, "cpu",
                                      quantized=True)
        shape = (TINY_TEST.n_layers, 2, 16, TINY_TEST.n_kv_heads,
                 TINY_TEST.resolved_head_dim)
        assert cache["k"].shape == shape and cache["k"].dtype == torch.int8
        assert cache["v_scale"].shape == shape[:-1]
        assert cache["v_scale"].dtype == torch.float32

    def test_insert_prefill_matches_reference(self, tiny):
        """Prompt KV quantized at insert: int8 values and scales agree (the
        prompt KV crosses as identical arrays, so exactly)."""
        jcache, tcache, _, _, _ = self.lanes(tiny)
        for name in ("k", "v", "k_scale", "v_scale"):
            np.testing.assert_array_equal(tcache[name].numpy(),
                                          np.asarray(jcache[name]))
        np.testing.assert_array_equal(tcache["length"].numpy(),
                                      np.asarray(jcache["length"]))

    def test_decode_step_matches_reference(self, tiny):
        """Four int8 decode steps with an adapter row and an INACTIVE row:
        logits agree each step; the inactive row's int8 cells and scales
        never change."""
        jparams, jbufs, tparams, tbufs = tiny
        jcache, tcache, pos, cur, slots = self.lanes(tiny)
        active = np.array([True, True, False])
        before = {n: tcache[n][:, 2].clone()
                  for n in ("k", "v", "k_scale", "v_scale")}
        for step in range(4):
            jlog, jcache = jtf.decode_step(
                JAX_TINY, jparams, jcache, jnp.asarray(cur), jnp.asarray(pos),
                lora_bufs=jbufs, slot_ids=jnp.asarray(slots),
                active=jnp.asarray(active))
            tlog, tcache = ttf.decode_step(
                TINY_TEST, tparams, tcache, t(cur), t(pos), lora_bufs=tbufs,
                slot_ids=t(slots), active=t(active))
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                       atol=logits_atol(tcache, jcache),
                                       err_msg=f"step {step}")
            cur = np.asarray(jnp.argmax(jlog, -1), np.int32)
            pos = pos + active
        assert_cache_close(tcache, jcache)
        for n, old in before.items():
            assert torch.equal(tcache[n][:, 2], old), n

    def test_prefill_with_cache_chunks_match_monolithic(self, tiny):
        """Two 16-token chunks of a 23-token prompt into an int8 lane of
        S_max 24 (the final chunk's pads past it write nothing): the last
        logits match JAX's and a monolithic prefill's, the lane's bytes
        JAX's."""
        jparams, jbufs, tparams, tbufs = tiny
        prompt = np.random.default_rng(7).integers(1, 250, 23)
        jcache = jtf.init_decode_cache(JAX_TINY, 2, 24, jnp.float32,
                                       quantized=True)
        tcache = ttf.init_decode_cache(TINY_TEST, 2, 24, torch.float32,
                                       "cpu", quantized=True)
        for start in (0, 16):
            c = min(16, 23 - start)
            toks = np.zeros(16, np.int32)
            toks[:c] = prompt[start:start + c]
            pos = start + np.arange(16, dtype=np.int32)
            jl, jcache = jtf.prefill_with_cache(
                JAX_TINY, jparams, jcache, jnp.asarray(toks), jnp.asarray(pos),
                jnp.int32(1), jnp.int32(start + c), jnp.int32(c - 1),
                lora_bufs=jbufs, lora_slot=jnp.int32(0))
            tl, tcache = ttf.prefill_with_cache(
                TINY_TEST, tparams, tcache, toks, pos, 1, start + c, c - 1,
                lora_bufs=tbufs, lora_slot=0)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=logits_atol(tcache, jcache))
        assert_cache_close(tcache, jcache)
        assert not tcache["k"][:, 0].any()  # the other lane is untouched
        want, _, _ = ttf.prefill(TINY_TEST, tparams, t(prompt[None]),
                                 t(np.arange(23)[None]), lora_bufs=tbufs,
                                 slot_ids=t([0]))
        # The second chunk attends the first through int8: a prefill
        # without a cache differs by the quantization error only.
        np.testing.assert_allclose(tl.numpy(), want[0, 22].numpy(), atol=0.05)
        # One chunk of the whole prompt over an int8 lane reads every key
        # dequantized too, so it equals the two chunks up to summation
        # order (LOGITS_ATOL).
        whole = ttf.init_decode_cache(TINY_TEST, 2, 24, torch.float32, "cpu",
                                      quantized=True)
        toks = np.zeros(32, np.int32)
        toks[:23] = prompt
        one, whole = ttf.prefill_with_cache(
            TINY_TEST, tparams, whole, toks, np.arange(32), 1, 23, 22,
            lora_bufs=tbufs, lora_slot=0)
        np.testing.assert_allclose(tl.numpy(), one.numpy(), atol=LOGITS_ATOL)
        for name in ("k", "v", "k_scale", "v_scale"):
            assert torch.equal(whole[name], tcache[name]), name


class TestPagedModel:
    def pools(self, tiny):
        k, v, lens, first, slots = prefill_both(tiny)
        phys = ([7, 2], [11, 4], [9, 0])  # row 2's second bucket block: trash
        tables = np.array([[7, 2, 0, 0], [11, 4, 0, 0], [9, 0, 0, 0]],
                          np.int32)
        jcache = jpaged.init_paged_cache(JAX_TINY, 3, 32, 12, P, jnp.float32,
                                         quantized=True)
        tcache = tpaged.init_paged_cache(TINY_TEST, 3, 32, 12, P,
                                         torch.float32, "cpu", quantized=True)
        for i, n in enumerate(lens):
            jcache = jpaged.insert_prefill_paged(
                jcache, k[:, i:i + 1], v[:, i:i + 1], i, jnp.asarray(phys[i]),
                jnp.asarray(tables[i]), int(n))
            tcache = tpaged.insert_prefill_paged(
                tcache, t(k[:, i:i + 1]), t(v[:, i:i + 1]), i, phys[i],
                tables[i], int(n))
        return jcache, tcache, lens, first, slots

    def test_quantized_layout(self):
        cache = tpaged.init_paged_cache(TINY_TEST, 2, 32, 8, 16, device="cpu",
                                        quantized=True)
        assert cache["k"].dtype == torch.int8
        assert cache["k_scale"].shape == (TINY_TEST.n_layers, 9, 16,
                                          TINY_TEST.n_kv_heads)
        assert cache["k_scale"].dtype == torch.float32

    def test_insert_prefill_paged_matches_reference(self, tiny):
        jcache, tcache, _, _, _ = self.pools(tiny)
        for name in ("k", "v", "k_scale", "v_scale"):
            np.testing.assert_array_equal(tcache[name][:, 1:].numpy(),
                                          np.asarray(jcache[name])[:, 1:])
        np.testing.assert_array_equal(tcache["tables"].numpy(),
                                      np.asarray(jcache["tables"]))

    def test_decode_step_paged_matches_reference(self, tiny):
        """Four steps over the int8 pool, an adapter row and an INACTIVE
        row: logits agree, the pools agree outside the trash block, and the
        inactive row's block (data and scales) never changes."""
        jparams, jbufs, tparams, tbufs = tiny
        jcache, tcache, pos, cur, slots = self.pools(tiny)
        grown = np.array([[7, 2, 0, 0], [11, 4, 5, 0], [9, 0, 0, 0]], np.int32)
        jcache["tables"] = jnp.asarray(grown)
        tcache["tables"] = t(grown)
        active = np.array([True, True, False])
        before = {n: tcache[n][:, 9].clone()
                  for n in ("k", "v", "k_scale", "v_scale")}
        for step in range(4):
            jlog, jcache = jpaged.decode_step_paged(
                JAX_TINY, jparams, jcache, jnp.asarray(cur), jnp.asarray(pos),
                lora_bufs=jbufs, slot_ids=jnp.asarray(slots),
                active=jnp.asarray(active))
            tlog, tcache = tpaged.decode_step_paged(
                TINY_TEST, tparams, tcache, t(cur), t(pos), lora_bufs=tbufs,
                slot_ids=t(slots), active=t(active))
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                       atol=logits_atol(tcache, jcache, True),
                                       err_msg=f"step {step}")
            cur = np.asarray(jnp.argmax(jlog, -1), np.int32)
            pos = pos + active
        assert_cache_close(tcache, jcache, skip_trash=True)
        for n, old in before.items():
            assert torch.equal(tcache[n][:, 9], old), n

    def test_prefill_with_cache_paged_matches_reference(self, tiny):
        """Two 16-token chunks of a 23-token prompt through a 3-block int8
        row (span 24): logits, pools and lengths agree."""
        jparams, jbufs, tparams, tbufs = tiny
        prompt = np.random.default_rng(7).integers(1, 250, 23)
        table = np.zeros((2, 3), np.int32)
        table[1] = [3, 6, 1]
        jcache = jpaged.init_paged_cache(JAX_TINY, 2, 24, 6, P, jnp.float32,
                                         quantized=True)
        tcache = tpaged.init_paged_cache(TINY_TEST, 2, 24, 6, P,
                                         torch.float32, "cpu", quantized=True)
        jcache["tables"] = jnp.asarray(table)
        tcache["tables"] = t(table)
        for start in (0, 16):
            c = min(16, 23 - start)
            toks = np.zeros(16, np.int32)
            toks[:c] = prompt[start:start + c]
            pos = start + np.arange(16, dtype=np.int32)
            jl, jcache = jpaged.prefill_with_cache_paged(
                JAX_TINY, jparams, jcache, jnp.asarray(toks), jnp.asarray(pos),
                jnp.int32(1), jnp.int32(start + c), jnp.int32(c - 1),
                lora_bufs=jbufs, lora_slot=jnp.int32(0))
            tl, tcache = tpaged.prefill_with_cache_paged(
                TINY_TEST, tparams, tcache, toks, pos, 1, start + c, c - 1,
                lora_bufs=tbufs, lora_slot=0)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=logits_atol(tcache, jcache, True))
        assert_cache_close(tcache, jcache, skip_trash=True)
        np.testing.assert_array_equal(tcache["length"].numpy(),
                                      np.asarray(jcache["length"]))

    def test_lane_and_paged_chunks_agree(self, tiny):
        """The same chunks into an int8 lane and an int8 pool give the same
        logits: the two read seams dequantize alike."""
        _, _, tparams, tbufs = tiny
        prompt = np.random.default_rng(9).integers(1, 250, 20)
        lane = ttf.init_decode_cache(TINY_TEST, 2, 24, torch.float32, "cpu",
                                     quantized=True)
        pool = tpaged.init_paged_cache(TINY_TEST, 2, 24, 6, P, torch.float32,
                                       "cpu", quantized=True)
        pool["tables"][1] = t(np.array([4, 2, 5], np.int32))
        for start in (0, 16):
            c = min(16, 20 - start)
            toks = np.zeros(16, np.int32)
            toks[:c] = prompt[start:start + c]
            pos = start + np.arange(16, dtype=np.int64)
            a, lane = ttf.prefill_with_cache(
                TINY_TEST, tparams, lane, toks, pos, 1, start + c, c - 1,
                lora_bufs=tbufs, lora_slot=0)
            b, pool = tpaged.prefill_with_cache_paged(
                TINY_TEST, tparams, pool, toks, pos, 1, start + c, c - 1,
                lora_bufs=tbufs, lora_slot=0)
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# engines: greedy streams against the JAX engine
# ---------------------------------------------------------------------------


def _adapter(seed=0, rank=3):
    rng = np.random.default_rng(seed)
    return {tg: {"a": rng.standard_normal((2, di, rank)).astype(np.float32) * .4,
                 "b": rng.standard_normal((2, rank, do)).astype(np.float32) * .4}
            for tg, (di, do) in jlora.target_dims(JAX_TINY).items()}


@pytest.fixture(scope="module")
def params():
    jparams = jtf.init_params(JAX_TINY, jax.random.PRNGKey(0), jnp.float32)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def engine_pair(params, weights=False, lora=True, **kw):
    cfg = dict(decode_slots=3, max_seq_len=64, prefill_buckets=(8, 16),
               decode_steps_per_sync=4, kv_cache_quant="int8")
    cfg.update(kw)
    jparams, tparams = params
    if weights:
        jparams, tparams = (jquant.quantize_params(jparams),
                            tquant.quantize_params(tparams))
    jl = tl = None
    if lora:
        jl = JLoRA(JAX_TINY, dtype=jnp.float32)
        jl.load("tenant", weights=_adapter(), alpha=6.0, rank=3)
        tl = TLoRA(TINY_TEST, dtype=torch.float32, device="cpu")
        tl.load("tenant", weights=_adapter(), alpha=6.0, rank=3)
    je = jeng.Engine(JAX_TINY, jparams, jeng.EngineConfig(**cfg),
                     lora_manager=jl, eos_id=None, dtype=jnp.float32)
    te = teng.Engine(TINY_TEST, tparams, teng.EngineConfig(**cfg),
                     lora_manager=tl, eos_id=None, dtype=torch.float32,
                     device="cpu")
    return je, te


def streams(engine, mod, jobs):
    """Requests one after another (a deterministic allocator history)."""
    engine.start()
    try:
        out = []
        for prompt, max_new, adapter in jobs:
            req = mod.Request(prompt_tokens=list(prompt),
                              max_new_tokens=max_new, adapter=adapter)
            engine.generate(req, timeout_s=120)
            assert req.error is None, req.error
            out.append(req.output_tokens)
        return out
    finally:
        engine.stop()


PREFIX = [256] + [(7 * i) % 200 + 3 for i in range(19)]
JOBS = [([256, 5, 6, 7], 8, None),
        (PREFIX + [40, 41], 6, "tenant"),
        (PREFIX + [50], 6, "tenant"),        # a prefix hit when paged
        ([256] + list(range(10, 40)), 5, None),  # 31 tokens: streams
        ([256, 9, 8], 7, "tenant")]


@pytest.mark.parametrize("case", [
    "lanes", "paged_prefix", "lanes_int8_weights", "paged_int8_weights",
    "weights_only"])
def test_engine_streams_match_jax(params, case):
    """Greedy streams identical to the JAX engine with int8 KV (lanes; the
    paged pool with prefix cache), int8 weights (``quantize_params``), and
    both together; a 31-token prompt beyond the largest bucket (16)
    streams in chunks."""
    paged = case.startswith("paged")
    kw = dict(weights="weights" in case)
    if paged:
        kw.update(paged_kv_block=P, prefix_cache=True)
    if case == "weights_only":
        kw.update(kv_cache_quant=None)
    je, te = engine_pair(params, **kw)
    want = streams(je, jeng, JOBS)
    got = streams(te, teng, JOBS)
    assert got == want
    if paged:
        assert te.prefix_reused_tokens == je.prefix_reused_tokens > 0
    if case == "weights_only":
        assert te.cache["k"].dtype == torch.float32
    else:
        assert te.cache["k"].dtype == torch.int8


def test_prefix_hit_reuses_blocks_with_their_scales(params):
    """A prefix hit maps the cached blocks (a table repoint): the second
    request's prefill leaves those blocks' int8 data and scales exactly as
    the first request wrote them."""
    _, te = engine_pair(params, lora=False, paged_kv_block=P,
                        prefix_cache=True)
    te.start()
    try:
        first = teng.Request(prompt_tokens=PREFIX + [40, 41], max_new_tokens=3)
        te.generate(first, timeout_s=120)
        cached = sorted(te._block_hash)
        assert len(cached) == len(PREFIX + [40, 41]) // P
        snap = {n: te.cache[n][:, cached].clone()
                for n in ("k", "v", "k_scale", "v_scale")}
        assert snap["k_scale"].abs().sum() > 0
        second = teng.Request(prompt_tokens=PREFIX + [50], max_new_tokens=3)
        te.generate(second, timeout_s=120)
        assert te.prefix_reused_tokens == len(PREFIX + [50]) // P * P
    finally:
        te.stop()
    for n, old in snap.items():
        assert torch.equal(te.cache[n][:, cached], old), n


def test_bad_kv_cache_quant_raises():
    cfg = teng.EngineConfig(kv_cache_quant="fp8")
    with pytest.raises(ValueError, match="kv_cache_quant"):
        teng.Engine(TINY_TEST, {}, cfg, device="cpu")


def test_api_http_serves_both_flags():
    httpd, engine, _ = api_http.make_server([
        "--device", "cpu", "--dtype", "float32", "--host", "127.0.0.1",
        "--port", "0", "--max-seq-len", "128", "--decode-slots", "2",
        "--quantize", "int8", "--kv-quantize", "int8",
        "--paged-kv-block", "16", "--prefix-cache"])
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        assert engine.cache["k"].dtype == torch.int8
        assert tquant.is_quantized(engine.params["layers"]["w_up"])
        url = "http://127.0.0.1:%d/v1/completions" % httpd.server_address[1]
        req = urllib.request.Request(
            url, data=json.dumps({"prompt": "hello", "max_tokens": 4}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as f:
            body = json.loads(f.read().decode())
        assert body["usage"]["completion_tokens"] == 4
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()
