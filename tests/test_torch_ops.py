"""Parity of the torch port's ops with the JAX reference, on the CPU.

Same numpy-seeded inputs through the JAX function and its port.  Kernel
modules are held through their plain versions (what a CPU tensor takes);
the Pallas kernels run in interpret mode, as tests/test_pallas_*.py run
them.  Also: the AST rule that the port imports nothing of JAX.
"""

import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest

from llm_instance_gateway_tpu.models import lora as jlora
from llm_instance_gateway_tpu.models.configs import TINY_TEST as JAX_TINY
from llm_instance_gateway_tpu.ops import attention as jatt
from llm_instance_gateway_tpu.ops import layers as jlayers
from llm_instance_gateway_tpu.ops import pallas_attention, pallas_decode_attention

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch.models import lora as tlora  # noqa: E402
from llm_instance_gateway_tpu_torch.models.configs import TINY_TEST  # noqa: E402
from llm_instance_gateway_tpu_torch.ops import attention as tatt  # noqa: E402
from llm_instance_gateway_tpu_torch.ops import decode_attention as tdec  # noqa: E402
from llm_instance_gateway_tpu_torch.ops import flash_attention as tflash  # noqa: E402
from llm_instance_gateway_tpu_torch.ops import layers as tlayers  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5       # plain ops, f32: same math, different summation order
KERNEL_ATOL = 1e-4  # plain kernel versions vs the Pallas kernels (tiled sums)


def rnd(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a))


class TestLayers:
    @pytest.mark.parametrize("plus_one", [False, True])
    def test_rms_norm(self, plus_one):
        rng = np.random.default_rng(0)
        x, w = rnd(rng, 3, 5, 64), rnd(rng, 64)
        want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, plus_one)
        got = tlayers.rms_norm(t(x), t(w), 1e-5, plus_one)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    @pytest.mark.parametrize("scaling", [None, (8.0, 1.0, 4.0, 8192)])
    def test_rope_frequencies(self, scaling):
        want = jlayers.rope_frequencies(128, 500_000.0, scaling)
        got = tlayers.rope_frequencies(128, 500_000.0, scaling)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-12)

    @pytest.mark.parametrize("scaling", [None, (8.0, 1.0, 4.0, 8192)])
    def test_apply_rope(self, scaling):
        rng = np.random.default_rng(1)
        x = rnd(rng, 2, 7, 4, 16)
        pos = rng.integers(0, 100, (2, 7)).astype(np.int32)
        want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0,
                                  scaling)
        got = tlayers.apply_rope(t(x), t(pos), 10_000.0, scaling)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    @pytest.mark.parametrize("gelu", [False, True])
    def test_swiglu(self, gelu):
        rng = np.random.default_rng(2)
        g, u = rnd(rng, 4, 32), rnd(rng, 4, 32)
        want = jlayers.swiglu(jnp.asarray(g), jnp.asarray(u), gelu)
        got = tlayers.swiglu(t(g), t(u), gelu)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


class TestAttention:
    @pytest.mark.parametrize("with_positions", [False, True])
    def test_prefill_attention(self, with_positions):
        rng = np.random.default_rng(3)
        q, k, v = rnd(rng, 2, 12, 4, 16), rnd(rng, 2, 12, 2, 16), rnd(rng, 2, 12, 2, 16)
        pos = None
        if with_positions:  # right-padded second row: pads at position 0
            pos = np.tile(np.arange(12, dtype=np.int32), (2, 1))
            pos[1, 7:] = 0
        want = jatt.prefill_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v),
                                      None if pos is None else jnp.asarray(pos))
        got = tatt.prefill_attention(t(q), t(k), t(v),
                                     None if pos is None else t(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    def test_decode_attention(self):
        rng = np.random.default_rng(4)
        q = rnd(rng, 3, 4, 16)
        k, v = rnd(rng, 3, 20, 2, 16), rnd(rng, 3, 20, 2, 16)
        lengths = np.array([1, 13, 20], np.int32)
        want = jatt.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(lengths))
        got = tatt.decode_attention(t(q), t(k), t(v), t(lengths))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


class TestFlashKernelPlainVersion:
    """The flash kernel's plain version against the Pallas kernel."""

    def _inputs(self, s=128, seed=5):
        rng = np.random.default_rng(seed)
        return (rnd(rng, 1, s, 4, 128), rnd(rng, 1, s, 2, 128),
                rnd(rng, 1, s, 2, 128))

    def test_matches_pallas_interpret(self):
        q, k, v = self._inputs()
        tr = (0, 2, 1, 3)
        want = pallas_attention.flash_attention_bhsd(
            jnp.asarray(q.transpose(tr)), jnp.asarray(k.transpose(tr)),
            jnp.asarray(v.transpose(tr)), interpret=True)
        got = tflash.flash_attention_reference(t(q), t(k), t(v))
        np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(tr),
                                   atol=KERNEL_ATOL)

    def test_wrapper_takes_plain_version_on_cpu(self):
        q, k, v = self._inputs(s=40, seed=6)
        before = tflash.launches
        got = tflash.flash_attention(t(q), t(k), t(v))
        want = tflash.flash_attention_reference(t(q), t(k), t(v))
        assert torch.equal(got, want)
        assert tflash.launches == before  # the plain version is no launch

    def test_ragged_bucket_matches_reference_op(self):
        # Buckets below 128 (16/32/64) and ragged S: the TPU gate sends them
        # to XLA; the port's kernel covers them, so its function must hold.
        q, k, v = self._inputs(s=48, seed=7)
        want = jatt.prefill_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v))
        got = tflash.flash_attention_reference(t(q), t(k), t(v))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=KERNEL_ATOL)

    def test_wrapper_rejects_other_devices(self):
        q = torch.zeros((1, 16, 4, 128), device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            tflash.flash_attention(q, q[:, :, :2], q[:, :, :2])


class TestDecodeKernelPlainVersion:
    """The lane decode kernel's plain version against the Pallas kernel."""

    def test_matches_pallas_interpret_ragged(self):
        rng = np.random.default_rng(8)
        q = rnd(rng, 5, 8, 128)
        k, v = rnd(rng, 5, 256, 2, 128), rnd(rng, 5, 256, 2, 128)
        lengths = np.array([0, 1, 77, 200, 256], np.int32)
        want = pallas_decode_attention.decode_attention_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(lengths), interpret=True)
        got = tdec.decode_attention_reference(t(q), t(k), t(v), t(lengths))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=KERNEL_ATOL)
        assert not got[0].any()  # a row of length 0 gives zeros

    def test_garbage_past_length_is_ignored(self):
        rng = np.random.default_rng(9)
        q = rnd(rng, 2, 4, 64)
        k, v = rnd(rng, 2, 64, 1, 64), rnd(rng, 2, 64, 1, 64)
        lengths = t(np.array([10, 33], np.int32))
        clean = tdec.decode_attention(t(q), t(k), t(v), lengths)
        k[:, 40:], v[:, 40:] = 1e3, -1e3
        k[0, 10:], v[0, 10:] = 1e3, -1e3
        dirty = tdec.decode_attention(t(q), t(k), t(v), lengths)
        np.testing.assert_array_equal(clean.numpy(), dirty.numpy())

    def test_bf16_probabilities_round_before_pv(self):
        # p.astype(v.dtype): in bf16 the plain version rounds p before PV,
        # like the reference kernel; its error vs the f32 path stays small.
        rng = np.random.default_rng(10)
        q = rnd(rng, 2, 4, 64)
        k, v = rnd(rng, 2, 32, 2, 64), rnd(rng, 2, 32, 2, 64)
        lengths = t(np.array([32, 5], np.int32))
        f32 = tdec.decode_attention_reference(t(q), t(k), t(v), lengths)
        b16 = tdec.decode_attention_reference(
            t(q).bfloat16(), t(k).bfloat16(), t(v).bfloat16(), lengths)
        assert b16.dtype == torch.bfloat16
        assert (b16.float() - f32).abs().max().item() < 5e-2


class TestLoraDelta:
    @pytest.mark.parametrize("rank3", [False, True])
    def test_mixed_slots(self, rank3):
        rng = np.random.default_rng(11)
        n_slots, d_in, r, d_out = 4, 16, 4, 24
        a, b = rnd(rng, n_slots, d_in, r), rnd(rng, n_slots, r, d_out)
        scale = np.array([0.5, 2.0, 1.5, 3.0], np.float32)
        slots = np.array([-1, 0, 2], np.int32)
        x = rnd(rng, 3, 5, d_in) if rank3 else rnd(rng, 3, d_in)
        want = jlora.lora_delta(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b),
                                jnp.asarray(scale), jnp.asarray(slots))
        got = tlora.lora_delta(t(x), t(a), t(b), t(scale), t(slots))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        assert not got[0].any()  # slot -1: an exact zero delta

    def test_load_unload_buffers_match_reference(self):
        rng = np.random.default_rng(12)
        dims = jlora.target_dims(JAX_TINY)
        adapter = {tg: {"a": rnd(rng, 2, di, 3), "b": rnd(rng, 2, 3, do)}
                   for tg, (di, do) in dims.items() if tg != "k"}
        jb = jlora.load_adapter(jlora.init_lora_buffers(JAX_TINY, jnp.float32),
                                JAX_TINY, 2, adapter, alpha=6.0, rank=3)
        tb = tlora.load_adapter(tlora.init_lora_buffers(TINY_TEST,
                                                        torch.float32, "cpu"),
                                TINY_TEST, 2, adapter, alpha=6.0, rank=3)
        assert set(jb) == set(tb)
        for key in jb:
            np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]))
        jb = jlora.unload_adapter(jb, JAX_TINY, 2)
        tb = tlora.unload_adapter(tb, TINY_TEST, 2)
        for key in jb:
            np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]))


def _port_files():
    root = os.path.join(REPO, "llm_instance_gateway_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, names in os.walk(root):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    # ml_dtypes comes with JAX; the card's host has none (bf16 handoffs
    # cross the wire as raw 16-bit words instead).  Orbax, Flax and Optax
    # are JAX libraries, and the safetensors package is not on the card's
    # host either: the port reads both checkpoint forms itself.
    return top in ("jax", "jaxlib", "llm_instance_gateway_tpu", "ml_dtypes",
                   "orbax", "flax", "optax", "safetensors")


def _imported_names(node) -> list:
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if isinstance(node, ast.ImportFrom) and node.level == 0:
        return [node.module or ""]
    return []


def _module_level_imports(tree) -> list:
    """Names imported when the module is imported: every import outside a
    function body (class bodies and ``if``/``try`` blocks run too)."""
    found, todo = [], list(tree.body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        found += _imported_names(node)
        todo += list(ast.iter_child_nodes(node))
    return found


def test_optional_packages_are_imported_inside_functions_only():
    """transformers (``HFTokenizer``) and tensorstore (the Orbax reader)
    are not on the card's host: the port imports them where they are
    used, so importing any module of the port never needs them."""
    users = set()
    for path in _port_files():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        rel = os.path.relpath(path, REPO)
        top = {n.split(".")[0] for n in _module_level_imports(tree)}
        assert not top & {"transformers", "tensorstore"}, rel
        every = {n.split(".")[0] for node in ast.walk(tree)
                 for n in _imported_names(node)}
        users |= {(rel, n) for n in every & {"transformers", "tensorstore"}}
    assert users == {
        ("llm_instance_gateway_tpu_torch/server/tokenizer.py",
         "transformers"),
        ("llm_instance_gateway_tpu_torch/models/orbax_tree.py",
         "tensorstore")}


def test_port_imports_nothing_of_jax():
    """No module of the port (nor chip_smoke.py) imports jax, jaxlib, the
    JAX package — not even a module of it that is framework-free —,
    ml_dtypes, orbax, flax, optax or safetensors."""
    files = _port_files()
    assert len(files) > 15
    rel = {os.path.relpath(p, REPO) for p in files}
    for module in ("models/paged.py", "server/kv_ledger.py",
                   "server/kv_transfer.py", "events.py", "tracing.py",
                   "ops/chunk_attention.py", "ops/paged_decode_attention.py",
                   "models/convert.py", "models/safetensors.py",
                   "models/orbax_tree.py", "training/train.py",
                   "parallel/ring_attention.py", "parallel/long_context.py"):
        # the walk covers every subpackage, the newest modules included
        assert f"llm_instance_gateway_tpu_torch/{module}" in rel
    offenders = []
    for path in files:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            offenders += [(os.path.relpath(path, REPO), n)
                          for n in names if _forbidden(n)]
    assert offenders == []


def test_kernel_sources_target_hopper():
    from llm_instance_gateway_tpu_torch.ops import _build

    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    for name in _build.KERNELS:
        with open(_build.source_path(name), encoding="utf-8") as f:
            src = f.read()
        assert f"{name}_launch" in src and 'extern "C"' in src
        assert "Replaces: llm_instance_gateway_tpu/ops/pallas_" in src
