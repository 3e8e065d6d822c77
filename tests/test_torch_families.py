"""Every model family of the reference served by the torch port, held to
the JAX package on the CPU at f32 (a port of ``test_engine_families.py``).

The same weights (the reference's ``init_params``, crossed by the weight
bridge; Qwen's q/k/v biases drawn non-zero, since zero biases would test
nothing) go through both packages:

- prefill logits within ``ATOL``, per family;
- greedy tokens of the JAX engine and the port's equal, on lanes and on the
  paged pool with the prefix cache, per family (Mixtral's prompts reach
  the grouped MoE dispatch in prefill, its 2-slot decode the dense one);
- Gemma with LoRA multiplexing (an adapter changes the tokens, and both
  packages agree), and a Mixtral adapter whose MLP factors load but leave
  the expert MLP alone;
- a speculative engine on ``mixtral-tiny`` whose verify runs the grouped
  dispatch, against the JAX spec engine;
- the decode block of a 16-slot ``mixtral-tiny`` engine (grouped, with the
  exact fallback) makes no host read;
- ``init_params(quantize=True)`` equals ``quantize_params(init_params())``
  bit for bit, per family;
- the ``--model`` presets equal the reference's, and a server answers on
  each tiny family.
"""

import dataclasses
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_instance_gateway_tpu.models import gemma as jgemma
from llm_instance_gateway_tpu.models import llama as jllama
from llm_instance_gateway_tpu.models import lora as jlora
from llm_instance_gateway_tpu.models import mixtral as jmixtral
from llm_instance_gateway_tpu.models import qwen as jqwen
from llm_instance_gateway_tpu.models import transformer as jtf
from llm_instance_gateway_tpu.models.configs import (
    GEMMA_2B,
    LLAMA2_7B,
    TINY_MOE_TEST,
    TINY_QWEN_TEST,
)
from llm_instance_gateway_tpu.server import engine as jeng
from llm_instance_gateway_tpu.server.lora_manager import LoRAManager as JLoRA

torch = pytest.importorskip("torch")

from llm_instance_gateway_tpu_torch.models import lora as tlora  # noqa: E402
from llm_instance_gateway_tpu_torch.models import transformer as ttf  # noqa: E402
from llm_instance_gateway_tpu_torch.models.configs import (  # noqa: E402
    CONFIGS,
    ModelConfig,
)
from llm_instance_gateway_tpu_torch.models.weights import params_from_numpy  # noqa: E402
from llm_instance_gateway_tpu_torch.ops.quant import quantize_params  # noqa: E402
from llm_instance_gateway_tpu_torch.server import api_http  # noqa: E402
from llm_instance_gateway_tpu_torch.server import engine as teng  # noqa: E402
from llm_instance_gateway_tpu_torch.server.lora_manager import (  # noqa: E402
    LoRAManager as TLoRA,
)

ATOL = 1e-4  # f32 logits through 2 layers: summation order only

FAMILIES = {
    "llama2-tiny": LLAMA2_7B.tiny(),
    "gemma-tiny": GEMMA_2B.tiny(),
    "mixtral-tiny": TINY_MOE_TEST,
    "qwen-tiny": TINY_QWEN_TEST,
}

ENGINE = dict(decode_slots=2, max_seq_len=64, prefill_buckets=(8, 16),
              decode_steps_per_sync=2)
POOLS = {"lanes": {}, "paged": dict(paged_kv_block=8, prefix_cache=True)}
PROMPTS = [(3, 5, 7), (256, 72, 105, 33, 9, 14, 200, 7, 81, 2, 60),
           (3, 5, 7, 11, 13), (40,)]


def port_cfg(jax_cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jax_cfg))


def to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def jax_params(jcfg, seed=0):
    """The reference's weights; a Qwen config gets non-zero biases."""
    params = jtf.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    if jcfg.attention_bias:
        rng = np.random.default_rng(seed + 10)
        layers = dict(params["layers"])
        for name in ("wq_b", "wk_b", "wv_b"):
            layers[name] = jnp.asarray(rng.standard_normal(
                layers[name].shape).astype(np.float32) * 0.5)
        params = dict(params, layers=layers)
    return params


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    jcfg = FAMILIES[request.param]
    jp = jax_params(jcfg)
    return request.param, jcfg, jp, to_port(jp)


def _serve(mod, engine, prompts, max_new=6, adapters=None):
    """Submit every prompt before the loop starts (one admission for all);
    returns the token lists."""
    reqs = [mod.Request(prompt_tokens=list(p), max_new_tokens=max_new,
                        adapter=None if adapters is None else adapters[i])
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.start()
    try:
        for r in reqs:
            assert r.done.wait(180), "request timed out"
            assert r.error is None, r.error
            assert r.finish_reason == "length"
    finally:
        engine.stop()
    return [list(r.output_tokens) for r in reqs]


def _engines(jcfg, jp, tp, jlm=None, tlm=None, **extra):
    kw = {**ENGINE, **extra}
    je = jeng.Engine(jcfg, jp, jeng.EngineConfig(**kw),
                     lora_manager=jlm, eos_id=None, dtype=jnp.float32)
    te = teng.Engine(port_cfg(jcfg), tp, teng.EngineConfig(**kw),
                     lora_manager=tlm, eos_id=None, dtype=torch.float32,
                     device="cpu")
    return je, te


def test_prefill_logits_match(family):
    name, jcfg, jp, tp = family
    rng = np.random.default_rng(1)
    lens = (9, 16, 5)
    tokens = np.zeros((3, 16), np.int32)
    positions = np.zeros((3, 16), np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(0, 259, n)
        positions[i, :n] = np.arange(n)
    jl, jk, _ = jtf.prefill(jcfg, jp, jnp.asarray(tokens),
                            jnp.asarray(positions))
    tl, tk, _ = ttf.prefill(port_cfg(jcfg), tp, torch.from_numpy(tokens),
                            torch.from_numpy(positions))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)


@pytest.mark.parametrize("pool", list(POOLS))
def test_greedy_tokens_equal_the_jax_engine(family, pool):
    name, jcfg, jp, tp = family
    je, te = _engines(jcfg, jp, tp, **POOLS[pool])
    want = _serve(jeng, je, PROMPTS)
    got = _serve(teng, te, PROMPTS)
    assert got == want, name


def _adapter(jcfg, targets, seed=0, rank=2):
    dims = jlora.target_dims(jcfg)
    rng = np.random.RandomState(seed)
    return {t: {"a": rng.randn(jcfg.n_layers, dims[t][0], rank) * 0.3,
                "b": rng.randn(jcfg.n_layers, rank, dims[t][1]) * 0.3}
            for t in targets}


def _lora_pair(jcfg, weights):
    jlm = JLoRA(jcfg, dtype=jnp.float32)
    tlm = TLoRA(port_cfg(jcfg), dtype=torch.float32, device="cpu")
    for lm in (jlm, tlm):
        lm.load("tenant", weights=weights, alpha=8.0, rank=2)
    return jlm, tlm


def test_gemma_with_lora_multiplexing():
    """The reference's Gemma case: base and adapter rows in one batch, the
    adapter (q and v) changes the tokens, and both packages agree."""
    jcfg = FAMILIES["gemma-tiny"]
    jp = jax_params(jcfg)
    jlm, tlm = _lora_pair(jcfg, _adapter(jcfg, ("q", "v")))
    prompts = [(3, 5, 7), (3, 5, 7)]
    adapters = [None, "tenant"]
    je, te = _engines(jcfg, jp, to_port(jp), jlm, tlm)
    want = _serve(jeng, je, prompts, 5, adapters)
    got = _serve(teng, te, prompts, 5, adapters)
    assert got == want
    assert got[0] != got[1]


def test_mixtral_adapter_changes_attention_only():
    """LoRA skips the expert weights, as in the reference: an adapter on
    every target agrees with the JAX engine and changes the tokens, while
    one on gate/up/down alone loads and leaves them as the base model's."""
    jcfg = FAMILIES["mixtral-tiny"]
    jp = jax_params(jcfg)
    tp = to_port(jp)
    prompts = [(3, 5, 7), (3, 5, 7)]
    full = _adapter(jcfg, jlora.TARGETS)
    jlm, tlm = _lora_pair(jcfg, full)
    je, te = _engines(jcfg, jp, tp, jlm, tlm)
    want = _serve(jeng, je, prompts, 6, [None, "tenant"])
    got = _serve(teng, te, prompts, 6, [None, "tenant"])
    assert got == want and got[0] != got[1]
    _, tlm = _lora_pair(jcfg, _adapter(jcfg, ("gate", "up", "down")))
    assert tlm.buffers["gate_a"].abs().sum() > 0
    te = _engines(jcfg, jp, tp, tlm=tlm)[1]
    mlp_only = _serve(teng, te, prompts, 6, [None, "tenant"])
    assert mlp_only[1] == mlp_only[0] == got[0]


def _draft(jcfg):
    """A small dense draft sharing the target's vocabulary."""
    return dataclasses.replace(jcfg, name="tiny-draft", d_model=32,
                               n_layers=1, n_heads=2, n_kv_heads=1, d_ff=64,
                               head_dim=16, n_experts=0)


@pytest.mark.parametrize("pool", list(POOLS))
def test_mixtral_spec_engine_matches_jax(pool, monkeypatch):
    """K=3 over 4 slots: the target's verify is 16 tokens, cap 8 — the
    grouped dispatch (counted) — and the tokens, cycles and emitted counts
    equal the JAX spec engine's."""
    jcfg = FAMILIES["mixtral-tiny"]
    jp = jax_params(jcfg)
    jd = jtf.init_params(_draft(jcfg), jax.random.PRNGKey(7), jnp.float32)
    extra = {**ENGINE, "decode_slots": 4, "speculative_k": 3, **POOLS[pool]}
    je = jeng.Engine(jcfg, jp, jeng.EngineConfig(**extra), eos_id=None,
                     dtype=jnp.float32, draft_params=jd,
                     draft_cfg=_draft(jcfg))
    te = teng.Engine(port_cfg(jcfg), to_port(jp), teng.EngineConfig(**extra),
                     eos_id=None, dtype=torch.float32, device="cpu",
                     draft_params=to_port(jd),
                     draft_cfg=port_cfg(_draft(jcfg)))
    grouped = []
    real = ttf._moe_grouped

    def counted(cfg, lp, x, host_flag=False):
        grouped.append((x.shape, host_flag))
        return real(cfg, lp, x, host_flag)

    monkeypatch.setattr(ttf, "_moe_grouped", counted)
    want = _serve(jeng, je, PROMPTS, 10)
    got = _serve(teng, te, PROMPTS, 10)
    assert got == want
    assert (te.spec_cycles, te.spec_emitted) == (je.spec_cycles,
                                                 je.spec_emitted)
    assert te.spec_cycles > 0
    assert ((4, 4, jcfg.d_model), False) in grouped  # the verify, on device


class _NoHostRead:
    """Raise on every tensor-to-host read while active (the reads a CUDA
    graph cannot hold)."""

    NAMES = ("item", "__bool__", "__int__", "__float__", "__index__",
             "tolist", "numpy")

    def __enter__(self):
        self.saved = {n: getattr(torch.Tensor, n) for n in self.NAMES}

        def boom(*_a, **_k):
            raise AssertionError("host read inside the decode block")

        for n in self.NAMES:
            setattr(torch.Tensor, n, boom)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(torch.Tensor, n, fn)


def test_guard_catches_the_eager_fallback_read():
    """The guard has teeth: the host-read fallback raises under it."""
    cfg = port_cfg(FAMILIES["mixtral-tiny"])
    lp = ttf._layer(to_port(jax_params(FAMILIES["mixtral-tiny"])), 0)
    x = torch.randn(16, cfg.d_model, generator=torch.Generator().manual_seed(0))
    with _NoHostRead(), pytest.raises(AssertionError, match="host read"):
        ttf._moe_grouped(cfg, lp, x, host_flag=True)
    with _NoHostRead():
        ttf._moe_grouped(cfg, lp, x)


@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "pipelined"])
def test_sixteen_slot_decode_block_makes_no_host_read(pipelined, monkeypatch):
    """16 slots: cap 8 < 16, so the decode block runs the grouped dispatch
    with its exact fallback selected on the device; a guard on every host
    read raises if the block makes one.  Tokens equal the JAX engine's."""
    jcfg = FAMILIES["mixtral-tiny"]
    jp = jax_params(jcfg)
    extra = dict(decode_slots=16, pipeline_decode=pipelined)
    je, te = _engines(jcfg, jp, to_port(jp), **extra)
    blocks, grouped = [], []
    real_block, real_grouped = te._decode_block, ttf._moe_grouped

    def guarded(*a, **k):
        blocks.append(a)
        with _NoHostRead():
            return real_block(*a, **k)

    def counted(cfg, lp, x, host_flag=False):
        grouped.append((x.shape[0], host_flag))
        return real_grouped(cfg, lp, x, host_flag)

    te._decode_block = guarded
    monkeypatch.setattr(ttf, "_moe_grouped", counted)
    prompts = [tuple(range(3 + i, 9 + 2 * i)) for i in range(16)]
    want = _serve(jeng, je, prompts, 6)
    got = _serve(teng, te, prompts, 6)
    assert got == want
    assert blocks and (16, False) in grouped


@pytest.mark.parametrize("name", list(FAMILIES))
def test_lora_target_dims_equal_the_reference(name):
    jcfg = FAMILIES[name]
    assert tlora.target_dims(port_cfg(jcfg)) == jlora.target_dims(jcfg)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_int8_init_layer_at_a_time_is_bit_identical(name):
    cfg = port_cfg(FAMILIES[name])
    dense = quantize_params(ttf.init_params(cfg, seed=3, dtype=torch.bfloat16,
                                            device="cpu"))
    direct = ttf.init_params(cfg, seed=3, dtype=torch.bfloat16, device="cpu",
                             quantize=True)

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", v

    a, b = dict(flat(dense)), dict(flat(direct))
    assert set(a) == set(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        assert torch.equal(a[key], b[key]), key
    if cfg.n_experts:
        assert b["layers.w_gate.q"].dim() == 4
        assert b["layers.w_gate.s"].shape == (cfg.n_layers, cfg.n_experts,
                                              cfg.d_ff)


def test_presets_equal_the_reference_model_choices():
    merged = {}
    for mod in (jllama, jgemma, jmixtral, jqwen):
        merged.update(mod.CONFIGS)
    assert sorted(CONFIGS) == sorted(merged)
    for key, jcfg in merged.items():
        assert dataclasses.asdict(CONFIGS[key]) == dataclasses.asdict(jcfg), key
    choices = next(a.choices for a in api_http.build_parser()._actions
                   if a.dest == "model")
    assert sorted(choices) == sorted(merged)


@pytest.mark.parametrize("model", ["gemma-tiny", "mixtral-tiny", "qwen-tiny"])
def test_server_serves_each_family(model):
    httpd, engine, _ = api_http.make_server([
        "--device", "cpu", "--dtype", "float32", "--model", model,
        "--max-seq-len", "64", "--port", "0", "--quantize", "int8"])
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/v1/completions"
        req = urllib.request.Request(url, data=json.dumps(
            {"prompt": "hello", "max_tokens": 4, "temperature": 0}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            body = json.loads(resp.read())
        assert body["usage"]["completion_tokens"] == 4
        assert body["model"] == model
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()
