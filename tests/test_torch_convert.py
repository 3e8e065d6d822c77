"""The port's HF conversion held to transformers and to the JAX package's
(a port of ``tests/test_convert.py``, plus the config routes and the
checkpoint round trip).

Tiny HF models are built in memory from a seed (nothing is downloaded),
converted by the port (``models/convert.py``) and run through the port's
decoder on the CPU at f32: logits within the reference test's tolerances
of HF's and of the JAX package's conversion run through the JAX model,
greedy continuations equal to HF's ``generate``.  The port's tree equals
the reference's conversion leaf for leaf.  Then:

- ``config_from_hf`` gives the same ``ModelConfig`` from a
  ``save_pretrained`` ``config.json`` read as a dict, from the config
  object, and through the reference, per family;
- ``save_hf_checkpoint`` -> ``load_serving_checkpoint`` gives back the
  tree written, bit for bit (bf16 included), and the layer-at-a-time int8
  load equals ``quantize_params`` of the dense load.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

from llm_instance_gateway_tpu.models import convert as jconvert  # noqa: E402
from llm_instance_gateway_tpu.models import transformer as jtf  # noqa: E402

from llm_instance_gateway_tpu_torch.models import convert  # noqa: E402
from llm_instance_gateway_tpu_torch.models import transformer as ttf  # noqa: E402
from llm_instance_gateway_tpu_torch.models.configs import CONFIGS  # noqa: E402
from llm_instance_gateway_tpu_torch.models.convert import (  # noqa: E402
    config_from_hf,
    from_hf_llama,
    load_serving_checkpoint,
    params_from_hf_state_dict,
    save_hf_checkpoint,
)
from llm_instance_gateway_tpu_torch.ops.quant import quantize_params  # noqa: E402


def build_hf_llama(vocab=128, hidden=64, layers=2, heads=4, kv_heads=2, ff=128):
    cfg = transformers.LlamaConfig(
        vocab_size=vocab, hidden_size=hidden, num_hidden_layers=layers,
        num_attention_heads=heads, num_key_value_heads=kv_heads,
        intermediate_size=ff, max_position_embeddings=256,
        rms_norm_eps=1e-5, rope_theta=10_000.0, tie_word_embeddings=False,
    )
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(cfg)
    model.eval()
    return model


def build_gemma():
    cfg = transformers.GemmaConfig(
        vocab_size=160, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=1,
        intermediate_size=128, head_dim=16, max_position_embeddings=256,
        rms_norm_eps=1e-6, rope_theta=10_000.0,
    )
    torch.manual_seed(1)
    return transformers.GemmaForCausalLM(cfg).eval()


def build_mixtral():
    cfg = transformers.MixtralConfig(
        vocab_size=144, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2,
        intermediate_size=96, num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=128, rms_norm_eps=1e-5,
        rope_theta=10_000.0, tie_word_embeddings=False,
    )
    torch.manual_seed(4)
    return transformers.MixtralForCausalLM(cfg).eval()


def build_qwen2():
    cfg = transformers.Qwen2Config(
        vocab_size=144, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2,
        intermediate_size=96, max_position_embeddings=128,
        rms_norm_eps=1e-6, rope_theta=1_000_000.0,
        tie_word_embeddings=False,
    )
    torch.manual_seed(6)
    model = transformers.Qwen2ForCausalLM(cfg)
    # transformers zero-inits Linear biases: randomize q/k/v biases so the
    # bias path is exercised.
    with torch.no_grad():
        for layer in model.model.layers:
            for proj in (layer.self_attn.q_proj, layer.self_attn.k_proj,
                         layer.self_attn.v_proj):
                torch.nn.init.normal_(proj.bias, std=0.5)
    return model.eval()


HF_MODELS = {
    "llama3": build_hf_llama,
    "llama2": lambda: build_hf_llama(heads=4, kv_heads=4),
    "gemma": build_gemma,
    "mixtral": build_mixtral,
    "qwen2": build_qwen2,
}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def port_logits(cfg, params, ids):
    tokens = torch.from_numpy(ids.astype(np.int64))
    positions = torch.arange(ids.shape[1])[None].expand(ids.shape[0], -1)
    with torch.no_grad():
        logits, *_ = ttf.prefill(cfg, params, tokens, positions)
    return logits.numpy()


def check_logits(model, ids, tol):
    """The port's logits against HF's and against the reference's
    conversion through the JAX model; the port's tree against the
    reference's."""
    cfg, params = from_hf_llama(model, dtype=torch.float32, device="cpu")
    jcfg, jparams = jconvert.from_hf_llama(model, dtype=jnp.float32)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    want = _flat(jax.tree.map(np.asarray, jparams))
    got = _flat(params)
    assert set(got) == set(want)
    for key, leaf in want.items():
        np.testing.assert_array_equal(got[key].numpy(), leaf, err_msg=str(key))
    v = model.config.vocab_size
    with torch.no_grad():
        hf = model(torch.from_numpy(ids)).logits.numpy()
    ours = port_logits(cfg, params, ids)[:, :, :v]
    np.testing.assert_allclose(hf, ours, rtol=tol, atol=tol)
    jax_logits, *_ = jtf.prefill(jcfg, jparams, jnp.asarray(ids, jnp.int32),
                                 jnp.arange(ids.shape[1])[None])
    np.testing.assert_allclose(np.asarray(jax_logits)[:, :, :v], ours,
                               rtol=tol, atol=tol)
    return cfg, params


def port_greedy(cfg, params, prompt, n_new, vocab):
    """Prefill then ``n_new - 1`` decode steps on the port's lane cache."""
    tokens = torch.tensor([prompt])
    positions = torch.arange(len(prompt))[None]
    with torch.no_grad():
        logits, k, v = ttf.prefill(cfg, params, tokens, positions)
        cache = ttf.init_decode_cache(cfg, 1, 32, dtype=torch.float32,
                                      device="cpu")
        ttf.insert_prefill(cache, k, v, 0, len(prompt))
        out = [int(logits[0, len(prompt) - 1, :vocab].argmax())]
        pos = len(prompt)
        for _ in range(n_new - 1):
            lg, cache = ttf.decode_step(cfg, params, cache,
                                        torch.tensor([out[-1]]),
                                        torch.tensor([pos]))
            out.append(int(lg[0, :vocab].argmax()))
            pos += 1
    return out


@pytest.fixture(scope="module")
def hf_and_ours():
    model = build_hf_llama()
    cfg, params = from_hf_llama(model, dtype=torch.float32, device="cpu")
    return model, cfg, params


def test_logits_match_hf(hf_and_ours):
    model, _, _ = hf_and_ours
    check_logits(model, np.array([[3, 17, 54, 9, 88, 120, 7, 42]], np.int64),
                 2e-4)


def test_gqa_shapes_converted(hf_and_ours):
    _, cfg, params = hf_and_ours
    assert cfg.n_kv_heads == 2 and cfg.n_heads == 4
    assert params["layers"]["wk"].shape == (2, 64, 2 * 16)
    assert params["layers"]["wq"].shape == (2, 64, 4 * 16)
    assert params["embed"].shape == (cfg.padded_vocab, 64)
    assert params["lm_head"].shape == (64, cfg.padded_vocab)


def test_greedy_continuation_matches_hf(hf_and_ours):
    model, cfg, params = hf_and_ours
    prompt = [5, 9, 23, 77]
    with torch.no_grad():
        hf_out = model.generate(torch.tensor([prompt]), max_new_tokens=6,
                                do_sample=False, pad_token_id=0)
    assert port_greedy(cfg, params, prompt, 6, model.config.vocab_size) \
        == hf_out[0, len(prompt):].tolist()


class TestGemmaParity:
    @pytest.fixture(scope="class")
    def gemma_and_ours(self):
        model = build_gemma()
        cfg, params = from_hf_llama(model, dtype=torch.float32, device="cpu")
        return model, cfg, params

    def test_flags_mapped(self, gemma_and_ours):
        _, cfg, params = gemma_and_ours
        assert cfg.embedding_scale and cfg.norm_plus_one and cfg.gelu_mlp
        assert cfg.tie_embeddings and "lm_head" not in params
        assert cfg.n_kv_heads == 1  # MQA

    def test_logits_match_hf(self, gemma_and_ours):
        model, _, _ = gemma_and_ours
        check_logits(model, np.array([[2, 45, 101, 7, 88, 131]], np.int64),
                     3e-4)


def test_unsupported_model_type_rejected():
    cfg = transformers.MistralConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=1,
        num_attention_heads=2, num_key_value_heads=1, intermediate_size=64,
    )
    with pytest.raises(NotImplementedError, match="model_type"):
        config_from_hf(cfg)
    with pytest.raises(NotImplementedError, match="model_type"):
        config_from_hf(cfg.to_dict())


class TestMixtralParity:
    @pytest.fixture(scope="class")
    def mixtral_and_ours(self):
        model = build_mixtral()
        cfg, params = from_hf_llama(model, dtype=torch.float32, device="cpu")
        return model, cfg, params

    def test_moe_config_mapped(self, mixtral_and_ours):
        _, cfg, params = mixtral_and_ours
        assert cfg.n_experts == 4 and cfg.n_experts_per_token == 2
        assert params["layers"]["w_gate"].shape == (2, 4, 64, 96)
        assert params["layers"]["w_down"].shape == (2, 4, 96, 64)
        assert params["layers"]["router"].shape == (2, 64, 4)

    def test_logits_match_hf(self, mixtral_and_ours):
        model, _, _ = mixtral_and_ours
        check_logits(model,
                     np.array([[3, 17, 54, 9, 88, 120, 7, 42]], np.int64),
                     3e-4)


def test_llama3_rope_scaling_mapped():
    scaling = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0,
               "original_max_position_embeddings": 8192}
    cfg = transformers.LlamaConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=1,
        num_attention_heads=2, num_key_value_heads=1, intermediate_size=64,
        rope_scaling=scaling)
    assert config_from_hf(cfg).rope_scaling == (8.0, 1.0, 4.0, 8192)
    assert config_from_hf({"model_type": "llama", "vocab_size": 64,
                           "rope_scaling": scaling}).rope_scaling \
        == (8.0, 1.0, 4.0, 8192)


def test_unknown_rope_scaling_type_rejected():
    cfg = transformers.LlamaConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=1,
        num_attention_heads=2, num_key_value_heads=1, intermediate_size=64,
        rope_scaling={"rope_type": "yarn", "factor": 4.0},
    )
    with pytest.raises(NotImplementedError, match="rope_scaling type"):
        config_from_hf(cfg)
    with pytest.raises(NotImplementedError, match="rope_scaling type"):
        config_from_hf({"model_type": "llama",
                        "rope_scaling": {"type": "linear", "factor": 2.0}})


class TestRopeScaling:
    def test_llama3_scaling_matches_hf(self):
        """The port's llama3 rope remapping reproduces transformers'
        logits and the reference's."""
        hf_cfg = transformers.LlamaConfig(
            vocab_size=128, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2,
            intermediate_size=128, max_position_embeddings=64,
            rms_norm_eps=1e-5, rope_theta=10_000.0, tie_word_embeddings=False,
            rope_scaling={"rope_type": "llama3", "factor": 8.0,
                          "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                          "original_max_position_embeddings": 32},
        )
        torch.manual_seed(2)
        model = transformers.LlamaForCausalLM(hf_cfg).eval()
        cfg = config_from_hf(hf_cfg)
        assert cfg.rope_scaling == (8.0, 1.0, 4.0, 32)
        params = params_from_hf_state_dict(cfg, model.state_dict(),
                                           dtype=torch.float32, device="cpu")
        ids = np.array([[3, 17, 54, 9, 88, 120, 7, 42, 11, 99]], np.int64)
        with torch.no_grad():
            hf = model(torch.from_numpy(ids)).logits.numpy()
        ours = port_logits(cfg, params, ids)[:, :, :128]
        np.testing.assert_allclose(hf, ours, rtol=3e-4, atol=3e-4)
        check_logits(model, ids, 3e-4)


def test_sliding_window_rejected():
    cfg = transformers.MixtralConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=1,
        num_attention_heads=2, num_key_value_heads=1, intermediate_size=64,
        num_local_experts=2, num_experts_per_tok=1,
        sliding_window=1024, max_position_embeddings=32768,
    )
    with pytest.raises(NotImplementedError, match="sliding_window"):
        config_from_hf(cfg)
    with pytest.raises(NotImplementedError, match="sliding_window"):
        config_from_hf(cfg.to_dict())


def _bare_server(aliases):
    from llm_instance_gateway_tpu_torch.server.api_http import ModelServer
    from llm_instance_gateway_tpu_torch.server.tokenizer import ByteTokenizer

    return ModelServer(None, ByteTokenizer(), "hf-llama", None,
                       aliases=aliases)


def test_preset_alias_still_served_with_checkpoint_name():
    """Both the checkpoint's own name and the CLI preset alias resolve."""
    from llm_instance_gateway_tpu_torch.server.api_http import HTTPError

    server = _bare_server({"llama3-tiny"})
    assert server.aliases == {"hf-llama", "llama3-tiny"}
    assert server._resolve_model("hf-llama") is None
    assert server._resolve_model("llama3-tiny") is None
    with pytest.raises(HTTPError) as err:
        server._resolve_model("ghost")
    assert err.value.status == 404


def test_adapter_name_colliding_with_alias_rejected():
    """An adapter named like a base-model alias answers 409, not a
    shadowed base model."""
    from llm_instance_gateway_tpu_torch.models.configs import TINY_TEST
    from llm_instance_gateway_tpu_torch.server.api_http import HTTPError
    from llm_instance_gateway_tpu_torch.server.lora_manager import LoRAManager

    server = _bare_server({"llama3-tiny"})
    server.lora = LoRAManager(TINY_TEST, dtype=torch.float32, device="cpu")
    for name in ("llama3-tiny", "hf-llama"):
        with pytest.raises(HTTPError) as err:
            server.load_adapter({"lora_name": name, "lora_path": "/nope"})
        assert err.value.status == 409
        assert "collides with the base model's served names" in str(
            err.value)


def test_llama2_mha_logits_match_hf():
    """Llama-2's shape (MHA: kv_heads == heads, theta 1e4)."""
    model = build_hf_llama(heads=4, kv_heads=4)
    cfg, _ = check_logits(
        model, np.array([[5, 9, 101, 33, 64, 2, 77, 18]], np.int64), 2e-4)
    assert cfg.n_kv_heads == cfg.n_heads == 4


class TestQwen2Parity:
    """Qwen2: learned q/k/v biases, held to Qwen2ForCausalLM."""

    @pytest.fixture(scope="class")
    def qwen_and_ours(self):
        model = build_qwen2()
        cfg, params = from_hf_llama(model, dtype=torch.float32, device="cpu")
        return model, cfg, params

    def test_bias_config_and_shapes(self, qwen_and_ours):
        _, cfg, params = qwen_and_ours
        assert cfg.attention_bias is True
        assert params["layers"]["wq_b"].shape == (2, 4 * 16)
        assert params["layers"]["wk_b"].shape == (2, 2 * 16)
        assert float(params["layers"]["wq_b"].abs().max()) > 0.01

    def test_logits_match_hf(self, qwen_and_ours):
        model, _, _ = qwen_and_ours
        check_logits(model,
                     np.array([[3, 17, 54, 9, 88, 120, 7, 42]], np.int64),
                     3e-4)

    def test_greedy_continuation_matches_hf(self, qwen_and_ours):
        model, cfg, params = qwen_and_ours
        ids = [5, 9, 31]
        with torch.no_grad():
            hf_out = model.generate(torch.tensor([ids]), max_new_tokens=6,
                                    do_sample=False)[0, len(ids):].tolist()
        assert port_greedy(cfg, params, ids, 6,
                           model.config.vocab_size) == hf_out


def test_qwen2_default_config_converts_despite_inactive_sliding_window():
    """Qwen2's sliding_window below max_position_embeddings with
    use_sliding_window False is full causal attention: it converts, from
    the object and from a dict that says so or omits the key."""
    kw = dict(vocab_size=64, hidden_size=32, num_hidden_layers=1,
              num_attention_heads=2, num_key_value_heads=1,
              intermediate_size=64, max_position_embeddings=32_768,
              sliding_window=4096, use_sliding_window=False)
    assert config_from_hf(transformers.Qwen2Config(**kw)).attention_bias
    d = {"model_type": "qwen2", **kw}
    assert config_from_hf(d).attention_bias
    del d["use_sliding_window"]
    assert config_from_hf(d).attention_bias
    with pytest.raises(NotImplementedError, match="sliding_window"):
        config_from_hf({**d, "use_sliding_window": True})


def test_llama_attention_bias_rejected():
    """HF llama attention_bias biases o_proj too: refused."""
    cfg = transformers.LlamaConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=1,
        num_attention_heads=2, num_key_value_heads=1, intermediate_size=64,
        attention_bias=True,
    )
    with pytest.raises(NotImplementedError, match="attention_bias"):
        config_from_hf(cfg)
    with pytest.raises(NotImplementedError, match="attention_bias"):
        config_from_hf(cfg.to_dict())


# ---------------------------------------------------------------------------
# Config routes and the checkpoint round trip
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", sorted(HF_MODELS))
def test_config_routes_agree(family, tmp_path):
    """``save_pretrained``'s config.json read as a dict (defaults from the
    model type's config class: Gemma's file has no tie_word_embeddings)
    gives the config object's ModelConfig, and the reference's."""
    model = HF_MODELS[family]()
    d = str(tmp_path / family)
    model.save_pretrained(d)
    with open(os.path.join(d, "config.json")) as f:
        raw = json.load(f)
    if family == "gemma":
        assert "tie_word_embeddings" not in raw
    obj = transformers.AutoConfig.from_pretrained(d)
    from_dict = config_from_hf({**raw, "_name_or_path": d})
    assert from_dict == config_from_hf(obj)
    assert dataclasses.asdict(from_dict) == dataclasses.asdict(
        jconvert.config_from_hf(obj))
    assert from_dict.name == d
    # The HF directory loads as a serving checkpoint with that config and
    # the tree from the model's own state dict.
    cfg, params = load_serving_checkpoint(d, torch.float32, "cpu")
    assert cfg == from_dict
    want = _flat(params_from_hf_state_dict(cfg, model.state_dict(),
                                           torch.float32, "cpu"))
    got = _flat(params)
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def _random_tree(name, dtype, seed=0):
    """Random weights as a conversion gives them: the padding rows past
    the vocabulary zero (an HF file has no such rows), norms and biases
    non-trivial."""
    cfg = CONFIGS[name]
    params = ttf.init_params(cfg, seed=seed, dtype=dtype, device="cpu")
    params["embed"][cfg.vocab_size:] = 0
    if "lm_head" in params:
        params["lm_head"][:, cfg.vocab_size:] = 0
    gen = torch.Generator().manual_seed(seed + 1)
    for key in ("wq_b", "wk_b", "wv_b", "attn_norm", "mlp_norm"):
        if key in params["layers"]:  # non-trivial biases and norms
            leaf = params["layers"][key]
            leaf.copy_(torch.randn(leaf.shape, generator=gen))
    params["final_norm"].copy_(torch.randn(params["final_norm"].shape,
                                           generator=gen))
    return cfg, params


ARCH_FIELDS = ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads",
               "d_ff", "resolved_head_dim", "rope_theta", "rope_scaling",
               "norm_eps", "max_seq_len", "tie_embeddings", "embedding_scale",
               "norm_plus_one", "gelu_mlp", "attention_bias", "n_experts",
               "n_experts_per_token")


@pytest.mark.parametrize("name,dtype", [
    ("llama3-tiny", torch.float32), ("llama3-tiny", torch.bfloat16),
    ("gemma-tiny", torch.bfloat16), ("mixtral-tiny", torch.bfloat16),
    ("qwen-tiny", torch.bfloat16)])
def test_save_load_round_trip(name, dtype, tmp_path):
    """``save_hf_checkpoint`` (sharded) -> ``load_serving_checkpoint``: the
    tree written, bit for bit, and the same architecture."""
    cfg, params = _random_tree(name, dtype)
    d = str(tmp_path / "hf")
    total = save_hf_checkpoint(cfg, params, d, shard_bytes=100_000)
    files = os.listdir(d)
    assert "model.safetensors.index.json" in files
    assert sum(f.endswith(".safetensors") for f in files) > 1
    with open(os.path.join(d, "model.safetensors.index.json")) as f:
        assert json.load(f)["metadata"]["total_size"] == total
    got_cfg, got = load_serving_checkpoint(d, dtype, "cpu")
    for field in ARCH_FIELDS:
        assert getattr(got_cfg, field) == getattr(cfg, field), field
    want, got = _flat(params), _flat(got)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == dtype
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("name", ["llama3-tiny", "mixtral-tiny"])
def test_int8_load_matches_quantize_params(name, tmp_path):
    """The layer-at-a-time int8 load equals ``quantize_params`` of the
    dense load, bit for bit."""
    cfg, params = _random_tree(name, torch.bfloat16, seed=3)
    d = str(tmp_path / "hf")
    save_hf_checkpoint(cfg, params, d)
    _, dense = load_serving_checkpoint(d, torch.bfloat16, "cpu")
    _, int8 = load_serving_checkpoint(d, torch.bfloat16, "cpu",
                                      quantize=True)
    want, got = _flat(quantize_params(dense)), _flat(int8)
    assert set(got) == set(want)
    assert ("layers", "w_down", "q") in got and ("lm_head", "s") in got
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key


def test_save_refuses_int8_tree(tmp_path):
    cfg, params = _random_tree("llama3-tiny", torch.float32)
    with pytest.raises(ValueError, match="int8"):
        save_hf_checkpoint(cfg, quantize_params(params), str(tmp_path / "q"))


def test_hf_config_dict_gives_the_config_back():
    """Every preset's config.json converts back to its architecture."""
    for name, cfg in CONFIGS.items():
        back = config_from_hf({**convert.hf_config_dict(cfg),
                               "_name_or_path": name})
        assert back.name == name
        for field in ARCH_FIELDS:
            assert getattr(back, field) == getattr(cfg, field), (name, field)
