"""HuggingFace checkpoints to the port's parameter tree, and back (port of
``models/convert.py``).

``config_from_hf`` and ``params_from_hf_state_dict`` are the reference's
mapping of Llama-2/3 (llama3 ``rope_scaling`` included), Gemma, Mixtral
and Qwen2 onto ``transformer.init_params``' stacked-layer tree, with the
reference's refusals.  ``load_serving_checkpoint`` is what ``api_http
--checkpoint`` / ``--draft-checkpoint`` read, by what the directory holds:

- an HF directory (``config.json`` with ``model.safetensors``, or shards
  with ``model.safetensors.index.json``), read by the port's own
  safetensors reader (``models/safetensors.py``): the route that needs no
  package beyond torch, so the one that runs on the card;
- the JAX package's serving checkpoint (``params/`` with
  ``model_config.json``, as ``save_hf_as_orbax`` writes it) or a bare
  Orbax params tree, read through ``models/orbax_tree.py``, which needs
  ``tensorstore``.

The tree is built one layer at a time on the device, into preallocated
stacks: each HF tensor is copied to the device and transposed and cast
there, so the host never holds a stacked or f32 copy of the model.  With
``quantize`` each layer of a projection is quantized as it lands, so the
result is ``quantize_params`` of the dense tree, bit for bit, without the
dense tree ever existing (Mixtral-8x7B's bf16 tree, ~93 GB, cannot be
loaded onto one 80 GB card otherwise).

``hf_state_dict_from_params`` and ``save_hf_checkpoint`` are the inverse:
they write the port's tree as an HF directory (the port's counterpart of
``save_hf_as_orbax``).  Nothing here imports ``transformers``: a config is
taken as a transformers object or as ``config.json``'s dict.
"""

from __future__ import annotations

import dataclasses
import json
import os
from types import SimpleNamespace
from typing import Any

import torch

from llm_instance_gateway_tpu_torch.models import orbax_tree
from llm_instance_gateway_tpu_torch.models import safetensors as st
from llm_instance_gateway_tpu_torch.models.configs import LLAMA3_8B, ModelConfig
from llm_instance_gateway_tpu_torch.models.weights import tensor_from_numpy
from llm_instance_gateway_tpu_torch.ops.quant import QUANT_TARGETS, quantize_weight

# The defaults of transformers 4.57.6's config classes for the keys
# ``config_from_hf`` reads.  ``save_pretrained`` drops a key whose value
# equals the base class's default (a GemmaConfig's ``tie_word_embeddings``
# True, for one), so a ``config.json`` read as a dict takes its absent
# keys from here, never from ``config_from_hf``'s own fallbacks.  None
# marks the values the class derives (see ``_config_view``); a key a class
# does not define is absent.
HF_DEFAULTS = {
    "llama": {
        "vocab_size": 32000, "hidden_size": 4096, "num_hidden_layers": 32,
        "num_attention_heads": 32, "num_key_value_heads": None,
        "intermediate_size": 11008, "head_dim": None, "rope_theta": 10000.0,
        "rms_norm_eps": 1e-6, "max_position_embeddings": 2048,
        "tie_word_embeddings": False, "rope_scaling": None,
        "attention_bias": False,
    },
    "gemma": {
        "vocab_size": 256000, "hidden_size": 3072, "num_hidden_layers": 28,
        "num_attention_heads": 16, "num_key_value_heads": 16,
        "intermediate_size": 24576, "head_dim": 256, "rope_theta": 10000.0,
        "rms_norm_eps": 1e-6, "max_position_embeddings": 8192,
        "tie_word_embeddings": True, "attention_bias": False,
    },
    "mixtral": {
        "vocab_size": 32000, "hidden_size": 4096, "num_hidden_layers": 32,
        "num_attention_heads": 32, "num_key_value_heads": 8,
        "intermediate_size": 14336, "head_dim": None,
        "rope_theta": 1000000.0, "rms_norm_eps": 1e-5,
        "max_position_embeddings": 131072, "tie_word_embeddings": False,
        "sliding_window": None, "num_local_experts": 8,
        "num_experts_per_tok": 2,
    },
    "qwen2": {
        "vocab_size": 151936, "hidden_size": 4096, "num_hidden_layers": 32,
        "num_attention_heads": 32, "num_key_value_heads": 32,
        "intermediate_size": 22016, "rope_theta": 10000.0,
        "rms_norm_eps": 1e-6, "max_position_embeddings": 32768,
        "tie_word_embeddings": False, "rope_scaling": None,
        "sliding_window": 4096, "use_sliding_window": False,
    },
}
_ARCHITECTURES = {"llama": "LlamaForCausalLM", "gemma": "GemmaForCausalLM",
                  "mixtral": "MixtralForCausalLM", "qwen2": "Qwen2ForCausalLM"}


def _config_view(d: dict) -> SimpleNamespace:
    """``config.json``'s dict as the attributes its transformers config
    object would have: absent keys take the class's defaults, and the
    values the class derives are derived as it does (``num_key_value_heads``
    None -> ``num_attention_heads``, Llama's ``head_dim`` None -> hidden /
    heads, Qwen2's ``sliding_window`` None unless ``use_sliding_window``).
    ``name_or_path`` is the dict's ``_name_or_path``."""
    model_type = d.get("model_type", "llama")
    v = {**HF_DEFAULTS.get(model_type, {}), **d, "model_type": model_type}
    if (model_type in ("llama", "mixtral", "qwen2")
            and v.get("num_key_value_heads") is None):
        v["num_key_value_heads"] = v["num_attention_heads"]
    if model_type == "llama" and v.get("head_dim") is None:
        v["head_dim"] = v["hidden_size"] // v["num_attention_heads"]
    if model_type == "qwen2" and not v.get("use_sliding_window"):
        v["sliding_window"] = None
    v["name_or_path"] = d.get("_name_or_path", "")
    return SimpleNamespace(**v)


def config_from_hf(hf_config) -> ModelConfig:
    """ModelConfig from a transformers Llama/Gemma/Mixtral/Qwen2 config
    object, or from its ``config.json`` dict (``_config_view``).

    Refused, as the reference refuses them: unknown model types,
    ``rope_scaling`` types other than llama3, an active sliding window
    (the decoder attends the full causal context) and ``attention_bias``
    outside qwen2.  The name is ``name_or_path``, else ``hf-<type>``."""
    if isinstance(hf_config, dict):
        hf_config = _config_view(hf_config)
    model_type = getattr(hf_config, "model_type", "llama")
    if model_type not in ("llama", "gemma", "mixtral", "qwen2"):
        raise NotImplementedError(
            f"HF model_type {model_type!r} not supported by the converter "
            "(llama, gemma, mixtral, qwen2 are)"
        )
    scaling_kwargs = {}
    rope_scaling = getattr(hf_config, "rope_scaling", None)
    if rope_scaling:
        rope_type = rope_scaling.get("rope_type", rope_scaling.get("type"))
        if rope_type != "llama3":
            raise NotImplementedError(
                f"rope_scaling type {rope_type!r} is not implemented "
                "(only 'llama3'); converting would silently change "
                "long-context frequencies"
            )
        scaling_kwargs = {
            "rope_scaling_factor": float(rope_scaling["factor"]),
            "rope_low_freq_factor": float(rope_scaling["low_freq_factor"]),
            "rope_high_freq_factor": float(rope_scaling["high_freq_factor"]),
            "rope_original_max_len": int(
                rope_scaling["original_max_position_embeddings"]),
        }
    sliding = getattr(hf_config, "sliding_window", None)
    max_pos = getattr(hf_config, "max_position_embeddings", 8192)
    # Qwen2 gates its window behind use_sliding_window: only an active
    # window diverges from the decoder's full causal attention.
    sliding_active = bool(getattr(hf_config, "use_sliding_window", True))
    if sliding and sliding_active and sliding < max_pos:
        raise NotImplementedError(
            f"sliding_window={sliding} < max_position_embeddings={max_pos}: "
            "our decoder attends the full causal context; converting would "
            "produce divergent long-context logits"
        )
    if model_type != "qwen2" and getattr(hf_config, "attention_bias", False):
        # Llama-style attention_bias also biases o_proj, which the tree
        # has no leaf for.
        raise NotImplementedError(
            f"attention_bias on model_type {model_type!r} is not supported "
            "(q/k/v/o biases; only the qwen2 q/k/v layout is implemented)"
        )
    gemma = model_type == "gemma"
    return dataclasses.replace(
        LLAMA3_8B,
        name=getattr(hf_config, "name_or_path", "") or f"hf-{model_type}",
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=getattr(hf_config, "num_key_value_heads",
                           hf_config.num_attention_heads),
        d_ff=hf_config.intermediate_size,
        head_dim=getattr(hf_config, "head_dim", 0)
        or hf_config.hidden_size // hf_config.num_attention_heads,
        rope_theta=getattr(hf_config, "rope_theta", 10_000.0),
        norm_eps=hf_config.rms_norm_eps,
        max_seq_len=getattr(hf_config, "max_position_embeddings", 8192),
        tie_embeddings=getattr(hf_config, "tie_word_embeddings", False),
        # Gemma: sqrt(d_model) embedding scale, (1+w) RMSNorm, GeLU gate.
        embedding_scale=gemma,
        norm_plus_one=gemma,
        gelu_mlp=gemma,
        n_experts=getattr(hf_config, "num_local_experts", 0)
        if model_type == "mixtral" else 0,
        n_experts_per_token=getattr(hf_config, "num_experts_per_tok", 2),
        # Qwen2: learned q/k/v biases (none on o_proj).
        attention_bias=(model_type == "qwen2"),
        **scaling_kwargs,
    )


def model_type_of(cfg: ModelConfig) -> str:
    """The HF ``model_type`` whose conversion gives ``cfg``'s flags."""
    gemma = (cfg.embedding_scale, cfg.norm_plus_one, cfg.gelu_mlp)
    if any(gemma) and not all(gemma):
        raise ValueError(f"{cfg.name}: the Gemma flags come together in HF "
                         f"configs, not as {gemma}")
    if sum((all(gemma), cfg.n_experts > 0, cfg.attention_bias)) > 1:
        raise ValueError(f"{cfg.name}: no HF model type has more than one "
                         "of Gemma's flags, experts and q/k/v biases")
    if all(gemma):
        return "gemma"
    if cfg.n_experts:
        return "mixtral"
    return "qwen2" if cfg.attention_bias else "llama"


def hf_config_dict(cfg: ModelConfig, torch_dtype: str = "bfloat16") -> dict:
    """``config.json`` for ``cfg``: every key ``config_from_hf`` reads, so
    it gives ``cfg`` back (but its name, which is the directory's)."""
    model_type = model_type_of(cfg)
    out = {
        "architectures": [_ARCHITECTURES[model_type]],
        "model_type": model_type,
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.d_model,
        "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "intermediate_size": cfg.d_ff,
        "head_dim": cfg.resolved_head_dim,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.norm_eps,
        "max_position_embeddings": cfg.max_seq_len,
        "tie_word_embeddings": cfg.tie_embeddings,
        "hidden_act": "gelu_pytorch_tanh" if cfg.gelu_mlp else "silu",
        "torch_dtype": torch_dtype,
    }
    if cfg.rope_scaling:
        factor, low, high, orig = cfg.rope_scaling
        out["rope_scaling"] = {
            "rope_type": "llama3", "factor": factor, "low_freq_factor": low,
            "high_freq_factor": high, "original_max_position_embeddings": orig}
    if model_type == "mixtral":
        out["num_local_experts"] = cfg.n_experts
        out["num_experts_per_tok"] = cfg.n_experts_per_token
    if model_type == "qwen2":
        out["use_sliding_window"] = False
    return out


# ---------------------------------------------------------------------------
# HF state dict -> params
# ---------------------------------------------------------------------------


def _stack(n: int, get, device, quant: bool):
    """A layer-stacked leaf from ``get(i)`` (layer ``i`` on ``device``, in
    the leaf's dtype), one layer at a time into a preallocated stack; with
    ``quant`` each layer is quantized as it lands (``_quantize_stacked``'s
    arithmetic, so the leaf equals quantizing the dense stack)."""
    first = get(0)
    if quant:
        out = {"q": torch.empty((n, *first.shape), dtype=torch.int8,
                                device=device),
               "s": torch.empty((n, *first.shape[:-2], first.shape[-1]),
                                dtype=torch.float32, device=device)}
    else:
        out = torch.empty((n, *first.shape), dtype=first.dtype,
                          device=device)
    for i in range(n):
        part = first if i == 0 else get(i)
        if quant:
            qs = quantize_weight(part)
            out["q"][i], out["s"][i] = qs["q"], qs["s"]
        else:
            out[i] = part
    return out


def params_from_hf_state_dict(cfg: ModelConfig, state_dict, dtype=torch.bfloat16,
                              device="cuda", quantize: bool = False) -> dict:
    """Map an HF state dict (name -> tensor or array) onto the stacked
    tree: HF Linear weights ``[out, in]`` become ``[in, out]``, the
    embedding and ``lm_head`` are padded to ``cfg.padded_vocab``, Qwen's
    1-D biases stack to ``[L, n]``, Mixtral's ``w1/w3/w2`` to
    ``w_gate/w_up/w_down [L, E, in, out]`` beside the ``router``.
    ``quantize`` gives ``quantize_params`` of that tree (see the module
    docstring)."""
    n_l = cfg.n_layers

    def src(name: str) -> torch.Tensor:
        try:
            t = state_dict[name]
        except KeyError:
            raise KeyError(f"the checkpoint has no tensor {name!r}") from None
        if not isinstance(t, torch.Tensor):
            return tensor_from_numpy(t, device)
        return t.to(device)

    def proj(name: str) -> torch.Tensor:  # [out, in] -> [in, out], dtype
        return src(name).t().to(dtype)

    def raw(name: str) -> torch.Tensor:  # norms and biases: no transpose
        return src(name).to(dtype)

    def stack(fmt: str, one=proj, quant: bool = False):
        return _stack(n_l, lambda i: one(fmt.format(i)), device, quant)

    def layer_experts(i: int, w_name: str) -> torch.Tensor:
        first = proj(f"model.layers.{i}.block_sparse_moe.experts.0."
                     f"{w_name}.weight")
        out = torch.empty((cfg.n_experts, *first.shape), dtype=dtype,
                          device=device)
        out[0] = first
        for e in range(1, cfg.n_experts):
            out[e] = proj(f"model.layers.{i}.block_sparse_moe.experts.{e}."
                          f"{w_name}.weight")
        return out

    q = set(QUANT_TARGETS) if quantize else set()
    pre = "model.layers.{}."
    layers = {
        "attn_norm": stack(pre + "input_layernorm.weight", raw),
        "mlp_norm": stack(pre + "post_attention_layernorm.weight", raw),
    }
    for name, hf in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"),
                     ("wo", "o_proj")):
        layers[name] = stack(pre + f"self_attn.{hf}.weight",
                             quant=name in q)
    if cfg.attention_bias:
        for name, hf in (("wq_b", "q_proj"), ("wk_b", "k_proj"),
                         ("wv_b", "v_proj")):
            layers[name] = stack(pre + f"self_attn.{hf}.bias", raw)
    if cfg.n_experts:
        layers["router"] = stack(pre + "block_sparse_moe.gate.weight")
        for name, hf in (("w_gate", "w1"), ("w_up", "w3"), ("w_down", "w2")):
            layers[name] = _stack(
                n_l, lambda i, hf=hf: layer_experts(i, hf), device, name in q)
    else:
        for name, hf in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                         ("w_down", "down_proj")):
            layers[name] = stack(pre + f"mlp.{hf}.weight", quant=name in q)
    embed = src("model.embed_tokens.weight")
    padded = torch.zeros((cfg.padded_vocab, cfg.d_model), dtype=dtype,
                         device=device)
    padded[: embed.shape[0]] = embed
    del embed  # its device copy: not held beside lm_head's
    params = {"embed": padded, "layers": layers,
              "final_norm": raw("model.norm.weight").clone()}
    if not cfg.tie_embeddings:
        head = src("lm_head.weight")
        padded_head = torch.zeros((cfg.d_model, cfg.padded_vocab),
                                  dtype=dtype, device=device)
        padded_head[:, : head.shape[0]] = head.t()
        params["lm_head"] = (quantize_weight(padded_head) if quantize
                             else padded_head)
    return params


def from_hf_llama(model, dtype=torch.bfloat16, device="cuda"):
    """(cfg, params) from a loaded transformers causal LM (its ``config``
    and ``state_dict()``; transformers itself is never imported here)."""
    cfg = config_from_hf(model.config)
    return cfg, params_from_hf_state_dict(cfg, model.state_dict(),
                                          dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# params -> HF directory
# ---------------------------------------------------------------------------


def hf_state_dict_from_params(cfg: ModelConfig, params: dict) -> dict:
    """The inverse mapping: HF names -> views of the tree's leaves (vocab
    unpadded, ``[in, out]`` transposed back to ``[out, in]``; nothing is
    copied).  A quantized tree is refused: HF checkpoints are dense."""
    def leaves(node):
        if isinstance(node, dict):
            if set(node) == {"q", "s"}:
                raise ValueError("an int8 {q, s} tree has no HF form; save "
                                 "the dense tree")
            for v in node.values():
                leaves(v)
    leaves(params)
    v, lp = cfg.vocab_size, params["layers"]
    out = {"model.embed_tokens.weight": params["embed"][:v]}
    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}."
        out[pre + "input_layernorm.weight"] = lp["attn_norm"][i]
        out[pre + "post_attention_layernorm.weight"] = lp["mlp_norm"][i]
        for name, hf in (("wq", "q_proj"), ("wk", "k_proj"),
                         ("wv", "v_proj"), ("wo", "o_proj")):
            out[pre + f"self_attn.{hf}.weight"] = lp[name][i].t()
        if cfg.attention_bias:
            for name, hf in (("wq_b", "q_proj"), ("wk_b", "k_proj"),
                             ("wv_b", "v_proj")):
                out[pre + f"self_attn.{hf}.bias"] = lp[name][i]
        if cfg.n_experts:
            moe = pre + "block_sparse_moe."
            out[moe + "gate.weight"] = lp["router"][i].t()
            for e in range(cfg.n_experts):
                for name, hf in (("w_gate", "w1"), ("w_up", "w3"),
                                 ("w_down", "w2")):
                    out[moe + f"experts.{e}.{hf}.weight"] = lp[name][i, e].t()
        else:
            for name, hf in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                             ("w_down", "down_proj")):
                out[pre + f"mlp.{hf}.weight"] = lp[name][i].t()
    out["model.norm.weight"] = params["final_norm"]
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = params["lm_head"][:, :v].t()
    return out


def save_hf_checkpoint(cfg: ModelConfig, params: dict, path: str,
                       shard_bytes: int = 5 * 10**9) -> int:
    """Write ``params`` as an HF directory: ``config.json``, then
    ``model.safetensors`` or, past ``shard_bytes``, shards
    ``model-0000i-of-0000n.safetensors`` filled in order up to
    ``shard_bytes`` each, with ``model.safetensors.index.json``.  Returns
    the bytes of tensor data written.  The rows past ``vocab_size`` (the
    padding) are not written: they load back as zeros."""
    state = hf_state_dict_from_params(cfg, params)
    dtype = params["embed"].dtype
    shards: list[dict] = [{}]
    size = 0
    for name, t in state.items():
        n = st.tensor_bytes(t)
        if shards[-1] and size + n > shard_bytes:
            shards.append({})
            size = 0
        shards[-1][name] = t
        size += n
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config_dict(cfg, str(dtype).removeprefix("torch.")),
                  f, indent=1)
    meta = {"format": "pt"}
    if len(shards) == 1:
        st.save_file(shards[0], os.path.join(path, st.SINGLE_FILE), meta)
        return sum(st.tensor_bytes(t) for t in state.values())
    weight_map = {}
    for i, shard in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        st.save_file(shard, os.path.join(path, fname), meta)
        weight_map.update({name: fname for name in shard})
    total = sum(st.tensor_bytes(t) for t in state.values())
    with open(os.path.join(path, st.INDEX_FILE), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=1)
    return total


# ---------------------------------------------------------------------------
# Serving checkpoints
# ---------------------------------------------------------------------------


def params_from_orbax(path: str, dtype=torch.bfloat16, device="cuda",
                      quantize: bool = False) -> dict:
    """The JAX package's params tree at ``path`` (an Orbax tree) on
    ``device``: floating leaves cast to ``dtype`` (an int8 ``{q, s}``
    leaf keeps its int8 and its f32 scale), leaves under ``layers`` read
    one layer at a time, and with ``quantize`` the projections and
    ``lm_head`` quantized as they land."""
    def load(leaf, stacked: bool, quant: bool = False, keep=None):
        def one(i=None):
            t = leaf.read(i).to(device)
            if keep is not None:
                return t.to(keep)
            return t.to(dtype) if t.is_floating_point() else t
        if stacked and len(leaf.shape) >= 2:
            return _stack(leaf.shape[0], one, device, quant)
        t = one()
        return quantize_weight(t) if quant else t

    def walk(node, keys):
        stacked = keys[:1] == ("layers",)
        if isinstance(node, dict) and set(node) == {"q", "s"}:
            return {"q": load(node["q"], stacked, keep=torch.int8),
                    "s": load(node["s"], stacked, keep=torch.float32)}
        if isinstance(node, dict):
            return {k: walk(v, keys + (k,)) for k, v in node.items()}
        quant = quantize and (
            (stacked and keys[-1] in QUANT_TARGETS) or keys == ("lm_head",))
        return load(node, stacked, quant)

    return walk(orbax_tree.open_tree(path), ())


def load_serving_checkpoint(path: str, dtype=torch.bfloat16, device="cuda",
                            quantize: bool = False) -> tuple[Any, dict]:
    """(cfg or None, params) from a checkpoint directory, by what it holds:
    an HF directory (its cfg from ``config.json``, named ``path`` as given,
    as ``AutoConfig.from_pretrained`` names it), ``params/`` with
    ``model_config.json`` (``ModelConfig(**json)``, as the reference
    restores it) or a bare Orbax params tree (no cfg).  Anything else is
    refused, naming both forms."""
    hf_config = os.path.join(path, "config.json")
    if st.is_checkpoint(path) and os.path.isfile(hf_config):
        with open(hf_config) as f:
            cfg = config_from_hf({**json.load(f), "_name_or_path": path})
        state = st.load_checkpoint(path)
        return cfg, params_from_hf_state_dict(cfg, state, dtype, device,
                                              quantize)
    cfg_file = os.path.join(path, "model_config.json")
    if os.path.isfile(cfg_file):
        with open(cfg_file) as f:
            cfg = ModelConfig(**json.load(f))
        return cfg, params_from_orbax(os.path.join(path, "params"), dtype,
                                      device, quantize)
    if orbax_tree.is_orbax_tree(path):
        return None, params_from_orbax(path, dtype, device, quantize)
    raise FileNotFoundError(
        f"{path}: not a serving checkpoint; expected an HF directory "
        f"(config.json with {st.SINGLE_FILE} or {st.INDEX_FILE} and its "
        "shards) or an Orbax tree (params/ with model_config.json, or a "
        f"bare params tree with {orbax_tree.METADATA})")
