"""Model architecture configs (the port's own copy of the reference's).

Same dataclass, same presets and the same ``tiny()`` shrink as
``llm_instance_gateway_tpu/models/configs.py``, so a config names the same
architecture in both packages.  The port serves the dense Llama path;
``models/transformer.py`` raises on MoE and attention-bias configs.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


def pad_to(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    rope_theta: float = 500_000.0
    # Llama-3.1 long-context rope scaling (factor 0 = disabled).
    rope_scaling_factor: float = 0.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_len: int = 8192
    norm_eps: float = 1e-5
    max_seq_len: int = 8192
    # Gemma-style differences.
    tie_embeddings: bool = False
    embedding_scale: bool = False
    norm_plus_one: bool = False
    gelu_mlp: bool = False
    # Qwen2-family q/k/v biases (not served by the port yet).
    attention_bias: bool = False
    # MoE (not served by the port yet): 0 experts = dense.
    n_experts: int = 0
    n_experts_per_token: int = 2
    moe_capacity_factor: float = 1.25
    moe_exact_fallback: bool = True
    # LoRA serving slots (vLLM's --max-loras / max rank).
    max_lora_slots: int = 4
    max_lora_rank: int = 16
    # Field parity with the reference.  The port has no fallback to switch
    # to: its attention always runs through the kernel wrappers (the plain
    # versions on CPU tensors), and models/transformer.py raises on False.
    use_flash_attention: bool = True
    use_pallas_decode: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, 128)

    @property
    def rope_scaling(self) -> tuple | None:
        """(factor, low_ff, high_ff, original_max) or None when disabled."""
        if not self.rope_scaling_factor:
            return None
        return (
            self.rope_scaling_factor,
            self.rope_low_freq_factor,
            self.rope_high_freq_factor,
            self.rope_original_max_len,
        )

    def tiny(self) -> "ModelConfig":
        """Shrink to test size, keeping structure (ratios, GQA)."""
        return replace(
            self,
            name=self.name + "-tiny",
            vocab_size=320,
            d_model=64,
            n_layers=2,
            n_heads=4,
            n_kv_heads=max(1, self.n_kv_heads * 4 // self.n_heads),
            d_ff=128,
            head_dim=16,
            max_seq_len=128,
            max_lora_rank=4,
        )


LLAMA2_7B = ModelConfig(
    name="llama2-7b",
    vocab_size=32_000,
    d_model=4096,
    n_layers=32,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11_008,
    rope_theta=10_000.0,
    max_seq_len=4096,
)

LLAMA3_8B = ModelConfig(
    name="llama3-8b",
    vocab_size=128_256,
    d_model=4096,
    n_layers=32,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    rope_theta=500_000.0,
    max_seq_len=8192,
)

TINY_TEST = LLAMA3_8B.tiny()

# The server's --model presets (the reference's llama.CONFIGS).
CONFIGS = {
    "llama2-7b": LLAMA2_7B,
    "llama2-tiny": LLAMA2_7B.tiny(),
    "llama3-8b": LLAMA3_8B,
    "llama3-tiny": TINY_TEST,
}
