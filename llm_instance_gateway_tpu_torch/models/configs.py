"""Model architecture configs (the port's own copy of the reference's).

Same dataclass, same presets and the same ``tiny()`` shrink as
``llm_instance_gateway_tpu/models/configs.py``, so a config names the same
architecture in both packages, and ``CONFIGS`` offers the reference's
``--model`` presets: Llama, Gemma, Mixtral (MoE) and Qwen2 (q/k/v biases).
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
    # Qwen2-family learned q/k/v biases (attention only).
    attention_bias: bool = False
    # MoE (Mixtral): 0 experts = dense.  Expert capacity, the dense/grouped
    # gate and the exact fallback: ``models/transformer._moe_mlp``.
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

GEMMA_2B = ModelConfig(
    name="gemma-2b",
    vocab_size=256_128,
    d_model=2048,
    n_layers=18,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16_384,
    head_dim=256,
    rope_theta=10_000.0,
    tie_embeddings=True,
    embedding_scale=True,
    norm_plus_one=True,
    gelu_mlp=True,
    max_seq_len=8192,
)

GEMMA_7B = ModelConfig(
    name="gemma-7b",
    vocab_size=256_128,
    d_model=3072,
    n_layers=28,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24_576,
    rope_theta=10_000.0,
    tie_embeddings=True,
    embedding_scale=True,
    norm_plus_one=True,
    gelu_mlp=True,
    max_seq_len=8192,
)

MIXTRAL_8X7B = ModelConfig(
    name="mixtral-8x7b",
    vocab_size=32_000,
    d_model=4096,
    n_layers=32,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    rope_theta=1_000_000.0,
    n_experts=8,
    n_experts_per_token=2,
    max_seq_len=32_768,
)

QWEN2_5_7B = ModelConfig(
    name="qwen2.5-7b",
    vocab_size=152_064,
    d_model=3584,
    n_layers=28,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18_944,
    head_dim=128,
    rope_theta=1_000_000.0,
    norm_eps=1e-6,
    attention_bias=True,
    max_seq_len=32_768,
)

TINY_TEST = LLAMA3_8B.tiny()
TINY_MOE_TEST = MIXTRAL_8X7B.tiny()
TINY_QWEN_TEST = QWEN2_5_7B.tiny()

# The server's --model presets: the reference's llama, gemma, mixtral and
# qwen ``CONFIGS``, merged as its api_http merges them.
CONFIGS = {
    "llama2-7b": LLAMA2_7B,
    "llama2-tiny": LLAMA2_7B.tiny(),
    "llama3-8b": LLAMA3_8B,
    "llama3-tiny": TINY_TEST,
    "gemma-2b": GEMMA_2B,
    "gemma-7b": GEMMA_7B,
    "gemma-tiny": GEMMA_2B.tiny(),
    "mixtral-8x7b": MIXTRAL_8X7B,
    "mixtral-tiny": TINY_MOE_TEST,
    "qwen2.5-7b": QWEN2_5_7B,
    "qwen-tiny": TINY_QWEN_TEST,
}
