"""Model configurations and registry (counterpart of ``llms_on_kubernetes_tpu/configs.py``).

A framework-free copy of the JAX package's ``ModelConfig`` and its registry,
kept here so the port never imports the JAX package. Only the text decoder
families are listed: the multimodal entries need a vision tower this port
does not have yet, and ``from_hf_config`` waits for the checkpoint loader.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 8192
    tie_word_embeddings: bool = False
    attention_bias: bool = False            # Qwen2-style qkv bias
    sliding_window: Optional[int] = None    # Mistral-style SWA
    # Gemma-2/3 interleaved attention: layer i is GLOBAL iff (i+1) % pattern == 0,
    # else local (sliding_window). None => all layers use `sliding_window` as-is.
    sliding_window_pattern: Optional[int] = None
    rope_local_theta: Optional[float] = None  # theta for local layers (gemma3: 1e4)
    # attention logit scale = query_pre_attn_scalar**-0.5 if set, else head_dim**-0.5
    query_pre_attn_scalar: Optional[float] = None
    # MoE (Mixtral)
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_capacity_factor: Optional[float] = None
    # activation / norm variants
    hidden_act: str = "silu"                # silu | gelu_tanh
    norm_style: str = "llama"               # llama: x*w ; gemma: x*(1+w)
    post_norms: bool = False                # gemma2/3 post-attn/post-mlp norms
    qk_norm: bool = False                   # qwen3 / gemma3 per-head q/k RMSNorm
    logit_softcap: Optional[float] = None   # gemma2
    attn_softcap: Optional[float] = None    # gemma2
    embedding_multiplier: Optional[float] = None  # gemma: sqrt(hidden_size)
    rope_scaling: Optional[dict] = dataclasses.field(default=None, hash=False)
    dtype: str = "bfloat16"
    vision: "Optional[Any]" = None
    image_token_id: Optional[int] = None
    boi_token_id: Optional[int] = None
    eoi_token_id: Optional[int] = None
    mrope_section: Optional[tuple] = None

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def num_params(self) -> int:
        """Approximate parameter count (for memory budgeting)."""
        d, f, v, L = self.hidden_size, self.intermediate_size, self.vocab_size, self.num_layers
        attn = d * self.q_dim * 2 + d * self.kv_dim * 2
        if self.is_moe:
            mlp = 3 * d * f * self.num_experts + d * self.num_experts
        else:
            mlp = 3 * d * f
        embed = v * d * (1 if self.tie_word_embeddings else 2)
        return L * (attn + mlp) + embed


REGISTRY: dict[str, ModelConfig] = {}
ALIASES: dict[str, str] = {}


def _register(cfg: ModelConfig, *hf_ids: str) -> ModelConfig:
    REGISTRY[cfg.name] = cfg
    for hf_id in hf_ids:
        ALIASES[hf_id.lower()] = cfg.name
    return cfg


LLAMA3_ROPE_SCALING = {
    "rope_type": "llama3",
    "factor": 8.0,
    "low_freq_factor": 1.0,
    "high_freq_factor": 4.0,
    "original_max_position_embeddings": 8192,
}

_register(
    ModelConfig(
        "llama-3-8b",
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
        rope_theta=500000.0, max_position_embeddings=8192,
    ),
    "meta-llama/Meta-Llama-3-8B", "meta-llama/Meta-Llama-3-8B-Instruct",
)
_register(
    ModelConfig(
        "llama-3-70b",
        vocab_size=128256, hidden_size=8192, intermediate_size=28672,
        num_layers=80, num_heads=64, num_kv_heads=8, head_dim=128,
        rope_theta=500000.0, max_position_embeddings=8192,
    ),
    "meta-llama/Meta-Llama-3-70B", "meta-llama/Meta-Llama-3-70B-Instruct",
)
_register(
    ModelConfig(
        "llama-3.1-8b",
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
        rope_theta=500000.0, max_position_embeddings=131072,
        rope_scaling=LLAMA3_ROPE_SCALING,
    ),
    "meta-llama/Llama-3.1-8B", "meta-llama/Llama-3.1-8B-Instruct",
)
_register(
    ModelConfig(
        "tinyllama-1.1b",
        vocab_size=32000, hidden_size=2048, intermediate_size=5632,
        num_layers=22, num_heads=32, num_kv_heads=4, head_dim=64,
        rope_theta=10000.0, max_position_embeddings=2048,
    ),
    "TinyLlama/TinyLlama-1.1B-Chat-v1.0",
)
_register(
    ModelConfig(
        "mistral-7b",
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
        rope_theta=10000.0, max_position_embeddings=32768,
        sliding_window=4096,
    ),
    "mistralai/Mistral-7B-v0.1", "mistralai/Mistral-7B-Instruct-v0.1",
)
_register(
    ModelConfig(
        "mistral-7b-v0.2",
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
        rope_theta=1000000.0, max_position_embeddings=32768,
    ),
    "mistralai/Mistral-7B-Instruct-v0.2", "mistralai/Mistral-7B-Instruct-v0.3",
)
_register(
    ModelConfig(
        "qwen2.5-7b",
        vocab_size=152064, hidden_size=3584, intermediate_size=18944,
        num_layers=28, num_heads=28, num_kv_heads=4, head_dim=128,
        rope_theta=1000000.0, max_position_embeddings=32768,
        attention_bias=True, tie_word_embeddings=False,
    ),
    "Qwen/Qwen2.5-7B-Instruct",
)
_register(
    ModelConfig(
        "qwen3-8b",
        vocab_size=151936, hidden_size=4096, intermediate_size=12288,
        num_layers=36, num_heads=32, num_kv_heads=8, head_dim=128,
        rope_theta=1000000.0, max_position_embeddings=40960,
        qk_norm=True, rms_norm_eps=1e-6,
    ),
    "Qwen/Qwen3-8B",
)
_register(
    ModelConfig(
        "gemma-2-9b",
        vocab_size=256000, hidden_size=3584, intermediate_size=14336,
        num_layers=42, num_heads=16, num_kv_heads=8, head_dim=256,
        rope_theta=10000.0, max_position_embeddings=8192,
        hidden_act="gelu_tanh", norm_style="gemma", post_norms=True,
        logit_softcap=30.0, attn_softcap=50.0,
        embedding_multiplier=3584 ** 0.5, tie_word_embeddings=True,
        rms_norm_eps=1e-6,
        sliding_window=4096, sliding_window_pattern=2, rope_local_theta=10000.0,
        query_pre_attn_scalar=256.0,
    ),
    "google/gemma-2-9b-it",
)

# Tiny configs for tests / local CPU smoke runs.
_register(
    ModelConfig(
        "debug-tiny",
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
        max_position_embeddings=512,
    ),
)
_register(
    ModelConfig(
        "debug-byte",
        vocab_size=258, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
        max_position_embeddings=512,
    ),
)
_register(
    ModelConfig(
        "debug-gemma",
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=4, num_heads=4, num_kv_heads=2, head_dim=16,
        max_position_embeddings=512,
        hidden_act="gelu_tanh", norm_style="gemma", post_norms=True,
        qk_norm=True, embedding_multiplier=8.0, tie_word_embeddings=True,
        sliding_window=8, sliding_window_pattern=2, rope_local_theta=10000.0,
        rope_theta=1000000.0, query_pre_attn_scalar=24.0,
    ),
)


def get_config(name: str) -> ModelConfig:
    key = name if name in REGISTRY else ALIASES.get(name.lower(), name)
    if key not in REGISTRY:
        raise KeyError(f"unknown model config {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[key]
