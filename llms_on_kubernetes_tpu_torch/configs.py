"""Model configurations and registry (counterpart of ``llms_on_kubernetes_tpu/configs.py``).

A framework-free copy of the JAX package's ``ModelConfig``, its registry
and ``from_hf_config`` (a HuggingFace ``config.json`` to a ``ModelConfig``,
with every guard the JAX one has), kept here so the port never imports the
JAX package. The registry lists every text entry of the JAX one, dense
and MoE (``mixtral-8x7b``, ``qwen3-30b-a3b``, ``debug-moe``: the port's
MoE block is ``ops/moe.py``); the multimodal debug entries wait for the
vision tower.
``VisionConfig`` is a copy of the JAX dataclass's fields, so that
``from_hf_config`` describes a multimodal checkpoint as the JAX one does;
the port loads no vision tower (``engine/weights.load_hf_params`` refuses
one).
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """The fields of ``llms_on_kubernetes_tpu/models/vision.VisionConfig``."""
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    image_size: int
    patch_size: int
    num_channels: int = 3
    layer_norm_eps: float = 1e-6
    mm_tokens_per_image: int = 256
    family: str = "siglip"
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    out_hidden_size: int = 0
    num_grid_per_side: int = 48
    deepstack_indexes: tuple = ()


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
    vision: Optional[VisionConfig] = None
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
# registry name -> first registered HF repo id, original case (the cache
# directory of a snapshot is named after it)
CANONICAL_HF_IDS: dict[str, str] = {}


def _register(cfg: ModelConfig, *hf_ids: str) -> ModelConfig:
    REGISTRY[cfg.name] = cfg
    for hf_id in hf_ids:
        ALIASES[hf_id.lower()] = cfg.name
    if hf_ids:
        CANONICAL_HF_IDS[cfg.name] = hf_ids[0]
    return cfg


def hf_repo_for(model_ref: str) -> Optional[str]:
    """Canonical HF repo id for a model reference, or None: a registry name
    or a known alias resolves through its first registered repo id, a ref
    shaped ``namespace/name`` is returned as it is, and a path-like ref
    (``/``, ``.`` or ``~`` first) gives None."""
    if model_ref.startswith((".", "/", "~")):
        return None
    key = model_ref if model_ref in REGISTRY else ALIASES.get(model_ref.lower())
    if key:
        return CANONICAL_HF_IDS.get(key)
    if re.fullmatch(r"[\w.\-]+/[\w.\-]+", model_ref):
        return model_ref
    return None


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
        "mixtral-8x7b",
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
        rope_theta=1000000.0, max_position_embeddings=32768,
        num_experts=8, num_experts_per_tok=2,
    ),
    "mistralai/Mixtral-8x7B-v0.1", "mistralai/Mixtral-8x7B-Instruct-v0.1",
)
_register(
    ModelConfig(
        "phi-3-mini",
        vocab_size=32064, hidden_size=3072, intermediate_size=8192,
        num_layers=32, num_heads=32, num_kv_heads=32, head_dim=96,
        rope_theta=10000.0, max_position_embeddings=4096,
        sliding_window=2047,
    ),
    "microsoft/Phi-3-mini-4k-instruct",
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
# Text backbone of the reference's second default model (Qwen3-VL-30B):
# the Qwen3-MoE decoder, 128 experts, top-8, q/k norms.
_register(
    ModelConfig(
        "qwen3-30b-a3b",
        vocab_size=151936, hidden_size=2048, intermediate_size=768,
        num_layers=48, num_heads=32, num_kv_heads=4, head_dim=128,
        rope_theta=1000000.0, max_position_embeddings=40960,
        qk_norm=True, rms_norm_eps=1e-6,
        num_experts=128, num_experts_per_tok=8,
    ),
    "Qwen/Qwen3-30B-A3B",
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
_register(
    ModelConfig(
        "gemma-3-27b",
        vocab_size=262208, hidden_size=5376, intermediate_size=21504,
        num_layers=62, num_heads=32, num_kv_heads=16, head_dim=128,
        rope_theta=1000000.0, max_position_embeddings=131072,
        hidden_act="gelu_tanh", norm_style="gemma", post_norms=True,
        qk_norm=True, embedding_multiplier=5376 ** 0.5,
        tie_word_embeddings=True, rms_norm_eps=1e-6,
        # 5 local (window 1024, theta 1e4) layers per global one; query
        # scale 1/sqrt(hidden / num_heads)
        sliding_window=1024, sliding_window_pattern=6, rope_local_theta=10000.0,
        query_pre_attn_scalar=5376.0 / 32,
        # global layers scale rope linearly (factor 8)
        rope_scaling={"rope_type": "linear", "factor": 8.0},
    ),
    "google/gemma-3-27b-it",
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

_register(
    ModelConfig(
        "debug-moe",
        vocab_size=256, hidden_size=64, intermediate_size=96,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
        max_position_embeddings=512, num_experts=4, num_experts_per_tok=2,
    ),
)


def get_config(name: str) -> ModelConfig:
    key = name if name in REGISTRY else ALIASES.get(name.lower(), name)
    if key not in REGISTRY:
        raise KeyError(f"unknown model config {name!r}; known: {sorted(REGISTRY)} "
                       f"(or pass a checkpoint directory, read by from_hf_config)")
    return REGISTRY[key]


# ---------------------------------------------------------------------------
# HuggingFace config.json -> ModelConfig
# ---------------------------------------------------------------------------

def from_hf_config(hf: dict | str, name: str = "hf-model") -> ModelConfig:
    """Build a ModelConfig from a HuggingFace ``config.json`` dict or path,
    as the JAX ``from_hf_config`` does. Raises NotImplementedError for what
    the decoder does not express: rope scaling other than llama3 and
    linear (yarn, longrope), scaled or sectioned mrope, and qwen3_moe
    without renormalized top-k or with dense layers interleaved."""
    if isinstance(hf, str):
        with open(hf) as f:
            hf = json.load(f)
    outer = hf  # multimodal wrappers keep vision and image-token info out here
    # gemma3 wraps the text config
    if "text_config" in hf and isinstance(hf["text_config"], dict):
        merged = dict(hf["text_config"])
        merged.setdefault("model_type", hf.get("model_type", ""))
        hf = merged
    model_type = hf.get("model_type", "llama")
    hidden = int(hf["hidden_size"])
    heads = int(hf["num_attention_heads"])
    head_dim = int(hf.get("head_dim") or hidden // heads)
    kw: dict[str, Any] = dict(
        name=name,
        vocab_size=int(hf["vocab_size"]),
        hidden_size=hidden,
        intermediate_size=int(hf["intermediate_size"]),
        num_layers=int(hf["num_hidden_layers"]),
        num_heads=heads,
        num_kv_heads=int(hf.get("num_key_value_heads") or heads),
        head_dim=head_dim,
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        rms_norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        max_position_embeddings=int(hf.get("max_position_embeddings", 8192)),
        tie_word_embeddings=bool(hf.get("tie_word_embeddings", False)),
        sliding_window=hf.get("sliding_window"),
    )
    scaling = hf.get("rope_scaling")
    if isinstance(scaling, dict):
        kind = scaling.get("rope_type", scaling.get("type"))
        if "mrope_section" in scaling:
            # Qwen3-VL multimodal rope: unscaled frequencies, interleaved
            # over three axes; a scaling scheme beside it is not expressed
            if kind not in (None, "default"):
                raise NotImplementedError(
                    f"rope_scaling type {kind!r} combined with "
                    f"mrope_section is not supported yet")
            if not scaling.get("mrope_interleaved", True):
                raise NotImplementedError(
                    "non-interleaved (sectioned) mrope is not supported "
                    "yet; only mrope_interleaved=true")
            kw["mrope_section"] = tuple(int(x) for x in scaling["mrope_section"])
        elif kind in ("llama3", "linear"):
            kw["rope_scaling"] = scaling
        elif kind is not None and kind != "default":
            # serving with a dropped scaling scheme would put positions wrong
            raise NotImplementedError(
                f"rope_scaling type {kind!r} is not supported yet"
            )
    if model_type in ("qwen2",):
        kw["attention_bias"] = True
    if model_type in ("qwen3", "qwen3_vl", "qwen3_vl_text"):
        kw["qk_norm"] = True
    if model_type in ("mixtral",):
        kw["num_experts"] = int(hf.get("num_local_experts", 8))
        kw["num_experts_per_tok"] = int(hf.get("num_experts_per_tok", 2))
    if model_type in ("qwen3_moe", "qwen3_vl_moe", "qwen3_vl_moe_text"):
        # HF's Qwen3MoeConfig defaults norm_topk_prob to False, which the
        # MoE block (it renormalizes the top-k weights) does not express
        if not hf.get("norm_topk_prob", False):
            raise NotImplementedError(
                "qwen3_moe with norm_topk_prob=false is not supported "
                "(the MoE block renormalizes top-k routing weights)")
        if int(hf.get("decoder_sparse_step", 1)) != 1 or hf.get("mlp_only_layers"):
            raise NotImplementedError(
                "qwen3_moe with dense layers interleaved "
                "(decoder_sparse_step != 1 or mlp_only_layers) is not supported")
        kw["qk_norm"] = True
        kw["num_experts"] = int(hf.get("num_experts", 128))
        kw["num_experts_per_tok"] = int(hf.get("num_experts_per_tok", 8))
        # experts use moe_intermediate_size, not the dense intermediate
        kw["intermediate_size"] = int(
            hf.get("moe_intermediate_size", hf["intermediate_size"]))
    if hf.get("query_pre_attn_scalar") is not None:
        kw["query_pre_attn_scalar"] = float(hf["query_pre_attn_scalar"])
    if model_type.startswith("gemma"):
        kw.update(
            hidden_act="gelu_tanh", norm_style="gemma",
            embedding_multiplier=hidden ** 0.5,
            tie_word_embeddings=bool(hf.get("tie_word_embeddings", True)),
        )
        if model_type in ("gemma2", "gemma3", "gemma3_text"):
            kw["post_norms"] = True
        if model_type == "gemma2":
            kw["logit_softcap"] = float(hf.get("final_logit_softcapping") or 30.0)
            kw["attn_softcap"] = float(hf.get("attn_logit_softcapping") or 50.0)
            kw["sliding_window_pattern"] = 2
            kw["rope_local_theta"] = float(hf.get("rope_theta", 10000.0))
        if model_type in ("gemma3", "gemma3_text"):
            kw["qk_norm"] = True
            kw["sliding_window_pattern"] = int(hf.get("sliding_window_pattern", 6))
            kw["rope_local_theta"] = float(hf.get("rope_local_base_freq", 10000.0))
    # multimodal wrapper (qwen3_vl): images resized to a fixed square
    vc = outer.get("vision_config")
    if isinstance(vc, dict) and outer.get("model_type") in ("qwen3_vl", "qwen3_vl_moe"):
        patch = int(vc.get("patch_size", 16))
        merge = int(vc.get("spatial_merge_size", 2))
        image_size = int(vc.get("image_size") or 768)
        image_size -= image_size % (patch * merge)
        kw["vision"] = VisionConfig(
            hidden_size=int(vc.get("hidden_size", 1152)),
            intermediate_size=int(vc.get("intermediate_size", 4304)),
            num_layers=int(vc.get("depth", 27)),
            num_heads=int(vc.get("num_heads", 16)),
            image_size=image_size,
            patch_size=patch,
            num_channels=int(vc.get("in_channels", 3)),
            family="qwen3vl",
            temporal_patch_size=int(vc.get("temporal_patch_size", 2)),
            spatial_merge_size=merge,
            out_hidden_size=int(vc.get("out_hidden_size", hidden)),
            num_grid_per_side=int(
                round(vc.get("num_position_embeddings", 2304) ** 0.5)),
            deepstack_indexes=tuple(vc.get("deepstack_visual_indexes", ())),
            mm_tokens_per_image=(image_size // (patch * merge)) ** 2,
        )
        kw["image_token_id"] = int(outer.get("image_token_id", 151655))
        kw["boi_token_id"] = int(outer.get("vision_start_token_id", 151652))
        kw["eoi_token_id"] = int(outer.get("vision_end_token_id", 151653))
    # multimodal wrapper (gemma3): vision tower and image token ids
    if isinstance(vc, dict) and outer.get("model_type") == "gemma3":
        kw["vision"] = VisionConfig(
            hidden_size=int(vc.get("hidden_size", 1152)),
            intermediate_size=int(vc.get("intermediate_size", 4304)),
            num_layers=int(vc.get("num_hidden_layers", 27)),
            num_heads=int(vc.get("num_attention_heads", 16)),
            image_size=int(vc.get("image_size", 896)),
            patch_size=int(vc.get("patch_size", 14)),
            num_channels=int(vc.get("num_channels", 3)),
            layer_norm_eps=float(vc.get("layer_norm_eps", 1e-6)),
            mm_tokens_per_image=int(outer.get("mm_tokens_per_image", 256)),
        )
        kw["image_token_id"] = int(outer.get("image_token_index", 262144))
        kw["boi_token_id"] = int(outer.get("boi_token_index", 255999))
        kw["eoi_token_id"] = int(outer.get("eoi_token_index", 256000))
    return ModelConfig(**kw)
