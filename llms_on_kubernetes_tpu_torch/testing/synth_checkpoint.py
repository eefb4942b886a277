"""Write a HuggingFace-format safetensors checkpoint of a registry model
(dense, MoE or multimodal), at its full width, with cheap deterministic
values.

    python -m llms_on_kubernetes_tpu_torch.testing.synth_checkpoint phi-3-mini OUT_DIR \
        [--fp8 | --awq] [--tokenizer llama3|phi3|gemma3|qwen3vl] [--layers N] \
        [--legacy-naming]

Neither machine this repository runs on can download the published
weights, so the card's run serves a checkpoint this module writes: the
HF ``config.json`` of the family (which ``configs.from_hf_config`` reads
back to the registry entry), the family's own tensor names and HF layouts
(phi-3's fused ``qkv_proj`` and ``gate_up_proj``, gemma's four norms a
layer, qwen2's attention biases, qwen3's q/k norms; an MoE model's
router and experts in Mixtral's ``block_sparse_moe.{gate,
experts.N.w1/w2/w3}`` or, with q/k norms, Qwen3-MoE's ``mlp.{gate,
experts.N.*_proj}``), sharded
``*.safetensors`` files with a ``model.safetensors.index.json``, in
bfloat16 (or float32/float16). Each file is a JSON header and raw bytes,
written tensor by tensor with numpy, so memory holds one tensor at a time.

``quantization="fp8"`` writes a compressed-tensors FP8 checkpoint, as
FP8-Dynamic models ship: each decoder-layer linear (an MoE model's experts
too; not its router, nor a multimodal model's tower) as ``F8_E4M3`` codes
with a float32 ``weight_scale`` per output channel (``[out, 1]``, amax /
448) or per tensor (a scalar), the embedding, norms and LM head in the
checkpoint dtype, and a ``quantization_config`` in ``config.json``. The
fp8 codes are PyTorch's float8_e4m3fn rounding of the pattern over its
scale (``fp8_value``).

``quantization="awq"`` writes an AWQ checkpoint as ``Qwen/Qwen3-8B-AWQ``
ships one: each decoder-layer linear (as for fp8) as ``qweight`` int32 ``[in, out/8]``
(eight 4-bit values a word in AWQ's nibble interleave), ``qzeros`` int32
``[G, out/8]`` and ``scales`` float16 ``[G, out]`` for G groups of
``group_size`` input rows, with the ``quantization_config`` that
checkpoint publishes (``awq_quantization_config``). The words are seeded
random payloads (``awq_value``): every nibble 0..15, zero points 6..9,
scales about ``1 / (4.6 sqrt(in))``, so a dequantized weight has the
spread of a trained one.

Values are a pattern, not draws: 65,536 normal values from ``seed``,
rotated by a hash of the tensor's name, tiled over its shape and scaled by
``1/sqrt(fan_in)`` (norm weights near 1, or near 0 for gemma's ``1 + w``
norms; biases small). Billions of random draws would cost minutes and
change nothing a load or a serve measures. ``tensor_value`` recomputes any
tensor, so a reader can be held to exactly what was written.

A multimodal config (``cfg.vision``) is written as its wrapper checkpoint:
gemma-3's (``Gemma3ForConditionalGeneration``: ``text_config``,
``vision_config``, the image token ids; the text model under
``model.language_model.*``, the SigLIP tower under
``model.vision_tower.vision_model.*`` and the projector under
``model.multi_modal_projector.*``, or with ``naming="legacy"`` the older
``language_model.model.*``, ``vision_tower.*`` and
``multi_modal_projector.*``) or Qwen3-VL's (``qwen3_vl`` /
``qwen3_vl_moe``: interleaved ``mrope_section`` in the text config's
``rope_scaling``, the tower, merger and DeepStack mergers under
``model.visual.*``). ``from_hf_config`` reads either back to the config.

``tokenizer="llama3"`` or ``"phi3"`` also writes ``tokenizer.json`` and
``tokenizer_config.json`` in that family's published format (see
``tokenizer_files``): a byte vocabulary and a few thousand merges that a
small pure-Python BPE trainer learns from the repository's ``SURVEY.md``,
the special tokens at their published ids and the published chat
template, with no ``tokenizers`` needed. ``TOKENIZER_PROBES`` holds the
ids ``transformers`` gives over those files for ``PROBE_TEXTS`` and
``PROBE_CHAT``.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
import json
import os
import sys
import unicodedata
import zlib

import numpy as np

from llms_on_kubernetes_tpu_torch.configs import (
    PUBLISHED_MM_CONFIGS, ModelConfig, from_hf_config, get_config,
)

PATTERN = 65536
# checkpoint dtype -> (safetensors dtype, bytes an element)
DTYPES = {"bfloat16": ("BF16", 2), "float16": ("F16", 2), "float32": ("F32", 4)}


def family(cfg: ModelConfig) -> str:
    """The HF ``model_type`` a config is written as (a multimodal one: its
    wrapper's)."""
    if cfg.vision is not None:
        if cfg.vision.family == "qwen3vl":
            return "qwen3_vl_moe" if cfg.is_moe else "qwen3_vl"
        return "gemma3"
    if cfg.is_moe:
        return "qwen3_moe" if cfg.qk_norm else "mixtral"
    if cfg.post_norms:
        return "gemma2" if cfg.attn_softcap else "gemma3_text"
    if cfg.name.startswith("phi-3"):
        return "phi3"
    if cfg.qk_norm:
        return "qwen3"
    if cfg.attention_bias:
        return "qwen2"
    if cfg.sliding_window:
        return "mistral"
    return "llama"


_ARCH = {"llama": "LlamaForCausalLM", "mistral": "MistralForCausalLM",
         "qwen2": "Qwen2ForCausalLM", "qwen3": "Qwen3ForCausalLM", "phi3": "Phi3ForCausalLM",
         "gemma2": "Gemma2ForCausalLM", "gemma3_text": "Gemma3ForCausalLM",
         "mixtral": "MixtralForCausalLM", "qwen3_moe": "Qwen3MoeForCausalLM"}


def _text_family(cfg: ModelConfig) -> str:
    """The family of a config's text model (its tensor layout)."""
    return family(dataclasses.replace(cfg, vision=None))


def _vision_hf_config(cfg: ModelConfig, dtype: str) -> dict:
    """A multimodal config's wrapper ``config.json``."""
    v = cfg.vision
    text = hf_config(dataclasses.replace(cfg, vision=None), dtype)
    fam = family(cfg)
    if fam == "gemma3":
        if text["model_type"] != "gemma3_text":
            raise ValueError(f"{cfg.name}: a SigLIP tower is written beside a gemma-3 text "
                             f"model, not {text['model_type']}")
        return {"architectures": ["Gemma3ForConditionalGeneration"], "model_type": "gemma3",
                "text_config": text, "torch_dtype": dtype,
                "vision_config": {"model_type": "siglip_vision_model",
                                  "hidden_size": v.hidden_size,
                                  "intermediate_size": v.intermediate_size,
                                  "num_hidden_layers": v.num_layers,
                                  "num_attention_heads": v.num_heads,
                                  "image_size": v.image_size, "patch_size": v.patch_size,
                                  "num_channels": v.num_channels,
                                  "layer_norm_eps": v.layer_norm_eps},
                "mm_tokens_per_image": v.mm_tokens_per_image,
                "image_token_index": cfg.image_token_id, "boi_token_index": cfg.boi_token_id,
                "eoi_token_index": cfg.eoi_token_id}
    text["model_type"] = fam + "_text"
    text["rope_scaling"] = {"rope_type": "default", "mrope_section": list(cfg.mrope_section),
                            "mrope_interleaved": True}
    m = v.spatial_merge_size
    return {"architectures": ["Qwen3VLMoeForConditionalGeneration" if cfg.is_moe
                              else "Qwen3VLForConditionalGeneration"],
            "model_type": fam, "text_config": text, "torch_dtype": dtype,
            "vision_config": {"depth": v.num_layers, "hidden_size": v.hidden_size,
                              "intermediate_size": v.intermediate_size,
                              "num_heads": v.num_heads, "patch_size": v.patch_size,
                              "spatial_merge_size": m,
                              "temporal_patch_size": v.temporal_patch_size,
                              "in_channels": v.num_channels,
                              "out_hidden_size": v.out_hidden_size,
                              "num_position_embeddings": v.num_grid_per_side ** 2,
                              "deepstack_visual_indexes": list(v.deepstack_indexes),
                              "image_size": v.image_size},
            "image_token_id": cfg.image_token_id,
            "vision_start_token_id": cfg.boi_token_id,
            "vision_end_token_id": cfg.eoi_token_id}


def hf_config(cfg: ModelConfig, dtype: str = "bfloat16") -> dict:
    """The family's ``config.json``: the fields ``from_hf_config`` reads,
    so that it gives back ``cfg`` (but for its name)."""
    if cfg.vision is not None:
        return _vision_hf_config(cfg, dtype)
    fam = family(cfg)
    hf = {
        "architectures": [_ARCH[fam]], "model_type": fam,
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
        "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps,
        "max_position_embeddings": cfg.max_position_embeddings,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "sliding_window": cfg.sliding_window, "rope_scaling": cfg.rope_scaling,
        "hidden_act": "silu" if cfg.hidden_act == "silu" else "gelu_pytorch_tanh",
        "torch_dtype": dtype,
    }
    if cfg.query_pre_attn_scalar is not None:
        hf["query_pre_attn_scalar"] = cfg.query_pre_attn_scalar
    if fam == "gemma2":
        hf["final_logit_softcapping"] = cfg.logit_softcap
        hf["attn_logit_softcapping"] = cfg.attn_softcap
    if fam == "gemma3_text":
        hf["sliding_window_pattern"] = cfg.sliding_window_pattern
        hf["rope_local_base_freq"] = cfg.rope_local_theta
    if fam == "mixtral":
        hf.update(num_local_experts=cfg.num_experts, num_experts_per_tok=cfg.num_experts_per_tok)
    if fam == "qwen3_moe":
        hf.update(num_experts=cfg.num_experts, num_experts_per_tok=cfg.num_experts_per_tok,
                  moe_intermediate_size=cfg.intermediate_size, norm_topk_prob=True,
                  decoder_sparse_step=1, mlp_only_layers=[])
    return hf


def _vision_specs(cfg: ModelConfig, naming: str) -> list[tuple[str, tuple, str]]:
    """The tower's tensors (and gemma-3's projector)."""
    v = cfg.vision
    D, I, C, P = v.hidden_size, v.intermediate_size, v.num_channels, v.patch_size
    if v.family == "qwen3vl":
        pre = "model.visual."
        m2D = v.spatial_merge_size ** 2 * D
        specs = [(pre + "patch_embed.proj.weight", (D, C, v.temporal_patch_size, P, P),
                  "linear"),
                 (pre + "patch_embed.proj.bias", (D,), "bias"),
                 (pre + "pos_embed.weight", (v.num_grid_per_side ** 2, D), "bias")]
        for i in range(v.num_layers):
            b = pre + f"blocks.{i}."
            specs += [(b + "norm1.weight", (D,), "ln"), (b + "norm1.bias", (D,), "bias"),
                      (b + "attn.qkv.weight", (3 * D, D), "linear"),
                      (b + "attn.qkv.bias", (3 * D,), "bias"),
                      (b + "attn.proj.weight", (D, D), "linear"),
                      (b + "attn.proj.bias", (D,), "bias"),
                      (b + "norm2.weight", (D,), "ln"), (b + "norm2.bias", (D,), "bias"),
                      (b + "mlp.linear_fc1.weight", (I, D), "linear"),
                      (b + "mlp.linear_fc1.bias", (I,), "bias"),
                      (b + "mlp.linear_fc2.weight", (D, I), "linear"),
                      (b + "mlp.linear_fc2.bias", (D,), "bias")]
        mergers = [("merger.", D)] + [(f"deepstack_merger_list.{i}.", m2D)
                                      for i in range(len(v.deepstack_indexes))]
        for name, norm_dim in mergers:
            b = pre + name
            specs += [(b + "norm.weight", (norm_dim,), "ln"), (b + "norm.bias", (norm_dim,), "bias"),
                      (b + "linear_fc1.weight", (m2D, m2D), "linear"),
                      (b + "linear_fc1.bias", (m2D,), "bias"),
                      (b + "linear_fc2.weight", (v.out_hidden_size, m2D), "linear"),
                      (b + "linear_fc2.bias", (v.out_hidden_size,), "bias")]
        return specs
    top = "model." if naming == "nested" else ""
    pre = top + "vision_tower.vision_model."
    specs = [(pre + "embeddings.patch_embedding.weight", (D, C, P, P), "linear"),
             (pre + "embeddings.patch_embedding.bias", (D,), "bias"),
             (pre + "embeddings.position_embedding.weight", (v.num_patches, D), "bias")]
    for i in range(v.num_layers):
        b = pre + f"encoder.layers.{i}."
        specs += [(b + "layer_norm1.weight", (D,), "ln"), (b + "layer_norm1.bias", (D,), "bias")]
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            specs += [(b + f"self_attn.{proj}.weight", (D, D), "linear"),
                      (b + f"self_attn.{proj}.bias", (D,), "bias")]
        specs += [(b + "layer_norm2.weight", (D,), "ln"), (b + "layer_norm2.bias", (D,), "bias"),
                  (b + "mlp.fc1.weight", (I, D), "linear"), (b + "mlp.fc1.bias", (I,), "bias"),
                  (b + "mlp.fc2.weight", (D, I), "linear"), (b + "mlp.fc2.bias", (D,), "bias")]
    specs += [(pre + "post_layernorm.weight", (D,), "ln"),
              (pre + "post_layernorm.bias", (D,), "bias"),
              (top + "multi_modal_projector.mm_soft_emb_norm.weight", (D,), "norm"),
              (top + "multi_modal_projector.mm_input_projection_weight", (D, cfg.hidden_size),
               "linear")]
    return specs


VISION_NAMINGS = ("nested", "legacy")


def tensor_specs(cfg: ModelConfig, naming: str = "nested") -> list[tuple[str, tuple, str]]:
    """(HF name, HF shape, kind) of every tensor, in file order; kind is
    "linear" (scaled by 1/sqrt of its last axis), "embed", "norm" (the
    text model's RMSNorm weights), "ln" (a LayerNorm weight, near 1) or
    "bias". A multimodal config's text tensors are nested as its wrapper
    nests them (``naming``: "nested", or gemma-3's "legacy"), and its
    tower's follow."""
    if cfg.vision is not None:
        if naming not in VISION_NAMINGS:
            raise ValueError(f"naming must be one of {VISION_NAMINGS}, got {naming!r}")
        if naming == "legacy" and cfg.vision.family == "qwen3vl":
            raise ValueError("Qwen3-VL checkpoints have one naming (model.visual.*)")
        prefix = "model.language_model." if naming == "nested" else "language_model.model."
        text = [(prefix + name[len("model."):] if name.startswith("model.") else name, shape, k)
                for name, shape, k in tensor_specs(dataclasses.replace(cfg, vision=None))]
        return text + _vision_specs(cfg, naming)
    fam = family(cfg)
    D, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    specs = [("model.embed_tokens.weight", (V, D), "embed")]
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        specs.append((p + "input_layernorm.weight", (D,), "norm"))
        if fam == "phi3":
            specs.append((p + "self_attn.qkv_proj.weight", ((H + 2 * KV) * hd, D), "linear"))
        else:
            specs += [(p + "self_attn.q_proj.weight", (H * hd, D), "linear"),
                      (p + "self_attn.k_proj.weight", (KV * hd, D), "linear"),
                      (p + "self_attn.v_proj.weight", (KV * hd, D), "linear")]
        if cfg.attention_bias:
            specs += [(p + "self_attn.q_proj.bias", (H * hd,), "bias"),
                      (p + "self_attn.k_proj.bias", (KV * hd,), "bias"),
                      (p + "self_attn.v_proj.bias", (KV * hd,), "bias")]
        if cfg.qk_norm:
            specs += [(p + "self_attn.q_norm.weight", (hd,), "norm"),
                      (p + "self_attn.k_norm.weight", (hd,), "norm")]
        specs.append((p + "self_attn.o_proj.weight", (D, H * hd), "linear"))
        specs.append((p + "post_attention_layernorm.weight", (D,), "norm"))
        if cfg.post_norms:
            specs += [(p + "pre_feedforward_layernorm.weight", (D,), "norm"),
                      (p + "post_feedforward_layernorm.weight", (D,), "norm")]
        if fam == "mixtral":
            specs.append((p + "block_sparse_moe.gate.weight", (cfg.num_experts, D), "linear"))
            for e in range(cfg.num_experts):
                ep = p + f"block_sparse_moe.experts.{e}."
                specs += [(ep + "w1.weight", (F, D), "linear"),
                          (ep + "w2.weight", (D, F), "linear"),
                          (ep + "w3.weight", (F, D), "linear")]
            continue
        if fam == "qwen3_moe":
            specs.append((p + "mlp.gate.weight", (cfg.num_experts, D), "linear"))
            for e in range(cfg.num_experts):
                ep = p + f"mlp.experts.{e}."
                specs += [(ep + "gate_proj.weight", (F, D), "linear"),
                          (ep + "up_proj.weight", (F, D), "linear"),
                          (ep + "down_proj.weight", (D, F), "linear")]
            continue
        if fam == "phi3":
            specs.append((p + "mlp.gate_up_proj.weight", (2 * F, D), "linear"))
        else:
            specs += [(p + "mlp.gate_proj.weight", (F, D), "linear"),
                      (p + "mlp.up_proj.weight", (F, D), "linear")]
        specs.append((p + "mlp.down_proj.weight", (D, F), "linear"))
    specs.append(("model.norm.weight", (D,), "norm"))
    if not cfg.tie_word_embeddings:
        specs.append(("lm_head.weight", (V, D), "linear"))
    return specs


def _bits(x: np.ndarray, dtype: str) -> np.ndarray:
    """float32 values in the checkpoint dtype (bfloat16 as its uint16
    bits, rounded to nearest even)."""
    if dtype == "float32":
        return x.astype(np.float32)
    if dtype == "float16":
        return x.astype(np.float16)
    b = x.astype(np.float32).view(np.uint32)
    return ((b + 0x7FFF + ((b >> 16) & 1)) >> 16).astype(np.uint16)


def _base(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(PATTERN).astype(np.float32)


def _pattern(cfg: ModelConfig, name: str, shape: tuple, kind: str, base: np.ndarray):
    pat = np.roll(base, -(zlib.crc32(name.encode()) % PATTERN))
    if kind == "ln":
        pat = 0.05 * pat + 1.0
    elif kind == "norm":
        pat = 0.05 * pat + (0.0 if cfg.norm_style == "gemma" else 1.0)
    elif kind == "bias":
        pat = 0.02 * pat
    elif kind == "linear":
        pat = pat / np.sqrt(shape[-1])
    return pat


def tensor_value(cfg: ModelConfig, name: str, shape: tuple, kind: str, dtype: str = "bfloat16",
                 seed: int = 0, base: np.ndarray = None) -> np.ndarray:
    """The tensor ``write_checkpoint`` writes under ``name``, in the
    checkpoint dtype (bfloat16 as uint16 bits)."""
    base = _base(seed) if base is None else base
    return np.resize(_bits(_pattern(cfg, name, shape, kind, base), dtype), shape)


FP8_STRATEGIES = ("channel", "tensor")
FP8_MAX = 448.0     # the largest float8_e4m3fn


def fp8_value(cfg: ModelConfig, name: str, shape: tuple, kind: str, seed: int = 0,
              base: np.ndarray = None, strategy: str = "channel") -> tuple:
    """(float8_e4m3fn codes as uint8 ``shape``, float32 ``weight_scale``)
    that an fp8 checkpoint holds for linear ``name``: the float32 pattern
    over its scale (amax / 448 per output row, ``[out, 1]``, or over the
    whole tensor, a scalar), rounded to e4m3."""
    import torch

    base = _base(seed) if base is None else base
    w = np.resize(_pattern(cfg, name, shape, kind, base).astype(np.float32), shape)
    amax = np.abs(w).max(axis=1, keepdims=True) if strategy == "channel" else np.abs(w).max()
    scale = np.where(amax > 0, amax / np.float32(FP8_MAX), np.float32(1.0)).astype(np.float32)
    codes = torch.from_numpy(w / scale).to(torch.float8_e4m3fn).view(torch.uint8).numpy()
    return codes, scale


def fp8_quantization_config(strategy: str = "channel") -> dict:
    """The ``quantization_config`` of a compressed-tensors FP8 checkpoint."""
    return {"quant_method": "compressed-tensors", "format": "float-quantized",
            "config_groups": {"group_0": {
                "targets": ["Linear"],
                "weights": {"type": "float", "num_bits": 8, "symmetric": True,
                            "strategy": strategy, "dynamic": False},
                "input_activations": {"type": "float", "num_bits": 8, "symmetric": True,
                                      "strategy": "token", "dynamic": True}}},
            "ignore": ["lm_head"]}


# the text model's layers under each naming (plain, gemma-3 nested and
# legacy, Qwen3-VL)
_LAYER_PREFIXES = ("model.layers.", "model.language_model.layers.", "language_model.model.layers.")
# an MoE router: published fp8 and AWQ MoE checkpoints keep it unquantized
_ROUTERS = (".block_sparse_moe.gate.weight", ".mlp.gate.weight")


def _fp8_linear(name: str, kind: str) -> bool:
    """A tensor a quantized checkpoint stores as fp8 or AWQ: the text
    model's layers' linears, MoE experts included, routers and the vision
    tower not."""
    return (kind == "linear" and name.startswith(_LAYER_PREFIXES)
            and not name.endswith(_ROUTERS))


def awq_quantization_config(group_size: int = 128) -> dict:
    """The ``quantization_config`` of an AWQ "gemm" checkpoint (the one
    ``Qwen/Qwen3-8B-AWQ`` publishes, at its group size 128)."""
    return {"quant_method": "awq", "bits": 4, "group_size": group_size, "version": "gemm",
            "zero_point": True}


def awq_pack(nibbles: np.ndarray) -> np.ndarray:
    """``[r, c]`` values 0..15 -> ``[r, c/8]`` int32 words in AWQ's
    interleave (the inverse of ``ops/quant._awq_unpack``): bits [4k, 4k+4)
    of word j hold column 8j + _AWQ_ORDER[k]."""
    from llms_on_kubernetes_tpu_torch.ops.quant import _AWQ_ORDER

    r, c = nibbles.shape
    v = nibbles.astype(np.uint32).reshape(r, c // 8, 8)
    out = np.zeros((r, c // 8), np.uint32)
    for k, o in enumerate(_AWQ_ORDER):
        out |= v[:, :, o] << np.uint32(4 * k)
    return out.view(np.int32)


def awq_value(cfg: ModelConfig, name: str, shape: tuple, seed: int = 0,
              group_size: int = 128) -> tuple:
    """(qweight int32 ``[in, out/8]``, qzeros int32 ``[G, out/8]``, scales
    float16 ``[G, out]``) that an AWQ checkpoint holds for linear ``name``
    of HF ``shape`` [out, in]: seeded random words (a rotated pattern of
    65,536 of them, tiled), zero points 6..9 and scales near 1 / (4.6
    sqrt(in))."""
    out_f, in_f = shape
    if in_f % group_size or out_f % 8:
        raise ValueError(f"{name}: AWQ needs in % group_size == 0 and out % 8 == 0, got "
                         f"{shape} with group {group_size}")
    G = in_f // group_size
    rng = np.random.default_rng(seed + 1)
    words = rng.integers(0, 1 << 32, PATTERN, dtype=np.uint64).astype(np.uint32)
    rot = zlib.crc32(name.encode()) % PATTERN
    qweight = np.resize(np.roll(words, -rot), (in_f, out_f // 8)).view(np.int32)
    small = np.roll(rng.integers(6, 10, PATTERN), -rot)
    qzeros = awq_pack(np.resize(small, (G, out_f)))
    u = np.roll(rng.uniform(0.8, 1.2, PATTERN), -rot)
    scales = (np.resize(u, (G, out_f)) / (4.6 * np.sqrt(in_f))).astype(np.float16)
    return qweight, qzeros, scales


def _header(entries: list[tuple[str, tuple, str, int]]) -> bytes:
    """The file header over (name, shape, safetensors dtype, bytes an
    element) entries, in order."""
    header, pos = {"__metadata__": {"format": "pt"}}, 0
    for name, shape, st_dtype, elt in entries:
        n = int(np.prod(shape)) * elt
        header[name] = {"dtype": st_dtype, "shape": list(shape), "data_offsets": [pos, pos + n]}
        pos += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)   # the data starts 8-byte aligned
    return len(raw).to_bytes(8, "little") + raw


def write_checkpoint(cfg: ModelConfig, out_dir: str, *, dtype: str = "bfloat16", seed: int = 0,
                     max_shard_bytes: int = 4 << 30, quantization: str = None,
                     fp8_strategy: str = "channel", tokenizer: str = None,
                     group_size: int = 128, naming: str = "nested") -> dict:
    """Write ``cfg`` as a HF checkpoint into ``out_dir`` (made if missing):
    ``config.json``, ``model-0000k-of-0000n.safetensors`` shards of at most
    ``max_shard_bytes`` (a tensor is never split) and
    ``model.safetensors.index.json``. ``quantization="fp8"``: the layers'
    linears as fp8 with ``fp8_strategy`` scales (``fp8_value``);
    ``quantization="awq"``: as AWQ tensors in groups of ``group_size``
    input rows (``awq_value``).
    ``tokenizer`` (``TOKENIZER_FAMILIES``): also that family's tokenizer
    files (``write_tokenizer``), whose ids must fit ``cfg.vocab_size``;
    ``naming``: a multimodal checkpoint's tensor names (``tensor_specs``).
    Returns the index."""
    if tokenizer is not None:
        top = max(special_tokens(tokenizer))
        if top >= cfg.vocab_size:
            raise ValueError(f"the {tokenizer} tokenizer's ids reach {top}, past "
                             f"{cfg.name}'s vocabulary of {cfg.vocab_size}")
        write_tokenizer(out_dir, tokenizer)
    if quantization not in (None, "fp8", "awq"):
        raise ValueError(f"quantization must be None, 'fp8' or 'awq', got {quantization!r}")
    if fp8_strategy not in FP8_STRATEGIES:
        raise ValueError(f"fp8_strategy must be one of {FP8_STRATEGIES}, got {fp8_strategy!r}")
    st_dtype, elt = DTYPES[dtype]
    # (name, shape, kind, safetensors dtype, bytes an element); a linear of
    # an fp8 checkpoint is its codes, then its scale; of an AWQ checkpoint
    # its qweight, qzeros and scales
    entries = []
    for name, shape, kind in tensor_specs(cfg, naming):
        if quantization == "awq" and _fp8_linear(name, kind):
            base_name = name[:-len("weight")]
            G = shape[1] // group_size
            entries += [(base_name + "qweight", (shape[1], shape[0] // 8), name, "I32", 4),
                        (base_name + "qzeros", (G, shape[0] // 8), "awq_part", "I32", 4),
                        (base_name + "scales", (G, shape[0]), "awq_part", "F16", 2)]
        elif quantization == "fp8" and _fp8_linear(name, kind):
            sshape = (shape[0], 1) if fp8_strategy == "channel" else ()
            entries += [(name, shape, kind, "F8_E4M3", 1),
                        (name + "_scale", sshape, "fp8_scale", "F32", 4)]
        else:
            entries.append((name, shape, kind, st_dtype, elt))
    shards, cur, size = [], [], 0
    for e in entries:
        n = int(np.prod(e[1])) * e[4]
        if cur and size + n > max_shard_bytes and e[2] not in ("fp8_scale", "awq_part"):
            shards.append(cur)
            cur, size = [], 0
        cur.append(e)
        size += n
    shards.append(cur)
    os.makedirs(out_dir, exist_ok=True)
    base = _base(seed)
    weight_map, total, scale, awq_parts = {}, 0, None, []
    for k, shard in enumerate(shards):
        fname = f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"
        with open(os.path.join(out_dir, fname), "wb") as f:
            f.write(_header([(name, shape, st, n) for name, shape, _, st, n in shard]))
            for name, shape, kind, st, _n in shard:
                if kind == "fp8_scale":
                    arr = scale                  # computed with its codes, just before
                elif kind == "awq_part":
                    arr = awq_parts.pop(0)       # computed with its qweight, just before
                elif name.endswith(".qweight"):
                    # the kind of a qweight entry is its HF .weight name
                    out_f, in_f = shape[1] * 8, shape[0]
                    arr, *awq_parts = awq_value(cfg, kind, (out_f, in_f), seed, group_size)
                elif st == "F8_E4M3":
                    arr, scale = fp8_value(cfg, name, shape, kind, seed, base, fp8_strategy)
                else:
                    arr = tensor_value(cfg, name, shape, kind, dtype, seed, base)
                f.write(memoryview(np.ascontiguousarray(arr)).cast("B"))
                weight_map[name] = fname
                total += arr.nbytes
    index = {"metadata": {"total_size": total}, "weight_map": weight_map}
    with open(os.path.join(out_dir, "model.safetensors.index.json"), "w") as f:
        json.dump(index, f, indent=1)
    hf = hf_config(cfg, dtype)
    # the modules left unquantized (routers, the tower), as the published
    # checkpoints name them
    kept = (["mlp.gate", "block_sparse_moe.gate"] if cfg.is_moe else []) \
        + (["visual", "vision_tower", "multi_modal_projector"] if cfg.vision is not None else [])
    if quantization == "fp8":
        hf["quantization_config"] = fp8_quantization_config(fp8_strategy)
        hf["quantization_config"]["ignore"] += [f"re:.*{k}.*" for k in kept]
    elif quantization == "awq":
        hf["quantization_config"] = awq_quantization_config(group_size)
        if kept:
            hf["quantization_config"]["modules_to_not_convert"] = kept
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf, f, indent=1)
    return index


# ---------------------------------------------------------------------------
# tokenizer files: tokenizer.json and tokenizer_config.json in the published
# llama-3 and phi-3 formats, over a vocabulary trained here
# ---------------------------------------------------------------------------

TOKENIZER_FAMILIES = ("llama3", "phi3", "gemma3", "qwen3vl")
# the training text: the repository's SURVEY.md, pinned, so the files (and
# TOKENIZER_PROBES) are the same on every machine
CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "SURVEY.md")
CORPUS_SHA256 = "27a1e9c597d9b0ac0c3f4a6df74dd308d95e77a66d67c9a18eebefb4406df17c"
TOKENIZER_MERGES = 3000
# the published special tokens at their published ids. ``tokenizers``
# numbers added tokens on from the model's vocabulary, so that vocabulary
# is filled up to the first of them (the published sizes) and the added
# tokens run on without a gap, placeholders included
LLAMA3_BASE_VOCAB = 128000
LLAMA3_SPECIAL = {128000: "<|begin_of_text|>", 128001: "<|end_of_text|>",
                  **{128002 + i: f"<|reserved_special_token_{i}|>" for i in range(4)},
                  128006: "<|start_header_id|>", 128007: "<|end_header_id|>",
                  128008: "<|reserved_special_token_4|>", 128009: "<|eot_id|>"}
PHI3_BASE_VOCAB = 32000
PHI3_SPECIAL = {0: "<unk>", 1: "<s>", 2: "</s>", 32000: "<|endoftext|>",
                32001: "<|assistant|>",
                **{32002 + i: f"<|placeholder{i + 1}|>" for i in range(4)},
                32006: "<|system|>", 32007: "<|end|>", 32008: "<|placeholder5|>",
                32009: "<|placeholder6|>", 32010: "<|user|>"}
# phi-3's chat-role tokens strip the whitespace after them
PHI3_RSTRIP = {32001, 32006, 32007, 32010}
# the multimodal families: llama-3's vocabulary and turn markers, plus each
# model's image markers at its published ids (gemma-3-27b-it's begin and end
# of image and its soft token; Qwen3-VL's vision start and end and image pad)
GEMMA3_IMAGE_SPECIAL = {255999: "<start_of_image>", 256000: "<end_of_image>",
                        262144: "<image_soft_token>"}
QWEN3VL_IMAGE_SPECIAL = {151652: "<|vision_start|>", 151653: "<|vision_end|>",
                         151655: "<|image_pad|>"}
# what each family's chat template renders for an image part
IMAGE_MARKUP = {"gemma3": "<start_of_image>",
                "qwen3vl": "<|vision_start|><|image_pad|><|vision_end|>"}


def special_tokens(family_name: str) -> dict:
    """id -> text of a tokenizer family's special tokens."""
    return {"llama3": LLAMA3_SPECIAL, "phi3": PHI3_SPECIAL,
            "gemma3": {**LLAMA3_SPECIAL, **GEMMA3_IMAGE_SPECIAL},
            "qwen3vl": {**LLAMA3_SPECIAL, **QWEN3VL_IMAGE_SPECIAL}}[family_name]


def mm_chat_template(family_name: str) -> str:
    """llama-3's chat template over content that may be a list of parts:
    text parts as text, image parts as the family's image markers."""
    return (
        "{{ bos_token }}{% for message in messages %}"
        "{{ '<|start_header_id|>' + message['role'] + '<|end_header_id|>\n\n' }}"
        "{% if message['content'] is string %}{{ message['content'] | trim }}"
        "{% else %}{% for part in message['content'] %}"
        "{% if part['type'] == 'image' %}{{ '" + IMAGE_MARKUP[family_name] + "' }}"
        "{% elif part['type'] == 'text' %}{{ part['text'] }}{% endif %}"
        "{% endfor %}{% endif %}{{ '<|eot_id|>' }}{% endfor %}"
        "{% if add_generation_prompt %}{{ '<|start_header_id|>assistant<|end_header_id|>\n\n' }}"
        "{% endif %}")
LLAMA3_CHAT_TEMPLATE = (
    "{% set loop_messages = messages %}{% for message in loop_messages %}"
    "{% set content = '<|start_header_id|>' + message['role'] + '<|end_header_id|>\n\n'"
    "+ message['content'] | trim + '<|eot_id|>' %}{% if loop.index0 == 0 %}"
    "{% set content = bos_token + content %}{% endif %}{{ content }}{% endfor %}"
    "{% if add_generation_prompt %}{{ '<|start_header_id|>assistant<|end_header_id|>\n\n' }}"
    "{% endif %}")
PHI3_CHAT_TEMPLATE = (
    "{% for message in messages %}{% if message['role'] == 'system' %}"
    "{{'<|system|>\n' + message['content'] + '<|end|>\n'}}"
    "{% elif message['role'] == 'user' %}{{'<|user|>\n' + message['content'] + '<|end|>\n'}}"
    "{% elif message['role'] == 'assistant' %}"
    "{{'<|assistant|>\n' + message['content'] + '<|end|>\n'}}{% endif %}{% endfor %}"
    "{% if add_generation_prompt %}{{ '<|assistant|>\n' }}{% else %}{{ eos_token }}{% endif %}")


# probes of the written files: strings and a chat, with the ids that
# ``transformers`` (AutoTokenizer over the files ``write_tokenizer`` writes)
# gives for them: ``encode`` (special tokens added) and
# ``apply_chat_template(tokenize=True, add_generation_prompt=True)``
PROBE_TEXTS = ("Hello, world! The engine serves 1,234,567 tokens on the card.",
               "naïve café — 東京 🚀\n\n  indented\r\nline's end",
               "<|eot_id|> and <|end|> as text")
PROBE_CHAT = ({"role": "system", "content": "You are a terse assistant."},
              {"role": "user", "content": "What is 2 + 2? Answer in one word."})
TOKENIZER_PROBES = {
    "llama3": {
        "texts": [
            [128000, 72, 284, 328, 44, 317, 279, 564, 33, 765, 671, 477, 276, 32, 49, 44,
             50, 778, 44, 1293, 55, 1108, 360, 297, 280, 541, 46],
            [128000, 110, 97, 195, 175, 1657, 280, 1322, 195, 169, 371, 32, 230, 157, 177,
             228, 186, 172, 32, 240, 159, 154, 128, 340, 32, 318, 258, 1050, 296, 13, 10,
             866, 648, 1723],
            [128000, 128009, 463, 761, 124, 559, 124, 62, 813, 306, 794],
        ],
        "chat": [128000, 128006, 2179, 128007, 340, 89, 111, 117, 883, 277, 306, 257, 519,
                 277, 692, 545, 748, 46, 128009, 128006, 615, 257, 128007, 340, 1150, 425,
                 32, 50, 332, 32, 50, 63, 368, 1370, 1661, 318, 768, 317, 279, 100, 46,
                 128009, 128006, 390, 115, 545, 748, 128007, 340],
    },
    "phi3": {
        "texts": [
            [2769, 430, 290, 416, 384, 263, 271, 36, 813, 759, 582, 379, 535, 290, 294,
             1781, 290, 304, 312, 309, 542, 296, 654, 463, 397, 383, 652, 279],
            [413, 261, 198, 178, 1946, 383, 1506, 198, 172, 469, 259, 233, 160, 180, 231,
             189, 175, 259, 243, 162, 157, 131, 13, 13, 259, 420, 362, 1195, 398, 16, 13,
             987, 763, 2057],
            [1092, 281, 260, 578, 322, 709, 281, 336, 541, 259, 32007, 1016, 407, 974],
        ],
        "chat": [32006, 259, 341, 264, 274, 1015, 380, 407, 361, 634, 380, 805, 656, 869,
                 279, 32007, 32010, 1609, 522, 636, 435, 636, 66, 466, 1577, 291, 361,
                 420, 893, 416, 384, 271, 279, 32007, 32001],
    },
}


def train_bpe(word_counts: dict, n_merges: int) -> list[tuple[str, str]]:
    """Byte-pair merges learned over ``word_counts`` (a tuple of symbols ->
    its count): the most frequent adjacent pair first, ties to the
    smaller pair, until ``n_merges`` or no pair occurs twice. Pair counts
    are kept up to date word by word, so this takes about a second in
    pure Python."""
    words = [list(w) for w in word_counts]
    freqs = list(word_counts.values())
    pairs: dict = collections.Counter()
    where: dict = collections.defaultdict(set)
    for wi, w in enumerate(words):
        for p in zip(w, w[1:]):
            pairs[p] += freqs[wi]
            where[p].add(wi)
    heap = [(-c, p) for p, c in pairs.items()]
    heapq.heapify(heap)
    merges: list[tuple[str, str]] = []
    while heap and len(merges) < n_merges:
        neg, pair = heapq.heappop(heap)
        if pairs.get(pair, 0) != -neg:
            continue                    # a stale count
        if -neg < 2:
            break
        merges.append(pair)
        a, b = pair
        touched = set()
        for wi in where.pop(pair):
            w, f = words[wi], freqs[wi]
            old = list(zip(w, w[1:]))
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and w[i] == a and w[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            if len(out) == len(w):
                continue
            words[wi] = out
            for p in old:
                pairs[p] -= f
            for p in zip(out, out[1:]):
                pairs[p] += f
                where[p].add(wi)
            touched.update(old)
            touched.update(zip(out, out[1:]))
        pairs.pop(pair, None)
        for p in touched:
            if pairs.get(p, 0) > 0 and p != pair:
                heapq.heappush(heap, (-pairs[p], p))
    return merges


def _corpus() -> str:
    import hashlib

    with open(CORPUS, "rb") as f:
        raw = f.read()
    if hashlib.sha256(raw).hexdigest() != CORPUS_SHA256:
        raise RuntimeError(f"{CORPUS} changed: the synthetic tokenizers (and "
                           f"TOKENIZER_PROBES) are trained on its pinned content")
    return raw.decode("utf-8")


def _vocab_with_merges(vocab: dict, merges: list, size: int) -> dict:
    """``vocab``, the merges' tokens, then fillers no merge makes, up to
    ``size`` ids."""
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    while len(vocab) < size:
        vocab[f"<|synthetic_{len(vocab)}|>"] = len(vocab)
    return vocab


def _added(special: dict, rstrip=frozenset()) -> list[dict]:
    return [{"id": i, "content": t, "single_word": False, "lstrip": False,
             "rstrip": i in rstrip, "normalized": False, "special": True}
            for i, t in sorted(special.items())]


def _template_processing(token: str, tid: int) -> dict:
    one = {"SpecialToken": {"id": token, "type_id": 0}}
    return {"type": "TemplateProcessing",
            "single": [one, {"Sequence": {"id": "A", "type_id": 0}}],
            "pair": [one, {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": token, "type_id": 1}},
                     {"Sequence": {"id": "B", "type_id": 1}}],
            "special_tokens": {token: {"id": token, "ids": [tid], "tokens": [token]}}}


def tokenizer_files(family_name: str) -> tuple[dict, dict]:
    """(tokenizer.json, tokenizer_config.json) of ``family_name``: llama-3's
    byte-level BPE or phi-3's SentencePiece BPE with byte fallback, in the
    published layouts (pre-tokenizer, normalizer, decoder, post-processor,
    special tokens at their published ids, the chat template), over a
    vocabulary of the 256 bytes and ``TOKENIZER_MERGES`` merges learned
    from the corpus. No ``tokenizers`` needed."""
    from llms_on_kubernetes_tpu_torch.engine.tokenizer import (
        BYTE_ENCODER, LLAMA3_SPLIT, _split_llama3,
    )

    if family_name in ("gemma3", "qwen3vl"):
        tok, cfg = tokenizer_files("llama3")
        tok["added_tokens"] = _added(special_tokens(family_name))
        cfg["chat_template"] = mm_chat_template(family_name)
        cfg["added_tokens_decoder"] = {str(a["id"]): {k: v for k, v in a.items() if k != "id"}
                                       for a in tok["added_tokens"]}
        return tok, cfg
    text = _corpus()
    if family_name == "llama3":
        counts = collections.Counter(
            tuple(BYTE_ENCODER[b] for b in piece.encode("utf-8"))
            for piece in _split_llama3(text))
        merges = train_bpe(counts, TOKENIZER_MERGES)
        vocab = _vocab_with_merges({BYTE_ENCODER[b]: b for b in range(256)}, merges,
                                   LLAMA3_BASE_VOCAB)
        tok = {
            "version": "1.0", "truncation": None, "padding": None,
            "added_tokens": _added(LLAMA3_SPECIAL), "normalizer": None,
            "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
                {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT}, "behavior": "Isolated",
                 "invert": False},
                {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
                 "use_regex": False}]},
            "post_processor": {"type": "Sequence", "processors": [
                {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": False,
                 "use_regex": True},
                _template_processing("<|begin_of_text|>", 128000)]},
            "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                        "use_regex": True},
            "model": {"type": "BPE", "dropout": None, "unk_token": None,
                      "continuing_subword_prefix": None, "end_of_word_suffix": None,
                      "fuse_unk": False, "byte_fallback": False, "ignore_merges": True,
                      "vocab": vocab, "merges": [f"{a} {b}" for a, b in merges]}}
        cfg = {"bos_token": "<|begin_of_text|>", "eos_token": "<|eot_id|>",
               "chat_template": LLAMA3_CHAT_TEMPLATE, "clean_up_tokenization_spaces": True,
               "model_input_names": ["input_ids", "attention_mask"],
               "model_max_length": 1000000000000000019884624838656,
               "tokenizer_class": "PreTrainedTokenizerFast"}
        special, rstrip = LLAMA3_SPECIAL, frozenset()
    elif family_name == "phi3":
        words: dict = collections.Counter()
        for line in text.split("\n"):
            norm = "▁" + line.replace(" ", "▁")
            i = 0
            while i < len(norm):
                j = norm.find("▁", i + 1)
                j = len(norm) if j < 0 else j
                words[norm[i:j]] += 1
                i = j
        chars = collections.Counter(c for w, n in words.items() for c in w for _ in range(n))
        pieces = sorted((c for c in chars if unicodedata.category(c)[0] != "C"),
                        key=lambda c: (-chars[c], c))
        counts = {tuple(w): n for w, n in words.items() if all(c in pieces for c in w)}
        merges = train_bpe(counts, TOKENIZER_MERGES)
        vocab = {"<unk>": 0, "<s>": 1, "</s>": 2,
                 **{f"<0x{b:02X}>": 3 + b for b in range(256)}}
        for c in pieces:
            vocab.setdefault(c, len(vocab))
        vocab = _vocab_with_merges(vocab, merges, PHI3_BASE_VOCAB)
        tok = {
            "version": "1.0", "truncation": None, "padding": None,
            "added_tokens": _added(PHI3_SPECIAL, PHI3_RSTRIP),
            "normalizer": {"type": "Sequence", "normalizers": [
                {"type": "Prepend", "prepend": "▁"},
                {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}]},
            "pre_tokenizer": None,
            "post_processor": _template_processing("<s>", 1),
            "decoder": {"type": "Sequence", "decoders": [
                {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
                {"type": "ByteFallback"}, {"type": "Fuse"},
                {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
            "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                      "continuing_subword_prefix": None, "end_of_word_suffix": None,
                      "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
                      "vocab": vocab, "merges": [f"{a} {b}" for a, b in merges]}}
        cfg = {"add_bos_token": False, "add_eos_token": False, "bos_token": "<s>",
               "chat_template": PHI3_CHAT_TEMPLATE, "clean_up_tokenization_spaces": False,
               "eos_token": "<|end|>", "legacy": False, "model_max_length": 4096,
               "pad_token": "<|endoftext|>", "padding_side": "left", "sp_model_kwargs": {},
               "tokenizer_class": "LlamaTokenizer", "unk_token": "<unk>",
               "use_default_system_prompt": False}
        special, rstrip = PHI3_SPECIAL, PHI3_RSTRIP
    else:
        raise ValueError(f"tokenizer must be one of {TOKENIZER_FAMILIES}, got {family_name!r}")
    cfg["added_tokens_decoder"] = {str(a["id"]): {k: v for k, v in a.items() if k != "id"}
                                   for a in _added(special, rstrip)}
    return tok, cfg


def write_tokenizer(out_dir: str, family_name: str) -> None:
    """Write ``tokenizer_files(family_name)`` into ``out_dir``."""
    tok, cfg = tokenizer_files(family_name)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(tok, f, ensure_ascii=False)
    with open(os.path.join(out_dir, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump(cfg, f, ensure_ascii=False, indent=1)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m llms_on_kubernetes_tpu_torch.testing."
                                      "synth_checkpoint")
    ap.add_argument("model", help="a registry model (dense, MoE or multimodal), or the HF id "
                                  "of a reference default model (configs.PUBLISHED_MM_CONFIGS)")
    ap.add_argument("out_dir")
    quant = ap.add_mutually_exclusive_group()
    quant.add_argument("--fp8", action="store_true", help="a compressed-tensors fp8 checkpoint")
    quant.add_argument("--awq", action="store_true",
                       help="an AWQ checkpoint (4-bit, group 128, gemm packing)")
    ap.add_argument("--tokenizer", choices=TOKENIZER_FAMILIES, default=None,
                    help="also write this family's tokenizer.json and tokenizer_config.json")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to this many layers (full width kept)")
    ap.add_argument("--legacy-naming", action="store_true",
                    help="gemma-3: the older language_model.model.* / vision_tower.* names")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    quantization = "fp8" if args.fp8 else "awq" if args.awq else None
    if args.model in PUBLISHED_MM_CONFIGS:      # a reference default model's config.json
        cfg = from_hf_config(PUBLISHED_MM_CONFIGS[args.model], args.model)
    else:
        cfg = get_config(args.model)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    index = write_checkpoint(cfg, args.out_dir, quantization=quantization,
                             tokenizer=args.tokenizer,
                             naming="legacy" if args.legacy_naming else "nested")
    print(f"{args.out_dir}: {len(index['weight_map'])} tensors, "
          f"{index['metadata']['total_size']} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
