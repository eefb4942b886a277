"""Write a HuggingFace-format safetensors checkpoint of a dense registry
model, at its full width, with cheap deterministic values.

    python -m llms_on_kubernetes_tpu_torch.testing.synth_checkpoint phi-3-mini OUT_DIR [--fp8]

Neither machine this repository runs on can download the published
weights, so the card's run serves a checkpoint this module writes: the
HF ``config.json`` of the family (which ``configs.from_hf_config`` reads
back to the registry entry), the family's own tensor names and HF layouts
(phi-3's fused ``qkv_proj`` and ``gate_up_proj``, gemma's four norms a
layer, qwen2's attention biases, qwen3's q/k norms), sharded
``*.safetensors`` files with a ``model.safetensors.index.json``, in
bfloat16 (or float32/float16). Each file is a JSON header and raw bytes,
written tensor by tensor with numpy, so memory holds one tensor at a time.

``quantization="fp8"`` writes a compressed-tensors FP8 checkpoint, as
FP8-Dynamic models ship: each decoder-layer linear as ``F8_E4M3`` codes
with a float32 ``weight_scale`` per output channel (``[out, 1]``, amax /
448) or per tensor (a scalar), the embedding, norms and LM head in the
checkpoint dtype, and a ``quantization_config`` in ``config.json``. The
fp8 codes are PyTorch's float8_e4m3fn rounding of the pattern over its
scale (``fp8_value``).

Values are a pattern, not draws: 65,536 normal values from ``seed``,
rotated by a hash of the tensor's name, tiled over its shape and scaled by
``1/sqrt(fan_in)`` (norm weights near 1, or near 0 for gemma's ``1 + w``
norms; biases small). Billions of random draws would cost minutes and
change nothing a load or a serve measures. ``tensor_value`` recomputes any
tensor, so a reader can be held to exactly what was written.
"""

from __future__ import annotations

import json
import os
import sys
import zlib

import numpy as np

from llms_on_kubernetes_tpu_torch.configs import ModelConfig, get_config

PATTERN = 65536
# checkpoint dtype -> (safetensors dtype, bytes an element)
DTYPES = {"bfloat16": ("BF16", 2), "float16": ("F16", 2), "float32": ("F32", 4)}


def family(cfg: ModelConfig) -> str:
    """The HF ``model_type`` a dense config is written as."""
    if cfg.is_moe or cfg.vision is not None:
        raise NotImplementedError(f"{cfg.name}: only dense text models are written")
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
         "gemma2": "Gemma2ForCausalLM", "gemma3_text": "Gemma3ForCausalLM"}


def hf_config(cfg: ModelConfig, dtype: str = "bfloat16") -> dict:
    """The family's ``config.json``: the fields ``from_hf_config`` reads,
    so that it gives back ``cfg`` (but for its name)."""
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
    return hf


def tensor_specs(cfg: ModelConfig) -> list[tuple[str, tuple, str]]:
    """(HF name, HF shape, kind) of every tensor, in file order; kind is
    "linear" (scaled by 1/sqrt of its last axis), "embed", "norm" or
    "bias"."""
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
    if kind == "norm":
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


def _fp8_linear(name: str, kind: str) -> bool:
    """A tensor an fp8 checkpoint stores as fp8: the decoder layers' linears."""
    return kind == "linear" and name.startswith("model.layers.")


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
                     fp8_strategy: str = "channel") -> dict:
    """Write ``cfg`` as a HF checkpoint into ``out_dir`` (made if missing):
    ``config.json``, ``model-0000k-of-0000n.safetensors`` shards of at most
    ``max_shard_bytes`` (a tensor is never split) and
    ``model.safetensors.index.json``. ``quantization="fp8"``: the layers'
    linears as fp8 with ``fp8_strategy`` scales (``fp8_value``). Returns
    the index."""
    if quantization not in (None, "fp8"):
        raise ValueError(f"quantization must be None or 'fp8', got {quantization!r}")
    if fp8_strategy not in FP8_STRATEGIES:
        raise ValueError(f"fp8_strategy must be one of {FP8_STRATEGIES}, got {fp8_strategy!r}")
    st_dtype, elt = DTYPES[dtype]
    # (name, shape, kind, safetensors dtype, bytes an element); a linear of
    # an fp8 checkpoint is its codes, then its scale
    entries = []
    for name, shape, kind in tensor_specs(cfg):
        if quantization == "fp8" and _fp8_linear(name, kind):
            sshape = (shape[0], 1) if fp8_strategy == "channel" else ()
            entries += [(name, shape, kind, "F8_E4M3", 1),
                        (name + "_scale", sshape, "fp8_scale", "F32", 4)]
        else:
            entries.append((name, shape, kind, st_dtype, elt))
    shards, cur, size = [], [], 0
    for e in entries:
        n = int(np.prod(e[1])) * e[4]
        if cur and size + n > max_shard_bytes and e[2] != "fp8_scale":
            shards.append(cur)
            cur, size = [], 0
        cur.append(e)
        size += n
    shards.append(cur)
    os.makedirs(out_dir, exist_ok=True)
    base = _base(seed)
    weight_map, total, scale = {}, 0, None
    for k, shard in enumerate(shards):
        fname = f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"
        with open(os.path.join(out_dir, fname), "wb") as f:
            f.write(_header([(name, shape, st, n) for name, shape, _, st, n in shard]))
            for name, shape, kind, st, _n in shard:
                if kind == "fp8_scale":
                    arr = scale                  # computed with its codes, just before
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
    if quantization == "fp8":
        hf["quantization_config"] = fp8_quantization_config(fp8_strategy)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf, f, indent=1)
    return index


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    quantization = None
    if argv[2:] == ["--fp8"]:
        quantization, argv = "fp8", argv[:2]
    if len(argv) != 2:
        print("usage: python -m llms_on_kubernetes_tpu_torch.testing.synth_checkpoint "
              "MODEL OUT_DIR [--fp8]", file=sys.stderr)
        return 2
    index = write_checkpoint(get_config(argv[0]), argv[1], quantization=quantization)
    print(f"{argv[1]}: {len(index['weight_map'])} tensors, "
          f"{index['metadata']['total_size']} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
