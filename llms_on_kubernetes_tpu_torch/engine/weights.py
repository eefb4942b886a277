"""Checkpoint loading and parameter conversion (counterpart of
``llms_on_kubernetes_tpu/engine/weights.py``).

``load_hf_params`` reads a HuggingFace safetensors checkpoint directory
(``engine/safetensors.py``: numpy ``memmap``, no ``safetensors`` package)
into the port's parameters: the tree and layouts the JAX ``init_params``
makes (layer-stacked, head axes explicit), so the decoder takes them as it
takes ``params_from_numpy``'s. ``hf_layer_maps`` is a copy of the JAX
one's dense families: llama, mistral and tinyllama (one key schema), qwen2
(attention biases), qwen3 (q/k norms), phi3 (fused ``qkv_proj`` and
``gate_up_proj``, split here) and gemma2/3 (four norms a layer), with the
``model.language_model.*`` nesting of gemma-3's multimodal checkpoints
seen through, and both MoE namings (Mixtral's ``block_sparse_moe.{gate,
experts.N.w1/w2/w3}``, Qwen3-MoE's ``mlp.{gate, experts.N.*_proj}``):
each expert's tensors go to the device as stored and are transposed and
stacked there into ``[E, D, F]`` / ``[E, F, D]``, a layer at a time. A
vision tower raises NotImplementedError, and so does any quantization of
an MoE checkpoint (int8 expert weights and AWQ MoE are ROADMAP queue 1
items 3a and 3b).

Quantized weights (``ops/quant.py``), as the JAX loader makes them:
``quantization="int8"`` quantizes the matmul weights layer by layer from
each tensor's value as fetched, in float32, before any cast to the serving
dtype; a compressed-tensors fp8 checkpoint (``checkpoint_quantization``)
is dequantized with its ``weight_scale`` and requantized to the same int8
QTensors whatever ``quantization`` says; ``quantization="fp8"|"awq"``
asserts the checkpoint's format. An AWQ checkpoint is served natively, as
the JAX loader serves it: each linear stored 1:1 in AWQ packing
(``qweight``/``qzeros``/``scales``) becomes a grouped int4 ``GroupQTensor``
(``_Fetch.grouped``: the int32 tensors go to the device as stored and are
unpacked there), fetched before the layer map so it is never dequantized;
a tensor the layer map fuses or splits (phi-3's ``qkv_proj`` and
``gate_up_proj``) is dequantized (``awq_dequantize``) and requantized to
int8 ``QTensor``s, as JAX does.

The load goes layer by layer: each stacked ``[L, ...]`` tensor is
allocated once on the device, and each HF tensor goes to the device as it
is stored (read through the file mapping), is transposed and split there,
and lands in its layer's slot, cast to the serving dtype. The host holds
no more than the tensor in flight, and the device no more than the model
and one layer's HF tensors.

``resolve_model_dir`` finds a local directory or a complete HuggingFace
cache snapshot, as the JAX one does; it downloads nothing.

``params_from_numpy`` turns a parameter tree of numpy arrays, laid out as
the JAX ``init_params`` lays it out, into tensors with identical layouts
(a caller holding JAX arrays converts them to numpy first; a JAX
``QTensor`` leaf comes as its ``(data, scale)`` pair).
"""

from __future__ import annotations

import json
import os
import pathlib
import re
from typing import Any, Callable, Optional

import numpy as np
import torch

from llms_on_kubernetes_tpu_torch import resolve_device
from llms_on_kubernetes_tpu_torch.configs import ModelConfig, hf_repo_for
from llms_on_kubernetes_tpu_torch.engine.cache import torch_dtype
from llms_on_kubernetes_tpu_torch.engine.safetensors import open_dir
from llms_on_kubernetes_tpu_torch.ops.quant import (
    _LAYER_REDUCE_AXES, SUPPORTED_QUANTIZATIONS, GroupQTensor, QTensor, awq_dequantize,
    awq_group_tensors, fp8_dequantize, quantize, reduce_axes_for,
)

Params = dict[str, Any]


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)    # a writable copy: torch does not wrap read-only buffers
    if a.dtype.name == "bfloat16":   # ml_dtypes bfloat16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree: Any, device="cuda", dtype: Optional[str] = None) -> Any:
    """Nested dicts of numpy arrays -> the same nesting of tensors on
    ``device``, cast to ``dtype`` when given (else kept as they are). A
    ``(data, scale)`` pair is a quantized weight: a ``QTensor`` whose
    int8 data and float32 scale keep their dtypes."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype) if dtype is not None else None
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev, dtype) for k, v in tree.items()}
    if isinstance(tree, tuple):
        data, scale = tree
        return QTensor(_tensor(data).to(dev), _tensor(scale).to(dev))
    t = _tensor(tree)
    return t.to(device=dev, dtype=dt) if dt is not None else t.to(dev)


# ---------------------------------------------------------------------------
# HF checkpoint -> the decoder's layouts
# ---------------------------------------------------------------------------

class _Fetch:
    """Reads HF tensors by name, onto ``device``, seeing through the
    multimodal wrappers' nesting of the text model and, in an AWQ
    checkpoint, through quantized storage (a ``.weight`` that exists only as
    ``.qweight``). In an fp8 checkpoint (``quant``), a ``.weight`` stored
    with a ``.weight_scale`` comes back dequantized to float32, in an AWQ
    one a ``.weight`` stored as ``.qweight`` too (``[out, in]``), as the JAX
    ``_Fetch`` returns them."""

    def __init__(self, loaders: dict[str, Callable[[], torch.Tensor]], device: torch.device,
                 quant: Optional[dict] = None):
        self.loaders = loaders
        self.device = device
        self.quant = quant

    def _awq(self) -> bool:
        return self.quant is not None and self.quant["method"] == "awq"

    def _present(self, name: str) -> bool:
        return name in self.loaders or (
            self._awq() and name.endswith(".weight")
            and name[:-len("weight")] + "qweight" in self.loaders)

    def _resolve(self, name: str) -> str:
        """A gemma-3 multimodal checkpoint stores ``model.language_model.*``
        (beside ``model.vision_tower.*``), an older wrapper
        ``language_model.model.*``; plain decoders ``model.*``."""
        if self._present(name):
            return name
        if name.startswith("model."):
            for alt in ("model.language_model." + name[len("model."):],
                        "language_model." + name):
                if self._present(alt):
                    return alt
        alt = "model." + name
        return alt if self._present(alt) else name

    def has(self, name: str) -> bool:
        return self._present(self._resolve(name))

    def _awq_parts(self, base: str) -> tuple:
        return tuple(self.loaders[base + part]().to(self.device)
                     for part in ("qweight", "qzeros", "scales"))

    def __call__(self, name: str) -> torch.Tensor:
        key = self._resolve(name)
        base = key[:-len("weight")]
        if self._awq() and key.endswith(".weight") and base + "qweight" in self.loaders:
            # HF orientation [out, in], as every other linear is fetched
            return awq_dequantize(*self._awq_parts(base), bits=self.quant["bits"]).T
        if key not in self.loaders:
            raise KeyError(f"checkpoint is missing tensor {name!r} "
                           f"(have {len(self.loaders)} tensors)")
        scale_key = base + "weight_scale"
        if (self.quant is not None and self.quant["method"] == "fp8"
                and key.endswith(".weight") and scale_key in self.loaders):
            return fp8_dequantize(self.loaders[key]().to(self.device),
                                  self.loaders[scale_key]().to(self.device))
        return self.loaders[key]().to(self.device)

    def linear(self, name: str, out_reshape=None) -> torch.Tensor:
        """HF linear weight [out, in] -> [in, out] (+ optional reshape)."""
        w = self(name).T
        if out_reshape is not None:
            w = w.reshape(w.shape[0], *out_reshape)
        return w

    def grouped(self, name: str, out_shape: tuple) -> Optional[GroupQTensor]:
        """The native grouped int4 tensor of an AWQ-packed linear (``name``
        its HF ``.weight`` name, ``out_shape`` the logical output axes of
        the decoder's layout; AWQ's input axis is the contraction), on the
        device, or None when the checkpoint is not AWQ or the tensor is not
        stored packed."""
        if not self._awq():
            return None
        base = self._resolve(name)[:-len("weight")]
        if base + "qweight" not in self.loaders:
            return None
        return awq_group_tensors(*self._awq_parts(base), bits=self.quant["bits"],
                                 out_shape=out_shape)


def hf_layer_maps(cfg: ModelConfig, fetch: _Fetch, i: int,
                  preloaded: Optional[Params] = None) -> Params:
    """The decoder's per-layer parameters for HF layer ``i`` (dense
    families), as the JAX ``hf_layer_maps`` makes them. ``preloaded``
    entries (the AWQ loader's grouped tensors) are taken as they are and
    never fetched."""
    H, KV, hd, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.hidden_size
    p = f"model.layers.{i}."
    pre = preloaded or {}
    out: Params = dict(pre)

    # --- attention ------------------------------------------------------
    if {"wq", "wk", "wv"} <= pre.keys():
        pass
    elif fetch.has(p + "self_attn.q_proj.weight"):
        for name, proj, heads in (("wq", "q_proj", H), ("wk", "k_proj", KV),
                                  ("wv", "v_proj", KV)):
            if name not in pre:
                out[name] = fetch.linear(p + f"self_attn.{proj}.weight", (heads, hd))
    else:
        # phi3 fused qkv: [(H + 2 KV) * hd, D]
        q, k, v = torch.split(fetch(p + "self_attn.qkv_proj.weight"),
                              [H * hd, KV * hd, KV * hd], dim=0)
        out["wq"] = q.T.reshape(D, H, hd)
        out["wk"] = k.T.reshape(D, KV, hd)
        out["wv"] = v.T.reshape(D, KV, hd)
    if "wo" not in pre:
        out["wo"] = fetch(p + "self_attn.o_proj.weight").T.reshape(H, hd, D)   # [D, H*hd]
    if cfg.attention_bias:
        out["bq"] = fetch(p + "self_attn.q_proj.bias").reshape(H, hd)
        out["bk"] = fetch(p + "self_attn.k_proj.bias").reshape(KV, hd)
        out["bv"] = fetch(p + "self_attn.v_proj.bias").reshape(KV, hd)
    if cfg.qk_norm:
        out["q_norm"] = fetch(p + "self_attn.q_norm.weight")
        out["k_norm"] = fetch(p + "self_attn.k_norm.weight")

    # --- norms ----------------------------------------------------------
    out["attn_norm"] = fetch(p + "input_layernorm.weight")
    if cfg.post_norms:  # gemma2/3: 4 norms a layer
        out["attn_post_norm"] = fetch(p + "post_attention_layernorm.weight")
        out["mlp_norm"] = fetch(p + "pre_feedforward_layernorm.weight")
        out["mlp_post_norm"] = fetch(p + "post_feedforward_layernorm.weight")
    else:
        out["mlp_norm"] = fetch(p + "post_attention_layernorm.weight")

    # --- mlp ------------------------------------------------------------
    if cfg.is_moe:
        if fetch.has(p + "block_sparse_moe.gate.weight"):
            # Mixtral: block_sparse_moe.{gate, experts.N.w1 (gate) / w3 (up) / w2 (down)}
            router, ep, names = "block_sparse_moe.gate.weight", "block_sparse_moe.experts.", \
                ("w1", "w3", "w2")
        else:
            # Qwen3-MoE: mlp.{gate, experts.N.gate_proj / up_proj / down_proj}
            router, ep, names = "mlp.gate.weight", "mlp.experts.", \
                ("gate_proj", "up_proj", "down_proj")
        out["router"] = fetch.linear(p + router)                       # [D, E]
        for key, name in zip(("w_gate", "w_up", "w_down"), names):
            out[key] = torch.stack([fetch.linear(p + f"{ep}{e}.{name}.weight")
                                    for e in range(cfg.num_experts)])
        return out
    if {"w_gate", "w_up"} <= pre.keys():
        pass
    elif fetch.has(p + "mlp.gate_proj.weight"):
        for name, proj in (("w_gate", "gate_proj"), ("w_up", "up_proj")):
            if name not in pre:
                out[name] = fetch.linear(p + f"mlp.{proj}.weight")
    else:
        g, u = torch.chunk(fetch(p + "mlp.gate_up_proj.weight"), 2, dim=0)   # phi3 [2F, D]
        out["w_gate"] = g.T
        out["w_up"] = u.T
    if "w_down" not in pre:
        out["w_down"] = fetch.linear(p + "mlp.down_proj.weight")
    return out


def awq_sources(cfg: ModelConfig) -> dict:
    """The decoder's weight name -> (HF linear in a layer, logical output
    axes) of every tensor an AWQ checkpoint may store packed 1:1."""
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {"wq": ("self_attn.q_proj.weight", (H, hd)),
            "wk": ("self_attn.k_proj.weight", (KV, hd)),
            "wv": ("self_attn.v_proj.weight", (KV, hd)),
            "wo": ("self_attn.o_proj.weight", (cfg.hidden_size,)),
            "w_gate": ("mlp.gate_proj.weight", (cfg.intermediate_size,)),
            "w_up": ("mlp.up_proj.weight", (cfg.intermediate_size,)),
            "w_down": ("mlp.down_proj.weight", (cfg.hidden_size,))}


def checkpoint_quantization(model_dir) -> Optional[dict]:
    """The format of a pre-quantized checkpoint from ``quantization_config``
    in its config.json, as the JAX ``checkpoint_quantization`` reads it:
    None (full precision), {"method": "fp8"} (compressed-tensors with float
    8-bit weights) or {"method": "awq", "bits", "group_size"} ("gemm"
    packing). Any other scheme raises ValueError: loading it as weight x
    scale would serve wrong weights."""
    path = os.path.join(model_dir, "config.json")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        qc = json.load(f).get("quantization_config")
    if not qc:
        return None
    method = qc.get("quant_method")
    if method == "compressed-tensors":
        for group in (qc.get("config_groups") or {}).values():
            w = (group or {}).get("weights") or {}
            if w.get("type", "float") != "float" or int(w.get("num_bits", 8)) != 8:
                raise ValueError(f"unsupported compressed-tensors weight scheme "
                                 f"{w.get('type')}/{w.get('num_bits')}-bit (only FP8 float "
                                 f"weights)")
        return {"method": "fp8"}
    if method == "awq":
        version = qc.get("version", "gemm")
        if version != "gemm":
            raise ValueError(f"unsupported AWQ version {version!r} (only 'gemm' packing)")
        return {"method": "awq", "bits": int(qc.get("bits", 4)),
                "group_size": int(qc.get("group_size", 128))}
    raise ValueError(f"unsupported quant_method {method!r} "
                     f"(supported: compressed-tensors fp8, awq)")


def moe_quantization_refusal(cfg: ModelConfig, quantization: str) -> str:
    """Why a quantized MoE model is refused: the port's expert kernel
    takes bf16 weights only."""
    return (f"{cfg.name}: {quantization} weights of an MoE model are not ported yet "
            f"(ROADMAP queue 1 item 3a: int8 expert weights through a grouped W8A16; "
            f"item 3b: AWQ MoE)")


def load_hf_params(cfg: ModelConfig, model_dir, device="cuda", dtype: Optional[str] = None,
                   quantization: Optional[str] = None) -> Params:
    """Load a HF checkpoint directory into the decoder's parameters on
    ``device``, cast to ``dtype`` (default ``cfg.dtype``): the tree and
    layouts of ``params_from_numpy`` of the JAX ``init_params``, the values
    of the JAX ``load_hf_params`` bit for bit. With ``quantization="int8"``,
    or from an fp8 checkpoint, the matmul weights are int8 ``QTensor``s
    with the JAX loader's bytes and scales; from an AWQ checkpoint, the
    linears stored packed are ``GroupQTensor``s (stacked on the device a
    layer at a time) and the rest int8 ``QTensor``s, with the JAX loader's
    bytes. An MoE checkpoint's router and expert stacks are the JAX
    loader's ``router`` [L, D, E], ``w_gate``/``w_up`` [L, E, D, F] and
    ``w_down`` [L, E, F, D]. Raises NotImplementedError for vision
    checkpoints and for a quantized MoE one, ValueError for an unknown
    ``quantization`` or one the checkpoint is not, FileNotFoundError for a
    directory without ``*.safetensors``, KeyError for a missing tensor."""
    if quantization not in SUPPORTED_QUANTIZATIONS:
        raise ValueError(f"unknown quantization {quantization!r} "
                         f"(supported: {[q for q in SUPPORTED_QUANTIZATIONS if q]})")
    if cfg.vision is not None:
        raise NotImplementedError(
            f"{cfg.name}: the checkpoint has a vision tower, which the port does not load yet")
    quant = checkpoint_quantization(model_dir)
    if cfg.is_moe and (quantization is not None or quant is not None):
        raise NotImplementedError(moe_quantization_refusal(cfg, quantization or quant["method"]))
    if quantization in ("fp8", "awq"):
        found = quant["method"] if quant else None
        if found != quantization:
            raise ValueError(f"quantization={quantization!r} requested but the checkpoint at "
                             f"{model_dir} is {found or 'full-precision'}")
    # a pre-quantized checkpoint always serves quantized weights (its
    # weights are 8-bit or fewer already)
    quantize_now = quantization == "int8" or quant is not None
    awq_native = quant is not None and quant["method"] == "awq"
    dev = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)
    fetch = _Fetch(open_dir(model_dir), dev, quant)
    L = cfg.num_layers
    layers: Params = {}
    for i in range(L):
        # grouped tensors FIRST, so the layer map never dequantizes them
        pre: Params = {}
        if awq_native:
            for name, (src, out_shape) in awq_sources(cfg).items():
                g = fetch.grouped(f"model.layers.{i}.{src}", out_shape)
                if g is not None:
                    pre[name] = g
        for name, w in hf_layer_maps(cfg, fetch, i, preloaded=pre).items():
            if isinstance(w, GroupQTensor):
                if name not in layers:
                    layers[name] = GroupQTensor(
                        *(torch.empty((L, *t.shape), dtype=t.dtype, device=dev)
                          for t in (w.data, w.scale, w.zero_scaled)), w.out_shape, w.packed)
                for dst, src in ((layers[name].data, w.data), (layers[name].scale, w.scale),
                                 (layers[name].zero_scaled, w.zero_scaled)):
                    dst[i].copy_(src)
                continue
            if quantize_now and name in _LAYER_REDUCE_AXES:
                # from the value as fetched (f32 for fp8), before any cast
                axes = tuple(a - 1 for a in reduce_axes_for(name, w.dim() + 1))
                q = quantize(w, axes)
                if name not in layers:
                    layers[name] = QTensor(
                        torch.empty((L, *q.data.shape), dtype=torch.int8, device=dev),
                        torch.empty((L, *q.scale.shape), dtype=torch.float32, device=dev))
                layers[name].data[i].copy_(q.data)
                layers[name].scale[i].copy_(q.scale)
                continue
            if name not in layers:     # allocated once, filled a layer at a time
                layers[name] = torch.empty((L, *w.shape), dtype=dt, device=dev)
            layers[name][i].copy_(w)
    # copies: on the CPU a fetched tensor is a view of the file mapping
    params: Params = {
        "embed": fetch("model.embed_tokens.weight").to(dtype=dt, copy=True),
        "final_norm": fetch("model.norm.weight").to(dtype=dt, copy=True),
        "layers": layers,
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = fetch.linear("lm_head.weight").to(dtype=dt, copy=True,
                                                             memory_format=torch.contiguous_format)
    return params


# ---------------------------------------------------------------------------
# Where a checkpoint lives
# ---------------------------------------------------------------------------

def hf_hub_cache(cache_dir: Optional[str] = None) -> str:
    """The HuggingFace hub cache directory: ``cache_dir``'s ``hub/``, else
    ``HF_HUB_CACHE``, else ``HF_HOME``'s ``hub/`` (``~/.cache/huggingface``
    by default), as the JAX ``hf_hub_cache`` orders them."""
    if cache_dir:
        return os.path.join(cache_dir, "hub")
    env = os.environ.get("HF_HUB_CACHE", "").strip()
    if env:
        return os.path.expanduser(env)
    home = os.path.expanduser(os.environ.get("HF_HOME", "~/.cache/huggingface"))
    return os.path.join(home, "hub")


_SHARD_RE = r".*-\d{4,6}-of-\d{4,6}\.safetensors$"


def _snapshot_complete(snap: pathlib.Path) -> bool:
    """True when a cache snapshot holds a complete checkpoint: config.json,
    a tokenizer file, and every shard of the index's weight_map, or with no
    index at least one safetensors file and none named as a shard (an
    index is still to come)."""
    if not (snap / "config.json").is_file():
        return False
    if not any(
            (snap / t).is_file() for t in
            ("tokenizer.json", "tokenizer.model", "tokenizer_config.json", "vocab.json")):
        return False
    idx = snap / "model.safetensors.index.json"
    if idx.is_file():
        try:
            weight_map = json.loads(idx.read_text()).get("weight_map", {})
        except (OSError, ValueError):
            return False
        shards = set(weight_map.values())
        return bool(shards) and all((snap / s).is_file() for s in shards)
    files = [f.name for f in snap.glob("*.safetensors")]
    return bool(files) and not any(re.match(_SHARD_RE, f) for f in files)


def resolve_model_dir(model_ref: str, cache_dir: Optional[str] = None) -> str:
    """A local directory, or the complete HF cache snapshot of
    ``model_ref`` (a repo id, or a registry name through its canonical
    repo id). Downloads nothing: a miss raises FileNotFoundError."""
    if os.path.isdir(model_ref):
        return model_ref
    hub_dir = pathlib.Path(hf_hub_cache(cache_dir))
    canonical = hf_repo_for(model_ref)
    refs = [model_ref] + ([canonical] if canonical and canonical != model_ref else [])
    for ref in refs:
        repo_dir = hub_dir / ("models--" + ref.replace("/", "--"))
        snaps = sorted((repo_dir / "snapshots").glob("*")) if repo_dir.exists() else []
        for snap in snaps:
            if _snapshot_complete(snap):
                return str(snap)
    raise FileNotFoundError(
        f"no local checkpoint for {model_ref!r}; expected a directory or a "
        f"HF cache snapshot for one of {refs} under {hub_dir}"
    )
