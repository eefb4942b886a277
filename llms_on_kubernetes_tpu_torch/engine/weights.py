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
seen through. MoE, vision towers and pre-quantized checkpoints (fp8, AWQ)
raise NotImplementedError.

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
(a caller holding JAX arrays converts them to numpy first).
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

Params = dict[str, Any]


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)    # a writable copy: torch does not wrap read-only buffers
    if a.dtype.name == "bfloat16":   # ml_dtypes bfloat16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree: Any, device="cuda", dtype: Optional[str] = None) -> Any:
    """Nested dicts of numpy arrays -> the same nesting of tensors on
    ``device``, cast to ``dtype`` when given (else kept as they are)."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype) if dtype is not None else None
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev, dtype) for k, v in tree.items()}
    t = _tensor(tree)
    return t.to(device=dev, dtype=dt) if dt is not None else t.to(dev)


# ---------------------------------------------------------------------------
# HF checkpoint -> the decoder's layouts
# ---------------------------------------------------------------------------

class _Fetch:
    """Reads HF tensors by name, onto ``device``, seeing through the
    multimodal wrappers' nesting of the text model."""

    def __init__(self, loaders: dict[str, Callable[[], torch.Tensor]], device: torch.device):
        self.loaders = loaders
        self.device = device

    def _resolve(self, name: str) -> str:
        """A gemma-3 multimodal checkpoint stores ``model.language_model.*``
        (beside ``model.vision_tower.*``), an older wrapper
        ``language_model.model.*``; plain decoders ``model.*``."""
        if name in self.loaders:
            return name
        if name.startswith("model."):
            for alt in ("model.language_model." + name[len("model."):],
                        "language_model." + name):
                if alt in self.loaders:
                    return alt
        alt = "model." + name
        return alt if alt in self.loaders else name

    def has(self, name: str) -> bool:
        return self._resolve(name) in self.loaders

    def __call__(self, name: str) -> torch.Tensor:
        key = self._resolve(name)
        if key not in self.loaders:
            raise KeyError(f"checkpoint is missing tensor {name!r} "
                           f"(have {len(self.loaders)} tensors)")
        return self.loaders[key]().to(self.device)

    def linear(self, name: str, out_reshape=None) -> torch.Tensor:
        """HF linear weight [out, in] -> [in, out] (+ optional reshape)."""
        w = self(name).T
        if out_reshape is not None:
            w = w.reshape(w.shape[0], *out_reshape)
        return w


def hf_layer_maps(cfg: ModelConfig, fetch: _Fetch, i: int) -> Params:
    """The decoder's per-layer parameters for HF layer ``i`` (dense
    families), as the JAX ``hf_layer_maps`` makes them."""
    H, KV, hd, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.hidden_size
    p = f"model.layers.{i}."
    out: Params = {}

    # --- attention ------------------------------------------------------
    if fetch.has(p + "self_attn.q_proj.weight"):
        out["wq"] = fetch.linear(p + "self_attn.q_proj.weight", (H, hd))
        out["wk"] = fetch.linear(p + "self_attn.k_proj.weight", (KV, hd))
        out["wv"] = fetch.linear(p + "self_attn.v_proj.weight", (KV, hd))
    else:
        # phi3 fused qkv: [(H + 2 KV) * hd, D]
        q, k, v = torch.split(fetch(p + "self_attn.qkv_proj.weight"),
                              [H * hd, KV * hd, KV * hd], dim=0)
        out["wq"] = q.T.reshape(D, H, hd)
        out["wk"] = k.T.reshape(D, KV, hd)
        out["wv"] = v.T.reshape(D, KV, hd)
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
    if fetch.has(p + "mlp.gate_proj.weight"):
        out["w_gate"] = fetch.linear(p + "mlp.gate_proj.weight")
        out["w_up"] = fetch.linear(p + "mlp.up_proj.weight")
    else:
        g, u = torch.chunk(fetch(p + "mlp.gate_up_proj.weight"), 2, dim=0)   # phi3 [2F, D]
        out["w_gate"] = g.T
        out["w_up"] = u.T
    out["w_down"] = fetch.linear(p + "mlp.down_proj.weight")
    return out


def checkpoint_quantization(model_dir) -> Optional[dict]:
    """``quantization_config`` of the checkpoint's config.json, or None."""
    path = os.path.join(model_dir, "config.json")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f).get("quantization_config") or None


def load_hf_params(cfg: ModelConfig, model_dir, device="cuda",
                   dtype: Optional[str] = None) -> Params:
    """Load a HF checkpoint directory into the decoder's parameters on
    ``device``, cast to ``dtype`` (default ``cfg.dtype``): the tree and
    layouts of ``params_from_numpy`` of the JAX ``init_params``, the values
    of the JAX ``load_hf_params`` bit for bit. Raises NotImplementedError
    for MoE, vision and pre-quantized checkpoints, FileNotFoundError for a
    directory without ``*.safetensors``, KeyError for a missing tensor."""
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE checkpoints are not loaded yet (the port has no MoE block)")
    if cfg.vision is not None:
        raise NotImplementedError(
            f"{cfg.name}: the checkpoint has a vision tower, which the port does not load yet")
    quant = checkpoint_quantization(model_dir)
    if quant is not None:
        raise NotImplementedError(
            f"{model_dir}: pre-quantized checkpoints ({quant.get('quant_method')}) are not "
            f"loaded yet; the port serves full-precision weights only")
    dev = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)
    fetch = _Fetch(open_dir(model_dir), dev)
    L = cfg.num_layers
    layers: Params = {}
    for i in range(L):
        for name, w in hf_layer_maps(cfg, fetch, i).items():
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
