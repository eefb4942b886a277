"""Dense decoder-only transformer: the serving engine's model core
(counterpart of ``llms_on_kubernetes_tpu/models/decoder.py``, dense path).

The layouts are the JAX package's, so weights carry over one to one:
parameters are a plain dict with the layers STACKED on a leading axis and
the head axes explicit (``wq [L, D, H, hd]``, ``wo [L, H, hd, D]``), and
the KV cache is the flat head-major pool ``[n_kv, L * P, page, hd]`` of
``engine/cache.py``, updated IN PLACE. The layer loop is a Python loop
(``jax.lax.scan`` has no counterpart that the port needs); inside it the
per-layer-local page table is offset by ``layer * P``.

The projections are plain ``torch.matmul`` (the JAX package leaves them
to XLA). Attention goes through ``ops/attention``'s dispatchers: the CUDA
kernels for CUDA tensors, the plain versions for CPU tensors.

Not ported yet: LoRA, MoE, vision, the chunk/verify/score passes.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from llms_on_kubernetes_tpu_torch import resolve_device
from llms_on_kubernetes_tpu_torch.configs import ModelConfig
from llms_on_kubernetes_tpu_torch.engine.cache import torch_dtype, write_tokens
from llms_on_kubernetes_tpu_torch.ops.attention import (
    dispatch_paged_attention_write, dispatch_prefill_attention, softcap,
)
from llms_on_kubernetes_tpu_torch.ops.norms import rms_norm
from llms_on_kubernetes_tpu_torch.ops.rope import apply_rope, rope_frequencies

Params = dict[str, Any]


def _act(cfg: ModelConfig):
    if cfg.hidden_act == "gelu_tanh":
        return functools.partial(F.gelu, approximate="tanh")
    return F.silu


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, dtype: Optional[str] = None,
                device="cuda") -> Params:
    """Random-init parameters with the JAX ``init_params`` shapes and scales
    (normal * scale, cast to ``dtype``), drawn from a ``torch.Generator``
    seeded with ``seed`` on the target device. Stacked tensors are drawn one
    layer at a time, so the float32 draw never holds a whole stack."""
    if cfg.is_moe or cfg.vision is not None:
        raise NotImplementedError(f"{cfg.name}: MoE and vision models are not ported yet")
    dev = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    L, D, Fd = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    H, KV, hd, V = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.vocab_size

    def init(*shape, scale=None):
        s = scale if scale is not None else 1.0 / math.sqrt(
            shape[-2] if len(shape) > 1 else shape[-1])
        out = torch.empty(shape, dtype=dt, device=dev)
        parts = out if len(shape) > 2 else [out]
        for part in parts:
            x = torch.randn(part.shape, generator=gen, device=dev, dtype=torch.float32)
            part.copy_(x.mul_(s))
        return out

    def norm(*shape):
        if cfg.norm_style == "llama":
            return torch.ones(shape, dtype=dt, device=dev)
        return torch.zeros(shape, dtype=dt, device=dev)

    layers: Params = {
        "attn_norm": norm(L, D),
        "wq": init(L, D, H, hd, scale=D ** -0.5),
        "wk": init(L, D, KV, hd, scale=D ** -0.5),
        "wv": init(L, D, KV, hd, scale=D ** -0.5),
        "wo": init(L, H, hd, D, scale=(H * hd) ** -0.5),
        "mlp_norm": norm(L, D),
        "w_gate": init(L, D, Fd, scale=D ** -0.5),
        "w_up": init(L, D, Fd, scale=D ** -0.5),
        "w_down": init(L, Fd, D, scale=Fd ** -0.5),
    }
    if cfg.attention_bias:
        layers["bq"] = torch.zeros((L, H, hd), dtype=dt, device=dev)
        layers["bk"] = torch.zeros((L, KV, hd), dtype=dt, device=dev)
        layers["bv"] = torch.zeros((L, KV, hd), dtype=dt, device=dev)
    if cfg.qk_norm:
        layers["q_norm"] = norm(L, hd)
        layers["k_norm"] = norm(L, hd)
    if cfg.post_norms:
        layers["attn_post_norm"] = norm(L, D)
        layers["mlp_post_norm"] = norm(L, D)
    params: Params = {
        "embed": init(V, D, scale=1.0),
        "final_norm": norm(D),
        "layers": layers,
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = init(D, V, scale=D ** -0.5)
    return params


# ---------------------------------------------------------------------------
# Layer
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _inv_freq(cfg: ModelConfig, device: torch.device, local: bool) -> torch.Tensor:
    """Rotary inverse frequencies, uploaded once per (config, device): a
    host-to-device copy inside the step would stall the stream."""
    if local:
        freqs = rope_frequencies(cfg.head_dim, cfg.rope_local_theta)
    else:
        freqs = rope_frequencies(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    return torch.from_numpy(freqs).to(device)


def _proj(x: torch.Tensor, w: torch.Tensor, n_in: int) -> torch.Tensor:
    """``x [..., in]`` times a weight whose first ``n_in`` axes are the
    input (flattened) and the rest the output (kept)."""
    in_shape, out_shape = w.shape[:n_in], w.shape[n_in:]
    y = torch.matmul(x.reshape(*x.shape[:x.dim() - n_in], math.prod(in_shape)),
                     w.reshape(math.prod(in_shape), math.prod(out_shape)))
    return y.reshape(*y.shape[:-1], *out_shape)


def _qkv(lp: Params, cfg: ModelConfig, h: torch.Tensor):
    q = _proj(h, lp["wq"], 1)            # [B, T, H, hd]
    k = _proj(h, lp["wk"], 1)            # [B, T, KV, hd]
    v = _proj(h, lp["wv"], 1)
    if cfg.attention_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.rms_norm_eps, style=cfg.norm_style)
        k = rms_norm(k, lp["k_norm"], cfg.rms_norm_eps, style=cfg.norm_style)
    return q, k, v


def _mlp(lp: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    gate = _act(cfg)(_proj(h, lp["w_gate"], 1))
    up = _proj(h, lp["w_up"], 1)
    return _proj(gate * up, lp["w_down"], 1)


def _layer_step(cfg: ModelConfig, inv_freq, page_table, positions, write_positions,
                lengths, mode: str, x, lp: Params, k_pages, v_pages,
                window: Optional[int], kv_write: str = "dus"):
    """One transformer layer. ``page_table`` holds GLOBAL page ids (the
    caller added this layer's block offset); the pools are updated in
    place. Returns the new residual stream."""
    scale = (cfg.query_pre_attn_scalar or cfg.head_dim) ** -0.5
    h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps, style=cfg.norm_style)
    q, k, v = _qkv(lp, cfg, h)
    q, k = apply_rope(q, k, positions, inv_freq)
    if mode == "decode":
        attn = dispatch_paged_attention_write(
            q[:, 0], k_pages, v_pages, page_table, lengths, k[:, 0], v[:, 0],
            write_positions, scale=scale, sliding_window=window,
            attn_softcap=cfg.attn_softcap, kv_write=kv_write)[0][:, None]
    else:
        write_tokens(k_pages, v_pages, k, v, page_table, write_positions)
        attn = dispatch_prefill_attention(q, k, v, lengths, scale=scale,
                                          sliding_window=window,
                                          attn_softcap=cfg.attn_softcap)
    out = _proj(attn, lp["wo"], 2)
    if cfg.post_norms:
        out = rms_norm(out, lp["attn_post_norm"], cfg.rms_norm_eps, style=cfg.norm_style)
    x = x + out
    h = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps, style=cfg.norm_style)
    m = _mlp(lp, cfg, h)
    if cfg.post_norms:
        m = rms_norm(m, lp["mlp_post_norm"], cfg.rms_norm_eps, style=cfg.norm_style)
    return x + m


def _run_layers(cfg: ModelConfig, params: Params, x, k_pages, v_pages, page_table,
                positions, write_positions, lengths, mode: str, kv_write: str = "dus"):
    kd = getattr(k_pages, "data", k_pages)
    pages_per_layer = kd.shape[1] // cfg.num_layers
    inv_freq = _inv_freq(cfg, x.device, False)
    layers = params["layers"]
    for idx in range(cfg.num_layers):
        # Gemma-2/3 interleaved attention: layer idx is global iff
        # (idx+1) % pattern == 0; local layers use the window and the local
        # rope theta
        window, freqs = cfg.sliding_window, inv_freq
        if cfg.sliding_window_pattern is not None:
            if (idx + 1) % cfg.sliding_window_pattern == 0:
                window = None
            elif cfg.rope_local_theta is not None:
                freqs = _inv_freq(cfg, x.device, True)
        lp = {name: w[idx] for name, w in layers.items()}
        x = _layer_step(cfg, freqs, page_table + idx * pages_per_layer, positions,
                        write_positions, lengths, mode, x, lp, k_pages, v_pages,
                        window, kv_write)
    return x


def _embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    # ids outside the vocabulary clamp to its ends, as the JAX gather does
    # (the byte tokenizer's BOS/EOS lie past debug-tiny's 256 ids)
    x = params["embed"][tokens.long().clamp(0, cfg.vocab_size - 1)]
    if cfg.embedding_multiplier is not None:
        x = (x.float() * cfg.embedding_multiplier).to(x.dtype)
    return x


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm and LM head: operands in the weight dtype, the float32
    accumulation returned unrounded (the JAX path's
    ``preferred_element_type=float32``). x is [B, D]."""
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps, style=cfg.norm_style)
    head = params["embed"].T if cfg.tie_word_embeddings else params["lm_head"]
    head = head.to(x.dtype)
    if x.dtype == torch.float32:
        logits = torch.mm(x, head)
    elif x.is_cuda:
        # bf16 operands, f32 output: the GEMM never rounds to bf16
        logits = torch.mm(x, head, out_dtype=torch.float32)
    else:
        # the CPU has no mm.dtype; widening bf16 to f32 is exact
        logits = torch.mm(x.float(), head.float())
    return softcap(logits, cfg.logit_softcap)


# ---------------------------------------------------------------------------
# Public forward passes
# ---------------------------------------------------------------------------

def forward_prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                    lengths: torch.Tensor, k_pages, v_pages, page_table: torch.Tensor):
    """Process whole prompts: tokens [B, T] (a padded bucket), lengths [B]
    int32 (0 => inactive row), page_table [B, pages_per_seq] per-layer-local
    ids. Writes the prompts' KV into the pools in place and returns
    (last-token logits [B, V] float32, k_pages, v_pages)."""
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device, dtype=torch.int32).expand(B, T)
    write_positions = torch.where(positions < lengths[:, None], positions, -1)
    x = _embed(params, cfg, tokens)
    x = _run_layers(cfg, params, x, k_pages, v_pages, page_table, positions,
                    write_positions, lengths, "prefill")
    last = (lengths.long() - 1).clamp(0, T - 1)
    x_last = x[torch.arange(B, device=x.device), last]
    return _logits(params, cfg, x_last), k_pages, v_pages


def forward_decode(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   lengths: torch.Tensor, k_pages, v_pages, page_table: torch.Tensor,
                   kv_write: str = "dus"):
    """One decode step for every slot: tokens [B], lengths [B] int32
    INCLUDING the new token (0 => idle slot). Appends each active slot's KV
    in place (``kv_write`` "dus": ``write_tokens`` then the decode kernel;
    "fused": the kernel that appends as it attends) and returns
    (logits [B, V] float32, k_pages, v_pages)."""
    positions = (lengths - 1).clamp(min=0)[:, None]
    write_positions = torch.where(lengths[:, None] > 0, positions, -1)
    x = _embed(params, cfg, tokens[:, None])
    x = _run_layers(cfg, params, x, k_pages, v_pages, page_table, positions,
                    write_positions, lengths, "decode", kv_write=kv_write)
    return _logits(params, cfg, x[:, 0]), k_pages, v_pages
