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
to XLA); an int8 ``QTensor`` weight (``ops/quant.py``) goes through the
W8A16 kernel instead, a grouped int4 ``GroupQTensor`` (an AWQ checkpoint)
through the W4A16 kernel, and the embedding and LM head stay unquantized,
as in the JAX decoder. Multi-tenant LoRA (``ops/lora.py``): a layer whose
params hold a ``lora_<name>`` stack adds each row's adapter delta to that
projection (``adapter_idx [B]``, the row's slot, -1 = the base model),
in float32, cast to the base's dtype, as the JAX ``lora_qeinsum``; without
stacks the forward is exactly the adapter-free one. Attention goes
through ``ops/attention``'s dispatchers: the CUDA kernels for CUDA
tensors, the plain versions for CPU tensors. The pools pass through as
``KVPool``s; an int8 pool carries its per-token scales,
prefill attends over the fresh, unquantized K/V and stores them quantized
(as the JAX decoder does), and decode goes to the int8 kernels. The chunk
pass (``forward_chunk``) appends with the window kernels
(ops/paged_write.py) and attends to the pool, so it reads an int8 chunk's
own keys back quantized, as the JAX chunk pass does. The score pass
(``forward_score``) runs the prefill layers cache-free and reduces every
position's logits to the next token's logprob and the top-k. The verify
pass (``forward_verify``, speculative decoding) is the chunk pass with the
logits of every window position.

MoE layers (``cfg.is_moe``: Mixtral, Qwen3-MoE) replace the MLP with
``ops/moe.moe_block``: the router, the routed expert FFN (the
``csrc/moe_experts.cu`` kernel on a card) and the combine. Which tokens
claim experts is ``token_valid`` [B, T], as in the JAX decoder: by default
the rows that write KV (``write_positions >= 0``), for the chunk and verify
passes the rows inside ``lengths``, and for the score pass (whose writes
all go to the trash page) ``positions < lengths``; padding and idle rows
claim no expert capacity and get a zero MLP. ``moe_workspace``: the
engine's ``MoEWorkspace`` (the expert kernel's scratch), else allocated per
call.

Not ported yet: vision.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from llms_on_kubernetes_tpu_torch import resolve_device
from llms_on_kubernetes_tpu_torch.configs import ModelConfig
from llms_on_kubernetes_tpu_torch.engine.cache import KVPool, torch_dtype, write_tokens
from llms_on_kubernetes_tpu_torch.ops.attention import (
    dispatch_chunk_attention, dispatch_paged_attention_write, dispatch_prefill_attention,
    softcap,
)
from llms_on_kubernetes_tpu_torch.ops.norms import rms_norm
from llms_on_kubernetes_tpu_torch.ops.paged_write import dispatch_write_window
from llms_on_kubernetes_tpu_torch.ops.lora import lora_delta_flat
from llms_on_kubernetes_tpu_torch.ops.moe import moe_block
from llms_on_kubernetes_tpu_torch.ops.quant import GroupQTensor, QTensor, w4_matmul, w8_matmul
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
    layer at a time (an MoE stack one expert at a time), so the float32
    draw never holds a whole stack."""
    if cfg.vision is not None:
        raise NotImplementedError(f"{cfg.name}: vision models are not ported yet")
    dev = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    L, D, Fd = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    H, KV, hd, V = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.vocab_size

    def init(*shape, scale=None, experts=False):
        s = scale if scale is not None else 1.0 / math.sqrt(
            shape[-2] if len(shape) > 1 else shape[-1])
        out = torch.empty(shape, dtype=dt, device=dev)
        parts = out if len(shape) > 2 else [out]
        if experts:
            parts = out.view(-1, *shape[-2:])
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
    if cfg.is_moe:
        E = cfg.num_experts
        layers["router"] = init(L, D, E, scale=D ** -0.5)
        layers["w_gate"] = init(L, E, D, Fd, scale=D ** -0.5, experts=True)
        layers["w_up"] = init(L, E, D, Fd, scale=D ** -0.5, experts=True)
        layers["w_down"] = init(L, E, Fd, D, scale=Fd ** -0.5, experts=True)
    else:
        layers["w_gate"] = init(L, D, Fd, scale=D ** -0.5)
        layers["w_up"] = init(L, D, Fd, scale=D ** -0.5)
        layers["w_down"] = init(L, Fd, D, scale=Fd ** -0.5)
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

@functools.cache
def _inv_freq(cfg: ModelConfig, device: torch.device, local: bool) -> torch.Tensor:
    """Rotary inverse frequencies, uploaded once per (config, device): a
    host-to-device copy inside the step would stall the stream. Never
    evicted: a captured decode window (engine/graphs.py) reads this
    tensor's address on every replay."""
    if local:
        freqs = rope_frequencies(cfg.head_dim, cfg.rope_local_theta)
    else:
        freqs = rope_frequencies(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    return torch.from_numpy(freqs).to(device)


def _proj(x: torch.Tensor, w, n_in: int, lora=None, adapter_idx=None) -> torch.Tensor:
    """``x [B, ..., in]`` times a weight whose first ``n_in`` axes are the
    input (flattened) and the rest the output (kept). An int8 ``QTensor``
    goes through ``ops/quant.w8_matmul`` (the W8A16 kernel on a card), a
    ``GroupQTensor`` (its logical input axis is one, ``in`` flattened)
    through ``ops/quant.w4_matmul`` (the W4A16 kernel). With a ``lora``
    stack (one layer's) and ``adapter_idx [B]``, each row's adapter delta
    is added in float32 and the sum cast to the base's dtype."""
    lead = x.shape[:x.dim() - n_in]
    if isinstance(w, GroupQTensor):
        out_shape = w.out_shape
        K, N = x.shape[x.dim() - n_in:].numel(), math.prod(out_shape)
        y = w4_matmul(x.reshape(-1, K), w.data, w.scale, w.zero_scaled, w.packed)
        y = y.reshape(*lead, N)
    else:
        in_shape, out_shape = w.shape[:n_in], w.shape[n_in:]
        K, N = math.prod(in_shape), math.prod(out_shape)
        if isinstance(w, QTensor):
            y = w8_matmul(x.reshape(-1, K), w.data.reshape(K, N), w.scale.reshape(N))
            y = y.reshape(*lead, N)
        else:
            y = torch.matmul(x.reshape(*lead, K), w.reshape(K, N))
    if lora is not None and adapter_idx is not None:
        y = (y.float() + lora_delta_flat(x, lora, adapter_idx, n_in)).to(y.dtype)
    return y.reshape(*y.shape[:-1], *out_shape)


def _lproj(lp: Params, name: str, x: torch.Tensor, n_in: int, adapter_idx) -> torch.Tensor:
    """``_proj`` of layer weight ``name`` with its LoRA stack, if any."""
    return _proj(x, lp[name], n_in, lp.get("lora_" + name), adapter_idx)


def _qkv(lp: Params, cfg: ModelConfig, h: torch.Tensor, adapter_idx=None):
    q = _lproj(lp, "wq", h, 1, adapter_idx)            # [B, T, H, hd]
    k = _lproj(lp, "wk", h, 1, adapter_idx)            # [B, T, KV, hd]
    v = _lproj(lp, "wv", h, 1, adapter_idx)
    if cfg.attention_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.rms_norm_eps, style=cfg.norm_style)
        k = rms_norm(k, lp["k_norm"], cfg.rms_norm_eps, style=cfg.norm_style)
    return q, k, v


def _mlp(lp: Params, cfg: ModelConfig, h: torch.Tensor, token_valid: torch.Tensor,
         adapter_idx=None, moe_workspace=None) -> torch.Tensor:
    if cfg.is_moe:
        B, T, D = h.shape
        out = moe_block(h.reshape(B * T, D), lp["router"], lp["w_gate"], lp["w_up"],
                        lp["w_down"], top_k=cfg.num_experts_per_tok,
                        capacity_factor=cfg.moe_capacity_factor, act=_act(cfg),
                        valid=token_valid.reshape(B * T), workspace=moe_workspace)
        return out.reshape(B, T, D)
    gate = _act(cfg)(_lproj(lp, "w_gate", h, 1, adapter_idx))
    up = _lproj(lp, "w_up", h, 1, adapter_idx)
    return _lproj(lp, "w_down", gate * up, 1, adapter_idx)


def _layer_step(cfg: ModelConfig, inv_freq, page_table, positions, write_positions,
                lengths, mode: str, x, lp: Params, k_pages, v_pages,
                window: Optional[int], kv_write: str = "dus", workspace=None,
                adapter_idx=None, token_valid=None, moe_workspace=None):
    """One transformer layer. ``page_table`` holds GLOBAL page ids (the
    caller added this layer's block offset); the pools are updated in
    place. ``token_valid`` [B, T]: the tokens an MoE layer routes. Returns
    the new residual stream."""
    scale = (cfg.query_pre_attn_scalar or cfg.head_dim) ** -0.5
    h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps, style=cfg.norm_style)
    q, k, v = _qkv(lp, cfg, h, adapter_idx)
    q, k = apply_rope(q, k, positions, inv_freq)
    if mode == "decode":
        attn = dispatch_paged_attention_write(
            q[:, 0], k_pages, v_pages, page_table, lengths, k[:, 0], v[:, 0],
            write_positions, scale=scale, sliding_window=window,
            attn_softcap=cfg.attn_softcap, kv_write=kv_write,
            workspace=workspace)[0][:, None]
    elif mode == "chunk":
        # the chunk's rows t < lengths go to positions history + t (the
        # window kernels write no filler), then its queries attend to the
        # pool: earlier chunks' keys and this chunk's, as stored
        history = positions[:, 0].contiguous()
        dispatch_write_window(k_pages, v_pages, page_table, history, lengths, k, v)
        attn = dispatch_chunk_attention(q, k_pages, v_pages, page_table, history, lengths,
                                        scale=scale, sliding_window=window,
                                        attn_softcap=cfg.attn_softcap)
    else:
        write_tokens(k_pages, v_pages, k, v, page_table, write_positions)
        attn = dispatch_prefill_attention(q, k, v, lengths, scale=scale,
                                          sliding_window=window,
                                          attn_softcap=cfg.attn_softcap)
    out = _lproj(lp, "wo", attn, 2, adapter_idx)
    if cfg.post_norms:
        out = rms_norm(out, lp["attn_post_norm"], cfg.rms_norm_eps, style=cfg.norm_style)
    x = x + out
    h = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps, style=cfg.norm_style)
    m = _mlp(lp, cfg, h, token_valid, adapter_idx, moe_workspace)
    if cfg.post_norms:
        m = rms_norm(m, lp["mlp_post_norm"], cfg.rms_norm_eps, style=cfg.norm_style)
    return x + m


def _run_layers(cfg: ModelConfig, params: Params, x, k_pages, v_pages, page_table,
                positions, write_positions, lengths, mode: str, kv_write: str = "dus",
                workspace=None, adapter_idx=None, token_valid=None, moe_workspace=None):
    kd = getattr(k_pages, "data", k_pages)
    pages_per_layer = kd.shape[1] // cfg.num_layers
    inv_freq = _inv_freq(cfg, x.device, False)
    if token_valid is None and cfg.is_moe:
        token_valid = write_positions >= 0      # the rows that write KV route
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
                        window, kv_write, workspace, adapter_idx, token_valid,
                        moe_workspace)
    return x


def _embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    # ids outside the vocabulary clamp to its ends, as the JAX gather does
    # (the byte tokenizer's BOS/EOS lie past debug-tiny's 256 ids)
    x = params["embed"][tokens.long().clamp(0, cfg.vocab_size - 1)]
    if cfg.embedding_multiplier is not None:
        x = (x.float() * cfg.embedding_multiplier).to(x.dtype)
    return x


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor,
            normed: bool = False) -> torch.Tensor:
    """Final norm (unless ``normed``) and LM head: operands in the weight
    dtype, the float32 accumulation returned unrounded (the JAX path's
    ``preferred_element_type=float32``). x is [B, D]."""
    if not normed:
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
                    lengths: torch.Tensor, k_pages, v_pages, page_table: torch.Tensor,
                    adapter_idx: Optional[torch.Tensor] = None, moe_workspace=None):
    """Process whole prompts: tokens [B, T] (a padded bucket), lengths [B]
    int32 (0 => inactive row), page_table [B, pages_per_seq] per-layer-local
    ids; adapter_idx [B] int32 each row's LoRA slot (-1: base; None: no
    adapters). Writes the prompts' KV into the pools in place and returns
    (last-token logits [B, V] float32, k_pages, v_pages)."""
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device, dtype=torch.int32).expand(B, T)
    write_positions = torch.where(positions < lengths[:, None], positions, -1)
    x = _embed(params, cfg, tokens)
    x = _run_layers(cfg, params, x, k_pages, v_pages, page_table, positions,
                    write_positions, lengths, "prefill", adapter_idx=adapter_idx,
                    moe_workspace=moe_workspace)
    last = (lengths.long() - 1).clamp(0, T - 1)
    x_last = x[torch.arange(B, device=x.device), last]
    return _logits(params, cfg, x_last), k_pages, v_pages


# rows of the [T, V] float32 logits forward_score holds at once
SCORE_SLAB = 512


def forward_score(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  lengths: torch.Tensor, top_k: int = 8, moe_workspace=None):
    """Score a prompt (the JAX ``forward_score``): per position, the logprob
    of the NEXT prompt token and the top-k alternatives, which the serving
    prefill cannot give (it keeps the last position's logits only).
    tokens [1, T] (a padded bucket), lengths [1].

    Cache-free: attention runs causally over the in-flight K/V through the
    prefill dispatcher (the flash kernel on a card), and every KV write goes
    to a private one-page float32 pool (each write position -1, the trash
    page), never a serving pool. The [T, V] float32 logits are reduced on
    the device in slabs of ``SCORE_SLAB`` rows, each to [t] + [t, k] before
    the next is computed (at llama-3-8b's vocabulary 1,024 rows would be
    525 MB).

    Returns (next_logprob [1, T] float32: entry t scores tokens[t + 1], the
    last valid entry and the padding are 0; top_ids [1, T, k] int32;
    top_logprobs [1, T, k] float32)."""
    B, T = tokens.shape
    dev = tokens.device
    positions = torch.arange(T, device=dev, dtype=torch.int32).expand(B, T)
    write_positions = torch.full((B, T), -1, dtype=torch.int32, device=dev)
    dummy = (cfg.num_kv_heads, cfg.num_layers, 1, cfg.head_dim)
    k_pages = KVPool(torch.zeros(dummy, dtype=torch.float32, device=dev))
    v_pages = KVPool(torch.zeros(dummy, dtype=torch.float32, device=dev))
    page_table = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    x = _embed(params, cfg, tokens)
    # an MoE layer routes the tokens inside lengths: every write goes to
    # the trash page, so write_positions >= 0 would zero the whole MLP
    x = _run_layers(cfg, params, x, k_pages, v_pages, page_table, positions,
                    write_positions, lengths, "prefill",
                    token_valid=positions < lengths[:, None], moe_workspace=moe_workspace)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps, style=cfg.norm_style)
    V = cfg.vocab_size
    nxt = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1).long()
    # a next token outside the vocabulary scores NaN (the JAX gather's
    # fill); its index is clamped, as an out-of-range one asserts on a card
    in_vocab = (nxt >= 0) & (nxt < V)
    nxt = nxt.clamp(0, V - 1)
    nxt_lps, tids, tlps = [], [], []
    for s in range(0, T, SCORE_SLAB):
        rows = x[:, s:s + SCORE_SLAB]
        t = rows.shape[1]
        logits = _logits(params, cfg, rows.reshape(B * t, -1), normed=True)
        lse = torch.logsumexp(logits, dim=-1)
        lp = logits.gather(1, nxt[:, s:s + t].reshape(-1, 1))[:, 0] - lse
        nxt_lps.append(torch.where(in_vocab[:, s:s + t].reshape(-1), lp, float("nan"))
                       .reshape(B, t))
        lp, ids = torch.topk(logits, top_k, dim=-1)
        tids.append(ids.to(torch.int32).reshape(B, t, top_k))
        tlps.append((lp - lse[:, None]).reshape(B, t, top_k))
    nxt_lp = torch.cat(nxt_lps, dim=1)
    valid = positions < (lengths[:, None] - 1)
    nxt_lp = torch.where(valid, nxt_lp, 0.0)
    return nxt_lp, torch.cat(tids, dim=1), torch.cat(tlps, dim=1)


def forward_decode(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   lengths: torch.Tensor, k_pages, v_pages, page_table: torch.Tensor,
                   kv_write: str = "dus", workspace=None,
                   adapter_idx: Optional[torch.Tensor] = None, moe_workspace=None):
    """One decode step for every slot: tokens [B], lengths [B] int32
    INCLUDING the new token (0 => idle slot). Appends each active slot's KV
    in place (``kv_write`` "dus": ``write_tokens`` then the decode kernel;
    "fused": the kernel that appends as it attends; ``workspace``: the
    decode kernels' scratch, None => the process-wide one) and returns
    (logits [B, V] float32, k_pages, v_pages)."""
    positions = (lengths - 1).clamp(min=0)[:, None]
    write_positions = torch.where(lengths[:, None] > 0, positions, -1)
    x = _embed(params, cfg, tokens[:, None])
    x = _run_layers(cfg, params, x, k_pages, v_pages, page_table, positions,
                    write_positions, lengths, "decode", kv_write=kv_write,
                    workspace=workspace, adapter_idx=adapter_idx,
                    moe_workspace=moe_workspace)
    return _logits(params, cfg, x[:, 0]), k_pages, v_pages


def forward_chunk(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  history: torch.Tensor, lengths: torch.Tensor, k_pages, v_pages,
                  page_table: torch.Tensor, adapter_idx: Optional[torch.Tensor] = None,
                  moe_workspace=None):
    """Chunked prefill: one chunk of a prompt whose earlier tokens are
    already in the paged cache (earlier chunks, or an adopted cached
    prefix). tokens [B, T] (a padded chunk); history [B] int32, the tokens
    cached before this chunk; lengths [B] int32, the valid tokens in THIS
    chunk (0 => idle row). Each layer appends the chunk's rows at
    ``history + t`` with the window kernels and attends through the page
    table (``chunk_attention``). Returns (the chunk's last-token logits
    [B, V] float32, k_pages, v_pages)."""
    B, T = tokens.shape
    offs = torch.arange(T, device=tokens.device, dtype=torch.int32).expand(B, T)
    positions = history[:, None] + offs
    x = _embed(params, cfg, tokens)
    # the window write takes (history, lengths), not per-row write positions
    x = _run_layers(cfg, params, x, k_pages, v_pages, page_table, positions, None,
                    lengths, "chunk", adapter_idx=adapter_idx,
                    token_valid=offs < lengths[:, None], moe_workspace=moe_workspace)
    last = (lengths.long() - 1).clamp(0, T - 1)
    x_last = x[torch.arange(B, device=x.device), last]
    return _logits(params, cfg, x_last), k_pages, v_pages


def forward_verify(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   history: torch.Tensor, lengths: torch.Tensor, k_pages, v_pages,
                   page_table: torch.Tensor, adapter_idx: Optional[torch.Tensor] = None,
                   moe_workspace=None):
    """The speculative-decoding verify pass (the JAX ``forward_verify``):
    ``forward_chunk`` over a short candidate window, returning the logits
    at EVERY window position. tokens [B, T] (the committed token, then the
    drafts); history [B] int32, the tokens cached before the window;
    lengths [B] int32, the valid tokens in the window (0 => idle row).
    Each layer appends the window's rows at ``history + t`` with the
    window kernel and attends through the page table (``chunk_attention``),
    so position t's logits are the model's distribution for the token
    after ``tokens[:, t]``. Rows past a row's length are garbage the caller
    masks; a rejected suffix's KV is overwritten by the next dispatch,
    which starts at the accepted length. Returns (logits [B, T, V]
    float32, k_pages, v_pages)."""
    B, T = tokens.shape
    offs = torch.arange(T, device=tokens.device, dtype=torch.int32).expand(B, T)
    positions = history[:, None] + offs
    x = _embed(params, cfg, tokens)
    x = _run_layers(cfg, params, x, k_pages, v_pages, page_table, positions, None,
                    lengths, "chunk", adapter_idx=adapter_idx,
                    token_valid=offs < lengths[:, None], moe_workspace=moe_workspace)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps, style=cfg.norm_style)
    logits = _logits(params, cfg, x.reshape(B * T, -1), normed=True)
    return logits.reshape(B, T, -1), k_pages, v_pages
