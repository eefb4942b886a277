"""Plain attention ops over the paged KV cache, and the dispatchers the
decoder calls (counterpart of ``llms_on_kubernetes_tpu/ops/attention.py``).

``prefill_attention``, ``paged_attention`` and ``chunk_attention`` are the
semantically authoritative gather-and-einsum versions: f32 softmax, masking
by where-substitution with the finite ``NEG_INF`` so a row whose keys are
all masked stays finite. The hand-written CUDA kernels
(ops/flash_attention.py, ops/paged_attention.py) are held against the first
two; ``chunk_attention`` has no kernel (the JAX package leaves it to XLA).

The dispatchers choose by the device of the tensors they are given: a CUDA
tensor goes to the kernel, which raises on a shape it does not take; a CPU
tensor goes to the plain version. A quantized (int8) ``KVPool`` goes to the
int8 kernels. The JAX dispatchers' Mosaic guards (``d % 128``,
``page % 8``, the int8 ``page % 128``) are TPU tiling rules and do not
carry over.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0e38  # large finite negative; avoids NaN from (-inf) - (-inf)


def softcap(logits: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2-style tanh soft-capping (no-op when cap is None)."""
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


def _softmax_masked(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return probs / probs.sum(dim=-1, keepdim=True)


def _gather_pool(pool, page_table: torch.Tensor, B: int, S: int, d: int) -> torch.Tensor:
    """A pool's logical KV [n_kv, B, S, d] in f32, through the page table,
    dequantized per token when the pool is int8 (engine/cache.py KVPool)."""
    data = getattr(pool, "data", pool)
    n_kv = data.shape[0]
    pt = page_table.long()
    x = data[:, pt].reshape(n_kv, B, S, d).float()
    if getattr(pool, "quantized", False):
        x = x * pool.scale[:, pt].reshape(n_kv, B, S)[..., None]
    return x


def prefill_attention(q, k, v, lengths, *, scale: float,
                      sliding_window: Optional[int] = None,
                      attn_softcap: Optional[float] = None,
                      mm_groups: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal self-attention over a (padded) prompt chunk.

    q [B, T, n_q, d]; k, v [B, T, n_kv, d]; lengths [B] int32 (keys at or
    beyond a row's length are masked). ``mm_groups`` [B, T] int32, each
    position's image group (-1 for text): a key in the query's own group
    is visible whatever the causal and window tests say (gemma-3's
    bidirectional image blocks); the length mask still applies. Returns
    [B, T, n_q, d]."""
    B, T, n_q, d = q.shape
    n_kv = k.shape[2]
    group = n_q // n_kv
    qg = q.reshape(B, T, n_kv, group, d).float()
    logits = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * scale
    logits = softcap(logits, attn_softcap)
    q_pos = torch.arange(T, device=q.device)[:, None]
    k_pos = torch.arange(T, device=q.device)[None, :]
    mask = k_pos <= q_pos
    if sliding_window is not None:
        mask = mask & (k_pos > q_pos - sliding_window)
    mask = mask[None].expand(B, T, T)
    if mm_groups is not None:
        g = mm_groups.long()
        mask = mask | ((g[:, :, None] >= 0) & (g[:, :, None] == g[:, None, :]))
    mask = mask & (k_pos[None] < lengths.long()[:, None, None])         # [B, T, T]
    probs = _softmax_masked(logits, mask[:, None, None])
    out = torch.einsum("bkgts,bskd->btkgd", probs, v.float())
    return out.reshape(B, T, n_q, d).to(q.dtype)


def paged_attention(q, k_pages, v_pages, page_table, lengths, *, scale: float,
                    sliding_window: Optional[int] = None,
                    attn_softcap: Optional[float] = None) -> torch.Tensor:
    """Single-token decode attention against the paged KV cache.

    q [B, n_q, d]; k/v_pages [n_kv, P, page, d] (head-major pool, or a
    KVPool); page_table [B, pages_per_seq] int32; lengths [B] int32 counts
    the keys INCLUDING the current token. Returns [B, n_q, d]."""
    B, n_q, d = q.shape
    data = getattr(k_pages, "data", k_pages)
    n_kv, _P, page, _ = data.shape
    S = page_table.shape[1] * page
    group = n_q // n_kv
    k = _gather_pool(k_pages, page_table, B, S, d)
    v = _gather_pool(v_pages, page_table, B, S, d)
    qg = q.reshape(B, n_kv, group, d).float()
    logits = torch.einsum("bkgd,kbsd->bkgs", qg, k) * scale
    logits = softcap(logits, attn_softcap)
    k_pos = torch.arange(S, device=q.device)[None, :]
    lens = lengths.long()[:, None]
    mask = k_pos < lens
    if sliding_window is not None:
        mask = mask & (k_pos > lens - 1 - sliding_window)
    probs = _softmax_masked(logits, mask[:, None, None])
    out = torch.einsum("bkgs,kbsd->bkgd", probs, v)
    return out.reshape(B, n_q, d).to(q.dtype)


def chunk_attention(q, k_pages, v_pages, page_table, history, chunk_lengths, *,
                    scale: float, sliding_window: Optional[int] = None,
                    attn_softcap: Optional[float] = None) -> torch.Tensor:
    """Prefill-with-history attention: a prompt CHUNK against the paged pool.

    The chunk's KV is already in the pages, so each query at global
    position ``history + t`` attends causally to every cached key (earlier
    chunks' and this chunk's) through the page table, read back as stored
    (dequantized for an int8 pool).

    q [B, T, n_q, d]; k/v_pages [n_kv, P, page, d] (or KVPools);
    page_table [B, pages_per_seq] int32; history [B] int32, the tokens
    cached before this chunk; chunk_lengths [B] int32, the valid tokens in
    this chunk (0 => idle row). Returns [B, T, n_q, d]."""
    B, T, n_q, d = q.shape
    data = getattr(k_pages, "data", k_pages)
    n_kv, _P, page, _ = data.shape
    S = page_table.shape[1] * page
    group = n_q // n_kv
    k = _gather_pool(k_pages, page_table, B, S, d)
    v = _gather_pool(v_pages, page_table, B, S, d)
    qg = q.reshape(B, T, n_kv, group, d).float()
    logits = torch.einsum("btkgd,kbsd->bkgts", qg, k) * scale        # [B, n_kv, g, T, S]
    logits = softcap(logits, attn_softcap)
    hist = history.long()
    q_pos = hist[:, None] + torch.arange(T, device=q.device)[None]     # [B, T]
    k_pos = torch.arange(S, device=q.device)[None, None]               # [1, 1, S]
    mask = k_pos <= q_pos[:, :, None]                                  # causal
    # bound reads to the written region (garbage beyond history + chunk)
    mask = mask & (k_pos < (hist + chunk_lengths.long())[:, None, None])
    if sliding_window is not None:
        mask = mask & (k_pos > q_pos[:, :, None] - sliding_window)
    probs = _softmax_masked(logits, mask[:, None, None])
    out = torch.einsum("bkgts,kbsd->btkgd", probs, v)
    return out.reshape(B, T, n_q, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Dispatchers (what the decoder calls)
# ---------------------------------------------------------------------------

def dispatch_prefill_attention(q, k, v, lengths, *, scale, sliding_window=None,
                               attn_softcap=None, mm_groups=None, group_spans=None):
    """The prefill's attention: the flash kernel on a card, image groups
    included (the JAX dispatcher sends ``mm_groups`` to XLA's plain path;
    here the kernel takes them, with their ``group_spans``), the plain
    version on the CPU."""
    from llms_on_kubernetes_tpu_torch.ops.flash_attention import flash_prefill_attention

    return flash_prefill_attention(q, k, v, lengths, scale=scale,
                                   sliding_window=sliding_window,
                                   attn_softcap=attn_softcap, mm_groups=mm_groups,
                                   group_spans=group_spans)


def dispatch_chunk_attention(q, k_pages, v_pages, page_table, history, chunk_lengths, *,
                             scale, sliding_window=None, attn_softcap=None):
    """The chunk path's attention: ``chunk_attention`` on every device. The
    JAX package computes it in XLA, outside any Pallas kernel, so the
    gather and einsum here are its faithful port (a hand-written chunk
    kernel is later work)."""
    return chunk_attention(q, k_pages, v_pages, page_table, history, chunk_lengths,
                           scale=scale, sliding_window=sliding_window,
                           attn_softcap=attn_softcap)


def dispatch_paged_attention(q, k_pages, v_pages, page_table, lengths, *,
                             scale, sliding_window=None, attn_softcap=None, workspace=None):
    from llms_on_kubernetes_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_int8,
    )

    if getattr(k_pages, "quantized", False):
        return paged_decode_attention_int8(
            q, k_pages.data, k_pages.scale, v_pages.data, v_pages.scale, page_table,
            lengths, scale=scale, sliding_window=sliding_window,
            attn_softcap=attn_softcap, workspace=workspace)
    return paged_decode_attention(
        q, getattr(k_pages, "data", k_pages), getattr(v_pages, "data", v_pages),
        page_table, lengths, scale=scale, sliding_window=sliding_window,
        attn_softcap=attn_softcap, workspace=workspace)


def dispatch_paged_attention_write(q, k_pages, v_pages, page_table, lengths,
                                   k_new, v_new, write_positions, *, scale,
                                   sliding_window=None, attn_softcap=None,
                                   kv_write: str = "dus", workspace=None):
    """Decode attention with the current token's KV append.

    ``kv_write="fused"`` folds the append into the attention kernel
    (ops/paged_attention.paged_decode_attention_write, or its int8 twin
    that quantizes the row as it stores it); ``"dus"`` runs
    ``write_tokens`` and then the decode kernel. Both update the pools IN
    PLACE. q [B, n_q, d]; k_new/v_new [B, n_kv, d] (post-rope);
    write_positions [B, 1] (negative => idle/trash). ``workspace``: the
    decode kernels' scratch (ops/paged_attention.DecodeWorkspace; None =>
    the process-wide one).
    Returns (attn [B, n_q, d], k_pages, v_pages)."""
    if kv_write == "fused":
        from llms_on_kubernetes_tpu_torch.ops.paged_attention import (
            paged_decode_attention_write, paged_decode_attention_write_int8,
        )

        if getattr(k_pages, "quantized", False):
            attn = paged_decode_attention_write_int8(
                q, k_pages.data, k_pages.scale, v_pages.data, v_pages.scale, page_table,
                lengths, k_new, v_new, scale=scale, sliding_window=sliding_window,
                attn_softcap=attn_softcap, workspace=workspace)
            return attn, k_pages, v_pages
        attn = paged_decode_attention_write(
            q, getattr(k_pages, "data", k_pages), getattr(v_pages, "data", v_pages),
            page_table, lengths, k_new, v_new, scale=scale,
            sliding_window=sliding_window, attn_softcap=attn_softcap, workspace=workspace)
        return attn, k_pages, v_pages
    if kv_write != "dus":
        raise ValueError(f"kv_write must be 'dus' or 'fused', got {kv_write!r}")
    from llms_on_kubernetes_tpu_torch.engine.cache import write_tokens

    write_tokens(k_pages, v_pages, k_new[:, None], v_new[:, None], page_table,
                 write_positions)
    attn = dispatch_paged_attention(
        q, k_pages, v_pages, page_table, lengths, scale=scale,
        sliding_window=sliding_window, attn_softcap=attn_softcap, workspace=workspace)
    return attn, k_pages, v_pages
