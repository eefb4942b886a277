"""Plain attention ops over the paged KV cache, and the dispatchers the
decoder calls (counterpart of ``llms_on_kubernetes_tpu/ops/attention.py``).

``prefill_attention`` and ``paged_attention`` are the semantically
authoritative gather-and-einsum versions: f32 softmax, masking by
where-substitution with the finite ``NEG_INF`` so a row whose keys are all
masked stays finite. The hand-written CUDA kernels (ops/flash_attention.py,
ops/paged_attention.py) are held against them.

The dispatchers choose by the device of the tensors they are given: a CUDA
tensor goes to the kernel, which raises on a shape it does not take; a CPU
tensor goes to the plain version. The JAX dispatchers' Mosaic guards
(``d % 128``, ``page % 8``) are TPU tiling rules and do not carry over.
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
    """A pool's logical KV [n_kv, B, S, d] in f32, through the page table."""
    data = getattr(pool, "data", pool)
    n_kv = data.shape[0]
    return data[:, page_table.long()].reshape(n_kv, B, S, d).float()


def prefill_attention(q, k, v, lengths, *, scale: float,
                      sliding_window: Optional[int] = None,
                      attn_softcap: Optional[float] = None) -> torch.Tensor:
    """Causal self-attention over a (padded) prompt chunk.

    q [B, T, n_q, d]; k, v [B, T, n_kv, d]; lengths [B] int32 (keys at or
    beyond a row's length are masked). Returns [B, T, n_q, d]."""
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
    mask = mask[None] & (k_pos[None] < lengths.long()[:, None, None])   # [B, T, T]
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


# ---------------------------------------------------------------------------
# Dispatchers (what the decoder calls)
# ---------------------------------------------------------------------------

def dispatch_prefill_attention(q, k, v, lengths, *, scale, sliding_window=None,
                               attn_softcap=None):
    from llms_on_kubernetes_tpu_torch.ops.flash_attention import flash_prefill_attention

    return flash_prefill_attention(q, k, v, lengths, scale=scale,
                                   sliding_window=sliding_window,
                                   attn_softcap=attn_softcap)


def dispatch_paged_attention(q, k_pages, v_pages, page_table, lengths, *,
                             scale, sliding_window=None, attn_softcap=None):
    from llms_on_kubernetes_tpu_torch.ops.paged_attention import paged_decode_attention

    return paged_decode_attention(
        q, getattr(k_pages, "data", k_pages), getattr(v_pages, "data", v_pages),
        page_table, lengths, scale=scale, sliding_window=sliding_window,
        attn_softcap=attn_softcap)


def dispatch_paged_attention_write(q, k_pages, v_pages, page_table, lengths,
                                   k_new, v_new, write_positions, *, scale,
                                   sliding_window=None, attn_softcap=None,
                                   kv_write: str = "dus"):
    """Decode attention with the current token's KV append.

    ``kv_write="fused"`` folds the append into the attention kernel
    (ops/paged_attention.paged_decode_attention_write); ``"dus"`` runs
    ``write_tokens`` and then the decode kernel. Both update the pools IN
    PLACE. q [B, n_q, d]; k_new/v_new [B, n_kv, d] (post-rope);
    write_positions [B, 1] (negative => idle/trash).
    Returns (attn [B, n_q, d], k_pages, v_pages)."""
    if kv_write == "fused":
        from llms_on_kubernetes_tpu_torch.ops.paged_attention import (
            paged_decode_attention_write,
        )

        attn = paged_decode_attention_write(
            q, getattr(k_pages, "data", k_pages), getattr(v_pages, "data", v_pages),
            page_table, lengths, k_new, v_new, scale=scale,
            sliding_window=sliding_window, attn_softcap=attn_softcap)
        return attn, k_pages, v_pages
    if kv_write != "dus":
        raise ValueError(f"kv_write must be 'dus' or 'fused', got {kv_write!r}")
    from llms_on_kubernetes_tpu_torch.engine.cache import write_tokens

    write_tokens(k_pages, v_pages, k_new[:, None], v_new[:, None], page_table,
                 write_positions)
    attn = dispatch_paged_attention(
        q, k_pages, v_pages, page_table, lengths, scale=scale,
        sliding_window=sliding_window, attn_softcap=attn_softcap)
    return attn, k_pages, v_pages
