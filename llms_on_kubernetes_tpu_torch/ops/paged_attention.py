"""Paged decode attention: the CUDA kernels' wrappers and their plain
versions (counterpart of ``llms_on_kubernetes_tpu/ops/pallas_paged.py``:
``pallas_paged_attention`` and ``pallas_paged_attention_write``).

Both wrappers launch ``csrc/paged_decode.cu`` for CUDA tensors and run the
plain version for CPU tensors; a CUDA tensor never takes the plain version.

- ``paged_decode_attention``: single-token decode attention through the
  page table. Plain version: ``ops/attention.paged_attention``.
- ``paged_decode_attention_write``: the same attention, plus the append of
  the current token's K/V at position ``length - 1``, IN PLACE in the pool
  tensors (nothing is written for ``length == 0``). Plain version:
  ``engine/cache.write_tokens`` followed by ``paged_attention``, which
  writes idle rows to the trash page instead; every other pool byte is the
  same after both.

The kernels attend only to keys ``[0, length)``; an idle slot's output is
zeros from the kernels and the average of the trash page from the plain
versions. Both are finite, and the engine discards them.
"""

from __future__ import annotations

from typing import Optional

import torch

from llms_on_kubernetes_tpu_torch import kernels
from llms_on_kubernetes_tpu_torch.ops.attention import paged_attention

KERNEL = "paged_decode"
KERNEL_WRITE = "paged_decode_write"
MAX_GROUP = 8       # query heads per KV head the kernel serves (kMaxGroup)
SPLIT_KEYS = 256    # key positions per block of the kernel (kSplitKeys)


def paged_decode_attention_plain(q, k_pages, v_pages, page_table, lengths, *,
                                 scale: float, sliding_window: Optional[int] = None,
                                 attn_softcap: Optional[float] = None) -> torch.Tensor:
    """The plain PyTorch version of the decode kernel."""
    return paged_attention(q, k_pages, v_pages, page_table, lengths, scale=scale,
                           sliding_window=sliding_window, attn_softcap=attn_softcap)


def paged_decode_attention_write_plain(q, k_pages, v_pages, page_table, lengths,
                                       k_new, v_new, *, scale: float,
                                       sliding_window: Optional[int] = None,
                                       attn_softcap: Optional[float] = None) -> torch.Tensor:
    """The plain PyTorch version of the fused kernel: ``write_tokens`` (in
    place) then the plain decode attention."""
    from llms_on_kubernetes_tpu_torch.engine.cache import write_tokens

    wp = torch.where(lengths > 0, lengths - 1, -1)[:, None].to(torch.int32)
    write_tokens(k_pages, v_pages, k_new[:, None], v_new[:, None], page_table, wp)
    return paged_attention(q, k_pages, v_pages, page_table, lengths, scale=scale,
                           sliding_window=sliding_window, attn_softcap=attn_softcap)


def _launch(name: str, q, k_pages, v_pages, page_table, lengths, k_new, v_new, *,
            scale, sliding_window, attn_softcap) -> torch.Tensor:
    B, n_q, d = q.shape
    n_kv, pool_pages, page, dk = k_pages.shape
    if q.dtype not in kernels.DTYPE_CODES:
        raise ValueError(f"paged decode kernel takes float32/bfloat16, got {q.dtype}")
    if d not in kernels.HEAD_DIMS or dk != d:
        raise ValueError(f"paged decode kernel takes head_dim in {kernels.HEAD_DIMS} "
                         f"matching the pool's, got q {d}, pool {dk}")
    if n_kv == 0 or n_q % n_kv or n_q // n_kv > MAX_GROUP:
        raise ValueError(f"paged decode kernel takes n_q a multiple of n_kv with at "
                         f"most {MAX_GROUP} per KV head, got {n_q}/{n_kv}")
    kernels.check_tensor("q", q, ndim=3)
    for nm, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        kernels.check_tensor(nm, t, dtype=q.dtype, ndim=4, device=q.device, align=16)
    if v_pages.shape != k_pages.shape:
        raise ValueError("k_pages and v_pages differ in shape")
    kernels.check_tensor("page_table", page_table, dtype=torch.int32, ndim=2,
                         device=q.device)
    kernels.check_tensor("lengths", lengths, dtype=torch.int32, ndim=1, device=q.device)
    if page_table.shape[0] != B or lengths.shape[0] != B:
        raise ValueError("page_table and lengths need one row per slot")
    write = k_new is not None
    if write:
        for nm, t in (("k_new", k_new), ("v_new", v_new)):
            kernels.check_tensor(nm, t, dtype=q.dtype, ndim=3, device=q.device, align=16)
            if tuple(t.shape) != (B, n_kv, d):
                raise ValueError(f"{nm} has shape {tuple(t.shape)}, expected {(B, n_kv, d)}")
    pps = page_table.shape[1]
    n_split = -(-pps * page // SPLIT_KEYS)
    out = torch.empty_like(q)
    part_ml = torch.empty((2, B, n_q, n_split), dtype=torch.float32, device=q.device)
    part_acc = torch.empty((B, n_q, n_split, d), dtype=torch.float32, device=q.device)
    fn = kernels.function(KERNEL)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             page_table.data_ptr(), lengths.data_ptr(),
             k_new.data_ptr() if write else None, v_new.data_ptr() if write else None,
             part_ml[0].data_ptr(), part_ml[1].data_ptr(), part_acc.data_ptr(),
             out.data_ptr(), B, n_q, n_kv, pool_pages, page, pps, n_split, d,
             float(scale), int(sliding_window or 0), float(attn_softcap or 0.0),
             int(write), kernels.DTYPE_CODES[q.dtype], kernels.stream_ptr(q))
    kernels.check(name, err)
    kernels.LAUNCHES[name] += 1
    return out


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor, *, scale: float,
                           sliding_window: Optional[int] = None,
                           attn_softcap: Optional[float] = None) -> torch.Tensor:
    """q [B, n_q, d]; k/v_pages [n_kv, P, page, d] (head-major pool);
    page_table [B, pages_per_seq] int32 global page ids; lengths [B] int32
    counting the keys INCLUDING the current token. Returns [B, n_q, d]."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pages, v_pages, page_table, lengths, scale=scale,
            sliding_window=sliding_window, attn_softcap=attn_softcap)
    return _launch(KERNEL, q, k_pages, v_pages, page_table, lengths, None, None,
                   scale=scale, sliding_window=sliding_window,
                   attn_softcap=attn_softcap)


def paged_decode_attention_write(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor, page_table: torch.Tensor,
                                 lengths: torch.Tensor, k_new: torch.Tensor,
                                 v_new: torch.Tensor, *, scale: float,
                                 sliding_window: Optional[int] = None,
                                 attn_softcap: Optional[float] = None) -> torch.Tensor:
    """Decode attention with the in-place append of the current token.

    As ``paged_decode_attention``, plus k_new/v_new [B, n_kv, d] (post-rope;
    cast to the pool dtype) stored IN PLACE in ``k_pages``/``v_pages`` at
    position ``lengths[b] - 1`` of slot b, for every slot with length > 0.
    Returns the attention output [B, n_q, d]."""
    if q.device.type == "cpu":
        return paged_decode_attention_write_plain(
            q, k_pages, v_pages, page_table, lengths, k_new, v_new, scale=scale,
            sliding_window=sliding_window, attn_softcap=attn_softcap)
    # in the pool dtype and contiguous, with no copy when it already is (the
    # decoder's k[:, 0]); _launch raises on a view that starts off 16 bytes
    return _launch(KERNEL_WRITE, q, k_pages, v_pages, page_table, lengths,
                   k_new.to(k_pages.dtype).contiguous(),
                   v_new.to(v_pages.dtype).contiguous(),
                   scale=scale, sliding_window=sliding_window, attn_softcap=attn_softcap)
