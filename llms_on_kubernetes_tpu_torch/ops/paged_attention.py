"""Paged decode attention: the CUDA kernels' wrappers and their plain
versions (counterpart of ``llms_on_kubernetes_tpu/ops/pallas_paged.py``:
``pallas_paged_attention``, ``pallas_paged_attention_write`` and their
int8 twins ``pallas_paged_attention_int8`` and
``pallas_paged_attention_write_int8``).

Every wrapper launches its kernel (``csrc/paged_decode.cu`` for float
pools, ``csrc/paged_decode_int8.cu`` for int8 pools) for CUDA tensors and
runs the plain version for CPU tensors; a CUDA tensor never takes the
plain version.

- ``paged_decode_attention``: single-token decode attention through the
  page table. Plain version: ``ops/attention.paged_attention``.
- ``paged_decode_attention_write``: the same attention, plus the append of
  the current token's K/V at position ``length - 1``, IN PLACE in the pool
  tensors (nothing is written for ``length == 0``). Plain version:
  ``engine/cache.write_tokens`` followed by ``paged_attention``, which
  writes idle rows to the trash page instead; every other pool byte is the
  same after both.
- ``paged_decode_attention_int8`` / ``paged_decode_attention_write_int8``:
  the same over an int8 pool (data [n_kv, P, page, d] int8, per-token
  scale [n_kv, P, page] f32). The write kernel quantizes the current
  token's row as ``engine/cache.quantize_kv`` does (same bytes) and attends
  to it with those quantized values. Plain versions: ``paged_attention``
  over the dequantized pool, and int8 ``write_tokens`` followed by it.

The kernels attend only to keys ``[0, length)``; an idle slot's output is
zeros from the kernels and the average of the trash page from the plain
versions. Both are finite, and the engine discards them.
"""

from __future__ import annotations

from typing import Optional

import torch

from llms_on_kubernetes_tpu_torch import kernels
from llms_on_kubernetes_tpu_torch.engine.cache import KVPool, write_tokens
from llms_on_kubernetes_tpu_torch.ops.attention import paged_attention

KERNEL = "paged_decode"
KERNEL_WRITE = "paged_decode_write"
KERNEL_INT8 = "paged_decode_int8"
KERNEL_WRITE_INT8 = "paged_decode_write_int8"
MAX_GROUP = 8       # query heads per KV head the kernel serves (kMaxGroup)
SPLIT_KEYS = 256    # key positions per block of the kernel (kSplitKeys)


def workspace_sizes(B: int, n_q: int, n_kv: int, n_split: int, d: int) -> tuple:
    """(float32 partials, int32 counters) one decode launch needs: each
    key split's max, sum and d accumulators per query row, and one arrival
    counter per (slot, KV head)."""
    return B * n_q * n_split * (d + 2), B * n_kv


class DecodeWorkspace:
    """The decode kernels' scratch: the splits' partials and the arrival
    counters by which the last split of a (slot, KV head) knows to merge.
    The counters are zeros when made, and every launch leaves them zero,
    so no call clears them (that would be a second launch). Launches that
    share a workspace must be ordered: one stream, as an engine runs.

    Each engine owns one (``Engine.workspace``), sized by its first decode
    window and then frozen when the window is captured as a CUDA graph: a
    graph holds the buffers' addresses, so a later call that needs more
    room raises instead of replacing them under the graph. ``WORKSPACE``
    is the process-wide one that a direct caller (a test, a kernel check)
    gets when it passes none; it grows on demand, one pair a device."""

    def __init__(self):
        self._bufs: dict = {}
        self.frozen = False

    def get(self, device: torch.device, B: int, n_q: int, n_kv: int, n_split: int,
            d: int) -> tuple:
        """(part, counters) for a launch of this shape on ``device``."""
        n_part, n_count = workspace_sizes(B, n_q, n_kv, n_split, d)
        part, counters = self._bufs.get(device, (None, None))
        grow_part = part is None or part.numel() < n_part
        grow_count = counters is None or counters.numel() < n_count
        if (grow_part or grow_count) and self.frozen:
            raise RuntimeError(f"decode workspace on {device} is held by a captured graph "
                               f"and cannot grow to {n_part} partials, {n_count} counters")
        if grow_part:
            part = torch.empty(n_part, dtype=torch.float32, device=device)
        if grow_count:
            counters = torch.zeros(n_count, dtype=torch.int32, device=device)
        self._bufs[device] = (part, counters)
        return part, counters


WORKSPACE = DecodeWorkspace()


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
    wp = torch.where(lengths > 0, lengths - 1, -1)[:, None].to(torch.int32)
    write_tokens(k_pages, v_pages, k_new[:, None], v_new[:, None], page_table, wp)
    return paged_attention(q, k_pages, v_pages, page_table, lengths, scale=scale,
                           sliding_window=sliding_window, attn_softcap=attn_softcap)


def paged_decode_attention_int8_plain(q, k_data, k_scale, v_data, v_scale, page_table,
                                      lengths, *, scale: float,
                                      sliding_window: Optional[int] = None,
                                      attn_softcap: Optional[float] = None) -> torch.Tensor:
    """The plain PyTorch version of the int8 decode kernel: attention over
    the dequantized pool (``data * scale``)."""
    return paged_decode_attention_plain(
        q, KVPool(k_data, k_scale), KVPool(v_data, v_scale), page_table, lengths,
        scale=scale, sliding_window=sliding_window, attn_softcap=attn_softcap)


def paged_decode_attention_write_int8_plain(q, k_data, k_scale, v_data, v_scale,
                                            page_table, lengths, k_new, v_new, *,
                                            scale: float,
                                            sliding_window: Optional[int] = None,
                                            attn_softcap: Optional[float] = None
                                            ) -> torch.Tensor:
    """The plain PyTorch version of the int8 fused kernel: int8
    ``write_tokens`` (quantize, then store in place) then the plain int8
    decode attention."""
    return paged_decode_attention_write_plain(
        q, KVPool(k_data, k_scale), KVPool(v_data, v_scale), page_table, lengths, k_new,
        v_new, scale=scale, sliding_window=sliding_window, attn_softcap=attn_softcap)


def _launch(name: str, q, k_pages, v_pages, page_table, lengths, k_new, v_new, *,
            scale, sliding_window, attn_softcap, k_scale=None, v_scale=None,
            workspace: Optional[DecodeWorkspace] = None) -> torch.Tensor:
    """Check the arguments and launch the decode kernel (``k_scale`` given:
    the int8 one). ``k_new``/``v_new`` given: the fused append."""
    B, n_q, d = q.shape
    n_kv, pool_pages, page, dk = k_pages.shape
    quant = k_scale is not None
    pool_dtype = torch.int8 if quant else q.dtype
    if q.dtype not in kernels.DTYPE_CODES:
        raise ValueError(f"paged decode kernel takes float32/bfloat16, got {q.dtype}")
    if d not in kernels.HEAD_DIMS or dk != d:
        raise ValueError(f"paged decode kernel takes head_dim in {kernels.HEAD_DIMS} "
                         f"matching the pool's, got q {d}, pool {dk}")
    if n_kv == 0 or n_q % n_kv or n_q // n_kv > MAX_GROUP:
        raise ValueError(f"paged decode kernel takes n_q a multiple of n_kv with at "
                         f"most {MAX_GROUP} per KV head, got {n_q}/{n_kv}")
    kernels.check_tensor("q", q, ndim=3, align=16)
    for nm, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        kernels.check_tensor(nm, t, dtype=pool_dtype, ndim=4, device=q.device, align=16)
    if v_pages.shape != k_pages.shape:
        raise ValueError("k_pages and v_pages differ in shape")
    if quant:
        for nm, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            kernels.check_tensor(nm, t, dtype=torch.float32, ndim=3, device=q.device)
            if t.shape != k_pages.shape[:3]:
                raise ValueError(f"{nm} has shape {tuple(t.shape)}, expected "
                                 f"{tuple(k_pages.shape[:3])}")
    kernels.check_tensor("page_table", page_table, dtype=torch.int32, ndim=2,
                         device=q.device)
    kernels.check_tensor("lengths", lengths, dtype=torch.int32, ndim=1, device=q.device)
    if page_table.shape[0] != B or lengths.shape[0] != B:
        raise ValueError("page_table and lengths need one row per slot")
    write = k_new is not None
    if write:
        # the float kernel stores k_new as it is (pool dtype); the int8 one
        # quantizes it from q's dtype
        new_dtype = q.dtype if quant else pool_dtype
        for nm, t in (("k_new", k_new), ("v_new", v_new)):
            kernels.check_tensor(nm, t, dtype=new_dtype, ndim=3, device=q.device, align=16)
            if tuple(t.shape) != (B, n_kv, d):
                raise ValueError(f"{nm} has shape {tuple(t.shape)}, expected {(B, n_kv, d)}")
    pps = page_table.shape[1]
    n_split = -(-pps * page // SPLIT_KEYS)
    out = torch.empty_like(q)
    ws = WORKSPACE if workspace is None else workspace
    part, counters = ws.get(q.device, B, n_q, n_kv, n_split, d)
    pools = (k_pages.data_ptr(), v_pages.data_ptr())
    if quant:
        fn = kernels.function(KERNEL_INT8)
        pools = (k_pages.data_ptr(), k_scale.data_ptr(), v_pages.data_ptr(),
                 v_scale.data_ptr())
    else:
        fn = kernels.function(KERNEL)
    err = fn(q.data_ptr(), *pools, page_table.data_ptr(), lengths.data_ptr(),
             k_new.data_ptr() if write else None, v_new.data_ptr() if write else None,
             part.data_ptr(), counters.data_ptr(),
             out.data_ptr(), B, n_q, n_kv, pool_pages, page, pps, n_split, d,
             float(scale), int(sliding_window or 0), float(attn_softcap or 0.0),
             int(write), kernels.DTYPE_CODES[q.dtype], kernels.stream_ptr(q))
    kernels.check(name, err)
    kernels.count(name)
    return out


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor, *, scale: float,
                           sliding_window: Optional[int] = None,
                           attn_softcap: Optional[float] = None,
                           workspace: Optional[DecodeWorkspace] = None) -> torch.Tensor:
    """q [B, n_q, d]; k/v_pages [n_kv, P, page, d] (head-major pool);
    page_table [B, pages_per_seq] int32 global page ids; lengths [B] int32
    counting the keys INCLUDING the current token. Returns [B, n_q, d]."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pages, v_pages, page_table, lengths, scale=scale,
            sliding_window=sliding_window, attn_softcap=attn_softcap)
    return _launch(KERNEL, q, k_pages, v_pages, page_table, lengths, None, None,
                   scale=scale, sliding_window=sliding_window,
                   attn_softcap=attn_softcap, workspace=workspace)


def paged_decode_attention_write(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor, page_table: torch.Tensor,
                                 lengths: torch.Tensor, k_new: torch.Tensor,
                                 v_new: torch.Tensor, *, scale: float,
                                 sliding_window: Optional[int] = None,
                                 attn_softcap: Optional[float] = None,
                                 workspace: Optional[DecodeWorkspace] = None) -> torch.Tensor:
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
                   scale=scale, sliding_window=sliding_window, attn_softcap=attn_softcap,
                   workspace=workspace)


def paged_decode_attention_int8(q: torch.Tensor, k_data: torch.Tensor,
                                k_scale: torch.Tensor, v_data: torch.Tensor,
                                v_scale: torch.Tensor, page_table: torch.Tensor,
                                lengths: torch.Tensor, *, scale: float,
                                sliding_window: Optional[int] = None,
                                attn_softcap: Optional[float] = None,
                                workspace: Optional[DecodeWorkspace] = None) -> torch.Tensor:
    """Decode attention over an int8 pool: as ``paged_decode_attention``,
    with k/v_data [n_kv, P, page, d] int8 and k/v_scale [n_kv, P, page]
    float32 (one scale per cached token). Returns [B, n_q, d] in q's dtype."""
    if q.device.type == "cpu":
        return paged_decode_attention_int8_plain(
            q, k_data, k_scale, v_data, v_scale, page_table, lengths, scale=scale,
            sliding_window=sliding_window, attn_softcap=attn_softcap)
    return _launch(KERNEL_INT8, q, k_data, v_data, page_table, lengths, None, None,
                   scale=scale, sliding_window=sliding_window, attn_softcap=attn_softcap,
                   k_scale=k_scale, v_scale=v_scale, workspace=workspace)


def paged_decode_attention_write_int8(q: torch.Tensor, k_data: torch.Tensor,
                                      k_scale: torch.Tensor, v_data: torch.Tensor,
                                      v_scale: torch.Tensor, page_table: torch.Tensor,
                                      lengths: torch.Tensor, k_new: torch.Tensor,
                                      v_new: torch.Tensor, *, scale: float,
                                      sliding_window: Optional[int] = None,
                                      attn_softcap: Optional[float] = None,
                                      workspace: Optional[DecodeWorkspace] = None
                                      ) -> torch.Tensor:
    """int8 decode attention with the quantize-at-write append.

    As ``paged_decode_attention_int8``, plus k_new/v_new [B, n_kv, d]
    (post-rope, in q's dtype) quantized per (slot, KV head) with
    ``quantize_kv``'s arithmetic and stored IN PLACE, int8 row and scale,
    at position ``lengths[b] - 1`` of slot b, for every slot with
    length > 0. The current token is attended with its quantized value.
    Returns the attention output [B, n_q, d]."""
    if q.device.type == "cpu":
        return paged_decode_attention_write_int8_plain(
            q, k_data, k_scale, v_data, v_scale, page_table, lengths, k_new, v_new,
            scale=scale, sliding_window=sliding_window, attn_softcap=attn_softcap)
    # contiguous, with no copy when it already is (the decoder's k[:, 0])
    return _launch(KERNEL_WRITE_INT8, q, k_data, v_data, page_table, lengths,
                   k_new.contiguous(), v_new.contiguous(), scale=scale,
                   sliding_window=sliding_window, attn_softcap=attn_softcap,
                   k_scale=k_scale, v_scale=v_scale, workspace=workspace)
