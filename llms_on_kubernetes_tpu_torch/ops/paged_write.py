"""Windowed in-place KV append: the CUDA kernels' wrappers, their plain
versions and the dispatcher the decoder's chunk path calls (counterpart of
``llms_on_kubernetes_tpu/ops/pallas_paged.py``: ``pallas_paged_write_window``
and ``pallas_paged_write_window_int8``).

Each wrapper launches ``csrc/paged_write_window.cu`` for CUDA tensors and
runs its plain version for CPU tensors; a CUDA tensor never takes the plain
version.

- ``paged_write_window``: rows ``t < widths[b]`` of k_new/v_new
  [B, W, n_kv, d] go IN PLACE to positions ``base[b] + t`` of slot b,
  through the page table, in the pool dtype.
- ``paged_write_window_int8``: the same over an int8 pool, each (row, KV
  head) quantized as ``engine/cache.quantize_kv`` quantizes it (data and
  per-token f32 scale).

The kernels take any page size: each block writes one span, the rows of
the window that land in one run of at most ``SPAN_ROWS`` rows of one page,
the runs cut by in-page offset (``_window_spans``). They write those rows
and no other pool byte. The plain versions are
one indexed store a side (and a scale store for int8): the rows that must
not be written (past the width, or outside the page table) are redirected
to row 0 of trash page 0, so the store needs no host sync and leaves the
same bytes as the kernel everywhere outside page 0. Unlike
``write_tokens``' chunk branch, neither writes filler rows past a chunk.
"""

from __future__ import annotations

import torch

from llms_on_kubernetes_tpu_torch import kernels
from llms_on_kubernetes_tpu_torch.engine.cache import quantize_kv

SOURCE = "paged_write_window"
KERNEL = "paged_write_window"
KERNEL_INT8 = "paged_write_window_int8"
# rows a span of the kernels holds at most (kSpanRows in the source)
SPAN_ROWS = 16


def window_span_count(W: int, page: int, R: int = SPAN_ROWS) -> int:
    """The spans a slot the kernels' grid holds (``window_span_count`` in
    the source): the most pieces W consecutive positions can touch, where
    each page is cut into pieces of R rows by in-page offset (the last
    piece of a page holds the ``page % R`` rest, or R). ``W - 1 = q * page
    + r`` positions past the first cross q whole pages and r more rows,
    which hold the most piece starts when they begin at a page's last
    piece. Tight: some base reaches it."""
    per = -(-page // R)
    rem = page - (per - 1) * R
    q, r = divmod(W - 1, page)
    n = 1 + q * per
    if r > 0:
        n += 1 + (1 + (r - 1 - rem) // R if r - 1 >= rem else 0)
    return n


def _window_spans(base, widths, W: int, page: int, pps: int,
                  R: int = SPAN_ROWS) -> list[tuple[int, int, int, int, int]]:
    """The kernels' span decomposition, in plain Python (the same formulas
    as ``window_span`` in ``csrc/paged_write_window.cu``): one entry
    ``(slot, span, first row t0, rows r, page slot)`` for each of the
    grid's ``window_span_count(W, page)`` spans a slot. Each page is cut
    into pieces by in-page offset, rows ``[R j, min(R j + R, page))``,
    numbered page by page; span s of slot b is the piece of position
    ``base[b]``, plus s, clipped to rows ``t < min(widths[b], W)`` and
    positions in ``[0, pps * page)``; ``r <= 0`` means the span writes
    nothing (its block returns at once). A written span's rows lie on page
    slot ``page slot`` of the table, at rows ``pos % page`` onwards. At a
    page of at most R rows or a multiple of R the pieces are the aligned
    runs of ``min(page, R)`` positions, found as the source finds them."""
    per = -(-page // R)
    n_spans = window_span_count(W, page, R)
    out = []
    for b, (b0, w) in enumerate(zip(base, widths)):
        b0, w = int(b0), int(w)
        pg0 = b0 // page
        for s in range(n_spans):
            if page <= R or page % R == 0:
                rp = min(page, R)
                k = b0 // rp + s
                start, stop = k * rp, (k + 1) * rp
            else:
                pg, j = divmod(pg0 * per + (b0 - pg0 * page) // R + s, per)
                start, stop = pg * page + j * R, pg * page + min((j + 1) * R, page)
            lo = max(b0, start, 0)
            hi = min(b0 + min(w, W), stop, pps * page)
            out.append((b, s, lo - b0, hi - lo, lo // page))
    return out


def _window_index(page_table: torch.Tensor, base: torch.Tensor, widths: torch.Tensor,
                  W: int, page: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(page id, row) [B * W] of each window row's pool slot; rows that are
    not written point at row 0 of trash page 0."""
    pps = page_table.shape[1]
    t = torch.arange(W, device=base.device)[None]
    pos = base.long()[:, None] + t
    ok = (t < widths.long()[:, None]) & (pos >= 0) & (pos < pps * page)
    safe = torch.where(ok, pos, 0)
    pid = torch.where(ok, torch.gather(page_table.long(), 1, safe // page), 0)
    return pid.reshape(-1), torch.where(ok, safe % page, 0).reshape(-1)


def paged_write_window_plain(k_pages, v_pages, page_table, base, widths, k_new, v_new):
    """The plain PyTorch version of the float window kernel."""
    B, W, n_kv, d = k_new.shape
    pid, off = _window_index(page_table, base, widths, W, k_pages.shape[2])
    k_pages[:, pid, off] = k_new.reshape(B * W, n_kv, d).transpose(0, 1).to(k_pages.dtype)
    v_pages[:, pid, off] = v_new.reshape(B * W, n_kv, d).transpose(0, 1).to(v_pages.dtype)
    return k_pages, v_pages


def paged_write_window_int8_plain(k_data, k_scale, v_data, v_scale, page_table, base, widths,
                                  k_new, v_new):
    """The plain PyTorch version of the int8 window kernel: ``quantize_kv``
    then the indexed stores of data and scales."""
    B, W, n_kv, d = k_new.shape
    pid, off = _window_index(page_table, base, widths, W, k_data.shape[2])
    for data, scale, x in ((k_data, k_scale, k_new), (v_data, v_scale, v_new)):
        q, s = quantize_kv(x)                  # int8 [B, W, n_kv, d], f32 [B, W, n_kv]
        data[:, pid, off] = q.reshape(B * W, n_kv, d).transpose(0, 1)
        scale[:, pid, off] = s.reshape(B * W, n_kv).transpose(0, 1)
    return k_data, k_scale, v_data, v_scale


def _launch(name: str, k_pool, v_pool, page_table, base, widths, k_new, v_new,
            k_scale=None, v_scale=None) -> None:
    """Check the arguments and launch the window kernel (``k_scale`` given:
    the int8 one)."""
    n_kv, pool_pages, page, d = k_pool.shape
    quant = k_scale is not None
    dev = k_new.device
    if d not in kernels.HEAD_DIMS:
        raise ValueError(f"window write kernel takes head_dim in {kernels.HEAD_DIMS}, got {d}")
    pool_dtype = torch.int8 if quant else k_pool.dtype
    if pool_dtype not in kernels.POOL_CODES:
        raise ValueError(f"window write kernel takes float32/bfloat16/int8 pools, "
                         f"got {k_pool.dtype}")
    if quant and k_pool.dtype != torch.int8:
        raise ValueError(f"an int8 pool must be int8, got {k_pool.dtype}")
    for nm, t in (("k_pages", k_pool), ("v_pages", v_pool)):
        kernels.check_tensor(nm, t, dtype=pool_dtype, ndim=4, device=dev, align=16)
    if v_pool.shape != k_pool.shape:
        raise ValueError("k_pages and v_pages differ in shape")
    if quant:
        for nm, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            kernels.check_tensor(nm, t, dtype=torch.float32, ndim=3, device=dev)
            if t.shape != k_pool.shape[:3]:
                raise ValueError(f"{nm} has shape {tuple(t.shape)}, expected "
                                 f"{tuple(k_pool.shape[:3])}")
    # the float kernel stores the rows as they are (the pool dtype); the
    # int8 one quantizes float32 or bfloat16 rows
    if quant and k_new.dtype not in kernels.DTYPE_CODES:
        raise ValueError(f"k_new must be float32/bfloat16 for an int8 pool, got {k_new.dtype}")
    B, W = k_new.shape[:2]
    for nm, t in (("k_new", k_new), ("v_new", v_new)):
        kernels.check_tensor(nm, t, dtype=k_new.dtype if quant else pool_dtype, ndim=4,
                             device=dev, align=16)
        if tuple(t.shape) != (B, W, n_kv, d):
            raise ValueError(f"{nm} has shape {tuple(t.shape)}, expected {(B, W, n_kv, d)}")
    kernels.check_tensor("page_table", page_table, dtype=torch.int32, ndim=2, device=dev)
    for nm, t in (("base", base), ("widths", widths)):
        kernels.check_tensor(nm, t, dtype=torch.int32, ndim=1, device=dev)
        if t.shape[0] != B:
            raise ValueError(f"{nm} needs one entry per slot, got {t.shape[0]} for {B}")
    if page_table.shape[0] != B:
        raise ValueError("page_table needs one row per slot")
    # what the grid and the kernels' 32-bit index math take
    if B > 65535:
        raise ValueError(f"window write kernel takes at most 65535 slots, got {B}")
    for nm, t in (("k_new", k_new), ("page_table", page_table)):
        if t.numel() >= 2 ** 31:
            raise ValueError(f"{nm} has {t.numel()} elements; the kernel indexes under 2^31")
    if B * W == 0:
        return
    fn = kernels.function(SOURCE)
    err = fn(k_pool.data_ptr(), k_scale.data_ptr() if quant else None, v_pool.data_ptr(),
             v_scale.data_ptr() if quant else None, page_table.data_ptr(), base.data_ptr(),
             widths.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), B, W, n_kv, pool_pages,
             page, page_table.shape[1], d, kernels.POOL_CODES[pool_dtype],
             kernels.POOL_CODES[k_new.dtype], kernels.stream_ptr(k_new))
    kernels.check(name, err)
    kernels.count(name)


def paged_write_window(k_pages: torch.Tensor, v_pages: torch.Tensor, page_table: torch.Tensor,
                       base: torch.Tensor, widths: torch.Tensor, k_new: torch.Tensor,
                       v_new: torch.Tensor):
    """Append up to W rows per slot IN PLACE: k/v_pages [n_kv, P, page, d]
    (head-major pool); page_table [B, pages_per_seq] int32 global page ids;
    base [B] int32, the position of row 0; widths [B] int32, the rows to
    write (0 => idle slot); k_new/v_new [B, W, n_kv, d], cast to the pool
    dtype. Returns (k_pages, v_pages)."""
    if k_new.device.type == "cpu":
        return paged_write_window_plain(k_pages, v_pages, page_table, base, widths, k_new,
                                        v_new)
    # in the pool dtype and contiguous, with no copy when it already is
    _launch(KERNEL, k_pages, v_pages, page_table, base, widths,
            k_new.to(k_pages.dtype).contiguous(), v_new.to(v_pages.dtype).contiguous())
    return k_pages, v_pages


def paged_write_window_int8(k_data: torch.Tensor, k_scale: torch.Tensor, v_data: torch.Tensor,
                            v_scale: torch.Tensor, page_table: torch.Tensor, base: torch.Tensor,
                            widths: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor):
    """The quantizing append over an int8 pool: as ``paged_write_window``,
    with k/v_data [n_kv, P, page, d] int8 and k/v_scale [n_kv, P, page]
    float32; each written (row, KV head) of k_new/v_new (float32 or
    bfloat16) is stored as ``quantize_kv``'s int8 row and scale. Returns
    (k_data, k_scale, v_data, v_scale)."""
    if k_new.device.type == "cpu":
        return paged_write_window_int8_plain(k_data, k_scale, v_data, v_scale, page_table,
                                             base, widths, k_new, v_new)
    _launch(KERNEL_INT8, k_data, v_data, page_table, base, widths, k_new.contiguous(),
            v_new.contiguous(), k_scale=k_scale, v_scale=v_scale)
    return k_data, k_scale, v_data, v_scale


def dispatch_write_window(k_pages, v_pages, page_table, base, widths, k_new, v_new):
    """The window append the decoder's chunk path calls, by the kind of
    pool: a quantized ``KVPool`` (engine/cache.py) takes the int8 kernel,
    any other pool the float one. Updates the pools in place and returns
    them."""
    if getattr(k_pages, "quantized", False):
        paged_write_window_int8(k_pages.data, k_pages.scale, v_pages.data, v_pages.scale,
                                page_table, base, widths, k_new, v_new)
    else:
        paged_write_window(getattr(k_pages, "data", k_pages), getattr(v_pages, "data", v_pages),
                           page_table, base, widths, k_new, v_new)
    return k_pages, v_pages
