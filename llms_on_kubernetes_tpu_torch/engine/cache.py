"""Paged KV cache: device-side page pool + host-side page allocator
(counterpart of ``llms_on_kubernetes_tpu/engine/cache.py``).

The layout is the JAX package's, so the tests compare like with like:

- ONE flat head-major pool per side, ``[n_kv, L * P, page_size, head_dim]``.
  Layer ``l``'s pages occupy the block ``[l*P, (l+1)*P)``; the decoder adds
  ``l*P`` to the per-layer-local page table inside the layer loop. One
  (head, page) slice is a contiguous ``[page, d]`` run, which is what the
  decode kernels stream.
- Physical page ``l*P`` (per-layer-local page 0) is a trash page: padded
  prompt positions and idle decode rows write there. It is never allocated
  and never read.
- The allocator is plain host Python handing out per-layer-local ids in
  ``[1, P)``.

JAX threads the pool functionally; here ``write_tokens`` and the fused
decode kernel update the pool tensors IN PLACE. int8 KV (a per-token scale
beside the data) waits for a later slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from llms_on_kubernetes_tpu_torch import resolve_device

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r} ({sorted(_DTYPES)})")
    return _DTYPES[name]


@dataclasses.dataclass
class CacheConfig:
    num_layers: int
    num_kv_heads: int
    head_dim: int
    num_pages: int = 2048
    page_size: int = 64
    pages_per_slot: int = 32
    dtype: str = "bfloat16"


class KVPool:
    """One side (K or V) of the paged cache: flat head-major ``data``
    [n_kv, L*P, page, d]. Updated in place."""

    def __init__(self, data: torch.Tensor):
        self.data = data

    def __repr__(self):
        return f"KVPool(shape={tuple(self.data.shape)}, dtype={self.data.dtype})"


def init_pages(cfg: CacheConfig, device="cuda") -> tuple[KVPool, KVPool]:
    """Zeroed flat head-major pools [n_kv, L * P, page, d] on ``device``."""
    device = resolve_device(device)
    shape = (cfg.num_kv_heads, cfg.num_layers * cfg.num_pages,
             cfg.page_size, cfg.head_dim)
    dt = torch_dtype(cfg.dtype)
    return (KVPool(torch.zeros(shape, dtype=dt, device=device)),
            KVPool(torch.zeros(shape, dtype=dt, device=device)))


# The JAX write_tokens writes whole pages for a chunk spanning up to this
# many pages and scatters single rows beyond it; the bytes it leaves differ
# only in filler rows, and the port leaves the same ones.
_MAX_RMW_PAGES = 33


def write_tokens(k_pages, v_pages, k: torch.Tensor, v: torch.Tensor,
                 page_table: torch.Tensor, positions: torch.Tensor):
    """Write new KV for one layer into the page pool IN PLACE.

    k_pages/v_pages: KVPool (or raw [n_kv, P_total, page, d] tensors)
    k, v:            [B, T, n_kv, d]
    page_table:      [B, pages_per_seq] int32 GLOBAL page ids (the layer
                     body has already added its l*P block offset)
    positions:       [B, T] int32 token positions; negative => trash page 0

    One indexed store per side, with the bytes the JAX ``write_tokens``
    leaves outside the trash pages:

    - T == 1 (decode): the row at each position; a negative position
      writes to trash page 0, row 0.
    - T > 1 and a span of more than ``_MAX_RMW_PAGES`` pages: the rows at
      their positions, as T == 1 (the JAX path's scatter fallback).
    - T > 1 otherwise (prefill, rows front-packed from ``positions[:, 0]``): the
      head page takes the chunk's valid rows only; every later page the
      chunk's span reaches is written whole, with the chunk row at the
      clamped offset as filler past the chunk (the JAX path's blind page
      writes). No length-masked read ever sees the filler. Idle rows and
      pages beyond the table go to the trash page.

    Entries that must not land anywhere are redirected to trash page 0, so
    the store needs no host sync. Returns the (same, updated) pools."""
    kd = getattr(k_pages, "data", k_pages)
    vd = getattr(v_pages, "data", v_pages)
    B, T, n_kv, d = k.shape
    page = kd.shape[2]
    pps = page_table.shape[1]
    pt = page_table.long()
    pos = positions.long()
    n_touch = (T - 1) // page + 2          # pages a T-token run can span
    if T == 1 or n_touch > _MAX_RMW_PAGES:
        safe = pos.clamp(min=0)
        logical = (safe // page).clamp(max=pps - 1)
        pid = torch.where(pos < 0, 0, torch.gather(pt, 1, logical)).reshape(-1)
        off = torch.where(pos < 0, 0, safe % page).reshape(-1)
        kd[:, pid, off] = k.reshape(B * T, n_kv, d).transpose(0, 1).to(kd.dtype)
        vd[:, pid, off] = v.reshape(B * T, n_kv, d).transpose(0, 1).to(vd.dtype)
        return k_pages, v_pages

    dev = k.device
    valid = pos >= 0
    pos0 = pos[:, 0].clamp(min=0)
    lg = (pos0 // page)[:, None] + torch.arange(n_touch, device=dev)[None]  # [B, n]
    pid = torch.gather(pt, 1, lg.clamp(0, pps - 1))
    pid = torch.where((lg < pps) & valid[:, :1], pid, 0)
    iota = torch.arange(page, device=dev)
    t_idx = lg[..., None] * page + iota - pos0[:, None, None]            # [B, n, page]
    t_c = t_idx.clamp(0, T - 1)
    head = ((t_idx >= 0) & (t_idx < T)
            & torch.gather(valid, 1, t_c.reshape(B, -1)).reshape(t_c.shape))
    write = torch.ones_like(head)
    write[:, 0] = head[:, 0]
    dst_pid = torch.where(write, pid[..., None], 0).reshape(-1)
    dst_off = torch.where(write, iota, 0).reshape(-1)
    rows = (torch.arange(B, device=dev)[:, None] * T + t_c.reshape(B, -1)).reshape(-1)
    kd[:, dst_pid, dst_off] = k.reshape(B * T, n_kv, d)[rows].transpose(0, 1).to(kd.dtype)
    vd[:, dst_pid, dst_off] = v.reshape(B * T, n_kv, d)[rows].transpose(0, 1).to(vd.dtype)
    return k_pages, v_pages


class PageAllocator:
    """Host-side refcounting allocator over the physical page pool (the JAX
    allocator with prefix caching off). Page 0 is reserved (trash).
    ``allocate`` grows a slot's page list to cover ``num_tokens``; ``free``
    releases it."""

    def __init__(self, num_pages: int, page_size: int, num_slots: int,
                 pages_per_slot: int):
        self.page_size = page_size
        self.pages_per_slot = pages_per_slot
        self.free_pages: list[int] = list(range(num_pages - 1, 0, -1))
        # unused entries point at the trash page 0 (never read)
        self.page_tables = np.zeros((num_slots, pages_per_slot), dtype=np.int32)
        self.slot_pages: list[list[int]] = [[] for _ in range(num_slots)]
        self.refcount: dict[int, int] = {}

    @property
    def num_free_pages(self) -> int:
        return len(self.free_pages)

    def pages_needed(self, num_tokens: int) -> int:
        return -(-num_tokens // self.page_size)

    def can_allocate(self, slot: int, num_tokens: int) -> bool:
        need = self.pages_needed(num_tokens) - len(self.slot_pages[slot])
        return (need <= len(self.free_pages)
                and self.pages_needed(num_tokens) <= self.pages_per_slot)

    def allocate(self, slot: int, num_tokens: int) -> None:
        """Ensure the slot holds enough pages to cover num_tokens tokens."""
        need = self.pages_needed(num_tokens)
        if need > self.pages_per_slot:
            raise ValueError(
                f"sequence of {num_tokens} tokens needs {need} pages > "
                f"pages_per_slot={self.pages_per_slot}")
        for i in range(len(self.slot_pages[slot]), need):
            if not self.free_pages:
                raise MemoryError("KV page pool exhausted")
            p = self.free_pages.pop()
            self.refcount[p] = 1
            self.slot_pages[slot].append(p)
            self.page_tables[slot, i] = p

    def free(self, slot: int) -> None:
        for p in self.slot_pages[slot]:
            if p not in self.refcount:
                raise RuntimeError(
                    f"double free of page {p} (slot {slot}): page has no "
                    "outstanding references")
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                del self.refcount[p]
                self.free_pages.append(p)
        self.slot_pages[slot] = []
        self.page_tables[slot, :] = 0
