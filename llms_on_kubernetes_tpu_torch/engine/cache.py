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
decode kernels update the pool tensors IN PLACE.

int8 KV (``CacheConfig.kv_dtype="int8"``): each pool side holds int8 data
plus a per-token f32 ``scale [n_kv, L * P, page]``; ``quantize_kv`` is the
JAX function's max/clamp/round/clip chain with true IEEE division, so its
bytes equal those of the JAX ``quantize_kv`` run eagerly. (Under
``jax.jit`` XLA-CPU rewrites the division by 127 as a multiply, and a
scale can then differ by one ulp and a value by one.)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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
    # "int8": per-token symmetric KV quantization, a f32 scale per (head,
    # page, token) beside the data; None: KV stored in ``dtype``
    kv_dtype: Optional[str] = None

    @property
    def bytes_per_page(self) -> int:
        if self.kv_dtype == "int8":
            per_tok = self.num_kv_heads * (self.head_dim + 4)   # data + scale
        else:
            per_tok = self.num_kv_heads * self.head_dim * torch_dtype(self.dtype).itemsize
        return 2 * self.num_layers * self.page_size * per_tok

    @property
    def bytes_per_token(self) -> int:
        """KV bytes per cached token across all layers, both sides."""
        return self.bytes_per_page // self.page_size


class KVPool:
    """One side (K or V) of the paged cache: flat head-major ``data``
    [n_kv, L*P, page, d] plus, when int8-quantized, a per-token ``scale``
    [n_kv, L*P, page] float32. Updated in place."""

    def __init__(self, data: torch.Tensor, scale: Optional[torch.Tensor] = None):
        self.data = data
        self.scale = scale

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def quantized(self) -> bool:
        return self.scale is not None

    def __repr__(self):
        return (f"KVPool(shape={tuple(self.data.shape)}, dtype={self.data.dtype}, "
                f"quantized={self.quantized})")


def init_pages(cfg: CacheConfig, device="cuda") -> tuple[KVPool, KVPool]:
    """Zeroed flat head-major pools [n_kv, L * P, page, d] on ``device``
    (int8 data and f32 scales [n_kv, L * P, page] for ``kv_dtype="int8"``)."""
    device = resolve_device(device)
    shape = (cfg.num_kv_heads, cfg.num_layers * cfg.num_pages,
             cfg.page_size, cfg.head_dim)
    if cfg.kv_dtype == "int8":
        def one():
            return KVPool(torch.zeros(shape, dtype=torch.int8, device=device),
                          torch.zeros(shape[:3], dtype=torch.float32, device=device))
        return one(), one()
    if cfg.kv_dtype is not None:
        raise ValueError(f"unsupported kv_dtype {cfg.kv_dtype!r} (None or 'int8')")
    dt = torch_dtype(cfg.dtype)
    return (KVPool(torch.zeros(shape, dtype=dt, device=device)),
            KVPool(torch.zeros(shape, dtype=dt, device=device)))


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8: x [..., d] -> (int8 data, f32 scale [...]).
    ``torch.round`` rounds half to even, like ``jnp.round``; both divisions
    are true divisions (never a multiply by 1/s), as the CUDA kernel's.
    The divisor 127 is a tensor: PyTorch's CUDA division by a Python
    scalar multiplies by the scalar's reciprocal, one ulp off."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = amax.clamp(min=1e-8) / torch.full_like(amax, 127.0)
    data = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return data, scale


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

    A quantized pool takes ``quantize_kv``'s int8 rows and per-token scales,
    the scales at the same (page, row) as their data. One indexed store per
    side (and per scale), with the bytes the JAX ``write_tokens``
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
    ksc = getattr(k_pages, "scale", None)
    vsc = getattr(v_pages, "scale", None)
    ks = vs = None
    if ksc is not None:
        k, ks = quantize_kv(k)         # int8 [B, T, n_kv, d], f32 [B, T, n_kv]
        v, vs = quantize_kv(v)
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
        if ks is not None:
            ksc[:, pid, off] = ks.reshape(B * T, n_kv).transpose(0, 1)
            vsc[:, pid, off] = vs.reshape(B * T, n_kv).transpose(0, 1)
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
    if ks is not None:
        ksc[:, dst_pid, dst_off] = ks.reshape(B * T, n_kv)[rows].transpose(0, 1)
        vsc[:, dst_pid, dst_off] = vs.reshape(B * T, n_kv)[rows].transpose(0, 1)
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
