"""Paged KV cache: device-side page pool + host-side page allocator
(counterpart of ``llms_on_kubernetes_tpu/engine/cache.py``), and the
host-RAM tier the finished and preempted slots' pages spill into.

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

The host tier (``HostKVCache``, the JAX class): one entry per spilled page,
keyed by (tenant, chained prefix digest), the payload the raw pool bytes of
that page over all layers. numpy has no bfloat16 without ml_dtypes, which
the port does not use: a bf16 pool's payload holds the same bytes as
``uint16`` (``BF16_VIEW``), and ``payload_shape_ok`` also takes the JAX
payload's ``bfloat16`` arrays, which ``as_pool_view`` turns into that view.
"""

from __future__ import annotations

import dataclasses
import hashlib
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
    """Host-side refcounting allocator over the physical page pool, with
    optional hash-chained prefix caching (the JAX allocator). Page 0 is
    reserved (trash). ``allocate`` grows a slot's page list to cover
    ``num_tokens``; ``free`` releases the slot's references.

    Prefix caching: each FULL page of a prompt gets a sha256 digest chained
    over every token up to and including that page (int64 token bytes,
    seeded with a salt: empty for text). The digests are byte-equal to the
    JAX allocator's, which makes them a wire contract between replicas.
    ``match_prefix`` finds the longest cached chain; ``adopt_prefix`` maps
    those pages into a slot's table read-only (the adopter writes only past
    the cached prefix, in later pages); ``register_prefix`` publishes a
    slot's freshly written prompt pages. A cached page keeps its content
    after its last reference drops: it moves to an LRU of evictable pages,
    reclaimed only when the free list runs dry.
    """

    def __init__(self, num_pages: int, page_size: int, num_slots: int,
                 pages_per_slot: int, prefix_caching: bool = False):
        self.page_size = page_size
        self.pages_per_slot = pages_per_slot
        self.prefix_caching = prefix_caching
        self.free_pages: list[int] = list(range(num_pages - 1, 0, -1))
        # unused entries point at the trash page 0 (never read)
        self.page_tables = np.zeros((num_slots, pages_per_slot), dtype=np.int32)
        self.slot_pages: list[list[int]] = [[] for _ in range(num_slots)]
        self.refcount: dict[int, int] = {}
        self._prefix_map: dict[bytes, int] = {}   # digest -> page id
        self._page_digest: dict[int, bytes] = {}  # page id -> digest
        # refcount-0 pages that still hold a cached prefix, oldest first
        self._lru: dict[int, None] = {}
        self.hit_tokens_total = 0                 # prompt tokens served from cache
        # the LRU order before a provisional adoption, until commit/rollback:
        # a blocked admission retries every step and must neither count the
        # hit nor refresh the adopted pages' recency
        self._adopt_snapshot: dict[int, list[int]] = {}

    @property
    def num_free_pages(self) -> int:
        return len(self.free_pages)

    @property
    def num_evictable_pages(self) -> int:
        return len(self._lru)

    def pages_needed(self, num_tokens: int) -> int:
        return -(-num_tokens // self.page_size)

    def can_allocate(self, slot: int, num_tokens: int) -> bool:
        need = self.pages_needed(num_tokens) - len(self.slot_pages[slot])
        return (need <= len(self.free_pages) + len(self._lru)
                and self.pages_needed(num_tokens) <= self.pages_per_slot)

    def _take_page(self) -> int:
        if self.free_pages:
            return self.free_pages.pop()
        if self._lru:                               # evict the oldest cached page
            p = next(iter(self._lru))
            if p in self.refcount:
                # the LRU holds only refcount-0 pages; evicting a page a slot
                # still reads would corrupt its KV
                raise RuntimeError(f"evictable page {p} is still referenced "
                                   f"(refcount={self.refcount[p]})")
            del self._lru[p]
            d = self._page_digest.pop(p, None)
            if d is not None and self._prefix_map.get(d) == p:
                del self._prefix_map[d]
            return p
        raise MemoryError("KV page pool exhausted")

    def allocate(self, slot: int, num_tokens: int) -> None:
        """Ensure the slot holds enough pages to cover num_tokens tokens."""
        need = self.pages_needed(num_tokens)
        if need > self.pages_per_slot:
            raise ValueError(
                f"sequence of {num_tokens} tokens needs {need} pages > "
                f"pages_per_slot={self.pages_per_slot}")
        for i in range(len(self.slot_pages[slot]), need):
            p = self._take_page()
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
                if p in self._page_digest:
                    self._lru[p] = None         # cached: evictable, content kept
                else:
                    self.free_pages.append(p)
        self.slot_pages[slot] = []
        self.page_tables[slot, :] = 0

    # -- prefix caching ----------------------------------------------------

    def _chain(self, tokens, salt: bytes, num_pages: int):
        """Yield the chained digest of each of the first ``num_pages`` full
        pages of ``tokens``."""
        prev = salt
        for i in range(num_pages):
            chunk = tokens[i * self.page_size:(i + 1) * self.page_size]
            h = hashlib.sha256(prev)
            h.update(np.asarray(chunk, np.int64).tobytes())
            prev = h.digest()
            yield prev

    def _digests(self, tokens, salt: bytes = b"") -> list[bytes]:
        """Chained digest per FULL page of ``tokens``."""
        return list(self._chain(tokens, salt, len(tokens) // self.page_size))

    def _match_digests(self, tokens, salt: bytes = b"") -> list[int]:
        """Page ids of the longest cached prefix, stopping at the first
        miss. Capped so at least one token is left to prefill: its logits
        seed sampling."""
        if not self.prefix_caching or len(tokens) <= self.page_size:
            return []
        pages: list[int] = []
        for d in self._chain(tokens, salt, (len(tokens) - 1) // self.page_size):
            p = self._prefix_map.get(d)
            if p is None:
                break
            pages.append(p)
        return pages

    def match_prefix(self, tokens, salt: bytes = b"") -> int:
        """Longest cached prefix of ``tokens`` in TOKENS."""
        return len(self._match_digests(tokens, salt)) * self.page_size

    def adopt_prefix(self, slot: int, tokens, salt: bytes = b"") -> int:
        """Map the longest cached prefix into the empty ``slot``'s table
        (increfs the shared pages); returns the tokens adopted. The adoption
        is provisional until ``commit_adopt`` (which counts the hit) or
        ``rollback_adopt``."""
        pages = self._match_digests(tokens, salt)
        if not pages:
            return 0
        if self.slot_pages[slot]:
            raise RuntimeError(f"adopt_prefix on slot {slot}, which holds pages")
        self._adopt_snapshot[slot] = list(self._lru)
        for i, p in enumerate(pages):
            self.refcount[p] = self.refcount.get(p, 0) + 1
            self._lru.pop(p, None)                  # referenced again: not evictable
            self.slot_pages[slot].append(p)
            self.page_tables[slot, i] = p
        return len(pages) * self.page_size

    def commit_adopt(self, slot: int, hit_tokens: int) -> None:
        """The adoption's admission went through: count the cache hit."""
        self._adopt_snapshot.pop(slot, None)
        self.hit_tokens_total += hit_tokens

    def rollback_adopt(self, slot: int) -> None:
        """Undo a provisional ``adopt_prefix``: decref the pages and restore
        the LRU order from before it (a plain ``free`` would make them the
        newest)."""
        snap = self._adopt_snapshot.pop(slot, None)
        self.free(slot)
        if snap is not None:
            restored = {p: None for p in snap if p in self._lru}
            for p in self._lru:                     # newer pages keep their order
                restored.setdefault(p, None)
            self._lru = restored

    def register_prefix(self, slot: int, tokens, salt: bytes = b"") -> None:
        """Publish ``slot``'s pages that hold full pages of ``tokens`` so
        later prompts with the same prefix can adopt them."""
        if not self.prefix_caching:
            return
        for i, d in enumerate(self._digests(tokens, salt)):
            if i >= len(self.slot_pages[slot]):
                break
            if d in self._prefix_map:
                continue                            # already cached (dedup)
            p = self.slot_pages[slot][i]
            old = self._page_digest.get(p)
            if old is not None and old != d:
                continue                            # published under another digest
            self._prefix_map[d] = p
            self._page_digest[p] = d

    def prefix_digests(self) -> list[bytes]:
        """Snapshot of the published digests. Other threads may call this
        while the engine thread mutates the map: a resize during the copy is
        retried, and a stale or empty snapshot is harmless (a routing
        hint)."""
        for _ in range(4):
            try:
                return list(self._prefix_map)
            except RuntimeError:
                continue
        return []


# numpy holds a bf16 pool's bytes as this dtype (same width, no arithmetic)
BF16_VIEW = np.dtype(np.uint16)


def payload_data_dtype(cfg: CacheConfig) -> np.dtype:
    """The numpy dtype of a host-tier payload's ``k`` / ``v`` for pools of
    ``cfg``: int8, float32, or ``BF16_VIEW`` for bfloat16."""
    if cfg.kv_dtype == "int8":
        return np.dtype(np.int8)
    if torch_dtype(cfg.dtype) == torch.bfloat16:
        return BF16_VIEW
    return np.dtype(np.float32)


def _is_bf16_array(a) -> bool:
    """A numpy array of ml_dtypes' bfloat16 (a JAX payload), recognized by
    its dtype's name and width so ml_dtypes need not be imported."""
    return isinstance(a, np.ndarray) and a.dtype.name == "bfloat16" and a.dtype.itemsize == 2


def as_pool_view(payload: dict) -> dict:
    """``payload`` with any ml_dtypes bfloat16 array viewed as
    ``BF16_VIEW`` (the same bytes); other arrays unchanged."""
    return {k: (a.view(BF16_VIEW) if _is_bf16_array(a) else a) for k, a in payload.items()}


class HostKVCache:
    """Host-RAM offload tier for inactive sessions' KV pages (the JAX
    ``HostKVCache``).

    When a slot is freed (finish) or preempted, its full pages spill here:
    one entry per page, keyed by (tenant, chained prefix digest), the same
    digest the ``PageAllocator``'s device prefix cache chains (salt
    included), so a returning session's tokens address both tiers with one
    hash pass. On a matching admission the engine uploads the pages and
    prefills only past them.

    Payloads are raw pool bytes per page, all layers stacked: ``{"k":
    [n_kv, L, page, d], "v": ..., "ks": [n_kv, L, page] | None, "vs": ...}``
    (int8 data and f32 scales for int8 pools, else the pool's bytes, bf16
    as ``BF16_VIEW``), so a reuse round-trips the exact bytes the device
    wrote and greedy streams are the same with the tier on or off.

    Keyed by tenant so one tenant's sessions are never served another's KV
    and per-tenant flushes stay possible. Plain LRU over bytes. The engine
    thread owns the hot paths; the disaggregated handoff reads and writes
    the tier from server threads, so every touch of the entry map holds
    ``_lock``.
    """

    def __init__(self, capacity_bytes: int, page_size: int):
        import threading

        self.capacity_bytes = int(capacity_bytes)
        self.page_size = page_size
        self._entries: "dict[tuple[str, bytes], dict]" = {}
        self._bytes = 0
        self._lock = threading.RLock()
        self.hits = 0        # pages served to a resuming session
        self.misses = 0      # landed admissions whose chain had no page here
        self.evictions = 0   # pages dropped by LRU pressure
        self.spilled_pages = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def used_bytes(self) -> int:
        return self._bytes

    @staticmethod
    def _nbytes(payload: dict) -> int:
        return sum(int(a.nbytes) for a in payload.values() if a is not None)

    def put(self, tenant: str, digest: bytes, payload: dict) -> None:
        with self._lock:
            key = (tenant, digest)
            old = self._entries.pop(key, None)
            if old is not None:          # the same prefix spilled again: refresh
                self._bytes -= self._nbytes(old)
            nb = self._nbytes(payload)
            if nb > self.capacity_bytes:
                return                   # one page larger than the whole tier
            self._entries[key] = payload
            self._bytes += nb
            self.spilled_pages += 1
            while self._bytes > self.capacity_bytes and self._entries:
                k, v = next(iter(self._entries.items()))
                if k == key:             # never evict the page just stored
                    break
                del self._entries[k]
                self._bytes -= self._nbytes(v)
                self.evictions += 1

    def match_chain(self, tenant: str, digests: "list[bytes]",
                    start: int) -> "tuple[list[bytes], list[dict]]":
        """(matched digests, payloads) of the longest run of consecutive
        pages present, walking ``digests[start:]``. A pure peek (no counts,
        no recency): a blocked admission probes again every step. Call
        ``commit`` once the admission lands."""
        matched: "list[bytes]" = []
        out: "list[dict]" = []
        with self._lock:
            for d in digests[start:]:
                e = self._entries.get((tenant, d))
                if e is None:
                    break
                matched.append(d)
                out.append(e)
        return matched, out

    def digests(self) -> "list[bytes]":
        """The digest of every resident entry (all tenants), for the
        replica's /ready filter. A peek; tenancy is enforced at adoption."""
        with self._lock:
            return [d for (_t, d) in self._entries]

    def export(self, tenant: str, digests: "list[bytes]") -> "list[Optional[dict]]":
        """Payloads for a pulling decode replica, one per digest (None
        where the page is gone). A peek, like ``match_chain``."""
        with self._lock:
            return [self._entries.get((tenant, d)) for d in digests]

    def commit(self, tenant: str, digests: "list[bytes]") -> None:
        """A landed admission's outcome: one hit per page served
        (refreshing its recency), or one miss for an empty match. Entries
        evicted between probe and commit are skipped: the engine uploads
        the payloads it captured at the probe."""
        served = 0
        with self._lock:
            for d in digests:
                key = (tenant, d)
                e = self._entries.pop(key, None)
                if e is None:
                    continue
                self._entries[key] = e   # move to the end: LRU recency
                served += 1
            if served:
                self.hits += served
            else:
                self.misses += 1


def payload_shape_ok(payload, cache_config: CacheConfig) -> bool:
    """True iff a host-tier payload has exactly the per-page shapes and
    dtypes this engine's pools expect (the JAX ``payload_shape_ok``): the
    guard of the handoff ingest, whose payloads crossed a network from a
    replica that may run another model or were corrupted on the way. A
    bf16 pool takes its own ``BF16_VIEW`` and the JAX payload's
    ``bfloat16``; everything the JAX check refuses is refused."""
    cc = cache_config
    if not isinstance(payload, dict):
        return False
    k, v = payload.get("k"), payload.get("v")
    ks, vs = payload.get("ks"), payload.get("vs")
    want = (cc.num_kv_heads, cc.num_layers, cc.page_size, cc.head_dim)
    data_dtype = payload_data_dtype(cc)
    for side in (k, v):
        if not isinstance(side, np.ndarray) or side.shape != want:
            return False
        if side.dtype != data_dtype and not (data_dtype == BF16_VIEW and _is_bf16_array(side)):
            return False
    if cc.kv_dtype == "int8":
        want_s = (cc.num_kv_heads, cc.num_layers, cc.page_size)
        for scale in (ks, vs):
            if (not isinstance(scale, np.ndarray) or scale.shape != want_s
                    or scale.dtype != np.dtype(np.float32)):
                return False
    elif ks is not None or vs is not None:
        return False
    return True
