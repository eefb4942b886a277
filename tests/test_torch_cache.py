"""The port's paged KV cache against the JAX package's, on the CPU.

``write_tokens`` must leave the same pool bytes as the JAX
``write_tokens`` outside the trash pages (which absorb padding and idle
rows in an order of writes neither side promises), for prefill and decode
writes, and the ``PageAllocator`` must hand out the same pages on the
``tests/test_cache.py`` cases that run without a prefix cache. Exact
equality: these are copies, not arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llms_on_kubernetes_tpu.engine import cache as jcache
from llms_on_kubernetes_tpu_torch.engine import cache as tcache


def _pools(rng, n_kv, P, page, d):
    k = rng.normal(size=(n_kv, P, page, d)).astype(np.float32)
    v = rng.normal(size=(n_kv, P, page, d)).astype(np.float32)
    return k, v


def _both(kp, vp, k, v, table, positions, trash_pages=(0,)):
    jk, jv = jcache.write_tokens(jcache.KVPool(jnp.asarray(kp)), jcache.KVPool(jnp.asarray(vp)),
                                 jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
                                 jnp.asarray(positions))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    out = tcache.write_tokens(tcache.KVPool(tk), tcache.KVPool(tv), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(table),
                              torch.from_numpy(positions))
    assert out[0].data is tk and out[1].data is tv    # updated in place
    keep = np.ones(kp.shape[1], bool)
    keep[list(trash_pages)] = False
    np.testing.assert_array_equal(tk.numpy()[:, keep], np.asarray(jk.data)[:, keep])
    np.testing.assert_array_equal(tv.numpy()[:, keep], np.asarray(jv.data)[:, keep])
    return tk, tv


@pytest.mark.parametrize("lengths", [[7, 5], [16, 0], [1, 13]])
def test_prefill_write_matches_jax(rng, lengths):
    """A padded bucket (T=16, page 4): valid rows land in their pages, the
    head page keeps its other rows, later pages take the JAX filler, idle
    rows and padding go to trash page 0."""
    n_kv, d, page, pps, T = 2, 8, 4, 6, 16
    B = len(lengths)
    P = B * pps + 1
    kp, vp = _pools(rng, n_kv, P, page, d)
    table = np.zeros((B, pps), np.int32)
    perm = rng.permutation(P - 1) + 1
    for b, n in enumerate(lengths):
        used = -(-n // page)
        table[b, :used] = perm[b * pps:b * pps + used]
    k = rng.normal(size=(B, T, n_kv, d)).astype(np.float32)
    v = rng.normal(size=(B, T, n_kv, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    positions = np.where(pos < np.asarray(lengths)[:, None], pos, -1).astype(np.int32)
    _both(kp, vp, k, v, table, positions)


def test_chunk_write_mid_page_matches_jax(rng):
    """A chunk starting mid-page (history 6): the head page keeps the
    earlier rows; the span runs past the table's end into the trash."""
    n_kv, d, page, pps, T = 1, 8, 4, 3, 8
    P = 8
    kp, vp = _pools(rng, n_kv, P, page, d)
    table = np.asarray([[3, 5, 6]], np.int32)
    k = rng.normal(size=(1, T, n_kv, d)).astype(np.float32)
    v = rng.normal(size=(1, T, n_kv, d)).astype(np.float32)
    positions = np.asarray([[6, 7, 8, 9, 10, 11, -1, -1]], np.int32)
    _both(kp, vp, k, v, table, positions)


def test_decode_write_matches_jax_including_trash(rng):
    """One token per slot; a negative position writes to trash page 0."""
    n_kv, d, page, pps = 2, 8, 4, 4
    P = 13
    kp, vp = _pools(rng, n_kv, P, page, d)
    table = np.asarray([[1, 2, 3, 0], [4, 5, 0, 0], [6, 0, 0, 0]], np.int32)
    k = rng.normal(size=(3, 1, n_kv, d)).astype(np.float32)
    v = rng.normal(size=(3, 1, n_kv, d)).astype(np.float32)
    positions = np.asarray([[9], [-1], [3]], np.int32)
    tk, _ = _both(kp, vp, k, v, table, positions)
    np.testing.assert_array_equal(tk.numpy()[:, 0, 0], k[1, 0])    # the trash row


def test_large_chunk_scatter_path_matches_jax(rng):
    """A chunk spanning more than _MAX_RMW_PAGES pages takes the JAX scatter
    path: only the positions themselves are written."""
    n_kv, d, page, T = 2, 3, 1, 64
    P = 80
    kp, vp = _pools(rng, n_kv, P, page, d)
    table = np.zeros((2, 70), np.int32)
    table[0] = rng.permutation(np.arange(1, 71))
    table[1] = rng.permutation(np.arange(1, 80))[:70]
    positions = np.full((2, T), -1, np.int32)
    positions[0] = np.arange(3, 3 + T)
    positions[1, :10] = np.arange(10)
    k = rng.normal(size=(2, T, n_kv, d)).astype(np.float32)
    v = rng.normal(size=(2, T, n_kv, d)).astype(np.float32)
    _both(kp, vp, k, v, table, positions)


def test_multi_layer_page_offsets_match_jax(rng):
    """Layer 1 of a two-layer flat pool: the decoder offsets the table by
    P; the layer's own trash page is P."""
    n_kv, d, page, pps, T, P = 2, 4, 4, 4, 8, 9
    kp, vp = _pools(rng, n_kv, 2 * P, page, d)
    table = np.asarray([[2, 5, 0, 0], [7, 0, 0, 0]], np.int32) + P
    k = rng.normal(size=(2, T, n_kv, d)).astype(np.float32)
    v = rng.normal(size=(2, T, n_kv, d)).astype(np.float32)
    positions = np.where(np.arange(T)[None] < np.asarray([[6], [3]]),
                         np.arange(T)[None], -1).astype(np.int32)
    _both(kp, vp, k, v, table, positions, trash_pages=(0, P))


def _trace(mod, ops, **kw):
    """Run allocator operations; return each step's observable state."""
    a = mod.PageAllocator(**kw)
    out = []
    for op, *args in ops:
        try:
            getattr(a, op)(*args)
            out.append((op, a.num_free_pages, [list(p) for p in a.slot_pages],
                        a.page_tables.tolist()))
        except (ValueError, MemoryError, RuntimeError) as e:
            out.append((op, type(e).__name__))
    return out


@pytest.mark.parametrize("kw,ops", [
    (dict(num_pages=8, page_size=4, num_slots=2, pages_per_slot=4),
     [("allocate", 0, 9), ("allocate", 0, 10), ("free", 0), ("allocate", 1, 1)]),
    (dict(num_pages=4, page_size=2, num_slots=1, pages_per_slot=2),
     [("allocate", 0, 100), ("allocate", 0, 4), ("free", 0)]),
    (dict(num_pages=3, page_size=2, num_slots=2, pages_per_slot=4),
     [("allocate", 0, 4), ("allocate", 1, 2), ("free", 0), ("allocate", 1, 2)]),
    (dict(num_pages=16, page_size=4, num_slots=3, pages_per_slot=4),
     [("allocate", 0, 5), ("allocate", 1, 16), ("allocate", 2, 3), ("free", 1),
      ("allocate", 0, 13), ("allocate", 2, 9), ("free", 0), ("free", 2)]),
])
def test_allocator_traces_match_jax(kw, ops):
    assert _trace(tcache, ops, **kw) == _trace(jcache, ops, **kw)


def test_allocator_double_free_detected():
    a = tcache.PageAllocator(num_pages=4, page_size=2, num_slots=2, pages_per_slot=2)
    a.allocate(0, 4)
    a.slot_pages[1] = list(a.slot_pages[0])   # stale alias
    a.free(0)
    with pytest.raises(RuntimeError, match="double free"):
        a.free(1)


def test_can_allocate_matches_jax():
    kw = dict(num_pages=6, page_size=4, num_slots=2, pages_per_slot=3)
    ta, ja = tcache.PageAllocator(**kw), jcache.PageAllocator(**kw)
    for a in (ta, ja):
        a.allocate(0, 9)
    for n in (1, 4, 8, 9, 12, 13):
        assert ta.can_allocate(1, n) == ja.can_allocate(1, n)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_init_pages_matches_jax(dtype):
    kw = dict(num_layers=2, num_kv_heads=4, head_dim=8, num_pages=16, page_size=8,
              pages_per_slot=4, dtype=dtype)
    k, v = tcache.init_pages(tcache.CacheConfig(**kw), device="cpu")
    jk, _ = jcache.init_pages(jcache.CacheConfig(**kw))
    assert tuple(k.data.shape) == tuple(jk.data.shape) == (4, 32, 8, 8)
    assert str(k.data.dtype).split(".")[-1] == str(jk.data.dtype)
    assert float(k.data.abs().sum()) == float(v.data.abs().sum()) == 0.0
    with pytest.raises(ValueError, match="dtype"):
        tcache.init_pages(tcache.CacheConfig(**{**kw, "dtype": "float16"}), device="cpu")
