"""The port's prefix cache against the JAX package's, on the CPU.

- The allocator: the cases of tests/test_prefix_cache.py (round trip, an
  exact page multiple keeps one token to prefill, LRU eviction, caching off
  is inert, provisional adoption rolled back or committed, the refcount
  guards). Every operation runs on both allocators, and the page tables,
  free list, refcounts, LRU order, hit counter and published digests must
  stay equal; the digests are byte-equal (a sha256 chain over int64
  tokens, the empty salt for text), which makes them a wire contract
  between replicas of either framework.
- The engine: greedy streams equal to the JAX engine's (prefix caching on)
  on the scenarios of tests/test_prefix_cache.py, with the same cache-hit
  token counts; float and int8 KV, kv_write "dus" and "fused". A seeded
  stream is the same cold, on a cache hit and one-shot.
"""

import jax
import numpy as np
import pytest

from llms_on_kubernetes_tpu.configs import get_config as jget_config
from llms_on_kubernetes_tpu.engine.cache import PageAllocator as JPageAllocator
from llms_on_kubernetes_tpu.engine.engine import Engine as JEngine
from llms_on_kubernetes_tpu.engine.engine import EngineConfig as JEngineConfig
from llms_on_kubernetes_tpu.engine.engine import SamplingParams as JSamplingParams
from llms_on_kubernetes_tpu.models.decoder import init_params as j_init_params
from llms_on_kubernetes_tpu_torch import cli
from llms_on_kubernetes_tpu_torch.engine.cache import PageAllocator
from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
from llms_on_kubernetes_tpu_torch.engine.weights import params_from_numpy


# ---------------------------------------------------------------------------
# the allocator, step for step beside the JAX one
# ---------------------------------------------------------------------------

class Pair:
    """A port allocator and a JAX allocator driven by the same calls; every
    call's result and the whole state afterwards must agree."""

    def __init__(self, **kw):
        self.t, self.j = PageAllocator(**kw), JPageAllocator(**kw)

    def __getattr__(self, name):
        def call(*args, **kw):
            got, want = getattr(self.t, name)(*args, **kw), getattr(self.j, name)(*args, **kw)
            assert got == want, (name, got, want)
            self.check()
            return got
        return call

    def check(self):
        t, j = self.t, self.j
        np.testing.assert_array_equal(t.page_tables, j.page_tables)
        assert t.free_pages == j.free_pages
        assert t.slot_pages == j.slot_pages
        assert t.refcount == j.refcount
        assert list(t._lru) == list(j._lru)
        assert t._prefix_map == j._prefix_map          # digest bytes -> page id
        assert t._page_digest == j._page_digest
        assert t.hit_tokens_total == j.hit_tokens_total
        assert t.num_free_pages == j.num_free_pages
        assert t.num_evictable_pages == j.num_evictable_pages
        assert t.prefix_digests() == j.prefix_digests()


def test_allocator_match_adopt_register_roundtrip():
    a = Pair(num_pages=32, page_size=4, num_slots=4, pages_per_slot=8, prefix_caching=True)
    prompt = list(range(10, 23))          # 13 tokens = 3 full pages + 1 partial
    assert a.match_prefix(prompt) == 0
    a.allocate(0, len(prompt) + 1)
    a.register_prefix(0, prompt)
    assert a.match_prefix(prompt) == 12
    assert a.match_prefix(prompt + [99, 98]) == 12
    assert a.match_prefix(prompt[:6] + [77] + prompt[7:]) == 4
    assert a.match_prefix(prompt[:4]) == 0          # >= 1 token must prefill
    assert a.adopt_prefix(1, prompt) == 12
    assert list(a.t.page_tables[1, :3]) == list(a.t.page_tables[0, :3])
    a.commit_adopt(1, 12)
    a.allocate(1, len(prompt) + 1)
    assert a.t.page_tables[1, 3] != a.t.page_tables[0, 3]
    a.free(0)
    assert a.match_prefix(prompt) == 12
    a.free(1)
    assert a.t.num_evictable_pages >= 3
    assert a.match_prefix(prompt) == 12
    assert a.t.hit_tokens_total == 12


def test_allocator_exact_page_multiple_prompt_keeps_one_token():
    a = Pair(num_pages=32, page_size=4, num_slots=2, pages_per_slot=8, prefix_caching=True)
    prompt = list(range(8))
    a.allocate(0, len(prompt) + 1)
    a.register_prefix(0, prompt)
    assert a.match_prefix(prompt) == 4


def test_allocator_eviction_reclaims_lru_cached_pages():
    a = Pair(num_pages=9, page_size=4, num_slots=2, pages_per_slot=8, prefix_caching=True)
    p1, p2 = list(range(100, 108)), list(range(200, 212))
    a.allocate(0, 8)
    a.register_prefix(0, p1)
    a.free(0)
    a.allocate(1, 12)
    a.register_prefix(1, p2)
    a.free(1)
    assert a.match_prefix(p1) == 4 and a.match_prefix(p2) == 8
    assert a.can_allocate(0, 28)                    # 3 free + 5 evictable
    a.allocate(0, 28)                               # evicts the oldest (p1's)
    assert a.match_prefix(p1 + [1]) == 0
    a.free(0)
    assert not a.can_allocate(0, 4 * 9)             # past pages_per_slot


def test_allocator_caching_off_is_inert():
    a = Pair(num_pages=8, page_size=4, num_slots=2, pages_per_slot=4, prefix_caching=False)
    prompt = list(range(9))
    a.allocate(0, 9)
    a.register_prefix(0, prompt)
    assert a.match_prefix(prompt) == 0
    assert a.adopt_prefix(1, prompt) == 0
    assert a.t.prefix_digests() == []


def test_rollback_restores_the_lru_order_and_counts_no_hit():
    """A blocked admission adopts and rolls back every step: the hit is not
    counted and the adopted pages do not become the newest in the LRU."""
    a = Pair(num_pages=16, page_size=4, num_slots=3, pages_per_slot=8, prefix_caching=True)
    p1, p2 = list(range(1, 10)), list(range(50, 59))
    for slot, p in ((0, p1), (1, p2)):
        a.allocate(slot, len(p))
        a.register_prefix(slot, p)
    a.free(0)
    a.free(1)
    order = list(a.t._lru)
    for _ in range(3):
        assert a.adopt_prefix(2, p1) == 8
        a.rollback_adopt(2)
    assert list(a.t._lru) == order and a.t.hit_tokens_total == 0
    assert a.adopt_prefix(2, p1) == 8
    a.commit_adopt(2, 8)
    assert a.t.hit_tokens_total == 8


def test_refcount_guards():
    for alloc in (PageAllocator, JPageAllocator):
        a = alloc(num_pages=8, page_size=4, num_slots=2, pages_per_slot=4, prefix_caching=True)
        a.allocate(0, 8)
        a.slot_pages[1] = list(a.slot_pages[0])       # a stale second owner
        a.free(0)
        with pytest.raises(RuntimeError, match="double free"):
            a.free(1)
        b = alloc(num_pages=3, page_size=4, num_slots=2, pages_per_slot=4, prefix_caching=True)
        b.allocate(0, 8)
        b.register_prefix(0, list(range(8)))
        b.free(0)
        b.refcount[next(iter(b._lru))] = 1           # an LRU page a slot still reads
        with pytest.raises(RuntimeError, match="still referenced"):
            b.allocate(1, 4)


@pytest.mark.parametrize("salt", [b"", b"\x01image-hash"])
def test_digests_are_byte_equal_to_the_jax_allocator(salt):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 128_256, size=301).tolist()
    t = PageAllocator(num_pages=8, page_size=16, num_slots=1, pages_per_slot=32)
    j = JPageAllocator(num_pages=8, page_size=16, num_slots=1, pages_per_slot=32)
    got, want = t._digests(tokens, salt), j._digests(tokens, salt)
    assert len(got) == 301 // 16 and got == want
    assert all(isinstance(d, bytes) and len(d) == 32 for d in got)


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

SMALL = dict(model="debug-tiny", dtype="float32", max_decode_slots=4, page_size=8,
             num_pages=64, pages_per_slot=8, prefill_buckets=(16, 32))
SYSTEM = list(range(1, 21))          # 20 tokens: 2 full pages at page_size 8


@pytest.fixture(scope="module")
def jparams():
    return j_init_params(jget_config("debug-tiny"), jax.random.key(0), dtype="float32")


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _port(tparams, **kw):
    return Engine(EngineConfig(**{**SMALL, "device": "cpu", **kw}), params=tparams)


def _jax(jparams, **kw):
    kw = {k: v for k, v in kw.items() if k != "kv_write"}
    return JEngine(JEngineConfig(**{**SMALL, "async_scheduling": False, **kw}),
                   params=jparams)


def _run(eng, sp_cls, prompt, max_tokens=8, **params):
    req = eng.submit(list(prompt), sp_cls(temperature=0.0, max_tokens=max_tokens, **params))
    for _ in range(10_000):
        if req.finished:
            break
        eng.step()
    return req.output


VARIANTS = [{}, dict(kv_cache_dtype="int8"), dict(kv_write="fused"),
            dict(kv_cache_dtype="int8", kv_write="fused")]
VARIANT_IDS = ["f32", "int8", "fused", "int8_fused"]


@pytest.mark.parametrize("kw", VARIANTS, ids=VARIANT_IDS)
def test_second_request_skips_cached_prefix_and_matches_jax(jparams, tparams, kw):
    """tests/test_prefix_cache.py:126: an identical prompt adopts both full
    pages, a new user turn after the same system prompt adopts them too,
    and every stream and hit count is the JAX engine's."""
    prompts = [SYSTEM + [30, 31, 32], SYSTEM + [30, 31, 32], SYSTEM + [40, 41]]
    jeng, eng = _jax(jparams, **kw), _port(tparams, **kw)
    for prompt, hits in zip(prompts, (0, 16, 32)):
        want = _run(jeng, JSamplingParams, prompt)
        assert _run(eng, SamplingParams, prompt) == want
        assert eng.allocator.hit_tokens_total == jeng.allocator.hit_tokens_total == hits
    assert eng.allocator._prefix_map == jeng.allocator._prefix_map
    cold = _port(tparams, prefix_caching=False, **kw)
    assert _run(cold, SamplingParams, prompts[2]) == want
    assert cold.allocator.hit_tokens_total == 0 and cold.chunk_calls == 0


def test_prefix_cache_off_by_flag(tparams):
    eng = _port(tparams, prefix_caching=False)
    _run(eng, SamplingParams, SYSTEM)
    _run(eng, SamplingParams, SYSTEM)
    assert eng.allocator.hit_tokens_total == 0 and eng.allocator.prefix_digests() == []


def test_concurrent_requests_share_prefix_pages(jparams, tparams):
    """tests/test_prefix_cache.py:152: a warm cache, then three concurrent
    requests over the same system prompt."""
    outs = {}
    for name, eng, sp_cls in (("jax", _jax(jparams), JSamplingParams),
                              ("port", _port(tparams), SamplingParams)):
        _run(eng, sp_cls, SYSTEM + [5])
        reqs = [eng.submit(SYSTEM + [60 + i], sp_cls(temperature=0.0, max_tokens=6))
                for i in range(3)]
        while any(not r.finished for r in reqs):
            eng.step()
        assert eng.allocator.hit_tokens_total >= 3 * 16
        outs[name] = [r.output for r in reqs]
    assert outs["port"] == outs["jax"]


@pytest.mark.parametrize("kw", VARIANTS, ids=VARIANT_IDS)
def test_prefix_cache_with_chunked_prefill_remainder(jparams, tparams, kw):
    """tests/test_prefix_cache.py:170: 40 tokens past the bucket of 32; the
    hit adopts 32 tokens and the remainder takes the chunk path."""
    long_prompt = list(range(1, 41))
    jeng, eng = _jax(jparams, **kw), _port(tparams, **kw)
    cold, jcold = _run(eng, SamplingParams, long_prompt), _run(jeng, JSamplingParams, long_prompt)
    assert eng.chunk_calls == 2
    hot, jhot = _run(eng, SamplingParams, long_prompt), _run(jeng, JSamplingParams, long_prompt)
    assert cold == jcold and hot == jhot == cold
    assert eng.allocator.hit_tokens_total == jeng.allocator.hit_tokens_total == 32
    assert eng.chunk_calls == 3 and eng.prefill_calls == 0


@pytest.mark.parametrize("kw", [{}, dict(kv_cache_dtype="int8")], ids=["f32", "int8"])
def test_cache_hits_at_page_24_equal_jax(jparams, tparams, kw):
    """A page of 24 rows, which the window kernels' spans cut by in-page
    offset: a 60-token prompt (two chunks of 32, the second starting
    mid-page), then again with a new tail: it adopts both full pages (48
    tokens) and prefills the rest through the chunk path mid-page."""
    kw = dict(kw, page_size=24)
    long_prompt = list(range(1, 61))
    jeng, eng = _jax(jparams, **kw), _port(tparams, **kw)
    for prompt, hits in ((long_prompt, 0), (long_prompt[:50] + [7, 8, 9], 48)):
        want = _run(jeng, JSamplingParams, prompt)
        assert _run(eng, SamplingParams, prompt) == want
        assert eng.allocator.hit_tokens_total == jeng.allocator.hit_tokens_total == hits
    assert eng.chunk_calls == 3


@pytest.mark.parametrize("kw", [{}, dict(kv_cache_dtype="int8")], ids=["f32", "int8"])
def test_penalties_correct_on_cache_hit(jparams, tparams, kw):
    """tests/test_prefix_cache.py:203: penalty counts reset on a cache-hit
    admission (the chunk path with history > 0)."""
    p = dict(max_tokens=10, frequency_penalty=0.9, presence_penalty=0.4)
    jeng, eng = _jax(jparams, **kw), _port(tparams, **kw)
    ref = _run(_port(tparams, prefix_caching=False, **kw), SamplingParams, SYSTEM + [7], **p)
    for _ in range(2):
        assert _run(eng, SamplingParams, SYSTEM + [7], **p) == ref
        assert _run(jeng, JSamplingParams, SYSTEM + [7], **p) == ref
    assert eng.allocator.hit_tokens_total == jeng.allocator.hit_tokens_total == 16


def test_seeded_stream_same_cold_on_a_hit_and_one_shot(tparams):
    """The first token's noise is keyed on (seed, prompt length) on every
    path: cold one-shot, a cache hit (chunk from the adopted prefix) and a
    chunked prompt past the bucket give one stream."""
    sp = SamplingParams(max_tokens=10, temperature=0.9, top_k=16, seed=4321,
                        presence_penalty=0.3)
    prompt = SYSTEM + [9, 8, 7]
    eng = _port(tparams)
    cold = eng.generate(prompt, sp)
    hot = eng.generate(prompt, sp)
    assert eng.allocator.hit_tokens_total == 16 and eng.chunk_calls == 1
    chunked = _port(tparams, prefill_buckets=(8,), prefix_caching=False).generate(prompt, sp)
    assert cold == hot == chunked


def test_blocked_admission_rolls_back_and_waits(tparams):
    """A cache-hit admission whose private pages do not fit yet rolls its
    adoption back (no hit counted), waits, and runs once pages free up.
    Pages are allocated on demand (the prompt and one token at admission),
    so the hog's prompt takes every free page; the sync loop with one-token
    windows keeps it running for the steps this checks."""
    eng = _port(tparams, num_pages=9, max_decode_slots=2,        # 8 usable pages
                async_scheduling=False, decode_steps=1)
    _run(eng, SamplingParams, SYSTEM)                            # caches 2 pages
    hog = eng.submit(list(range(100, 144)), SamplingParams(temperature=0.0, max_tokens=4))
    eng.step()                                                   # 6 pages: 45 tokens
    req = eng.submit(SYSTEM + [1, 2], SamplingParams(temperature=0.0, max_tokens=20))
    eng.step()
    assert req.slot < 0 and eng.allocator.hit_tokens_total == 0
    while not req.finished:
        eng.step()
    assert hog.finished and eng.allocator.hit_tokens_total > 0


def test_no_prefix_caching_flag():
    args = cli.build_parser().parse_args(["serve", "--model", "x"])
    assert args.prefix_caching is True
    args = cli.build_parser().parse_args(["serve", "--model", "x", "--no-prefix-caching"])
    assert args.prefix_caching is False
    assert EngineConfig().prefix_caching is True
