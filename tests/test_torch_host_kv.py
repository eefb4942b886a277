"""The port's host KV tier against the JAX package's.

- ``HostKVCache`` and ``payload_shape_ok``: the same seeded operation
  sequences (put, match_chain, commit, export, digests) on the JAX tier
  and the port's leave the same LRU order, evictions, hit/miss counts and
  used bytes; the same payloads get the same verdicts (the port also takes
  its own ``uint16`` view of a bf16 page, which is the JAX bytes).
- Engines on debug-tiny (float32, the JAX weights on both sides): with the
  tier on, multi-turn sessions in a pool too small to keep them, and
  preemption, give the greedy streams the tier-off engine gives, float32
  and int8 KV, sync and async (tolerance: token streams exact); the host
  tier serves pages and uploads tokens; the trash page is never spilled;
  the port's spilled payloads for a prompt have the JAX engine's digests
  byte for byte, its shapes and dtypes, and its values within 1e-5
  (float32: the two engines' projections differ in summation order only).
"""

import time

import jax
import numpy as np
import pytest

from llms_on_kubernetes_tpu.configs import get_config as jget_config
from llms_on_kubernetes_tpu.engine import cache as jcache
from llms_on_kubernetes_tpu.engine.engine import Engine as JEngine
from llms_on_kubernetes_tpu.engine.engine import EngineConfig as JEngineConfig
from llms_on_kubernetes_tpu.engine.engine import SamplingParams as JSamplingParams
from llms_on_kubernetes_tpu.models.decoder import init_params as j_init_params
from llms_on_kubernetes_tpu_torch.engine import cache as tcache
from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
from llms_on_kubernetes_tpu_torch.engine.weights import params_from_numpy

SMALL = dict(model="debug-tiny", dtype="float32", max_decode_slots=4, page_size=8,
             num_pages=64, pages_per_slot=8, prefill_buckets=(16, 32))
PROMPT = list(range(1, 21)) + [30, 31, 32]
TOL = 1e-5


# -- the tier alone -----------------------------------------------------


def _tier_trace(mod, seed: int):
    rng = np.random.default_rng(seed)
    tier = mod.HostKVCache(capacity_bytes=int(rng.integers(40, 200)), page_size=8)
    digests = [bytes([i]) * 8 for i in range(12)]
    tenants = ["a", "b", ""]
    out = []
    for _ in range(400):
        x = rng.random()
        t = tenants[int(rng.integers(3))]
        if x < 0.45:
            d = digests[int(rng.integers(len(digests)))]
            n = int(rng.choice([4, 8, 16, 250]))
            tier.put(t, d, {"k": np.full(n // 2, len(out) % 127, np.int8),
                            "v": np.zeros(n - n // 2, np.int8), "ks": None, "vs": None})
        elif x < 0.65:
            start = int(rng.integers(3))
            m, pls = tier.match_chain(t, digests[:int(rng.integers(1, 12))], start)
            out.append(("match", m, [int(p["k"][0]) for p in pls]))
        elif x < 0.85:
            tier.commit(t, [digests[i] for i in rng.integers(0, 12, int(rng.integers(0, 4)))])
        elif x < 0.95:
            got = tier.export(t, digests[:5])
            out.append(("export", [None if p is None else int(p["k"][0]) for p in got]))
        else:
            out.append(("digests", sorted(tier.digests())))
        out.append((len(tier), tier.used_bytes, tier.hits, tier.misses, tier.evictions,
                    tier.spilled_pages, list(tier._entries)))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_host_cache_equals_jax_on_operation_sequences(seed):
    assert _tier_trace(tcache, seed) == _tier_trace(jcache, seed)


def _cc(mod, **kw):
    return mod.CacheConfig(**{**dict(num_layers=2, num_kv_heads=2, head_dim=4, num_pages=8,
                                     page_size=4), **kw})


def _payloads(kv_dtype, dtype):
    """Well-formed and malformed payloads for pools of (kv_dtype, dtype)."""
    import ml_dtypes

    data = {None: np.dtype(ml_dtypes.bfloat16) if dtype == "bfloat16" else np.float32,
            "int8": np.int8}[kv_dtype]
    shp, sshp = (2, 2, 4, 4), (2, 2, 4)

    def pl(k=shp, v=shp, dt=data, ks=None, vs=None):
        return {"k": np.zeros(k, dt), "v": np.zeros(v, dt), "ks": ks, "vs": vs}

    sc = np.zeros(sshp, np.float32)
    good = pl(ks=sc, vs=sc) if kv_dtype == "int8" else pl()
    cases = [good, "nope", None, {}, {**good, "k": None}, {**good, "k": [[0]]},
             pl(k=(2, 2, 4, 3), ks=good["ks"], vs=good["vs"]),
             pl(dt=np.float16, ks=good["ks"], vs=good["vs"]),
             pl(dt=np.int8, ks=good["ks"], vs=good["vs"]),
             pl(dt=np.float32, ks=good["ks"], vs=good["vs"]),
             {**good, "k": good["k"].ravel()[:3].copy()}]
    if kv_dtype == "int8":
        cases += [{**good, "ks": None}, {**good, "vs": sc.astype(np.float64)},
                  {**good, "ks": np.zeros((2, 2, 3), np.float32)}]
    else:
        cases += [{**good, "ks": sc, "vs": sc}]
    return cases


@pytest.mark.parametrize("kv_dtype,dtype", [(None, "float32"), (None, "bfloat16"),
                                            ("int8", "bfloat16")])
def test_payload_shape_ok_verdicts_equal_jax(kv_dtype, dtype):
    jcc, tcc = _cc(jcache, kv_dtype=kv_dtype, dtype=dtype), _cc(tcache, kv_dtype=kv_dtype,
                                                                dtype=dtype)
    verdicts = [(tcache.payload_shape_ok(p, tcc), jcache.payload_shape_ok(p, jcc))
                for p in _payloads(kv_dtype, dtype)]
    assert [t for t, _ in verdicts] == [j for _, j in verdicts]
    assert verdicts[0] == (True, True) and sum(t for t, _ in verdicts) <= 2


def test_payload_shape_ok_takes_the_ports_bf16_view():
    """A bf16 pool's payload in the port is the same bytes as uint16; the
    JAX bfloat16 array of those bytes is turned into that view."""
    import ml_dtypes

    cc = _cc(tcache, dtype="bfloat16")
    j = np.arange(64, dtype=np.float32).astype(ml_dtypes.bfloat16).reshape(2, 2, 4, 4)
    mine = tcache.as_pool_view({"k": j, "v": j, "ks": None, "vs": None})
    assert mine["k"].dtype == np.uint16 and mine["k"].tobytes() == j.tobytes()
    assert tcache.payload_shape_ok(mine, cc)
    assert not tcache.payload_shape_ok(mine, _cc(tcache, dtype="float32"))


# -- the engines --------------------------------------------------------


@pytest.fixture(scope="module")
def jparams():
    return j_init_params(jget_config("debug-tiny"), jax.random.key(0), dtype="float32")


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _port(tparams, **kw):
    return Engine(EngineConfig(**{**SMALL, "device": "cpu", "kv_host_cache_gb": 0.5,
                                  **kw}), params=tparams)


def _drain(eng, reqs, limit=20_000):
    for _ in range(limit):
        if all(r.finished for r in reqs) and not eng.has_work():
            return
        eng.step()
    raise AssertionError("engine did not drain")


def _sessions(eng, n_sessions=4, turns=3, seed=0, max_tokens=4):
    """Round-robin multi-turn sessions: each turn's prompt is the last
    turn's prompt, its answer and a new user message."""
    rng = np.random.default_rng(seed)
    hist = [[int(t) for t in rng.integers(1, 250, 30 + 3 * s)] for s in range(n_sessions)]
    outs = []
    for _turn in range(turns):
        for s in range(n_sessions):
            r = eng.submit(hist[s], SamplingParams(temperature=0.0, max_tokens=max_tokens),
                           tenant=f"s{s % 2}")
            _drain(eng, [r])
            outs.append(r.output)
            hist[s] = hist[s] + r.output + [int(t) for t in rng.integers(1, 250, 5)]
    return outs


def _evict_device_tier(eng):
    """Every cached device page reclaimed: only the host tier can serve."""
    a = eng.allocator
    a._prefix_map.clear()
    a._page_digest.clear()
    for p in list(a._lru):
        del a._lru[p]
        a.free_pages.append(p)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("async_scheduling", [False, True])
def test_sessions_stream_equal_with_the_tier_on_and_off(tparams, kv_dtype, async_scheduling):
    """A pool of 14 pages for 4 growing sessions (~22 pages of history):
    idle sessions lose their device pages, returning turns adopt host
    pages; every stream equals the tier-off engine's. Every returning
    prompt is past the largest bucket, so both engines prefill it through
    the chunk path (from the host hit, or from the start): a one-shot
    prefill would differ from the chunk path by float rounding, which the
    card's check triages instead."""
    kw = dict(kv_cache_dtype=kv_dtype, async_scheduling=async_scheduling, num_pages=14)
    on = _port(tparams, **kw)
    off = _port(tparams, kv_host_cache_gb=0, **kw)
    assert off.host_kv is None
    assert _sessions(on) == _sessions(off)
    assert on.host_kv.hits > 0 and on.kv_uploaded_tokens > 0 and len(on.kv_upload_obs) > 0
    if kv_dtype == "int8":
        pl = next(iter(on.host_kv._entries.values()))
        assert pl["k"].dtype == np.int8 and pl["ks"].dtype == np.float32


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("async_scheduling", [False, True])
def test_resume_from_host_pages_equals_a_cold_run(tparams, kv_dtype, async_scheduling):
    eng = _port(tparams, kv_cache_dtype=kv_dtype, async_scheduling=async_scheduling)
    cold = eng.generate(PROMPT, SamplingParams(temperature=0.0, max_tokens=8))
    eng._drain_spills()
    assert eng.host_kv.spilled_pages > 0
    _evict_device_tier(eng)
    hot = eng.generate(PROMPT, SamplingParams(temperature=0.0, max_tokens=8))
    assert hot == cold
    assert eng.host_kv.hits > 0 and eng.kv_uploaded_tokens > 0


@pytest.mark.parametrize("async_scheduling", [False, True])
def test_preempted_resume_uploads_and_equals_the_uninterrupted_stream(tparams,
                                                                      async_scheduling):
    """A pool too small for the batch: victims spill, and their resumes
    upload host pages and prefill fewer tokens than a re-prefill; every
    stream equals the roomy pool's."""
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(1, 250, 17 + i)] for i in range(4)]
    sp = SamplingParams(temperature=0.0, max_tokens=20)
    roomy = _port(tparams, kv_host_cache_gb=0, async_scheduling=async_scheduling)
    want = [roomy.generate(p, sp) for p in prompts]
    eng = _port(tparams, num_pages=13, async_scheduling=async_scheduling)
    reqs = [eng.submit(p, sp) for p in prompts]
    _drain(eng, reqs)
    assert eng.preemptions > 0, "the pool was sized to force preemption"
    assert [r.output for r in reqs] == want
    assert eng.host_kv.hits > 0 and eng.kv_uploaded_tokens > 0


def test_trash_page_is_never_spilled(tparams):
    eng = _port(tparams, async_scheduling=False)
    req = eng.submit(list(range(1, 25)), SamplingParams(temperature=0.0, max_tokens=32))
    for _ in range(3):
        eng.step()
    slot = req.slot
    eng._spill_slot(req)
    eng._drain_spills()
    base = eng.host_kv.spilled_pages
    assert base >= 3
    pages = eng.allocator.slot_pages[slot]
    orig = pages[0]
    pages[0] = 0                    # doctored: the trash id in the list
    try:
        eng._spill_slot(req)
        eng._drain_spills()
    finally:
        pages[0] = orig
    assert eng.host_kv.spilled_pages - base == base - 1
    eng.abort(req)
    _drain(eng, [req])


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_spilled_payloads_equal_the_jax_engines(jparams, tparams, kv_dtype):
    """The same prompt through both engines with the tier on: the spilled
    pages' digests byte-equal, shapes and dtypes equal, float32 values
    within TOL; the int8 pages' scales within TOL relative."""
    prompt = [int(t) for t in np.random.default_rng(7).integers(1, 250, 29)]
    spills = []
    for eng, SP in ((JEngine(JEngineConfig(**SMALL, kv_host_cache_gb=0.5,
                                           kv_cache_dtype=kv_dtype), params=jparams),
                     JSamplingParams),
                    (_port(tparams, kv_cache_dtype=kv_dtype), SamplingParams)):
        r = eng.submit(prompt, SP(temperature=0.0, max_tokens=4), tenant="t")
        while not r.finished or eng.has_work():
            eng.step()
        eng._drain_spills()
        spills.append(dict(eng.host_kv._entries))
    jspill, tspill = spills
    assert list(tspill) == list(jspill) and len(tspill) >= len(prompt) // 8
    for key, jp in jspill.items():
        tp = tspill[key]
        for side in ("k", "v", "ks", "vs"):
            if jp[side] is None:
                assert tp[side] is None
                continue
            assert tp[side].shape == jp[side].shape and tp[side].dtype == jp[side].dtype
            if kv_dtype is None:
                np.testing.assert_allclose(tp[side], jp[side], rtol=0, atol=TOL)
            elif side in ("ks", "vs"):
                np.testing.assert_allclose(tp[side], jp[side], rtol=TOL, atol=0)
            else:       # int8 values: a rounding boundary may move one step
                assert np.abs(tp[side].astype(int) - jp[side].astype(int)).max() <= 1


def test_tier_off_without_prefix_caching(tparams):
    assert _port(tparams, prefix_caching=False).host_kv is None


def test_prefix_filter_advertises_host_pages(tparams):
    eng = _port(tparams, async_scheduling=False)
    eng.generate(PROMPT, SamplingParams(temperature=0.0, max_tokens=4))
    eng._drain_spills()
    _evict_device_tier(eng)
    assert eng.allocator.prefix_digests() == []
    assert set(eng.prefix_filter_digests()) == set(eng.host_kv.digests()) != set()


def test_handoff_submit_lands_its_pages_before_the_finish(tparams):
    eng = _port(tparams, role="prefill")
    req = eng.submit(list(PROMPT), SamplingParams(temperature=0.0, max_tokens=1),
                     tenant="t", handoff=True)
    _drain(eng, [req])
    digests = eng.handoff_digests(PROMPT)
    payloads = eng.host_kv_export("t", digests)
    assert len(payloads) == len(PROMPT) // 8 and all(p is not None for p in payloads)
    assert eng.host_kv_export("other", digests) == [None] * len(digests)
    assert _port(tparams, kv_host_cache_gb=0).host_kv_export("t", digests) == \
        [None] * len(digests)


def test_upload_observations_are_seconds(tparams):
    eng = _port(tparams, async_scheduling=False)
    eng.generate(PROMPT, SamplingParams(temperature=0.0, max_tokens=4))
    eng._drain_spills()
    _evict_device_tier(eng)
    t0 = time.perf_counter()
    eng.generate(PROMPT, SamplingParams(temperature=0.0, max_tokens=4))
    assert eng.kv_upload_obs and 0 < max(eng.kv_upload_obs) < time.perf_counter() - t0
