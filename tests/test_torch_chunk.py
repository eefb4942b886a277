"""The port's chunk path against the JAX package's, on the CPU.

- ``chunk_attention`` against the JAX function on the same pools: float32
  and int8 pools, history 0, mid-page and page-aligned, an idle row, a
  window and a softcap, within 1e-5 (only the f32 summation order differs).
- The plain window writers against the Pallas window kernels run in
  interpret mode: the float writer byte-equal outside the trash page 0; the
  int8 writer exact against a splice of the JAX ``quantize_kv`` run eagerly
  and within one ulp (scales) / one (values) of the interpret kernel, which
  jit-compiles its division by 127 into a multiply.
- ``forward_chunk`` against the JAX ``forward_chunk``: a 12-token prompt in
  three chunks of 4, logits within 1e-4 and the pools equal on every row
  below ``history + length`` (the JAX write leaves filler rows past a chunk;
  the window kernels write none), float and int8 KV, debug-tiny and
  debug-gemma (window, softcaps, post norms).
- The engine: prompts past the largest bucket generate exactly what the
  JAX engine generates (greedy), in ceil(n / bucket) chunk calls; a seeded
  stream is the same chunked as one-shot; int8 KV and kv_write "fused" too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llms_on_kubernetes_tpu.configs import get_config as jget_config
from llms_on_kubernetes_tpu.engine import cache as jcache
from llms_on_kubernetes_tpu.engine.engine import Engine as JEngine
from llms_on_kubernetes_tpu.engine.engine import EngineConfig as JEngineConfig
from llms_on_kubernetes_tpu.engine.engine import SamplingParams as JSamplingParams
from llms_on_kubernetes_tpu.models import decoder as jdec
from llms_on_kubernetes_tpu.ops.attention import chunk_attention as j_chunk_attention
from llms_on_kubernetes_tpu.ops.pallas_paged import (
    pallas_paged_write_window, pallas_paged_write_window_int8,
)
from llms_on_kubernetes_tpu_torch.configs import get_config
from llms_on_kubernetes_tpu_torch.engine import cache as tcache
from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
from llms_on_kubernetes_tpu_torch.engine.weights import params_from_numpy
from llms_on_kubernetes_tpu_torch.models import decoder as tdec
from llms_on_kubernetes_tpu_torch.ops import attention as tatt
from llms_on_kubernetes_tpu_torch.ops import paged_write as pw

ATT_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# chunk_attention
# ---------------------------------------------------------------------------

def _chunk_case(rng, int8: bool, history, chunk_lengths, T=8, n_kv=2, group=2, d=16,
                page=4, pps=6):
    B = len(history)
    P = B * pps + 1
    table = np.zeros((B, pps), np.int32)
    perm = rng.permutation(P - 1) + 1
    for b in range(B):
        used = -(-int(history[b] + chunk_lengths[b]) // page)
        table[b, :used] = perm[b * pps:b * pps + used]
    q = rng.normal(size=(B, T, n_kv * group, d)).astype(np.float32)
    if int8:
        pools = [(rng.integers(-127, 128, size=(n_kv, P, page, d)).astype(np.int8),
                  (rng.random(size=(n_kv, P, page)) * 0.05 + 0.001).astype(np.float32))
                 for _ in range(2)]
        jp = [jcache.KVPool(jnp.asarray(a), jnp.asarray(s)) for a, s in pools]
        tp = [tcache.KVPool(*_t(a, s)) for a, s in pools]
    else:
        pools = [rng.normal(size=(n_kv, P, page, d)).astype(np.float32) for _ in range(2)]
        jp = [jnp.asarray(a) for a in pools]
        tp = _t(*pools)
    h, c = np.asarray(history, np.int32), np.asarray(chunk_lengths, np.int32)
    return q, jp, tp, table, h, c


@pytest.mark.parametrize("int8", [False, True], ids=["f32_pool", "int8_pool"])
@pytest.mark.parametrize("window,cap", [(None, None), (5, None), (None, 20.0)])
def test_chunk_attention_matches_jax(rng, int8, window, cap):
    """Rows: history 0; mid-page (5); page-aligned (8); an idle row."""
    history, lengths = [0, 5, 8, 3], [8, 7, 6, 0]
    q, jp, tp, table, h, c = _chunk_case(rng, int8, history, lengths)
    kw = dict(scale=0.25, sliding_window=window, attn_softcap=cap)
    want = j_chunk_attention(jnp.asarray(q), *jp, jnp.asarray(table), jnp.asarray(h),
                             jnp.asarray(c), **kw)
    got = tatt.chunk_attention(*_t(q), *tp, *_t(table, h, c), **kw)
    assert got.shape == q.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT_TOL)
    # the dispatcher takes the same function on every device
    again = tatt.dispatch_chunk_attention(*_t(q), *tp, *_t(table, h, c), **kw)
    assert torch.equal(again, got)


def test_chunk_attention_history_zero_is_prefill_attention(rng):
    """With history 0 the chunk attends exactly the keys prefill attends:
    held to the port's plain prefill over the same K/V."""
    T, n_kv, d, page = 8, 2, 16, 4
    q = rng.normal(size=(1, T, 4, d)).astype(np.float32)
    k = rng.normal(size=(1, T, n_kv, d)).astype(np.float32)
    v = rng.normal(size=(1, T, n_kv, d)).astype(np.float32)
    kp = np.zeros((n_kv, 3, page, d), np.float32)
    vp = np.zeros_like(kp)
    kp[:, 1:] = k[0].transpose(1, 0, 2).reshape(n_kv, 2, page, d)
    vp[:, 1:] = v[0].transpose(1, 0, 2).reshape(n_kv, 2, page, d)
    table = np.asarray([[1, 2]], np.int32)
    n = np.asarray([7], np.int32)
    got = tatt.chunk_attention(*_t(q, kp, vp, table), torch.zeros(1, dtype=torch.int32),
                               *_t(n), scale=0.3)
    ref = tatt.prefill_attention(*_t(q, k, v, n), scale=0.3)
    np.testing.assert_allclose(got[0, :7].numpy(), ref[0, :7].numpy(), **ATT_TOL)


# ---------------------------------------------------------------------------
# window writers
# ---------------------------------------------------------------------------

WINDOW_CASES = {
    # tests/test_pallas.py:261: mid-page, a page boundary, position 0, a
    # window crossing into a fresh page, an idle row
    "test_pallas": dict(n_kv=2, d=8, page=8, pps=4, W=4, base=[7, 8, 0, 15, 3],
                        widths=[4, 3, 4, 2, 0]),
    "d128_page16": dict(n_kv=2, d=128, page=16, pps=4, W=20, base=[0, 16, 5, 40],
                        widths=[20, 16, 1, 0]),
}


def _window_setup(rng, n_kv, d, page, pps, W, base, widths):
    B = len(base)
    P = B * pps + 1
    table = np.zeros((B, pps), np.int32)
    perm = rng.permutation(P - 1) + 1
    for b in range(B):
        used = min(pps, -(-(base[b] + W) // page))
        table[b, :used] = perm[b * pps:b * pps + used]
    k_new = rng.normal(size=(B, W, n_kv, d)).astype(np.float32)
    v_new = rng.normal(size=(B, W, n_kv, d)).astype(np.float32)
    return P, table, np.asarray(base, np.int32), np.asarray(widths, np.int32), k_new, v_new


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_window_writer_matches_the_pallas_kernel(rng, case):
    c = WINDOW_CASES[case]
    P, table, base, widths, k_new, v_new = _window_setup(rng, **c)
    kp = rng.normal(size=(c["n_kv"], P, c["page"], c["d"])).astype(np.float32)
    vp = rng.normal(size=kp.shape).astype(np.float32)
    jk, jv = pallas_paged_write_window(
        *(jnp.asarray(a) for a in (kp, vp, table, base, widths, k_new, v_new)), interpret=True)
    tk, tv = _t(kp, vp)
    out = pw.paged_write_window(tk, tv, *_t(table, base, widths, k_new, v_new))
    assert out[0] is tk and out[1] is tv                      # in place
    np.testing.assert_array_equal(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:])
    np.testing.assert_array_equal(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:])
    # the rows past each width keep their bytes (the kernel writes none)
    untouched = np.ones((P, c["page"]), bool)
    for b in range(len(base)):
        for t in range(int(widths[b])):
            pos = base[b] + t
            untouched[table[b, pos // c["page"]], pos % c["page"]] = False
    untouched[0] = False
    np.testing.assert_array_equal(tk.numpy()[:, untouched], kp[:, untouched])


def test_window_writer_casts_to_the_pool_dtype(rng):
    """A bf16 pool takes f32 rows rounded to bf16, as the JAX wrapper casts
    them."""
    c = WINDOW_CASES["test_pallas"]
    P, table, base, widths, k_new, v_new = _window_setup(rng, **c)
    kp = torch.zeros((c["n_kv"], P, c["page"], c["d"]), dtype=torch.bfloat16)
    vp = torch.zeros_like(kp)
    pw.paged_write_window(kp, vp, *_t(table, base, widths, k_new, v_new))
    b, t = 0, 2
    pos = base[b] + t
    row = kp[:, table[b, pos // c["page"]], pos % c["page"]]
    assert torch.equal(row, torch.from_numpy(k_new[b, t]).to(torch.bfloat16))


def _int8_pools(rng, n_kv, P, page, d):
    return [rng.integers(-127, 128, size=(n_kv, P, page, d)).astype(np.int8),
            (rng.random(size=(n_kv, P, page)) + 0.1).astype(np.float32),
            rng.integers(-127, 128, size=(n_kv, P, page, d)).astype(np.int8),
            (rng.random(size=(n_kv, P, page)) + 0.1).astype(np.float32)]


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_int8_window_writer_equals_eager_jax_splice(rng, case):
    """Written rows hold the eager JAX quantize_kv bytes exactly; every
    other byte (data and scale) is the pool's own, page 0 included."""
    c = WINDOW_CASES[case]
    P, table, base, widths, k_new, v_new = _window_setup(rng, **c)
    pools = _int8_pools(rng, c["n_kv"], P, c["page"], c["d"])
    want = [a.copy() for a in pools]
    for x, (data, scale) in ((k_new, (want[0], want[1])), (v_new, (want[2], want[3]))):
        qd, qs = jcache.quantize_kv(jnp.asarray(x))           # eager: IEEE division
        for b in range(len(base)):
            for t in range(int(widths[b])):
                pos = base[b] + t
                pid, off = table[b, pos // c["page"]], pos % c["page"]
                data[:, pid, off] = np.asarray(qd)[b, t]
                scale[:, pid, off] = np.asarray(qs)[b, t]
    got = _t(*pools)
    out = pw.paged_write_window_int8(*got, *_t(table, base, widths, k_new, v_new))
    assert all(o is g for o, g in zip(out, got))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy()[:, 1:], w[:, 1:])


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_int8_window_writer_within_an_ulp_of_the_pallas_kernel(rng, case):
    c = WINDOW_CASES[case]
    P, table, base, widths, k_new, v_new = _window_setup(rng, **c)
    pools = _int8_pools(rng, c["n_kv"], P, c["page"], c["d"])
    jout = pallas_paged_write_window_int8(
        *(jnp.asarray(a) for a in (*pools, table, base, widths, k_new, v_new)),
        interpret=True)
    got = _t(*pools)
    pw.paged_write_window_int8(*got, *_t(table, base, widths, k_new, v_new))
    for i, (g, j) in enumerate(zip(got, jout)):
        g, j = g.numpy()[:, 1:], np.asarray(j)[:, 1:]
        if i % 2:      # scales: one f32 ulp
            np.testing.assert_allclose(g, j, rtol=2e-7, atol=0)
        else:
            assert np.abs(g.astype(np.int32) - j.astype(np.int32)).max() <= 1


def test_dispatch_write_window_picks_by_pool(rng):
    c = WINDOW_CASES["test_pallas"]
    P, table, base, widths, k_new, v_new = _window_setup(rng, **c)
    shape = (c["n_kv"], P, c["page"], c["d"])
    fk, fv = tcache.KVPool(torch.zeros(shape)), tcache.KVPool(torch.zeros(shape))
    args = _t(table, base, widths, k_new, v_new)
    pw.dispatch_write_window(fk, fv, *args)
    ref = torch.zeros(shape), torch.zeros(shape)
    pw.paged_write_window_plain(*ref, *args)
    assert torch.equal(fk.data, ref[0]) and torch.equal(fv.data, ref[1])
    qk, qv = (tcache.KVPool(torch.zeros(shape, dtype=torch.int8), torch.zeros(shape[:3]))
              for _ in range(2))
    pw.dispatch_write_window(qk, qv, *args)
    ref = [torch.zeros(shape, dtype=torch.int8), torch.zeros(shape[:3]),
           torch.zeros(shape, dtype=torch.int8), torch.zeros(shape[:3])]
    pw.paged_write_window_int8_plain(*ref, *args)
    for a, b in zip((qk.data, qk.scale, qv.data, qv.scale), ref):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# forward_chunk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["debug-tiny", "debug-gemma"])
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_forward_chunk_matches_jax(rng, model, kv_dtype):
    """tests/test_chunked_prefill.py:41: a 12-token prompt in three chunks
    of 4 against the paged pool, both frameworks from the same weights."""
    jcfg = jget_config(model)
    tcfg = get_config(model)
    jp = jdec.init_params(jcfg, jax.random.key(0), dtype="float32")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    P = 32
    kw = dict(num_layers=jcfg.num_layers, num_kv_heads=jcfg.num_kv_heads,
              head_dim=jcfg.head_dim, num_pages=P, page_size=4, pages_per_slot=8,
              dtype="float32", kv_dtype=kv_dtype)
    jk, jv = jcache.init_pages(jcache.CacheConfig(**kw))
    tk, tv = tcache.init_pages(tcache.CacheConfig(**kw), device="cpu")
    n = 12
    prompt = rng.integers(0, jcfg.vocab_size, size=n).astype(np.int32)
    table = np.zeros((1, 8), np.int32)
    table[0, :3] = [5, 2, 9]
    for pos in range(0, n, 4):
        chunk = prompt[None, pos:pos + 4]
        h, c = np.asarray([pos], np.int32), np.asarray([4], np.int32)
        jlog, jk, jv = jdec.forward_chunk(jp, jcfg, *(jnp.asarray(a) for a in (chunk, h, c)),
                                          jk, jv, jnp.asarray(table))
        tlog, _, _ = tdec.forward_chunk(tp, tcfg, *_t(chunk, h, c), tk, tv, *_t(table))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
    # every row below history + length: the prompt's 12 rows of each layer
    rows = np.zeros((jcfg.num_layers * P, 4), bool)
    for layer in range(jcfg.num_layers):
        for pos in range(n):
            rows[layer * P + table[0, pos // 4], pos % 4] = True
    for t, j in ((tk, jk), (tv, jv)):
        if kv_dtype is None:
            np.testing.assert_allclose(t.data.numpy()[:, rows], np.asarray(j.data)[:, rows],
                                       rtol=2e-5, atol=2e-5)
        else:
            diff = t.data.numpy()[:, rows].astype(np.int32) - np.asarray(j.data)[:, rows]
            assert np.abs(diff).max() <= 1
            np.testing.assert_allclose(t.scale.numpy()[:, rows], np.asarray(j.scale)[:, rows],
                                       rtol=1e-5, atol=0)


def test_forward_chunk_with_history_zero_matches_one_shot_prefill(rng):
    """The port's own identity (tests/test_chunked_prefill.py:41): chunked
    in three chunks == one-shot forward_prefill, logits and pool rows."""
    cfg = get_config("debug-tiny")
    tp = tdec.init_params(cfg, seed=0, dtype="float32", device="cpu")
    cc = tcache.CacheConfig(cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, num_pages=32,
                            page_size=4, pages_per_slot=8, dtype="float32")
    n = 12
    prompt = rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
    table = torch.tensor([[1, 2, 3, 0, 0, 0, 0, 0]], dtype=torch.int32)
    kp, vp = tcache.init_pages(cc, device="cpu")
    tokens = np.zeros((1, 16), np.int32)
    tokens[0, :n] = prompt
    want, _, _ = tdec.forward_prefill(tp, cfg, *_t(tokens), torch.tensor([n], dtype=torch.int32),
                                      kp, vp, table)
    kc, vc = tcache.init_pages(cc, device="cpu")
    for pos in range(0, n, 4):
        got, _, _ = tdec.forward_chunk(tp, cfg, *_t(prompt[None, pos:pos + 4]),
                                       torch.tensor([pos], dtype=torch.int32),
                                       torch.tensor([4], dtype=torch.int32), kc, vc, table)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)
    keep = torch.ones(cfg.num_layers * 32, dtype=torch.bool)
    keep[::32] = False
    np.testing.assert_allclose(kc.data[:, keep].numpy(), kp.data[:, keep].numpy(),
                               rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

CHUNKED = dict(model="debug-tiny", dtype="float32", max_decode_slots=4, page_size=4,
               num_pages=128, pages_per_slot=16, prefill_buckets=(8,))


@pytest.fixture(scope="module")
def jparams():
    return jdec.init_params(jget_config("debug-tiny"), jax.random.key(0), dtype="float32")


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _port(tparams, **kw):
    return Engine(EngineConfig(**{**CHUNKED, "device": "cpu", **kw}), params=tparams)


def _jax(jparams, **kw):
    return JEngine(JEngineConfig(**{**CHUNKED, **kw}), params=jparams)


LONG = np.random.default_rng(7).integers(0, 256, size=33).tolist()   # 4 x 8 + 1


@pytest.mark.parametrize("kw", [{}, dict(kv_cache_dtype="int8"), dict(kv_write="fused"),
                                dict(kv_cache_dtype="int8", kv_write="fused")],
                         ids=["f32", "int8", "fused", "int8_fused"])
def test_long_prompt_greedy_stream_equals_jax(jparams, tparams, kw):
    """tests/test_chunked_prefill.py:95: a prompt 4x the largest bucket."""
    jkw = {k: v for k, v in kw.items() if k != "kv_write"}
    want = _jax(jparams, **jkw).generate(LONG, JSamplingParams(max_tokens=8, temperature=0.0))
    eng = _port(tparams, **kw)
    got = eng.generate(LONG, SamplingParams(max_tokens=8, temperature=0.0))
    assert got == want and len(got) == 8
    assert eng.chunk_calls == 5 and eng.prefill_calls == 0


@pytest.mark.parametrize("sampling", [dict(temperature=0.0),
                                      dict(temperature=0.9, top_k=8, seed=1234)],
                         ids=["greedy", "seeded"])
def test_long_prompt_chunked_equals_one_shot(tparams, sampling):
    """Chunked (bucket 8) == one-shot (bucket 64), greedy and seeded: the
    first token's noise is keyed on the prompt length either way."""
    p = SamplingParams(max_tokens=8, **sampling)
    one_shot = _port(tparams, prefill_buckets=(64,))
    want = one_shot.generate(LONG, p)
    assert one_shot.chunk_calls == 0 and one_shot.prefill_calls == 1
    assert _port(tparams).generate(LONG, p) == want


@pytest.mark.parametrize("n", [9, 16, 29, 33])
def test_chunk_count_is_ceil_n_over_bucket(tparams, n):
    eng = _port(tparams)
    eng.generate(list(range(1, n + 1)), SamplingParams(max_tokens=2, temperature=0.0))
    assert eng.chunk_calls == -(-n // 8) and eng.prefill_calls == 0


def test_long_prompt_mixed_with_short_requests(jparams, tparams):
    """tests/test_chunked_prefill.py:125: a chunked prompt batched with
    short ones; every stream is the JAX engine's and its solo run's."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, size=20).tolist(), [3, 17, 9], [40, 2, 8, 11]]
    p = SamplingParams(max_tokens=6, temperature=0.0)
    solo = [_port(tparams).generate(pr, p) for pr in prompts]
    jeng = _jax(jparams)
    jreqs = [jeng.submit(pr, JSamplingParams(max_tokens=6, temperature=0.0)) for pr in prompts]
    while jeng.has_work():
        jeng.step()
    eng = _port(tparams)
    reqs = [eng.submit(pr, p) for pr in prompts]
    for _ in range(300):
        if not eng.has_work():
            break
        eng.step()
    assert [r.output for r in reqs] == solo == [r.output for r in jreqs]


def test_submit_accepts_out_of_bucket_prompt_within_pages(tparams):
    """tests/test_chunked_prefill.py:167: up to max_model_len - 1 tokens."""
    eng = _port(tparams)                     # max_model_len = 64
    req = eng.submit(list(range(1, 41)), SamplingParams(max_tokens=2, temperature=0.0))
    while not req.finished:
        eng.step()
    assert len(req.output) == 2
    req = eng.submit([5] * 63, SamplingParams(max_tokens=4, temperature=0.0))
    while not req.finished:
        eng.step()
    assert req.output and req.finish_reason == "length"
    with pytest.raises(ValueError, match="max_model_len"):
        eng.submit(list(range(64)), SamplingParams(max_tokens=2, temperature=0.0))
