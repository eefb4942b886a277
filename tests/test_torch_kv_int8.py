"""The port's int8 KV cache against the JAX package's, on the CPU.

- ``quantize_kv`` and int8 ``write_tokens`` leave the bytes of the JAX
  functions run EAGERLY, exactly (data and scale; outside the trash pages
  for the pools). Under ``jax.jit`` XLA-CPU turns the division by 127 into
  a multiply, so a scale may differ by one ulp (rtol 2e-7) and a value by
  one (|diff| <= 1), which is what the JAX package's own tests allow
  between its jitted path and its Pallas kernels.
- The plain versions of the int8 decode kernels (kernel 4: attention over
  the dequantized pool; kernel 5: int8 ``write_tokens`` then that
  attention) against JAX ``paged_attention`` at 1e-5 and against the
  Pallas kernels in interpret mode at 2e-5 (the kernels fold the scales
  into the logits and probabilities, a different rounding order).
- debug-tiny in float32 with ``kv_dtype="int8"``: logits within 1e-4 of
  the JAX decoder's (run eagerly, so both quantize the same K/V to the
  same bytes up to the f32 summation order of the projections), and the
  engines' greedy streams identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llms_on_kubernetes_tpu.configs import get_config as jget_config
from llms_on_kubernetes_tpu.engine import cache as jcache
from llms_on_kubernetes_tpu.models import decoder as jdec
from llms_on_kubernetes_tpu.ops.attention import paged_attention as j_paged_attention
from llms_on_kubernetes_tpu_torch.configs import get_config
from llms_on_kubernetes_tpu_torch.engine import cache as tcache
from llms_on_kubernetes_tpu_torch.engine.weights import params_from_numpy
from llms_on_kubernetes_tpu_torch.models import decoder as tdec
from llms_on_kubernetes_tpu_torch.ops import paged_attention as pa

SCALE_RTOL = 2e-7      # one f32 ulp of a scale
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _mixed(rng, *shape):
    """Values whose per-token magnitude spans nine decades, plus an
    all-zero row (the 1e-8 clamp) and a row of tiny values."""
    x = rng.normal(size=shape) * 10.0 ** rng.uniform(-6, 3, size=shape[:-1] + (1,))
    x = x.astype(np.float32)
    x.reshape(-1, shape[-1])[0] = 0.0
    x.reshape(-1, shape[-1])[1] *= 1e-6
    return x


# ---------------------------------------------------------------------------
# quantize_kv, init_pages, CacheConfig
# ---------------------------------------------------------------------------

def test_quantize_kv_equals_eager_jax_byte_for_byte(rng):
    x = _mixed(rng, 16, 65, 8, 128)
    jd, js = jcache.quantize_kv(jnp.asarray(x))
    td, ts = tcache.quantize_kv(torch.from_numpy(x))
    assert td.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == (16, 65, 8)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantize_kv_within_one_ulp_of_jitted_jax(rng):
    x = _mixed(rng, 16, 65, 8, 128)
    jd, js = jax.jit(jcache.quantize_kv)(jnp.asarray(x))
    td, ts = tcache.quantize_kv(torch.from_numpy(x))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=SCALE_RTOL, atol=0)
    assert np.abs(td.numpy().astype(np.int32) - np.asarray(jd).astype(np.int32)).max() <= 1


def test_quantize_kv_of_bf16_equals_jax(rng):
    """The decoder's K/V are bf16 in a bf16 model: both sides widen to f32
    first."""
    x = _mixed(rng, 4, 9, 2, 64)
    jd, js = jcache.quantize_kv(jnp.asarray(x, jnp.bfloat16))
    td, ts = tcache.quantize_kv(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("kv_dtype,dtype", [("int8", "bfloat16"), ("int8", "float32"),
                                            (None, "bfloat16"), (None, "float32")])
def test_cache_config_and_init_pages_match_jax(kv_dtype, dtype):
    kw = dict(num_layers=3, num_kv_heads=4, head_dim=16, num_pages=10, page_size=8,
              pages_per_slot=4, dtype=dtype, kv_dtype=kv_dtype)
    tc, jc = tcache.CacheConfig(**kw), jcache.CacheConfig(**kw)
    assert tc.bytes_per_page == jc.bytes_per_page
    assert tc.bytes_per_token == jc.bytes_per_token
    tk, tv = tcache.init_pages(tc, device="cpu")
    jk, _ = jcache.init_pages(jc)
    assert tk.quantized == jk.quantized == (kv_dtype == "int8")
    assert tuple(tk.shape) == tuple(jk.shape) == (4, 30, 8, 16)
    assert str(tk.dtype).split(".")[-1] == str(jk.dtype)
    if kv_dtype:
        assert tuple(tk.scale.shape) == tuple(jk.scale.shape) == (4, 30, 8)
        assert tk.scale.dtype == torch.float32
        assert float(tv.scale.abs().sum()) == 0.0
    assert float(tk.data.abs().sum()) == float(tv.data.abs().sum()) == 0.0


def test_llama_pool_bytes_halve_with_int8():
    """The default EngineConfig pool at llama-3-8b widths (32 layers, 8 KV
    heads, d 128, 512 pages of 64): 4.29 GB bf16, 2.21 GB int8."""
    kw = dict(num_layers=32, num_kv_heads=8, head_dim=128, num_pages=512, page_size=64)
    bf16 = tcache.CacheConfig(**kw).bytes_per_page * 512
    int8 = tcache.CacheConfig(**kw, kv_dtype="int8").bytes_per_page * 512
    assert (bf16, int8) == (4_294_967_296, 2_214_592_512)


def test_init_pages_rejects_other_kv_dtypes():
    for mod in (tcache, jcache):
        with pytest.raises(ValueError, match="kv_dtype"):
            kw = {} if mod is jcache else {"device": "cpu"}
            mod.init_pages(mod.CacheConfig(num_layers=1, num_kv_heads=1, head_dim=8,
                                           kv_dtype="fp4"), **kw)


# ---------------------------------------------------------------------------
# write_tokens on int8 pools: the cases of tests/test_torch_cache.py
# ---------------------------------------------------------------------------

def _int8_pools(rng, n_kv, P, page, d):
    """Pools that already hold bytes, so untouched rows are checked too."""
    def one():
        return (rng.integers(-127, 128, size=(n_kv, P, page, d)).astype(np.int8),
                (rng.random(size=(n_kv, P, page)) + 0.1).astype(np.float32))
    return one(), one()


def _both(pools, k, v, table, positions, trash_pages=(0,)):
    (kd, ks), (vd, vs) = pools
    jk, jv = jcache.write_tokens(
        jcache.KVPool(jnp.asarray(kd), jnp.asarray(ks)),
        jcache.KVPool(jnp.asarray(vd), jnp.asarray(vs)), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(table), jnp.asarray(positions))
    tk = tcache.KVPool(torch.from_numpy(kd.copy()), torch.from_numpy(ks.copy()))
    tv = tcache.KVPool(torch.from_numpy(vd.copy()), torch.from_numpy(vs.copy()))
    out = tcache.write_tokens(tk, tv, torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(table), torch.from_numpy(positions))
    assert out[0] is tk and out[1] is tv                # updated in place
    keep = np.ones(kd.shape[1], bool)
    keep[list(trash_pages)] = False
    for t, j in ((tk, jk), (tv, jv)):
        np.testing.assert_array_equal(t.data.numpy()[:, keep], np.asarray(j.data)[:, keep])
        np.testing.assert_array_equal(t.scale.numpy()[:, keep], np.asarray(j.scale)[:, keep])
    return tk, tv


@pytest.mark.parametrize("lengths", [[7, 5], [16, 0], [1, 13]])
def test_int8_prefill_write_matches_jax(rng, lengths):
    n_kv, d, page, pps, T = 2, 8, 4, 6, 16
    B = len(lengths)
    P = B * pps + 1
    pools = _int8_pools(rng, n_kv, P, page, d)
    table = np.zeros((B, pps), np.int32)
    perm = rng.permutation(P - 1) + 1
    for b, n in enumerate(lengths):
        used = -(-n // page)
        table[b, :used] = perm[b * pps:b * pps + used]
    k, v = _mixed(rng, B, T, n_kv, d), _mixed(rng, B, T, n_kv, d)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    positions = np.where(pos < np.asarray(lengths)[:, None], pos, -1).astype(np.int32)
    _both(pools, k, v, table, positions)


def test_int8_chunk_write_mid_page_matches_jax(rng):
    n_kv, d, page, T, P = 1, 8, 4, 8, 8
    pools = _int8_pools(rng, n_kv, P, page, d)
    table = np.asarray([[3, 5, 6]], np.int32)
    k, v = _mixed(rng, 1, T, n_kv, d), _mixed(rng, 1, T, n_kv, d)
    positions = np.asarray([[6, 7, 8, 9, 10, 11, -1, -1]], np.int32)
    _both(pools, k, v, table, positions)


def test_int8_decode_write_matches_jax_including_idle_rows(rng):
    n_kv, d, page, P = 2, 16, 4, 13
    pools = _int8_pools(rng, n_kv, P, page, d)
    table = np.asarray([[1, 2, 3, 0], [4, 5, 0, 0], [6, 0, 0, 0], [7, 8, 9, 10]], np.int32)
    k, v = _mixed(rng, 4, 1, n_kv, d), _mixed(rng, 4, 1, n_kv, d)
    positions = np.asarray([[9], [-1], [3], [15]], np.int32)
    tk, _ = _both(pools, k, v, table, positions)
    kq, ksc = tcache.quantize_kv(torch.from_numpy(k[1, 0]))
    assert torch.equal(tk.data[:, 0, 0], kq) and torch.equal(tk.scale[:, 0, 0], ksc)


def test_int8_large_chunk_scatter_path_matches_jax(rng):
    n_kv, d, page, T, P = 2, 8, 1, 64, 80
    pools = _int8_pools(rng, n_kv, P, page, d)
    table = np.zeros((2, 70), np.int32)
    table[0] = rng.permutation(np.arange(1, 71))
    table[1] = rng.permutation(np.arange(1, 80))[:70]
    positions = np.full((2, T), -1, np.int32)
    positions[0] = np.arange(3, 3 + T)
    positions[1, :10] = np.arange(10)
    k, v = _mixed(rng, 2, T, n_kv, d), _mixed(rng, 2, T, n_kv, d)
    _both(pools, k, v, table, positions)


def test_int8_multi_layer_page_offsets_match_jax(rng):
    n_kv, d, page, T, P = 2, 8, 4, 8, 9
    pools = _int8_pools(rng, n_kv, 2 * P, page, d)
    table = np.asarray([[2, 5, 0, 0], [7, 0, 0, 0]], np.int32) + P
    k, v = _mixed(rng, 2, T, n_kv, d), _mixed(rng, 2, T, n_kv, d)
    positions = np.where(np.arange(T)[None] < np.asarray([[6], [3]]),
                         np.arange(T)[None], -1).astype(np.int32)
    _both(pools, k, v, table, positions, trash_pages=(0, P))


# ---------------------------------------------------------------------------
# kernel 4's and kernel 5's plain versions
# ---------------------------------------------------------------------------

def _filled(rng, KV, P, page, d, B, T):
    """tests/test_kv_int8.py's _filled_pools: T tokens per slot written by
    the JAX write_tokens (jitted) into an int8 pool; returns numpy arrays."""
    cc = jcache.CacheConfig(num_layers=1, num_kv_heads=KV, head_dim=d, num_pages=P,
                            page_size=page, pages_per_slot=P - 1, dtype="float32",
                            kv_dtype="int8")
    kp, vp = jcache.init_pages(cc)
    k = jnp.asarray(rng.normal(size=(B, T, KV, d)), jnp.float32)
    v = jnp.asarray(rng.normal(size=(B, T, KV, d)), jnp.float32)
    pps = (T + page - 1) // page
    pt = np.zeros((B, P - 1), np.int32)
    for b in range(B):
        pt[b, :pps] = 1 + b * pps + np.arange(pps)
    positions = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    kp, vp = jax.jit(jcache.write_tokens)(kp, vp, k, v, jnp.asarray(pt),
                                           jnp.asarray(positions))
    return [np.asarray(a) for a in (kp.data, kp.scale, vp.data, vp.scale)], pt


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("window", [None, 6])
def test_int8_decode_plain_matches_jax_and_the_pallas_kernel(rng, window):
    from llms_on_kubernetes_tpu.ops.pallas_paged import pallas_paged_attention_int8

    KV, P, page, d, B, T = 2, 9, 4, 128, 2, 12
    (kd, ks, vd, vs), pt = _filled(rng, KV, P, page, d, B, T)
    q = rng.normal(size=(B, 4, d)).astype(np.float32)
    lengths = np.asarray([T, T - 5], np.int32)
    kw = dict(scale=0.3, sliding_window=window)
    out = pa.paged_decode_attention_int8(*_t(q, kd, ks, vd, vs, pt, lengths), **kw)
    ref = j_paged_attention(jnp.asarray(q), jcache.KVPool(jnp.asarray(kd), jnp.asarray(ks)),
                            jcache.KVPool(jnp.asarray(vd), jnp.asarray(vs)), jnp.asarray(pt),
                            jnp.asarray(lengths), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    pallas = pallas_paged_attention_int8(
        *(jnp.asarray(a) for a in (q, kd, ks, vd, vs, pt, lengths)), interpret=True, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window,softcap", [(None, None), (9, None), (None, 40.0)])
def test_int8_write_plain_matches_the_pallas_kernel(window, softcap):
    """tests/test_kv_int8.py:104-165: lengths mid-page, at a fresh-page
    boundary, 1 token of history, an idle row, the last row of the last
    page. Outputs on active rows at 2e-5; outside page 0, int8 data within
    one and scales within one ulp of the Pallas kernel's (it quantizes
    inside a traced program)."""
    from llms_on_kubernetes_tpu.ops.pallas_paged import pallas_paged_attention_write_int8

    rng = np.random.default_rng(3)
    KV, group, d, page, pps = 2, 2, 8, 8, 4
    hist = np.asarray([13, 16, 1, 0, 31], np.int32)
    B, n_q = len(hist), KV * group
    P = B * pps + 1
    cc = jcache.CacheConfig(num_layers=1, num_kv_heads=KV, head_dim=d, num_pages=P,
                            page_size=page, pages_per_slot=pps, dtype="float32",
                            kv_dtype="int8")
    kp, vp = jcache.init_pages(cc)
    table = np.zeros((B, pps), np.int32)
    for b in range(B):
        table[b] = 1 + b * pps + np.arange(pps)
    Tmax = int(hist.max())
    k_hist = jnp.asarray(rng.normal(size=(B, Tmax, KV, d)), jnp.float32)
    v_hist = jnp.asarray(rng.normal(size=(B, Tmax, KV, d)), jnp.float32)
    pos = np.broadcast_to(np.arange(Tmax, dtype=np.int32), (B, Tmax)).copy()
    pos[pos >= hist[:, None]] = -1
    kp, vp = jax.jit(jcache.write_tokens)(kp, vp, k_hist, v_hist, jnp.asarray(table),
                                           jnp.asarray(pos))
    pools = [np.asarray(a) for a in (kp.data, kp.scale, vp.data, vp.scale)]
    lengths = np.where(hist > 0, hist + 1, 0).astype(np.int32)
    k_new = rng.normal(size=(B, KV, d)).astype(np.float32)
    v_new = rng.normal(size=(B, KV, d)).astype(np.float32)
    q = rng.normal(size=(B, n_q, d)).astype(np.float32)
    kw = dict(scale=d ** -0.5, sliding_window=window, attn_softcap=softcap)

    want, kd2, ks2, vd2, vs2 = pallas_paged_attention_write_int8(
        *(jnp.asarray(a) for a in (q, *pools, table, lengths, k_new, v_new)),
        interpret=True, **kw)
    tpools = _t(*pools)
    out = pa.paged_decode_attention_write_int8(
        _t(q)[0], *tpools, *_t(table, lengths, k_new, v_new), **kw)
    act = lengths > 0
    np.testing.assert_allclose(out.numpy()[act], np.asarray(want)[act], rtol=2e-5, atol=2e-5)
    assert np.isfinite(out.numpy()).all()
    for got, ref in ((tpools[0], kd2), (tpools[2], vd2)):
        diff = got.numpy()[:, 1:].astype(np.int32) - np.asarray(ref)[:, 1:].astype(np.int32)
        assert np.abs(diff).max() <= 1
    for got, ref in ((tpools[1], ks2), (tpools[3], vs2)):
        np.testing.assert_allclose(got.numpy()[:, 1:], np.asarray(ref)[:, 1:],
                                   rtol=SCALE_RTOL, atol=0)


def test_int8_write_plain_equals_eager_jax_write_then_attend(rng):
    """Kernel 5's plain version is int8 write_tokens then kernel 4's: the
    pools equal the JAX eager write_tokens' bytes outside page 0, and the
    output JAX paged_attention's over them at 1e-5."""
    KV, d, page, pps = 2, 16, 4, 5
    hist = np.asarray([6, 0, 19, 8], np.int32)
    B = len(hist)
    P = B * pps + 1
    (kd, ks), (vd, vs) = _int8_pools(rng, KV, P, page, d)
    table = np.zeros((B, pps), np.int32)
    for b in range(B):
        table[b] = 1 + b * pps + np.arange(pps)
    lengths = np.where(hist > 0, hist + 1, 0).astype(np.int32)
    k_new, v_new = _mixed(rng, B, KV, d), _mixed(rng, B, KV, d)
    q = rng.normal(size=(B, 4 * KV, d)).astype(np.float32)
    wp = np.where(lengths > 0, lengths - 1, -1)[:, None].astype(np.int32)
    jk, jv = jcache.write_tokens(jcache.KVPool(jnp.asarray(kd), jnp.asarray(ks)),
                                 jcache.KVPool(jnp.asarray(vd), jnp.asarray(vs)),
                                 jnp.asarray(k_new)[:, None], jnp.asarray(v_new)[:, None],
                                 jnp.asarray(table), jnp.asarray(wp))
    ref = j_paged_attention(jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(lengths),
                            scale=0.25)
    tpools = _t(kd, ks, vd, vs)
    out = pa.paged_decode_attention_write_int8(_t(q)[0], *tpools,
                                               *_t(table, lengths, k_new, v_new), scale=0.25)
    act = lengths > 0
    np.testing.assert_allclose(out.numpy()[act], np.asarray(ref)[act], rtol=1e-5, atol=1e-5)
    for got, j in zip(tpools, (jk.data, jk.scale, jv.data, jv.scale)):
        np.testing.assert_array_equal(got.numpy()[:, 1:], np.asarray(j)[:, 1:])


def test_dispatchers_route_quantized_pools(rng, monkeypatch):
    """A quantized KVPool reaches the int8 wrappers (with its scales), a
    float pool the float ones."""
    from llms_on_kubernetes_tpu_torch.ops import attention as attn

    seen = []
    for name in ("paged_decode_attention", "paged_decode_attention_int8",
                 "paged_decode_attention_write", "paged_decode_attention_write_int8"):
        real = getattr(pa, name)
        monkeypatch.setattr(pa, name, lambda *a, _n=name, _r=real, **k: (seen.append(_n),
                                                                         _r(*a, **k))[1])
    (kd, ks), (vd, vs) = _int8_pools(rng, 2, 5, 4, 8)
    pools = {"int8": (tcache.KVPool(*_t(kd, ks)), tcache.KVPool(*_t(vd, vs))),
             "float": (tcache.KVPool(torch.zeros(2, 5, 4, 8)),
                       tcache.KVPool(torch.zeros(2, 5, 4, 8)))}
    q = torch.zeros(1, 2, 8)
    table = torch.tensor([[1, 2]], dtype=torch.int32)
    lengths = torch.tensor([6], dtype=torch.int32)
    kn = torch.ones(1, 2, 8)
    for kind, (kp, vp) in pools.items():
        attn.dispatch_paged_attention(q, kp, vp, table, lengths, scale=0.1)
        for mode in ("dus", "fused"):
            attn.dispatch_paged_attention_write(q, kp, vp, table, lengths, kn, kn,
                                                torch.tensor([[5]], dtype=torch.int32),
                                                scale=0.1, kv_write=mode)
    assert seen == ["paged_decode_attention_int8", "paged_decode_attention_int8",
                    "paged_decode_attention_write_int8",
                    "paged_decode_attention", "paged_decode_attention",
                    "paged_decode_attention_write"]


# ---------------------------------------------------------------------------
# the model and the engine
# ---------------------------------------------------------------------------

def test_int8_prefill_then_decode_matches_jax(rng):
    """debug-tiny f32, int8 KV: JAX forward_prefill/forward_decode run
    eagerly (so both sides quantize with IEEE division); logits within
    1e-4 on active rows, and the pools' int8 data within one of JAX's
    (the projections' f32 summation order can move a value across a
    rounding boundary)."""
    num_pages = 24
    jcfg = jget_config("debug-tiny")
    jp = jdec.init_params(jcfg, jax.random.key(0), dtype="float32")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    tcfg = get_config("debug-tiny")
    kw = dict(num_layers=jcfg.num_layers, num_kv_heads=jcfg.num_kv_heads,
              head_dim=jcfg.head_dim, num_pages=num_pages, page_size=4, pages_per_slot=6,
              dtype="float32", kv_dtype="int8")
    jk, jv = jcache.init_pages(jcache.CacheConfig(**kw))
    tk, tv = tcache.init_pages(tcache.CacheConfig(**kw), device="cpu")
    B, T = 3, 16
    lengths = np.asarray([11, 16, 5], np.int32)
    tokens = rng.integers(0, jcfg.vocab_size, size=(B, T)).astype(np.int32)
    table = np.zeros((B, 6), np.int32)
    table[:, :5] = np.arange(1, 16).reshape(3, 5)
    jlog, jk, jv = jdec.forward_prefill(jp, jcfg, jnp.asarray(tokens), jnp.asarray(lengths),
                                        jk, jv, jnp.asarray(table))
    tlog, _, _ = tdec.forward_prefill(tp, tcfg, *_t(tokens, lengths), tk, tv, _t(table)[0])
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
    lens = lengths.copy()
    for step in range(3):
        lens = lens + 1
        if step == 2:
            lens[1] = 0                      # an idle slot rides along
        toks = rng.integers(0, jcfg.vocab_size, size=(B,)).astype(np.int32)
        jlog, jk, jv = jdec.forward_decode(jp, jcfg, jnp.asarray(toks), jnp.asarray(lens),
                                           jk, jv, jnp.asarray(table))
        tlog, _, _ = tdec.forward_decode(tp, tcfg, *_t(toks, lens), tk, tv, _t(table)[0])
        act = lens > 0
        np.testing.assert_allclose(tlog.numpy()[act], np.asarray(jlog)[act], **LOGIT_TOL)
    keep = np.ones(jcfg.num_layers * num_pages, bool)
    keep[::num_pages] = False
    for t, j in ((tk, jk), (tv, jv)):
        diff = t.data.numpy()[:, keep].astype(np.int32) - np.asarray(j.data)[:, keep]
        assert np.abs(diff).max() <= 1
        np.testing.assert_allclose(t.scale.numpy()[:, keep], np.asarray(j.scale)[:, keep],
                                   rtol=1e-5, atol=0)


def test_int8_decode_kv_write_fused_equals_dus(rng):
    """From copies of one int8 pool, one decode step with kv_write fused
    and dus gives identical logits and pools (the CPU runs both plain
    versions; the card holds the kernels to the same identity)."""
    cfg = get_config("debug-tiny")
    tp = tdec.init_params(cfg, seed=0, dtype="float32", device="cpu")
    cc = tcache.CacheConfig(cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, num_pages=24,
                            page_size=4, pages_per_slot=6, dtype="float32", kv_dtype="int8")
    tk, tv = tcache.init_pages(cc, device="cpu")
    table = torch.tensor([[1, 2, 3, 0, 0, 0], [4, 5, 6, 0, 0, 0]], dtype=torch.int32)
    tokens = torch.from_numpy(rng.integers(0, 256, size=(2, 8)).astype(np.int32))
    tdec.forward_prefill(tp, cfg, tokens, torch.tensor([8, 6], dtype=torch.int32), tk, tv,
                         table)
    outs = {}
    for mode in ("dus", "fused"):
        k = tcache.KVPool(tk.data.clone(), tk.scale.clone())
        v = tcache.KVPool(tv.data.clone(), tv.scale.clone())
        logits, _, _ = tdec.forward_decode(tp, cfg, torch.tensor([3, 9], dtype=torch.int32),
                                           torch.tensor([9, 7], dtype=torch.int32), k, v,
                                           table, kv_write=mode)
        outs[mode] = (logits, k.data, k.scale, v.data, v.scale)
    for a, b in zip(outs["dus"], outs["fused"]):
        assert torch.equal(a, b)


ENGINE = dict(model="debug-tiny", dtype="float32", max_decode_slots=2, page_size=8,
              num_pages=32, pages_per_slot=8, prefill_buckets=(16,))


@pytest.fixture(scope="module")
def jparams():
    return jdec.init_params(jget_config("debug-tiny"), jax.random.key(0), dtype="float32")


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _port_stream(tparams, prompt, **kw):
    from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams

    eng = Engine(EngineConfig(**{**ENGINE, "device": "cpu", **kw}), params=tparams)
    return eng.generate(prompt, SamplingParams(temperature=0.0, max_tokens=8))


@pytest.fixture(scope="module")
def jax_int8_stream(jparams):
    """tests/test_kv_int8.py:302-320: the JAX engine, int8 KV, greedy."""
    from llms_on_kubernetes_tpu.engine.engine import Engine, EngineConfig, SamplingParams

    eng = Engine(EngineConfig(**ENGINE, kv_cache_dtype="int8"), params=jparams)
    return eng.generate([1, 2, 3, 4], SamplingParams(temperature=0.0, max_tokens=8))


@pytest.mark.parametrize("decode_steps", [1, 4])
@pytest.mark.parametrize("kv_write", ["dus", "fused"])
def test_int8_engine_greedy_stream_equals_jax(tparams, jax_int8_stream, decode_steps,
                                              kv_write):
    out = _port_stream(tparams, [1, 2, 3, 4], kv_cache_dtype="int8",
                       decode_steps=decode_steps, kv_write=kv_write)
    assert len(out) == 8
    assert out == jax_int8_stream


def test_int8_engine_stays_close_to_full_width_kv(tparams):
    """As the JAX test: the int8 KV stream differs from the float KV one in
    at most 2 of 8 greedy tokens (tiny random model, wide logit gaps)."""
    a = _port_stream(tparams, [1, 2, 3, 4], kv_cache_dtype="int8")
    ref = _port_stream(tparams, [1, 2, 3, 4])
    assert sum(x == y for x, y in zip(a, ref)) >= len(ref) - 2, (a, ref)


def test_kv_cache_dtype_config_env_and_cli(monkeypatch):
    from llms_on_kubernetes_tpu_torch import cli
    from llms_on_kubernetes_tpu_torch.engine.engine import EngineConfig

    monkeypatch.delenv("LLMK_KV_DTYPE", raising=False)
    assert EngineConfig().kv_cache_dtype is None
    assert EngineConfig(kv_cache_dtype="int8").kv_cache_dtype == "int8"
    for off in ("off", "none", ""):
        assert EngineConfig(kv_cache_dtype=off).kv_cache_dtype is None
    monkeypatch.setenv("LLMK_KV_DTYPE", "int8")
    assert EngineConfig().kv_cache_dtype == "int8"
    assert EngineConfig(kv_cache_dtype="off").kv_cache_dtype is None
    monkeypatch.setenv("LLMK_KV_DTYPE", "none")
    assert EngineConfig().kv_cache_dtype is None
    for bad in ("fp8", "int4", "INT8"):
        with pytest.raises(ValueError, match="kv_cache_dtype"):
            EngineConfig(kv_cache_dtype=bad)
    monkeypatch.setenv("LLMK_KV_DTYPE", "fp4")
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        EngineConfig()
    monkeypatch.delenv("LLMK_KV_DTYPE")
    args = cli.build_parser().parse_args(["serve", "--model", "debug-tiny",
                                          "--kv-cache-dtype", "int8", "--kv-write", "fused"])
    assert (args.kv_cache_dtype, args.kv_write) == ("int8", "fused")
    assert cli.build_parser().parse_args(["serve", "--model", "x"]).kv_cache_dtype is None
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["serve", "--model", "x", "--kv-cache-dtype", "fp8"])


def test_int8_engine_allocates_the_quantized_pool(tparams):
    from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig

    eng = Engine(EngineConfig(**ENGINE, device="cpu", kv_cache_dtype="int8"), params=tparams)
    assert eng.cache_config.kv_dtype == "int8"
    assert eng.k_pages.quantized and eng.k_pages.data.dtype == torch.int8
    assert tuple(eng.v_pages.scale.shape) == tuple(eng.v_pages.shape[:3])
