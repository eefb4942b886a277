"""The port's ops against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and fed to both sides. The kernel
modules' plain versions (what a CPU tensor takes) are held against the
Pallas kernels run as tests/test_pallas.py runs them (interpret mode), on
the same cases, including the pool bytes after the fused append.
Tolerance: float32, atol = rtol = 2e-5 (only the summation order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llms_on_kubernetes_tpu.engine.cache import KVPool as JKVPool
from llms_on_kubernetes_tpu.engine.cache import write_tokens as j_write_tokens
from llms_on_kubernetes_tpu.ops import attention as jatt
from llms_on_kubernetes_tpu.ops import norms as jnorms
from llms_on_kubernetes_tpu.ops import rope as jrope
from llms_on_kubernetes_tpu.ops.pallas_flash import flash_prefill_attention as j_flash
from llms_on_kubernetes_tpu.ops.pallas_paged import (
    pallas_paged_attention as j_paged,
    pallas_paged_attention_write as j_paged_write,
)
from llms_on_kubernetes_tpu_torch import kernels
from llms_on_kubernetes_tpu_torch.ops import attention as tatt
from llms_on_kubernetes_tpu_torch.ops import flash_attention as tflash
from llms_on_kubernetes_tpu_torch.ops import norms as tnorms
from llms_on_kubernetes_tpu_torch.ops import paged_attention as tpaged
from llms_on_kubernetes_tpu_torch.ops import rope as trope

TOL = dict(rtol=2e-5, atol=2e-5)


def T(a):
    return torch.from_numpy(np.array(a))


def close(port, ref, **kw):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **(kw or TOL))


@pytest.mark.parametrize("style", ["llama", "gemma"])
def test_rms_norm_matches_jax(rng, style):
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    close(tnorms.rms_norm(T(x), T(w), 1e-6, style=style),
          jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6, style=style))


@pytest.mark.parametrize("scaling", [
    None,
    {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
     "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
    {"rope_type": "linear", "factor": 4.0},
])
def test_rope_frequencies_match_jax(scaling):
    np.testing.assert_array_equal(trope.rope_frequencies(128, 500000.0, scaling),
                                  jrope.rope_frequencies(128, 500000.0, scaling))


def test_rope_frequencies_reject_unknown_scaling():
    with pytest.raises(NotImplementedError):
        trope.rope_frequencies(64, 1e4, {"rope_type": "yarn"})


def test_apply_rope_matches_jax(rng):
    q = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 7, 2, 16)).astype(np.float32)
    pos = rng.integers(0, 3000, size=(2, 7)).astype(np.int32)
    inv = jrope.rope_frequencies(16, 10000.0)
    tq, tk = trope.apply_rope(T(q), T(k), T(pos), T(inv))
    jq, jk = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos), jnp.asarray(inv))
    close(tq, jq)
    close(tk, jk)


def _qkv(rng, B, Tn, n_q, n_kv, d):
    return (rng.normal(size=(B, Tn, n_q, d)).astype(np.float32),
            rng.normal(size=(B, Tn, n_kv, d)).astype(np.float32),
            rng.normal(size=(B, Tn, n_kv, d)).astype(np.float32))


def _paged_setup(rng, B, n_kv, d, page, pps, lengths):
    """tests/test_pallas.py's _paged_setup, in numpy."""
    P = B * pps + 1
    k_pages = rng.normal(size=(n_kv, P, page, d)).astype(np.float32)
    v_pages = rng.normal(size=(n_kv, P, page, d)).astype(np.float32)
    table = np.zeros((B, pps), np.int32)
    perm = rng.permutation(P - 1) + 1
    for b in range(B):
        used = -(-lengths[b] // page)
        table[b, :used] = perm[b * pps:b * pps + used]
    return k_pages, v_pages, table


@pytest.mark.parametrize("window,softcap", [(None, None), (5, None), (None, 30.0)])
def test_prefill_attention_plain_matches_jax(rng, window, softcap):
    q, k, v = _qkv(rng, 2, 16, 4, 2, 8)
    lengths = np.asarray([16, 9], np.int32)
    kw = dict(scale=8 ** -0.5, sliding_window=window, attn_softcap=softcap)
    ref = jatt.prefill_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(lengths), **kw)
    close(tatt.prefill_attention(T(q), T(k), T(v), T(lengths), **kw), ref)


@pytest.mark.parametrize("window,softcap", [(None, None), (5, None), (None, 30.0)])
def test_flash_plain_matches_pallas_interpret(rng, window, softcap):
    """test_pallas.py:27, the port's plain flash version against the Pallas
    kernel in interpret mode."""
    q, k, v = _qkv(rng, 2, 16, 4, 2, 8)
    lengths = np.asarray([16, 9], np.int32)
    kw = dict(scale=8 ** -0.5, sliding_window=window, attn_softcap=softcap)
    ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
                  interpret=True, **kw)
    close(tflash.flash_prefill_attention(T(q), T(k), T(v), T(lengths), **kw), ref)


def test_flash_plain_multiblock_matches_pallas_interpret(rng):
    """test_pallas.py:44: T over several 128-row query blocks, uneven
    lengths; padding rows are don't-care."""
    q, k, v = _qkv(rng, 2, 256, 2, 1, 16)
    lengths = np.asarray([256, 130], np.int32)
    ref = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(lengths), scale=16 ** -0.5, interpret=True))
    out = tflash.flash_prefill_attention(T(q), T(k), T(v), T(lengths),
                                         scale=16 ** -0.5).numpy()
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(out[b, :n], ref[b, :n], **TOL)


@pytest.mark.parametrize("window,softcap", [(None, None), (7, None), (None, 50.0)])
def test_paged_plain_matches_reference_and_pallas(rng, window, softcap):
    """test_pallas.py:72: plain paged attention against the JAX reference
    and against the Pallas decode kernel in interpret mode."""
    lengths = np.asarray([13, 16, 5], np.int32)
    kp, vp, table = _paged_setup(rng, 3, 2, 8, 4, 4, lengths)
    q = rng.normal(size=(3, 4, 8)).astype(np.float32)
    kw = dict(scale=8 ** -0.5, sliding_window=window, attn_softcap=softcap)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, table, lengths)]
    out = tpaged.paged_decode_attention(*(T(a) for a in (q, kp, vp, table, lengths)), **kw)
    close(out, jatt.paged_attention(*jargs, **kw))
    close(out, j_paged(*jargs, interpret=True, **kw))
    close(tatt.dispatch_paged_attention(*(T(a) for a in (q, kp, vp, table, lengths)), **kw),
          jatt.paged_attention(*jargs, **kw))


@pytest.mark.parametrize("window,softcap", [(None, None), (37, None), (None, 50.0)])
@pytest.mark.parametrize("d,n_q,n_kv", [(96, 4, 4), (256, 4, 2)])
def test_prefill_plain_wide_head_dims_match_jax_dispatch(rng, d, n_q, n_kv, window, softcap):
    """head_dim 96 (phi-3: one query head a KV head) and 256 (gemma-2): the
    port's prefill dispatcher against the JAX one (which takes the Pallas
    kernel in interpret mode at 256 and its XLA path at 96)."""
    q, k, v = _qkv(rng, 2, 128, n_q, n_kv, d)
    lengths = np.asarray([128, 77], np.int32)
    kw = dict(scale=d ** -0.5, sliding_window=window, attn_softcap=softcap)
    want = np.asarray(jatt.dispatch_prefill_attention(
        *(jnp.asarray(a) for a in (q, k, v, lengths)), **kw))
    got = tatt.dispatch_prefill_attention(*(T(a) for a in (q, k, v, lengths)), **kw).numpy()
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(got[b, :n], want[b, :n], **TOL)


@pytest.mark.parametrize("int8", [False, True], ids=["float_pool", "int8_pool"])
@pytest.mark.parametrize("window,softcap", [(None, None), (30, None), (None, 50.0)])
@pytest.mark.parametrize("d,n_q,n_kv", [(96, 4, 4), (256, 4, 2)])
def test_paged_plain_wide_head_dims_match_jax_dispatch(rng, d, n_q, n_kv, window, softcap,
                                                       int8):
    """The port's decode dispatcher against the JAX one at head_dim 96 and
    256, page 24, float and int8 pools (data and scales given to both)."""
    from llms_on_kubernetes_tpu_torch.engine.cache import KVPool, quantize_kv

    lengths = np.asarray([100, 37, 0, 1], np.int32)
    kp, vp, table = _paged_setup(rng, 4, n_kv, d, 24, 6, lengths)
    q = rng.normal(size=(4, n_q, d)).astype(np.float32)
    if int8:
        (kq, ks), (vq, vs) = quantize_kv(T(kp)), quantize_kv(T(vp))
        tk, tv = KVPool(kq, ks), KVPool(vq, vs)
        jk = JKVPool(jnp.asarray(kq.numpy()), jnp.asarray(ks.numpy()))
        jv = JKVPool(jnp.asarray(vq.numpy()), jnp.asarray(vs.numpy()))
    else:
        tk, tv, jk, jv = T(kp), T(vp), JKVPool(jnp.asarray(kp)), JKVPool(jnp.asarray(vp))
    kw = dict(scale=d ** -0.5, sliding_window=window, attn_softcap=softcap)
    want = np.asarray(jatt.dispatch_paged_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(lengths), **kw))
    got = tatt.dispatch_paged_attention(T(q), tk, tv, T(table), T(lengths), **kw).numpy()
    act = lengths > 0
    np.testing.assert_allclose(got[act], want[act], **TOL)


def test_paged_plain_idle_slot_is_finite(rng):
    """test_pallas.py:89: a length-0 (idle) slot must not NaN."""
    lengths = np.asarray([6, 0], np.int32)
    kp, vp, table = _paged_setup(rng, 2, 1, 8, 4, 2, lengths)
    q = rng.normal(size=(2, 2, 8)).astype(np.float32)
    out = tpaged.paged_decode_attention(T(q), T(kp), T(vp), T(table), T(lengths),
                                        scale=8 ** -0.5)
    assert torch.isfinite(out).all()
    ref = j_paged(*(jnp.asarray(a) for a in (q, kp, vp, table, lengths)),
                  scale=8 ** -0.5, interpret=True)
    close(out[:1], np.asarray(ref)[:1])


def _fused_case(rng, lengths, *, n_kv, group, d, page, pps, window=None, softcap=None):
    """test_pallas.py's run_fused_write_case against the port's plain fused
    version: the same attention rows for active slots, finite rows
    everywhere, and the same pool bytes outside the trash page 0."""
    lengths = np.asarray(lengths, np.int32)
    B = len(lengths)
    kp, vp, table = _paged_setup(rng, B, n_kv, d, page, pps, lengths)
    q = rng.normal(size=(B, n_kv * group, d)).astype(np.float32)
    k_new = rng.normal(size=(B, n_kv, d)).astype(np.float32)
    v_new = rng.normal(size=(B, n_kv, d)).astype(np.float32)
    kw = dict(scale=d ** -0.5, sliding_window=window, attn_softcap=softcap)
    ref, jk, jv = j_paged_write(*(jnp.asarray(a) for a in (q, kp, vp, table, lengths,
                                                          k_new, v_new)),
                                interpret=True, **kw)
    tk, tv = T(kp), T(vp)
    out = tpaged.paged_decode_attention_write(T(q), tk, tv, T(table), T(lengths),
                                              T(k_new), T(v_new), **kw)
    act = lengths > 0
    np.testing.assert_allclose(out.numpy()[act], np.asarray(ref)[act], **TOL)
    assert torch.isfinite(out).all()
    np.testing.assert_array_equal(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:])
    np.testing.assert_array_equal(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:])
    # the dus path (write_tokens + paged attention) leaves the same bytes
    wp = np.where(lengths > 0, lengths - 1, -1)[:, None].astype(np.int32)
    jk2, jv2 = j_write_tokens(JKVPool(jnp.asarray(kp)), JKVPool(jnp.asarray(vp)),
                              jnp.asarray(k_new)[:, None], jnp.asarray(v_new)[:, None],
                              jnp.asarray(table), jnp.asarray(wp))
    np.testing.assert_array_equal(tk.numpy()[:, 1:], np.asarray(jk2.data)[:, 1:])
    np.testing.assert_array_equal(tv.numpy()[:, 1:], np.asarray(jv2.data)[:, 1:])


def test_fused_write_page_boundary(rng):
    """test_pallas.py:196: writes on the last row of a page and the first
    row of a fresh page."""
    page = 8
    _fused_case(rng, [page, page + 1, 3 * page, 3 * page + 1],
                n_kv=2, group=2, d=8, page=page, pps=4)


@pytest.mark.parametrize("lengths", [[0, 0, 0], [0, 5, 0, 8, 1]])
def test_fused_write_idle_rows(rng, lengths):
    """test_pallas.py:206: idle rows write nothing and stay finite."""
    _fused_case(rng, lengths, n_kv=1 if len(lengths) == 3 else 2, group=2, d=8,
                page=8, pps=2)


@pytest.mark.parametrize("window,softcap", [(None, None), (9, None), (None, 40.0)])
def test_fused_write_matches_pallas(rng, window, softcap):
    """test_pallas.py:218: mid-page, page-boundary, length-1 and idle rows."""
    _fused_case(rng, [13, 16, 1, 0, 32], n_kv=2, group=2, d=8, page=8, pps=4,
                window=window, softcap=softcap)


def test_dispatch_dus_and_fused_agree_on_cpu(rng):
    lengths = np.asarray([13, 16, 1, 0, 32], np.int32)
    kp, vp, table = _paged_setup(rng, 5, 2, 8, 8, 4, lengths)
    q = rng.normal(size=(5, 4, 8)).astype(np.float32)
    k_new = rng.normal(size=(5, 2, 8)).astype(np.float32)
    v_new = rng.normal(size=(5, 2, 8)).astype(np.float32)
    wp = T(np.where(lengths > 0, lengths - 1, -1)[:, None].astype(np.int32))
    outs = {}
    for mode in ("dus", "fused"):
        k, v = T(kp), T(vp)
        out, _, _ = tatt.dispatch_paged_attention_write(
            T(q), k, v, T(table), T(lengths), T(k_new), T(v_new), wp,
            scale=8 ** -0.5, kv_write=mode)
        outs[mode] = (out, k, v)
    for a, b in zip(outs["dus"], outs["fused"]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="kv_write"):
        tatt.dispatch_paged_attention_write(
            T(q), T(kp), T(vp), T(table), T(lengths), T(k_new), T(v_new), wp,
            scale=8 ** -0.5, kv_write="scatter")


def test_wrappers_take_plain_versions_for_cpu_tensors(rng):
    """A CPU tensor runs the plain version and launches (counts) nothing."""
    before = kernels.launch_counts()
    q, k, v = _qkv(rng, 1, 8, 2, 1, 16)
    out = tflash.flash_prefill_attention(T(q), T(k), T(v), T(np.asarray([8], np.int32)),
                                         scale=0.25)
    ref = tflash.prefill_attention_plain(T(q), T(k), T(v), T(np.asarray([8], np.int32)),
                                         scale=0.25)
    assert torch.equal(out, ref)
    assert kernels.launch_counts() == before


def test_softcap_is_identity_without_cap():
    x = torch.randn(4, generator=torch.Generator().manual_seed(0))
    assert torch.equal(tatt.softcap(x, None), x)
    np.testing.assert_allclose(tatt.softcap(x, 2.0).numpy(),
                               np.asarray(jatt.softcap(jnp.asarray(x.numpy()), 2.0)), **TOL)


@pytest.mark.parametrize("B,n_q,n_kv,n_split,d", [(8, 32, 8, 8, 128), (3, 4, 2, 1, 8),
                                                  (1, 8, 1, 16, 64)])
def test_decode_workspace_sizes(B, n_q, n_kv, n_split, d):
    """One launch needs each split's max, sum and d accumulators per query
    row, and one arrival counter per (slot, KV head)."""
    n_part, n_count = tpaged.workspace_sizes(B, n_q, n_kv, n_split, d)
    assert n_part == B * n_q * n_split * (d + 2)
    assert n_count == B * n_kv


def test_decode_workspace_grows_and_is_reused():
    """The workspace grows to the largest launch seen and never shrinks; a
    smaller launch reuses the same storage, and new counters start at 0
    (the kernel leaves them 0, so no call clears them)."""
    ws = tpaged.DecodeWorkspace()
    dev = torch.device("cpu")
    part, counters = ws.get(dev, 2, 8, 2, 4, 64)
    assert part.dtype == torch.float32 and counters.dtype == torch.int32
    assert part.numel() == 2 * 8 * 4 * 66 and counters.numel() == 4
    assert not counters.any()
    big_part, big_counters = ws.get(dev, 8, 32, 8, 8, 128)
    assert big_part.numel() == 8 * 32 * 8 * 130 and big_counters.numel() == 64
    assert not big_counters.any()
    again = ws.get(dev, 2, 8, 2, 4, 64)
    assert again[0].data_ptr() == big_part.data_ptr()
    assert again[1].data_ptr() == big_counters.data_ptr()
    # more counters but fewer partials: only the counters grow
    part3, counters3 = ws.get(dev, 16, 16, 16, 1, 8)
    assert part3.data_ptr() == big_part.data_ptr() and counters3.numel() == 256
    assert not counters3.any()
