"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and nvcc; without them they skip (the
decision is made inside each test, never at import time). On a machine
with a card and no JAX, run them without the repository's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: float32, atol = rtol = 1e-4 (summation order); bfloat16,
each row's (one query head's d values) max |err| <= 2e-2 * that row's own
max |plain| (rounding points), so a long-context row with small values is
held to its own scale. The float32 cases at lengths past one 256-key split
hold the decode kernel's split merge at 1e-4. Pool bytes after the fused
append are compared exactly, for int8 pools data and scale both: the
kernel's quantization must store engine/cache.quantize_kv's bytes.
"""

import numpy as np
import pytest
import torch

from llms_on_kubernetes_tpu_torch import kernels
from llms_on_kubernetes_tpu_torch.engine.cache import quantize_kv
from llms_on_kubernetes_tpu_torch.ops import flash_attention as fa
from llms_on_kubernetes_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return np.random.default_rng(0)


def _t(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to("cuda", dtype)


def _close(out, ref, dtype):
    o, r = out.float().cpu(), ref.float().cpu()
    assert torch.isfinite(out.float()).all()
    if dtype == torch.float32:
        np.testing.assert_allclose(o.numpy(), r.numpy(), rtol=1e-4, atol=1e-4)
    else:
        n = o.shape[-1]
        row_err = (o - r).abs().reshape(-1, n).amax(dim=1)
        row_max = r.abs().reshape(-1, n).amax(dim=1)
        assert bool((row_err <= 2e-2 * row_max).all())


def _paged(rng, B, n_kv, d, page, pps, lengths, dtype, pool_pages=None):
    P = pool_pages or B * pps + 1
    kp, vp = _t(rng, n_kv, P, page, d, dtype=dtype), _t(rng, n_kv, P, page, d, dtype=dtype)
    table = np.zeros((B, pps), np.int32)
    perm = rng.permutation(P - 1) + 1
    for b, n in enumerate(lengths):
        used = -(-int(n) // page)
        table[b, :used] = perm[b * pps:b * pps + used]
    return kp, vp, torch.from_numpy(table).cuda()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,softcap", [(None, None), (5, None), (None, 30.0)])
@pytest.mark.parametrize("d", [8, 16, 64, 128])
def test_flash_prefill_matches_plain(cuda, dtype, window, softcap, d):
    q, k, v = _t(cuda, 2, 80, 8, d, dtype=dtype), _t(cuda, 2, 80, 2, d, dtype=dtype), \
        _t(cuda, 2, 80, 2, d, dtype=dtype)
    lengths = torch.tensor([80, 37], dtype=torch.int32, device="cuda")
    kw = dict(scale=d ** -0.5, sliding_window=window, attn_softcap=softcap)
    before = kernels.LAUNCHES["flash_prefill"]
    out = fa.flash_prefill_attention(q, k, v, lengths, **kw)
    ref = fa.prefill_attention_plain(q, k, v, lengths, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_prefill"] == before + 1
    _close(out[0], ref[0], dtype)
    _close(out[1, :37], ref[1, :37], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,softcap", [(None, None), (7, None), (None, 50.0)])
@pytest.mark.parametrize("group", [1, 4, 7])
def test_paged_decode_matches_plain(cuda, dtype, window, softcap, group):
    lengths = np.asarray([13, 64, 1, 0, 130])
    kp, vp, table = _paged(cuda, 5, 2, 64, 16, 9, lengths, dtype)
    q = _t(cuda, 5, 2 * group, 64, dtype=dtype)
    lens = torch.from_numpy(lengths.astype(np.int32)).cuda()
    kw = dict(scale=0.125, sliding_window=window, attn_softcap=softcap)
    out = pa.paged_decode_attention(q, kp, vp, table, lens, **kw)
    ref = pa.paged_decode_attention_plain(q, kp, vp, table, lens, **kw)
    act = torch.from_numpy(lengths > 0).cuda()
    _close(out[act], ref[act], dtype)
    assert float(out[3].abs().max()) == 0.0            # idle slot: zeros


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lengths", [[8, 9, 24, 25], [0, 5, 0, 8, 1], [13, 16, 1, 0, 32]])
def test_paged_decode_write_matches_plain(cuda, dtype, lengths):
    lengths = np.asarray(lengths)
    B = len(lengths)
    kp, vp, table = _paged(cuda, B, 2, 128, 8, 4, lengths, dtype)
    q, kn, vn = _t(cuda, B, 8, 128, dtype=dtype), _t(cuda, B, 2, 128, dtype=dtype), \
        _t(cuda, B, 2, 128, dtype=dtype)
    lens = torch.from_numpy(lengths.astype(np.int32)).cuda()
    kr, vr = kp.clone(), vp.clone()
    ref = pa.paged_decode_attention_write_plain(q, kr, vr, table, lens, kn, vn, scale=0.1)
    before = kernels.LAUNCHES["paged_decode_write"]
    out = pa.paged_decode_attention_write(q, kp, vp, table, lens, kn, vn, scale=0.1)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["paged_decode_write"] == before + 1
    act = torch.from_numpy(lengths > 0).cuda()
    _close(out[act], ref[act], dtype)
    assert torch.equal(kp[:, 1:], kr[:, 1:]) and torch.equal(vp[:, 1:], vr[:, 1:])
    # bit-identical to write_tokens followed by the unfused kernel
    assert torch.equal(out[act], pa.paged_decode_attention(q, kr, vr, table, lens,
                                                           scale=0.1)[act])


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("window,softcap", [(None, None), (500, None), (None, 30.0)])
def test_paged_decode_multi_split_f32(cuda, fused, window, softcap):
    """llama-3-8b widths, page 64, 32 pages a slot (8 splits of 256 keys):
    lengths 300, 700 and 2048 give the merge real partials in float32."""
    lengths = np.asarray([300, 700, 2048, 0])
    kp, vp, table = _paged(cuda, 4, 8, 128, 64, 32, lengths, torch.float32)
    q, kn, vn = _t(cuda, 4, 32, 128), _t(cuda, 4, 8, 128), _t(cuda, 4, 8, 128)
    lens = torch.from_numpy(lengths.astype(np.int32)).cuda()
    kw = dict(scale=128 ** -0.5, sliding_window=window, attn_softcap=softcap)
    act = torch.from_numpy(lengths > 0).cuda()
    if fused:
        kr, vr = kp.clone(), vp.clone()
        ref = pa.paged_decode_attention_write_plain(q, kr, vr, table, lens, kn, vn, **kw)
        out = pa.paged_decode_attention_write(q, kp, vp, table, lens, kn, vn, **kw)
        assert torch.equal(kp[:, 1:], kr[:, 1:]) and torch.equal(vp[:, 1:], vr[:, 1:])
    else:
        ref = pa.paged_decode_attention_plain(q, kp, vp, table, lens, **kw)
        out = pa.paged_decode_attention(q, kp, vp, table, lens, **kw)
    _close(out[act], ref[act], torch.float32)


def _paged_int8(rng, B, n_kv, d, page, pps, lengths):
    """int8 pools holding quantize_kv's bytes of random K/V, and a table."""
    P = B * pps + 1
    kd, ks = quantize_kv(torch.from_numpy(rng.normal(size=(n_kv, P, page, d)).astype(np.float32)))
    vd, vs = quantize_kv(torch.from_numpy(rng.normal(size=(n_kv, P, page, d)).astype(np.float32)))
    _, _, table = _paged(rng, B, 1, 8, page, pps, lengths, torch.float32)
    return [t.cuda() for t in (kd, ks, vd, vs)], table


def test_quantize_kv_on_the_card_equals_the_cpu(cuda):
    """quantize_kv's bytes do not depend on the device: PyTorch's CUDA
    division by a Python scalar would multiply by its reciprocal and move
    a scale by one ulp, so the divisor is a tensor."""
    x = cuda.normal(size=(64, 33, 8, 128)) * 10.0 ** cuda.uniform(-6, 3, size=(64, 33, 8, 1))
    x = torch.from_numpy(x.astype(np.float32))
    cd, cs = quantize_kv(x)
    gd, gs = quantize_kv(x.cuda())
    assert torch.equal(gd.cpu(), cd) and torch.equal(gs.cpu(), cs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,softcap", [(None, None), (7, None), (None, 50.0)])
@pytest.mark.parametrize("group", [1, 4, 7])
def test_paged_decode_int8_matches_plain(cuda, dtype, window, softcap, group):
    lengths = np.asarray([13, 64, 1, 0, 130])
    pools, table = _paged_int8(cuda, 5, 2, 64, 16, 9, lengths)
    q = _t(cuda, 5, 2 * group, 64, dtype=dtype)
    lens = torch.from_numpy(lengths.astype(np.int32)).cuda()
    kw = dict(scale=0.125, sliding_window=window, attn_softcap=softcap)
    before = kernels.LAUNCHES["paged_decode_int8"]
    out = pa.paged_decode_attention_int8(q, *pools, table, lens, **kw)
    ref = pa.paged_decode_attention_int8_plain(q, *pools, table, lens, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["paged_decode_int8"] == before + 1
    act = torch.from_numpy(lengths > 0).cuda()
    _close(out[act], ref[act], dtype)
    assert float(out[3].abs().max()) == 0.0            # idle slot: zeros


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 16, 32, 128])
@pytest.mark.parametrize("lengths", [[8, 9, 24, 25], [0, 5, 0, 8, 1], [13, 16, 1, 0, 32]])
def test_paged_decode_write_int8_matches_plain(cuda, dtype, d, lengths):
    """The quantize-at-write kernel: output as its plain version's, pool
    data and scales byte-equal to int8 write_tokens' outside the trash
    page, and output bit-identical to write_tokens + the unfused kernel."""
    lengths = np.asarray(lengths)
    B = len(lengths)
    pools, table = _paged_int8(cuda, B, 2, d, 8, 4, lengths)
    q, kn, vn = _t(cuda, B, 8, d, dtype=dtype), _t(cuda, B, 2, d, dtype=dtype), \
        _t(cuda, B, 2, d, dtype=dtype)
    lens = torch.from_numpy(lengths.astype(np.int32)).cuda()
    ref_pools = [t.clone() for t in pools]
    ref = pa.paged_decode_attention_write_int8_plain(q, *ref_pools, table, lens, kn, vn,
                                                     scale=0.1)
    before = kernels.LAUNCHES["paged_decode_write_int8"]
    out = pa.paged_decode_attention_write_int8(q, *pools, table, lens, kn, vn, scale=0.1)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["paged_decode_write_int8"] == before + 1
    act = torch.from_numpy(lengths > 0).cuda()
    _close(out[act], ref[act], dtype)
    for got, want in zip(pools, ref_pools):
        assert torch.equal(got[:, 1:], want[:, 1:])
    unfused = pa.paged_decode_attention_int8(q, *ref_pools, table, lens, scale=0.1)
    assert torch.equal(out[act], unfused[act])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,softcap", [(None, None), (7, None), (None, 50.0)])
@pytest.mark.parametrize("group", [1, 4, 7])
def test_paged_decode_write_int8_groups_window_softcap(cuda, dtype, window, softcap, group):
    lengths = np.asarray([13, 64, 1, 0, 130])
    pools, table = _paged_int8(cuda, 5, 2, 64, 16, 9, lengths)
    q = _t(cuda, 5, 2 * group, 64, dtype=dtype)
    kn, vn = _t(cuda, 5, 2, 64, dtype=dtype), _t(cuda, 5, 2, 64, dtype=dtype)
    lens = torch.from_numpy(lengths.astype(np.int32)).cuda()
    kw = dict(scale=0.125, sliding_window=window, attn_softcap=softcap)
    ref_pools = [t.clone() for t in pools]
    ref = pa.paged_decode_attention_write_int8_plain(q, *ref_pools, table, lens, kn, vn, **kw)
    out = pa.paged_decode_attention_write_int8(q, *pools, table, lens, kn, vn, **kw)
    act = torch.from_numpy(lengths > 0).cuda()
    _close(out[act], ref[act], dtype)
    for got, want in zip(pools, ref_pools):
        assert torch.equal(got[:, 1:], want[:, 1:])


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("window,softcap", [(None, None), (500, None), (None, 30.0)])
def test_paged_decode_int8_multi_split_f32(cuda, fused, window, softcap):
    """int8 pools at llama-3-8b widths, page 64, 32 pages a slot: lengths
    300, 700 and 2048 give the split merge real partials in float32."""
    lengths = np.asarray([300, 700, 2048, 0])
    pools, table = _paged_int8(cuda, 4, 8, 128, 64, 32, lengths)
    q, kn, vn = _t(cuda, 4, 32, 128), _t(cuda, 4, 8, 128), _t(cuda, 4, 8, 128)
    lens = torch.from_numpy(lengths.astype(np.int32)).cuda()
    kw = dict(scale=128 ** -0.5, sliding_window=window, attn_softcap=softcap)
    act = torch.from_numpy(lengths > 0).cuda()
    if fused:
        ref_pools = [t.clone() for t in pools]
        ref = pa.paged_decode_attention_write_int8_plain(q, *ref_pools, table, lens, kn, vn,
                                                         **kw)
        out = pa.paged_decode_attention_write_int8(q, *pools, table, lens, kn, vn, **kw)
        for got, want in zip(pools, ref_pools):
            assert torch.equal(got[:, 1:], want[:, 1:])
    else:
        ref = pa.paged_decode_attention_int8_plain(q, *pools, table, lens, **kw)
        out = pa.paged_decode_attention_int8(q, *pools, table, lens, **kw)
    _close(out[act], ref[act], torch.float32)


def test_flash_prefill_long_f32(cuda):
    """llama-3-8b widths in float32: rows of up to 900 keys, 29 K/V tiles."""
    q, k, v = _t(cuda, 1, 1024, 32, 128), _t(cuda, 1, 1024, 8, 128), _t(cuda, 1, 1024, 8, 128)
    lengths = torch.tensor([900], dtype=torch.int32, device="cuda")
    out = fa.flash_prefill_attention(q, k, v, lengths, scale=128 ** -0.5)
    ref = fa.prefill_attention_plain(q, k, v, lengths, scale=128 ** -0.5)
    _close(out[0, :900], ref[0, :900], torch.float32)


def test_bf16_logits_keep_the_f32_accumulation(cuda):
    """The LM head on the card: bf16 operands, float32 logits not rounded to
    bf16 (the JAX path's preferred_element_type=float32). Held to the f32
    product of the same bf16 operands at 1e-5 of the logits' scale; a bf16
    rounding of the result would be off by ~4e-3 of it."""
    import dataclasses

    from llms_on_kubernetes_tpu_torch.configs import get_config
    from llms_on_kubernetes_tpu_torch.models.decoder import _logits
    from llms_on_kubernetes_tpu_torch.ops.norms import rms_norm

    cfg = dataclasses.replace(get_config("debug-tiny"), vocab_size=4096)
    params = {"final_norm": torch.ones(cfg.hidden_size, dtype=torch.bfloat16, device="cuda"),
              "lm_head": _t(cuda, cfg.hidden_size, 4096, dtype=torch.bfloat16)}
    x = _t(cuda, 8, cfg.hidden_size, dtype=torch.bfloat16)
    logits = _logits(params, cfg, x)
    assert logits.dtype == torch.float32
    h = rms_norm(x, params["final_norm"], cfg.rms_norm_eps, style=cfg.norm_style)
    ref = h.double() @ params["lm_head"].double()
    err = float((logits.double() - ref).abs().max())
    assert err <= 1e-5 * float(ref.abs().max())


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q, k, v = _t(cuda, 1, 16, 4, 96), _t(cuda, 1, 16, 2, 96), _t(cuda, 1, 16, 2, 96)
    lens = torch.tensor([16], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_prefill_attention(q, k, v, lens, scale=0.1)
    q, k, v = _t(cuda, 1, 16, 4, 64), _t(cuda, 1, 16, 2, 64), _t(cuda, 1, 16, 2, 64)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_prefill_attention(q[:, ::2], k[:, ::2], v[:, ::2], lens, scale=0.1)
    with pytest.raises(ValueError, match="int32"):
        fa.flash_prefill_attention(q, k, v, lens.long(), scale=0.1)
    with pytest.raises(ValueError, match="float32"):
        fa.flash_prefill_attention(q.half(), k.half(), v.half(), lens, scale=0.1)
    kp, vp, table = _paged(cuda, 1, 1, 64, 8, 2, [5], torch.float32)
    lens = torch.tensor([5], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="per KV head"):
        pa.paged_decode_attention(_t(cuda, 1, 9, 64), kp, vp, table, lens, scale=0.1)
    pools, table = _paged_int8(cuda, 1, 1, 64, 8, 2, [5])
    q = _t(cuda, 1, 2, 64)
    with pytest.raises(ValueError, match="int8"):           # a float pool
        pa.paged_decode_attention_int8(q, kp, pools[1], vp, pools[3], table, lens, scale=0.1)
    with pytest.raises(ValueError, match="k_scale"):
        pa.paged_decode_attention_int8(q, pools[0], pools[1][:, :, :4].contiguous(),
                                       pools[2], pools[3], table, lens, scale=0.1)
    with pytest.raises(ValueError, match="k_new"):          # not q's dtype
        pa.paged_decode_attention_write_int8(q, *pools, table, lens, _t(cuda, 1, 1, 64).half(),
                                             _t(cuda, 1, 1, 64).half(), scale=0.1)


def test_int8_decode_step_fused_equals_dus_on_the_card(cuda):
    """debug-tiny in float32 with int8 KV: one decode step with kv_write
    fused and dus from copies of one pool gives identical logits and
    byte-equal pools (data and scales) outside the trash pages."""
    from llms_on_kubernetes_tpu_torch.configs import get_config
    from llms_on_kubernetes_tpu_torch.engine.cache import CacheConfig, KVPool, init_pages
    from llms_on_kubernetes_tpu_torch.models import decoder

    cfg = get_config("debug-tiny")
    params = decoder.init_params(cfg, seed=0, dtype="float32", device="cuda")
    P = 24
    k, v = init_pages(CacheConfig(cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, num_pages=P,
                                  page_size=4, pages_per_slot=6, dtype="float32",
                                  kv_dtype="int8"), device="cuda")
    table = torch.tensor([[1, 2, 3, 0, 0, 0], [4, 5, 6, 0, 0, 0], [7, 0, 0, 0, 0, 0]],
                         dtype=torch.int32, device="cuda")
    tokens = torch.from_numpy(cuda.integers(0, 256, size=(3, 8)).astype(np.int32)).cuda()
    decoder.forward_prefill(params, cfg, tokens,
                            torch.tensor([8, 6, 3], dtype=torch.int32, device="cuda"), k, v,
                            table)
    outs = {}
    for mode in ("dus", "fused"):
        kp, vp = (KVPool(p.data.clone(), p.scale.clone()) for p in (k, v))
        logits, _, _ = decoder.forward_decode(
            params, cfg, torch.tensor([3, 9, 5], dtype=torch.int32, device="cuda"),
            torch.tensor([9, 7, 0], dtype=torch.int32, device="cuda"), kp, vp, table,
            kv_write=mode)
        outs[mode] = (logits[:2], kp, vp)
    assert torch.equal(outs["dus"][0], outs["fused"][0])
    keep = torch.ones(cfg.num_layers * P, dtype=torch.bool, device="cuda")
    keep[::P] = False
    for a, b in zip(outs["dus"][1:], outs["fused"][1:]):
        assert torch.equal(a.data[:, keep], b.data[:, keep])
        assert torch.equal(a.scale[:, keep], b.scale[:, keep])


def test_engine_on_cuda_matches_engine_on_cpu(cuda):
    """debug-tiny in float32, float and int8 KV: the kernels carry the
    engine to the same greedy streams as the plain versions on the CPU."""
    from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
    from llms_on_kubernetes_tpu_torch.models.decoder import init_params
    from llms_on_kubernetes_tpu_torch.configs import get_config

    params = init_params(get_config("debug-tiny"), seed=0, dtype="float32", device="cpu")
    kw = dict(model="debug-tiny", dtype="float32", max_decode_slots=4, page_size=4,
              num_pages=128, pages_per_slot=16, prefill_buckets=(16, 32))
    prompts = [[3, 17, 9], [40, 2] * 9, [7, 7, 7, 7], [11] * 30]
    sp = SamplingParams(max_tokens=10, temperature=0.0)
    for kv_dtype in (None, "int8"):
        outs = {}
        for dev, kv_write in (("cpu", "dus"), ("cuda", "dus"), ("cuda", "fused")):
            p = {k: ({n: w.to(dev) for n, w in v.items()} if isinstance(v, dict)
                     else v.to(dev)) for k, v in params.items()}
            eng = Engine(EngineConfig(**kw, device=dev, kv_write=kv_write,
                                      kv_cache_dtype=kv_dtype), params=p)
            reqs = [eng.submit(pr, sp) for pr in prompts]
            while eng.has_work():
                eng.step()
            outs[(dev, kv_write)] = [r.output for r in reqs]
        assert outs[("cuda", "dus")] == outs[("cpu", "dus")], kv_dtype
        assert outs[("cuda", "fused")] == outs[("cuda", "dus")], kv_dtype
