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

import time

import numpy as np
import pytest
import torch

from llms_on_kubernetes_tpu_torch import kernels
from llms_on_kubernetes_tpu_torch.engine.cache import quantize_kv
from llms_on_kubernetes_tpu_torch.ops import flash_attention as fa
from llms_on_kubernetes_tpu_torch.ops import paged_attention as pa
from llms_on_kubernetes_tpu_torch.ops import quant as tquant

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
@pytest.mark.parametrize("group", [1, 4, 7, 8])
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
@pytest.mark.parametrize("group", [1, 4, 7, 8])
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
@pytest.mark.parametrize("group", [1, 4, 7, 8])
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
    # a head_dim no kernel is instantiated for (96 is, since phi-3)
    q, k, v = _t(cuda, 1, 16, 4, 80), _t(cuda, 1, 16, 2, 80), _t(cuda, 1, 16, 2, 80)
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


def _window_case(rng, B, W, n_kv, d, page, pps, base, widths, int8, dtype):
    """Pools (float in ``dtype``, or int8 data + scales) over random pages
    covering each slot's window, rows k_new/v_new, and the mask of the
    (page, row) slots the window writes."""
    P = B * pps + 1
    table = np.zeros((B, pps), np.int32)
    perm = rng.permutation(P - 1) + 1
    written = np.zeros((P, page), bool)
    for b in range(B):
        used = min(pps, -(-(base[b] + W) // page))
        table[b, :used] = perm[b * pps:b * pps + used]
        for t in range(min(widths[b], W)):
            pos = base[b] + t
            if pos < pps * page:
                written[table[b, pos // page], pos % page] = True
    if int8:
        pools = [torch.from_numpy(rng.integers(-127, 128, size=(n_kv, P, page, d))
                                  .astype(np.int8)).cuda() if i % 2 == 0 else
                 torch.from_numpy((rng.random(size=(n_kv, P, page)) + 0.1)
                                  .astype(np.float32)).cuda() for i in range(4)]
    else:
        pools = [_t(rng, n_kv, P, page, d, dtype=dtype) for _ in range(2)]
    args = [torch.from_numpy(np.asarray(a, np.int32)).cuda() for a in (table, base, widths)]
    return pools, args, _t(rng, B, W, n_kv, d, dtype=dtype), _t(rng, B, W, n_kv, d, dtype=dtype), \
        torch.from_numpy(~written).cuda()


WINDOW_SHAPES = {
    "test_pallas": dict(B=5, W=4, n_kv=2, d=8, page=8, pps=4, base=[7, 8, 0, 15, 3],
                        widths=[4, 3, 4, 2, 0]),
    "d128_page16": dict(B=4, W=20, n_kv=2, d=128, page=16, pps=4, base=[0, 16, 5, 40],
                        widths=[20, 16, 1, 0]),
    "llama_b4": dict(B=4, W=256, n_kv=8, d=128, page=64, pps=32, base=[0, 896, 900, 0],
                     widths=[256, 256, 200, 0]),
}


@pytest.mark.parametrize("int8", [False, True], ids=["float_pool", "int8_pool"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(WINDOW_SHAPES))
def test_paged_write_window_matches_plain(cuda, int8, dtype, shape):
    """Kernels 6 and 7: pool bytes (data and scales) equal the plain
    version's outside the trash page 0, and every byte outside the written
    rows (page 0 included) is the pool's own."""
    from llms_on_kubernetes_tpu_torch.ops import paged_write as pw

    pools, args, kn, vn, keep = _window_case(cuda, int8=int8, dtype=dtype,
                                             **WINDOW_SHAPES[shape])
    before = [t.clone() for t in pools]
    ref = [t.clone() for t in pools]
    name = "paged_write_window_int8" if int8 else "paged_write_window"
    kernel = pw.paged_write_window_int8 if int8 else pw.paged_write_window
    plain = pw.paged_write_window_int8_plain if int8 else pw.paged_write_window_plain
    plain(*ref, *args, kn, vn)
    launches = kernels.LAUNCHES[name]
    kernel(*pools, *args, kn, vn)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == launches + 1
    for got, want, old in zip(pools, ref, before):
        assert torch.equal(got[:, 1:], want[:, 1:])
        assert torch.equal(got[:, keep], old[:, keep])


# span edges a slot each: a base mid-page, one on a page boundary, width 0,
# width = page, and a window whose rows run past the page table (pps pages)
def _span_edges(W, page, pps=3):
    return dict(B=5, W=W, pps=pps, base=[page // 2 + 1, page, 5, 0, pps * page - 7],
                widths=[W, W - 1, 0, min(page, W), W])


@pytest.mark.parametrize("page", [16, 64, 128])
@pytest.mark.parametrize("d", kernels.HEAD_DIMS)
@pytest.mark.parametrize("pool", ["f32", "bf16", "int8_f32_rows", "int8_bf16_rows"])
def test_paged_write_window_span_edges(cuda, pool, d, page):
    """Kernels 6 and 7 at the span edge cases, every head dim, pages of 16,
    64 and 128 rows (two spans a page), W below a page and W not a multiple
    of it: pool bytes (int8 data and scales bit for bit, quantize_kv's)
    equal the plain version's outside page 0, and page 0 and every other
    unwritten byte keep the pool's own."""
    from llms_on_kubernetes_tpu_torch.ops import paged_write as pw

    int8 = pool.startswith("int8")
    dtype = torch.bfloat16 if "bf16" in pool else torch.float32
    kernel = pw.paged_write_window_int8 if int8 else pw.paged_write_window
    plain = pw.paged_write_window_int8_plain if int8 else pw.paged_write_window_plain
    for W in (page - 3, 2 * page + 5):
        pools, args, kn, vn, keep = _window_case(cuda, n_kv=2, d=d, page=page, int8=int8,
                                                 dtype=dtype, **_span_edges(W, page))
        before = [t.clone() for t in pools]
        ref = [t.clone() for t in pools]
        plain(*ref, *args, kn, vn)
        kernel(*pools, *args, kn, vn)
        torch.cuda.synchronize()
        for got, want, old in zip(pools, ref, before):
            assert torch.equal(got[:, 1:], want[:, 1:]), W
            assert torch.equal(got[:, keep], old[:, keep]), W


def test_window_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from llms_on_kubernetes_tpu_torch.ops import paged_write as pw

    pools, args, kn, vn, _ = _window_case(cuda, int8=False, dtype=torch.float32,
                                          **WINDOW_SHAPES["test_pallas"])
    with pytest.raises(ValueError, match="int32"):
        pw.paged_write_window(*pools, args[0], args[1].long(), args[2], kn, vn)
    with pytest.raises(ValueError, match="one entry per slot"):
        pw.paged_write_window(*pools, args[0], args[1][:2], args[2], kn, vn)
    with pytest.raises(ValueError, match="head_dim"):
        pw.paged_write_window(pools[0][..., :6].contiguous(), pools[1][..., :6].contiguous(),
                              *args, kn[..., :6].contiguous(), vn[..., :6].contiguous())
    q8, args8, kn8, vn8, _ = _window_case(cuda, int8=True, dtype=torch.float32,
                                          **WINDOW_SHAPES["test_pallas"])
    with pytest.raises(ValueError, match="k_new"):
        pw.paged_write_window_int8(*q8, *args8, kn8.half(), vn8.half())
    with pytest.raises(ValueError, match="int8"):
        pw.paged_write_window_int8(pools[0], q8[1], pools[1], q8[3], *args8, kn8, vn8)
    # a page over SPAN_ROWS rows and not a multiple of it: the spans are cut
    # by in-page offset, so it writes what the plain version writes
    p100, args100, kn100, vn100, keep = _window_case(
        cuda, int8=False, dtype=torch.float32, **dict(WINDOW_SHAPES["test_pallas"], page=100))
    ref, before = [t.clone() for t in p100], [t.clone() for t in p100]
    pw.paged_write_window_plain(*ref, *args100, kn100, vn100)
    pw.paged_write_window(*p100, *args100, kn100, vn100)
    torch.cuda.synchronize()
    for got, want, old in zip(p100, ref, before):
        assert torch.equal(got[:, 1:], want[:, 1:])
        assert torch.equal(got[:, keep], old[:, keep])


def test_engine_chunk_path_and_cache_hits_on_the_card(cuda):
    """debug-tiny in float32, float and int8 KV: a prompt past the largest
    bucket (chunked) and a second pass of cache hits give the CPU's greedy
    streams, and the window kernel runs once a layer per chunk call."""
    from llms_on_kubernetes_tpu_torch.configs import get_config
    from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
    from llms_on_kubernetes_tpu_torch.models.decoder import init_params

    cfg = get_config("debug-tiny")
    params = init_params(cfg, seed=0, dtype="float32", device="cpu")
    kw = dict(model="debug-tiny", dtype="float32", max_decode_slots=4, page_size=4,
              num_pages=128, pages_per_slot=16, prefill_buckets=(8, 16))
    prompts = [[3, 17, 9, 4, 4, 1], [40, 2] * 9, [(7 * i) % 251 for i in range(37)]]
    sp = SamplingParams(max_tokens=8, temperature=0.0)
    for kv_dtype in (None, "int8"):
        outs = {}
        for dev in ("cpu", "cuda"):
            p = {k: ({n: w.to(dev) for n, w in v.items()} if isinstance(v, dict)
                     else v.to(dev)) for k, v in params.items()}
            eng = Engine(EngineConfig(**kw, device=dev, kv_cache_dtype=kv_dtype), params=p)
            window = "paged_write_window_int8" if kv_dtype else "paged_write_window"
            launches = kernels.LAUNCHES[window]
            for rnd in ("cold", "hit"):
                reqs = [eng.submit(pr, sp) for pr in prompts]
                while eng.has_work():
                    eng.step()
                outs[(dev, rnd)] = [r.output for r in reqs]
            assert eng.allocator.hit_tokens_total == 4 + 16 + 36
            assert eng.chunk_calls == 5 + 3
            if dev == "cuda":
                assert kernels.LAUNCHES[window] - launches == cfg.num_layers * eng.chunk_calls
        assert outs[("cuda", "cold")] == outs[("cpu", "cold")], kv_dtype
        assert outs[("cuda", "hit")] == outs[("cpu", "hit")] == outs[("cpu", "cold")], kv_dtype


@pytest.mark.parametrize("window,softcap", [(None, None), (37, None), (None, 30.0)])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("T", [77, 1000])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_prefill_tensor_cores_bf16(cuda, d, T, group, window, softcap):
    """The bf16 tensor-core body: T not a multiple of the 64-row tile,
    lengths 0, 1 and T in one batch, every group the decoder uses; rows
    below each length match the plain version, and every row is finite
    (a query tile past its length is zeros)."""
    n_kv = 2
    q = _t(cuda, 3, T, n_kv * group, d, dtype=torch.bfloat16)
    k, v = (_t(cuda, 3, T, n_kv, d, dtype=torch.bfloat16) for _ in range(2))
    lengths = torch.tensor([0, 1, T], dtype=torch.int32, device="cuda")
    kw = dict(scale=d ** -0.5, sliding_window=window, attn_softcap=softcap)
    out = fa.flash_prefill_attention(q, k, v, lengths, **kw)
    ref = fa.prefill_attention_plain(q, k, v, lengths, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert float(out[0].float().abs().max()) == 0.0       # length 0: one padding tile
    _close(out[1, :1], ref[1, :1], torch.bfloat16)
    _close(out[2], ref[2], torch.bfloat16)


def _decode_case(rng, lengths, int8, dtype, n_kv=8, group=4, d=128, page=64, pps=32):
    if int8:
        pools, table = _paged_int8(rng, len(lengths), n_kv, d, page, pps, lengths)
    else:
        kp, vp, table = _paged(rng, len(lengths), n_kv, d, page, pps, lengths, dtype)
        pools = [kp, vp]
    q = _t(rng, len(lengths), n_kv * group, d, dtype=dtype)
    return pools, table, q, torch.from_numpy(np.asarray(lengths, np.int32)).cuda()


def _decode(int8, q, pools, table, lens, **kw):
    if int8:
        return pa.paged_decode_attention_int8(q, *pools, table, lens, **kw)
    return pa.paged_decode_attention(q, pools[0], pools[1], table, lens, **kw)


def _decode_plain(int8, q, pools, table, lens, **kw):
    if int8:
        return pa.paged_decode_attention_int8_plain(q, *pools, table, lens, **kw)
    return pa.paged_decode_attention_plain(q, pools[0], pools[1], table, lens, **kw)


def _counters_clear(device):
    return not bool(pa.WORKSPACE.get(device, 1, 1, 1, 1, 8)[1].any())


@pytest.mark.parametrize("int8", [False, True], ids=["float_pool", "int8_pool"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_two_calls_bit_identical(cuda, int8, dtype):
    """One launch merges the splits: the last block to arrive merges in
    split order and puts its counter back to 0, so a second call gives the
    same bits and every counter is 0 after each call."""
    lengths = [300, 700, 2048, 0, 256, 512, 45, 1]
    pools, table, q, lens = _decode_case(cuda, lengths, int8, dtype)
    kw = dict(scale=128 ** -0.5)
    first = _decode(int8, q, pools, table, lens, **kw)
    torch.cuda.synchronize()
    assert _counters_clear(q.device)
    second = _decode(int8, q, pools, table, lens, **kw)
    torch.cuda.synchronize()
    assert _counters_clear(q.device)
    assert torch.equal(first, second)
    act = lens > 0
    _close(first[act], _decode_plain(int8, q, pools, table, lens, **kw)[act], dtype)
    assert float(first[3].float().abs().max()) == 0.0       # idle slot: zeros


@pytest.mark.parametrize("int8", [False, True], ids=["float_pool", "int8_pool"])
def test_paged_decode_workspace_grows(cuda, int8):
    """A launch with more (slot, KV head) pairs than any before it grows the
    workspace, and the new counters work from the first call."""
    small = _decode_case(cuda, [300, 20], int8, torch.bfloat16, n_kv=2)
    lengths = [600 + 37 * i for i in range(24)]
    big = _decode_case(cuda, lengths, int8, torch.bfloat16, n_kv=16, group=2, pps=24)
    kw = dict(scale=128 ** -0.5)
    for pools, table, q, lens in (small, big, small):
        out = _decode(int8, q, pools, table, lens, **kw)
        _close(out, _decode_plain(int8, q, pools, table, lens, **kw), torch.bfloat16)
        torch.cuda.synchronize()
        assert _counters_clear(q.device)
    assert pa.WORKSPACE.get(q.device, 1, 1, 1, 1, 8)[1].numel() >= 24 * 16


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("int8", [False, True], ids=["float_pool", "int8_pool"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 300, 260])
def test_paged_decode_split_boundaries(cuda, fused, int8, dtype, window):
    """Lengths that end exactly on a 256-key split boundary (256, 512, 768)
    or one past it, and windows that start inside a split (700 - 300 = 400,
    inside split 1; 512 - 260 = 252, inside split 0): only the splits that
    hold keys work, and the merge of their partials matches the plain
    version (float32 at 1e-4). The fused append stores write_tokens' bytes
    and attends like write_tokens + the unfused kernel, bit for bit."""
    lengths = [256, 512, 768, 257, 700, 0]
    pools, table, q, lens = _decode_case(cuda, lengths, int8, dtype)
    kw = dict(scale=128 ** -0.5, sliding_window=window)
    act = lens > 0
    if not fused:
        out = _decode(int8, q, pools, table, lens, **kw)
        _close(out[act], _decode_plain(int8, q, pools, table, lens, **kw)[act], dtype)
        return
    kn, vn = _t(cuda, len(lengths), 8, 128, dtype=dtype), _t(cuda, len(lengths), 8, 128,
                                                           dtype=dtype)
    ref_pools = [t.clone() for t in pools]
    if int8:
        ref = pa.paged_decode_attention_write_int8_plain(q, *ref_pools, table, lens, kn, vn,
                                                         **kw)
        out = pa.paged_decode_attention_write_int8(q, *pools, table, lens, kn, vn, **kw)
    else:
        ref = pa.paged_decode_attention_write_plain(q, *ref_pools, table, lens, kn, vn, **kw)
        out = pa.paged_decode_attention_write(q, *pools, table, lens, kn, vn, **kw)
    _close(out[act], ref[act], dtype)
    for got, want in zip(pools, ref_pools):
        assert torch.equal(got[:, 1:], want[:, 1:])
    assert torch.equal(out[act], _decode(int8, q, ref_pools, table, lens, **kw)[act])


def test_wrappers_refuse_misaligned_rows(cuda):
    """The kernels copy rows in 16-byte vectors: a view that starts off a
    16-byte boundary is refused, not read wrongly."""
    buf = _t(cuda, 1 * 16 * 4 * 64 + 8, dtype=torch.bfloat16)
    q = buf[4:4 + 16 * 4 * 64].view(1, 16, 4, 64)          # 8 bytes in
    k, v = _t(cuda, 1, 16, 2, 64, dtype=torch.bfloat16), _t(cuda, 1, 16, 2, 64,
                                                            dtype=torch.bfloat16)
    lens = torch.tensor([16], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_prefill_attention(q, k, v, lens, scale=0.1)
    kp, vp, table = _paged(cuda, 1, 1, 64, 8, 2, [5], torch.bfloat16)
    qd = buf[4:4 + 2 * 64].view(1, 2, 64)
    with pytest.raises(ValueError, match="16-byte"):
        pa.paged_decode_attention(qd, kp, vp, table, torch.tensor([5], dtype=torch.int32,
                                                                  device="cuda"), scale=0.1)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 16, 32])
def test_paged_decode_small_head_dims(cuda, fused, dtype, d):
    """Float pools at head dims whose rows are one or two 16-byte copies
    (bf16 d 8 and 16 take the CUDA-core and the tensor-core body), past one
    16-key tile and one 256-key split."""
    lengths = np.asarray([13, 40, 1, 0, 300])
    kp, vp, table = _paged(cuda, 5, 2, d, 16, 20, lengths, dtype)
    q, kn, vn = _t(cuda, 5, 8, d, dtype=dtype), _t(cuda, 5, 2, d, dtype=dtype), \
        _t(cuda, 5, 2, d, dtype=dtype)
    lens = torch.from_numpy(lengths.astype(np.int32)).cuda()
    act = torch.from_numpy(lengths > 0).cuda()
    kw = dict(scale=d ** -0.5)
    if fused:
        kr, vr = kp.clone(), vp.clone()
        ref = pa.paged_decode_attention_write_plain(q, kr, vr, table, lens, kn, vn, **kw)
        out = pa.paged_decode_attention_write(q, kp, vp, table, lens, kn, vn, **kw)
        assert torch.equal(kp[:, 1:], kr[:, 1:]) and torch.equal(vp[:, 1:], vr[:, 1:])
        assert torch.equal(out[act], pa.paged_decode_attention(q, kr, vr, table, lens,
                                                               **kw)[act])
    else:
        ref = pa.paged_decode_attention_plain(q, kp, vp, table, lens, **kw)
        out = pa.paged_decode_attention(q, kp, vp, table, lens, **kw)
    _close(out[act], ref[act], dtype)


# -- head_dim 96 (phi-3: 32 query heads on 32 KV heads) and 256 (gemma-2:
# 16 on 8), every kernel against its plain version ------------------------

WIDE = {96: dict(n_kv=32, group=1), 256: dict(n_kv=8, group=2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,softcap", [(None, None), (37, None), (None, 50.0)])
@pytest.mark.parametrize("d", [96, 256])
def test_flash_prefill_wide_head_dims(cuda, d, window, softcap, dtype):
    """Kernel 1 at head_dim 96 and 256: rows past several 64-key tiles (T
    200), a second row cut short, phi-3's and gemma-2's head counts."""
    n_kv, group = WIDE[d]["n_kv"], WIDE[d]["group"]
    T = 200
    q, k, v = _t(cuda, 2, T, n_kv * group, d, dtype=dtype), \
        _t(cuda, 2, T, n_kv, d, dtype=dtype), _t(cuda, 2, T, n_kv, d, dtype=dtype)
    lengths = torch.tensor([T, 77], dtype=torch.int32, device="cuda")
    kw = dict(scale=d ** -0.5, sliding_window=window, attn_softcap=softcap)
    before = kernels.LAUNCHES["flash_prefill"]
    out = fa.flash_prefill_attention(q, k, v, lengths, **kw)
    ref = fa.prefill_attention_plain(q, k, v, lengths, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_prefill"] == before + 1
    _close(out[0], ref[0], dtype)
    _close(out[1, :77], ref[1, :77], dtype)


@pytest.mark.parametrize("page", [24, 64])
@pytest.mark.parametrize("window,softcap", [(None, None), (300, None), (None, 30.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [96, 256])
@pytest.mark.parametrize("int8", [False, True], ids=["float_pool", "int8_pool"])
@pytest.mark.parametrize("fused", [False, True])
def test_paged_decode_wide_head_dims(cuda, fused, int8, d, dtype, window, softcap, page):
    """Kernels 2-5 at head_dim 96 (group 1) and 256 (group 2), lengths
    past one 256-key split, an idle slot, pages of 24 and 64: output as
    the plain version's; the fused kernels' pool bytes (int8: data and
    scales) as write_tokens' outside the trash page, and their output bit
    for bit that of write_tokens then the unfused kernel."""
    n_kv, group = WIDE[d]["n_kv"], WIDE[d]["group"]
    lengths = np.asarray([300, 37, 0, 700])
    B, pps = len(lengths), -(-700 // page)
    if int8:
        pools, table = _paged_int8(cuda, B, n_kv, d, page, pps, lengths)
    else:
        kp, vp, table = _paged(cuda, B, n_kv, d, page, pps, lengths, dtype)
        pools = [kp, vp]
    q = _t(cuda, B, n_kv * group, d, dtype=dtype)
    kn, vn = _t(cuda, B, n_kv, d, dtype=dtype), _t(cuda, B, n_kv, d, dtype=dtype)
    lens = torch.from_numpy(lengths.astype(np.int32)).cuda()
    kw = dict(scale=d ** -0.5, sliding_window=window, attn_softcap=softcap)
    act = torch.from_numpy(lengths > 0).cuda()
    name = "paged_decode" + ("_write" if fused else "") + ("_int8" if int8 else "")
    before = kernels.LAUNCHES[name]
    if fused:
        ref_pools = [t.clone() for t in pools]
        plain = (pa.paged_decode_attention_write_int8_plain if int8
                 else pa.paged_decode_attention_write_plain)
        kernel = (pa.paged_decode_attention_write_int8 if int8
                  else pa.paged_decode_attention_write)
        ref = plain(q, *ref_pools, table, lens, kn, vn, **kw)
        out = kernel(q, *pools, table, lens, kn, vn, **kw)
        for got, want in zip(pools, ref_pools):
            assert torch.equal(got[:, 1:], want[:, 1:])
        unfused = (pa.paged_decode_attention_int8 if int8 else pa.paged_decode_attention)(
            q, *ref_pools, table, lens, **kw)
        assert torch.equal(out[act], unfused[act])
    else:
        plain = pa.paged_decode_attention_int8_plain if int8 else pa.paged_decode_attention_plain
        kernel = pa.paged_decode_attention_int8 if int8 else pa.paged_decode_attention
        ref = plain(q, *pools, table, lens, **kw)
        out = kernel(q, *pools, table, lens, **kw)
        assert float(out[2].abs().max()) == 0.0        # idle slot: zeros
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    _close(out[act], ref[act], dtype)


@pytest.mark.parametrize("page", [1, 5, 24, 100, 130])
@pytest.mark.parametrize("d", [96, 128, 256])
@pytest.mark.parametrize("pool", ["f32", "bf16", "int8_f32_rows", "int8_bf16_rows"])
def test_paged_write_window_any_page(cuda, pool, d, page):
    """Kernels 6 and 7 at pages that are neither at most 16 rows nor a
    multiple of 16 (24, 100, 130) and small ones (1, 5), at the span edge
    cases, head_dim 96, 128 and 256: pool bytes (int8 data and scales, bit
    for bit quantize_kv's) equal the plain version's outside page 0, and
    every unwritten byte keeps the pool's own."""
    from llms_on_kubernetes_tpu_torch.ops import paged_write as pw

    int8 = pool.startswith("int8")
    dtype = torch.bfloat16 if "bf16" in pool else torch.float32
    kernel = pw.paged_write_window_int8 if int8 else pw.paged_write_window
    plain = pw.paged_write_window_int8_plain if int8 else pw.paged_write_window_plain
    name = "paged_write_window_int8" if int8 else "paged_write_window"
    for W in sorted({max(1, page - 3), 2 * page + 5, 40}):
        pools, args, kn, vn, keep = _window_case(cuda, n_kv=2, d=d, page=page, int8=int8,
                                                 dtype=dtype,
                                                 **_span_edges(W, page, pps=max(4, -(-8 // page))))
        before = [t.clone() for t in pools]
        ref = [t.clone() for t in pools]
        plain(*ref, *args, kn, vn)
        launches = kernels.LAUNCHES[name]
        kernel(*pools, *args, kn, vn)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[name] == launches + 1
        for got, want, old in zip(pools, ref, before):
            assert torch.equal(got[:, 1:], want[:, 1:]), W
            assert torch.equal(got[:, keep], old[:, keep]), W


def _wide_debug_config(d: int):
    """debug-tiny cut to head_dim 96 (phi-3 style: one query head a KV head,
    a sliding window) or 256 (gemma-2 style: softcaps, alternating
    windows), made here and not registered."""
    import dataclasses

    from llms_on_kubernetes_tpu_torch.configs import get_config

    if d == 96:
        return dataclasses.replace(get_config("debug-tiny"), name="debug-d96", head_dim=96,
                                   num_heads=2, num_kv_heads=2, sliding_window=30)
    return dataclasses.replace(get_config("debug-gemma"), name="debug-d256", head_dim=256,
                               num_heads=2, num_kv_heads=1, logit_softcap=30.0,
                               attn_softcap=50.0, query_pre_attn_scalar=256.0)


@pytest.mark.parametrize("d", [96, 256])
def test_engine_wide_head_dims_page_24_on_the_card(cuda, d):
    """An engine at head_dim 96 or 256 and page 24 on the card, float32,
    float and int8 KV: a prompt past the largest bucket (chunked), cache
    hits on a second pass and the decode windows give the CPU's greedy
    streams, through the kernels (the window kernel once a layer per chunk
    call)."""
    from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
    from llms_on_kubernetes_tpu_torch.models.decoder import init_params

    cfg = _wide_debug_config(d)
    params = init_params(cfg, seed=0, dtype="float32", device="cpu")
    kw = dict(model=cfg.name, dtype="float32", max_decode_slots=4, page_size=24,
              num_pages=64, pages_per_slot=6, prefill_buckets=(16, 32))
    prompts = [[3, 17, 9, 4, 4, 1], [40, 2] * 20, [(7 * i) % 251 for i in range(75)]]
    sp = SamplingParams(max_tokens=8, temperature=0.0)
    for kv_dtype in (None, "int8"):
        outs = {}
        for dev in ("cpu", "cuda"):
            p = {k: ({n: w.to(dev) for n, w in v.items()} if isinstance(v, dict)
                     else v.to(dev)) for k, v in params.items()}
            eng = Engine(EngineConfig(**kw, device=dev, kv_cache_dtype=kv_dtype),
                         model_config=cfg, params=p)
            window = "paged_write_window_int8" if kv_dtype else "paged_write_window"
            launches = dict(kernels.LAUNCHES)
            for rnd in ("cold", "hit"):
                reqs = [eng.submit(pr, sp) for pr in prompts]
                while eng.has_work():
                    eng.step()
                outs[(dev, rnd)] = [r.output for r in reqs]
            assert eng.chunk_calls >= 3 and eng.allocator.hit_tokens_total >= 24 + 72
            if dev == "cuda":
                assert (kernels.LAUNCHES[window] - launches.get(window, 0)
                        == cfg.num_layers * eng.chunk_calls)
                assert kernels.LAUNCHES["flash_prefill"] > launches.get("flash_prefill", 0)
        assert outs[("cuda", "cold")] == outs[("cpu", "cold")], kv_dtype
        assert outs[("cuda", "hit")] == outs[("cpu", "hit")] == outs[("cpu", "cold")], kv_dtype


# ---------------------------------------------------------------------------
# the decode window as one CUDA graph (engine/graphs.py)
# ---------------------------------------------------------------------------

def _tiny_engine(dev, quantized=False, **kw):
    from llms_on_kubernetes_tpu_torch.configs import get_config
    from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig
    from llms_on_kubernetes_tpu_torch.models.decoder import init_params

    # drawn on the CPU and moved, so every device gets the same weights
    params = init_params(get_config("debug-tiny"), seed=0, dtype="float32", device="cpu")
    if quantized:       # int8 weights, quantized on the CPU
        params = tquant.quantize_params(params)
    params = {k: ({n: w.to(dev) for n, w in v.items()} if isinstance(v, dict) else v.to(dev))
              for k, v in params.items()}
    base = dict(model="debug-tiny", dtype="float32", max_decode_slots=4, page_size=4,
                num_pages=128, pages_per_slot=16, prefill_buckets=(16, 32), device=dev)
    return Engine(EngineConfig(**{**base, **kw}), params=params)


def _window_inputs(eng, prompts, penalties=False):
    """Admit ``prompts`` (sync admission: first tokens read), grow each row
    for a full window and return its packed rows (host values)."""
    from llms_on_kubernetes_tpu_torch.engine.engine import SamplingParams

    sp = SamplingParams(max_tokens=64, temperature=0.7 if penalties else 0.0, seed=5,
                        presence_penalty=0.4 if penalties else 0.0,
                        frequency_penalty=0.3 if penalties else 0.0)
    for p in prompts:
        eng.submit(p, sp)
    eng._admit()
    K = eng.config.decode_steps
    active = [(i, r) for i, r in enumerate(eng.slots) if r is not None]
    base = {i: int(eng.slot_len[i]) + 1 for i, _r in active}
    for i, _r in active:
        eng.allocator.allocate(i, base[i] + K - 1)
    return eng._window_rows(active, {i: K for i, _r in active}, base)


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32_kv", "int8_kv"])
@pytest.mark.parametrize("kv_write", ["dus", "fused"])
def test_window_graph_replay_equals_the_eager_window(cuda, kv_write, kv_dtype):
    """One window replayed and one run eagerly from copies of one pool and
    one penalty-count table: the same packed results (tokens, logprobs,
    top alternatives), and pools (outside each layer's trash page) and
    counts byte-equal."""
    from llms_on_kubernetes_tpu_torch.engine.cache import KVPool

    eng = _tiny_engine("cuda", kv_write=kv_write, kv_cache_dtype=kv_dtype,
                       async_scheduling=False)
    packed = _window_inputs(eng, [[3, 17, 9], [40, 2] * 9, [7] * 30], penalties=True)
    pools = [KVPool(p.data.clone(), None if p.scale is None else p.scale.clone())
             for p in (eng.k_pages, eng.v_pages)]
    counts = eng.token_counts.clone()
    zeros = torch.zeros(eng.config.max_decode_slots, dtype=torch.int32, device="cuda")
    eager_pack, eager_toks = eng._window._eager(
        torch.from_numpy(packed).cuda(), zeros, zeros[:1], *pools, counts,
        workspace=pa.DecodeWorkspace())
    pack, toks = eng._window.run(packed, None, None)
    torch.cuda.synchronize()
    assert eng.graph_replays == 1
    assert torch.equal(pack, eager_pack) and torch.equal(toks, eager_toks)
    assert torch.equal(eng.token_counts, counts) and int(counts.sum()) > 0
    P = eng.config.num_pages
    keep = torch.ones(eng.model_config.num_layers * P, dtype=torch.bool, device="cuda")
    keep[::P] = False
    for got, want in zip((eng.k_pages, eng.v_pages), pools):
        assert torch.equal(got.data[:, keep], want.data[:, keep])
        if want.scale is not None:
            assert torch.equal(got.scale[:, keep], want.scale[:, keep])


def test_two_engines_of_different_shapes_replay_in_turn(cuda):
    """Each engine owns its decode workspace: two engines of different
    shapes, alive in one process with their graphs replayed in turn (and
    the process-wide workspace grown by a direct call between them), give
    the streams each gives alone."""
    from llms_on_kubernetes_tpu_torch.engine.engine import SamplingParams

    shapes = [dict(), dict(max_decode_slots=2, page_size=8, num_pages=96, pages_per_slot=12)]
    prompts = [[3, 17, 9], [40, 2] * 9, [7] * 30, [5, 6]]
    sp = SamplingParams(max_tokens=24, temperature=0.0)

    def streams(eng, reqs):
        return [r.output for r in reqs]

    alone = []
    for kw in shapes:
        eng = _tiny_engine("cuda", **kw)
        reqs = [eng.submit(p, sp) for p in prompts]
        while eng.has_work():
            eng.step()
        alone.append(streams(eng, reqs))
        del eng
    engines = [_tiny_engine("cuda", **kw) for kw in shapes]
    assert engines[0].workspace is not engines[1].workspace
    assert all(e.workspace.frozen for e in engines)
    rng = np.random.default_rng(1)
    q = _t(rng, 16, 8, 32)
    kp, vp, table = _paged(rng, 16, 8, 32, 64, 32, [2048] * 16, torch.float32)
    lens = torch.full((16,), 2048, dtype=torch.int32, device="cuda")
    pa.paged_decode_attention(q, kp, vp, table, lens, scale=0.2)   # grows WORKSPACE
    reqs = [[e.submit(p, sp) for p in prompts] for e in engines]
    while any(e.has_work() for e in engines):
        for e in engines:
            if e.has_work():
                e.step()
    assert [streams(e, r) for e, r in zip(engines, reqs)] == alone
    assert all(e.graph_replays > 0 for e in engines)


def test_launches_after_n_replays_are_n_times_the_captured_counts(cuda):
    """Building an engine (warm-up and capture) counts no launch; every
    replay adds the captured window's launches: num_layers x K decode
    kernel launches, nothing else."""
    before = kernels.launch_counts()
    eng = _tiny_engine("cuda", async_scheduling=False)
    assert kernels.launch_counts() == before
    L, K = eng.model_config.num_layers, eng.config.decode_steps
    assert eng._window.launches == {"paged_decode": L * K}
    packed = _window_inputs(eng, [[3, 17, 9], [7] * 30])
    kernels.reset_launches()
    for _ in range(5):
        eng._window.run(packed, None, None)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"paged_decode": 5 * L * K}
    assert kernels.replayed_counts() == {"paged_decode": 5 * L * K}
    assert eng.graph_replays == 5


@pytest.mark.parametrize("kw", [dict(), dict(async_depth=1), dict(kv_cache_dtype="int8"),
                                dict(num_pages=11, page_size=8, pages_per_slot=8)],
                         ids=["depth2", "depth1", "int8_kv", "tight_pool"])
def test_async_graphed_engine_equals_sync_and_the_cpu(cuda, kw):
    """The default engine on the card (async, graphed windows) gives the
    greedy streams of the sync engine on the card and of the CPU engine,
    with every window a replay; in a tight pool it preempts and its
    streams stay the same."""
    from llms_on_kubernetes_tpu_torch.engine.engine import SamplingParams

    prompts = [[1, 2, 3]] * 4 + [[40, 2] * 9, [7] * 30]
    sp = SamplingParams(max_tokens=20, temperature=0.0)
    outs = {}
    for name, dev, extra in (("async", "cuda", {}), ("sync", "cuda",
                                                     dict(async_scheduling=False)),
                             ("cpu", "cpu", {})):
        eng = _tiny_engine(dev, **{**kw, **extra})
        reqs = [eng.submit(p, sp) for p in prompts]
        while eng.has_work():
            eng.step()
        outs[name] = [(r.output, r.finish_reason) for r in reqs]
        if dev == "cuda":
            assert eng.graph_replays * eng.config.decode_steps == eng.decode_forwards > 0
        if "num_pages" in kw:
            assert eng.preemptions > 0, name
    assert outs["async"] == outs["sync"] == outs["cpu"]


@pytest.mark.parametrize("async_scheduling", [True, False], ids=["async", "sync"])
def test_graphed_preemption_right_after_the_first_token(cuda, async_scheduling):
    """Four 3-token prompts (prompt + 1 fills a 4-row page) in 4 usable
    pages: the first window's growth preempts the youngest holding one
    output token; they resume with their first token restored, and the
    streams equal the CPU engine's with room."""
    from llms_on_kubernetes_tpu_torch.engine.engine import SamplingParams

    prompts = [[1 + i, 5, 9 + i] for i in range(4)]
    sp = SamplingParams(max_tokens=12, temperature=0.0)
    outs = {}
    for name, dev, kw in (("tight", "cuda", dict(num_pages=5)), ("roomy", "cpu", {})):
        eng = _tiny_engine(dev, async_scheduling=async_scheduling, **kw)
        seen = []
        preempt = eng._preempt_youngest

        def recording(eng=eng, preempt=preempt, seen=seen):
            victim = max((r for r in eng.slots if r is not None), key=lambda r: r.submitted_at)
            seen.append(len(victim.output))
            preempt()

        eng._preempt_youngest = recording
        reqs = [eng.submit(p, sp) for p in prompts]
        while eng.has_work():
            eng.step()
        outs[name] = [(r.output, r.finish_reason) for r in reqs]
        if name == "tight":
            assert eng.preemptions > 0 and 1 in seen, seen
            assert eng.graph_replays * eng.config.decode_steps == eng.decode_forwards
    assert outs["tight"] == outs["roomy"]


def test_a_script_that_leaves_its_engine_alive_exits_cleanly(cuda):
    """An engine still referenced when the interpreter exits (its harvester
    thread running) must not abort the process."""
    import subprocess
    import sys
    from pathlib import Path

    script = ("from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, "
              "SamplingParams\n"
              "eng = Engine(EngineConfig(model='debug-tiny', dtype='float32', device='cuda'))\n"
              "print(eng.generate([1, 2, 3], SamplingParams(max_tokens=8, temperature=0.0)))\n")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          cwd=Path(__file__).resolve().parent.parent, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "terminate called" not in proc.stderr


def test_harvester_wait_releases_the_interpreter_lock(cuda):
    """The harvester's event wait must let the engine thread run: while it
    waits on a copy queued behind ~0.2 s of device work, this thread keeps
    executing Python."""
    import threading
    import time

    from llms_on_kubernetes_tpu_torch.engine.engine import _HostCopy

    t = torch.zeros(4, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)
    copy = _HostCopy(t)
    done = threading.Event()
    waited = []

    def reader():
        t0 = time.perf_counter()
        copy.read()
        waited.append(time.perf_counter() - t0)
        done.set()

    th = threading.Thread(target=reader)
    th.start()
    spins = 0
    while not done.is_set():
        spins += 1
    th.join(timeout=30)
    assert not th.is_alive() and waited[0] > 0.02
    assert spins > 10_000, spins


# ---------------------------------------------------------------------------
# the W8A16 kernel (csrc/w8_matmul.cu) and int8 weights on the card
# ---------------------------------------------------------------------------

def _w8_inputs(rng, M, K, N, dtype):
    x = _t(rng, M, K, dtype=dtype)
    w = torch.from_numpy(rng.integers(-127, 128, size=(K, N)).astype(np.int8)).cuda()
    s = torch.from_numpy(rng.uniform(1e-3, 2e-2, size=N).astype(np.float32)).cuda()
    return x, w, s


# M on both bodies (<= 64 rows: the decode body at 8, 16, 32 and 64 rows;
# above: 128-row prefill blocks), K past and short of a whole K tile and of
# a 64-row unit, N not a multiple of a slab; float32 at small K only: 1e-4
# is the summation order's error there (at K 4,096 two f32 orders of sums
# near 40 differ by ~1.5e-4)
W8_SHAPES = [(dt, *shape) for shape in [(1, 64, 32), (3, 64, 32), (17, 128, 48),
                                        (64, 320, 96), (65, 64, 32), (200, 320, 160)]
             for dt in (torch.float32, torch.bfloat16)]
W8_SHAPES += [(torch.bfloat16, 8, 4096, 1024), (torch.bfloat16, 300, 1024, 4096),
              (torch.bfloat16, 33, 80, 48), (torch.bfloat16, 8, 4112, 256),
              (torch.bfloat16, 64, 3072, 8192), (torch.bfloat16, 130, 8192, 3072)]


@pytest.mark.parametrize("dtype,M,K,N", W8_SHAPES)
def test_w8_matmul_matches_plain(cuda, dtype, M, K, N):
    x, w, s = _w8_inputs(cuda, M, K, N, dtype)
    before = kernels.LAUNCHES["w8_matmul"]
    out = tquant.w8_matmul(x, w, s)
    ref = tquant.w8_matmul_plain(x, w, s)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["w8_matmul"] == before + 1
    assert out.dtype == dtype and tuple(out.shape) == (M, N)
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w8_matmul_rows_do_not_depend_on_m(cuda, dtype):
    """Batch invariance: a row's output is bit for bit the same at any M
    (both block shapes) and at any place in the call."""
    x, w, s = _w8_inputs(cuda, 4096, 320, 96, dtype)
    full = tquant.w8_matmul(x, w, s)
    for M in (1, 5, 64, 65, 256):
        assert torch.equal(tquant.w8_matmul(x[:M], w, s), full[:M]), M
    for r in (37, 1000, 4095):
        assert torch.equal(tquant.w8_matmul(x[r:r + 1], w, s), full[r:r + 1]), r
        assert torch.equal(tquant.w8_matmul(x[r - 30:r + 1], w, s)[-1], full[r]), r


# llama-3-8b's and phi-3-mini's projections (K, N), and a K of 16-row units
W8_SERVED = {"llama wq/wo": (4096, 4096), "llama wk/wv": (4096, 1024),
             "llama w_gate/w_up": (4096, 14336), "llama w_down": (14336, 4096),
             "phi3 wqkvo": (3072, 3072), "phi3 w_gate/w_up": (3072, 8192),
             "phi3 w_down": (8192, 3072), "odd K": (4112, 4096)}


@pytest.mark.parametrize("K,N", list(W8_SERVED.values()), ids=list(W8_SERVED))
def test_w8_matmul_rows_bit_equal_across_bodies(cuda, K, N):
    """bfloat16 at the served widths: rows alone are bit for bit the rows of
    calls of 8, 64, 65, 256 and 4,096 rows (decode body at 8 and 64 rows,
    prefill body above), each call within the row tolerance of the plain
    version."""
    x, w, s = _w8_inputs(cuda, 4096, K, N, torch.bfloat16)
    calls = {M: tquant.w8_matmul(x[:M], w, s) for M in (8, 64, 65, 256, 4096)}
    _close(calls[4096], tquant.w8_matmul_plain(x, w, s), torch.bfloat16)
    for r in (0, 5, 37, 63):
        one = tquant.w8_matmul(x[r:r + 1], w, s)[0]
        for M, out in calls.items():
            if r < M:
                assert torch.equal(one, out[r]), (r, M)


def test_w8_splits_kernel_equals_the_mirror(cuda):
    """The kernel's slice count is ``ops/quant.w8_splits``' at the served
    widths and at random multiples of 16."""
    fn = kernels.function("w8_splits")
    shapes = list(W8_SERVED.values()) + [(64, 32), (64, 128), (128, 64), (80, 48)]
    rng = np.random.default_rng(3)
    shapes += [(16 * int(k), 16 * int(n)) for k, n in rng.integers(1, 1200, size=(200, 2))]
    for K, N in shapes:
        assert fn(K, N) == len(tquant.w8_splits(K, N)), (K, N)


def _tiny_bf16_int8_engine(cfg, **kw):
    """An engine of ``cfg`` with bf16 activations and int8 weights (the
    W8A16 kernel's bf16 decode body in every captured window), weights
    drawn on the CPU."""
    from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig
    from llms_on_kubernetes_tpu_torch.models.decoder import init_params

    params = tquant.quantize_params(init_params(cfg, seed=0, dtype="bfloat16", device="cpu"))
    params = {k: ({n: w.to("cuda") for n, w in v.items()} if isinstance(v, dict)
                  else v.to("cuda")) for k, v in params.items()}
    base = dict(model="debug-tiny", dtype="bfloat16", max_decode_slots=4, page_size=4,
                num_pages=128, pages_per_slot=16, prefill_buckets=(16, 32), device="cuda")
    return Engine(EngineConfig(**{**base, **kw}), params=params, model_config=cfg)


def test_int8_weight_engines_of_two_widths_replay_in_turn(cuda):
    """Two int8-weight bf16 engines of different widths (so different W8A16
    shapes and slice counts), alive in one process, their windows replayed
    in turn with eager W8A16 calls of other shapes between steps, give the
    greedy streams each gives alone: a captured window holds nothing that a
    later call replaces."""
    import dataclasses

    from llms_on_kubernetes_tpu_torch.configs import get_config
    from llms_on_kubernetes_tpu_torch.engine.engine import SamplingParams

    tiny = get_config("debug-tiny")
    wide = dataclasses.replace(tiny, name="debug-wide", hidden_size=128,
                               intermediate_size=384, num_heads=4, num_kv_heads=2,
                               head_dim=32)
    prompts = [[3, 17, 9], [40, 2] * 9, [7] * 30, [5, 6]]
    sp = SamplingParams(max_tokens=24, temperature=0.0)
    alone = []
    for cfg in (tiny, wide):
        eng = _tiny_bf16_int8_engine(cfg)
        reqs = [eng.submit(p, sp) for p in prompts]
        while eng.has_work():
            eng.step()
        alone.append([r.output for r in reqs])
        del eng
    engines = [_tiny_bf16_int8_engine(cfg) for cfg in (tiny, wide)]
    others = [_w8_inputs(cuda, M, K, N, torch.bfloat16)
              for M, K, N in ((5, 320, 96), (64, 4112, 256), (300, 1024, 512))]
    before = kernels.LAUNCHES["w8_matmul"]
    reqs = [[e.submit(p, sp) for p in prompts] for e in engines]
    i = 0
    while any(e.has_work() for e in engines):
        for e in engines:
            if e.has_work():
                e.step()
                tquant.w8_matmul(*others[i % len(others)])
                i += 1
    assert [[r.output for r in rs] for rs in reqs] == alone
    assert all(e.graph_replays > 0 for e in engines)
    assert kernels.LAUNCHES["w8_matmul"] > before + i


def test_w8_matmul_refuses_what_the_kernel_does_not_take(cuda):
    x, w, s = _w8_inputs(cuda, 8, 64, 32, torch.bfloat16)
    for args, match in (((x, w.cpu(), s), "CUDA"), ((x, w, s.cpu()), "CUDA"),
                        ((x[:, ::2], w[::2], s), "contiguous"),
                        ((x.half(), w, s), "float32/bfloat16"),
                        ((x, w.float(), s), "int8"), ((x[:0], w, s), "M >= 1")):
        with pytest.raises(ValueError, match=match):
            tquant.w8_matmul(*args)
    x40, w40, s40 = _w8_inputs(cuda, 8, 40, 32, torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 16"):
        tquant.w8_matmul(x40, w40, s40)
    x2, w2, s2 = _w8_inputs(cuda, 8, 64, 40, torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 16"):
        tquant.w8_matmul(x2, w2, s2)


def test_quantize_on_the_card_equals_the_cpu(cuda):
    """``quantize`` divides by tensors: the card gives the CPU's bytes."""
    w = _t(cuda, 4, 256, 512) * 0.05
    w[1, :, 7] = 0.0
    for axes in ((1,), (1, 2)):
        a, b = tquant.quantize(w, axes), tquant.quantize(w.cpu(), axes)
        assert torch.equal(a.data.cpu(), b.data) and torch.equal(a.scale.cpu(), b.scale)


@pytest.mark.parametrize("kv_write", ["dus", "fused"])
def test_int8_weight_window_graph_replay_equals_the_eager_window(cuda, kv_write):
    """The window captured with int8-weight params (QTensor layer views and
    scales are captured addresses): every projection a W8A16 launch, and
    one replay byte-equal to the eager window (tokens, logprobs, pools,
    counts)."""
    from llms_on_kubernetes_tpu_torch.engine.cache import KVPool

    eng = _tiny_engine("cuda", quantized=True, kv_write=kv_write, async_scheduling=False)
    L, K = eng.model_config.num_layers, eng.config.decode_steps
    decode = "paged_decode_write" if kv_write == "fused" else "paged_decode"
    assert eng._window.launches == {decode: L * K, "w8_matmul": 7 * L * K}
    packed = _window_inputs(eng, [[3, 17, 9], [40, 2] * 9, [7] * 30], penalties=True)
    pools = [KVPool(p.data.clone(), None) for p in (eng.k_pages, eng.v_pages)]
    counts = eng.token_counts.clone()
    zeros = torch.zeros(eng.config.max_decode_slots, dtype=torch.int32, device="cuda")
    eager_pack, eager_toks = eng._window._eager(
        torch.from_numpy(packed).cuda(), zeros, zeros[:1], *pools, counts,
        workspace=pa.DecodeWorkspace())
    pack, toks = eng._window.run(packed, None, None)
    torch.cuda.synchronize()
    assert torch.equal(pack, eager_pack) and torch.equal(toks, eager_toks)
    assert torch.equal(eng.token_counts, counts)
    P = eng.config.num_pages
    keep = torch.ones(L * P, dtype=torch.bool, device="cuda")
    keep[::P] = False
    for got, want in zip((eng.k_pages, eng.v_pages), pools):
        assert torch.equal(got.data[:, keep], want.data[:, keep])


@pytest.mark.parametrize("async_scheduling", [True, False], ids=["async", "sync"])
def test_int8_weight_engine_equals_the_cpu(cuda, async_scheduling):
    """debug-tiny with int8 weights in float32: the card's greedy streams
    (W8A16 kernel, graphed windows) equal the CPU's (plain version)."""
    from llms_on_kubernetes_tpu_torch.engine.engine import SamplingParams

    prompts = [[3, 17, 9], [40, 2] * 9, [7] * 30, [5, 6], [(7 * i) % 251 for i in range(45)]]
    sp = SamplingParams(max_tokens=16, temperature=0.0)
    outs = {}
    for dev in ("cuda", "cpu"):
        eng = _tiny_engine(dev, quantized=True, async_scheduling=async_scheduling)
        reqs = [eng.submit(p, sp) for p in prompts]
        while eng.has_work():
            eng.step()
        outs[dev] = [(r.output, r.finish_reason) for r in reqs]
    assert outs["cuda"] == outs["cpu"]


# ---------------------------------------------------------------------------
# logit_bias in the graphed window, prompt scoring and the watchdog
# ---------------------------------------------------------------------------

BIASES = [((5, 100.0),), (), ((9, -100.0), (11, 3.0), (200, -2.5)),
          tuple((t, 0.25 * (t % 7) - 0.75) for t in range(100, 132))]


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32_kv", "int8_kv"])
def test_biased_window_graph_replay_equals_the_eager_window(cuda, kv_dtype):
    """Requests whose logit_bias arrives after the window was captured (with
    every row idle): the replay applies each row's bias, byte for byte as
    the eager window does, and +100 forces its token."""
    from llms_on_kubernetes_tpu_torch.engine.cache import KVPool
    from llms_on_kubernetes_tpu_torch.engine.engine import SamplingParams
    from llms_on_kubernetes_tpu_torch.engine.graphs import unpack_results

    eng = _tiny_engine("cuda", kv_cache_dtype=kv_dtype, async_scheduling=False)
    prompts = [[3, 17, 9], [40, 2] * 9, [7] * 30, [5, 6]]
    for p, b in zip(prompts, BIASES):
        eng.submit(p, SamplingParams(max_tokens=64, temperature=0.7, seed=5,
                                     presence_penalty=0.4, logit_bias=b))
    eng._admit()
    K = eng.config.decode_steps
    active = [(i, r) for i, r in enumerate(eng.slots) if r is not None]
    base = {i: int(eng.slot_len[i]) + 1 for i, _r in active}
    for i, _r in active:
        eng.allocator.allocate(i, base[i] + K - 1)
    packed = eng._window_rows(active, {i: K for i, _r in active}, base)
    pools = [KVPool(p.data.clone(), None if p.scale is None else p.scale.clone())
             for p in (eng.k_pages, eng.v_pages)]
    counts = eng.token_counts.clone()
    zeros = torch.zeros(eng.config.max_decode_slots, dtype=torch.int32, device="cuda")
    eager_pack, eager_toks = eng._window._eager(
        torch.from_numpy(packed).cuda(), zeros, zeros[:1], *pools, counts,
        workspace=pa.DecodeWorkspace())
    pack, toks = eng._window.run(packed, None, None)
    torch.cuda.synchronize()
    assert eng.graph_replays == 1
    assert torch.equal(pack, eager_pack) and torch.equal(toks, eager_toks)
    assert torch.equal(eng.token_counts, counts)
    tokens = unpack_results(pack.cpu().numpy())[0].reshape(K, -1)
    assert (tokens[:, 0] == 5).all()                     # forced in every step
    assert not (tokens[:, 2] == 9).any()                  # banned


@pytest.mark.parametrize("async_scheduling", [True, False], ids=["async", "sync"])
def test_biased_graphed_engine_equals_the_cpu(cuda, async_scheduling):
    """Greedy streams with per-request biases, submitted after the capture
    and joining a decoding batch: the card's (graph replays) equal the
    CPU's (eager)."""
    from llms_on_kubernetes_tpu_torch.engine.engine import SamplingParams

    prompts = [[3, 17, 9], [40, 2] * 9, [7] * 30, [5, 6], [(7 * i) % 251 for i in range(45)]]
    outs = {}
    for dev in ("cuda", "cpu"):
        eng = _tiny_engine(dev, async_scheduling=async_scheduling)
        reqs = [eng.submit(prompts[0], SamplingParams(max_tokens=24, temperature=0.0))]
        for _ in range(3):
            eng.step()
        reqs += [eng.submit(p, SamplingParams(max_tokens=16, temperature=0.0, logit_bias=b))
                 for p, b in zip(prompts[1:], BIASES)]
        while eng.has_work():
            eng.step()
        outs[dev] = [(r.output, r.finish_reason) for r in reqs]
        if dev == "cuda":
            assert eng.graph_replays * eng.config.decode_steps == eng.decode_forwards > 0
    assert outs["cuda"] == outs["cpu"]
    assert outs["cuda"][1][0] == [5] * 16


def test_forward_score_through_the_flash_kernel(cuda):
    """forward_score on the card (flash prefill, kernel 1, once a layer)
    equals the plain version on the CPU: logprobs within 1e-4, top ids
    exact; Engine.score_prompt on the card equals the CPU engine's."""
    from llms_on_kubernetes_tpu_torch.models.decoder import forward_score

    rng = np.random.default_rng(3)
    cpu = _tiny_engine("cpu")
    eng = _tiny_engine("cuda")
    toks = torch.from_numpy(rng.integers(0, 256, (1, 32)).astype(np.int32))
    n = torch.tensor([29], dtype=torch.int32)
    want = forward_score(cpu.params, cpu.model_config, toks, n, 8)
    before = kernels.launch_counts().get("flash_prefill", 0)
    got = forward_score(eng.params, eng.model_config, toks.cuda(), n.cuda(), 8)
    torch.cuda.synchronize()
    assert (kernels.launch_counts()["flash_prefill"] - before
            == eng.model_config.num_layers)
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-4, atol=1e-4)
    assert torch.equal(got[1].cpu(), want[1])
    torch.testing.assert_close(got[2].cpu(), want[2], rtol=1e-4, atol=1e-4)
    prompt = rng.integers(0, 256, 40).tolist()
    a, b = eng.score_prompt(prompt), cpu.score_prompt(prompt)
    np.testing.assert_allclose(a[0], b[0], rtol=1e-4, atol=1e-4)
    assert a[1] == b[1]


def test_watchdog_sheds_a_spinning_card(cuda):
    """A spin kernel on the engine's stream outlasts the watchdog budget:
    every request finishes "stalled", the engine wedges and refuses, and the
    process goes on once the spin ends."""
    from llms_on_kubernetes_tpu_torch.engine.engine import (
        EngineStallError, SamplingParams,
    )

    eng = _tiny_engine("cuda", watchdog_stall_s=0.2)
    eng._est_step = 1e-3
    reqs = [eng.submit(p, SamplingParams(max_tokens=32, temperature=0.0))
            for p in ([3, 17, 9], [40, 2] * 9)]
    torch.cuda._sleep(4_000_000_000)          # ~2 s at the H100's clock
    t0 = time.monotonic()
    while not all(r.finished for r in reqs):
        assert time.monotonic() - t0 < 30
        eng.step()
    assert [r.finish_reason for r in reqs] == ["stalled", "stalled"]
    assert eng.wedged and time.monotonic() - t0 < 2.0
    with pytest.raises(EngineStallError):
        eng.submit([1, 2], SamplingParams(max_tokens=2))
    torch.cuda.synchronize()


def test_deadline_abort_inside_a_captured_window_leaves_the_survivor_equal(cuda):
    """Two requests decode in graphed windows; one passes its deadline with
    windows in flight and is aborted "timeout". The survivor's stream is
    the one it gets alone on the card and on the CPU, every window stayed a
    replay, and every page came back."""
    from llms_on_kubernetes_tpu_torch.engine.engine import SamplingParams

    sp = SamplingParams(max_tokens=24, temperature=0.0)
    alone = {}
    for dev in ("cuda", "cpu"):
        eng = _tiny_engine(dev)
        alone[dev] = eng.generate([40, 2] * 9, sp)
    assert alone["cuda"] == alone["cpu"]
    eng = _tiny_engine("cuda")
    doomed = eng.submit([3, 17, 9], SamplingParams(max_tokens=200, temperature=0.0),
                        deadline=time.monotonic() + 3600)
    survivor = eng.submit([40, 2] * 9, sp)
    while len(doomed.output) < 5:
        eng.step()
    assert eng._inflight or eng.config.async_depth == 1
    doomed.deadline = time.monotonic() - 1.0
    eng.step()
    assert doomed.finished and doomed.finish_reason == "timeout" and doomed.slot == -1
    while eng.has_work():
        eng.step()
    assert survivor.output == alone["cuda"]
    assert eng.graph_replays * eng.config.decode_steps == eng.decode_forwards > 0
    alloc = eng.allocator
    assert alloc.num_free_pages + alloc.num_evictable_pages == eng.config.num_pages - 1


@pytest.mark.parametrize("cut", [1, 5, 11])
def test_seeded_resume_under_graphs_equals_the_uninterrupted_stream(cuda, cut):
    """A seeded stream with penalties, cut after ``cut`` tokens and resumed
    with that prefix (SamplingParams.prefix_tokens) in graphed windows, is
    the uninterrupted stream on the card token for token."""
    import dataclasses

    from llms_on_kubernetes_tpu_torch.engine.engine import SamplingParams

    sp = SamplingParams(max_tokens=16, temperature=0.9, top_k=20, seed=1234,
                        presence_penalty=0.5, frequency_penalty=0.3)
    prompt = [3, 17, 9, 5]
    full = _tiny_engine("cuda").generate(prompt, sp)
    eng = _tiny_engine("cuda")
    got = eng.generate(prompt, dataclasses.replace(sp, prefix_tokens=tuple(full[:cut])))
    assert got == full and len(full) == 16
    assert eng.graph_replays * eng.config.decode_steps == eng.decode_forwards > 0


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_spill_then_upload_round_trips_pool_bytes_on_the_card(cuda, kv_dtype):
    """The host tier on the card: a seated slot's full pages spill (gather
    on the stream, copy into the pinned ring, drained through the
    harvester) and, wiped on the card, upload back through the admission
    path: pool bytes (bf16 data, or int8 data and f32 scales) equal
    exactly before and after, and each payload holds its page's bytes."""
    from llms_on_kubernetes_tpu_torch.configs import get_config
    from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
    from llms_on_kubernetes_tpu_torch.models.decoder import init_params

    params = init_params(get_config("debug-tiny"), seed=0, dtype="bfloat16", device="cpu")
    params = {k: ({n: w.to("cuda") for n, w in v.items()} if isinstance(v, dict)
                  else v.to("cuda")) for k, v in params.items()}
    eng = Engine(EngineConfig(model="debug-tiny", dtype="bfloat16", kv_cache_dtype=kv_dtype,
                              max_decode_slots=4, page_size=4, num_pages=64, pages_per_slot=16,
                              prefill_buckets=(16, 32), device="cuda", kv_host_cache_gb=0.1),
                 params=params)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sides = [eng.k_pages.data, eng.v_pages.data]
    for t in sides:
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen, device="cuda",
                                  dtype=torch.int8))
        else:
            t.copy_(torch.randn(t.shape, generator=gen, device="cuda").to(t.dtype))
    if eng.k_pages.scale is not None:
        sides += [eng.k_pages.scale, eng.v_pages.scale]
        for t in sides[2:]:
            t.copy_(torch.rand(t.shape, generator=gen, device="cuda"))
    req = eng.submit(list(range(1, 30)), SamplingParams(max_tokens=4, temperature=0.0))
    with eng._lock:
        slot = eng._seat_next([])[0]
    eng.slot_len[slot] = 29                          # 7 full pages of 4
    pages = list(eng.allocator.slot_pages[slot][:7])
    L = eng.cache_config.num_layers
    idx = torch.from_numpy(eng._flat_pages(pages)).to("cuda")

    def raw(t):
        g = t.index_select(1, idx).cpu()
        return (g.view(torch.int16) if g.dtype == torch.bfloat16 else g).numpy()

    before = [raw(t) for t in sides]
    eng._spill_slot(req)
    assert eng._spill_ring is not None and eng._spill_ring[0].is_pinned()
    eng._drain_spills()
    assert eng.host_kv.spilled_pages == 7
    digests = eng.allocator._digests(req.prompt[:28])
    matched, payloads = eng.host_kv.match_chain("", digests, 0)
    assert matched == digests
    # the tier holds pageable memory of its own, not pinned ring memory
    assert not any(torch.from_numpy(pl[key]).is_pinned() for pl in payloads
                   for key in ("k", "v"))
    for j, pl in enumerate(payloads):
        for b, key in zip(before, ("k", "v", "ks", "vs")):
            assert pl[key].tobytes() == np.ascontiguousarray(
                b[:, j * L:(j + 1) * L]).tobytes()
    for t in sides:
        t.index_fill_(1, idx, 0)
    assert not any(np.array_equal(raw(t), b) for t, b in zip(sides, before))
    eng._host_adopt[slot] = (0, matched, payloads)
    eng._host_kv_commit(slot, req)
    for t, b in zip(sides, before):
        assert np.array_equal(raw(t), b)
    assert eng.kv_uploaded_tokens == 28 and eng.host_kv.hits == 7
    eng.abort(req)
    while eng.has_work():
        eng.step()


# ---------------------------------------------------------------------------
# speculative decoding (the verify graph, the draft rollout) and GGUF
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32_kv", "int8_kv"])
def test_verify_graph_replay_equals_the_eager_verify(cuda, kv_dtype):
    """One verify replayed (captured at its first call) and one run
    eagerly from copies of one pool and one penalty-count table: the
    drafts of even rows pinned (all accepted), of odd rows random (rejected
    at once); packed results with the accept counts, pools (outside the
    trash pages) and counts byte-equal, and the verify's launches num_layers
    window-kernel launches, all by the replay."""
    from llms_on_kubernetes_tpu_torch.engine.cache import KVPool
    from llms_on_kubernetes_tpu_torch.engine.engine import SamplingParams
    from llms_on_kubernetes_tpu_torch.engine.graphs import unpack_accept, verify_rows

    eng = _tiny_engine("cuda", kv_cache_dtype=kv_dtype, async_scheduling=False,
                       speculation="ngram")
    prompts = [[3, 17, 9], [40, 2] * 9, [7] * 30, [5, 6]]
    pins = [11, 12, 13, 14]
    for i, p in enumerate(prompts):
        eng.submit(p, SamplingParams(max_tokens=64, temperature=0.7, seed=5 + i,
                                     presence_penalty=0.4, frequency_penalty=0.3,
                                     logit_bias=((pins[i], 90.0),) if i % 2 == 0 else ()))
    eng._admit()
    K = eng.config.decode_steps
    active = [(i, r) for i, r in enumerate(eng.slots) if r is not None]
    base = {i: int(eng.slot_len[i]) + 1 for i, _r in active}
    for i, _r in active:
        eng.allocator.allocate(i, base[i] + K - 1)
    packed = eng._window_rows(active, {i: K for i, _r in active}, base)
    drafts = np.array([[pins[i]] * (K - 1) if i % 2 == 0 else [200, 201, 202][:K - 1]
                       for i in range(4)], np.int32)
    full = verify_rows(packed, drafts)
    pools = [KVPool(p.data.clone(), None if p.scale is None else p.scale.clone())
             for p in (eng.k_pages, eng.v_pages)]
    counts = eng.token_counts.clone()
    eager_pack, eager_toks = eng._window._eager_verify(torch.from_numpy(full).cuda(), *pools,
                                                       counts)
    kernels.reset_launches()
    pack, toks = eng._window.run_verify(full)
    torch.cuda.synchronize()
    assert eng.verify_replays == 1 and eng.graph_replays == 0
    assert torch.equal(pack, eager_pack) and torch.equal(toks, eager_toks)
    assert torch.equal(eng.token_counts, counts)
    P = eng.config.num_pages
    keep = torch.ones(eng.model_config.num_layers * P, dtype=torch.bool, device="cuda")
    keep[::P] = False
    for got, want in zip((eng.k_pages, eng.v_pages), pools):
        assert torch.equal(got.data[:, keep], want.data[:, keep])
        if want.scale is not None:
            assert torch.equal(got.scale[:, keep], want.scale[:, keep])
    accept = unpack_accept(pack.cpu().numpy(), 4)[1]
    assert accept.tolist()[0::2] == [K, K] and max(accept.tolist()[1::2]) <= 1
    window = "paged_write_window_int8" if kv_dtype else "paged_write_window"
    L = eng.model_config.num_layers
    assert kernels.launch_counts() == kernels.replayed_counts() == {window: L}


def test_graphed_speculation_equals_the_cpu(cuda):
    """The async engine with prompt-lookup speculation on the card (verify
    graphs) gives the CPU engine's streams, pinned and free rows mixed."""
    from llms_on_kubernetes_tpu_torch.engine.engine import SamplingParams

    prompts = [[1, 2, 3, 42, 42, 42], [5, 6, 7, 5, 6, 7, 5, 6], [40, 2] * 9]
    sps = [SamplingParams(max_tokens=20, temperature=0.0, logit_bias=((42, 90.0),)),
           SamplingParams(max_tokens=20, temperature=0.0),
           SamplingParams(max_tokens=20, temperature=0.0)]
    outs = {}
    for dev in ("cuda", "cpu"):
        eng = _tiny_engine(dev, speculation="ngram")
        reqs = [eng.submit(p, sp) for p, sp in zip(prompts, sps)]
        while eng.has_work():
            eng.step()
        outs[dev] = [(r.output, r.finish_reason) for r in reqs]
        assert eng.spec_dispatches > 0
        if dev == "cuda":
            assert eng.verify_replays == eng.spec_dispatches
    assert outs["cuda"] == outs["cpu"]


def test_draft_rollout_replays_equal_the_cpu_drafts(cuda):
    """The draft model's rollout captured as one graph: its drafts on the
    card equal the CPU's (float32, same weights), one replay a group."""
    from llms_on_kubernetes_tpu_torch.configs import get_config
    from llms_on_kubernetes_tpu_torch.engine.speculation import DraftModelDrafter
    from llms_on_kubernetes_tpu_torch.models.decoder import init_params

    cfg = get_config("debug-tiny")
    host = init_params(cfg, seed=0, dtype="float32", device="cpu")
    dev = {k: ({n: w.cuda() for n, w in v.items()} if isinstance(v, dict) else v.cuda())
           for k, v in host.items()}
    ctxs = [np.arange(1, 70, dtype=np.int32) % 251, None, np.array([5, 6, 7] * 4, np.int32)]
    want = DraftModelDrafter(host, cfg, max_draft=3).propose_batch(ctxs, 3)
    d = DraftModelDrafter(dev, cfg, max_draft=3)
    for _ in range(2):
        got = d.propose_batch(ctxs, 3)
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert d.replays == 2 and d.launches["flash_prefill"] == cfg.num_layers


def test_gguf_upload_equals_the_host_values(cuda, tmp_path):
    """load_gguf_params onto the card: every tensor equals the file's
    dequantized host values cast to the dtype, bit for bit; int8 weights
    equal the CPU quantization of those values."""
    from llms_on_kubernetes_tpu_torch.engine.gguf import GGUFFile, gguf_layer, load_gguf_params
    from llms_on_kubernetes_tpu_torch.testing import synth_gguf as S

    spec = dict(S.PRESETS["phi-3-mini"], hidden=64, layers=2, heads=4, kv_heads=4,
                head_dim=16, ffn=256, vocab=1024, tokenizer=None)
    path = str(tmp_path / "m.gguf")
    S.write_model(path, spec, seed=2)
    for dtype in (torch.float32, torch.bfloat16):
        cfg, params = load_gguf_params(path, dtype=str(dtype).split(".")[1], device="cuda")
        gf = GGUFFile(path)
        for i in range(cfg.num_layers):
            for name, want in gguf_layer(gf, cfg, i).items():
                w = torch.from_numpy(np.ascontiguousarray(want)).to(dtype)
                assert torch.equal(params["layers"][name][i].cpu(), w), name
        for name, t in (("embed", "token_embd.weight"), ("final_norm", "output_norm.weight")):
            assert torch.equal(params[name].cpu(), torch.from_numpy(gf.tensor(t)).to(dtype))
        assert torch.equal(params["lm_head"].cpu(),
                           torch.from_numpy(np.ascontiguousarray(
                               gf.tensor("output.weight").T)).to(dtype))
        gf.close()
    _, q_card = load_gguf_params(path, dtype="float32", quantization="int8", device="cuda")
    _, q_cpu = load_gguf_params(path, dtype="float32", quantization="int8", device="cpu")
    for name, w in q_cpu["layers"].items():
        if isinstance(w, tquant.QTensor):
            assert torch.equal(q_card["layers"][name].data.cpu(), w.data)
            assert torch.equal(q_card["layers"][name].scale.cpu(), w.scale)


# ---------------------------------------------------------------------------
# the W4A16 kernel (csrc/w4_matmul.cu), AWQ checkpoints and LoRA on the card
# ---------------------------------------------------------------------------

def _w4_inputs(rng, M, K, N, gs, dtype, packed=True):
    x = _t(rng, M, K, dtype=dtype)
    G = K // gs
    vals = torch.from_numpy(rng.integers(-8, 8, size=(G, gs, N)).astype(np.int8))
    data = (tquant.pack_int4_lanes(vals) if packed else vals).cuda()
    s = (rng.uniform(0.8, 1.2, size=(G, N)) / (4.6 * np.sqrt(K))).astype(np.float32)
    z = rng.integers(6, 10, size=(G, N)).astype(np.float32) - 8
    return x, data, torch.from_numpy(s).cuda(), torch.from_numpy(s * z).cuda()


# M on both bf16 bodies (decode up to 64 rows, prefill above: 64 and 65
# straddle them), groups of 16 to 256 rows, N off the 128-column slab (16,
# 48, 144, 1,040) and K of one group; float32 at small K only (1e-4 is the
# summation order's error there)
W4_SHAPES = [(dt, *shape, packed) for shape in [(1, 64, 32, 16), (5, 256, 48, 32),
                                                (17, 256, 64, 128), (70, 384, 96, 128),
                                                (300, 512, 160, 256), (64, 64, 16, 64),
                                                (65, 128, 1040, 128), (3, 16, 48, 16)]
             for dt in (torch.float32, torch.bfloat16) for packed in (True, False)]
W4_SHAPES += [(torch.bfloat16, 8, 4096, 1024, 128, True),
              (torch.bfloat16, 300, 4096, 12288, 128, True),
              (torch.bfloat16, 64, 12288, 4096, 128, True),
              (torch.bfloat16, 65, 12288, 4096, 128, True),
              (torch.bfloat16, 64, 512, 1040, 16, True),
              (torch.bfloat16, 65, 384, 144, 64, False)]


@pytest.mark.parametrize("dtype,M,K,N,gs,packed", W4_SHAPES)
def test_w4_matmul_matches_plain(cuda, dtype, M, K, N, gs, packed):
    x, data, s, zs = _w4_inputs(cuda, M, K, N, gs, dtype, packed)
    before = kernels.LAUNCHES["w4_matmul"]
    out = tquant.w4_matmul(x, data, s, zs, packed)
    ref = tquant.group_qeinsum_plain(x, data, s, zs, packed)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["w4_matmul"] == before + 1
    assert out.dtype == dtype and tuple(out.shape) == (M, N)
    _close(out, ref, dtype)


@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096)],
                         ids=["wq/wo", "wk/wv", "w_gate/w_up", "w_down"])
def test_w4_matmul_rows_do_not_depend_on_m(cuda, K, N):
    """Batch invariance at Qwen3-8B's projections (group 128): rows alone
    are bit for bit the rows of calls of 8, 17, 64, 65, 256 and 4,096 rows
    (the decode and prefill bodies); packed and int8 storage give the same
    bits."""
    x, data, s, zs = _w4_inputs(cuda, 4096, K, N, 128, torch.bfloat16)
    calls = {M: tquant.w4_matmul(x[:M], data, s, zs, True) for M in (8, 17, 64, 65, 256, 4096)}
    for r in (0, 5, 37, 63):
        one = tquant.w4_matmul(x[r:r + 1], data, s, zs, True)[0]
        for M, out in calls.items():
            if r < M:
                assert torch.equal(one, out[r]), (r, M)
    for M in (64, 65, 256):
        assert torch.equal(calls[M], calls[4096][:M]), M
    wide = tquant.unpack_int4_lanes(data).contiguous()
    assert torch.equal(tquant.w4_matmul(x[:64], wide, s, zs, False), calls[64])
    assert torch.equal(tquant.w4_matmul(x[:65], wide, s, zs, False), calls[65])


@pytest.mark.parametrize("K,N,gs", [(64, 16, 64), (256, 48, 32), (128, 1040, 128),
                                    (512, 1040, 16), (16, 48, 16)])
def test_w4_matmul_rows_bit_equal_across_bodies_at_narrow_shapes(cuda, K, N, gs):
    """N off the slab, small groups, K of one group: calls of 1 to 300 rows
    (the decode body) are the first rows of a call on the prefill body (at
    least 256 blocks of 128 x 128: csrc/w4_matmul.cu kMinPrefillBlocks), bit
    for bit."""
    Mp = 128 * -(-256 // -(-N // 128))
    x, data, s, zs = _w4_inputs(cuda, Mp, K, N, gs, torch.bfloat16)
    full = tquant.w4_matmul(x, data, s, zs, True)
    _close(full, tquant.group_qeinsum_plain(x, data, s, zs, True), torch.bfloat16)
    for M in (1, 8, 16, 33, 64, 65, 300):
        assert torch.equal(tquant.w4_matmul(x[:M], data, s, zs, True), full[:M]), M


@pytest.mark.parametrize("M", [8, 256])
def test_w4_matmul_is_one_kernel_node_and_no_workspace(cuda, M):
    """A call captured in a CUDA graph is one kernel node whose replay
    gives the eager call's bits, and the wrapper allocates nothing but the
    output."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from chip_smoke import graph_nodes

    x, data, s, zs = _w4_inputs(cuda, M, 4096, 12288, 128, torch.bfloat16)
    want = tquant.w4_matmul(x, data, s, zs, True)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = tquant.w4_matmul(x, data, s, zs, True)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before == -(-got.numel() * 2 // 512) * 512
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tquant.w4_matmul(x, data, s, zs, True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)   # its nodes stay readable
    with torch.cuda.graph(graph):
        out = tquant.w4_matmul(x, data, s, zs, True)
    graph.instantiate()
    graph.replay()
    torch.cuda.synchronize()
    assert graph_nodes(graph) == {"kernel": 1}
    assert torch.equal(out, want)


def test_w4_splits_kernel_equals_the_mirror(cuda):
    fn = kernels.function("w4_splits")
    rng = np.random.default_rng(4)
    shapes = [(4096, 4096, 128), (4096, 1024, 128), (4096, 12288, 128), (12288, 4096, 128)]
    shapes += [(int(g) * gs, 16 * int(n), gs) for g, n, gs in zip(
        rng.integers(1, 200, 200), rng.integers(1, 1000, 200),
        rng.choice([16, 32, 64, 128, 256], 200))]
    for K, N, gs in shapes:
        assert fn(K, N, gs) == len(tquant.w4_splits(K, N, gs)), (K, N, gs)


def test_w4_matmul_refuses_what_it_does_not_take(cuda):
    x, data, s, zs = _w4_inputs(cuda, 8, 256, 64, 32, torch.bfloat16)
    for args in ((x, data.cpu(), s, zs, True), (x[:, ::2], data, s, zs, True),
                 (x.half(), data, s, zs, True), (x, data, s.double(), zs, True)):
        with pytest.raises(ValueError):
            tquant.w4_matmul(*args)
    x24, d24, s24, z24 = _w4_inputs(cuda, 8, 240, 64, 24, torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 16"):
        tquant.w4_matmul(x24, d24, s24, z24, True)


def test_awq_checkpoint_loads_on_the_card_as_on_the_cpu(cuda, tmp_path):
    """The loader's unpack on the card gives the CPU loader's bytes."""
    from llms_on_kubernetes_tpu_torch.configs import get_config
    from llms_on_kubernetes_tpu_torch.engine.weights import load_hf_params
    from llms_on_kubernetes_tpu_torch.testing.synth_checkpoint import write_checkpoint

    cfg = get_config("debug-tiny")
    write_checkpoint(cfg, str(tmp_path), quantization="awq", group_size=32)
    card = load_hf_params(cfg, str(tmp_path), device="cuda", quantization="awq")
    host = load_hf_params(cfg, str(tmp_path), device="cpu", quantization="awq")
    for name, w in host["layers"].items():
        if isinstance(w, tquant.GroupQTensor):
            for part in ("data", "scale", "zero_scaled"):
                assert torch.equal(getattr(card["layers"][name], part).cpu(),
                                   getattr(w, part)), (name, part)


def test_lora_window_replays_equal_the_cpu_engine(cuda, tmp_path):
    """A float32 debug-tiny engine with three adapters on two slots on the
    card (every window a graph replay, uploads into the captured stacks)
    gives the CPU engine's greedy streams, alone and in a mixed batch, and
    captures no graph for an upload."""
    from llms_on_kubernetes_tpu_torch.configs import get_config
    from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
    from llms_on_kubernetes_tpu_torch.models.decoder import init_params
    from llms_on_kubernetes_tpu_torch.testing.synth_adapter import write_peft

    cfg = get_config("debug-tiny")
    dirs = {f"ad{i}": write_peft(tmp_path / f"ad{i}", cfg, rank=2, alpha=16, seed=10 + i)
            for i in range(3)}
    kw = dict(model="debug-tiny", dtype="float32", max_decode_slots=4, page_size=16,
              pages_per_slot=8, num_pages=33, prefill_buckets=(16,), adapters=dirs,
              adapter_slots=2, adapter_rank=4)
    host = init_params(cfg, seed=0, dtype="float32", device="cpu")
    dev = {k: (v.cuda() if torch.is_tensor(v) else {n: t.cuda() for n, t in v.items()})
           for k, v in host.items()}
    cpu_eng = Engine(EngineConfig(**kw, device="cpu"), params=host)
    card_eng = Engine(EngineConfig(**kw, device="cuda"), params=dev)

    def captures():
        return sum(kind.startswith("graph:") for kind, _s in kernels.COMPILES)

    captured = captures()
    sp = SamplingParams(temperature=0.0, max_tokens=8)
    prompt = [3, 17, 9, 42, 7]
    for a in (None, "ad0", "ad1", "ad2", "ad0"):
        assert card_eng.generate(prompt, sp, adapter=a) == cpu_eng.generate(prompt, sp,
                                                                             adapter=a), a
    reqs = [card_eng.submit(prompt, sp, adapter=a) for a in ("ad1", None, "ad2")]
    while any(not r.finished for r in reqs):
        card_eng.step()
    assert [r.output for r in reqs] == [cpu_eng.generate(prompt, sp, adapter=a)
                                        for a in ("ad1", None, "ad2")]
    assert card_eng.graph_replays > 0 and captures() == captured
    assert card_eng.adapters.stats["evictions"] >= 2


# ---------------------------------------------------------------------------
# the MoE expert kernel (csrc/moe_experts.cu) at Qwen3-30B-A3B's widths
# ---------------------------------------------------------------------------

def _moe_weights(E=128, D=2048, F=768, seed=0):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def w(*shape, scale):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

    return w(E, D, F, scale=D ** -0.5), w(E, D, F, scale=D ** -0.5), w(E, F, D, scale=F ** -0.5)


def _moe_rows(rng, R, E, N):
    """R expert-major rows: each names a random token of N and a random
    expert, rows sorted by expert. Returns (src, counts, experts)."""
    experts = np.sort(rng.integers(0, E, size=R))
    counts = np.bincount(experts, minlength=E).astype(np.int32)
    src = rng.integers(0, N, size=R).astype(np.int32)
    return torch.from_numpy(src).cuda(), torch.from_numpy(counts).cuda(), experts


@pytest.mark.parametrize("R", [1, 8, 64, 512, 32768])
def test_moe_experts_kernel_matches_plain(cuda, R):
    from llms_on_kubernetes_tpu_torch.ops import moe

    wg, wu, wd = _moe_weights()
    N = max(1, R // 8)
    x = _t(cuda, N, 2048, dtype=torch.bfloat16)
    src, counts, _ = _moe_rows(cuda, R, 128, N)
    got = moe.moe_experts(x, src, counts, wg, wu, wd)
    want = moe.moe_experts_plain(x, src, counts, wg, wu, wd)
    torch.cuda.synchronize()
    _close(got, want, torch.bfloat16)


def test_moe_experts_rows_bit_equal_across_R(cuda):
    """A row's output is the same bits alone (R 1) and among 512 and
    32,768 rows, wherever it falls in its tile."""
    from llms_on_kubernetes_tpu_torch.ops import moe

    wg, wu, wd = _moe_weights()
    N = 4096
    x = _t(cuda, N, 2048, dtype=torch.bfloat16)
    for R in (512, 32768):
        src, counts, experts = _moe_rows(cuda, R, 128, N)
        many = moe.moe_experts(x, src, counts, wg, wu, wd).clone()
        for r in (0, 1, R // 3, R - 1):
            one = torch.zeros(128, dtype=torch.int32, device="cuda")
            one[int(experts[r])] = 1
            alone = moe.moe_experts(x, src[r:r + 1].contiguous(), one, wg, wu, wd)
            assert torch.equal(alone[0], many[r]), (R, r)


@pytest.mark.parametrize("R,N", [(1, 1), (8, 4), (32, 16), (40, 20), (128, 64), (300, 150),
                                 (2048, 1024)])
def test_moe_experts_every_tile_size_at_debug_moe_widths(cuda, R, N):
    """debug-moe's widths (D 64, F 96: a partial column tile, K slices of
    32 rows) in 8- to 128-row tiles (R 1 to 2,048): within the bf16 row
    tolerance, and rows alone (8-row tiles) bit-equal to them."""
    from llms_on_kubernetes_tpu_torch.ops import moe

    wg, wu, wd = _moe_weights(E=4, D=64, F=96)
    x = _t(cuda, N, 64, dtype=torch.bfloat16)
    src, counts, experts = _moe_rows(cuda, R, 4, N)
    got = moe.moe_experts(x, src, counts, wg, wu, wd).clone()
    _close(got, moe.moe_experts_plain(x, src, counts, wg, wu, wd), torch.bfloat16)
    for r in sorted({0, R // 2, R - 1}):
        one = torch.zeros(4, dtype=torch.int32, device="cuda")
        one[int(experts[r])] = 1
        alone = moe.moe_experts(x, src[r:r + 1].contiguous(), one, wg, wu, wd)
        assert torch.equal(alone[0], got[r]), (R, r)


def test_moe_experts_rows_bit_equal_across_tiles_at_qwen3_widths(cuda):
    """512 rows over 64 tokens and 128 experts run in 16-row tiles (four
    times an expert's even share); a row alone (8-row tiles) gives the same
    bits."""
    from llms_on_kubernetes_tpu_torch.ops import moe

    wg, wu, wd = _moe_weights()
    x = _t(cuda, 64, 2048, dtype=torch.bfloat16)
    src, counts, experts = _moe_rows(cuda, 512, 128, 64)
    assert moe.moe_rows(512, 64, 128) == 16 and moe.moe_rows(1, 64, 128) == 8
    many = moe.moe_experts(x, src, counts, wg, wu, wd).clone()
    _close(many, moe.moe_experts_plain(x, src, counts, wg, wu, wd), torch.bfloat16)
    for r in (0, 1, 170, 511):
        one = torch.zeros(128, dtype=torch.int32, device="cuda")
        one[int(experts[r])] = 1
        alone = moe.moe_experts(x, src[r:r + 1].contiguous(), one, wg, wu, wd)
        assert torch.equal(alone[0], many[r]), r


def test_moe_kernel_split_and_tile_equal_their_mirrors(cuda):
    """The kernel's K split and tile size are ``ops/moe``'s mirrors, at
    every registry MoE width and at R across the tile sizes."""
    from llms_on_kubernetes_tpu_torch import configs
    from llms_on_kubernetes_tpu_torch.ops import moe

    splits, rows = kernels.function("moe_splits"), kernels.function("moe_rows")
    for c in configs.REGISTRY.values():
        if c.num_experts:
            D, F = c.hidden_size, c.intermediate_size
            for K, Nw in ((D, 2 * F), (F, D)):
                assert splits(K, Nw) == len(moe.moe_splits(K, Nw)), (c.name, K, Nw)
    for R, N, E in [(1, 1, 128), (8, 1, 128), (64, 8, 128), (65, 65, 8), (512, 64, 128),
                    (512, 4096, 128), (32768, 4096, 128), (16, 8, 8), (8192, 4096, 8)]:
        assert rows(R, N, E) == moe.moe_rows(R, N, E), (R, N, E)


def test_moe_block_on_the_card_equals_its_plain_parts(cuda):
    """Routing, the kernel and the combine on the card against the same
    route through moe_experts_plain, with padding rows (valid False)."""
    from llms_on_kubernetes_tpu_torch.ops import moe

    wg, wu, wd = _moe_weights()
    N = 96
    x = _t(cuda, N, 2048, dtype=torch.bfloat16)
    router = _t(cuda, 2048, 128, dtype=torch.bfloat16) * 2048 ** -0.5
    valid = torch.arange(N, device="cuda") < 80
    ws = moe.MoEWorkspace(N * 8, 2048, 768, torch.bfloat16, torch.device("cuda"))
    got = moe.moe_block(x, router, wg, wu, wd, top_k=8, valid=valid, workspace=ws)
    route = moe.moe_route(x, router, top_k=8, valid=valid)
    want = moe.moe_combine(moe.moe_experts_plain(x, route.src, route.counts, wg, wu, wd), route)
    torch.cuda.synchronize()
    assert not got[80:].any()
    _close(got[:80], want[:80], torch.bfloat16)


def test_moe_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from llms_on_kubernetes_tpu_torch.ops import moe

    wg, wu, wd = _moe_weights(E=4, D=64, F=96)
    x = _t(cuda, 4, 64, dtype=torch.bfloat16)
    src = torch.zeros(8, dtype=torch.int32, device="cuda")
    counts = torch.tensor([8, 0, 0, 0], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        moe.moe_experts(x.float(), src, counts, wg, wu, wd)
    with pytest.raises(ValueError):
        moe.moe_experts(x, src, counts, wg, wu, wd, act=torch.nn.functional.gelu)
    wg2, wu2, wd2 = _moe_weights(E=4, D=64, F=80)
    with pytest.raises(ValueError):
        moe.moe_experts(x, src, counts, wg2, wu2, wd2)
    got = moe.moe_experts(x, src, counts, wg, wu, wd)        # F 96: a partial column tile
    _close(got, moe.moe_experts_plain(x, src, counts, wg, wu, wd), torch.bfloat16)


# ---------------------------------------------------------------------------
# the int8 expert kernel (csrc/moe_experts_w8.cu): QTensor stacks quantized
# per (expert, output column), as the JAX quantize_params quantizes them
# ---------------------------------------------------------------------------

def _moe_w8(E=128, D=2048, F=768, seed=0):
    return tuple(tquant.quantize(w, (1,)) for w in _moe_weights(E, D, F, seed))


@pytest.mark.parametrize("R", [1, 8, 64, 512])
def test_moe_experts_w8_kernel_matches_plain(cuda, R):
    """The int8 kernel against moe_experts_plain on the same stacks (each
    product with qeinsum's two roundings), one launch a gate/up and one a
    down pass."""
    from llms_on_kubernetes_tpu_torch.ops import moe

    qg, qu, qd = _moe_w8()
    N = max(1, R // 8)
    x = _t(cuda, N, 2048, dtype=torch.bfloat16)
    src, counts, _ = _moe_rows(cuda, R, 128, N)
    before = kernels.LAUNCHES["moe_experts_w8"]
    got = moe.moe_experts(x, src, counts, qg, qu, qd)
    want = moe.moe_experts_plain(x, src, counts, qg, qu, qd)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["moe_experts_w8"] == before + 2
    _close(got, want, torch.bfloat16)


def test_moe_experts_w8_rows_bit_equal_across_R(cuda):
    """A row's output is the same bits alone (R 1, 8-row tiles) and among
    64 and 512 rows (tiles of up to 128 rows), wherever it falls in its
    tile."""
    from llms_on_kubernetes_tpu_torch.ops import moe

    qg, qu, qd = _moe_w8()
    x = _t(cuda, 512, 2048, dtype=torch.bfloat16)
    for R, N in ((64, 8), (512, 64), (512, 512)):
        src, counts, experts = _moe_rows(cuda, R, 128, N)
        many = moe.moe_experts(x[:N], src, counts, qg, qu, qd).clone()
        for r in (0, 1, R // 3, R - 1):
            one = torch.zeros(128, dtype=torch.int32, device="cuda")
            one[int(experts[r])] = 1
            alone = moe.moe_experts(x[:N], src[r:r + 1].contiguous(), one, qg, qu, qd)
            assert torch.equal(alone[0], many[r]), (R, N, r)


@pytest.mark.parametrize("R,N", [(1, 1), (40, 20), (300, 150)])
def test_moe_experts_w8_at_debug_moe_widths(cuda, R, N):
    """debug-moe's widths (D 64, F 96: a partial column tile, so scales past
    N are never read into a stored row; K slices of 32 rows)."""
    from llms_on_kubernetes_tpu_torch.ops import moe

    qg, qu, qd = _moe_w8(E=4, D=64, F=96)
    x = _t(cuda, N, 64, dtype=torch.bfloat16)
    src, counts, experts = _moe_rows(cuda, R, 4, N)
    got = moe.moe_experts(x, src, counts, qg, qu, qd).clone()
    _close(got, moe.moe_experts_plain(x, src, counts, qg, qu, qd), torch.bfloat16)
    for r in sorted({0, R // 2, R - 1}):
        one = torch.zeros(4, dtype=torch.int32, device="cuda")
        one[int(experts[r])] = 1
        alone = moe.moe_experts(x, src[r:r + 1].contiguous(), one, qg, qu, qd)
        assert torch.equal(alone[0], got[r]), (R, r)


def test_moe_block_int8_on_the_card_equals_its_plain_parts(cuda):
    from llms_on_kubernetes_tpu_torch.ops import moe

    qg, qu, qd = _moe_w8()
    N = 96
    x = _t(cuda, N, 2048, dtype=torch.bfloat16)
    router = _t(cuda, 2048, 128, dtype=torch.bfloat16) * 2048 ** -0.5
    valid = torch.arange(N, device="cuda") < 80
    ws = moe.MoEWorkspace(N * 8, 2048, 768, torch.bfloat16, torch.device("cuda"))
    got = moe.moe_block(x, router, qg, qu, qd, top_k=8, valid=valid, workspace=ws)
    route = moe.moe_route(x, router, top_k=8, valid=valid)
    want = moe.moe_combine(moe.moe_experts_plain(x, route.src, route.counts, qg, qu, qd), route)
    torch.cuda.synchronize()
    assert not got[80:].any()
    _close(got[:80], want[:80], torch.bfloat16)


def test_moe_experts_w8_refuses_what_the_kernel_does_not_take(cuda):
    from llms_on_kubernetes_tpu_torch.ops import moe

    wg, wu, wd = _moe_weights(E=4, D=64, F=96)
    qg, qu, qd = (tquant.quantize(w, (1,)) for w in (wg, wu, wd))
    x = _t(cuda, 4, 64, dtype=torch.bfloat16)
    src = torch.zeros(8, dtype=torch.int32, device="cuda")
    counts = torch.tensor([8, 0, 0, 0], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        moe.moe_experts(x.float(), src, counts, qg, qu, qd)
    with pytest.raises(ValueError):
        moe.moe_experts(x, src, counts, qg, wu, wd)          # mixed stacks
    with pytest.raises(ValueError):
        moe.moe_experts(x, src, counts, qg, qu,
                        tquant.QTensor(qd.data, qd.scale.reshape(4, 64, 1)))


def _image_groups(T, runs):
    g = torch.full((2, T), -1, dtype=torch.int32)
    for b, row in enumerate(runs):
        for i, (s, n) in enumerate(row):
            g[b, s:s + n] = i
    return g.cuda()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("runs", [[[(5, 16)], [(70, 40)]],
                                  [[(3, 20), (60, 64), (140, 16)], [(0, 64), (64, 64)]]])
def test_flash_prefill_image_groups_match_plain(cuda, dtype, window, d, runs):
    """Kernel 1 with gemma-3's image blocks: keys of the query's own image
    are visible past the causal and window tests (runs that start before a
    tile, end past one, sit back to back and fill whole tiles), both
    bodies, against the plain mask; all-text groups give the bits of
    mm_groups=None."""
    T = 192
    q, k, v = (_t(cuda, 2, T, h, d, dtype=dtype) for h in (8, 2, 2))
    lengths = torch.tensor([180, 150], dtype=torch.int32, device="cuda")
    groups = _image_groups(T, runs)
    kw = dict(scale=d ** -0.5, sliding_window=window)
    before = kernels.LAUNCHES["flash_prefill"]
    out = fa.flash_prefill_attention(q, k, v, lengths, mm_groups=groups, **kw)
    ref = fa.prefill_attention_plain(q, k, v, lengths, mm_groups=groups, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_prefill"] == before + 1
    _close(out[0, :180], ref[0, :180], dtype)
    _close(out[1, :150], ref[1, :150], dtype)
    text = torch.full_like(groups, -1)
    assert torch.equal(fa.flash_prefill_attention(q, k, v, lengths, mm_groups=text, **kw),
                       fa.flash_prefill_attention(q, k, v, lengths, **kw))
    # spans the caller computed once give the same bits
    assert torch.equal(out, fa.flash_prefill_attention(
        q, k, v, lengths, mm_groups=groups, group_spans=fa.mm_spans(groups), **kw))


def test_flash_prefill_image_groups_refused_shapes(cuda):
    q, k, v = (_t(cuda, 1, 64, h, 16, dtype=torch.bfloat16) for h in (4, 2, 2))
    lengths = torch.tensor([64], dtype=torch.int32, device="cuda")
    for bad in (torch.zeros((1, 32), dtype=torch.int32, device="cuda"),
                torch.zeros((1, 64), dtype=torch.int64, device="cuda"),
                torch.zeros((1, 64), dtype=torch.int32)):
        with pytest.raises(ValueError):
            fa.flash_prefill_attention(q, k, v, lengths, scale=0.25, mm_groups=bad)
    groups = torch.zeros((1, 64), dtype=torch.int32, device="cuda")
    lo, hi = fa.mm_spans(groups)
    for spans in ((lo[:, :32], hi[:, :32]), (lo.long(), hi), (lo.cpu(), hi)):
        with pytest.raises(ValueError):
            fa.flash_prefill_attention(q, k, v, lengths, scale=0.25, mm_groups=groups,
                                       group_spans=spans)
