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
