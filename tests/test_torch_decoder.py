"""The port's decoder against the JAX decoder, on the CPU in float32.

The JAX ``init_params`` weights go through ``params_from_numpy``; the same
prompts prefill both, then a few decode steps feed both the same token
ids. Logits must match within atol = rtol = 1e-4 (float32; the matmul
summation order differs). The pools hold computed K/V, so they are held
to atol = rtol = 1e-5 outside the trash pages; which rows are written
(filler included) is pinned exactly by tests/test_torch_cache.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llms_on_kubernetes_tpu.configs import get_config as jget_config
from llms_on_kubernetes_tpu.engine.cache import CacheConfig as JCacheConfig
from llms_on_kubernetes_tpu.engine.cache import init_pages as j_init_pages
from llms_on_kubernetes_tpu.models import decoder as jdec
from llms_on_kubernetes_tpu_torch.configs import get_config
from llms_on_kubernetes_tpu_torch.engine.cache import CacheConfig, init_pages
from llms_on_kubernetes_tpu_torch.engine.weights import params_from_numpy
from llms_on_kubernetes_tpu_torch.models import decoder as tdec

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
POOL_TOL = dict(rtol=1e-5, atol=1e-5)


def _setup(name, page=4, num_pages=24, pps=6):
    jcfg = jget_config(name)
    jp = jdec.init_params(jcfg, jax.random.key(0), dtype="float32")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    kw = dict(num_layers=jcfg.num_layers, num_kv_heads=jcfg.num_kv_heads,
              head_dim=jcfg.head_dim, num_pages=num_pages, page_size=page,
              pages_per_slot=pps, dtype="float32")
    jk, jv = j_init_pages(JCacheConfig(**kw))
    tk, tv = init_pages(CacheConfig(**kw), device="cpu")
    return jcfg, jp, tp, (jk, jv), (tk, tv)


def _pools_close(tpools, jpools, cfg, num_pages):
    keep = np.ones(cfg.num_layers * num_pages, bool)
    keep[::num_pages] = False       # each layer's trash page
    for t, j in zip(tpools, jpools):
        np.testing.assert_allclose(t.data.numpy()[:, keep], np.asarray(j.data)[:, keep],
                                   **POOL_TOL)


@pytest.mark.parametrize("name", ["debug-tiny", "debug-gemma"])
def test_prefill_then_decode_matches_jax(rng, name):
    num_pages = 24
    jcfg, jp, tp, (jk, jv), (tk, tv) = _setup(name, num_pages=num_pages)
    tcfg = get_config(name)
    B, T = 3, 16
    lengths = np.asarray([11, 16, 5], np.int32)
    tokens = rng.integers(0, jcfg.vocab_size, size=(B, T)).astype(np.int32)
    table = np.zeros((B, 6), np.int32)
    table[0, :5], table[1, :5], table[2, :5] = [1, 2, 3, 4, 5], [6, 7, 8, 9, 10], \
        [11, 12, 13, 14, 15]

    jpre = jax.jit(jdec.forward_prefill, static_argnums=(1,))
    jlog, jk, jv = jpre(jp, jcfg, jnp.asarray(tokens), jnp.asarray(lengths), jk, jv,
                        jnp.asarray(table))
    tlog, _, _ = tdec.forward_prefill(tp, tcfg, torch.from_numpy(tokens),
                                      torch.from_numpy(lengths), tk, tv,
                                      torch.from_numpy(table))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
    _pools_close((tk, tv), (jk, jv), jcfg, num_pages)

    jdecode = jax.jit(jdec.forward_decode, static_argnums=(1,))
    lens = lengths.copy()
    for step in range(3):
        lens = lens + 1
        if step == 2:
            lens[1] = 0                      # an idle slot rides along
        toks = rng.integers(0, jcfg.vocab_size, size=(B,)).astype(np.int32)
        jlog, jk, jv = jdecode(jp, jcfg, jnp.asarray(toks), jnp.asarray(lens), jk, jv,
                               jnp.asarray(table))
        tlog, _, _ = tdec.forward_decode(tp, tcfg, torch.from_numpy(toks),
                                         torch.from_numpy(lens), tk, tv,
                                         torch.from_numpy(table))
        act = lens > 0
        np.testing.assert_allclose(tlog.numpy()[act], np.asarray(jlog)[act], **LOGIT_TOL)
        _pools_close((tk, tv), (jk, jv), jcfg, num_pages)


def test_decode_kv_write_fused_equals_dus(rng):
    _, _, tp, _, (tk, tv) = _setup("debug-tiny")
    cfg = get_config("debug-tiny")
    table = torch.tensor([[1, 2, 3, 0, 0, 0], [4, 5, 6, 0, 0, 0]], dtype=torch.int32)
    tokens = torch.from_numpy(rng.integers(0, 256, size=(2, 8)).astype(np.int32))
    tdec.forward_prefill(tp, cfg, tokens, torch.tensor([8, 6], dtype=torch.int32), tk, tv,
                         table)
    outs = {}
    for mode in ("dus", "fused"):
        k, v = tk.data.clone(), tv.data.clone()
        logits, _, _ = tdec.forward_decode(tp, cfg, torch.tensor([3, 9], dtype=torch.int32),
                                           torch.tensor([9, 7], dtype=torch.int32), k, v,
                                           table, kv_write=mode)
        outs[mode] = (logits, k, v)
    for a, b in zip(outs["dus"], outs["fused"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["debug-tiny", "debug-gemma"])
def test_bf16_logits_keep_the_f32_accumulation(rng, name):
    """bf16 operands, float32 logits never rounded to bf16 (the JAX path's
    preferred_element_type=float32), tied head and logit softcap included.
    Held to the float64 product of the same bf16 operands at 1e-5 of the
    logits' scale; a bf16 rounding of the product is off by ~4e-3 of it."""
    from llms_on_kubernetes_tpu_torch.ops.attention import softcap
    from llms_on_kubernetes_tpu_torch.ops.norms import rms_norm

    cfg = get_config(name)
    params = tdec.init_params(cfg, seed=0, dtype="bfloat16", device="cpu")
    x = torch.from_numpy(rng.normal(size=(4, cfg.hidden_size)).astype(np.float32))
    x = x.to(torch.bfloat16)
    logits = tdec._logits(params, cfg, x)
    assert logits.dtype == torch.float32
    h = rms_norm(x, params["final_norm"], cfg.rms_norm_eps, style=cfg.norm_style)
    head = params["embed"].T if cfg.tie_word_embeddings else params["lm_head"]
    ref = softcap(h.double() @ head.double(), cfg.logit_softcap)
    err = float((logits.double() - ref).abs().max())
    assert err <= 1e-5 * float(ref.abs().max())


def test_init_params_shapes_match_jax():
    """The port's own random init has the JAX layout, dtypes and scales."""
    jcfg = jget_config("debug-tiny")
    jp = jax.eval_shape(lambda k: jdec.init_params(jcfg, k, dtype="float32"),
                        jax.random.key(0))
    tp = tdec.init_params(get_config("debug-tiny"), seed=3, dtype="float32", device="cpu")
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    tshapes = {k: ({n: tuple(w.shape) for n, w in v.items()} if isinstance(v, dict)
                   else tuple(v.shape)) for k, v in tp.items()}
    assert tshapes == jshapes
    wq = tp["layers"]["wq"]
    assert abs(float(wq.std()) - 64 ** -0.5) < 0.02
    assert torch.equal(tp["layers"]["attn_norm"], torch.ones(2, 64))
    again = tdec.init_params(get_config("debug-tiny"), seed=3, dtype="float32", device="cpu")
    assert torch.equal(again["embed"], tp["embed"])            # seeded


def test_init_params_rejects_unported_families():
    """Vision towers and MoE are ported now (tests/test_torch_vision.py,
    tests/test_torch_moe.py): a vision config gets its tower, an MoE
    config the expert stacks."""
    import dataclasses

    from llms_on_kubernetes_tpu_torch.configs import VisionConfig

    mm = dataclasses.replace(get_config("debug-tiny"), vision=VisionConfig(
        hidden_size=16, intermediate_size=32, num_layers=1, num_heads=2, image_size=16,
        patch_size=4))
    tower = tdec.init_params(mm, device="cpu")["vision"]
    assert tuple(tower["patch_w"].shape) == (4, 4, 3, 16)
    assert tuple(tower["mm_proj"].shape) == (16, 64)
    moe = dataclasses.replace(get_config("debug-tiny"), num_experts=4)
    assert tuple(tdec.init_params(moe, device="cpu")["layers"]["w_gate"].shape) == (2, 4, 64, 128)
