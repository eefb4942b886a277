"""int8 expert weights in the port against the JAX package, on the CPU.

The same numpy-seeded inputs go through both packages. Tolerances:

- ``quantize`` of 4-D expert stacks, ``quantize_params``, the int8
  ``init_params`` and every loader (int8, fp8, AWQ; both MoE namings;
  gemma-3 fp8 and Qwen3-VL AWQ): int8 bytes and float32 scales exactly
  (both divide IEEE and round half to even), everything else bit for bit;
- ``moe_block`` on ``QTensor`` stacks against the JAX ``moe_block``:
  float32 atol = rtol = 1e-5 (the same routing; summation orders differ,
  measured ~1e-7); bfloat16 each row's max |err| <= 2e-2 x the row's own
  max |JAX| (the port's bf16 row tolerance: rounding points differ);
- ``debug-moe`` int8 logits (float32 activations): atol = rtol = 1e-4,
  the decoder tests' tolerance;
- engine streams: greedy tokens exactly.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from llms_on_kubernetes_tpu.configs import from_hf_config as j_from_hf_config
from llms_on_kubernetes_tpu.configs import get_config as jget_config
from llms_on_kubernetes_tpu.engine.cache import CacheConfig as JCacheConfig
from llms_on_kubernetes_tpu.engine.cache import init_pages as j_init_pages
from llms_on_kubernetes_tpu.engine.engine import Engine as JEngine
from llms_on_kubernetes_tpu.engine.engine import EngineConfig as JEngineConfig
from llms_on_kubernetes_tpu.engine.engine import SamplingParams as JSamplingParams
from llms_on_kubernetes_tpu.engine.weights import load_hf_params as j_load_hf_params
from llms_on_kubernetes_tpu.models import decoder as jdec
from llms_on_kubernetes_tpu.ops import quant as jquant
from llms_on_kubernetes_tpu.ops.moe import moe_block as j_moe_block
from llms_on_kubernetes_tpu_torch import cli
from llms_on_kubernetes_tpu_torch.configs import from_hf_config, get_config
from llms_on_kubernetes_tpu_torch.engine.cache import CacheConfig, init_pages
from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
from llms_on_kubernetes_tpu_torch.engine.weights import (
    checkpoint_quantization, load_hf_params, params_from_numpy,
)
from llms_on_kubernetes_tpu_torch.models import decoder as tdec
from llms_on_kubernetes_tpu_torch.ops import moe as tmoe
from llms_on_kubernetes_tpu_torch.ops import quant as tquant
from llms_on_kubernetes_tpu_torch.server.openai_api import OpenAIServer
from llms_on_kubernetes_tpu_torch.testing import synth_checkpoint as sc

TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_ROW_TOL = 2e-2
SHAPES = {"ops": (16, 8, 12, 4, 2), "e16k8": (32, 32, 48, 16, 8)}   # N, D, F, E, k
EXPERTS = ("w_gate", "w_up", "w_down")
SMALL = dict(model="debug-moe", dtype="float32", max_decode_slots=4, page_size=4,
             num_pages=128, pages_per_slot=16, prefill_buckets=(16, 32))
GREEDY = dict(temperature=0.0, max_tokens=12)
PROMPTS = [[3, 17, 9], [40, 2] * 9, [7, 7, 7, 7], [100, 42, 5, 1, 9] * 5, [11] * 30]


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy (ml_dtypes bfloat16 included) -> a CPU tensor, bits kept."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _bits(t) -> np.ndarray:
    t = t.detach().cpu()
    return t.view(torch.uint16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _np_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _carry(tree):
    """A JAX param tree -> numpy, a QTensor leaf as its (data, scale) pair."""
    if isinstance(tree, dict):
        return {k: _carry(v) for k, v in tree.items()}
    if isinstance(tree, jquant.QTensor):
        return (np.asarray(tree.data), np.asarray(tree.scale))
    return np.asarray(tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _assert_params_equal(got, want):
    """Two parameter trees (the port's, JAX's) equal leaf for leaf: a
    QTensor's bytes and scales, every other tensor's bits."""
    got_l, want_l = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got_l) == sorted(want_l)
    for k, w in want_l.items():
        g = got_l[k]
        if isinstance(w, jquant.QTensor):
            assert isinstance(g, tquant.QTensor), k
            assert g.data.dtype == torch.int8 and g.scale.dtype == torch.float32, k
            np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data), err_msg=k)
            np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale), err_msg=k)
        else:
            assert not isinstance(g, (tquant.QTensor, tquant.GroupQTensor)), k
            np.testing.assert_array_equal(_bits(g), _np_bits(w), err_msg=k)


def _row_close(got: np.ndarray, want: np.ndarray) -> None:
    n = want.shape[-1]
    row_err = np.abs(got - want).reshape(-1, n).max(axis=1)
    row_max = np.abs(want).reshape(-1, n).max(axis=1)
    assert (row_err <= BF16_ROW_TOL * np.maximum(row_max, 1e-6)).all(), \
        float((row_err / np.maximum(row_max, 1e-6)).max())


@pytest.fixture
def f8_numpy(monkeypatch):
    """The JAX loader's safetensors numpy reader names float8 types as
    numpy attributes; ml_dtypes provides them."""
    monkeypatch.setattr(np, "float8_e4m3fn", ml_dtypes.float8_e4m3fn, raising=False)


@pytest.fixture(scope="module")
def jparams():
    return jdec.init_params(jget_config("debug-moe"), jax.random.key(0), dtype="float32")


@pytest.fixture(scope="module")
def jq(jparams):
    return jquant.quantize_params(jparams)


@pytest.fixture(scope="module")
def tq(jq):
    return params_from_numpy(_carry(jq), device="cpu")


# ---------------------------------------------------------------------------
# quantizing expert stacks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", EXPERTS)
def test_quantize_expert_stacks_equal_jax(rng, name, dtype):
    """A layer-stacked [L, E, in, out] expert stack with one all-zero output
    column (scale 1, data 0): the JAX axes (2,) of ``reduce_axes_for(name,
    4)``, the port's bytes and scales equal JAX ``quantize``'s, whole and a
    layer at a time."""
    L, E, D, F = 2, 4, 32, 48
    shape = (L, E, F, D) if name == "w_down" else (L, E, D, F)
    w = rng.normal(size=shape).astype(np.float32) * 0.05
    w[1, 2, :, 5] = 0.0
    if dtype == "bfloat16":
        w = w.astype(ml_dtypes.bfloat16)
    axes = jquant.reduce_axes_for(name, 4)
    assert axes == tquant.reduce_axes_for(name, 4) == (2,)
    want = jquant.quantize(w, axes)
    for got in (tquant.quantize(_t(w), axes), tquant.quantize_stack(_t(w), axes)):
        assert tuple(got.scale.shape) == tuple(np.asarray(want.scale).shape) == \
            (L, E, 1, shape[-1])
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert float(np.asarray(want.scale)[1, 2, 0, 5]) == 1.0


def test_quantize_params_moe_equals_jax(jparams, jq):
    """JAX ``init_params(debug-moe, f32)`` carried across and quantized by
    the port: the seven matmul weights (three of them expert stacks) int8
    as JAX's, the router, embedding and norms untouched."""
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    got = tquant.quantize_params(tp)
    _assert_params_equal(got, jq)
    assert all(isinstance(got["layers"][n], tquant.QTensor) for n in EXPERTS)
    assert got["layers"]["router"] is tp["layers"]["router"]


def _mixtral_narrow():
    """mixtral-8x7b cut to debug widths: 2 layers, 8 experts top-2."""
    return dataclasses.replace(get_config("mixtral-8x7b"), name="mixtral-narrow", num_layers=2,
                               hidden_size=64, intermediate_size=96, num_heads=4, num_kv_heads=2,
                               head_dim=16, vocab_size=256)


def _qwen3_moe_narrow():
    """qwen3-30b-a3b cut to debug widths: 2 layers, 16 experts top-4."""
    return dataclasses.replace(get_config("qwen3-30b-a3b"), name="qwen3-moe-narrow",
                               num_layers=2, hidden_size=64, intermediate_size=64, num_heads=4,
                               num_kv_heads=2, head_dim=16, vocab_size=256, num_experts=16,
                               num_experts_per_tok=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", ["debug-moe", "mixtral-narrow", "debug-tiny"])
def test_int8_init_params_equal_quantize_params(model, dtype):
    """``init_params(quantize=True)`` quantizes each expert slice as it is
    drawn (never the whole bf16 stack) and gives the bytes of
    ``quantize_params(init_params(...))``; a dense model's too."""
    cfg = _mixtral_narrow() if model == "mixtral-narrow" else get_config(model)
    want = tquant.quantize_params(tdec.init_params(cfg, seed=3, dtype=dtype, device="cpu"))
    got = tdec.init_params(cfg, seed=3, dtype=dtype, device="cpu", quantize=True)
    assert sorted(got) == sorted(want) and sorted(got["layers"]) == sorted(want["layers"])
    for name, w in want["layers"].items():
        g = got["layers"][name]
        if isinstance(w, tquant.QTensor):
            assert isinstance(g, tquant.QTensor), name
            assert torch.equal(g.data, w.data) and torch.equal(g.scale, w.scale), name
        else:
            assert torch.equal(g, w), name
    for name in ("embed", "final_norm"):
        assert torch.equal(got[name], want[name])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,shape", [("wq", (2, 8, 4, 3)), ("wo", (2, 4, 3, 8)),
                                        ("w_gate", (3, 8, 6)), ("w_down", (2, 3, 6, 8))])
def test_quantize_drawn_equals_jax_quantize(rng, name, shape, dtype):
    """``quantize_drawn`` builds a stack from its slices (a layer; an
    expert stack's (layer, expert)), drawn in order, with the bytes and
    scales of the JAX ``quantize`` of the whole stack."""
    w = rng.normal(size=shape).astype(np.float32)
    if dtype == "bfloat16":
        w = w.astype(ml_dtypes.bfloat16)
    want = jquant.quantize(jnp.asarray(w), jquant.reduce_axes_for(name, len(shape)))
    lead = min(jquant.reduce_axes_for(name, len(shape)))
    slices = iter(torch.from_numpy(w.astype(np.float32)).to(getattr(torch, dtype))
                  .reshape(-1, *shape[lead:]))
    drawn = []

    def draw(part_shape):
        drawn.append(tuple(part_shape))
        return next(slices)

    got = tquant.quantize_drawn(shape, tquant.reduce_axes_for(name, len(shape)), draw)
    assert drawn == [tuple(shape[lead:])] * int(np.prod(shape[:lead]))
    assert np.array_equal(got.data.numpy(), np.asarray(want.data))
    assert np.array_equal(got.scale.numpy(), np.asarray(want.scale))


def test_quantizes_names_the_jax_policy(jparams, jq):
    """``quantizes`` is true of exactly the layer weights the JAX
    ``quantize_params`` turns into int8 (the router, norms, embedding and
    head stay in the dtype)."""
    for name, w in jparams["layers"].items():
        assert tquant.quantizes(name) == isinstance(jq["layers"][name], jquant.QTensor), name
    for name in ("embed", "lm_head", "final_norm", "router"):
        assert not tquant.quantizes(name)


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

def _block_inputs(rng, N, D, F, E, dtype):
    x = rng.normal(size=(N, D)).astype(np.float32)
    router = rng.normal(size=(D, E)).astype(np.float32)
    stacks = [rng.normal(size=s).astype(np.float32) * 0.1 for s in ((E, D, F), (E, D, F),
                                                                     (E, F, D))]
    if dtype == "bfloat16":
        x, router, *stacks = (a.astype(ml_dtypes.bfloat16) for a in (x, router, *stacks))
    return x, router, [jquant.quantize(w, (1,)) for w in stacks]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cf", [None, 1.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_moe_block_on_int8_stacks_matches_jax(shape, dtype, cf, masked):
    """The JAX ``moe_block`` on QTensor stacks (``qeinsum``) against the
    port's on the same stacks carried across, dropless and with capacity
    drops, with and without padding rows."""
    N, D, F, E, k = SHAPES[shape]
    rng = np.random.default_rng(5)
    x, router, jstacks = _block_inputs(rng, N, D, F, E, dtype)
    tstacks = [tquant.QTensor(_t(np.asarray(w.data)), _t(np.asarray(w.scale))) for w in jstacks]
    valid = rng.random(N) > 0.3 if masked else None
    kw = dict(top_k=k, capacity_factor=cf)
    want = np.asarray(j_moe_block(jnp.asarray(x), jnp.asarray(router), *jstacks, **kw,
                                  valid=None if valid is None else jnp.asarray(valid)))
    got = tmoe.moe_block(_t(x), _t(router), *tstacks, **kw,
                         valid=None if valid is None else torch.from_numpy(valid))
    assert got.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    g, w = got.float().numpy(), want.astype(np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(g, w, **TOL)
    else:
        keep = np.abs(w).max(axis=1) > 0
        _row_close(g[keep], w[keep])
    if masked:
        assert not g[~valid].any()


def test_int8_plain_experts_round_as_qeinsum(rng):
    """bf16: every product rounded, times the scale rounded to bf16,
    rounded again (JAX ``qeinsum``); SiLU(g) rounded, times u, rounded. The
    plain loop (the CPU wrapper) against that formula written out for one
    expert's rows, exactly."""
    N, D, F, E = 6, 32, 48, 3
    x = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32)).to(torch.bfloat16)
    q = [tquant.quantize(torch.from_numpy(rng.normal(size=s).astype(np.float32)), (1,))
         for s in ((E, D, F), (E, D, F), (E, F, D))]
    src = torch.tensor([4, 0, 2, 5, 1], dtype=torch.int32)
    counts = torch.tensor([0, 5, 0], dtype=torch.int32)
    got = tmoe.moe_experts(x, src, counts, *q)
    assert torch.equal(got, tmoe.moe_experts_plain(x, src, counts, *q))
    bf = torch.bfloat16

    def prod(a, w):
        y = torch.matmul(a.float(), w.data[1].float()).to(bf)
        return (y.float() * w.scale[1, 0].to(bf).float()).to(bf)

    xs = x[src.long()]
    h = (torch.nn.functional.silu(prod(xs, q[0]).float()).to(bf).float()
         * prod(xs, q[1]).float()).to(bf)
    assert torch.equal(got, prod(h, q[2]))


# ---------------------------------------------------------------------------
# the decoder and the engine
# ---------------------------------------------------------------------------

def _pools(jcfg, num_pages, page, pps):
    kw = dict(num_layers=jcfg.num_layers, num_kv_heads=jcfg.num_kv_heads,
              head_dim=jcfg.head_dim, num_pages=num_pages, page_size=page,
              pages_per_slot=pps, dtype="float32")
    return j_init_pages(JCacheConfig(**kw)), init_pages(CacheConfig(**kw), device="cpu")


def test_int8_prefill_and_decode_match_jax(rng, jq, tq):
    """``debug-moe`` with int8 weights (float32 activations): prefill over
    padded rows, then three decode steps with an idle slot."""
    jcfg, tcfg = jget_config("debug-moe"), get_config("debug-moe")
    (jk, jv), (tk, tv) = _pools(jcfg, 24, 4, 6)
    B, T = 3, 16
    lengths = np.asarray([11, 16, 5], np.int32)
    tokens = rng.integers(0, jcfg.vocab_size, size=(B, T)).astype(np.int32)
    table = np.zeros((B, 6), np.int32)
    table[0, :5], table[1, :5], table[2, :5] = range(1, 6), range(6, 11), range(11, 16)
    jlog, jk, jv = jax.jit(jdec.forward_prefill, static_argnums=(1,))(
        jq, jcfg, jnp.asarray(tokens), jnp.asarray(lengths), jk, jv, jnp.asarray(table))
    tlog, _, _ = tdec.forward_prefill(tq, tcfg, *map(torch.from_numpy, (tokens, lengths)), tk,
                                      tv, torch.from_numpy(table))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
    jdecode = jax.jit(jdec.forward_decode, static_argnums=(1,))
    lens = lengths.copy()
    for step in range(3):
        lens = lens + 1
        if step == 2:
            lens[1] = 0
        toks = rng.integers(0, jcfg.vocab_size, size=(B,)).astype(np.int32)
        jlog, jk, jv = jdecode(jq, jcfg, jnp.asarray(toks), jnp.asarray(lens), jk, jv,
                               jnp.asarray(table))
        tlog, _, _ = tdec.forward_decode(tq, tcfg, *map(torch.from_numpy, (toks, lens)), tk, tv,
                                         torch.from_numpy(table))
        act = lens > 0
        np.testing.assert_allclose(tlog.numpy()[act], np.asarray(jlog)[act], **LOGIT_TOL)


def test_int8_chunk_and_verify_match_jax(rng, jq, tq):
    jcfg, tcfg = jget_config("debug-moe"), get_config("debug-moe")
    (jk, jv), (tk, tv) = _pools(jcfg, 32, 4, 8)
    prompt = rng.integers(0, jcfg.vocab_size, size=12).astype(np.int32)
    table = np.zeros((1, 8), np.int32)
    table[0, :4] = [5, 2, 9, 7]
    for pos, m in ((0, 4), (4, 4), (8, 3)):
        chunk = np.zeros((1, 4), np.int32)
        chunk[0, :m] = prompt[pos:pos + m]
        h, c = np.asarray([pos], np.int32), np.asarray([m], np.int32)
        jlog, jk, jv = jdec.forward_chunk(jq, jcfg, *(jnp.asarray(a) for a in (chunk, h, c)),
                                          jk, jv, jnp.asarray(table))
        tlog, _, _ = tdec.forward_chunk(tq, tcfg, *map(torch.from_numpy, (chunk, h, c)), tk, tv,
                                        torch.from_numpy(table))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
    window = rng.integers(0, jcfg.vocab_size, size=(1, 4)).astype(np.int32)
    h, w = np.asarray([11], np.int32), np.asarray([3], np.int32)
    jlog, _, _ = jdec.forward_verify(jq, jcfg, *(jnp.asarray(a) for a in (window, h, w)),
                                     jk, jv, jnp.asarray(table))
    tlog, _, _ = tdec.forward_verify(tq, tcfg, *map(torch.from_numpy, (window, h, w)), tk, tv,
                                     torch.from_numpy(table))
    np.testing.assert_allclose(tlog.numpy()[:, :3], np.asarray(jlog)[:, :3], **LOGIT_TOL)


def _run(eng, prompts, sp):
    reqs = [eng.submit(p, sp) for p in prompts]
    for _ in range(2000):
        if not eng.has_work():
            break
        eng.step()
    assert all(r.finished for r in reqs) and not eng.has_work()
    return [(list(r.output), r.finish_reason) for r in reqs]


ENGINE_CASES = {"async": dict(), "sync": dict(async_scheduling=False),
                "int8_kv": dict(kv_cache_dtype="int8")}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_int8_greedy_streams_equal_jax_engine(jq, tq, case):
    """``debug-moe`` served with int8 weights: the port's greedy streams are
    the JAX int8 engine's, idle slots and padded buckets among them."""
    kw = ENGINE_CASES[case]
    want = _run(JEngine(JEngineConfig(**SMALL, quantization="int8", **kw), params=jq), PROMPTS,
                JSamplingParams(**GREEDY))
    eng = Engine(EngineConfig(**SMALL, quantization="int8", device="cpu", **kw), params=tq)
    assert _run(eng, PROMPTS, SamplingParams(**GREEDY)) == want


@pytest.mark.parametrize("mode", ["int8", "fp8", "awq"])
def test_random_moe_weights_serve_int8_in_every_mode(mode):
    """No checkpoint: an MoE model's random weights are drawn quantized in
    every mode (the JAX engine quantizes them too), and stream what the
    same draw quantized by hand streams."""
    eng = Engine(EngineConfig(**SMALL, quantization=mode, device="cpu"))
    layers = eng.params["layers"]
    assert all(isinstance(layers[n], tquant.QTensor) for n in EXPERTS + ("wq", "wo"))
    assert not isinstance(layers["router"], tquant.QTensor)
    by_hand = tquant.quantize_params(tdec.init_params(get_config("debug-moe"), seed=0,
                                                      dtype="float32", device="cpu"))
    ref = Engine(EngineConfig(**SMALL, device="cpu"), params=by_hand)
    sp = SamplingParams(**GREEDY)
    assert _run(eng, PROMPTS[:3], sp) == _run(ref, PROMPTS[:3], sp)


# ---------------------------------------------------------------------------
# checkpoints: int8 from bf16, fp8 and AWQ MoE, gemma-3 fp8, Qwen3-VL AWQ
# ---------------------------------------------------------------------------

NAMINGS = {"mixtral": _mixtral_narrow, "qwen3_moe": _qwen3_moe_narrow}


def _load_both(path, cfg, dtype, quantization=None):
    hf = str(path / "config.json")
    tcfg, jcfg = from_hf_config(hf, name=cfg.name), j_from_hf_config(hf, name=cfg.name)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    got = load_hf_params(tcfg, str(path), device="cpu", dtype=dtype, quantization=quantization)
    want = j_load_hf_params(jcfg, str(path), dtype=dtype, quantization=quantization)
    return got, want


def _assert_int8_moe(got, cfg):
    layers = got["layers"]
    for n in EXPERTS:
        assert isinstance(layers[n], tquant.QTensor), n
        assert tuple(layers[n].scale.shape) == (cfg.num_layers, cfg.num_experts, 1,
                                                layers[n].shape[-1])
    for n in ("wq", "wk", "wv", "wo"):
        assert isinstance(layers[n], tquant.QTensor), n
    assert isinstance(layers["router"], torch.Tensor)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("naming", sorted(NAMINGS))
def test_int8_moe_checkpoint_loads_as_jax(tmp_path, naming, dtype):
    """A full-precision MoE checkpoint under ``quantization="int8"``: JAX's
    QTensors from each stack's value as fetched, the router in the dtype."""
    cfg = NAMINGS[naming]()
    assert sc.family(cfg) == naming
    sc.write_checkpoint(cfg, str(tmp_path), dtype="float32")
    got, want = _load_both(tmp_path, cfg, dtype, quantization="int8")
    _assert_params_equal(got, want)
    _assert_int8_moe(got, cfg)


@pytest.mark.parametrize("strategy", sc.FP8_STRATEGIES)
@pytest.mark.parametrize("naming", sorted(NAMINGS))
def test_fp8_moe_checkpoint_loads_as_jax(tmp_path, f8_numpy, naming, strategy):
    """A compressed-tensors fp8 MoE checkpoint (experts in fp8, the router
    kept in the checkpoint dtype): dequantized and requantized to JAX's
    int8, with or without ``quantization="fp8"``."""
    cfg = NAMINGS[naming]()
    sc.write_checkpoint(cfg, str(tmp_path), quantization="fp8", fp8_strategy=strategy,
                        max_shard_bytes=200_000)
    assert checkpoint_quantization(str(tmp_path)) == {"method": "fp8"}
    index = json.loads((tmp_path / "model.safetensors.index.json").read_text())["weight_map"]
    router = ("model.layers.0.block_sparse_moe.gate.weight" if naming == "mixtral"
              else "model.layers.0.mlp.gate.weight")
    assert router in index and router + "_scale" not in index
    expert = ("model.layers.1.block_sparse_moe.experts.3.w2.weight" if naming == "mixtral"
              else "model.layers.1.mlp.experts.3.down_proj.weight")
    assert expert + "_scale" in index
    for quantization in (None, "fp8"):
        got, want = _load_both(tmp_path, cfg, "bfloat16", quantization)
        _assert_params_equal(got, want)
        _assert_int8_moe(got, cfg)


@pytest.mark.parametrize("naming", sorted(NAMINGS))
def test_awq_moe_checkpoint_loads_as_jax(tmp_path, naming):
    """An AWQ MoE checkpoint: every linear, the attention projections
    included, dequantized and quantized to int8 per layer as the JAX loader
    does (no GroupQTensor: JAX serves grouped AWQ for dense models only)."""
    cfg = NAMINGS[naming]()
    sc.write_checkpoint(cfg, str(tmp_path), quantization="awq", group_size=32)
    hf = json.loads((tmp_path / "config.json").read_text())
    assert hf["quantization_config"]["modules_to_not_convert"][:2] == ["mlp.gate",
                                                                       "block_sparse_moe.gate"]
    for quantization in (None, "awq"):
        got, want = _load_both(tmp_path, cfg, "bfloat16", quantization)
        _assert_params_equal(got, want)
        _assert_int8_moe(got, cfg)


def _gemma_mm():
    mm = get_config("debug-mm")
    return dataclasses.replace(get_config("debug-gemma"), name="debug-gemma-mm", vocab_size=300,
                               vision=mm.vision, image_token_id=mm.image_token_id,
                               boi_token_id=mm.boi_token_id, eoi_token_id=mm.eoi_token_id)


def _qwen_vl_moe():
    """debug-qwen-mm with MoE layers (the Qwen3-VL-30B-A3B layout:
    ``qwen3_vl_moe``)."""
    return dataclasses.replace(get_config("debug-qwen-mm"), name="debug-qwen-mm-moe",
                               intermediate_size=64, num_experts=4, num_experts_per_tok=2)


MM_CASES = {"gemma3-fp8-nested": (_gemma_mm, "fp8", "nested"),
            "gemma3-fp8-legacy": (_gemma_mm, "fp8", "legacy"),
            "qwen3vl-moe-awq": (_qwen_vl_moe, "awq", "nested"),
            "qwen3vl-awq": (lambda: get_config("debug-qwen-mm"), "awq", "nested")}


@pytest.mark.parametrize("case", sorted(MM_CASES))
def test_quantized_mm_checkpoint_loads_as_jax(tmp_path, f8_numpy, case):
    """gemma-3 fp8 (both namings) and Qwen3-VL AWQ (MoE and dense): the
    text model's ``model.language_model.*`` / ``language_model.model.*``
    linears quantized, the tower kept in the checkpoint dtype, loaded with
    the JAX loader's bytes and scales (a dense AWQ model keeps its grouped
    tensors, an MoE one none)."""
    make, quantization, naming = MM_CASES[case]
    cfg = make()
    sc.write_checkpoint(cfg, str(tmp_path), dtype="float32", quantization=quantization,
                        naming=naming, group_size=32)
    index = json.loads((tmp_path / "model.safetensors.index.json").read_text())["weight_map"]
    quantized = [n for n in index if n.endswith(("_scale", ".qweight"))]
    assert quantized and all("layers." in n and "vision" not in n and "visual" not in n
                             for n in quantized)
    got = load_hf_params(from_hf_config(str(tmp_path / "config.json"), name=cfg.name),
                         str(tmp_path), device="cpu", dtype="float32")
    want = j_load_hf_params(j_from_hf_config(str(tmp_path / "config.json"), name=cfg.name),
                            str(tmp_path), dtype="float32")
    assert "vision" in got
    if cfg.is_moe or quantization == "fp8":
        _assert_params_equal(got, want)
        assert isinstance(got["layers"]["wq"], tquant.QTensor)
    else:   # a dense AWQ model: its linears as JAX's GroupQTensors
        for name, w in want["layers"].items():
            g = got["layers"][name]
            if isinstance(w, jquant.GroupQTensor):
                assert isinstance(g, tquant.GroupQTensor), name
                for part in ("data", "scale", "zero_scaled"):
                    np.testing.assert_array_equal(getattr(g, part).numpy(),
                                                  np.asarray(getattr(w, part)), err_msg=name)
            else:
                np.testing.assert_array_equal(_bits(g), _np_bits(w), err_msg=name)
        _assert_params_equal(got["vision"], want["vision"])


@pytest.mark.parametrize("quantization", ["fp8", "awq"])
def test_quantized_moe_checkpoint_serves_jax_streams(tmp_path, f8_numpy, quantization):
    """An Engine over an fp8 or AWQ MoE checkpoint (the engine loads it
    itself) streams what the JAX engine streams over the JAX loader's
    params of the same directory."""
    cfg = get_config("debug-moe")
    sc.write_checkpoint(cfg, str(tmp_path), dtype="float32", quantization=quantization,
                        group_size=32)
    jp = j_load_hf_params(jget_config("debug-moe"), str(tmp_path), dtype="float32")
    want = _run(JEngine(JEngineConfig(**SMALL, quantization=quantization), params=jp),
                PROMPTS, JSamplingParams(**GREEDY))
    eng = Engine(EngineConfig(**SMALL, device="cpu", quantization=quantization),
                 model_dir=str(tmp_path))
    _assert_int8_moe(eng.params, cfg)
    assert _run(eng, PROMPTS, SamplingParams(**GREEDY)) == want


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["mixtral-8x7b", "qwen3-30b-a3b"])
def test_serve_takes_int8_for_an_moe_model(model):
    args = cli.build_parser().parse_args(["serve", "--model", model, "--random-weights",
                                          "--quantization", "int8"])
    ec = cli.engine_config_from_args(args)
    assert ec.model == model and ec.quantization == "int8"


def test_int8_moe_server_counts_its_bytes():
    """``serve --quantization int8`` on debug-moe (the flags through
    ``engine_config_from_args``): the server's live-bytes figure counts the
    int8 expert stacks at a byte a weight plus their f32 scales, as it
    counts a dense model's int8 weights."""
    args = cli.build_parser().parse_args([
        "serve", "--model", "debug-moe", "--random-weights", "--quantization", "int8",
        "--num-pages", "64", "--pages-per-slot", "8", "--prefill-buckets", "16,32",
        "--max-decode-slots", "2"])
    ec = dataclasses.replace(cli.engine_config_from_args(args), device="cpu")
    eng = Engine(ec)
    srv = OpenAIServer(eng, None, "debug-moe")
    want = 0
    for leaf in (t for _, t in _leaves(eng.params)):
        parts = (leaf.data, leaf.scale) if isinstance(leaf, tquant.QTensor) else (leaf,)
        want += sum(p.numel() * p.element_size() for p in parts)
    want += sum(t.numel() * t.element_size()
                for t in (eng.k_pages.data, eng.v_pages.data, eng.token_counts))
    layers = eng.params["layers"]
    assert layers["w_gate"].data.dtype == torch.int8
    assert srv._engine_bytes() == float(want)
    E, D, F, L = 4, 64, 96, 2
    assert layers["w_gate"].nbytes() == L * E * D * F + 4 * L * E * F
