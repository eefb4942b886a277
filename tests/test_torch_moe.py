"""The port's MoE slice on the CPU against the JAX package, in float32.

- ``ops/moe.moe_block`` against the JAX ``moe_block``: the shapes of
  tests/test_ops.py:157 and a 16-expert top-8 case, dropless and with
  capacity drops, with and without a ``valid`` mask (tests/test_ops.py:186,
  204). Tolerance atol = rtol = 1e-5: float32 on both sides, the same
  routing, summation orders that differ (measured <= 2.1e-7).
- ``moe_route``'s integers (experts, positions, drops, rows, counts)
  against the JAX formula (ops/moe.py:57-72) exactly, a tied router too.
- ``debug-moe``'s prefill, decode (idle slots), chunk, score and verify
  passes against the JAX decoder's at the decoder tests' 1e-4, from the
  JAX ``init_params`` weights.
- Greedy streams of the port's Engine against the JAX Engine's on
  ``debug-moe`` with idle slots and padded buckets: identical.
- MoE checkpoints in both namings (Mixtral, Qwen3-MoE) load tensor for
  tensor as the JAX loader loads them; the registry's MoE entries equal
  the JAX ones.
- What stays refused: LoRA on the MLP of an MoE model (the JAX
  ValueError). Quantized MoE weights are tests/test_torch_moe_quant.py's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llms_on_kubernetes_tpu import configs as jconfigs
from llms_on_kubernetes_tpu.configs import from_hf_config as j_from_hf_config
from llms_on_kubernetes_tpu.configs import get_config as jget_config
from llms_on_kubernetes_tpu.engine.cache import CacheConfig as JCacheConfig
from llms_on_kubernetes_tpu.engine.cache import init_pages as j_init_pages
from llms_on_kubernetes_tpu.engine.engine import Engine as JEngine
from llms_on_kubernetes_tpu.engine.engine import EngineConfig as JEngineConfig
from llms_on_kubernetes_tpu.engine.engine import SamplingParams as JSamplingParams
from llms_on_kubernetes_tpu.engine.weights import load_hf_params as j_load_hf_params
from llms_on_kubernetes_tpu.models import decoder as jdec
from llms_on_kubernetes_tpu.ops.moe import moe_block as j_moe_block
from llms_on_kubernetes_tpu_torch import configs as tconfigs
from llms_on_kubernetes_tpu_torch.configs import from_hf_config, get_config
from llms_on_kubernetes_tpu_torch.engine.cache import CacheConfig, init_pages
from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
from llms_on_kubernetes_tpu_torch.engine.weights import load_hf_params, params_from_numpy
from llms_on_kubernetes_tpu_torch.models import decoder as tdec
from llms_on_kubernetes_tpu_torch.ops.moe import capacity, moe_block, moe_route
from llms_on_kubernetes_tpu_torch.testing import synth_checkpoint as sc

TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
SHAPES = {"ops": (16, 8, 12, 4, 2), "e16k8": (32, 32, 48, 16, 8)}   # N, D, F, E, k


def _weights(rng, N, D, F, E):
    x = rng.normal(size=(N, D)).astype(np.float32)
    router = rng.normal(size=(D, E)).astype(np.float32)
    wg, wu = (rng.normal(size=(E, D, F)).astype(np.float32) * 0.1 for _ in range(2))
    wd = rng.normal(size=(E, F, D)).astype(np.float32) * 0.1
    return x, router, wg, wu, wd


def _jax_route(x, router, k, cf, valid):
    """The JAX block's routing integers, by its own formula."""
    N, E = x.shape[0], router.shape[1]
    C = N if cf is None else min(N, max(1, int(-(-N * k * cf // E))))
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(idx, E, dtype=jnp.int32)
    if valid is not None:
        onehot = onehot * jnp.asarray(valid).astype(jnp.int32)[:, None, None]
    before = jnp.cumsum(onehot.reshape(N * k, E), axis=0).reshape(N, k, E)
    pos_all = before - onehot
    ok = (onehot == 1) & (pos_all < C)
    idx, pos_all, ok = np.asarray(idx), np.asarray(pos_all), np.asarray(ok)
    pos = np.take_along_axis(pos_all, idx[:, :, None], 2)[:, :, 0]
    kept = np.take_along_axis(ok, idx[:, :, None], 2)[:, :, 0]
    counts = ok.sum(axis=(0, 1))
    offsets = np.cumsum(counts) - counts
    return idx, pos, kept, offsets[idx] + pos, counts


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("cf", [None, "E/k", 1.0])
@pytest.mark.parametrize("masked", [False, True])
def test_moe_block_matches_jax(shape, cf, masked):
    N, D, F, E, k = SHAPES[shape]
    cf = E / k if cf == "E/k" else cf
    rng = np.random.default_rng(3)
    arrays = _weights(rng, N, D, F, E)
    valid = rng.random(N) > 0.3 if masked else None
    kw = dict(top_k=k, capacity_factor=cf)
    want = j_moe_block(*(jnp.asarray(a) for a in arrays), **kw,
                       valid=None if valid is None else jnp.asarray(valid))
    got = moe_block(*(torch.from_numpy(a) for a in arrays), **kw,
                    valid=None if valid is None else torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if masked:
        assert not got.numpy()[~valid].any()          # padding rows come out 0
    if cf == 1.0:   # C = N k / E: some claims are dropped
        route = moe_route(torch.from_numpy(arrays[0]), torch.from_numpy(arrays[1]), **kw)
        assert not bool(route.kept.all())


@pytest.mark.parametrize("case", ["random", "tied", "drops_masked"])
def test_moe_route_integers_equal_the_jax_formula(case):
    N, D, F, E, k = SHAPES["e16k8"]
    rng = np.random.default_rng(11)
    x, router, *_ = _weights(rng, N, D, F, E)
    cf, valid = None, None
    if case == "tied":
        router = np.zeros_like(router)          # every expert ties: the lower index wins
    if case == "drops_masked":
        cf, valid = 1.0, rng.random(N) > 0.25
    idx, pos, kept, rows, counts = _jax_route(x, router, k, cf, valid)
    r = moe_route(torch.from_numpy(x), torch.from_numpy(router), top_k=k, capacity_factor=cf,
                  valid=None if valid is None else torch.from_numpy(valid))
    assert np.array_equal(r.experts.numpy(), idx)
    if case == "tied":
        assert np.array_equal(idx, np.tile(np.arange(k), (N, 1)))
    claimed = np.ones(N, bool) if valid is None else valid
    assert np.array_equal(r.pos.numpy()[claimed], pos[claimed])
    assert np.array_equal(r.kept.numpy(), kept)
    assert np.array_equal(r.rows.numpy()[kept], rows[kept])
    assert np.array_equal(r.counts.numpy(), counts)
    assert np.array_equal(r.offsets.numpy(), np.cumsum(counts) - counts)
    # src inverts rows: each kept claim's row names its token
    tok = np.broadcast_to(np.arange(N)[:, None], (N, k))
    assert np.array_equal(r.src.numpy()[rows[kept]], tok[kept])
    assert capacity(N, E, k, cf) == (N if cf is None else N * k // E)


# ---------------------------------------------------------------------------
# the decoder's MoE layers
# ---------------------------------------------------------------------------

def _setup(num_pages=24, page=4, pps=6):
    jcfg = jget_config("debug-moe")
    jp = jdec.init_params(jcfg, jax.random.key(0), dtype="float32")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    kw = dict(num_layers=jcfg.num_layers, num_kv_heads=jcfg.num_kv_heads,
              head_dim=jcfg.head_dim, num_pages=num_pages, page_size=page,
              pages_per_slot=pps, dtype="float32")
    return jcfg, jp, tp, j_init_pages(JCacheConfig(**kw)), init_pages(CacheConfig(**kw),
                                                                        device="cpu")


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_init_params_moe_shapes_equal_jax():
    jcfg = jget_config("debug-moe")
    jp = jdec.init_params(jcfg, jax.random.key(0), dtype="float32")
    tp = tdec.init_params(get_config("debug-moe"), seed=0, dtype="float32", device="cpu")
    assert {k: tuple(v.shape) for k, v in tp["layers"].items()} == \
        {k: tuple(v.shape) for k, v in jp["layers"].items()}
    # the JAX scales: router and gate/up D^-0.5, down F^-0.5
    assert abs(float(tp["layers"]["w_down"].std()) - 96 ** -0.5) < 0.01
    assert abs(float(tp["layers"]["router"].std()) - 64 ** -0.5) < 0.02


def test_prefill_and_decode_match_jax(rng):
    jcfg, jp, tp, (jk, jv), (tk, tv) = _setup()
    tcfg = get_config("debug-moe")
    B, T = 3, 16
    lengths = np.asarray([11, 16, 5], np.int32)        # padded rows claim nothing
    tokens = rng.integers(0, jcfg.vocab_size, size=(B, T)).astype(np.int32)
    table = np.zeros((B, 6), np.int32)
    table[0, :5], table[1, :5], table[2, :5] = range(1, 6), range(6, 11), range(11, 16)
    jlog, jk, jv = jdec.forward_prefill(jp, jcfg, *(jnp.asarray(a) for a in (tokens, lengths)),
                                        jk, jv, jnp.asarray(table))
    tlog, _, _ = tdec.forward_prefill(tp, tcfg, *_t(tokens, lengths), tk, tv, *_t(table))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
    lens = lengths.copy()
    for step in range(3):
        lens = lens + 1
        if step == 2:
            lens[1] = 0                      # an idle slot rides along
        toks = rng.integers(0, jcfg.vocab_size, size=(B,)).astype(np.int32)
        jlog, jk, jv = jdec.forward_decode(jp, jcfg, jnp.asarray(toks), jnp.asarray(lens),
                                           jk, jv, jnp.asarray(table))
        tlog, _, _ = tdec.forward_decode(tp, tcfg, *_t(toks, lens), tk, tv, *_t(table))
        act = lens > 0
        np.testing.assert_allclose(tlog.numpy()[act], np.asarray(jlog)[act], **LOGIT_TOL)


def test_chunk_and_verify_match_jax(rng):
    jcfg, jp, tp, (jk, jv), (tk, tv) = _setup(num_pages=32, pps=8)
    tcfg = get_config("debug-moe")
    n = 12
    prompt = rng.integers(0, jcfg.vocab_size, size=n).astype(np.int32)
    table = np.zeros((1, 8), np.int32)
    table[0, :4] = [5, 2, 9, 7]
    for pos, m in ((0, 4), (4, 4), (8, 3)):          # the last chunk padded (3 of 4)
        chunk = np.zeros((1, 4), np.int32)
        chunk[0, :m] = prompt[pos:pos + m]
        h, c = np.asarray([pos], np.int32), np.asarray([m], np.int32)
        jlog, jk, jv = jdec.forward_chunk(jp, jcfg, *(jnp.asarray(a) for a in (chunk, h, c)),
                                          jk, jv, jnp.asarray(table))
        tlog, _, _ = tdec.forward_chunk(tp, tcfg, *_t(chunk, h, c), tk, tv, *_t(table))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
    window = rng.integers(0, jcfg.vocab_size, size=(1, 4)).astype(np.int32)
    h, w = np.asarray([11], np.int32), np.asarray([3], np.int32)
    jlog, _, _ = jdec.forward_verify(jp, jcfg, *(jnp.asarray(a) for a in (window, h, w)),
                                     jk, jv, jnp.asarray(table))
    tlog, _, _ = tdec.forward_verify(tp, tcfg, *_t(window, h, w), tk, tv, *_t(table))
    np.testing.assert_allclose(tlog.numpy()[:, :3], np.asarray(jlog)[:, :3], **LOGIT_TOL)


def test_score_matches_jax_and_routes_inside_lengths(rng):
    """Every write of the score pass goes to the trash page: routing by
    write_positions would zero each MoE layer's MLP (the JAX package's
    round-4 finding). Held against the JAX pass and against a run whose
    layers route every token."""
    jcfg, jp, tp, _, _ = _setup()
    tcfg = get_config("debug-moe")
    toks = np.zeros((1, 16), np.int32)
    toks[0, :13] = rng.integers(0, jcfg.vocab_size, size=13)
    n = np.asarray([13], np.int32)
    want = jdec.forward_score(jp, jcfg, jnp.asarray(toks), jnp.asarray(n), 8)
    got = tdec.forward_score(tp, tcfg, *_t(toks, n), 8)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **LOGIT_TOL)
    np.testing.assert_allclose(got[2].numpy()[0, :12], np.asarray(want[2])[0, :12], **LOGIT_TOL)
    # a pass whose MLP were zeroed scores differently
    zeroed = {**tp, "layers": {**tp["layers"], "w_down": torch.zeros_like(tp["layers"]["w_down"])}}
    other = tdec.forward_score(zeroed, tcfg, *_t(toks, n), 8)
    assert not torch.allclose(other[0], got[0], atol=1e-3)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

SMALL = dict(model="debug-moe", dtype="float32", max_decode_slots=4, page_size=4,
             num_pages=128, pages_per_slot=16, prefill_buckets=(16, 32))


def _run(eng, prompts, params):
    reqs = [eng.submit(p, params) for p in prompts]
    for _ in range(500):
        if not eng.has_work():
            break
        eng.step()
    assert all(r.finished for r in reqs)
    return [r.output for r in reqs]


@pytest.mark.parametrize("prompts", [
    [[3, 17, 9], [40, 2] * 9],                                   # two of four slots idle
    [[3, 17, 9], [40, 2] * 9, [7, 7, 7, 7], [100, 42, 5, 1, 9] * 5, [11] * 30],
])
def test_greedy_streams_equal_jax_engine(prompts):
    jp = jdec.init_params(jget_config("debug-moe"), jax.random.key(0), dtype="float32")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    ref = _run(JEngine(JEngineConfig(**SMALL), params=jp), prompts,
               JSamplingParams(max_tokens=12, temperature=0.0))
    out = _run(Engine(EngineConfig(**SMALL, device="cpu"), params=tp), prompts,
               SamplingParams(max_tokens=12, temperature=0.0))
    assert out == ref


# ---------------------------------------------------------------------------
# checkpoints, registry, refusal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("naming", ["mixtral", "qwen3_moe"])
def test_moe_checkpoint_loads_as_jax(tmp_path, naming):
    cfg = get_config("debug-moe")
    if naming == "qwen3_moe":
        cfg = dataclasses.replace(cfg, name="debug-qwen3-moe", qk_norm=True, rms_norm_eps=1e-6)
    assert sc.family(cfg) == naming
    sc.write_checkpoint(cfg, str(tmp_path), dtype="float32")
    names = sc.tensor_specs(cfg)
    expert = "block_sparse_moe.experts.3.w2" if naming == "mixtral" else "mlp.experts.3.down_proj"
    assert any(n == f"model.layers.1.{expert}.weight" for n, _, _ in names)
    tcfg = from_hf_config(str(tmp_path / "config.json"), name=cfg.name)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    got = load_hf_params(tcfg, str(tmp_path), device="cpu", dtype="float32")
    want = j_load_hf_params(j_from_hf_config(str(tmp_path / "config.json"), name=cfg.name),
                            str(tmp_path), dtype="float32")
    assert sorted(got["layers"]) == sorted(want["layers"])
    for name, t in got["layers"].items():
        assert np.array_equal(t.numpy(), np.asarray(want["layers"][name])), name
    for name in ("embed", "final_norm", "lm_head"):
        assert np.array_equal(got[name].numpy(), np.asarray(want[name])), name


def test_registry_moe_entries_equal_jax():
    for name in ("mixtral-8x7b", "qwen3-30b-a3b", "debug-moe"):
        assert dataclasses.asdict(tconfigs.REGISTRY[name]) == \
            dataclasses.asdict(jconfigs.REGISTRY[name])
        assert tconfigs.CANONICAL_HF_IDS.get(name) == jconfigs.CANONICAL_HF_IDS.get(name)
    for alias, name in jconfigs.ALIASES.items():
        if jconfigs.REGISTRY[name].is_moe:
            assert tconfigs.ALIASES[alias] == name
    q = get_config("Qwen/Qwen3-30B-A3B")
    assert (q.num_experts, q.num_experts_per_tok, q.num_layers) == (128, 8, 48)


def test_lora_on_moe_mlp_is_refused_as_jax():
    kw = dict(SMALL, device="cpu", adapter_targets=("wq", "w_up"))
    with pytest.raises(ValueError, match="is MoE"):
        Engine(EngineConfig(**kw, adapters={"a": "/nonexistent"}))
    with pytest.raises(ValueError, match="is MoE"):
        JEngine(JEngineConfig(**{k: v for k, v in kw.items() if k != "device"},
                              adapters={"a": "/nonexistent"}))

