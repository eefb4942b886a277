"""The port's native AWQ path against the JAX package, on the CPU
(counterparts of the AWQ parts of tests/test_quant.py and
tests/test_quant_checkpoints.py): AWQ's unpack and dequantize, the
grouped ``GroupQTensor`` and its int4 lane packing, the plain grouped
projection (``group_qeinsum_plain``, what ``w4_matmul`` runs on a CPU
tensor), the loader over a synthetic AWQ checkpoint, the forward and the
engine.

Inputs come from a numpy seed (or ``testing/synth_checkpoint.py``) and go
through both packages. Tolerances:
- unpack, dequantize, grouped tensors, packing, the loaders: bit for bit;
- the plain projection against JAX ``group_qeinsum``: float32 rtol = atol
  = 1e-5 (summation order only); bfloat16 each row's max |err| <= 2e-2 x
  the row's own max |JAX| (the port's bf16 tolerance);
- AWQ debug-tiny prefill logits: rtol = atol = 2e-4
  (tests/test_quant_checkpoints.py's AWQ tolerance);
- engine streams: greedy tokens exactly (float32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from llms_on_kubernetes_tpu.configs import get_config as jget_config
from llms_on_kubernetes_tpu.engine.cache import CacheConfig as JCacheConfig
from llms_on_kubernetes_tpu.engine.cache import init_pages as j_init_pages
from llms_on_kubernetes_tpu.engine.engine import Engine as JEngine
from llms_on_kubernetes_tpu.engine.engine import EngineConfig as JEngineConfig
from llms_on_kubernetes_tpu.engine.engine import SamplingParams as JSamplingParams
from llms_on_kubernetes_tpu.engine.weights import load_hf_params as j_load_hf_params
from llms_on_kubernetes_tpu.models import decoder as jdec
from llms_on_kubernetes_tpu.ops import quant as jquant
from llms_on_kubernetes_tpu_torch.configs import REGISTRY, get_config
from llms_on_kubernetes_tpu_torch.engine.cache import CacheConfig, init_pages
from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
from llms_on_kubernetes_tpu_torch.engine.weights import checkpoint_quantization, load_hf_params
from llms_on_kubernetes_tpu_torch.models import decoder as tdec
from llms_on_kubernetes_tpu_torch.ops import quant as tquant
from llms_on_kubernetes_tpu_torch.testing import synth_checkpoint as sc

GROUP = 32
SMALL = dict(model="debug-tiny", dtype="float32", max_decode_slots=4, page_size=8,
             num_pages=64, pages_per_slot=8, prefill_buckets=(16, 32))
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10], [11, 12, 13, 14], [2, 4, 6, 8, 10, 12]]
GREEDY = dict(temperature=0.0, max_tokens=12)


def _awq_tensors(rng, n_in: int, n_out: int, group: int = GROUP, bits: int = 4):
    """Random AWQ "gemm" tensors: qweight, qzeros (int32) and f16 scales."""
    per = 32 // bits
    G = n_in // group
    qw = rng.integers(-2 ** 31, 2 ** 31, size=(n_in, n_out // per), dtype=np.int64)
    qz = rng.integers(-2 ** 31, 2 ** 31, size=(G, n_out // per), dtype=np.int64)
    sc_ = rng.uniform(1e-3, 2e-2, size=(G, n_out)).astype(np.float16)
    return qw.astype(np.int32), qz.astype(np.int32), sc_


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_g_equal(got: tquant.GroupQTensor, want: jquant.GroupQTensor, name=""):
    assert isinstance(got, tquant.GroupQTensor), name
    assert got.packed == want.packed and got.out_shape == tuple(want.out_shape), name
    for part in ("data", "scale", "zero_scaled"):
        g, w = getattr(got, part).numpy(), np.asarray(getattr(want, part))
        assert g.dtype == w.dtype and g.shape == w.shape, (name, part)
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=f"{name}.{part}")


# ---------------------------------------------------------------------------
# AWQ's tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [4, 8])
def test_awq_unpack_equals_jax(rng, bits):
    qw, qz, _ = _awq_tensors(rng, 64, 48, bits=bits)
    for a in (qw, qz):
        np.testing.assert_array_equal(tquant._awq_unpack(_t(a), bits).numpy(),
                                      jquant._awq_unpack(a, bits))
    with pytest.raises(ValueError, match="bits"):
        tquant._awq_unpack(_t(qw), 3)


def test_awq_dequantize_equals_jax(rng):
    qw, qz, s = _awq_tensors(rng, 128, 64)
    got = tquant.awq_dequantize(_t(qw), _t(qz), _t(s)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  jquant.awq_dequantize(qw, qz, s).view(np.uint32))


@pytest.mark.parametrize("storage,jax_storage", [("int8", "int8"), ("packed4", "packed4"),
                                                 ("int4", "packed4"), (None, "packed4")])
def test_awq_group_tensors_equal_jax(rng, storage, jax_storage):
    """Bit-equal leaves; "int4" (an ml_dtypes element type in JAX) is
    stored as packed4, the same function."""
    qw, qz, s = _awq_tensors(rng, 128, 64)
    got = tquant.awq_group_tensors(_t(qw), _t(qz), _t(s), storage=storage, out_shape=(4, 16))
    _assert_g_equal(got, jquant.awq_group_tensors(qw, qz, s, storage=jax_storage,
                                                  out_shape=(4, 16)))
    want_w = jquant.awq_dequantize(qw, qz, s).reshape(128, 4, 16)
    np.testing.assert_allclose(got.dequantize(torch.float32).numpy(), want_w, rtol=1e-6,
                               atol=1e-7)
    assert got.shape == (128, 4, 16) and got.group_size == GROUP


def test_awq_storage_env_and_refusal(rng, monkeypatch):
    qw, qz, s = _awq_tensors(rng, 64, 32)
    monkeypatch.setenv("LLMK_AWQ_STORAGE", "int8")
    assert not tquant.awq_group_tensors(_t(qw), _t(qz), _t(s)).packed
    with pytest.raises(ValueError, match="storage"):
        tquant.awq_group_tensors(_t(qw), _t(qz), _t(s), storage="int2")


def test_pack_unpack_round_trip_equals_jax(rng):
    q = rng.integers(-8, 8, size=(3, 32, 24)).astype(np.int8)
    packed = tquant.pack_int4_lanes(_t(q))
    np.testing.assert_array_equal(packed.numpy(), jquant.pack_int4_lanes(q))
    np.testing.assert_array_equal(tquant.unpack_int4_lanes(packed).numpy(), q)
    np.testing.assert_array_equal(
        tquant.unpack_int4_lanes(packed).numpy(),
        np.asarray(jquant.unpack_int4_lanes(jnp.asarray(jquant.pack_int4_lanes(q)))))
    with pytest.raises(ValueError, match="even"):
        tquant.pack_int4_lanes(_t(q[:, :3]))


@pytest.mark.parametrize("K,N,gs", [(4096, 4096, 128), (4096, 1024, 128), (4096, 12288, 128),
                                    (12288, 4096, 128), (64, 32, 16), (96, 64, 32)])
def test_w4_splits_cut_whole_groups(K, N, gs):
    """The kernel's K slices: contiguous, in order, over [0, K), each a
    whole number of groups, balanced, a power of two of them and at most
    16 (W8A16's cluster split with the group as its unit); from K, N and gs
    only."""
    sl = tquant.w4_splits(K, N, gs)
    assert sl[0][0] == 0 and sl[-1][1] == K
    assert all(a[1] == b[0] for a, b in zip(sl, sl[1:]))
    assert all(k0 % gs == 0 and k1 > k0 for k0, k1 in sl)
    assert len(sl) & (len(sl) - 1) == 0
    assert len(sl) <= tquant.W8_SLICE_GROUPS * tquant.W8_MAX_CLUSTER
    groups = [(k1 - k0) // gs for k0, k1 in sl]
    assert max(groups) - min(groups) <= 1
    assert sl == tquant._cluster_splits(K, N, gs)


# ---------------------------------------------------------------------------
# the plain projection against the JAX scan
# ---------------------------------------------------------------------------

# the decoder's equations: x shape, weight logical shape, out shape
EQS = {"wq": ("btd,dhk->bthk", (64,), (4, 16)), "wk": ("btd,dhk->bthk", (64,), (2, 16)),
       "wo": ("bthk,hkd->btd", (4, 16), (64,)), "w_gate": ("btd,df->btf", (64,), (128,)),
       "w_down": ("btf,fd->btd", (128,), (64,))}


@pytest.mark.parametrize("packed", [True, False], ids=["packed4", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(EQS))
def test_group_qeinsum_plain_matches_jax(rng, name, dtype, packed):
    eq, in_shape, out_shape = EQS[name]
    K, N = int(np.prod(in_shape)), int(np.prod(out_shape))
    qw, qz, s = _awq_tensors(rng, K, N)
    storage = "packed4" if packed else "int8"
    jw = jquant.awq_group_tensors(qw, qz, s, storage=storage, out_shape=out_shape)
    tw = tquant.awq_group_tensors(_t(qw), _t(qz), _t(s), storage=storage, out_shape=out_shape)
    x = rng.normal(size=(3, 5, *in_shape)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                       torch.bfloat16)
    want = np.asarray(jquant.group_qeinsum(eq, jnp.asarray(x).astype(jdt), jw)
                      .astype(jnp.float32)).reshape(15, N)
    xt = torch.from_numpy(x).to(tdt).reshape(15, K)
    got = tquant.w4_matmul(xt, tw.data, tw.scale, tw.zero_scaled, tw.packed)
    assert got.dtype == tdt
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        err = np.abs(got - want).max(axis=1)
        assert (err <= 2e-2 * np.abs(want).max(axis=1)).all(), err.max()


def test_w4_matmul_cpu_is_the_plain_version(rng):
    """A CPU tensor takes group_qeinsum_plain, bit for bit."""
    qw, qz, s = _awq_tensors(rng, 128, 64)
    tw = tquant.awq_group_tensors(_t(qw), _t(qz), _t(s))
    x = torch.from_numpy(rng.normal(size=(7, 128)).astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(tquant.w4_matmul(x, tw.data, tw.scale, tw.zero_scaled, True),
                       tquant.group_qeinsum_plain(x, tw.data, tw.scale, tw.zero_scaled, True))


# ---------------------------------------------------------------------------
# a synthetic AWQ checkpoint: the loaders, the forward, the engine
# ---------------------------------------------------------------------------

def _write_awq(path, cfg=None, dtype="float32"):
    sc.write_checkpoint(cfg or get_config("debug-tiny"), str(path), dtype=dtype,
                        quantization="awq", group_size=GROUP)
    return str(path)


def _phi3_small():
    name = next(n for n, c in REGISTRY.items()
                if not n.startswith("debug") and sc.family(c) == "phi3")
    return dataclasses.replace(REGISTRY[name], name="phi-3-tiny", num_layers=2, hidden_size=64,
                               intermediate_size=128, num_heads=4, num_kv_heads=2,
                               head_dim=16, vocab_size=256)


def _assert_params_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            _assert_params_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, jquant.GroupQTensor):
        _assert_g_equal(got, want, path)
    elif isinstance(want, jquant.QTensor):
        assert isinstance(got, tquant.QTensor), path
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data), err_msg=path)
        np.testing.assert_array_equal(_bits(got.scale.numpy()), _bits(want.scale), err_msg=path)
    else:
        w = np.asarray(want)
        g = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
        if w.dtype == ml_dtypes.bfloat16:
            w = w.astype(np.float32)
        np.testing.assert_array_equal(g, w, err_msg=path)


def test_synth_awq_checkpoint_declares_the_published_format(tmp_path):
    d = _write_awq(tmp_path)
    assert checkpoint_quantization(d) == {"method": "awq", "bits": 4, "group_size": GROUP}
    assert sc.awq_quantization_config() == {"quant_method": "awq", "bits": 4,
                                            "group_size": 128, "version": "gemm",
                                            "zero_point": True}
    from llms_on_kubernetes_tpu_torch.engine.safetensors import open_dir

    loaders = open_dir(d)
    p = "model.layers.1.mlp.down_proj."
    assert "model.layers.1.mlp.down_proj.weight" not in loaders
    assert loaders[p + "qweight"]().dtype == torch.int32
    assert tuple(loaders[p + "qweight"]().shape) == (128, 64 // 8)
    assert tuple(loaders[p + "qzeros"]().shape) == (128 // GROUP, 64 // 8)
    assert loaders[p + "scales"]().dtype == torch.float16
    qw, qz, s = sc.awq_value(get_config("debug-tiny"), p + "weight", (64, 128), 0, GROUP)
    np.testing.assert_array_equal(loaders[p + "qweight"]().numpy(), qw)
    np.testing.assert_array_equal(loaders[p + "qzeros"]().numpy(), qz)
    zeros = tquant._awq_unpack(loaders[p + "qzeros"](), 4)
    assert int(zeros.min()) >= 6 and int(zeros.max()) <= 9


@pytest.mark.parametrize("storage", ["packed4", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_awq_checkpoint_equals_jax(tmp_path, monkeypatch, dtype, storage):
    """Every linear a GroupQTensor with JAX's leaves; the rest bit-equal."""
    monkeypatch.setenv("LLMK_AWQ_STORAGE", storage)
    d = _write_awq(tmp_path, dtype=dtype)
    got = load_hf_params(get_config("debug-tiny"), d, device="cpu", dtype=dtype,
                         quantization="awq")
    want = j_load_hf_params(jget_config("debug-tiny"), d, dtype=dtype, quantization="awq")
    _assert_params_equal(got, want)
    assert all(isinstance(got["layers"][n], tquant.GroupQTensor)
               for n in tquant._LAYER_REDUCE_AXES)
    assert got["layers"]["wq"].packed == (storage == "packed4")


def test_load_phi3_awq_checkpoint_equals_jax(tmp_path):
    """phi-3's fused qkv_proj and gate_up_proj are split by the layer map:
    dequantized and requantized to int8 QTensors, as JAX does; o_proj and
    down_proj stay grouped."""
    cfg = _phi3_small()
    d = _write_awq(tmp_path, cfg)
    got = load_hf_params(cfg, d, device="cpu", dtype="float32", quantization="awq")
    from llms_on_kubernetes_tpu.configs import from_hf_config as j_from_hf_config

    want = j_load_hf_params(j_from_hf_config(str(tmp_path / "config.json"), name="phi-3-tiny"),
                            d, dtype="float32", quantization="awq")
    _assert_params_equal(got, want)
    kinds = {n: type(got["layers"][n]).__name__ for n in tquant._LAYER_REDUCE_AXES}
    assert kinds == {"wq": "QTensor", "wk": "QTensor", "wv": "QTensor", "wo": "GroupQTensor",
                     "w_gate": "QTensor", "w_up": "QTensor", "w_down": "GroupQTensor"}


def test_awq_mismatch_still_refused(tmp_path):
    d = _write_awq(tmp_path)
    with pytest.raises(ValueError, match="is awq"):
        load_hf_params(get_config("debug-tiny"), d, device="cpu", quantization="fp8")


def _numpy_params(tree):
    return jax.tree.map(np.asarray, tree)


def test_awq_prefill_and_decode_logits_match_jax(rng, tmp_path):
    """forward_prefill, then three forward_decode steps, over the AWQ
    debug-tiny checkpoint (float32): logits within 2e-4 of JAX's."""
    d = _write_awq(tmp_path)
    jcfg, tcfg = jget_config("debug-tiny"), get_config("debug-tiny")
    jp = j_load_hf_params(jcfg, d, dtype="float32", quantization="awq")
    tp = load_hf_params(tcfg, d, device="cpu", dtype="float32", quantization="awq")
    kw = dict(num_layers=jcfg.num_layers, num_kv_heads=jcfg.num_kv_heads,
              head_dim=jcfg.head_dim, num_pages=24, page_size=4, pages_per_slot=6,
              dtype="float32")
    jk, jv = j_init_pages(JCacheConfig(**kw))
    tk, tv = init_pages(CacheConfig(**kw), device="cpu")
    B, T = 3, 16
    lengths = np.asarray([11, 16, 5], np.int32)
    tokens = rng.integers(0, jcfg.vocab_size, size=(B, T)).astype(np.int32)
    table = np.arange(1, 19, dtype=np.int32).reshape(B, 6)
    jlog, jk, jv = jax.jit(jdec.forward_prefill, static_argnums=(1,))(
        jp, jcfg, jnp.asarray(tokens), jnp.asarray(lengths), jk, jv, jnp.asarray(table))
    tlog, _, _ = tdec.forward_prefill(tp, tcfg, torch.from_numpy(tokens),
                                      torch.from_numpy(lengths), tk, tv,
                                      torch.from_numpy(table))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=2e-4, atol=2e-4)
    jdecode = jax.jit(jdec.forward_decode, static_argnums=(1,))
    lens = lengths.copy()
    for _ in range(3):
        lens = lens + 1
        toks = rng.integers(0, jcfg.vocab_size, size=(B,)).astype(np.int32)
        jlog, jk, jv = jdecode(jp, jcfg, jnp.asarray(toks), jnp.asarray(lens), jk, jv,
                               jnp.asarray(table))
        tlog, _, _ = tdec.forward_decode(tp, tcfg, torch.from_numpy(toks),
                                         torch.from_numpy(lens), tk, tv,
                                         torch.from_numpy(table))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=2e-4, atol=2e-4)


def _run(eng, prompts, sp):
    reqs = [eng.submit(p, sp) for p in prompts]
    for _ in range(10_000):
        if not eng.has_work():
            break
        eng.step()
    assert all(r.finished for r in reqs) and not eng.has_work()
    return [(r.output, r.finish_reason) for r in reqs]


@pytest.mark.parametrize("kw", [dict(), dict(async_scheduling=False)], ids=["async", "sync"])
def test_awq_engine_streams_equal_jax(tmp_path, kw):
    """An Engine over the AWQ checkpoint (``model_dir``, ``quantization=
    "awq"``: the loader's GroupQTensors, each projection through
    ``w4_matmul``): the JAX engine's greedy streams over the same file."""
    d = _write_awq(tmp_path)
    jp = j_load_hf_params(jget_config("debug-tiny"), d, dtype="float32", quantization="awq")
    want = _run(JEngine(JEngineConfig(**SMALL, quantization="awq", **kw), params=jp),
                PROMPTS, JSamplingParams(**GREEDY))
    eng = Engine(EngineConfig(**SMALL, quantization="awq", device="cpu", **kw), model_dir=d)
    assert isinstance(eng.params["layers"]["w_down"], tquant.GroupQTensor)
    assert _run(eng, PROMPTS, SamplingParams(**GREEDY)) == want
