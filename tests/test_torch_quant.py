"""The port's weight-only int8 quantization, fp8 checkpoints and device-queue
pacing against the JAX package, on the CPU (counterparts of
tests/test_quant.py, tests/test_quant_checkpoints.py and the pacing parts
of tests/test_engine_async.py).

Inputs come from a numpy seed and go through both packages as numpy.
Tolerances:
- ``quantize`` / ``quantize_params`` / the loaders: int8 bytes and float32
  scales exactly (both divide IEEE, round half to even);
- the plain projection against JAX ``qeinsum``: float32 rtol = atol =
  1e-6 (summation order only); bfloat16 each row's max |err| <= 2e-2 x the
  row's own max |JAX| (the bf16 tolerance of the port's kernel checks:
  rounding points differ);
- quantized debug-tiny forward logits: rtol = atol = 1e-5 (float32);
- engine streams: greedy tokens exactly.
"""

import collections
import dataclasses
import json
import struct
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from llms_on_kubernetes_tpu.configs import from_hf_config as j_from_hf_config
from llms_on_kubernetes_tpu.configs import get_config as jget_config
from llms_on_kubernetes_tpu.engine import engine as jengine
from llms_on_kubernetes_tpu.engine.cache import CacheConfig as JCacheConfig
from llms_on_kubernetes_tpu.engine.cache import init_pages as j_init_pages
from llms_on_kubernetes_tpu.engine.engine import Engine as JEngine
from llms_on_kubernetes_tpu.engine.engine import EngineConfig as JEngineConfig
from llms_on_kubernetes_tpu.engine.engine import SamplingParams as JSamplingParams
from llms_on_kubernetes_tpu.engine.weights import load_hf_params as j_load_hf_params
from llms_on_kubernetes_tpu.models import decoder as jdec
from llms_on_kubernetes_tpu.ops import quant as jquant
from llms_on_kubernetes_tpu_torch import cli
from llms_on_kubernetes_tpu_torch.configs import REGISTRY, from_hf_config, get_config
from llms_on_kubernetes_tpu_torch.engine import engine as tengine
from llms_on_kubernetes_tpu_torch.engine import safetensors as st
from llms_on_kubernetes_tpu_torch.engine.cache import CacheConfig, init_pages
from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
from llms_on_kubernetes_tpu_torch.engine.weights import (
    checkpoint_quantization, load_hf_params, params_from_numpy,
)
from llms_on_kubernetes_tpu_torch.models import decoder as tdec
from llms_on_kubernetes_tpu_torch.ops import quant as tquant
from llms_on_kubernetes_tpu_torch.testing import synth_checkpoint as sc

NAMES = list(tquant._LAYER_REDUCE_AXES)
SMALL = dict(model="debug-tiny", dtype="float32", max_decode_slots=4, page_size=8,
             num_pages=64, pages_per_slot=8, prefill_buckets=(16, 32))
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10], [11, 12, 13, 14], [2, 4, 6, 8, 10, 12],
           [3, 1, 4, 1, 5]]
GREEDY = dict(temperature=0.0, max_tokens=12)


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy (ml_dtypes bfloat16 included) -> a CPU tensor, bits kept."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _carry(tree):
    """A JAX param tree -> numpy, a QTensor leaf as its (data, scale) pair,
    as ``params_from_numpy`` takes it."""
    if isinstance(tree, dict):
        return {k: _carry(v) for k, v in tree.items()}
    if isinstance(tree, jquant.QTensor):
        return (np.asarray(tree.data), np.asarray(tree.scale))
    return np.asarray(tree)


def _assert_q_equal(got: tquant.QTensor, want: jquant.QTensor, name=""):
    assert isinstance(got, tquant.QTensor), name
    assert got.data.dtype == torch.int8 and got.scale.dtype == torch.float32, name
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data), err_msg=name)
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale), err_msg=name)


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, jquant.QTensor):
        _assert_q_equal(got, want, path)
    else:
        w = np.asarray(want)
        g = got.view(torch.uint16).numpy() if got.dtype == torch.bfloat16 else got.numpy()
        np.testing.assert_array_equal(g, w.view(np.uint16) if w.dtype.name == "bfloat16"
                                      else w, err_msg=path)


@pytest.fixture(scope="module")
def jparams():
    return jdec.init_params(jget_config("debug-tiny"), jax.random.key(0), dtype="float32")


@pytest.fixture(scope="module")
def jq(jparams):
    return jquant.quantize_params(jparams)


@pytest.fixture(scope="module")
def tq(jq):
    return params_from_numpy(_carry(jq), device="cpu")


# ---------------------------------------------------------------------------
# quantize, quantize_params, the projection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_quantize_equals_jax(rng, name, dtype):
    """Every weight name's contraction axes, on a stacked debug-tiny shape
    with one all-zero output channel (scale 1, data 0): the port's bytes
    and scales are JAX's numpy ``quantize``'s; so are ``quantize_stack``'s,
    a layer at a time."""
    shapes = {k: tuple(v.shape) for k, v in
              jdec.init_params(jget_config("debug-tiny"), jax.random.key(1))["layers"].items()}
    shape = shapes[name]
    w = rng.normal(size=shape).astype(np.float32) * 0.05
    axes = jquant.reduce_axes_for(name, len(shape))
    assert axes == tquant.reduce_axes_for(name, len(shape))
    zero = [slice(None)] * len(shape)
    zero[max(set(range(1, len(shape))) - set(axes))] = 0    # an output channel
    w[tuple(zero)] = 0.0
    if dtype == "bfloat16":
        w = w.astype(ml_dtypes.bfloat16)
    want = jquant.quantize(w, axes)
    got = tquant.quantize(_t(w), axes)
    _assert_q_equal(got, want, name)
    assert float(np.asarray(want.scale)[tuple(zero)].max()) == 1.0
    _assert_q_equal(tquant.quantize_stack(_t(w), axes), want, name)


def test_quantize_params_equals_jax(jparams, jq):
    """JAX ``init_params(debug-tiny, f32)`` carried across and quantized by
    the port equals JAX ``quantize_params``: the seven matmul weights int8
    with equal scales, embedding, head and norms untouched."""
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    got = tquant.quantize_params(tp)
    _assert_tree_equal(got, jq)
    assert all(isinstance(got["layers"][n], tquant.QTensor) for n in NAMES)
    assert not isinstance(got["embed"], tquant.QTensor)
    assert got["layers"]["attn_norm"] is tp["layers"]["attn_norm"]


def test_params_from_numpy_carries_qtensors(jq, tq):
    _assert_tree_equal(tq, jq)
    assert tq["layers"]["wq"][1].data.data_ptr() == tq["layers"]["wq"].data[1].data_ptr()
    assert tuple(tq["layers"]["wq"][1].scale.shape) == (1, 4, 16)


# (equation, weight name, the decoder's n_in)
EQUATIONS = [("btd,dhk->bthk", "wq", 1), ("btd,df->btf", "w_gate", 1),
             ("btf,fd->btd", "w_down", 1), ("bthk,hkd->btd", "wo", 2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("eq,name,n_in", EQUATIONS, ids=[e[0] for e in EQUATIONS])
def test_plain_projection_equals_qeinsum(rng, jq, tq, eq, name, n_in, dtype):
    """The decoder's projection of a QTensor on the CPU (``_proj`` ->
    ``w8_matmul`` -> ``w8_matmul_plain``) against JAX ``qeinsum`` on the
    same layer-1 QTensor and activations."""
    jw = jquant.QTensor(np.asarray(jq["layers"][name].data)[1],
                        np.asarray(jq["layers"][name].scale)[1])
    tw = tq["layers"][name][1]
    x_shape = (2, 5) + tuple(jw.data.shape[:n_in])
    x = rng.normal(size=x_shape).astype(np.float32)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    want = np.asarray(jquant.qeinsum(eq, jnp.asarray(x), jw)).astype(np.float32)
    got = tdec._proj(_t(x), tw, n_in)
    assert got.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    assert tuple(got.shape) == want.shape
    g = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(g, want, rtol=1e-6, atol=1e-6)
    else:
        n = want.shape[-1]
        row_err = np.abs(g - want).reshape(-1, n).max(axis=1)
        row_max = np.abs(want).reshape(-1, n).max(axis=1)
        assert (row_err <= 2e-2 * row_max).all()


def test_w8_matmul_plain_rounds_like_qeinsum(rng):
    """bf16: the product is rounded to bf16 before the bf16 scale multiply
    (JAX's two roundings), not scaled in f32 and rounded once."""
    x = torch.from_numpy(rng.normal(size=(3, 32)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.integers(-127, 128, size=(32, 16)).astype(np.int8))
    s = torch.from_numpy(rng.uniform(1e-3, 2e-2, size=16).astype(np.float32))
    y = torch.matmul(x, w.to(torch.bfloat16))
    want = (y.float() * s.to(torch.bfloat16).float()).to(torch.bfloat16)
    assert torch.equal(tquant.w8_matmul(x, w, s), want)
    assert torch.equal(tquant.w8_matmul_plain(x, w, s), want)


def test_qtensor_dequantize_equals_jax(jq, tq):
    for name in NAMES:
        want = np.asarray(jq["layers"][name].dequantize(jnp.float32))
        np.testing.assert_array_equal(tq["layers"][name].dequantize(torch.float32).numpy(),
                                      want)


def test_quantized_forward_matches_jax(rng, jq, tq):
    """forward_prefill then three forward_decode steps of int8-weight
    debug-tiny (f32 activations): logits within 1e-5 of JAX's."""
    jcfg, tcfg = jget_config("debug-tiny"), get_config("debug-tiny")
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
        jq, jcfg, jnp.asarray(tokens), jnp.asarray(lengths), jk, jv, jnp.asarray(table))
    tlog, _, _ = tdec.forward_prefill(tq, tcfg, torch.from_numpy(tokens),
                                      torch.from_numpy(lengths), tk, tv,
                                      torch.from_numpy(table))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-5, atol=1e-5)
    jdecode = jax.jit(jdec.forward_decode, static_argnums=(1,))
    lens = lengths.copy()
    for _ in range(3):
        lens = lens + 1
        toks = rng.integers(0, jcfg.vocab_size, size=(B,)).astype(np.int32)
        jlog, jk, jv = jdecode(jq, jcfg, jnp.asarray(toks), jnp.asarray(lens), jk, jv,
                               jnp.asarray(table))
        tlog, _, _ = tdec.forward_decode(tq, tcfg, torch.from_numpy(toks),
                                         torch.from_numpy(lens), tk, tv,
                                         torch.from_numpy(table))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the engine: int8 weights, pacing
# ---------------------------------------------------------------------------

def _run(eng, prompts, sp):
    reqs = [eng.submit(p, sp) for p in prompts]
    for _ in range(10_000):
        if not eng.has_work():
            break
        eng.step()
    assert all(r.finished for r in reqs) and not eng.has_work()
    return [(r.output, r.finish_reason) for r in reqs]


ENGINE_CASES = [dict(), dict(async_scheduling=False), dict(kv_cache_dtype="int8"),
                dict(kv_cache_dtype="int8", async_scheduling=False),
                dict(kv_write="fused"), dict(decode_steps=1, async_depth=3)]


@pytest.mark.parametrize("kw", ENGINE_CASES,
                         ids=["async", "sync", "int8_kv", "int8_kv_sync", "fused", "k1_depth3"])
def test_int8_engine_streams_equal_jax(jq, tq, kw):
    """int8 weights through the whole engine: the port's greedy streams are
    the JAX int8 engine's, with float and int8 KV, sync and async (the JAX
    engine has no kv_write field: "fused" stores what "dus" does)."""
    jkw = {k: v for k, v in kw.items() if k != "kv_write"}
    want = _run(JEngine(JEngineConfig(**SMALL, quantization="int8", **jkw), params=jq),
                PROMPTS, JSamplingParams(**GREEDY))
    eng = Engine(EngineConfig(**SMALL, quantization="int8", device="cpu", **kw), params=tq)
    assert _run(eng, PROMPTS, SamplingParams(**GREEDY)) == want


@pytest.mark.parametrize("mode", ["int8", "fp8", "awq"])
def test_random_weights_serve_int8_in_every_mode(mode):
    """No checkpoint: every quantization mode quantizes the seeded random
    weights (JAX engine.py:1388-1394); the streams are those of the same
    weights quantized by hand."""
    eng = Engine(EngineConfig(**SMALL, quantization=mode, device="cpu"))
    assert all(isinstance(eng.params["layers"][n], tquant.QTensor) for n in NAMES)
    assert not isinstance(eng.params["embed"], tquant.QTensor)
    by_hand = tquant.quantize_params(tdec.init_params(get_config("debug-tiny"), seed=0,
                                                      dtype="float32", device="cpu"))
    ref = Engine(EngineConfig(**SMALL, device="cpu"), params=by_hand)
    sp = SamplingParams(**GREEDY)
    assert _run(eng, PROMPTS[:3], sp) == _run(ref, PROMPTS[:3], sp)


def test_engine_refuses_an_unknown_quantization():
    with pytest.raises(ValueError, match="quantization"):
        Engine(EngineConfig(**SMALL, quantization="int4", device="cpu"))


def test_cli_takes_quantization():
    args = cli.build_parser().parse_args(["serve", "--model", "m", "--quantization", "int8"])
    assert args.quantization == "int8"
    assert cli.build_parser().parse_args(["serve", "--model", "m"]).quantization is None
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["serve", "--model", "m", "--quantization", "int4"])


class _Clock:
    """A monotonic clock the test moves; ``sleep`` records and advances."""

    def __init__(self, t=100.0, tick=0.0):
        self.t, self.tick, self.slept = t, tick, []

    def monotonic(self):
        self.t += self.tick
        return self.t

    def sleep(self, s):
        self.slept.append(s)
        self.t += s


def _patch_clock(monkeypatch, module, clock):
    monkeypatch.setattr(module, "time", types.SimpleNamespace(
        monotonic=clock.monotonic, sleep=clock.sleep, perf_counter=clock.monotonic,
        time=clock.monotonic))


def _port(tparams, **kw):
    return Engine(EngineConfig(**{**SMALL, "device": "cpu", **kw}), params=tparams)


def _unharvested(monkeypatch, eng):
    """Nothing the harvester reads counts as done: windows stay in flight
    (the engine must then never wait on backpressure)."""
    monkeypatch.setattr(eng._harvester, "is_done", lambda seq: False)
    monkeypatch.setattr(eng._harvester, "key_done", lambda key: False)


def test_paced_decision(monkeypatch, tq):
    """``_launch_decode_multi`` returns "paced" iff pacing is on, nothing
    was admitted this step, a window is in flight and the estimated undone
    work exceeds pace x step time (JAX engine.py:3360-3363)."""
    clock = _Clock()
    _patch_clock(monkeypatch, tengine, clock)
    eng = _port(tq, pace_target_steps=3.0)
    _unharvested(monkeypatch, eng)
    eng.submit([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=64))
    eng.step()                                    # admits and launches one window
    assert len(eng._inflight) == 1
    eng._est_step = 0.01
    eng._busy_until = clock.t + 0.0301            # > 3 steps of undone work
    assert eng._launch_decode_multi(None, []) == "paced"
    assert len(eng._inflight) == 1
    eng._busy_until = clock.t + 0.0299            # <= 3 steps: launch
    assert eng._launch_decode_multi(None, []) == "launched"
    assert len(eng._inflight) == 2
    eng._busy_until = clock.t + 10.0
    eng.config.pace_target_steps = 0.0            # off
    assert eng._launch_decode_multi(None, []) == "launched"
    eng.config.pace_target_steps = -1.0           # <= 0 is off, as in JAX
    assert eng._launch_decode_multi(None, []) == "launched"


def test_a_step_that_admitted_always_launches(monkeypatch, tq):
    clock = _Clock()
    _patch_clock(monkeypatch, tengine, clock)
    eng = _port(tq, pace_target_steps=3.0, async_depth=4)   # no backpressure wait
    _unharvested(monkeypatch, eng)
    eng.submit([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=64))
    eng.step()
    busy = eng._busy_until = clock.t + 10.0
    eng.step()                                    # nothing admitted: paced
    assert len(eng._inflight) == 1 and clock.slept == [0.001]
    eng.submit([4, 5, 6], SamplingParams(**GREEDY))
    eng.step()                                    # admits: the window launches anyway
    assert len(eng._inflight) == 2
    assert eng._busy_until == busy + 2.0 * eng._est_step + eng._est_step


def test_paced_step_naps(monkeypatch, tq):
    """A "paced" step with no events and nobody waiting naps 1 ms (the
    loop must not spin on the lock the harvester needs); with a request
    waiting it does not."""
    clock = _Clock()
    _patch_clock(monkeypatch, tengine, clock)
    eng = _port(tq, pace_target_steps=3.0)
    monkeypatch.setattr(eng, "_admit_async", lambda events: None)
    monkeypatch.setattr(eng, "_launch_decode_multi", lambda admitted, events: "paced")
    monkeypatch.setattr(eng, "_harvest", lambda drain: [])
    assert eng.step() == [] and clock.slept == [0.001]
    eng.submit([1, 2, 3], SamplingParams(**GREEDY))     # stays waiting
    eng.step()
    assert clock.slept == [0.001]


def _frozen_first_step(monkeypatch, eng, module, prompt):
    clock = _Clock(t=50.0)
    _patch_clock(monkeypatch, module, clock)
    eng._est_step = 0.0125
    eng.submit(prompt, (JSamplingParams if module is jengine else SamplingParams)(**GREEDY))
    eng.step()
    return eng._busy_until - 50.0


@pytest.mark.parametrize("prompt_len", [5, 45], ids=["bucket", "chunked"])
def test_busy_until_grows_as_jax(monkeypatch, jq, tq, prompt_len):
    """One step on a frozen clock: a prefill call adds 2 step times, a
    chunked prompt 2 x its chunks (45 tokens, largest bucket 32: 2), the
    window 1 (JAX engine.py:3155, 3206, 3459); the port's and the JAX
    engine's estimates agree."""
    prompt = [(7 * i) % 200 + 1 for i in range(prompt_len)]
    jeng = JEngine(JEngineConfig(**SMALL, quantization="int8", pace_target_steps=3.0),
                   params=jq)
    want = _frozen_first_step(monkeypatch, jeng, jengine, prompt)
    got = _frozen_first_step(monkeypatch, _port(tq, pace_target_steps=3.0), tengine, prompt)
    n = 2 * (2 if prompt_len > 32 else 1) + 1
    assert got == pytest.approx(n * 0.0125, abs=1e-12)
    assert got == want


# (clock time, windows the harvest consumes, windows still in flight after)
CALIBRATION = [(1.000, 1, 1), (1.030, 1, 1), (1.045, 1, 1), (1.100, 2, 1), (1.100, 0, 0),
               (2.000, 1, 1), (2.600, 1, 1), (2.600, 1, 1), (2.610, 3, 0), (2.700, 0, 1),
               (2.705, 1, 0)]


def _calibrate(monkeypatch, eng, module):
    clock = _Clock()
    _patch_clock(monkeypatch, module, clock)
    seen = []
    for t, n, left in CALIBRATION:
        clock.t = t
        eng._inflight = collections.deque()
        eng._pending_first = [None]       # past harvest's early return

        def collect(events, n=n, left=left):
            eng._pending_first = []
            eng._inflight = collections.deque([None] * left)
            return n

        monkeypatch.setattr(eng, "_collect_ready", collect)
        monkeypatch.setattr(eng, "_head_blocking_first", lambda: None)
        eng._harvest(drain=False)
        seen.append((eng._est_step, eng._last_harvest_t))
    eng._inflight = collections.deque()
    return seen


def test_est_step_calibration_follows_jax(monkeypatch, jq, tq):
    """The step-time estimate over a scripted harvest sequence: the least
    spacing per window, 2% upward drift, only gaps in (0, 0.5) s, reset
    when idle; step for step equal to the JAX engine's."""
    jeng = JEngine(JEngineConfig(**SMALL, quantization="int8", async_depth=8), params=jq)
    want = _calibrate(monkeypatch, jeng, jengine)
    got = _calibrate(monkeypatch, _port(tq, async_depth=8), tengine)
    assert got == want
    ests = [e for e, _ in got]
    assert ests[1] == pytest.approx(0.02 * 1.02) and ests[2] == pytest.approx(0.015)
    assert got[4][1] is None                      # idle: the next gap is no sample


def test_pace_3_streams_equal_pace_0(monkeypatch, tq):
    """Greedy streams at pace 3 equal pace 0's, and pacing did defer
    windows: a clock that moves 0.1 ms a read keeps the estimated undone
    work ahead of it. A deferral is a "paced" return made before the
    window is planned (a return after planning means every row's budget
    is in flight, which happens at pace 0 too)."""
    want = _run(_port(tq), PROMPTS, SamplingParams(**GREEDY))
    clock = _Clock(tick=1e-4)
    _patch_clock(monkeypatch, tengine, clock)
    eng = _port(tq, pace_target_steps=3.0, async_depth=4)
    launch, plan = eng._launch_decode_multi, eng._plan_window
    statuses, planned = collections.Counter(), []

    def counted(admitted, events):
        planned.clear()
        status = launch(admitted, events)
        statuses["deferred" if status == "paced" and not planned else status] += 1
        return status

    def planning(events):
        planned.append(1)
        return plan(events)

    monkeypatch.setattr(eng, "_launch_decode_multi", counted)
    monkeypatch.setattr(eng, "_plan_window", planning)
    assert _run(eng, PROMPTS, SamplingParams(**GREEDY)) == want
    assert statuses["deferred"] > 0 and statuses["launched"] > 0


# ---------------------------------------------------------------------------
# checkpoints: int8, fp8, AWQ; the F8_E4M3 reader
# ---------------------------------------------------------------------------

@pytest.fixture
def f8_numpy(monkeypatch):
    """The safetensors package's numpy reader names float8 types as numpy
    attributes; ml_dtypes provides them (the JAX loader's fallback when the
    native reader is not built)."""
    monkeypatch.setattr(np, "float8_e4m3fn", ml_dtypes.float8_e4m3fn, raising=False)


def test_f8_e4m3_reads_equal_ml_dtypes(tmp_path):
    codes = np.arange(256, dtype=np.uint8)
    header = json.dumps({"a": {"dtype": "F8_E4M3", "shape": [16, 16],
                               "data_offsets": [0, 256]}}).encode()
    path = tmp_path / "f8.safetensors"
    path.write_bytes(struct.pack("<Q", len(header)) + header + codes.tobytes())
    t = st.SafetensorsFile(path).tensor("a")
    assert t.dtype == torch.float8_e4m3fn and tuple(t.shape) == (16, 16)
    want = codes.view(ml_dtypes.float8_e4m3fn).astype(np.float32).reshape(16, 16)
    np.testing.assert_array_equal(t.float().numpy(), want)        # NaNs at the same codes
    np.testing.assert_array_equal(t.view(torch.uint8).numpy().ravel(), codes)


def _q_params_equal(got, want):
    _assert_tree_equal(got, want)
    assert all(isinstance(got["layers"][n], tquant.QTensor) for n in NAMES)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", ["llama", "qwen2", "qwen3", "phi3", "gemma2",
                                    "gemma3_nested"])
def test_load_int8_equals_jax(tmp_path, family, dtype):
    """``load_hf_params(quantization="int8")`` on the transformers-written
    float32 checkpoints of tests/test_torch_weights.py (phi3's fused
    tensors split first): JAX's QTensor bytes and scales, quantized from
    the float32 values before the cast to ``dtype``; everything else
    bit-equal."""
    from test_torch_weights import _hf_model, _nest_gemma3

    torch.manual_seed(0)
    hf = _hf_model(family)
    for p in hf.parameters():
        torch.nn.init.normal_(p, std=0.05)
    hf.eval().to(torch.float32).save_pretrained(tmp_path, safe_serialization=True)
    if family == "gemma3_nested":
        _nest_gemma3(tmp_path)
    hf_cfg = json.loads((tmp_path / "config.json").read_text())
    got = load_hf_params(from_hf_config(hf_cfg, name=family), str(tmp_path), device="cpu",
                         dtype=dtype, quantization="int8")
    want = j_load_hf_params(j_from_hf_config(hf_cfg, name=family), str(tmp_path),
                            dtype=dtype, quantization="int8")
    _q_params_equal(got, want)


def _small(family: str):
    """A registry config of ``family`` cut to debug widths (2 layers,
    hidden 64, 4 heads of 16), as synth_checkpoint writes it."""
    name = next(n for n, c in REGISTRY.items()
                if not n.startswith("debug") and sc.family(c) == family)
    cfg = REGISTRY[name]
    return dataclasses.replace(cfg, name=f"{name}-tiny", num_layers=2, hidden_size=64,
                               intermediate_size=128, num_heads=4,
                               num_kv_heads=min(cfg.num_kv_heads, 2), head_dim=16,
                               vocab_size=256,
                               query_pre_attn_scalar=16.0 if cfg.query_pre_attn_scalar else None)


FP8_CASES = [("llama", "channel"), ("llama", "tensor"), ("phi3", "channel"),
             ("qwen2", "channel"), ("qwen3", "channel"), ("gemma2", "channel"),
             ("gemma3_text", "channel")]


@pytest.mark.parametrize("family,strategy", FP8_CASES,
                         ids=[f"{f}-{s}" for f, s in FP8_CASES])
def test_load_fp8_checkpoint_equals_jax(tmp_path, f8_numpy, family, strategy):
    """A compressed-tensors fp8 checkpoint from synth_checkpoint (per-channel
    and per-tensor scales; phi3's fused tensors): dequantized and
    requantized to JAX's int8 QTensors, with or without
    ``quantization="fp8"``."""
    cfg = _small(family)
    sc.write_checkpoint(cfg, str(tmp_path), quantization="fp8", fp8_strategy=strategy,
                        max_shard_bytes=40_000)
    assert checkpoint_quantization(str(tmp_path)) == {"method": "fp8"}
    hf_cfg = json.loads((tmp_path / "config.json").read_text())
    tcfg, jcfg = from_hf_config(hf_cfg, name=cfg.name), j_from_hf_config(hf_cfg, name=cfg.name)
    want = j_load_hf_params(jcfg, str(tmp_path), dtype="bfloat16")
    for quantization in (None, "fp8"):
        got = load_hf_params(tcfg, str(tmp_path), device="cpu", dtype="bfloat16",
                             quantization=quantization)
        _q_params_equal(got, want)


def test_fp8_dequantize_equals_jax(rng):
    w = (rng.normal(size=(8, 32)) * 100).astype(ml_dtypes.float8_e4m3fn)
    codes = torch.from_numpy(w.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    for s in (np.float32(0.02), rng.uniform(0.01, 0.1, 8).astype(np.float32),
              rng.uniform(0.01, 0.1, (8, 1)).astype(np.float32)):
        np.testing.assert_array_equal(
            tquant.fp8_dequantize(codes, torch.from_numpy(np.array(s))).numpy(),
            jquant.fp8_dequantize(w, s))


def test_fp8_checkpoint_serves_what_it_loads(tmp_path):
    """An Engine over an fp8 checkpoint serves the streams of the same
    params handed in (the engine loads through load_hf_params)."""
    cfg = get_config("debug-tiny")
    sc.write_checkpoint(cfg, str(tmp_path), quantization="fp8")
    params = load_hf_params(cfg, str(tmp_path), device="cpu", dtype="float32")
    kw = {**SMALL, "device": "cpu"}
    eng = Engine(EngineConfig(**kw, quantization="fp8"), model_dir=str(tmp_path))
    assert isinstance(eng.params["layers"]["w_up"], tquant.QTensor)
    sp = SamplingParams(**GREEDY)
    assert _run(eng, PROMPTS[:3], sp) == _run(Engine(EngineConfig(**kw), params=params),
                                              PROMPTS[:3], sp)


def test_quantization_mismatch_and_awq_raise(tmp_path):
    cfg = get_config("debug-tiny")
    sc.write_checkpoint(cfg, str(tmp_path), dtype="float32")
    with pytest.raises(ValueError, match="full-precision"):
        load_hf_params(cfg, str(tmp_path), device="cpu", quantization="fp8")
    with pytest.raises(ValueError, match="full-precision"):
        load_hf_params(cfg, str(tmp_path), device="cpu", quantization="awq")
    with pytest.raises(ValueError, match="unknown quantization"):
        load_hf_params(cfg, str(tmp_path), device="cpu", quantization="int4")
    hf = json.loads((tmp_path / "config.json").read_text())
    hf["quantization_config"] = {"quant_method": "awq", "bits": 4, "group_size": 32,
                                 "version": "gemm"}
    (tmp_path / "config.json").write_text(json.dumps(hf))
    assert checkpoint_quantization(str(tmp_path)) == {"method": "awq", "bits": 4,
                                                      "group_size": 32}
    with pytest.raises(ValueError, match="is awq"):
        load_hf_params(cfg, str(tmp_path), device="cpu", quantization="fp8")
    hf["quantization_config"] = {"quant_method": "compressed-tensors", "config_groups": {
        "g": {"weights": {"type": "int", "num_bits": 4}}}}
    (tmp_path / "config.json").write_text(json.dumps(hf))
    with pytest.raises(ValueError, match="compressed-tensors"):
        checkpoint_quantization(str(tmp_path))
