"""logit_bias in the port against the JAX package, on the CPU.

The sampler: ``sample(bias=)`` against the JAX ``sample(bias=)`` with
padding ids (-1), ids past the vocabulary, +/-100 and logprobs under the
bias (float32, atol = rtol = 1e-5, as tests/test_torch_sampling.py).
The engine: greedy streams with per-request biases equal the JAX engine's
under the same config, sync and async, across a preemption, and a request
that joins a decoding batch is biased from its first token (debug-tiny in
float32 with the JAX ``init_params`` weights on both sides; streams
exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llms_on_kubernetes_tpu.configs import get_config as jget_config
from llms_on_kubernetes_tpu.engine import sampling as jsamp
from llms_on_kubernetes_tpu.engine.engine import Engine as JEngine
from llms_on_kubernetes_tpu.engine.engine import EngineConfig as JEngineConfig
from llms_on_kubernetes_tpu.engine.engine import SamplingParams as JSamplingParams
from llms_on_kubernetes_tpu.models.decoder import init_params as j_init_params
from llms_on_kubernetes_tpu_torch.engine import sampling as tsamp
from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
from llms_on_kubernetes_tpu_torch.engine.graphs import (
    BIAS, LOGIT_BIAS_SLOTS, idle_rows, pack_bias, unpack_bias,
)
from llms_on_kubernetes_tpu_torch.engine.weights import params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)
SMALL = dict(model="debug-tiny", dtype="float32", max_decode_slots=4, page_size=8,
             num_pages=64, pages_per_slot=8, prefill_buckets=(16, 32))
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10], [11, 12, 13, 14], [2, 4, 6, 8, 10, 12],
           [3, 1, 4, 1, 5]]


def _bias_arrays(rng, B, V, N=LOGIT_BIAS_SLOTS):
    """Per row: a few real entries (one +100, one -100, small ones), an id
    past the vocabulary, the rest padding -1 (with nonzero values, which
    must be dropped)."""
    ids = np.full((B, N), -1, np.int32)
    vals = rng.normal(size=(B, N)).astype(np.float32) * 7
    for b in range(B):
        real = rng.choice(V, size=5, replace=False)
        ids[b, :5] = real
        vals[b, 0], vals[b, 1] = 100.0, -100.0
        ids[b, 5] = V + 3 + b            # outside the vocabulary: dropped
    return ids, vals


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_sample_bias_matches_jax(rng, temperature):
    B, V = 4, 300
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    counts = rng.integers(0, 3, size=(B, V)).astype(np.int32)
    presence = np.asarray([0.0, 0.5, -0.5, 1.0], np.float32)
    frequency = np.asarray([0.0, 0.2, 0.1, -0.3], np.float32)
    ids, vals = _bias_arrays(rng, B, V)
    temps = np.full(B, temperature, np.float32)
    top_k = np.asarray([0, 5, 64, 1], np.int32)
    top_p = np.asarray([1.0, 0.9, 0.5, 1.0], np.float32)
    keys = jax.vmap(lambda s: jax.random.fold_in(jax.random.key(0), s))(jnp.arange(B))
    ref = jsamp.sample(jnp.asarray(logits), keys, jnp.asarray(temps), jnp.asarray(top_k),
                       jnp.asarray(top_p),
                       penalties=(jnp.asarray(presence), jnp.asarray(frequency),
                                  jnp.asarray(counts)),
                       bias=(jnp.asarray(ids), jnp.asarray(vals)))
    noise = tsamp.gumbel_noise(0, torch.arange(B), torch.arange(B), 64)
    out = tsamp.sample(torch.from_numpy(logits), noise, torch.from_numpy(temps),
                       torch.from_numpy(top_k), torch.from_numpy(top_p),
                       penalties=(torch.from_numpy(presence), torch.from_numpy(frequency),
                                  torch.from_numpy(counts)),
                       bias=(torch.from_numpy(ids), torch.from_numpy(vals)))
    # +100 forces the row's first entry under any temperature
    np.testing.assert_array_equal(out.tokens.numpy(), ids[:, 0])
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_allclose(out.logprobs.numpy(), np.asarray(ref.logprobs), **TOL)
    np.testing.assert_array_equal(out.top_ids.numpy(), np.asarray(ref.top_ids))
    np.testing.assert_allclose(out.top_logprobs.numpy(), np.asarray(ref.top_logprobs), **TOL)
    # -100 bans: the banned id is never among the alternatives
    assert not (out.top_ids.numpy() == ids[:, 1:2]).any()


def test_padding_and_out_of_range_bias_change_nothing(rng):
    B, V = 3, 200
    logits = torch.from_numpy((rng.normal(size=(B, V)) * 3).astype(np.float32))
    ids = torch.full((B, LOGIT_BIAS_SLOTS), -1, dtype=torch.int32)
    ids[:, 0] = V                       # one past the end
    ids[:, 1] = 10 ** 6
    vals = torch.full((B, LOGIT_BIAS_SLOTS), 50.0)
    args = (logits, tsamp.gumbel_noise(0, torch.arange(B), torch.arange(B), 64),
            torch.zeros(B), torch.zeros(B, dtype=torch.int32), torch.ones(B))
    plain = tsamp.sample(*args)
    biased = tsamp.sample(*args, bias=(ids, vals))
    for a, b in zip((plain.tokens, plain.logprobs, plain.top_ids, plain.top_logprobs),
                    (biased.tokens, biased.logprobs, biased.top_ids, biased.top_logprobs)):
        assert torch.equal(a, b)


def test_bias_columns_round_trip():
    packed = idle_rows(2, 3)
    assert (packed[:, BIAS:BIAS + LOGIT_BIAS_SLOTS] == -1).all()
    pack_bias(packed, 1, BIAS, ((7, 100.0), (9, -2.5)))
    ids, vals = unpack_bias(torch.from_numpy(packed), BIAS)
    assert ids[1, :3].tolist() == [7, 9, -1] and (ids[0] == -1).all()
    assert vals[1, :2].tolist() == [100.0, -2.5] and float(vals[1, 2:].abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jparams():
    return j_init_params(jget_config("debug-tiny"), jax.random.key(0), dtype="float32")


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _run(eng, prompts, params):
    params = params if isinstance(params, list) else [params] * len(prompts)
    reqs = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
    for _ in range(10_000):
        if all(r.finished for r in reqs) and not eng.has_work():
            break
        eng.step()
    assert all(r.finished for r in reqs) and not eng.has_work()
    return reqs


def _streams(reqs):
    return [(r.output, r.finish_reason) for r in reqs]


def _biases(tparams):
    """Per prompt: a ban of the unbiased greedy stream's third token (and
    a mild push), a +100 force, a mix of small values, no bias."""
    plain = _run(Engine(EngineConfig(**SMALL, device="cpu"), params=tparams), PROMPTS,
                 SamplingParams(temperature=0.0, max_tokens=12))
    out = []
    for i, r in enumerate(plain):
        kind = i % 4
        if kind == 0:
            out.append(((r.output[2], -100.0), (r.output[0], 3.5)))
        elif kind == 1:
            out.append(((42, 100.0),))
        elif kind == 2:
            out.append(tuple((t, float(v)) for t, v in zip(range(60, 92), np.linspace(-4, 4, 32))))
        else:
            out.append(())
    return out


@pytest.mark.parametrize("kw", [dict(), dict(async_scheduling=False), dict(decode_steps=1),
                                dict(kv_write="fused"), dict(kv_cache_dtype="int8")],
                         ids=["async", "sync", "k1", "fused", "int8"])
def test_biased_greedy_streams_equal_jax_engine(jparams, tparams, kw):
    biases = _biases(tparams)
    tp = [SamplingParams(temperature=0.0, max_tokens=12, logit_bias=b) for b in biases]
    jp = [JSamplingParams(temperature=0.0, max_tokens=12, logit_bias=b) for b in biases]
    jkw = {k: v for k, v in kw.items() if k != "kv_write"}
    want = _streams(_run(JEngine(JEngineConfig(**SMALL, **jkw), params=jparams), PROMPTS, jp))
    got = _streams(_run(Engine(EngineConfig(**SMALL, device="cpu", **kw), params=tparams),
                        PROMPTS, tp))
    assert got == want
    forced = got[1][0]
    assert forced == [42] * len(forced)
    assert biases[0][0][0] not in got[0][0]


@pytest.mark.parametrize("kw", [dict(), dict(async_scheduling=False)], ids=["async", "sync"])
def test_biased_streams_survive_preemption(jparams, tparams, kw):
    """11 pages for four requests that each grow to 3 (tests/test_engine_async.py:59),
    each with its own bias: the preempted request re-prefills with its bias
    and every stream equals the JAX engine's and a roomy pool's."""
    prompts = [[1, 2, 3]] * 4
    biases = [((7, 2.0), (100, -100.0)), ((42, 100.0),), (), ((5, 4.0), (6, 4.0))]
    tp = [SamplingParams(temperature=0.0, max_tokens=20, logit_bias=b) for b in biases]
    jp = [JSamplingParams(temperature=0.0, max_tokens=20, logit_bias=b) for b in biases]
    tight = Engine(EngineConfig(**{**SMALL, "num_pages": 11}, device="cpu", **kw),
                   params=tparams)
    got = _streams(_run(tight, prompts, tp))
    assert tight.preemptions > 0
    roomy = _streams(_run(Engine(EngineConfig(**SMALL, device="cpu", **kw), params=tparams),
                          prompts, tp))
    want = _streams(_run(JEngine(JEngineConfig(**{**SMALL, "num_pages": 11}, **kw),
                                 params=jparams), prompts, jp))
    assert got == roomy == want
    assert got[1][0] == [42] * 20


def test_a_request_joining_a_decoding_batch_is_biased(tparams):
    """Requests already decode when a biased one is submitted: its first
    token (the prefill row) and every window token carry the bias."""
    eng = Engine(EngineConfig(**SMALL, device="cpu"), params=tparams)
    early = [eng.submit(p, SamplingParams(temperature=0.0, max_tokens=16))
             for p in PROMPTS[:2]]
    for _ in range(3):
        eng.step()
    assert all(len(r.output) > 0 for r in early)
    late = eng.submit(PROMPTS[2], SamplingParams(temperature=0.0, max_tokens=10,
                                                 logit_bias=((77, 100.0),)))
    for _ in range(1_000):
        if not eng.has_work():
            break
        eng.step()
    assert late.output == [77] * 10 and late.finish_reason == "length"
    assert all(77 not in r.output[:1] for r in early)


@pytest.mark.parametrize("bias,match", [
    (tuple((i, 1.0) for i in range(LOGIT_BIAS_SLOTS + 1)), "at most"),
    (((256, 1.0),), "outside the vocabulary"),
    (((-1, 1.0),), "outside the vocabulary"),
    (((5, 1.0), (5, 2.0)), "duplicate"),
])
def test_submit_refuses_bad_bias(tparams, bias, match):
    eng = Engine(EngineConfig(**SMALL, device="cpu"), params=tparams)
    with pytest.raises(ValueError, match=match):
        eng.submit([1, 2, 3], SamplingParams(logit_bias=bias))
