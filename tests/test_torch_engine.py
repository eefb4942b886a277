"""The port's Engine on the CPU: greedy streams against the JAX Engine's,
and the scheduler's own invariants.

debug-tiny in float32 with the JAX ``init_params`` weights on both sides.
Greedy token streams must be IDENTICAL to the JAX engine's, and identical
across decode_steps 1 and 4 and across kv_write "dus" and "fused". A
seeded sampled stream must not change with the batch it rides in.
"""

import jax
import numpy as np
import pytest

from llms_on_kubernetes_tpu.configs import get_config as jget_config
from llms_on_kubernetes_tpu.engine.engine import Engine as JEngine
from llms_on_kubernetes_tpu.engine.engine import EngineConfig as JEngineConfig
from llms_on_kubernetes_tpu.engine.engine import SamplingParams as JSamplingParams
from llms_on_kubernetes_tpu.models.decoder import init_params as j_init_params
from llms_on_kubernetes_tpu_torch.engine.engine import (
    Engine, EngineConfig, QueueFullError, SamplingParams,
)
from llms_on_kubernetes_tpu_torch.engine.weights import params_from_numpy

SMALL = dict(model="debug-tiny", dtype="float32", max_decode_slots=4, page_size=4,
             num_pages=128, pages_per_slot=16, prefill_buckets=(16, 32))
PROMPTS = [[3, 17, 9], [40, 2] * 9, [7, 7, 7, 7], [100, 42, 5, 1, 9] * 5, [11] * 30]


@pytest.fixture(scope="module")
def jparams():
    return j_init_params(jget_config("debug-tiny"), jax.random.key(0), dtype="float32")


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _port(tparams, **kw):
    return Engine(EngineConfig(**{**SMALL, "device": "cpu", **kw}), params=tparams)


def _run(eng, prompts, params):
    reqs = [eng.submit(p, params) for p in prompts]
    for _ in range(500):
        if not eng.has_work():
            break
        eng.step()
    assert all(r.finished for r in reqs)
    return [r.output for r in reqs]


def test_greedy_streams_equal_jax_engine(jparams, tparams):
    """Five concurrent prompts over both buckets (16 and 32) and more
    requests than slots: the token streams are the JAX engine's."""
    jeng = JEngine(JEngineConfig(**SMALL), params=jparams)
    ref = _run(jeng, PROMPTS, JSamplingParams(max_tokens=12, temperature=0.0))
    out = _run(_port(tparams), PROMPTS, SamplingParams(max_tokens=12, temperature=0.0))
    assert out == ref


@pytest.mark.parametrize("kw", [dict(decode_steps=1), dict(kv_write="fused"),
                                dict(kv_write="fused", decode_steps=3)])
def test_streams_independent_of_window_and_kv_write(tparams, kw):
    greedy = SamplingParams(max_tokens=11, temperature=0.0)
    assert _run(_port(tparams, **kw), PROMPTS, greedy) == _run(_port(tparams), PROMPTS, greedy)


def test_seeded_sampled_stream_independent_of_batch(tparams):
    sp = SamplingParams(max_tokens=14, temperature=0.8, top_k=20, top_p=0.9, seed=1234,
                        presence_penalty=0.5, frequency_penalty=0.3)
    alone = _run(_port(tparams), [[5, 6, 7]], sp)[0]
    assert _run(_port(tparams), [[9, 9], [5, 6, 7], [1] * 20], sp)[1] == alone
    assert _run(_port(tparams, decode_steps=1), [[5, 6, 7]], sp)[0] == alone
    other_seed = _run(_port(tparams), [[5, 6, 7]],
                      SamplingParams(max_tokens=14, temperature=0.8, top_k=20, top_p=0.9,
                                     seed=99, presence_penalty=0.5, frequency_penalty=0.3))[0]
    assert other_seed != alone


def test_stop_token_and_length_finish(tparams):
    eng = _port(tparams)
    probe = eng.generate([5, 6], SamplingParams(max_tokens=3, temperature=0.0))
    req = eng.submit([5, 6], SamplingParams(max_tokens=50, temperature=0.0,
                                            stop_token_ids=(probe[1],)))
    while not req.finished:
        eng.step()
    assert req.output == probe[:2] and req.finish_reason == "stop"
    req = eng.submit([1, 2, 3], SamplingParams(max_tokens=5, temperature=0.0))
    while not req.finished:
        eng.step()
    assert len(req.output) == 5 and req.finish_reason == "length"
    # events carry every token once, then the finish
    got, done = [], None
    while True:
        toks, fin, reason = req.events.get_nowait()
        got += toks
        if fin:
            done = reason
            break
    assert got == req.output and done == "length"


def test_model_len_cap_truncates(tparams):
    eng = _port(tparams, pages_per_slot=4)        # max_model_len 16
    req = eng.submit([1] * 10, SamplingParams(max_tokens=1000, temperature=0.0))
    while not req.finished:
        eng.step()
    assert req.finish_reason == "length" and len(req.output) <= 6


def test_abort_frees_slot_and_pages(tparams):
    eng = _port(tparams)
    free0 = eng.allocator.num_free_pages
    req = eng.submit([4, 5, 6], SamplingParams(max_tokens=40, temperature=0.0))
    eng.step()
    assert req.slot >= 0 and eng.allocator.num_free_pages < free0
    eng.abort(req, "disconnect")
    eng.step()
    assert req.finished and req.finish_reason == "disconnect"
    assert eng.allocator.num_free_pages == free0 and not eng.has_work()


def test_waiting_requests_admit_when_slots_free(tparams):
    eng = _port(tparams, max_decode_slots=2)
    outs = _run(eng, PROMPTS, SamplingParams(max_tokens=4, temperature=0.0))
    assert [len(o) for o in outs] == [4] * len(PROMPTS)
    assert eng.allocator.num_free_pages == 127


def test_shed_finishes_everything(tparams):
    eng = _port(tparams, max_decode_slots=2)
    reqs = [eng.submit(p, SamplingParams(max_tokens=20, temperature=0.0)) for p in PROMPTS]
    eng.step()
    events = eng.shed("error")
    assert len(events) == len(PROMPTS)
    assert all(r.finished and r.finish_reason == "error" for r in reqs)
    assert not eng.has_work() and eng.allocator.num_free_pages == 127


def test_submit_validation(tparams):
    eng = _port(tparams, max_waiting=1)
    with pytest.raises(ValueError, match="empty"):
        eng.submit([])
    with pytest.raises(ValueError, match="top_k"):
        eng.submit([1], SamplingParams(top_k=65))
    with pytest.raises(ValueError, match="presence_penalty"):
        eng.submit([1], SamplingParams(presence_penalty=3.0))
    with pytest.raises(ValueError, match="stop_token_ids"):
        eng.submit([1], SamplingParams(stop_token_ids=tuple(range(9))))
    with pytest.raises(ValueError, match="bucket"):
        eng.submit([1] * 33)
    with pytest.raises(ValueError, match="pages than the pool"):
        _port(tparams, num_pages=8).submit([1] * 20, SamplingParams(max_tokens=20))
    eng.submit([1])
    with pytest.raises(QueueFullError):
        eng.submit([2])
    with pytest.raises(ValueError, match="kv_write"):
        EngineConfig(kv_write="scatter")
    with pytest.raises(ValueError, match="decode_steps"):
        EngineConfig(decode_steps=0)
    assert EngineConfig().max_model_len == 64 * 32


def test_engine_config_defaults_match_jax():
    port, jax_cfg = EngineConfig(), JEngineConfig()
    for field in ("model", "dtype", "max_decode_slots", "page_size", "num_pages",
                  "pages_per_slot", "prefill_buckets", "max_waiting", "decode_steps",
                  "seed", "kv_write"):
        assert getattr(port, field) == getattr(jax_cfg, field), field
    assert port.device == "cuda"
