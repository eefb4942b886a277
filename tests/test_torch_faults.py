"""The port's ``faults.py`` against the JAX package's, and each fault hook
the port wires, on the CPU.

- The ``LLMK_FAULT`` grammar (``get``, ``is_active``, ``get_float``) and the
  one-shot ``claim`` / N-shot ``claim_n`` semantics equal the JAX module's
  under hypothesis (random specs and claim sequences).
- Engine hooks: ``engine_stall`` (the harvester never sees the read
  complete: the watchdog sheds "stalled"), ``slow_step`` (every read
  delayed), ``queue_stall`` (admission held; the port and JAX engines keep
  the request waiting alike).
- Server hooks: ``flappy_replica`` (/ready alternates while /health stays
  green), ``slow_cold_start`` (loading, then serving), ``preempt_replica``
  (one of two servers in the process drains), ``degraded_replica`` (one
  of two servers stretches its streams' pacing), ``net_jitter`` (a random
  delay before each event). ``kill_mid_stream`` is held in
  tests/test_torch_stream_resume.py.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from llms_on_kubernetes_tpu import faults as jfaults
from llms_on_kubernetes_tpu.configs import get_config as jget_config
from llms_on_kubernetes_tpu.engine.engine import Engine as JEngine
from llms_on_kubernetes_tpu.engine.engine import EngineConfig as JEngineConfig
from llms_on_kubernetes_tpu.engine.engine import SamplingParams as JSamplingParams
from llms_on_kubernetes_tpu.models.decoder import init_params as j_init_params
from llms_on_kubernetes_tpu_torch import faults
from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
from llms_on_kubernetes_tpu_torch.engine.tokenizer import ByteTokenizer
from llms_on_kubernetes_tpu_torch.engine.weights import params_from_numpy
from llms_on_kubernetes_tpu_torch.server import openai_api
from llms_on_kubernetes_tpu_torch.server.openai_api import OpenAIServer

SMALL = dict(model="debug-tiny", dtype="float32", max_decode_slots=4, page_size=8,
             num_pages=64, pages_per_slot=8, prefill_buckets=(16, 32))
NAMES = ["engine_stall", "slow_step", "queue_stall", "kill_mid_stream", "flappy_replica",
         "net_jitter", "drop_handoff", "x"]


@pytest.fixture(scope="module")
def jparams():
    return j_init_params(jget_config("debug-tiny"), jax.random.key(0), dtype="float32")


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


@pytest.fixture(autouse=True)
def fresh_claims():
    faults.reset_claims()
    jfaults.reset_claims()
    yield
    faults.reset_claims()
    jfaults.reset_claims()


# ---------------------------------------------------------------------------
# the grammar and the claims, against the JAX module
# ---------------------------------------------------------------------------

SPEC_PART = st.tuples(st.sampled_from(NAMES + [" slow_step ", ""]),
                      st.one_of(st.none(), st.sampled_from(["", "2", "0.5", "-1", "abc", " 3 "])))


def _spec(parts) -> str:
    return ";".join(n if a is None else f"{n}:{a}" for n, a in parts)


@settings(max_examples=400, deadline=None)
@given(parts=st.lists(SPEC_PART, max_size=5), sep=st.sampled_from([";", " ; ", ";;"]))
def test_the_grammar_equals_jax(parts, sep):
    spec = _spec(parts).replace(";", sep)
    old = os.environ.get("LLMK_FAULT")
    os.environ["LLMK_FAULT"] = spec
    try:
        for name in NAMES + ["slow_step"]:
            assert faults.get(name) == jfaults.get(name)
            assert faults.is_active(name) == jfaults.is_active(name)
            assert faults.get_float(name, 7.0) == jfaults.get_float(name, 7.0)
    finally:
        if old is None:
            os.environ.pop("LLMK_FAULT", None)
        else:
            os.environ["LLMK_FAULT"] = old


@settings(max_examples=200, deadline=None)
@given(parts=st.lists(SPEC_PART, max_size=4),
       calls=st.lists(st.tuples(st.sampled_from(["claim", "claim_n"]), st.sampled_from(NAMES),
                                st.sampled_from([1.0, 2.0, 3.0])), max_size=12))
def test_claims_equal_jax(parts, calls):
    old = os.environ.get("LLMK_FAULT")
    os.environ["LLMK_FAULT"] = _spec(parts)
    faults.reset_claims()
    jfaults.reset_claims()
    try:
        for kind, name, n in calls:
            if kind == "claim":
                assert faults.claim(name) == jfaults.claim(name)
            else:
                assert faults.claim_n(name, n) == jfaults.claim_n(name, n)
    finally:
        if old is None:
            os.environ.pop("LLMK_FAULT", None)
        else:
            os.environ["LLMK_FAULT"] = old


def test_inject_delay_and_hang_release_with_the_environment(monkeypatch):
    monkeypatch.setenv("LLMK_FAULT", "slow_step:0.2")
    t0 = time.monotonic()
    faults.inject_delay("slow_step", 5.0)
    assert 0.2 <= time.monotonic() - t0 < 2.0
    faults.inject_hang("engine_stall")          # inactive: returns at once
    assert time.monotonic() - t0 < 2.0


# ---------------------------------------------------------------------------
# the engine's hooks
# ---------------------------------------------------------------------------

def test_engine_stall_is_shed_by_the_watchdog(tparams, monkeypatch):
    monkeypatch.setenv("LLMK_FAULT", "engine_stall")
    eng = Engine(EngineConfig(**SMALL, device="cpu", watchdog_stall_s=0.5), params=tparams)
    eng._est_step = 1e-3
    try:
        req = eng.submit([1, 2, 3], SamplingParams(max_tokens=16, temperature=0.0))
        t0 = time.monotonic()
        while not req.finished:
            assert time.monotonic() - t0 < 30
            eng.step()
        assert req.finish_reason == "stalled" and eng.wedged
        assert time.monotonic() - t0 < 5.0
    finally:
        monkeypatch.delenv("LLMK_FAULT")      # the harvester's hang ends within a second
        eng._harvester.close()


def test_slow_step_delays_every_read(tparams, monkeypatch):
    eng = Engine(EngineConfig(**SMALL, device="cpu", decode_steps=4), params=tparams)
    sp = SamplingParams(max_tokens=9, temperature=0.0)
    want = eng.generate([1, 2, 3], sp)
    monkeypatch.setenv("LLMK_FAULT", "slow_step:0.15")
    t0 = time.monotonic()
    got = eng.generate([1, 2, 3], sp)
    # a first-token read and two windows: at least three delayed reads
    assert got == want and time.monotonic() - t0 >= 0.45


def test_queue_stall_holds_admission_as_jax(jparams, tparams, monkeypatch):
    monkeypatch.setenv("LLMK_FAULT", "queue_stall")
    port = Engine(EngineConfig(**SMALL, device="cpu"), params=tparams)
    jeng = JEngine(JEngineConfig(**SMALL), params=jparams)
    reqs = [port.submit([1, 2, 3], SamplingParams(max_tokens=3, temperature=0.0)),
            jeng.submit([1, 2, 3], JSamplingParams(max_tokens=3, temperature=0.0))]
    for eng in (port, jeng):
        for _ in range(20):
            eng.step()
    assert [(r.output, r.finished, r.slot) for r in reqs] == [([], False, -1)] * 2
    assert port.prefill_calls == 0 and len(port.waiting) == 1
    monkeypatch.delenv("LLMK_FAULT")
    for eng, r in zip((port, jeng), reqs):
        for _ in range(200):
            if r.finished:
                break
            eng.step()
    assert reqs[0].output == reqs[1].output and len(reqs[0].output) == 3


# ---------------------------------------------------------------------------
# the server's hooks
# ---------------------------------------------------------------------------

def _server(tparams):
    srv = OpenAIServer(Engine(EngineConfig(**SMALL, device="cpu"), params=tparams),
                       ByteTokenizer(), "debug-tiny")
    return srv, f"http://127.0.0.1:{srv.start()}"


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _complete(base, body):
    req = urllib.request.Request(base + "/v1/completions", data=json.dumps(body).encode(),
                                 method="POST", headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read()


def test_flappy_replica_flaps_ready_while_health_stays_green(tparams, monkeypatch):
    monkeypatch.setenv("LLMK_FAULT", "flappy_replica:0.1")
    srv, base = _server(tparams)
    try:
        seen = set()
        t0 = time.monotonic()
        while len(seen) < 2 and time.monotonic() - t0 < 10:
            status, raw = _get(base, "/ready")
            seen.add((status, json.loads(raw)["state"]))
            assert _get(base, "/health")[0] == 200
            time.sleep(0.03)
        assert seen == {(200, "serving"), (503, "draining")}
        assert _complete(base, {"prompt": "a", "max_tokens": 2})[0] == 200
    finally:
        srv.close()


def test_slow_cold_start_holds_the_replica_loading(tparams, monkeypatch):
    """The replica answers /ready 503 "loading" (and /health 200) for the
    fault's 0.5 s, then serves. The cold-start timer's call is held until
    the test has read /ready once: whether that read lands inside the 0.5
    s would otherwise measure the machine's load, not the port. The hold
    itself is read from the timer: it calls no sooner than 0.5 s after the
    server began to start, and the replica turns serving only then."""
    monkeypatch.setenv("LLMK_FAULT", "slow_cold_start:0.5")
    read, serving, times = threading.Event(), threading.Event(), {}
    go_serving = OpenAIServer._go_serving

    def held(self):
        times["called"] = time.monotonic()
        assert read.wait(120)
        go_serving(self)
        times["serving"] = time.monotonic()
        serving.set()

    monkeypatch.setattr(OpenAIServer, "_go_serving", held)
    started = time.monotonic()
    srv, base = _server(tparams)
    try:
        status, raw = _get(base, "/ready")
        read_at = time.monotonic()
        assert (status, json.loads(raw)["state"]) == (503, "loading")
        assert _get(base, "/health")[0] == 200
        read.set()
        assert serving.wait(120)
        assert times["called"] - started >= 0.5
        assert times["serving"] >= max(times["called"], read_at)
        assert _get(base, "/ready")[0] == 200
        assert _complete(base, {"prompt": "a", "max_tokens": 2})[0] == 200
    finally:
        read.set()
        srv.close()


def test_preempt_replica_drains_exactly_one_server(tparams, monkeypatch):
    monkeypatch.setenv("LLMK_FAULT", "preempt_replica:0.2")
    servers = [_server(tparams) for _ in range(2)]
    try:
        t0 = time.monotonic()
        while sum(s.state == "draining" for s, _ in servers) < 1:
            assert time.monotonic() - t0 < 10
            time.sleep(0.05)
        time.sleep(0.5)
        states = sorted(s.state for s, _ in servers)
        assert states == ["draining", "serving"]
        drained = next(b for s, b in servers if s.state == "draining")
        assert _get(drained, "/ready")[0] == 503
    finally:
        for s, _ in servers:
            s.close()


def test_degraded_replica_stretches_one_servers_pacing(tparams, monkeypatch):
    """One of two servers in the process claims the fault; its deliveries
    sleep (factor - 1) x the time since the previous event, the other's
    never do."""
    import time as real_time

    sleeps = []

    class RecordingTime:
        def __getattr__(self, name):
            return getattr(real_time, name)

        @staticmethod
        def sleep(s):
            sleeps.append(s)
            real_time.sleep(s)

    body = {"prompt": "abc", "max_tokens": 12, "temperature": 0, "stream": True}
    monkeypatch.setenv("LLMK_FAULT", "slow_step:0.02;degraded_replica:3")
    victim, vbase = _server(tparams)
    healthy, hbase = _server(tparams)
    try:
        monkeypatch.setattr(openai_api, "time", RecordingTime())
        status, raw = _complete(vbase, body)
        assert status == 200 and raw.decode().rstrip().endswith("data: [DONE]")
        stretched = list(sleeps)
        sleeps.clear()
        _complete(hbase, body)
        assert (victim._degraded_factor, healthy._degraded_factor) == (3.0, 1.0)
        assert stretched and sum(stretched) > 0 and not sleeps
    finally:
        monkeypatch.undo()
        healthy.close()
        victim.close()


def test_net_jitter_delays_every_event(tparams, monkeypatch):
    draws = []

    class Recording:
        @staticmethod
        def uniform(a, b):
            draws.append((a, b))
            return 0.0

    monkeypatch.setattr(openai_api, "random", Recording)
    monkeypatch.setenv("LLMK_FAULT", "net_jitter:30")
    srv, base = _server(tparams)
    try:
        status, raw = _complete(base, {"prompt": "abc", "max_tokens": 5, "temperature": 0})
        assert status == 200
        assert len(draws) >= 2 and set(draws) == {(0.0, 0.03)}
    finally:
        srv.close()
