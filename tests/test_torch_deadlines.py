"""Request deadlines in the port against the JAX package, on the CPU.

- Engine (debug-tiny, float32, the JAX weights on both sides): a waiting
  request past its deadline is shed with "timeout" and never prefilled;
  a running one is aborted with "timeout" with decode windows in flight
  (depth 1 and 2, the windows' completions held by ``DemandGate``): its
  slot and pages come back and the other request's greedy stream is the
  one the JAX engine gives.
- Server, over HTTP: the port server and the JAX server answer the same
  statuses, error codes and finish reasons, and count the same
  ``llm_deadline_exceeded_total{phase}``, for a deadline expired on
  arrival (504), a malformed header (none), a request shed in the queue
  (admission held by ``LLMK_FAULT=queue_stall``: 504), the body's
  ``timeout`` and a deadline that expires mid-decode (decode slowed by
  ``LLMK_FAULT=slow_step``, 0.1 s a read: a stream ends with finish_reason "timeout", a
  completion with output answers 200 "timeout").
"""

import asyncio
import contextlib
import json
import os
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from llms_on_kubernetes_tpu.configs import get_config as jget_config
from llms_on_kubernetes_tpu.engine.engine import Engine as JEngine
from llms_on_kubernetes_tpu.engine.engine import EngineConfig as JEngineConfig
from llms_on_kubernetes_tpu.engine.engine import SamplingParams as JSamplingParams
from llms_on_kubernetes_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from llms_on_kubernetes_tpu.models.decoder import init_params as j_init_params
from llms_on_kubernetes_tpu.server.openai_api import OpenAIServer as JOpenAIServer
from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
from llms_on_kubernetes_tpu_torch.engine.tokenizer import ByteTokenizer
from llms_on_kubernetes_tpu_torch.engine.weights import params_from_numpy
from llms_on_kubernetes_tpu_torch.server.openai_api import OpenAIServer
from test_torch_engine_async import DemandGate

SMALL = dict(model="debug-tiny", dtype="float32", max_decode_slots=4, page_size=8,
             num_pages=64, pages_per_slot=8, prefill_buckets=(16, 32))
# 512 tokens a slot: at slow_step 0.1 (at most two windows of 4 tokens a
# read) a stream takes >= 6 s, far past the mid-decode deadlines
SERVE = dict(model="debug-tiny", dtype="float32", max_decode_slots=4, page_size=4,
             num_pages=300, pages_per_slot=128, prefill_buckets=(32, 64))
DEADLINE = "X-LLMK-Deadline-Ms"


@pytest.fixture(scope="module")
def jparams():
    return j_init_params(jget_config("debug-tiny"), jax.random.key(0), dtype="float32")


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


@contextlib.contextmanager
def fault(spec):
    old = os.environ.get("LLMK_FAULT")
    if spec:
        os.environ["LLMK_FAULT"] = spec
    else:
        os.environ.pop("LLMK_FAULT", None)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("LLMK_FAULT", None)
        else:
            os.environ["LLMK_FAULT"] = old


def _step_until(eng, cond, limit=20_000):
    for _ in range(limit):
        if cond():
            return
        eng.step()
    raise AssertionError("the engine did not get there")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def test_a_waiting_request_past_its_deadline_is_shed_without_a_prefill(jparams, tparams):
    with fault("queue_stall"):
        port = Engine(EngineConfig(**SMALL, device="cpu"), params=tparams)
        jeng = JEngine(JEngineConfig(**SMALL), params=jparams)
        got = []
        for eng, sp in ((port, SamplingParams), (jeng, JSamplingParams)):
            req = eng.submit([1, 2, 3], sp(temperature=0.0, max_tokens=8),
                             deadline=time.monotonic() + 0.05)
            eng.step()
            assert not req.finished          # admission is held, the deadline not yet due
            time.sleep(0.06)
            _step_until(eng, lambda: req.finished)
            got.append((req.finish_reason, req.output, req.admitted_at))
        assert got[0] == got[1] == ("timeout", [], None)
        assert port.prefill_calls == port.chunk_calls == 0 and not port.has_work()


@pytest.mark.parametrize("depth", [1, 2])
def test_a_running_request_past_its_deadline_is_aborted_with_windows_in_flight(
        jparams, tparams, depth):
    sp = dict(temperature=0.0, max_tokens=60)
    port = Engine(EngineConfig(**SMALL, device="cpu", async_depth=depth), params=tparams)
    gate = DemandGate(port._harvester)
    try:
        req = port.submit([1, 2, 3], SamplingParams(**sp), deadline=time.monotonic() + 3600)
        other = port.submit([4, 5], SamplingParams(temperature=0.0, max_tokens=10))
        for _ in range(3):
            port.step()
        assert bool(port._inflight) == (depth > 1)
        assert req.output and not req.finished
        req.deadline = time.monotonic() - 1.0
        gate.release()
        events = port.step()
        assert req.finished and req.finish_reason == "timeout" and req.slot == -1
        assert [ev.finish_reason for ev in events if ev.request is req] == ["timeout"]
        _step_until(port, lambda: other.finished)
        port._drain_async()
    finally:
        gate.release()
    assert not port.has_work() and all(s is None for s in port.slots)
    alloc = port.allocator
    assert alloc.num_free_pages + alloc.num_evictable_pages == 63
    # the JAX engine: the same abort, and the survivor's stream
    jeng = JEngine(JEngineConfig(**SMALL, async_depth=depth), params=jparams)
    jreq = jeng.submit([1, 2, 3], JSamplingParams(**sp), deadline=time.monotonic() + 3600)
    jother = jeng.submit([4, 5], JSamplingParams(temperature=0.0, max_tokens=10))
    _step_until(jeng, lambda: jreq.output)
    jreq.deadline = time.monotonic() - 1.0
    _step_until(jeng, lambda: jreq.finished and jother.finished)
    assert jreq.finish_reason == "timeout"
    assert (other.output, other.finish_reason) == (jother.output, jother.finish_reason)


def test_submit_takes_a_deadline_and_a_seated_request_records_admission(tparams):
    eng = Engine(EngineConfig(**SMALL, device="cpu"), params=tparams)
    t = time.monotonic() + 5.0
    req = eng.submit([1, 2, 3], SamplingParams(max_tokens=2), deadline=t)
    assert req.deadline == t and req.admitted_at is None
    _step_until(eng, lambda: req.finished)
    assert req.finish_reason == "length" and req.admitted_at is not None


# ---------------------------------------------------------------------------
# the servers
# ---------------------------------------------------------------------------

BODY = {"temperature": 0}
# name -> (fault, headers, body). Each prompt shares no page with another:
# a prefix-cache hit takes the JAX engine's chunk path, which leaves
# Request.admitted_at unset (its decode-phase timeouts count as "queue")
CASES = {
    "expired on arrival": (None, {DEADLINE: "0"}, {**BODY, "max_tokens": 4, "prompt": "aaaa"}),
    "malformed header": (None, {DEADLINE: "soon"}, {**BODY, "max_tokens": 4,
                                                    "prompt": "bbbb"}),
    "shed in the queue": ("queue_stall", {DEADLINE: "300"}, {**BODY, "max_tokens": 4,
                                                              "prompt": "cccc"}),
    "body timeout shed in the queue": ("queue_stall", {}, {**BODY, "max_tokens": 4,
                                                           "timeout": 0.3, "prompt": "dddd"}),
    "expires mid-decode": ("slow_step:0.1", {DEADLINE: "1500"},
                           {**BODY, "max_tokens": 1000, "prompt": "eeee"}),
    "expires mid-decode streamed": ("slow_step:0.1", {DEADLINE: "1500"},
                                    {**BODY, "max_tokens": 1000, "stream": True,
                                     "prompt": "ffff"}),
    "shed in the queue streamed": ("queue_stall", {DEADLINE: "300"},
                                   {**BODY, "max_tokens": 4, "stream": True, "prompt": "gggg"}),
}
WARM = {**BODY, "max_tokens": 8, "prompt": "warm"}


def _deadline_counts(metrics: str) -> dict:
    out = {"queue": 0.0, "decode": 0.0}
    for line in metrics.splitlines():
        if line.startswith("llm_deadline_exceeded_total{"):
            phase = line.split('phase="', 1)[1].split('"', 1)[0]
            out[phase] = float(line.rsplit(" ", 1)[1])
    return out


def settled(counts, before: dict) -> dict:
    """The counts once the engine loop has counted the request: it counts
    a step's finishes after it delivered their events, so the answer can
    come first (at most 1 s)."""
    after = counts()
    for _ in range(20):
        if after != before:
            break
        time.sleep(0.05)
        after = counts()
    return after


def _summary(status: int, raw: bytes, stream: bool) -> tuple:
    """(status, error code or finish reason, some output?)."""
    if status != 200:
        return status, json.loads(raw)["error"].get("code"), False
    if stream:
        frames = [json.loads(ln[6:]) for ln in raw.decode().splitlines()
                  if ln.startswith("data: ") and ln != "data: [DONE]"]
        reasons = [f["choices"][0]["finish_reason"] for f in frames
                   if f["choices"] and f["choices"][0]["finish_reason"]]
        assert raw.decode().rstrip().endswith("data: [DONE]") and len(reasons) == 1
        return status, reasons[0], bool("".join(f["choices"][0]["text"] for f in frames))
    ch = json.loads(raw)["choices"][0]
    return status, ch["finish_reason"], bool(ch["text"])


def _port_answers(tparams) -> dict:
    srv = OpenAIServer(Engine(EngineConfig(**SERVE, device="cpu"), params=tparams),
                       ByteTokenizer(), "debug-tiny")
    base = f"http://127.0.0.1:{srv.start()}"

    def post(headers, body):
        req = urllib.request.Request(base + "/v1/completions", data=json.dumps(body).encode(),
                                     method="POST",
                                     headers={"Content-Type": "application/json", **headers})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def counts():
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            return _deadline_counts(r.read().decode())

    out = {}
    try:
        post({}, WARM)          # as warm as the JAX side
        for name, (spec, headers, body) in CASES.items():
            before = counts()
            with fault(spec):
                status, raw = post(headers, body)
            after = settled(counts, before)
            out[name] = (_summary(status, raw, bool(body.get("stream"))),
                         {k: after[k] - before[k] for k in after})
    finally:
        srv.close()
    return out


def _jax_answers(jparams) -> dict:
    async def go():
        srv = JOpenAIServer(JEngine(JEngineConfig(**SERVE), params=jparams), JByteTokenizer(),
                            "debug-tiny")
        client = TestClient(TestServer(srv.make_app()))
        await client.start_server()

        async def counts():
            r = await client.get("/metrics")
            return _deadline_counts(await r.text())

        out = {}
        try:
            await (await client.post("/v1/completions", json=WARM)).read()
            for name, (spec, headers, body) in CASES.items():
                before = await counts()
                with fault(spec):
                    r = await client.post("/v1/completions", json=body, headers=headers)
                    raw = await r.read()
                after = await counts()
                for _ in range(20):
                    if after != before:
                        break
                    await asyncio.sleep(0.05)
                    after = await counts()
                out[name] = (_summary(r.status, raw, bool(body.get("stream"))),
                             {k: after[k] - before[k] for k in after})
        finally:
            await client.close()
        return out
    return asyncio.run(go())


@pytest.fixture(scope="module")
def answers(jparams, tparams):
    return _port_answers(tparams), _jax_answers(jparams)


@pytest.mark.parametrize("name", list(CASES))
def test_deadline_answers_equal_the_jax_server(answers, name):
    got, want = answers[0][name], answers[1][name]
    assert got == want, (name, got, want)


def test_deadline_answers_are_the_documented_ones(answers):
    port = answers[0]
    assert port["expired on arrival"] == ((504, "deadline_exceeded", False),
                                          {"queue": 1.0, "decode": 0.0})
    assert port["malformed header"][0][:2] == (200, "length")
    assert port["shed in the queue"] == ((504, "deadline_exceeded", False),
                                         {"queue": 1.0, "decode": 0.0})
    assert port["expires mid-decode"] == ((200, "timeout", True), {"queue": 0.0, "decode": 1.0})
    assert port["expires mid-decode streamed"] == ((200, "timeout", True),
                                                   {"queue": 0.0, "decode": 1.0})
    assert port["shed in the queue streamed"] == ((200, "timeout", False),
                                                  {"queue": 1.0, "decode": 0.0})
