"""The port's stall watchdog and serving lifecycle, on the CPU
(counterparts of tests/test_faults.py's watchdog and /health-/ready
tests).

A wedged card is simulated by a harvester read that never returns (the
harvester thread blocks as it would in ``torch.cuda.Event.synchronize``
on a step that never completes): the engine thread must give up after its
budget, finish every request with "stalled", wedge, refuse submissions,
and the server must answer /health and /ready 503 instead of hanging.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from llms_on_kubernetes_tpu_torch.engine import engine as tengine
from llms_on_kubernetes_tpu_torch.engine.engine import (
    Engine, EngineConfig, EngineStallError, SamplingParams,
)
from llms_on_kubernetes_tpu_torch.engine.tokenizer import ByteTokenizer
from llms_on_kubernetes_tpu_torch.server.openai_api import OpenAIServer

SMALL = dict(model="debug-tiny", dtype="float32", max_decode_slots=4, page_size=8,
             num_pages=64, pages_per_slot=8, prefill_buckets=(16, 32), device="cpu")


def _engine(**kw) -> Engine:
    eng = Engine(EngineConfig(**{**SMALL, **kw}))
    eng._est_step = 1e-3        # the budget is then watchdog_stall_s
    return eng


@pytest.fixture
def wedged_card(monkeypatch):
    """Every harvester read blocks until the test ends (a step the card
    never completes); the release lets the harvester threads finish."""
    release = threading.Event()
    real = tengine._HostCopy.read

    def stuck(self):
        release.wait()
        return real(self)

    monkeypatch.setattr(tengine._HostCopy, "read", stuck)
    yield release
    release.set()


def test_watchdog_sheds_a_stalled_step(wedged_card):
    eng = _engine(watchdog_stall_s=0.3)
    reqs = [eng.submit([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=8)),
            eng.submit([4, 5, 6, 7], SamplingParams(temperature=0.0, max_tokens=8)),
            eng.submit(list(range(20)), SamplingParams(temperature=0.0, max_tokens=8))]
    t0 = time.monotonic()
    while not all(r.finished for r in reqs):
        assert time.monotonic() - t0 < 60, "the watchdog never fired"
        eng.step()
    assert [r.finish_reason for r in reqs] == ["stalled"] * 3
    assert all(r.events.get_nowait()[2] == "stalled" for r in reqs)   # delivered once
    assert all(r.events.empty() for r in reqs)
    assert eng.wedged and not eng.has_work()
    with pytest.raises(EngineStallError):
        eng.submit([1, 2], SamplingParams(max_tokens=4))
    assert eng.step() == []                 # a wedged engine does nothing
    wedged_card.set()       # the card comes back: the harvester may finish


def test_the_budget_is_the_larger_of_the_floor_and_50_steps():
    eng = _engine(watchdog_stall_s=2.0)
    eng._est_step = 0.01
    assert eng._stall_budget() == 2.0
    eng._est_step = 0.1
    assert eng._stall_budget() == pytest.approx(5.0)
    assert _engine(watchdog_stall_s=0)._stall_budget() is None
    assert _engine(watchdog_stall_s=-1)._stall_budget() is None


def test_watchdog_default_comes_from_the_environment(monkeypatch):
    monkeypatch.setenv("LLMK_WATCHDOG_S", "7.5")
    assert EngineConfig(device="cpu").watchdog_stall_s == 7.5
    monkeypatch.delenv("LLMK_WATCHDOG_S")
    assert EngineConfig(device="cpu").watchdog_stall_s == 120.0


def test_a_healthy_card_is_never_shed():
    eng = _engine(watchdog_stall_s=0.05)
    req = eng.submit([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=12))
    while eng.has_work():
        eng.step()
    assert req.finish_reason == "length" and not eng.wedged


def call(base, path, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(base + path, data=data,
                                 method="POST" if data is not None else "GET",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_lifecycle_states_and_probes():
    """loading -> serving -> (wedged) -> draining: /health fails only when
    wedged, /ready passes only while serving, llm_engine_state follows."""
    srv = OpenAIServer(_engine(), ByteTokenizer(), "debug-tiny")
    assert srv.state == "loading"
    base = f"http://127.0.0.1:{srv.start()}"
    try:
        status, _, body = call(base, "/ready")
        assert status == 200 and json.loads(body)["state"] == "serving"
        assert call(base, "/health")[0] == 200
        assert "llm_engine_state 1" in call(base, "/metrics")[2].decode()

        srv.engine.wedged = True            # what the watchdog sets
        status, _, body = call(base, "/ready")
        assert status == 503 and json.loads(body)["state"] == "wedged"
        assert call(base, "/health")[0] == 503
        assert "llm_engine_state 3" in call(base, "/metrics")[2].decode()
        status, headers, body = call(base, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "hi"}], "max_tokens": 4})
        assert status == 503 and json.loads(body)["error"]["code"] == "engine_stalled"
        assert headers.get("Retry-After")

        srv.engine.wedged = False
        srv.begin_drain()
        status, _, body = call(base, "/ready")
        assert status == 503 and json.loads(body)["state"] == "draining"
        assert call(base, "/health")[0] == 200      # draining is healthy
        assert "llm_engine_state 2" in call(base, "/metrics")[2].decode()
        status, headers, body = call(base, "/v1/completions", {"prompt": "ab"})
        assert status == 503 and json.loads(body)["error"]["code"] == "shutting_down"
        assert headers.get("Retry-After") == "5"
    finally:
        srv.close()


def test_a_wedged_card_turns_the_server_503_and_never_hangs(wedged_card):
    """A card that never finishes a step: the requests in flight end
    ("stalled": 503 for a non-streamed one, a final chunk for a streamed
    one), /health and /ready answer 503 within the budget, and new
    requests get 503 at once."""
    srv = OpenAIServer(_engine(watchdog_stall_s=0.3), ByteTokenizer(), "debug-tiny")
    base = f"http://127.0.0.1:{srv.start()}"
    try:
        results = {}

        def full():
            results["full"] = call(base, "/v1/completions", {
                "prompt": "abc", "max_tokens": 16, "temperature": 0})

        def stream():
            results["stream"] = call(base, "/v1/completions", {
                "prompt": "xyz", "max_tokens": 16, "temperature": 0, "stream": True})

        threads = [threading.Thread(target=full), threading.Thread(target=stream)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads), "a client hung"
        status, _, body = results["full"]
        assert status == 503 and json.loads(body)["error"]["code"] == "engine_stalled"
        status, _, raw = results["stream"]
        frames = [line[6:] for line in raw.decode().splitlines() if line.startswith("data: ")]
        assert status == 200 and frames[-1] == "[DONE]"
        assert [json.loads(f)["choices"][0]["finish_reason"] for f in frames[:-1]][-1] \
            == "stalled"
        while call(base, "/health")[0] != 503:
            assert time.monotonic() - t0 < 30
            time.sleep(0.05)
        assert call(base, "/ready")[0] == 503
        status, _, body = call(base, "/v1/completions", {"prompt": "ab", "max_tokens": 2})
        assert status == 503 and json.loads(body)["error"]["code"] == "engine_stalled"
    finally:
        wedged_card.set()
        srv.close()
