"""Stream journal and resume in the port (counterparts of
tests/test_stream_resume.py), on the CPU, debug-tiny in float32 with the
JAX weights on both sides.

- Engine: ``SamplingParams.prefix_tokens`` rides the resumed re-prefill
  path, so a stream cut after 1, 5 and 11 tokens and resumed with that
  prefix is the uninterrupted one token for token, greedy and seeded, at
  decode_steps 1 and 4; greedy streams equal the JAX engine's, and the JAX
  engine's resumes hold the same property. Penalties are rebuilt from the
  prefix; the prefix counts toward max_tokens; bad prefixes are refused as
  the JAX engine refuses them.
- Server: ``X-LLMK-Journal`` gives a ``: llmk-tok`` comment after each
  event's data, naming the ids the JAX server journals for the same
  request; ``X-LLMK-Resume-Tokens`` (with the stream id and ``created``
  headers) continues a stream byte for byte, with no role chunk; a
  non-streaming or malformed resume is refused with 400, as by the JAX
  server; ``LLMK_FAULT=kill_mid_stream`` resets the client's socket.
- Behind ``llkt-router`` (``native/router``, built with g++) with two port
  replicas, ``kill_mid_stream:4`` resets one stream mid-generation and the
  client's stream equals the uninterrupted one, with no error event; the
  router counts one resume.
"""

import asyncio
import dataclasses
import http.client
import json
import shutil
import socket
import subprocess
import time
import urllib.error
import urllib.request
from pathlib import Path

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
from llms_on_kubernetes_tpu_torch import faults
from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
from llms_on_kubernetes_tpu_torch.engine.tokenizer import ByteTokenizer
from llms_on_kubernetes_tpu_torch.engine.weights import params_from_numpy
from llms_on_kubernetes_tpu_torch.server.openai_api import OpenAIServer

REPO = Path(__file__).resolve().parent.parent
GREEDY = dict(temperature=0.0)
SEEDED = dict(temperature=0.9, top_k=20, seed=1234)
ENGINE = dict(model="debug-tiny", dtype="float32", max_decode_slots=4, page_size=4,
              num_pages=128, pages_per_slot=16, prefill_buckets=(16, 32))
SERVER = dict(ENGINE, num_pages=256, pages_per_slot=32, prefill_buckets=(32, 64))
STREAM_BODY = {"model": "debug-tiny", "messages": [{"role": "user", "content": "hello"}],
               "max_tokens": 8, "temperature": 0, "stream": True}


@pytest.fixture(scope="module")
def jparams():
    return j_init_params(jget_config("debug-tiny"), jax.random.key(0), dtype="float32")


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _port(tparams, **kw):
    return Engine(EngineConfig(**{**ENGINE, "device": "cpu", **kw}), params=tparams)


def _jax(jparams, **kw):
    return JEngine(JEngineConfig(**{**ENGINE, **kw}), params=jparams)


def _finish(eng, req):
    for _ in range(5_000):
        if req.finished:
            return req
        eng.step()
    raise AssertionError("the request did not finish")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("decode_steps", [1, 4])
@pytest.mark.parametrize("sampling", [GREEDY, SEEDED], ids=["greedy", "seeded"])
def test_resume_bit_identical(jparams, tparams, decode_steps, sampling):
    """tests/test_stream_resume.py:57 on both engines: every cut resumes
    into the uninterrupted stream; the port's greedy stream is the JAX
    engine's (the port's sampling noise is its own, so seeded streams are
    held each to its own engine)."""
    prompt = [3, 17, 9, 5]
    sp, jsp = SamplingParams(max_tokens=12, **sampling), JSamplingParams(max_tokens=12,
                                                                          **sampling)
    full = _port(tparams, decode_steps=decode_steps).generate(prompt, sp)
    jfull = _jax(jparams, decode_steps=decode_steps).generate(prompt, jsp)
    assert len(full) == len(jfull) == 12
    if sampling is GREEDY:
        assert full == jfull
    for cut in (1, 5, 11):
        eng = _port(tparams, decode_steps=decode_steps)
        req = _finish(eng, eng.submit(prompt, dataclasses.replace(
            sp, prefix_tokens=tuple(full[:cut]))))
        assert req.output == full and req.finish_reason == "length", cut
        jeng = _jax(jparams, decode_steps=decode_steps)
        jreq = _finish(jeng, jeng.submit(prompt, dataclasses.replace(
            jsp, prefix_tokens=tuple(jfull[:cut]))))
        assert jreq.output == jfull, cut


def test_a_resumed_seeded_stream_keys_its_noise_on_the_original_prompt(tparams):
    """The resumed re-prefill packs the original prompt length (the
    penalty boundary) and samples at the same positions, so a seeded
    stream with penalties resumes exactly; a prefix taken as part of the
    prompt would not."""
    prompt = [3, 17, 9, 5]
    sp = SamplingParams(max_tokens=10, presence_penalty=1.0, frequency_penalty=0.5,
                        **SEEDED)
    full = _port(tparams).generate(prompt, sp)
    eng = _port(tparams)
    req = _finish(eng, eng.submit(prompt, dataclasses.replace(sp, prefix_tokens=tuple(
        full[:5]))))
    assert req.output == full
    as_prompt = _port(tparams).generate(prompt + full[:5], dataclasses.replace(
        sp, max_tokens=5))
    assert as_prompt != full[5:]


def test_resume_with_penalties_matches_uninterrupted(jparams, tparams):
    sp = dict(max_tokens=10, presence_penalty=1.5, frequency_penalty=0.5, **GREEDY)
    prompt = [3, 17, 9, 5]
    full = _port(tparams).generate(prompt, SamplingParams(**sp))
    assert full == _jax(jparams).generate(prompt, JSamplingParams(**sp))
    eng = _port(tparams)
    req = _finish(eng, eng.submit(prompt, SamplingParams(**sp, prefix_tokens=tuple(full[:4]))))
    assert req.output == full


def test_prefix_counts_toward_max_tokens(tparams):
    sp = SamplingParams(max_tokens=8, **GREEDY)
    full = _port(tparams).generate([1, 2, 3], sp)
    eng = _port(tparams)
    req = _finish(eng, eng.submit([1, 2, 3], dataclasses.replace(sp, prefix_tokens=tuple(
        full[:5]))))
    assert len(req.output) == 8 and req.finish_reason == "length" and req.output == full


@pytest.mark.parametrize("case", ["outside the vocabulary", "max_tokens", "max_model_len"])
def test_prefix_validation_as_jax(jparams, tparams, case):
    prefix, max_tokens, prompt = {
        "outside the vocabulary": ((10 ** 9,), 4, [1, 2]),
        "max_tokens": ((5, 6), 2, [1, 2]),
        "max_model_len": ((5,) * 30, 40, [1] * 40),
    }[case]
    for eng, sp in ((_port(tparams), SamplingParams), (_jax(jparams), JSamplingParams)):
        with pytest.raises(ValueError, match=case):
            eng.submit(prompt, sp(max_tokens=max_tokens, prefix_tokens=prefix, **GREEDY))


# ---------------------------------------------------------------------------
# the server: journal, resume headers, kill_mid_stream
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_base(tparams):
    srv = OpenAIServer(Engine(EngineConfig(**SERVER, device="cpu"), params=tparams),
                       ByteTokenizer(), "debug-tiny")
    yield f"http://127.0.0.1:{srv.start()}"
    srv.close()


def _post(base, body, headers=None, path="/v1/chat/completions"):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _jax_post(jparams, calls):
    """[(status, text)] of ``calls`` [(body, headers)] on a JAX server."""
    async def go():
        srv = JOpenAIServer(JEngine(JEngineConfig(**SERVER), params=jparams), JByteTokenizer(),
                            "debug-tiny")
        client = TestClient(TestServer(srv.make_app()))
        await client.start_server()
        out = []
        try:
            for body, headers in calls:
                r = await client.post("/v1/chat/completions", json=body, headers=headers)
                out.append((r.status, await r.text()))
        finally:
            await client.close()
        return out
    return asyncio.run(go())


def _events(raw: str) -> list:
    return [json.loads(ln[6:]) for ln in raw.splitlines()
            if ln.startswith("data: ") and ln != "data: [DONE]"]


def _text(raw: str) -> str:
    return "".join(e["choices"][0]["delta"].get("content", "") for e in _events(raw))


def _journal(raw: str) -> list[int]:
    """The journaled ids; every comment follows a data line."""
    toks, data_seen = [], 0
    for line in raw.splitlines():
        if line.startswith("data: "):
            data_seen += 1
        elif line.startswith(": llmk-tok"):
            assert data_seen > 0
            toks += [int(x) for x in line[len(": llmk-tok"):].split(",") if x.strip()]
    return toks


def test_journal_comments_follow_data_and_equal_jax(port_base, jparams):
    status, raw = _post(port_base, STREAM_BODY, {"X-LLMK-Journal": "1"})
    assert status == 200
    toks = _journal(raw)
    assert len(toks) == 8
    assert ": llmk-tok" not in _post(port_base, STREAM_BODY)[1]
    # a multi-choice stream is not journaled
    assert ": llmk-tok" not in _post(port_base, {**STREAM_BODY, "n": 2},
                                     {"X-LLMK-Journal": "1"})[1]
    (jstatus, jraw), = _jax_post(jparams, [(STREAM_BODY, {"X-LLMK-Journal": "1"})])
    assert jstatus == 200 and _journal(jraw) == toks and _text(jraw) == _text(raw)


@pytest.mark.parametrize("cut", [1, 3, 7])
def test_resume_headers_replay_idempotently(port_base, cut):
    """tests/test_stream_resume.py:177: the same id and created, no role
    chunk, and the text delivered up to the journaled cut plus the
    continuation is the uninterrupted text."""
    status, raw = _post(port_base, STREAM_BODY, {"X-LLMK-Journal": "1"})
    full_text = _text(raw)
    toks, delivered, at_cut = [], "", None
    for line in raw.splitlines():
        if line.startswith("data: ") and line != "data: [DONE]":
            delivered += json.loads(line[6:])["choices"][0]["delta"].get("content", "")
        elif line.startswith(": llmk-tok"):
            toks += [int(x) for x in line[len(": llmk-tok"):].split(",") if x.strip()]
            if at_cut is None and len(toks) >= cut:
                at_cut = delivered
    status2, raw2 = _post(port_base, STREAM_BODY, {
        "X-LLMK-Resume-Tokens": ",".join(map(str, toks[:cut])),
        "X-LLMK-Resume-Stream-Id": "chatcmpl-orig", "X-LLMK-Resume-Created": "12345"})
    events = _events(raw2)
    assert status2 == 200 and events
    assert all(e["id"] == "chatcmpl-orig" and e["created"] == 12345 for e in events)
    assert not any(e["choices"][0]["delta"].get("role") for e in events)
    assert at_cut + _text(raw2) == full_text
    assert raw2.rstrip().endswith("data: [DONE]")


def test_resume_rejected_on_non_streaming_and_malformed_as_jax(port_base, jparams):
    calls = [({**STREAM_BODY, "stream": False}, {"X-LLMK-Resume-Tokens": "1,2"}),
             (STREAM_BODY, {"X-LLMK-Resume-Tokens": "1,zap"}),
             ({**STREAM_BODY, "n": 2}, {"X-LLMK-Resume-Tokens": "1,2"})]
    got = [_post(port_base, b, h) for b, h in calls]
    want = _jax_post(jparams, calls)
    assert [s for s, _ in got] == [s for s, _ in want] == [400, 400, 400]
    assert "malformed" in json.loads(got[1][1])["error"]["message"]


def test_kill_mid_stream_resets_the_socket(port_base, monkeypatch):
    monkeypatch.setenv("LLMK_FAULT", "kill_mid_stream:3")
    faults.reset_claims()
    try:
        host, port = port_base[len("http://"):].split(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=60)
        conn.request("POST", "/v1/chat/completions",
                     json.dumps({**STREAM_BODY, "max_tokens": 12}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = b""
        with pytest.raises((ConnectionResetError, http.client.IncompleteRead, OSError)):
            while True:
                chunk = resp.read1(65536)
                if not chunk:
                    raise OSError("closed without [DONE]")
                raw += chunk
                assert b"[DONE]" not in raw
        assert b"[DONE]" not in raw
        # one-shot: the next stream is whole
        assert _post(port_base, STREAM_BODY)[1].rstrip().endswith("data: [DONE]")
    finally:
        faults.reset_claims()


# ---------------------------------------------------------------------------
# behind llkt-router: a replica dies mid-stream, the client sees nothing
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def router_binary(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build native/router")
    out = tmp_path_factory.mktemp("router") / "llkt-router"
    subprocess.run(["g++", "-O2", "-std=c++17", "-pthread", "-o", str(out),
                    str(REPO / "native" / "router" / "router.cpp")], check=True,
                   capture_output=True, timeout=600)
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _router_metric(base: str, name: str, label: str) -> float:
    """A series of the router's /metrics: ``name`` with ``label`` among
    its labels (0 before the router listens)."""
    try:
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            text = r.read().decode()
    except OSError:
        return 0.0
    for line in text.splitlines():
        if line.startswith(name + "{") and label in line:
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def test_kill_mid_stream_behind_llkt_router_splices_the_same_text(router_binary, tparams,
                                                                  monkeypatch):
    servers = [OpenAIServer(Engine(EngineConfig(**SERVER, device="cpu"), params=tparams),
                            ByteTokenizer(), "debug-tiny") for _ in range(2)]
    bases = [f"http://127.0.0.1:{s.start()}" for s in servers]
    rport = _free_port()
    router = subprocess.Popen(
        [str(router_binary), "--models", "debug-tiny=" + "|".join(bases), "--port", str(rport),
         "--probe-interval", "0.2", "--breaker-threshold", "100", "--quiet"],
        stderr=subprocess.DEVNULL)
    rbase = f"http://127.0.0.1:{rport}"
    body = {**STREAM_BODY, "max_tokens": 12}
    try:
        t0 = time.monotonic()
        while True:
            assert router.poll() is None, "llkt-router exited"
            healthy = [_router_metric(rbase, "llm_replica_healthy", f'replica="{b}"')
                       for b in bases]
            if healthy == [1.0, 1.0]:
                break
            assert time.monotonic() - t0 < 20, "the router never admitted both replicas"
            time.sleep(0.1)
        status, reference = _post(rbase, body)
        assert status == 200 and _text(reference)
        monkeypatch.setenv("LLMK_FAULT", "kill_mid_stream:4")
        faults.reset_claims()
        status, raw = _post(rbase, body)
        assert status == 200
        assert _text(raw) == _text(reference)
        assert ": llmk-tok" not in raw and "upstream_lost" not in raw and "error" not in raw
        assert raw.rstrip().endswith("data: [DONE]")
        assert _router_metric(rbase, "llm_stream_resume_total", 'outcome="ok"') == 1.0
    finally:
        faults.reset_claims()
        router.terminate()
        router.wait(timeout=30)
        for s in servers:
            s.close()
