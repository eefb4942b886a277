"""The port server's request surface and replica contract against the JAX
server, on the CPU.

- Stop strings, logprobs (completions and chat, streamed and not),
  logit_bias, n / best_of, a list of prompts and echo with prompt logprobs,
  /tokenize, /detokenize, /version, /health and /ready (its prefix filter
  after the same requests): the port server (stdlib, urllib)
  and the JAX server (aiohttp TestClient, as tests/test_server.py drives
  it) on debug-tiny in float32 with the same weights answer with the same
  status, the same response and chunk keys, the same greedy text and
  finish reasons, and logprob values within 1e-4 (token strings, offsets
  and top ids exact).
- ``StopChecker`` against the JAX ``StopChecker`` under hypothesis: stops
  split across deltas, overlapping stops, the earliest match winning.
- Drain: a stream in flight when the drain begins ends whole, while
  /ready answers 503 and new requests 503.
- The port's CLI server behind ``llkt-router`` (``native/router``, built
  with g++ into a temporary directory): requests through the router, then
  SIGTERM drains the server, the stream through the router ends whole,
  the router's /metrics reports the replica unhealthy and the process
  exits 0.
"""

import asyncio
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer
from hypothesis import given, settings
from hypothesis import strategies as st

from llms_on_kubernetes_tpu.configs import get_config as jget_config
from llms_on_kubernetes_tpu.engine.engine import Engine as JEngine
from llms_on_kubernetes_tpu.engine.engine import EngineConfig as JEngineConfig
from llms_on_kubernetes_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from llms_on_kubernetes_tpu.models.decoder import init_params as j_init_params
from llms_on_kubernetes_tpu.server.openai_api import OpenAIServer as JOpenAIServer
from llms_on_kubernetes_tpu.server.openai_api import StopChecker as JStopChecker
from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig
from llms_on_kubernetes_tpu_torch.engine.tokenizer import ByteTokenizer
from llms_on_kubernetes_tpu_torch.engine.weights import params_from_numpy
from llms_on_kubernetes_tpu_torch.server.openai_api import OpenAIServer, StopChecker

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(model="debug-tiny", dtype="float32", max_decode_slots=4, page_size=4,
             num_pages=256, pages_per_slot=32, prefill_buckets=(32, 64))
CHAT = [{"role": "user", "content": "tell me"}]


def http(base, path, body=None, timeout=60):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(base + path, data=data,
                                 method="POST" if data is not None else "GET",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture(scope="module")
def params():
    jp = j_init_params(jget_config("debug-tiny"), jax.random.key(0), dtype="float32")
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def port_base(params):
    srv = OpenAIServer(Engine(EngineConfig(**SMALL, device="cpu"), params=params[1]),
                       ByteTokenizer(), "debug-tiny")
    yield f"http://127.0.0.1:{srv.start()}"
    srv.close()


@pytest.fixture(scope="module")
def cases(port_base):
    """name -> (method, path, body). The stop strings come from the port's
    own greedy text of the prompt, so they do occur."""
    _, raw = http(port_base, "/v1/completions", {"prompt": "abc", "max_tokens": 12,
                                                 "temperature": 0})
    text = json.loads(raw)["choices"][0]["text"]
    plain = [i for i, c in enumerate(text) if c.isprintable() and c != "�"]
    a = text[plain[2]]
    b = text[plain[3]:plain[3] + 2]
    greedy = dict(temperature=0, max_tokens=12)
    c = {
        "stop": ("/v1/completions", {"prompt": "abc", **greedy, "stop": [b]}),
        "stop overlapping": ("/v1/completions", {"prompt": "abc", **greedy,
                                                 "stop": [b, a + "zz", a]}),
        "stop streamed": ("/v1/completions", {"prompt": "abc", **greedy, "stop": b,
                                              "stream": True}),
        "stop with logprobs": ("/v1/completions", {"prompt": "abc", **greedy, "stop": [b],
                                                   "logprobs": 2}),
        "stop chat streamed": ("/v1/chat/completions", {"messages": CHAT, **greedy,
                                                        "stop": ["x"], "stream": True}),
        "logprobs 3": ("/v1/completions", {"prompt": "hello", "max_tokens": 6,
                                           "temperature": 0, "logprobs": 3}),
        "logprobs 2": ("/v1/completions", {"prompt": "abc", "max_tokens": 4,
                                           "temperature": 0, "logprobs": 2}),
        "logprobs 0": ("/v1/completions", {"prompt": "abc", "max_tokens": 4,
                                           "temperature": 0, "logprobs": 0}),
        "logprobs streamed": ("/v1/completions", {"prompt": "hello", "max_tokens": 6,
                                                  "temperature": 0, "logprobs": 3,
                                                  "stream": True}),
        "chat logprobs": ("/v1/chat/completions", {"messages": CHAT, "max_tokens": 5,
                                                   "temperature": 0, "logprobs": True,
                                                   "top_logprobs": 5}),
        "chat logprobs streamed": ("/v1/chat/completions", {
            "messages": CHAT, "max_tokens": 5, "temperature": 0, "logprobs": True,
            "top_logprobs": 2, "stream": True, "stream_options": {"include_usage": True}}),
        "logit_bias force": ("/v1/completions", {"prompt": "abc", **greedy,
                                                 "logit_bias": {"65": 100}}),
        "logit_bias ban": ("/v1/completions", {"prompt": "abc", **greedy, "logprobs": 1,
                                               "logit_bias": {str(ord(a)): -100,
                                                              "66": 5}}),
        "logit_bias chat streamed": ("/v1/chat/completions", {
            "messages": CHAT, **greedy, "stream": True, "logit_bias": {"120": 100}}),
        "n 2": ("/v1/completions", {"prompt": "abc", "max_tokens": 4, "temperature": 0,
                                    "n": 2}),
        "n 3 chat": ("/v1/chat/completions", {"messages": CHAT, "max_tokens": 4,
                                              "temperature": 0, "n": 3, "seed": 5}),
        "n 2 streamed": ("/v1/completions", {"prompt": "abc", "max_tokens": 4,
                                             "temperature": 0, "n": 2, "stream": True,
                                             "stream_options": {"include_usage": True}}),
        "two prompts n 2": ("/v1/completions", {"prompt": ["abc", [104, 105]], "n": 2,
                                                "max_tokens": 3, "temperature": 0}),
        "best_of 3 n 2": ("/v1/completions", {"prompt": "ab", "max_tokens": 4,
                                              "temperature": 0, "n": 2, "best_of": 3,
                                              "logprobs": 1}),
        "echo": ("/v1/completions", {"prompt": "hello", "max_tokens": 2, "temperature": 0,
                                     "echo": True}),
        "echo logprobs": ("/v1/completions", {"prompt": "hello world", "max_tokens": 1,
                                              "temperature": 0, "echo": True,
                                              "logprobs": 2}),
        "echo logprobs two prompts": ("/v1/completions", {
            "prompt": ["hi there", "abc"], "max_tokens": 2, "temperature": 0,
            "echo": True, "logprobs": 1, "n": 2}),
        "tokenize prompt": ("/tokenize", {"prompt": "héllo"}),
        "tokenize messages": ("/tokenize", {"messages": CHAT}),
        "tokenize nothing": ("/tokenize", {}),
        "detokenize": ("/detokenize", {"tokens": [104, 195, 169, 108]}),
        "detokenize bad id": ("/detokenize", {"tokens": [104, 9999]}),
        "detokenize not ids": ("/detokenize", {"tokens": ["a"]}),
        "version": ("/version", None),
        "logprobs over the cap": ("/v1/completions", {"prompt": "a", "logprobs": 9}),
        "negative logprobs": ("/v1/completions", {"prompt": "a", "logprobs": -1}),
        "bias out of range": ("/v1/completions", {"prompt": "a",
                                                  "logit_bias": {"5": 101}}),
        "bias bad key": ("/v1/completions", {"prompt": "a", "logit_bias": {"x": 1}}),
        "bias not an object": ("/v1/completions", {"prompt": "a", "logit_bias": [1]}),
        "best_of streamed": ("/v1/completions", {"prompt": "a", "n": 2, "best_of": 3,
                                                 "stream": True}),
        "best_of below n": ("/v1/completions", {"prompt": "a", "n": 4, "best_of": 2}),
        "n over 16": ("/v1/completions", {"prompt": "a", "n": 17}),
        "echo logprobs streamed": ("/v1/completions", {"prompt": "a", "echo": True,
                                                       "logprobs": 1, "stream": True}),
        "suffix": ("/v1/completions", {"prompt": "a", "suffix": "b"}),
        # last: both prefix caches now hold the pages of the same prompts
        "ready": ("/ready", None),
        "health": ("/health", None),
    }
    return {k: ("GET" if v[1] is None else "POST", *v) for k, v in c.items()}


def _port_answers(base, cases):
    return {name: http(base, path, body) for name, (_m, path, body) in cases.items()}


def _jax_answers(jparams, cases):
    async def go():
        srv = JOpenAIServer(JEngine(JEngineConfig(**SMALL), params=jparams),
                            JByteTokenizer(), "debug-tiny")
        client = TestClient(TestServer(srv.make_app()))
        await client.start_server()
        out = {}
        try:
            for name, (method, path, body) in cases.items():
                r = await (client.get(path) if method == "GET"
                           else client.post(path, json=body))
                out[name] = (r.status, await r.read())
        finally:
            await client.close()
        return out
    return asyncio.run(go())


@pytest.fixture(scope="module")
def answers(params, port_base, cases):
    return _port_answers(port_base, cases), _jax_answers(params[0], cases)


def _frames(raw: bytes) -> list:
    lines = [ln[6:] for ln in raw.decode().splitlines() if ln.startswith("data: ")]
    assert lines[-1] == "[DONE]"
    return [json.loads(ln) for ln in lines[:-1]]


def _close(got, want, where=""):
    """Equal JSON, floats within TOL (None, strings, ints, keys exact)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (where, got, want)
        for k in want:
            _close(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, (int, float)), (where, got)
        np.testing.assert_allclose(got, want, err_msg=where, **TOL)
    else:
        assert got == want, (where, got, want)


def _by_choice(frames, chat):
    """Per choice index: the streamed text, the logprob entries in order
    and the finish reason; and the usage frame."""
    out: dict = {}
    usage = None
    for f in frames:
        if not f["choices"]:
            usage = f["usage"]
            continue
        ch = f["choices"][0]
        acc = out.setdefault(ch["index"], {"text": "", "lp": [], "finish": None})
        acc["text"] += (ch["delta"].get("content") or "") if chat else ch["text"]
        if ch.get("logprobs"):
            lp = ch["logprobs"]
            acc["lp"] += (lp["content"] if chat else
                          [list(e) for e in zip(lp["tokens"], lp["token_logprobs"],
                                                lp["top_logprobs"], lp["text_offset"])])
        if ch["finish_reason"]:
            acc["finish"] = ch["finish_reason"]
    return out, usage


CASE_NAMES = [
    "stop", "stop overlapping", "stop streamed", "stop with logprobs", "stop chat streamed",
    "logprobs 3", "logprobs 2", "logprobs 0", "logprobs streamed", "chat logprobs",
    "chat logprobs streamed", "logit_bias force", "logit_bias ban",
    "logit_bias chat streamed", "n 2", "n 3 chat", "n 2 streamed", "two prompts n 2",
    "echo", "echo logprobs", "echo logprobs two prompts", "tokenize prompt",
    "tokenize messages", "tokenize nothing", "detokenize", "detokenize bad id",
    "detokenize not ids", "version", "logprobs over the cap", "negative logprobs",
    "bias out of range", "bias bad key", "bias not an object", "best_of streamed",
    "best_of below n", "n over 16", "echo logprobs streamed", "suffix", "ready", "health"]


@pytest.mark.parametrize("name", CASE_NAMES)
def test_answers_equal_the_jax_server(answers, cases, name):
    got_status, got = answers[0][name]
    want_status, want = answers[1][name]
    assert got_status == want_status, (got, want)
    body = cases[name][2] or {}
    chat = cases[name][1] == "/v1/chat/completions"
    if want_status != 200:
        assert "message" in json.loads(got)["error"]
        return
    if body.get("stream"):
        gf, wf = _frames(got), _frames(want)
        # the chunk shapes: keys and object kind of every frame
        shape = {(f["object"], tuple(sorted(f)),
                  tuple(sorted(f["choices"][0])) if f["choices"] else ()) for f in wf}
        assert {(f["object"], tuple(sorted(f)),
                 tuple(sorted(f["choices"][0])) if f["choices"] else ()) for f in gf} \
            <= shape | {(wf[0]["object"], tuple(sorted(wf[0])), ("finish_reason", "index",
                                                                  "text"))}
        got_c, got_u = _by_choice(gf, chat)
        want_c, want_u = _by_choice(wf, chat)
        _close(got_c, want_c, name)
        if want_u is not None:
            # chip time is the ledger's measure of each side's own device
            _same_chip_phases(got_u.pop("chip_ms"), want_u.pop("chip_ms"))
        assert got_u == want_u
        if chat:
            assert all(f["choices"][0]["delta"] == {"role": "assistant"}
                       for f in gf[:len(want_c)])
        return
    if name == "health":
        assert got == want == b"OK"
        return
    g, w = json.loads(got), json.loads(want)
    if "choices" in w:
        for d in (g, w):
            d.pop("id"), d.pop("created")
        # chip time is the ledger's measure of each side's own device
        _same_chip_phases(g["usage"].pop("chip_ms"), w["usage"].pop("chip_ms"))
    _close(g, w, name)


def _same_chip_phases(got: dict, want: dict) -> None:
    """Both sides book the prefill (and the decode windows) of what they
    served, in the ledger's phases (the milliseconds are each device's own;
    a window wasted behind a stop string is booked "early_exit" where the
    timing left one in flight)."""
    phases = {"prefill", "decode", "spec_waste", "early_exit"}
    assert ("decode" in got) == ("decode" in want), (got, want)
    for chip in (got, want):
        assert {"prefill"} <= set(chip) <= phases, chip
        assert all(v >= 0 for v in chip.values()), chip


def test_the_stops_cut_the_text(answers, cases):
    for name in ("stop", "stop overlapping", "stop with logprobs"):
        ch = json.loads(answers[0][name][1])["choices"][0]
        stops = cases[name][2]["stop"]
        assert ch["finish_reason"] == "stop"
        assert not any(s in ch["text"] for s in stops)
    lp = json.loads(answers[0]["stop with logprobs"][1])["choices"][0]["logprobs"]
    assert all(off <= len(json.loads(answers[0]["stop with logprobs"][1])["choices"][0]
                          ["text"]) for off in lp["text_offset"])


def test_the_responses_have_the_documented_shapes(answers):
    """The positive counterparts of test_bad_requests_get_400's old cases
    (logprobs 2, a stop string, n 2), with the OpenAI shapes."""
    port = {k: (s, json.loads(b)) for k, (s, b) in answers[0].items()
            if s == 200 and b[:1] == b"{"}
    lp = port["logprobs 2"][1]["choices"][0]["logprobs"]
    assert set(lp) == {"tokens", "token_logprobs", "top_logprobs", "text_offset"}
    assert len(lp["tokens"]) == 4 and all(v <= 1e-6 for v in lp["token_logprobs"])
    assert all(1 <= len(t) <= 2 for t in lp["top_logprobs"])
    content = port["chat logprobs"][1]["choices"][0]["logprobs"]["content"]
    assert len(content) == 5
    for e in content:
        assert set(e) == {"token", "logprob", "bytes", "top_logprobs"}
        tops = [t["logprob"] for t in e["top_logprobs"]]
        assert len(tops) == 5 and tops == sorted(tops, reverse=True)
        assert e["logprob"] <= 1e-6 and tops[0] == e["logprob"]      # greedy
    assert port["stop"][1]["choices"][0]["finish_reason"] == "stop"
    n2 = port["n 2"][1]
    assert [c["index"] for c in n2["choices"]] == [0, 1]
    assert n2["choices"][0]["text"] == n2["choices"][1]["text"]          # greedy
    assert n2["usage"]["completion_tokens"] == 8 and n2["usage"]["prompt_tokens"] == 3
    two = port["two prompts n 2"][1]
    assert len(two["choices"]) == 4 and two["usage"]["prompt_tokens"] == 5
    assert port["logit_bias force"][1]["choices"][0]["text"] == "A" * 12
    echo = port["echo logprobs"][1]["choices"][0]
    assert echo["text"].startswith("hello world")
    assert echo["logprobs"]["token_logprobs"][0] is None
    assert len(echo["logprobs"]["tokens"]) == len("hello world") + 1
    for i, t in enumerate(echo["logprobs"]["tokens"]):
        assert echo["text"][echo["logprobs"]["text_offset"][i]:][:len(t)] == t
    assert len(port["best_of 3 n 2"][1]["choices"]) == 2


def test_seeded_n_choices_repeat_and_differ(port_base):
    """n 4 with a seed at temperature 1: the same four choices again on a
    repeat; choice j > 0 samples with seed + j, so they are not all one."""
    body = {"prompt": "abc", "max_tokens": 8, "temperature": 1.0, "seed": 11, "n": 4}
    a = json.loads(http(port_base, "/v1/completions", body)[1])
    b = json.loads(http(port_base, "/v1/completions", body)[1])
    texts = [c["text"] for c in a["choices"]]
    assert texts == [c["text"] for c in b["choices"]] and len(set(texts)) > 1
    one = json.loads(http(port_base, "/v1/completions", {**body, "n": 1})[1])
    assert one["choices"][0]["text"] == texts[0]
    shifted = json.loads(http(port_base, "/v1/completions",
                              {**body, "n": 1, "seed": 12})[1])
    assert shifted["choices"][0]["text"] == texts[1]


# ---------------------------------------------------------------------------
# StopChecker against the JAX StopChecker
# ---------------------------------------------------------------------------

@settings(max_examples=300, deadline=None)
@given(stops=st.lists(st.text(alphabet="abc", min_size=0, max_size=4), max_size=4),
       deltas=st.lists(st.text(alphabet="abcd", max_size=5), max_size=10))
def test_stop_checker_equals_jax(stops, deltas):
    got, want = StopChecker(stops), JStopChecker(stops)
    for i, d in enumerate(deltas):
        final = i == len(deltas) - 1
        out = got.push(d, final=final)
        assert out == want.push(d, final=final)
        if out[1]:
            break


def test_stop_checker_earliest_match_wins():
    s = StopChecker(["b", "a"])
    assert s.push("xxaxxb", final=True) == ("xx", True)
    s = StopChecker(["abcd", "c"])       # a longer stop may still complete: wait
    assert s.push("zabc") == ("z", False)
    assert s.push("d") == ("", True)


# ---------------------------------------------------------------------------
# drain
# ---------------------------------------------------------------------------

def _stream_lines(base, body):
    req = urllib.request.Request(base + "/v1/completions", data=json.dumps(body).encode(),
                                 method="POST", headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=120)


def test_drain_keeps_an_in_flight_stream_whole(params):
    body = {"prompt": "drain me", "max_tokens": 300, "temperature": 0, "stream": True,
            "stream_options": {"include_usage": True}}
    cfg = {**SMALL, "page_size": 16}
    ref_srv = OpenAIServer(Engine(EngineConfig(**cfg, device="cpu"), params=params[1]),
                           ByteTokenizer(), "debug-tiny")
    ref_base = f"http://127.0.0.1:{ref_srv.start()}"
    try:
        ref, _ = _by_choice(_frames(_stream_lines(ref_base, body).read()), False)
    finally:
        ref_srv.close()
    srv = OpenAIServer(Engine(EngineConfig(**cfg, device="cpu"), params=params[1]),
                       ByteTokenizer(), "debug-tiny")
    base = f"http://127.0.0.1:{srv.start()}"
    try:
        resp = _stream_lines(base, body)
        first = resp.readline()
        assert first.startswith(b"data: ")
        assert srv.begin_drain() and not srv.begin_drain()
        srv.shutdown_when_drained()
        assert http(base, "/ready")[0] == 503
        status, raw = http(base, "/v1/completions", {"prompt": "new", "max_tokens": 2})
        assert status == 503 and json.loads(raw)["error"]["code"] == "shutting_down"
        got, usage = _by_choice(_frames(first + resp.read()), False)
        assert got == ref and got[0]["finish"] == "length"
        assert usage["completion_tokens"] == 300
        srv.loop.join(timeout=30)
        srv._thread.join(timeout=30)
        assert not srv.loop.is_alive() and not srv._thread.is_alive()
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# behind llkt-router
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def router_binary(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build native/router")
    out = tmp_path_factory.mktemp("router") / "llkt-router"
    subprocess.run(["g++", "-O2", "-std=c++17", "-pthread", "-o", str(out),
                    str(REPO / "native" / "router" / "router.cpp")], check=True,
                   capture_output=True, timeout=600)
    return out


def _wait_http(url, deadline_s=120):
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        try:
            with urllib.request.urlopen(url, timeout=2) as r:
                if r.status == 200:
                    return
        except OSError:
            pass
        time.sleep(0.1)
    raise AssertionError(f"{url} did not answer")


def _healthy(router_base, replica):
    text = http(router_base, "/metrics")[1].decode()
    for line in text.splitlines():
        if line.startswith("llm_replica_healthy{") and f'replica="{replica}"' in line:
            return float(line.rsplit(" ", 1)[1])
    return None


def test_the_cli_server_behind_llkt_router_drains_on_sigterm(router_binary, tmp_path):
    sport, rport = _free_port(), _free_port()
    replica = f"http://127.0.0.1:{sport}"
    # one CPU thread and a pool sized for the CPU: at serve's defaults (2,048
    # pages of 64, 64 a slot, every core) the 300-token stream below takes
    # ~31 s alone and ~46 s beside six busy processes, near the drain's fixed
    # 55 s bound, which then cuts it; so sized, ~5 s either way
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    server = subprocess.Popen(
        [sys.executable, "-m", "llms_on_kubernetes_tpu_torch", "serve", "--model",
         "debug-tiny", "--random-weights", "--device", "cpu", "--host", "127.0.0.1",
         "--port", str(sport), "--num-pages", "256", "--page-size", "16",
         "--pages-per-slot", "32", "--prefill-buckets", "64,256"], cwd=tmp_path, env=env,
        stdout=subprocess.DEVNULL, stderr=open(tmp_path / "server.log", "w"))
    router = subprocess.Popen(
        [str(router_binary), "--models", f"debug-tiny={replica}", "--port", str(rport),
         "--probe-interval", "0.2", "--quiet"], stderr=subprocess.DEVNULL)
    rbase = f"http://127.0.0.1:{rport}"
    try:
        _wait_http(replica + "/health")
        _wait_http(rbase + "/health")
        # admission is waited for as _wait_http waits (its pace is the
        # machine's load); the replica's turn to draining is bounded from the
        # signal, the router's ejection from the replica's 503
        t0 = time.monotonic()
        while _healthy(rbase, replica) != 1.0:
            assert time.monotonic() - t0 < 120, "the router never admitted the replica"
            time.sleep(0.1)
        status, raw = http(rbase, "/v1/completions", {
            "model": "debug-tiny", "prompt": "abc", "max_tokens": 6, "temperature": 0,
            "logprobs": 2, "stop": ["ÿÿ"], "n": 2})
        data = json.loads(raw)
        assert status == 200 and len(data["choices"]) == 2
        assert len(data["choices"][0]["logprobs"]["token_logprobs"]) >= 1
        resp = urllib.request.urlopen(urllib.request.Request(
            rbase + "/v1/completions", method="POST",
            headers={"Content-Type": "application/json"},
            data=json.dumps({"model": "debug-tiny", "prompt": "stream through", "stream": True,
                             "max_tokens": 300, "temperature": 0}).encode()), timeout=120)
        first = resp.readline()
        assert first.startswith(b"data: ")
        server.send_signal(signal.SIGTERM)
        t_term = time.monotonic()
        while True:
            status, raw = http(replica, "/ready")
            if status == 503:
                assert json.loads(raw)["state"] == "draining"
                break
            assert time.monotonic() - t_term < 10, "the replica did not begin its drain"
            time.sleep(0.05)
        t_drain = time.monotonic()
        while _healthy(rbase, replica) != 0.0:
            assert time.monotonic() - t_drain < 5, "the router did not eject the replica"
            time.sleep(0.05)
        ejected_s = time.monotonic() - t_drain
        frames = _frames(first + resp.read())
        got, _ = _by_choice(frames, False)
        assert got[0]["finish"] == "length"
        assert server.wait(timeout=60) == 0
        assert ejected_s < 5
    finally:
        for p in (server, router):
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)


# ---------------------------------------------------------------------------
# the queue-full 429's Retry-After, the body cap and the SSE keepalive,
# against the JAX server (admission held by LLMK_FAULT=queue_stall)
# ---------------------------------------------------------------------------

def _port_server(params, **kw):
    srv = OpenAIServer(Engine(EngineConfig(**{**SMALL, **kw}, device="cpu"), params=params[1]),
                       ByteTokenizer(), "debug-tiny")
    return srv, f"http://127.0.0.1:{srv.start()}"


def _jax_run(params, fn, **kw):
    """``fn(client)`` against a JAX server over the same weights."""
    async def go():
        srv = JOpenAIServer(JEngine(JEngineConfig(**{**SMALL, **kw}), params=params[0]),
                            JByteTokenizer(), "debug-tiny")
        client = TestClient(TestServer(srv.make_app()))
        await client.start_server()
        try:
            return await fn(client)
        finally:
            await client.close()
    return asyncio.run(go())


def test_queue_full_429_carries_retry_after_as_jax(params, monkeypatch):
    """max_waiting 1, admission held: the first request waits, the second
    gets 429 "overloaded" with Retry-After in [1, 60] s from both servers."""
    monkeypatch.setenv("LLMK_FAULT", "queue_stall")
    body = {"prompt": "abc", "max_tokens": 2, "temperature": 0}
    srv, base = _port_server(params, max_waiting=1)
    try:
        first = threading.Thread(target=http, args=(base, "/v1/completions", body))
        first.start()
        t0 = time.monotonic()
        while not srv.engine.waiting:
            assert time.monotonic() - t0 < 30
            time.sleep(0.01)
        req = urllib.request.Request(base + "/v1/completions", data=json.dumps(body).encode(),
                                     method="POST", headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=60)
        port = (exc.value.code, exc.value.headers.get("Retry-After"),
                json.loads(exc.value.read())["error"]["code"])
        monkeypatch.delenv("LLMK_FAULT")
        first.join(timeout=60)
    finally:
        srv.close()

    async def two(client):
        task = asyncio.ensure_future(client.post("/v1/completions", json=body))
        for _ in range(300):
            await asyncio.sleep(0.01)
            if task.done():
                break
        r = await client.post("/v1/completions", json=body)
        out = (r.status, r.headers.get("Retry-After"), (await r.json())["error"]["code"])
        task.cancel()
        return out

    monkeypatch.setenv("LLMK_FAULT", "queue_stall")
    want = _jax_run(params, two, max_waiting=1)
    assert port[0] == want[0] == 429 and port[2] == want[2] == "overloaded"
    assert 1 <= int(port[1]) <= 60 and 1 <= int(want[1]) <= 60


def test_a_body_over_the_cap_gets_413_as_jax(params):
    """A POST declaring 64 MiB is refused with 413 before the port reads a
    byte of its body; the JAX server (aiohttp's client_max_size) answers a
    body over 32 MiB with 413 too."""
    from llms_on_kubernetes_tpu_torch.server.openai_api import MAX_BODY_BYTES

    srv, base = _port_server(params)
    body_reads: list = []
    handler = srv.httpd.RequestHandlerClass

    class Counting(handler):
        def setup(self):
            super().setup()
            raw = self.rfile

            class Reader:
                def read(self, n=-1):
                    data = raw.read(n)
                    body_reads.append(len(data))
                    return data

                def __getattr__(self, name):
                    return getattr(raw, name)

            self.rfile = Reader()

    srv.httpd.RequestHandlerClass = Counting
    try:
        with socket.create_connection(("127.0.0.1", srv.httpd.server_address[1]),
                                      timeout=30) as s:
            s.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: test\r\n"
                      b"Content-Type: application/json\r\n"
                      b"Content-Length: %d\r\n\r\n" % (64 << 20))
            head = s.recv(4096).decode()
        assert head.startswith("HTTP/1.0 413") or head.startswith("HTTP/1.1 413"), head
        assert sum(body_reads) <= MAX_BODY_BYTES and sum(body_reads) == 0
        # the server goes on serving
        assert http(base, "/v1/completions", {"prompt": "a", "max_tokens": 1})[0] == 200
    finally:
        srv.close()

    async def big(client):
        r = await client.post("/v1/completions", data=b" " * (MAX_BODY_BYTES + 1024),
                              headers={"Content-Type": "application/json"})
        return r.status

    assert _jax_run(params, big) == 413


def _first_lines(lines, n=1):
    """The first ``n`` non-blank lines of an SSE byte-line iterator."""
    out = []
    for raw in lines:
        line = raw.decode().strip()
        if line:
            out.append(line)
            if len(out) == n:
                return out
    return out


def test_sse_keepalive_pings_before_the_first_data_as_jax(params, monkeypatch):
    """LLMK_SSE_KEEPALIVE_S=0.2 with admission held: both servers send a
    ``: ping`` comment before any ``data:`` line, and the stream ends whole
    once admission resumes."""
    monkeypatch.setenv("LLMK_FAULT", "queue_stall")
    monkeypatch.setenv("LLMK_SSE_KEEPALIVE_S", "0.2")
    body = {"prompt": "abc", "max_tokens": 3, "temperature": 0, "stream": True}
    srv, base = _port_server(params)
    try:
        resp = _stream_lines(base, body)
        first = _first_lines(resp)
        monkeypatch.delenv("LLMK_FAULT")
        rest = resp.read().decode()
        assert first == [": ping"] and rest.rstrip().endswith("data: [DONE]")
    finally:
        srv.close()
    monkeypatch.setenv("LLMK_FAULT", "queue_stall")

    async def ping(client):
        r = await client.post("/v1/completions", json=body)
        lines = []
        while not lines:
            line = (await r.content.readline()).decode().strip()
            if line:
                lines.append(line)
        r.close()
        return lines

    assert _jax_run(params, ping) == [": ping"]
