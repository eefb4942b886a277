"""Request ids and tracing in the port against the JAX package, on the CPU.

- The port's ``server/tracing.py`` (a copy) answers tests/data/
  trace_vectors.json (parse, format, reconcile, the tail sampler) and equals
  the JAX module on random correlation headers (hypothesis); a formatted
  ``traceparent`` parses back.
- The port server and the JAX server (debug-tiny, float32, the same
  weights) echo ``X-LLMK-Request-Id`` by the same rules on every response,
  errors and streams included: a safe id verbatim, an unsafe one replaced
  by the adopted trace id or a fresh one.
- ``GET /debug/traces`` holds the request under its id with the JAX
  server's keys, the W3C ids from the inbound ``traceparent``, its
  admission, queue, prefill and decode spans parented under the fragment
  and the engine's finish event; ``?limit`` and a miss answer as JAX's.
- The flight recorder (``GET /debug/engine``) has a frame per engine step.
"""

import asyncio
import json
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
from llms_on_kubernetes_tpu.server import tracing as jtracing
from llms_on_kubernetes_tpu.server.openai_api import OpenAIServer as JOpenAIServer
from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig
from llms_on_kubernetes_tpu_torch.engine.tokenizer import ByteTokenizer
from llms_on_kubernetes_tpu_torch.engine.weights import params_from_numpy
from llms_on_kubernetes_tpu_torch.server import tracing
from llms_on_kubernetes_tpu_torch.server.openai_api import OpenAIServer

VECTORS = json.loads((Path(__file__).resolve().parent / "data"
                      / "trace_vectors.json").read_text())
SMALL = dict(model="debug-tiny", dtype="float32", max_decode_slots=4, page_size=4,
             num_pages=256, pages_per_slot=32, prefill_buckets=(32, 64))
RID = "X-LLMK-Request-Id"
TP = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"
TRACE_ID, PARENT = "4bf92f3577b34da6a3ce929d0e0e4736", "00f067aa0ba902b7"


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("v", VECTORS["parse"], ids=lambda v: v.get("_comment", "")[:40])
def test_parse_vectors(v):
    got = tracing.parse_traceparent(v["traceparent"])
    want = v["expect"]
    assert got == (None if want is None else (want["trace_id"], want["span_id"],
                                              want["flags"]))


def test_format_vectors_round_trip():
    for v in VECTORS["format"]:
        tp = tracing.format_traceparent(v["trace_id"], v["span_id"], v["sampled"])
        assert tp == v["expect"]
        assert tracing.parse_traceparent(tp) == (v["trace_id"], v["span_id"],
                                                 1 if v["sampled"] else 0)


@pytest.mark.parametrize("v", VECTORS["reconcile"], ids=lambda v: v.get("_comment", "")[:40])
def test_reconcile_vectors(v):
    assert tracing.reconcile(v["traceparent"], v["tracestate"], v["request_id"]) == v["expect"]


def test_sampler_vectors():
    for v in VECTORS["sampler"]:
        keep, reason = tracing.tail_decision(v["error"], v["e2e_ms"], v["slow_ms"],
                                             v["multi_hop"], v["sample"], v["rand01"])
        assert {"export": keep, "reason": reason} == v["expect"]


HEX = st.text(alphabet="0123456789abcdefABCDEF", min_size=0, max_size=34)
HEADER = st.one_of(
    st.none(), st.text(max_size=60),
    st.builds(lambda a, b, c, d: f"{a}-{b}-{c}-{d}", st.sampled_from(["00", "01", "ff", "0"]),
              HEX, HEX, st.sampled_from(["01", "00", "1", "zz"])))


@settings(max_examples=500, deadline=None)
@given(tp=HEADER, ts=st.one_of(st.none(), st.text(max_size=40)),
       rid=st.one_of(st.none(), st.text(max_size=70),
                     st.text(alphabet="abcXYZ019_-", min_size=1, max_size=70)))
def test_reconcile_equals_jax(tp, ts, rid):
    assert tracing.reconcile(tp, ts, rid) == jtracing.reconcile(tp, ts, rid)
    assert tracing.safe_request_id(rid) == jtracing.safe_request_id(rid)


# ---------------------------------------------------------------------------
# the servers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    jp = j_init_params(jget_config("debug-tiny"), jax.random.key(0), dtype="float32")
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


# name -> (method, path, body, headers)
CALLS = {
    "safe id, completion": ("POST", "/v1/completions",
                            {"prompt": "abc", "max_tokens": 3, "temperature": 0},
                            {RID: "client-id_1"}),
    "unsafe id, no traceparent": ("POST", "/v1/completions",
                                  {"prompt": "abc", "max_tokens": 2, "temperature": 0},
                                  {RID: "bad id!"}),
    "unsafe id, traceparent": ("POST", "/v1/completions",
                               {"prompt": "abd", "max_tokens": 2, "temperature": 0},
                               {RID: "bad id!", "traceparent": TP}),
    "traced, streamed": ("POST", "/v1/chat/completions",
                         {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4,
                          "temperature": 0, "stream": True},
                         {RID: "traced-1", "traceparent": TP, "tracestate": "k=v"}),
    "error 400": ("POST", "/v1/completions", {"prompt": "a", "n": 99}, {RID: "bad-request-1"}),
    "error 404": ("GET", "/no/such/route", None, {RID: "missing-1"}),
    "health": ("GET", "/health", None, {RID: "probe-1"}),
    "embeddings": ("POST", "/v1/embeddings", {"input": "x"}, {RID: "embed-1"}),
}


def _port_answers(tparams) -> dict:
    srv = OpenAIServer(Engine(EngineConfig(**SMALL, device="cpu"), params=tparams),
                       ByteTokenizer(), "debug-tiny")
    base = f"http://127.0.0.1:{srv.start()}"

    def call(method, path, body, headers):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(base + path, data=data, method=method,
                                     headers={"Content-Type": "application/json", **headers})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, r.headers.get(RID), r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.headers.get(RID), e.read()

    try:
        out = {name: call(*c) for name, c in CALLS.items()}
        out["traces"] = call("GET", "/debug/traces?id=traced-1", None, {})
        out["traces limit"] = call("GET", "/debug/traces?limit=2", None, {})
        out["traces miss"] = call("GET", "/debug/traces?id=nobody", None, {})
        out["engine"] = call("GET", "/debug/engine?limit=3", None, {})
    finally:
        srv.close()
    return out


def _jax_answers(jparams) -> dict:
    async def go():
        srv = JOpenAIServer(JEngine(JEngineConfig(**SMALL), params=jparams), JByteTokenizer(),
                            "debug-tiny")
        client = TestClient(TestServer(srv.make_app()))
        await client.start_server()

        async def call(method, path, body, headers):
            r = await (client.get(path, headers=headers) if method == "GET"
                       else client.post(path, json=body, headers=headers))
            return r.status, r.headers.get(RID), await r.read()

        out = {}
        try:
            for name, c in CALLS.items():
                out[name] = await call(*c)
            out["traces"] = await call("GET", "/debug/traces?id=traced-1", None, {})
            out["traces limit"] = await call("GET", "/debug/traces?limit=2", None, {})
            out["traces miss"] = await call("GET", "/debug/traces?id=nobody", None, {})
        finally:
            await client.close()
        return out
    return asyncio.run(go())


@pytest.fixture(scope="module")
def answers(params):
    return _port_answers(params[1]), _jax_answers(params[0])


@pytest.mark.parametrize("name", list(CALLS))
def test_the_request_id_is_echoed_as_jax(answers, name):
    (gs, grid, _), (ws, wrid, _) = answers[0][name], answers[1][name]
    assert gs == ws
    assert grid and wrid
    sent = CALLS[name][3].get(RID)
    if tracing.safe_request_id(sent):
        assert grid == wrid == sent
    elif "traceparent" in CALLS[name][3]:
        assert grid == wrid == TRACE_ID
    else:       # re-minted on each side: 32 hex characters, not the unsafe id
        assert grid != sent and wrid != sent and len(grid) == len(wrid) == 32


def test_debug_traces_hold_the_request_as_jax(answers):
    (gs, _, graw), (ws, _, wraw) = answers[0]["traces"], answers[1]["traces"]
    assert gs == ws == 200
    (got,), (want,) = json.loads(graw)["traces"], json.loads(wraw)["traces"]
    assert set(got) == set(want)
    for t in (got, want):
        assert (t["id"], t["trace_id"], t["parent_span_id"], t["component"], t["status"]) == \
            ("traced-1", TRACE_ID, PARENT, "api", "ok")
    names = [s["name"] for s in got["spans"]]
    assert [s["name"] for s in want["spans"] if s["name"] in names] == names
    assert {"admission", "queue", "prefill", "decode"} <= set(names)
    assert all(s["parent_span_id"] == got["span_id"] and len(s["span_id"]) == 16
               for s in got["spans"])
    decode = next(s for s in got["spans"] if s["name"] == "decode")
    assert decode["tokens"] == 4 and decode["duration_ms"] >= 0
    finish = [e for e in got["events"] if e["name"] == "finish"]
    assert len(finish) == 1 and finish[0]["reason"] == "length" and finish[0]["tokens"] == 4
    assert [e["name"] for e in want["events"]] == [e["name"] for e in got["events"]]


def test_debug_traces_limit_and_miss_as_jax(answers):
    for key in ("traces limit", "traces miss"):
        (gs, _, graw), (ws, _, wraw) = answers[0][key], answers[1][key]
        assert gs == ws == 200
        assert len(json.loads(graw)["traces"]) == len(json.loads(wraw)["traces"])


def test_errors_leave_traces_with_their_status(answers):
    """Newest first: the 400 left a trace with its status, after the
    streamed request's."""
    for side in answers:
        latest = json.loads(side["traces limit"][2])["traces"]
        assert [(t["id"], t["status"]) for t in latest] == [("bad-request-1", "http_400"),
                                                            ("traced-1", "ok")]


def test_embeddings_answer_501_as_jax(answers):
    (gs, _, graw), (ws, _, wraw) = answers[0]["embeddings"], answers[1]["embeddings"]
    assert gs == ws == 501
    assert json.loads(graw) == json.loads(wraw)


def test_the_flight_recorder_has_a_frame_per_step(answers):
    status, _, raw = answers[0]["engine"]
    doc = json.loads(raw)
    assert status == 200 and doc["state"] == "serving" and doc["model"] == "debug-tiny"
    assert doc["steps_recorded"] >= 3 and len(doc["steps"]) == 3
    assert {"step", "ts", "step_ms", "occupancy", "kv_pages_used", "waiting", "tokens",
            "preemptions", "wedged"} <= set(doc["steps"][-1])
