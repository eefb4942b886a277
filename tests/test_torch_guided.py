"""Guided decoding over HTTP in the port against the JAX server, on the CPU:
``response_format`` (``json_object``, ``json_schema``, ``text``) and
grammar-forced ``tool_choice`` (the JAX tests/test_guided.py cases).

The port server and the JAX server run a debug-tiny sized model over the
byte vocabulary (so EOS can be sampled) in float32 with the same weights.
Greedy requests steered to finish with ``logit_bias`` (the bias ranks
only the tokens the grammar allows) answer the same status, content,
``tool_calls`` (ids aside), finish_reason and usage (chip time aside),
streamed and not, on chat and completions; every constrained answer
parses and validates. The 400s (an unsupported schema construct, an
unknown or malformed ``response_format``, a JSON format with a forced
tool choice, a ``json_schema`` without a schema) answer with the JAX
server's messages. Sampled requests (temperature 1) stay valid on the
port: valid output is a property of the mask, not of the model.
"""

import asyncio
import json
import urllib.error
import urllib.request

import jax
import jsonschema
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from llms_on_kubernetes_tpu.configs import ModelConfig as JModelConfig
from llms_on_kubernetes_tpu.engine.engine import Engine as JEngine
from llms_on_kubernetes_tpu.engine.engine import EngineConfig as JEngineConfig
from llms_on_kubernetes_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from llms_on_kubernetes_tpu.models.decoder import init_params as j_init_params
from llms_on_kubernetes_tpu.server.openai_api import OpenAIServer as JOpenAIServer
from llms_on_kubernetes_tpu_torch.configs import ModelConfig
from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig
from llms_on_kubernetes_tpu_torch.engine.tokenizer import ByteTokenizer
from llms_on_kubernetes_tpu_torch.engine.weights import params_from_numpy
from llms_on_kubernetes_tpu_torch.server.openai_api import OpenAIServer

MODEL = dict(vocab_size=258, hidden_size=64, intermediate_size=128, num_layers=2,
             num_heads=4, num_kv_heads=2, head_dim=16, max_position_embeddings=1024)
ENGINE = dict(model="debug-tiny", dtype="float32", max_decode_slots=4, page_size=8,
              num_pages=256, pages_per_slot=64, prefill_buckets=(64, 128, 512))
EOS = 257
# greedy answers steered to finish: EOS, then the closing and separating
# characters, outrank whatever else the grammar allows
STEER = {str(EOS): 100, str(ord("}")): 60, str(ord(",")): 40, str(ord('"')): 30,
         str(ord(":")): 28, str(ord("{")): 25, str(ord("<")): 22, str(ord("1")): 20}
BASE = {"model": "debug-guided", "messages": [{"role": "user", "content": "emit json"}],
        "max_tokens": 96, "temperature": 0, "logit_bias": STEER}
SCHEMA = {"type": "object",
          "properties": {"name": {"type": "string", "maxLength": 6},
                         "color": {"enum": ["red", "green"]}, "n": {"type": "integer"}},
          "required": ["name", "color", "n"]}
TOOLS = [{"type": "function", "function": {
    "name": "set_value", "parameters": {"type": "object",
                                        "properties": {"v": {"type": "integer"}},
                                        "required": ["v"]}}},
    {"type": "function", "function": {"name": "other"}}]
NAMED_REQUIRED = [{"type": "function", "function": {
    "name": "required", "parameters": {"type": "object",
                                       "properties": {"v": {"type": "integer"}},
                                       "required": ["v"]}}},
    {"type": "function", "function": {"name": "other"}}]
JSON_OBJECT = {"type": "json_object"}
JSON_SCHEMA = {"type": "json_schema", "json_schema": {"name": "thing", "schema": SCHEMA}}
FORCED = {"type": "function", "function": {"name": "set_value"}}

CASES = {
    "json_object": ("chat", {**BASE, "response_format": JSON_OBJECT}),
    "json_object streamed": ("chat", {**BASE, "response_format": JSON_OBJECT, "stream": True}),
    "json_schema": ("chat", {**BASE, "response_format": JSON_SCHEMA}),
    "json_schema streamed": ("chat", {**BASE, "response_format": JSON_SCHEMA, "stream": True,
                                      "stream_options": {"include_usage": True}}),
    "json_object completions": ("completions", {
        "prompt": "emit json", "max_tokens": 96, "temperature": 0, "logit_bias": STEER,
        "response_format": JSON_OBJECT}),
    "json_schema completions n 2": ("completions", {
        "prompt": ["emit", "json"], "max_tokens": 96, "temperature": 0, "logit_bias": STEER,
        "response_format": JSON_SCHEMA}),
    "forced tool": ("chat", {**BASE, "tools": TOOLS, "tool_choice": FORCED}),
    "forced tool streamed": ("chat", {**BASE, "tools": TOOLS, "tool_choice": FORCED,
                                      "stream": True}),
    "required tool": ("chat", {**BASE, "tools": TOOLS, "tool_choice": "required"}),
    "tool named required": ("chat", {**BASE, "tools": NAMED_REQUIRED, "tool_choice": {
        "type": "function", "function": {"name": "required"}}}),
    "text is a no-op": ("chat", {**BASE, "response_format": {"type": "text"},
                                 "max_tokens": 8}),
    "$ref": ("chat", {**BASE, "response_format": {
        "type": "json_schema", "json_schema": {"schema": {"$ref": "#/x"}}}}),
    "unknown type": ("chat", {**BASE, "response_format": {"type": "grammar"}}),
    "malformed": ("chat", {**BASE, "response_format": "json"}),
    "format with a forced tool": ("chat", {**BASE, "tools": TOOLS, "tool_choice": "required",
                                           "response_format": JSON_OBJECT}),
    "json_schema without a schema": ("chat", {**BASE, "response_format": {
        "type": "json_schema"}}),
}
PATHS = {"chat": "/v1/chat/completions", "completions": "/v1/completions"}


@pytest.fixture(scope="module")
def weights():
    jcfg = JModelConfig("debug-guided", **MODEL)
    jp = j_init_params(jcfg, jax.random.key(5), dtype="float32")
    return jcfg, jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _port_server(weights):
    eng = Engine(EngineConfig(**ENGINE, device="cpu"),
                 model_config=ModelConfig("debug-guided", **MODEL), params=weights[2])
    srv = OpenAIServer(eng, ByteTokenizer(), "debug-guided")
    return srv, f"http://127.0.0.1:{srv.start()}"


def _post(base, path, body):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture(scope="module")
def answers(weights):
    srv, base = _port_server(weights)
    try:
        port = {name: _post(base, PATHS[kind], body) for name, (kind, body) in CASES.items()}
    finally:
        srv.close()

    async def go():
        jsrv = JOpenAIServer(JEngine(JEngineConfig(**ENGINE), model_config=weights[0],
                                     params=weights[1]), JByteTokenizer(), "debug-guided")
        client = TestClient(TestServer(jsrv.make_app()))
        await client.start_server()
        out = {}
        try:
            for name, (kind, body) in CASES.items():
                r = await client.post(PATHS[kind], json=body)
                out[name] = (r.status, await r.read())
        finally:
            await client.close()
        return out
    return port, asyncio.run(go())


def _no_ids(calls):
    return [{k: v for k, v in c.items() if k != "id"} for c in calls]


def _view(raw: bytes, stream: bool, chat: bool):
    """Per choice (content or text, tool calls without ids, finish), and
    the usage without chip time."""
    if not stream:
        d = json.loads(raw)
        usage = dict(d["usage"])
        usage.pop("chip_ms", None)
        out = []
        for ch in d["choices"]:
            if chat:
                m = ch["message"]
                out.append((m.get("content"), _no_ids(m.get("tool_calls", [])),
                            ch["finish_reason"]))
            else:
                out.append((ch["text"], [], ch["finish_reason"]))
        return out, usage
    acc: dict = {}
    usage = None
    for line in raw.decode().splitlines():
        if not line.startswith("data: {"):
            continue
        frame = json.loads(line[6:])
        if not frame["choices"]:
            usage = dict(frame["usage"])
            usage.pop("chip_ms", None)
        for ch in frame["choices"]:
            a = acc.setdefault(ch["index"], ["", [], None])
            a[0] += (ch["delta"].get("content") or "") if chat else ch["text"]
            a[1] += _no_ids(ch["delta"].get("tool_calls", [])) if chat else []
            a[2] = ch["finish_reason"] or a[2]
    return [tuple(acc[i]) for i in sorted(acc)], usage


@pytest.mark.parametrize("name", list(CASES))
def test_guided_answers_equal_the_jax_server(answers, name):
    (gs, got), (ws, want) = answers[0][name], answers[1][name]
    assert gs == ws, (name, got, want)
    if gs != 200:
        assert json.loads(got)["error"]["message"] == json.loads(want)["error"]["message"]
        return
    kind, body = CASES[name]
    assert _view(got, bool(body.get("stream")), kind == "chat") == \
        _view(want, bool(body.get("stream")), kind == "chat")


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n][1].get("response_format")
                                  in (JSON_OBJECT, JSON_SCHEMA)
                                  and "tools" not in CASES[n][1]])
def test_every_json_answer_parses_and_validates(answers, name):
    kind, body = CASES[name]
    status, raw = answers[0][name]
    assert status == 200
    choices, _usage = _view(raw, bool(body.get("stream")), kind == "chat")
    for content, _calls, finish in choices:
        assert finish == "stop", (content, finish)
        obj = json.loads(content)
        assert isinstance(obj, dict)
        if body["response_format"] is JSON_SCHEMA:
            jsonschema.validate(obj, SCHEMA)


@pytest.mark.parametrize("name", ["forced tool", "forced tool streamed", "required tool",
                                  "tool named required"])
def test_every_forced_tool_answer_is_a_call(answers, name):
    _kind, body = CASES[name]
    status, raw = answers[0][name]
    assert status == 200
    ((content, calls, finish),), _ = _view(raw, bool(body.get("stream")), True)
    assert finish == "tool_calls", (content, calls)
    assert (content or "").strip() == ""        # no plain-text answer beside whitespace
    assert len(calls) >= 1
    want = "required" if name == "tool named required" else "set_value"
    if name != "required tool":
        assert [c["function"]["name"] for c in calls] == [want]
    for c in calls:
        args = json.loads(c["function"]["arguments"])
        if c["function"]["name"] in ("set_value", "required"):
            assert isinstance(args["v"], int)


def test_guided_400s_name_the_cause(answers):
    assert "$ref" in json.loads(answers[0]["$ref"][1])["error"]["message"]
    assert "cannot be combined" in json.loads(
        answers[0]["format with a forced tool"][1])["error"]["message"]


@pytest.mark.parametrize("fmt", ["json_object", "json_schema"])
def test_sampled_answers_stay_valid(weights, fmt):
    """Temperature 1 with no steering: every answer is a path of its
    grammar; those that end on EOS parse and validate."""
    srv, base = _port_server(weights)
    try:
        rf = JSON_OBJECT if fmt == "json_object" else JSON_SCHEMA
        for seed in range(4):
            status, raw = _post(base, "/v1/chat/completions", {
                "messages": [{"role": "user", "content": "emit json"}], "max_tokens": 96,
                "temperature": 1.0, "seed": seed, "response_format": rf})
            assert status == 200
            ch = json.loads(raw)["choices"][0]
            if ch["finish_reason"] == "stop":
                obj = json.loads(ch["message"]["content"])
                if fmt == "json_schema":
                    jsonschema.validate(obj, SCHEMA)
            else:       # cut at max_tokens: still a path of the grammar's
                assert ch["finish_reason"] == "length"
        text = urllib.request.urlopen(base + "/metrics", timeout=30).read().decode()
        assert "llm_requests_total 4" in text
    finally:
        srv.close()
