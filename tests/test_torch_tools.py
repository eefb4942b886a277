"""OpenAI tool calling in the port against the JAX package, on the CPU.

- ``server/tools.py``: ``ToolStreamParser`` gives the JAX parser's content
  and calls (ids aside: they are random) for the same text cut into deltas
  anywhere; ``validate_tools``, ``validate_tool_choice`` and
  ``inject_tool_messages`` answer as the JAX ones, errors included.
- The chat template gets the tools: ``ByteTokenizer`` and the
  ``JsonTokenizer`` of the llama3 and phi3 files ``synth_checkpoint``
  writes give the JAX tokenizers' ids, with the tools and the injected
  instruction.
- Server (the JAX tests/test_tools.py cases): a scripted tokenizer turns
  the random model's tokens into a known tool-call text, so the port
  server and the JAX server on the same weights answer the same
  ``tool_calls``, content and finish_reason "tool_calls", streamed (one
  ``tool_calls`` delta a call) and not; ``tool_choice: "none"`` turns the
  parsing off; bad tools and choices answer 400 on both.
"""

import asyncio
import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from llms_on_kubernetes_tpu.configs import get_config as jget_config
from llms_on_kubernetes_tpu.engine.engine import Engine as JEngine
from llms_on_kubernetes_tpu.engine.engine import EngineConfig as JEngineConfig
from llms_on_kubernetes_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from llms_on_kubernetes_tpu.engine.tokenizer import HFTokenizer
from llms_on_kubernetes_tpu.models.decoder import init_params as j_init_params
from llms_on_kubernetes_tpu.server import tools as jtools
from llms_on_kubernetes_tpu.server.openai_api import OpenAIServer as JOpenAIServer
from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig
from llms_on_kubernetes_tpu_torch.engine.tokenizer import ByteTokenizer, JsonTokenizer
from llms_on_kubernetes_tpu_torch.engine.weights import params_from_numpy
from llms_on_kubernetes_tpu_torch.server import tools as ttools
from llms_on_kubernetes_tpu_torch.server.openai_api import OpenAIServer
from llms_on_kubernetes_tpu_torch.testing import synth_checkpoint as synth

TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "Get the weather",
    "parameters": {"type": "object", "properties": {"city": {"type": "string"}}}}}]
TARGET = ('I will check. <tool_call>{"name": "get_weather", "arguments": '
          '{"city": "Oslo"}}</tool_call>END')
TEXTS = [
    TARGET,
    'a<tool_call>{"name": "f", "arguments": {}}</tool_call>b<tool_call>{"name": "g", '
    '"arguments": "{\\"x\\": 1}"}</tool_call>',
    "no calls at all, just <tool text < and <tool_",
    '<tool_call>not json</tool_call> tail',
    '<tool_call>{"name": "f", "arguments": {"a": [1, 2]}}',      # unterminated
    '<tool_call>{"arguments": {}}</tool_call>',                  # no name
]


def _no_ids(calls):
    return [{k: v for k, v in c.items() if k != "id"} for c in calls]


@pytest.mark.parametrize("text", TEXTS, ids=range(len(TEXTS)))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stream_parser_equals_the_jax_parser(text, seed):
    rng = np.random.default_rng(seed)
    cuts = sorted(set(rng.integers(0, len(text) + 1, 6).tolist()))
    pieces = [text[a:b] for a, b in zip([0] + cuts, cuts + [len(text)])]
    tp, jp = ttools.ToolStreamParser(), jtools.ToolStreamParser()
    for i, piece in enumerate(pieces):
        final = i == len(pieces) - 1
        (tc, tcalls), (jc, jcalls) = tp.push(piece, final=final), jp.push(piece, final=final)
        assert tc == jc and _no_ids(tcalls) == _no_ids(jcalls)
    assert _no_ids(tp.calls) == _no_ids(jp.calls)
    assert all(c["id"].startswith("call_") and len(c["id"]) == 29 for c in tp.calls)


CHOICES = [None, "none", "auto", "required", {"type": "function",
                                              "function": {"name": "get_weather"}},
           {"type": "function", "function": {"name": "unknown"}}, {"type": "function"},
           "sometimes", 3]


@pytest.mark.parametrize("tools", [TOOLS, None, [], [{"type": "function", "function": {}}],
                                   [{"type": "other"}], "x"], ids=range(6))
@pytest.mark.parametrize("choice", CHOICES, ids=range(len(CHOICES)))
def test_validation_equals_jax(tools, choice):
    def run(mod):
        try:
            t = mod.validate_tools(tools) if tools is not None else None
            return ("ok", mod.validate_tool_choice(choice, t))
        except ValueError as e:
            return ("error", str(e))
    assert run(ttools) == run(jtools)


@pytest.mark.parametrize("choice", [None, "auto", "required", "get_weather"])
def test_inject_tool_messages_equals_jax(choice):
    msgs = [{"role": "system", "content": "be brief"}, {"role": "user", "content": "do it"},
            {"role": "assistant", "content": "ok"}]
    assert ttools.inject_tool_messages(msgs, choice) == jtools.inject_tool_messages(msgs, choice)
    assert msgs[1]["content"] == "do it"
    mm = [{"role": "user", "content": [{"type": "image"}]}]
    assert ttools.inject_tool_messages(mm, "required") == jtools.inject_tool_messages(
        mm, "required")
    only_system = [{"role": "system", "content": "x"}]
    assert ttools.inject_tool_messages(only_system, choice) == \
        jtools.inject_tool_messages(only_system, choice)


@pytest.fixture(scope="module")
def tokenizer_dirs(tmp_path_factory):
    out = {}
    for fam in ("llama3", "phi3"):
        d = str(tmp_path_factory.mktemp(f"tools-{fam}"))
        synth.write_tokenizer(d, fam)
        out[fam] = d
    return out


@pytest.mark.parametrize("fam", ["byte", "llama3", "phi3"])
@pytest.mark.parametrize("choice", ["auto", "required"])
def test_tools_render_through_the_chat_template_as_jax(tokenizer_dirs, fam, choice):
    msgs = ttools.inject_tool_messages([{"role": "user", "content": "weather in Oslo?"}],
                                       choice)
    if fam == "byte":
        port, ref = ByteTokenizer(), JByteTokenizer()
    else:
        port, ref = JsonTokenizer(tokenizer_dirs[fam]), HFTokenizer(tokenizer_dirs[fam])
    got = port.apply_chat_template(msgs, tools=TOOLS)
    assert list(got) == list(ref.apply_chat_template(msgs, tools=TOOLS))
    # the synthetic files' templates ignore tools (so do their JAX readings);
    # the byte tokenizer renders them
    if fam == "byte":
        assert len(got) > len(port.apply_chat_template(msgs))
        assert "get_weather" in port.decode(got)


# ---------------------------------------------------------------------------
# the server, with a scripted tokenizer
# ---------------------------------------------------------------------------

SMALL = dict(model="debug-tiny", dtype="float32", max_decode_slots=4, page_size=8,
             num_pages=256, pages_per_slot=64, prefill_buckets=(32, 64))
CHAT_BODY = {"model": "debug-tiny", "messages": [{"role": "user", "content": "weather in Oslo?"}],
             "tools": TOOLS, "max_tokens": len(TARGET) + 8, "temperature": 0, "stop": ["END"]}


class Scripted(ByteTokenizer):
    """decode(ids) yields a fixed script, one character a token: the
    model's sampled ids become a known text."""

    def decode(self, ids):
        return TARGET[:len(ids)]


class JScripted(JByteTokenizer):
    def decode(self, ids):
        return TARGET[:len(ids)]


CASES = {
    "tool call": CHAT_BODY,
    "tool call streamed": {**CHAT_BODY, "stream": True},
    "tool_choice none": {**CHAT_BODY, "tool_choice": "none"},
    "tool_choice none streamed": {**CHAT_BODY, "tool_choice": "none", "stream": True},
    "auto n 2": {**CHAT_BODY, "n": 2},
    "bad tool": {**CHAT_BODY, "tools": [{"type": "function", "function": {}}]},
    "unknown function": {**CHAT_BODY, "tool_choice": {"type": "function",
                                                      "function": {"name": "unknown"}}},
    "required without tools": {**{k: v for k, v in CHAT_BODY.items() if k != "tools"},
                               "tool_choice": "required"},
    "tools not a list": {**CHAT_BODY, "tools": {"type": "function"}},
}


@pytest.fixture(scope="module")
def answers():
    jp = j_init_params(jget_config("debug-tiny"), jax.random.key(0), dtype="float32")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    srv = OpenAIServer(Engine(EngineConfig(**SMALL, device="cpu"), params=tp), Scripted(),
                       "debug-tiny")
    base = f"http://127.0.0.1:{srv.start()}"
    port = {}
    try:
        for name, body in CASES.items():
            req = urllib.request.Request(base + "/v1/chat/completions",
                                         data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=60) as r:
                    port[name] = (r.status, r.read())
            except urllib.error.HTTPError as e:
                port[name] = (e.code, e.read())
    finally:
        srv.close()

    async def go():
        jsrv = JOpenAIServer(JEngine(JEngineConfig(**SMALL), params=jp), JScripted(),
                             "debug-tiny")
        client = TestClient(TestServer(jsrv.make_app()))
        await client.start_server()
        out = {}
        try:
            for name, body in CASES.items():
                r = await client.post("/v1/chat/completions", json=body)
                out[name] = (r.status, await r.read())
        finally:
            await client.close()
        return out
    return port, asyncio.run(go())


def _stream_view(raw: bytes) -> list:
    """Per choice: content, tool_calls deltas (ids aside) and finish."""
    out: dict = {}
    for line in raw.decode().splitlines():
        if not line.startswith("data: {"):
            continue
        frame = json.loads(line[6:])
        for ch in frame["choices"]:
            acc = out.setdefault(ch["index"], {"content": "", "tools": [], "finish": []})
            acc["content"] += ch["delta"].get("content") or ""
            acc["tools"] += _no_ids(ch["delta"].get("tool_calls", []))
            if ch["finish_reason"]:
                acc["finish"].append(ch["finish_reason"])
    return [out[i] for i in sorted(out)]


@pytest.mark.parametrize("name", list(CASES))
def test_tool_answers_equal_the_jax_server(answers, name):
    (gs, got), (ws, want) = answers[0][name], answers[1][name]
    assert gs == ws, (got, want)
    if gs != 200:
        assert json.loads(got)["error"]["message"] == json.loads(want)["error"]["message"]
        return
    if CASES[name].get("stream"):
        assert _stream_view(got) == _stream_view(want)
        return
    g, w = json.loads(got), json.loads(want)
    for d in (g, w):
        for ch in d["choices"]:
            ch["message"]["tool_calls"] = _no_ids(ch["message"].get("tool_calls", []))
    assert g["choices"] == w["choices"]


def test_the_tool_call_has_the_documented_shape(answers):
    choice = json.loads(answers[0]["tool call"][1])["choices"][0]
    assert choice["finish_reason"] == "tool_calls"
    (call,) = choice["message"]["tool_calls"]
    assert call["type"] == "function" and call["id"].startswith("call_")
    assert call["function"]["name"] == "get_weather"
    assert json.loads(call["function"]["arguments"]) == {"city": "Oslo"}
    assert choice["message"]["content"] == "I will check. "
    streamed = _stream_view(answers[0]["tool call streamed"][1])[0]
    assert "<tool_call>" not in streamed["content"]
    assert [t["index"] for t in streamed["tools"]] == [0]
    assert streamed["finish"] == ["tool_calls"]
    off = json.loads(answers[0]["tool_choice none"][1])["choices"][0]["message"]
    assert "tool_calls" not in off and "<tool_call>" in off["content"]
