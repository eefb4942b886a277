"""The port's standard-library OpenAI server, in-thread on the CPU.

debug-tiny with the byte tokenizer, driven over real HTTP with urllib;
response and SSE chunk shapes as in tests/test_server.py.
"""

import json
import urllib.error
import urllib.request

import pytest

from llms_on_kubernetes_tpu_torch import kernels
from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig
from llms_on_kubernetes_tpu_torch.engine.tokenizer import ByteTokenizer
from llms_on_kubernetes_tpu_torch.server.openai_api import IncrementalDetokenizer, OpenAIServer


@pytest.fixture(scope="module")
def base():
    eng = Engine(EngineConfig(model="debug-tiny", dtype="float32", max_decode_slots=4,
                              page_size=4, num_pages=256, pages_per_slot=32,
                              prefill_buckets=(32, 64), device="cpu"))
    server = OpenAIServer(eng, ByteTokenizer(), "debug-tiny")
    port = server.start("127.0.0.1", 0)
    yield f"http://127.0.0.1:{port}"
    server.close()
    assert not server.loop.is_alive()


def call(base, path, body=None, raw=None):
    data = raw if raw is not None else (json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(base + path, data=data,
                                 method="POST" if data is not None else "GET",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def sse(raw: bytes) -> list[str]:
    return [line[6:] for line in raw.decode().splitlines() if line.startswith("data: ")]


def test_health_and_models(base):
    status, _, body = call(base, "/health")
    assert status == 200 and body == b"OK"
    status, _, body = call(base, "/v1/models")
    data = json.loads(body)
    assert status == 200 and data["object"] == "list"
    assert data["data"][0]["id"] == "debug-tiny"


def test_chat_completion_non_streaming(base):
    status, _, body = call(base, "/v1/chat/completions", {
        "model": "debug-tiny", "messages": [{"role": "user", "content": "hi"}],
        "max_tokens": 8, "temperature": 0})
    data = json.loads(body)
    assert status == 200 and data["object"] == "chat.completion"
    choice = data["choices"][0]
    assert choice["message"]["role"] == "assistant"
    assert choice["finish_reason"] in ("length", "stop")
    assert data["usage"]["completion_tokens"] <= 8
    assert data["usage"]["total_tokens"] == (data["usage"]["prompt_tokens"]
                                             + data["usage"]["completion_tokens"])


def test_completions_endpoint(base):
    status, _, body = call(base, "/v1/completions", {
        "model": "debug-tiny", "prompt": "abc", "max_tokens": 4, "temperature": 0})
    data = json.loads(body)
    assert status == 200 and data["object"] == "text_completion"
    assert isinstance(data["choices"][0]["text"], str)
    assert data["usage"] == {"prompt_tokens": 3, "completion_tokens": 4, "total_tokens": 7}


def test_token_id_prompt(base):
    status, _, body = call(base, "/v1/completions", {
        "prompt": [97, 98, 99], "max_tokens": 4, "temperature": 0})
    status2, _, body2 = call(base, "/v1/completions", {
        "prompt": "abc", "max_tokens": 4, "temperature": 0})
    assert status == status2 == 200
    assert json.loads(body)["choices"][0]["text"] == json.loads(body2)["choices"][0]["text"]


def test_streaming_sse_chunks(base):
    status, headers, raw = call(base, "/v1/chat/completions", {
        "model": "debug-tiny", "messages": [{"role": "user", "content": "hello"}],
        "max_tokens": 6, "temperature": 0, "stream": True})
    assert status == 200 and headers["Content-Type"].startswith("text/event-stream")
    events = sse(raw)
    assert events[-1] == "[DONE]"
    parsed = [json.loads(e) for e in events[:-1]]
    assert parsed[0]["choices"][0]["delta"].get("role") == "assistant"
    assert parsed[0]["object"] == "chat.completion.chunk"
    finals = [p for p in parsed if p["choices"][0]["finish_reason"]]
    assert len(finals) == 1


@pytest.mark.parametrize("chat", [True, False])
def test_streaming_matches_non_streaming_greedy(base, chat):
    if chat:
        path, payload = "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "xyz"}], "max_tokens": 8,
            "temperature": 0}
        text_of = lambda d: d["choices"][0]["message"]["content"]
        delta_of = lambda c: c["choices"][0]["delta"].get("content") or ""
    else:
        path, payload = "/v1/completions", {"prompt": "xyz", "max_tokens": 8,
                                            "temperature": 0}
        text_of = lambda d: d["choices"][0]["text"]
        delta_of = lambda c: c["choices"][0]["text"]
    _, _, body = call(base, path, payload)
    full = text_of(json.loads(body))
    _, _, raw = call(base, path, {**payload, "stream": True,
                                  "stream_options": {"include_usage": True}})
    chunks = [json.loads(e) for e in sse(raw)[:-1]]
    assert "".join(delta_of(c) for c in chunks if c["choices"]) == full
    assert chunks[-1]["choices"] == [] and chunks[-1]["usage"]["completion_tokens"] == 8


def test_seeded_sampling_is_reproducible(base):
    body = {"prompt": "fox", "max_tokens": 10, "temperature": 0.8, "seed": 7}
    a = json.loads(call(base, "/v1/completions", body)[2])["choices"][0]["text"]
    b = json.loads(call(base, "/v1/completions", body)[2])["choices"][0]["text"]
    assert a == b


@pytest.mark.parametrize("path,kw", [
    ("/v1/chat/completions", dict(raw=b"{not json")),
    ("/v1/chat/completions", dict(body={"messages": []})),
    ("/v1/chat/completions", dict(body={"messages": [{"role": "user", "content": 3}]})),
    ("/v1/completions", dict(body={"prompt": ""})),
    ("/v1/completions", dict(body={"prompt": "x" * 500})),
    ("/v1/completions", dict(body={"prompt": "abc", "top_k": 1000})),
    ("/v1/completions", dict(body={"prompt": "abc", "logprobs": 2})),
    ("/v1/completions", dict(body={"prompt": "abc", "stop": ["x"]})),
    ("/v1/completions", dict(body={"prompt": "abc", "n": 2})),
    ("/v1/completions", dict(body={"prompt": "abc", "temperature": "hot"})),
    ("/v1/completions", dict(raw=b"[1, 2]")),
])
def test_bad_requests_get_400(base, path, kw):
    status, _, body = call(base, path, **kw)
    assert status == 400
    assert "message" in json.loads(body)["error"]


def test_unknown_route_404(base):
    assert call(base, "/v2/nothing")[0] == 404
    assert call(base, "/v2/nothing", {})[0] == 404


def test_debug_kernels_endpoint(base):
    status, _, body = call(base, "/debug/kernels")
    data = json.loads(body)
    assert status == 200 and data["device"] == "cpu" and data["num_layers"] == 2
    assert data["launches"] == {}          # CPU tensors take the plain versions
    kernels.LAUNCHES["flash_prefill"] += 2
    assert json.loads(call(base, "/debug/kernels")[2])["launches"] == {"flash_prefill": 2}
    status, _, body = call(base, "/debug/kernels/reset", {})
    assert status == 200 and json.loads(body)["launches"] == {}


def test_concurrent_clients_all_complete(base):
    """More client threads than cores, with a short switch interval: every
    request is admitted once, answered once, and the same greedy prompt
    gives the same text whatever batch it lands in."""
    import sys
    import threading

    results: dict = {}

    def client(i):
        results[i] = call(base, "/v1/completions", {
            "prompt": "abc" if i % 2 else "xy", "max_tokens": 3, "temperature": 0})

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert sorted(results) == list(range(24))
    texts = {}
    for i, (status, _, body) in results.items():
        data = json.loads(body)
        assert status == 200 and data["usage"]["completion_tokens"] == 3
        texts.setdefault(i % 2, set()).add(data["choices"][0]["text"])
    assert all(len(v) == 1 for v in texts.values())


def test_engine_loop_sheds_on_a_failed_step():
    """A step that raises must end every waiting stream with "error", not
    leave its client blocked, and the loop keeps serving."""
    import queue

    from llms_on_kubernetes_tpu_torch.engine.engine import SamplingParams
    from llms_on_kubernetes_tpu_torch.server.openai_api import EngineLoop

    eng = Engine(EngineConfig(model="debug-tiny", dtype="float32", max_decode_slots=2,
                              page_size=4, num_pages=64, pages_per_slot=8,
                              prefill_buckets=(16,), device="cpu"))
    real = eng._decode

    def broken():
        eng._decode = real          # fail once
        raise RuntimeError("device fault")

    eng._decode = broken
    loop = EngineLoop(eng)
    loop.start()
    try:
        got: "queue.SimpleQueue" = queue.SimpleQueue()
        loop.submit([1, 2, 3], SamplingParams(max_tokens=4, temperature=0.0), got.put)
        payloads = [got.get(timeout=30)]
        while not payloads[-1][1]:
            payloads.append(got.get(timeout=30))
        assert payloads[-1][2] == "error"
        again: "queue.SimpleQueue" = queue.SimpleQueue()
        loop.submit([1, 2, 3], SamplingParams(max_tokens=2, temperature=0.0), again.put)
        last = again.get(timeout=30)
        while not last[1]:
            last = again.get(timeout=30)
        assert last[2] == "length"
    finally:
        loop.stop()
        loop.join(timeout=10)
    assert not loop.is_alive()


def test_incremental_detokenizer_holds_partial_utf8():
    d = IncrementalDetokenizer(ByteTokenizer())
    snowman = "☃".encode()
    assert d.push([snowman[0]]) == ""
    assert d.push([snowman[1]]) == ""
    assert d.push([snowman[2]]) == "☃"
    assert d.push(list("ok".encode()), final=True) == "ok"
