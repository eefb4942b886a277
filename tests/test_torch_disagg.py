"""The port's disaggregated prefill/decode handoff against the JAX package's.

- Addressing and the wire: ``handoff_digests`` equal the JAX engine's;
  ``encode_kv_payload`` is byte-equal to the JAX ``_encode_kv_payload``
  for float32, bfloat16 and int8 pages (the port's bf16 page is the same
  bytes as ``uint16`` and goes out as "bfloat16"), and the JAX documents
  decode in the port to the same bytes.
- Engines (debug-tiny, float32, the JAX weights on both sides; greedy
  token streams exact): pages a JAX prefill engine exports, ingested by a
  port decode engine, give the JAX colocated stream; the port's own
  handoff gives the port's colocated stream (K 1 and 4, sync and async).
  A salted chain, a corrupt or truncated page and a deadline that expires
  degrade to a re-prefill with the same stream and exact page accounting.
- Servers on the CPU behind the JAX package's Python router
  (``server/router.py``, as tests/test_disagg.py runs the JAX servers):
  two port stdlib replicas, prefill and decode, give the colocated
  stream with outcome "ok"; ``drop_handoff`` gives "reprefill" and
  ``kill_prefill_replica`` "fallback_colocated", the stream whole either
  way; a JAX prefill replica hands off to a port decode replica and the
  other way round.
"""

import asyncio
import json
import time
import urllib.request

import jax
import ml_dtypes
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from llms_on_kubernetes_tpu.configs import get_config as jget_config
from llms_on_kubernetes_tpu.engine.engine import Engine as JEngine
from llms_on_kubernetes_tpu.engine.engine import EngineConfig as JEngineConfig
from llms_on_kubernetes_tpu.engine.engine import SamplingParams as JSamplingParams
from llms_on_kubernetes_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from llms_on_kubernetes_tpu.models.decoder import init_params as j_init_params
from llms_on_kubernetes_tpu.server import openai_api as japi
from llms_on_kubernetes_tpu.server.router import Router
from llms_on_kubernetes_tpu_torch import faults
from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
from llms_on_kubernetes_tpu_torch.engine.tokenizer import ByteTokenizer
from llms_on_kubernetes_tpu_torch.engine.weights import params_from_numpy
from llms_on_kubernetes_tpu_torch.server import openai_api as tapi

SMALL = dict(model="debug-tiny", dtype="float32", max_decode_slots=4, page_size=8,
             num_pages=64, pages_per_slot=8, prefill_buckets=(16, 32), kv_host_cache_gb=0.5)
PROMPT = list(range(1, 21)) + [30, 31, 32]
TENANT = "tenant-a"


@pytest.fixture(scope="module")
def jparams():
    return j_init_params(jget_config("debug-tiny"), jax.random.key(0), dtype="float32")


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _port(tparams, role="both", **kw):
    return Engine(EngineConfig(**{**SMALL, "device": "cpu", "role": role, **kw}),
                  params=tparams)


def _jax(jparams, role="both", **kw):
    return JEngine(JEngineConfig(**{**SMALL, "role": role, **kw}), params=jparams)


def _run(eng, SP, prompt, max_tokens=8, **kw):
    req = eng.submit(list(prompt), SP(temperature=0.0, max_tokens=max_tokens), **kw)
    for _ in range(20_000):
        if req.finished and not eng.has_work():
            return req
        eng.step()
    raise AssertionError("engine did not finish")


def _export(eng, SP, prompt=PROMPT):
    _run(eng, SP, prompt, max_tokens=1, tenant=TENANT, handoff=True)
    digests = eng.handoff_digests(prompt)
    payloads = eng.host_kv_export(TENANT, digests)
    assert digests and all(p is not None for p in payloads)
    return digests, payloads


# -- addressing and the wire --------------------------------------------


def test_handoff_digests_equal_jax(jparams, tparams):
    j, t = _jax(jparams), _port(tparams)
    for prompt in (PROMPT, PROMPT[:7], PROMPT[:16], [99] + PROMPT[1:], list(range(200))):
        for salt in (b"", b"other-cluster"):
            assert t.handoff_digests(prompt, salt=salt) == j.handoff_digests(prompt, salt=salt)


def _page(kind, rng):
    shp = (2, 3, 8, 16)
    if kind == "float32":
        a = rng.standard_normal(shp).astype(np.float32)
        return {"k": a, "v": -a, "ks": None, "vs": None}, None
    if kind == "bfloat16":
        a = rng.standard_normal(shp).astype(ml_dtypes.bfloat16)
        jp = {"k": a, "v": a[::-1].copy(), "ks": None, "vs": None}
        return jp, {k: (None if v is None else v.view(np.uint16)) for k, v in jp.items()}
    k = rng.integers(-127, 128, shp).astype(np.int8)
    s = rng.random(shp[:3]).astype(np.float32)
    return {"k": k, "v": k[:, ::-1].copy(), "ks": s, "vs": s * 2}, None


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_wire_form_is_byte_equal_to_jax(kind):
    jp, tp = _page(kind, np.random.default_rng(0))
    tp = tp or jp
    enc_t, enc_j = tapi.encode_kv_payload(tp), japi._encode_kv_payload(jp)
    assert json.dumps(enc_t) == json.dumps(enc_j)
    if kind == "bfloat16":
        assert enc_t["k"]["dtype"] == "bfloat16"
    # the JAX document decodes in the port to the same bytes (a bf16 page
    # as the uint16 view), and the port's in the JAX server
    dec = tapi.decode_kv_payload(json.loads(json.dumps(enc_j)))
    back = japi._decode_kv_payload(json.loads(json.dumps(enc_t)))
    for side in ("k", "v", "ks", "vs"):
        if jp[side] is None:
            assert dec[side] is None and back[side] is None
            continue
        assert dec[side].tobytes() == jp[side].tobytes()
        assert dec[side].shape == jp[side].shape
        assert back[side].dtype == jp[side].dtype and back[side].tobytes() == jp[side].tobytes()
    if kind == "bfloat16":
        assert dec["k"].dtype == np.uint16


def test_corrupt_wire_documents_decode_to_none():
    jp, _ = _page("float32", np.random.default_rng(1))
    enc = tapi.encode_kv_payload(jp)
    flipped = json.loads(json.dumps(enc))
    raw = bytearray(flipped["k"]["b64"].encode())
    raw[10] = ord("A") if raw[10] != ord("A") else ord("B")
    flipped["k"]["b64"] = raw.decode()
    truncated = json.loads(json.dumps(enc))
    truncated["v"]["b64"] = truncated["v"]["b64"][:-8]
    for doc in (flipped, truncated, {"k": None, "v": None}, "x", {"k": {"b64": 1}},
                {**enc, "k": {**enc["k"], "dtype": "no-such-type"}}):
        assert tapi.decode_kv_payload(doc) is None
        assert japi._decode_kv_payload(doc) is None


# -- engines --------------------------------------------------------------


def test_jax_export_to_port_ingest_gives_the_jax_stream(jparams, tparams):
    want = _run(_jax(jparams), JSamplingParams, PROMPT, tenant=TENANT).output
    digests, payloads = _export(_jax(jparams, role="prefill"), JSamplingParams)
    dec = _port(tparams, role="decode")
    wire = [tapi.decode_kv_payload(json.loads(json.dumps(japi._encode_kv_payload(p))))
            for p in payloads]
    for d, pl in zip(digests, wire):
        assert dec.host_kv_ingest(TENANT, d, pl)
    got = _run(dec, SamplingParams, PROMPT, tenant=TENANT)
    assert got.output == want
    assert dec.host_kv.hits == len(digests) and dec.kv_uploaded_tokens == 8 * len(digests)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("async_scheduling", [False, True])
def test_port_handoff_is_bit_identical_to_colocated(tparams, k, async_scheduling):
    kw = dict(decode_steps=k, async_scheduling=async_scheduling)
    cold = _run(_port(tparams, **kw), SamplingParams, PROMPT, tenant=TENANT).output
    digests, payloads = _export(_port(tparams, role="prefill", **kw), SamplingParams)
    dec = _port(tparams, role="decode", **kw)
    for d, pl in zip(digests, payloads):
        assert dec.host_kv_ingest(TENANT, d, pl)
    hot = _run(dec, SamplingParams, PROMPT, tenant=TENANT)
    assert hot.output == cold
    assert dec.host_kv.hits > 0 and dec.kv_uploaded_tokens > 0
    # the decode replica prefilled only the remainder after the adopted pages
    assert dec.prefill_calls == 0 and dec.chunk_calls == 1


def test_salt_mismatch_reprefills(tparams):
    cold = _run(_port(tparams), SamplingParams, PROMPT, tenant=TENANT).output
    pre = _port(tparams, role="prefill")
    _, payloads = _export(pre, SamplingParams)
    wrong = pre.handoff_digests(PROMPT, salt=b"some-other-salt")
    dec = _port(tparams, role="decode")
    for d, pl in zip(wrong, payloads):
        assert dec.host_kv_ingest(TENANT, d, pl)
    assert _run(dec, SamplingParams, PROMPT, tenant=TENANT).output == cold
    assert dec.host_kv.hits == 0


def test_corrupt_or_truncated_pages_are_missing_pages(tparams):
    cold = _run(_port(tparams), SamplingParams, PROMPT, tenant=TENANT).output
    digests, payloads = _export(_port(tparams, role="prefill"), SamplingParams)
    assert len(digests) >= 2
    dec = _port(tparams, role="decode")
    for d, pl in zip(digests, payloads):
        bad = dict(pl)
        bad["k"] = np.asarray(pl["k"]).ravel()[:3].copy()       # truncated
        assert dec.host_kv_ingest(TENANT, d, bad) is False
    assert len(dec.host_kv) == 0
    assert _run(dec, SamplingParams, PROMPT, tenant=TENANT).output == cold
    # rot after ingest: the adoption walk stops at the bad page
    dec = _port(tparams, role="decode")
    for d, pl in zip(digests, payloads):
        assert dec.host_kv_ingest(TENANT, d, pl)
    dec.host_kv._entries[(TENANT, digests[1])]["k"] = np.zeros(3, np.float32)
    assert _run(dec, SamplingParams, PROMPT, tenant=TENANT).output == cold
    assert 0 < dec.host_kv.hits < len(digests)


@pytest.mark.parametrize("async_scheduling", [False, True])
def test_deadline_expiry_returns_every_page(tparams, async_scheduling):
    cold = _run(_port(tparams), SamplingParams, PROMPT, tenant=TENANT).output
    digests, payloads = _export(_port(tparams, role="prefill"), SamplingParams)
    dec = _port(tparams, role="decode", async_scheduling=async_scheduling)
    for d, pl in zip(digests, payloads):
        assert dec.host_kv_ingest(TENANT, d, pl)

    def idle(a):
        return len(a.free_pages) + len(a._lru)

    before = idle(dec.allocator)
    req = dec.submit(list(PROMPT), SamplingParams(temperature=0.0, max_tokens=8),
                     tenant=TENANT, deadline=time.monotonic() - 0.1)
    for _ in range(1000):
        if req.finished and not dec.has_work():
            break
        dec.step()
    assert req.finish_reason == "timeout"
    assert idle(dec.allocator) == before and not dec._host_adopt
    assert len(dec.host_kv) == len(digests)
    assert _run(dec, SamplingParams, PROMPT, tenant=TENANT).output == cold


# -- servers behind the Python router -----------------------------------


def _chat_body(**over):
    body = {"model": "m", "messages": [{"role": "user", "content": "hello disagg world"}],
            "max_tokens": 8, "temperature": 0, "stream": True}
    body.update(over)
    return body


def _sse_content(text: str) -> str:
    out = []
    for line in text.splitlines():
        if not line.startswith("data: ") or line == "data: [DONE]":
            continue
        doc = json.loads(line[len("data: "):])
        for ch in doc.get("choices", ()):
            out.append(ch.get("delta", {}).get("content") or "")
    return "".join(out)


def _port_server(tparams, role):
    srv = tapi.OpenAIServer(_port(tparams, role=role), ByteTokenizer(), "m")
    return srv, f"http://127.0.0.1:{srv.start()}"


def _colocated(tparams, body) -> str:
    srv, url = _port_server(tparams, "both")
    try:
        req = urllib.request.Request(url + "/v1/chat/completions", json.dumps(body).encode(),
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return _sse_content(r.read().decode())
    finally:
        srv.close()


class _Pair:
    """A prefill and a decode replica (each port or JAX) behind a Router."""

    def __init__(self, tparams, jparams, pre="port", dec="port", **router_kw):
        self.kinds = (pre, dec)
        self.tparams, self.jparams = tparams, jparams
        self.router_kw = router_kw
        self.closers = []

    async def _replica(self, kind, role):
        if kind == "port":
            srv, url = _port_server(self.tparams, role)
            self.closers.append(srv.close)
            return srv, url
        srv = japi.OpenAIServer(_jax(self.jparams, role=role), JByteTokenizer(), "m")
        client = TestClient(TestServer(srv.make_app()))
        await client.start_server()
        self.closers.append(client.close)
        return srv, str(client.make_url("")).rstrip("/")

    async def __aenter__(self):
        self.s_pre, self.u_pre = await self._replica(self.kinds[0], "prefill")
        self.s_dec, self.u_dec = await self._replica(self.kinds[1], "decode")
        self.router = Router({"m": [self.u_pre, self.u_dec]},
                             roles={self.u_pre: "prefill", self.u_dec: "decode"},
                             **self.router_kw)
        self.client = TestClient(TestServer(self.router.make_app()))
        await self.client.start_server()
        return self

    async def __aexit__(self, *exc):
        await self.client.close()
        for close in reversed(self.closers):
            out = close()
            if asyncio.iscoroutine(out):
                await out

    def outcomes(self) -> dict:
        m = self.router.metrics["handoff"]
        return {oc: m.labeled_value(outcome=oc)
                for oc in ("ok", "retried", "reprefill", "fallback_colocated")}


async def _chat(pair, body):
    resp = await pair.client.post("/v1/chat/completions", json=body)
    assert resp.status == 200
    assert resp.headers["Content-Type"].startswith("text/event-stream")
    return _sse_content(await resp.text())


@pytest.mark.parametrize("pre,dec", [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_two_hop_handoff_behind_the_router(tparams, jparams, pre, dec):
    ref = _colocated(tparams, _chat_body())
    assert ref

    async def go():
        async with _Pair(tparams, jparams, pre, dec) as d:
            assert await _chat(d, _chat_body()) == ref
            assert d.outcomes() == {"ok": 1, "retried": 0, "reprefill": 0,
                                    "fallback_colocated": 0}
            assert d.s_dec.engine.host_kv.hits > 0
            assert d.s_pre.engine.host_kv.spilled_pages > 0
    asyncio.run(go())


def test_port_decode_replica_answers_the_hop_headers(tparams):
    """The decode hop by hand: the pulled pages land, the answer carries
    X-LLMK-Handoff-Adopted and X-LLMK-Cache-Digests, and the source's
    fetch answers null past what it holds."""
    pre, u_pre = _port_server(tparams, "prefill")
    dec, u_dec = _port_server(tparams, "decode")
    try:
        body = _chat_body()
        req = urllib.request.Request(u_pre + "/v1/chat/completions", json.dumps(body).encode(),
                                     {"Content-Type": "application/json",
                                      "X-LLMK-Handoff": "ticket"})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.headers["X-LLMK-Handoff-Ticket"] == "1"
            ticket = json.loads(r.read())
        assert ticket["object"] == "llmk.handoff_ticket" and ticket["digests"]
        hdr = {"Content-Type": "application/json",
               "X-LLMK-Handoff-Source": u_pre, "X-LLMK-Handoff-Tenant": ticket["tenant"],
               "X-LLMK-Handoff-Digests": ",".join(ticket["digests"]),
               "X-LLMK-Handoff-Seed": str(ticket["seed"])}
        req = urllib.request.Request(u_dec + "/v1/chat/completions", json.dumps(body).encode(),
                                     hdr)
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.headers["X-LLMK-Handoff-Adopted"] == str(len(ticket["digests"]))
            assert r.headers["X-LLMK-Cache-Digests"].split(",") == \
                ticket["digests"][:tapi.CACHE_DIGESTS_MAX]
            assert _sse_content(r.read().decode()) == _colocated(tparams, body)
        fetch = urllib.request.Request(
            u_pre + "/internal/kv/fetch", json.dumps(
                {"tenant": ticket["tenant"], "digests": ticket["digests"] + ["00" * 32]}).encode(),
            {"Content-Type": "application/json"})
        with urllib.request.urlopen(fetch, timeout=60) as r:
            doc = json.loads(r.read())
        assert doc["payloads"][-1] is None
        assert all(tapi.decode_kv_payload(p) is not None for p in doc["payloads"][:-1])
        trace = json.loads(urllib.request.urlopen(u_dec + "/debug/traces?limit=1",
                                                  timeout=30).read())["traces"][0]
        assert "kv_pull" in {s["name"] for s in trace["spans"]}
        text = urllib.request.urlopen(u_dec + "/metrics", timeout=30).read().decode()
        assert 'llm_queue_depth{model="m",role="decode"}' in text
        hits = dec.engine.host_kv.hits
        assert hits == len(ticket["digests"])
        assert f"llm_kv_host_cache_hits_total {hits}" in text
        engine = json.loads(urllib.request.urlopen(u_dec + "/debug/engine", timeout=30).read())
        assert engine["role"] == "decode"
    finally:
        pre.close()
        dec.close()


def test_drop_handoff_counts_reprefill(tparams, jparams, monkeypatch):
    ref = _colocated(tparams, _chat_body())
    faults.reset_claims()
    monkeypatch.setenv("LLMK_FAULT", "drop_handoff:1")

    async def go():
        async with _Pair(tparams, jparams) as d:
            assert await _chat(d, _chat_body()) == ref
            assert d.outcomes()["reprefill"] == 1 and d.outcomes()["ok"] == 0
            assert d.s_dec.engine.host_kv.hits == 0
    try:
        asyncio.run(go())
    finally:
        faults.reset_claims()


def test_kill_prefill_replica_falls_back_colocated(tparams, jparams, monkeypatch):
    ref = _colocated(tparams, _chat_body())
    faults.reset_claims()
    monkeypatch.setenv("LLMK_FAULT", "kill_prefill_replica:0.0")

    async def go():
        async with _Pair(tparams, jparams) as d:
            deadline = time.monotonic() + 10
            while d.s_pre.state != "killed" and time.monotonic() < deadline:
                await asyncio.sleep(0.02)
            assert d.s_pre.state == "killed"
            assert d.s_dec.state == "serving"       # armed on the prefill role only
            assert await _chat(d, _chat_body()) == ref
            assert d.outcomes()["fallback_colocated"] == 1 and d.outcomes()["ok"] == 0
    try:
        asyncio.run(go())
    finally:
        faults.reset_claims()


def test_declined_ticket_relays_the_stream(tparams, jparams):
    async def go():
        async with _Pair(tparams, jparams) as d:
            resp = await d.client.post("/v1/chat/completions", json=_chat_body(n=2))
            assert resp.status == 200
            assert _sse_content(await resp.text())
            assert sum(d.outcomes().values()) == 0
    asyncio.run(go())
