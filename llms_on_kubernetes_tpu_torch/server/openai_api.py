"""OpenAI-compatible HTTP server on the standard library (counterpart of
``llms_on_kubernetes_tpu/server/openai_api.py``).

``http.server.ThreadingHTTPServer`` answers each connection on a thread of
its own; one ``EngineLoop`` thread drives ``Engine.step``. Handlers submit
requests and block on a per-HTTP-request queue that the engine thread
feeds through ``Request.on_event``. Server-sent events are written by hand
on an HTTP/1.0 response that ends when the connection closes.

Endpoints, with the JAX server's shapes:

- ``POST /v1/completions`` (a prompt string, token ids, or a list of
  either: one choice group each) and ``POST /v1/chat/completions``, each
  with ``"stream": true``. Options: sampling (temperature, top_p, top_k,
  seed, penalties, max_tokens), ``stop`` strings (matched on the text,
  held back across deltas; a hit aborts the engine request),
  ``logprobs`` / ``top_logprobs`` (at most ``LOGPROB_TOPK``),
  ``logit_bias`` (token id -> [-100, 100]), ``n`` and ``best_of`` (at most
  16; choice j > 0 of a seeded request samples with seed + j), ``echo``
  (with ``logprobs``: the prompt's own logprobs, scored by
  ``Engine.score_prompt`` on the engine thread). Guided decoding:
  ``response_format`` ``json_object`` / ``json_schema`` (``{"type":
  "text"}`` is a no-op) and, on chat, ``tools`` / ``tool_choice``
  (``server/tools.py``: the tools render through the chat template, a
  forced or "required" choice is grammar-guaranteed, and tool-call blocks
  in the output come back as ``message.tool_calls`` with finish_reason
  "tool_calls", streamed as one ``tool_calls`` delta a call). The grammar
  (``engine/grammar.py``) is compiled on the request's own thread, off the
  engine thread, and cached; a ``GrammarError`` answers 400, and so does a
  forced tool choice with a JSON ``response_format``. ``suffix`` is
  refused with 400, as by the JAX server.
- Chip time (the goodput ledger, ``engine/ledger.py``): a response's
  ``usage.chip_ms`` holds the device milliseconds its requests were
  attributed by phase and ``X-LLMK-Chip-Ms`` their total (non-streaming);
  the trace's prefill and decode spans carry them too.
- ``GET /health``: 503 only when the engine is wedged (its watchdog shed
  a step the card never finished); ``GET /ready``: 200 with the state and
  the prefix-cache bloom filter while serving, else 503 (loading,
  draining, wedged), as the routers and the charts probe it;
  ``GET /metrics`` (Prometheus text, fed from the engine loop);
  ``POST /tokenize``, ``POST /detokenize``, ``GET /version``,
  ``GET /v1/models``.
- ``GET /debug/kernels`` / ``POST /debug/kernels/reset``: the kernel
  launch counters of ``kernels.LAUNCHES`` (and the part of them graph
  replays added), the engine's prefill, chunk and decode call counts, its
  decode window length and graph replays (the windows', and the verify
  dispatches' and speculative dispatches' counts), its preemptions, the
  prompt tokens served from the prefix cache and the pool's free and
  evictable pages, so launches can be held to calls and pages to their
  idle count. ``/metrics`` has the speculation series
  (``llm_spec_drafted_total``, ``llm_spec_accepted_total``,
  ``llm_spec_accept_ratio``), fed from the engine's counters by deltas.
- ``GET /debug/traces`` (recent request traces, ``?id=``, ``?model=``,
  ``?limit=``) and ``GET /debug/engine`` (the flight recorder: the last
  engine steps, with the ledger's chip time and MFU a step); ``POST
  /v1/embeddings`` answers 501.
- ``POST /debug/profile`` (``{"duration_ms"}``: one bounded capture of the
  live engine, ``server/profiling.py``; 409 while one runs), ``GET
  /debug/profile`` (the captures) and ``GET /debug/profile/{id}`` (one as
  .tar.gz); ``POST /debug/profile/start`` and ``/stop``, the JAX server's
  manual session (started and stopped between engine steps, on the engine
  thread; 409 for a start while a capture or session runs, a stop without
  one, and a bounded capture during one; the stopped session is listed
  and downloaded as a capture). When the ledger's anomaly detector fires, the loop takes one
  capture itself (``llm_auto_profile_total``, rate-limited by the
  detector's cooldown). ``/metrics`` adds the ledger's ``llm_mfu_ratio``,
  ``llm_mbu_ratio``, ``llm_chip_seconds_total{phase}`` and
  ``llm_tenant_chip_seconds_total`` (tenant "default") and the runtime
  telemetry (``server/runtime_telemetry.py``).

The replica contract with the routers, as the JAX server keeps it:

- Request ids and tracing (``server/tracing.py``): ``traceparent``,
  ``tracestate`` and ``X-LLMK-Request-Id`` are reconciled on every request
  and the id is echoed on every response, errors included; each completion
  leaves a trace (admission, queue, prefill, decode and stream spans, the
  engine's preemption and finish events) in the ``/debug/traces`` ring,
  one JSON access-log line, and is tail-sampled to OTLP when
  ``LLMK_OTLP_ENDPOINT`` is set (off otherwise: nothing is sent).
- Deadlines: ``X-LLMK-Deadline-Ms`` (milliseconds left, the router's
  decremented budget; malformed means none) or the body's ``timeout``
  (seconds). Expired on arrival: 504 before admission. The engine sheds a
  waiting request and aborts a running one at its deadline: a choice with
  no output answers 504, a stream ends with finish_reason "timeout", and
  ``llm_deadline_exceeded_total{phase}`` counts queue or decode.
- Stream journal and resume: a single-choice stream asked with
  ``X-LLMK-Journal`` follows each event's ``data:`` lines with a
  ``: llmk-tok <ids>`` comment (the event's raw ids); a request with
  ``X-LLMK-Resume-Tokens`` continues a stream another replica started
  (``SamplingParams.prefix_tokens``, the detokenizer and stop checker
  warmed with the prefix, the original id and ``created`` reused).
- ``Retry-After`` on the queue-full 429 (the backlog's estimated drain
  time, clamped to [1, 60] s); a request body over ``MAX_BODY_BYTES`` is
  refused with 413 before it is read; a stream writes ``: ping`` every
  ``LLMK_SSE_KEEPALIVE_S`` seconds (default 15, <= 0 off) while it waits.
- Fault hooks (``faults.py``): ``flappy_replica``, ``slow_cold_start``,
  ``preempt_replica``, ``degraded_replica``, ``net_jitter`` and
  ``kill_mid_stream`` (a one-shot TCP reset of the first stream to
  deliver N tokens).

- Tenants and priority classes (``server/qos.py``): a completion's tenant
  is the body's ``user``, else its ``model``, else the served model; its
  class the ``X-LLMK-Priority`` header when valid, else the engine's
  per-tenant config. The queue-full 429 carries ``code=overloaded`` and
  counts ``llm_tenant_shed_total``; ``llm_tenant_admitted_total``,
  ``llm_tenant_queue_wait_seconds`` and the ledger's
  ``llm_tenant_chip_seconds_total`` follow the real tenant.
- The host KV tier's series (``llm_kv_host_cache_*_total``,
  ``llm_kv_upload_seconds``), and ``X-LLMK-Cache-Digests`` on every
  completion: the digest chain of the prompt's full pages (at most
  ``CACHE_DIGESTS_MAX``), what a returning prompt can adopt here.
- The disaggregated handoff (``EngineConfig.role``, the ``role`` label of
  ``llm_queue_depth``, ``llm_build_info`` and ``/debug/engine``), the JAX
  server's two-hop protocol with the routers: a streamed single-choice
  completion asked with ``X-LLMK-Handoff: ticket`` (and a host tier) runs
  a one-token prefill and answers a JSON ticket (page digests, tenant,
  the resolved seed); a request with ``X-LLMK-Handoff-Source`` pulls those
  pages from the source's ``POST /internal/kv/fetch`` into its host tier
  before admission (``LLMK_HANDOFF_PULL_TIMEOUT_S``, clamped to the
  deadline; a ``kv_pull`` span with its own ``traceparent``) and answers
  ``X-LLMK-Handoff-Adopted`` with the pages that landed. Any failure of
  the pull lands fewer pages, which re-prefill: never a client error. The
  pages travel as base64 raw bytes with shape, dtype and a truncated
  sha256 (``encode_kv_payload``, the JAX wire form: a bf16 page says
  "bfloat16"), written one page at a time. Faults: ``drop_handoff[:N]``
  (a pull skipped) and ``kill_prefill_replica[:DELAY]`` (a prefill
  replica dies: state "killed", /health and /ready 503, work refused).

Lifecycle: loading -> serving -> draining, with wedged (and killed)
overriding all. ``begin_drain`` (SIGTERM in ``cli.py``) turns /ready to
503, refuses new requests with 503 and lets in-flight work finish, at most
``EngineLoop.drain_timeout_s``.
"""

from __future__ import annotations

import base64
import binascii
import dataclasses
import hashlib
import http.client
import json
import logging
import os
import queue
import random
import signal
import socket
import struct
import sys
import threading
import time
import traceback
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from llms_on_kubernetes_tpu_torch import __version__, faults, kernels, resolve_device
from llms_on_kubernetes_tpu_torch.engine.engine import (
    Engine, EngineConfig, EngineStallError, QueueFullError, SamplingParams, UnknownAdapterError,
    model_config_for,
)
from llms_on_kubernetes_tpu_torch.engine.grammar import (
    GrammarError, compile_response_format, compile_tool_choice, token_bytes_of,
)
from llms_on_kubernetes_tpu_torch.engine.sampling import LOGPROB_TOPK
from llms_on_kubernetes_tpu_torch.engine.tokenizer import load_tokenizer
from llms_on_kubernetes_tpu_torch.engine.weights import resolve_model_dir
from llms_on_kubernetes_tpu_torch.server import tracing
from llms_on_kubernetes_tpu_torch.server.affinity import BloomFilter
from llms_on_kubernetes_tpu_torch.server.metrics import (
    Registry, build_info_metrics, engine_metrics, process_age_s,
)
from llms_on_kubernetes_tpu_torch.server.profiling import ProfileError, ProfileManager
from llms_on_kubernetes_tpu_torch.server.qos import (
    PRIORITIES, PRIORITY_HEADER, retry_after_s, tenant_of,
)
from llms_on_kubernetes_tpu_torch.server.runtime_telemetry import RuntimeTelemetry
from llms_on_kubernetes_tpu_torch.server.tools import (
    ToolStreamParser, inject_tool_messages, validate_tool_choice, validate_tools,
)

log = logging.getLogger(__name__)

MAX_CHOICES = 16
# the request body cap (the JAX server's aiohttp client_max_size)
MAX_BODY_BYTES = 32 * 1024 * 1024

# the router <-> replica headers (the JAX server/router.py constants): the
# deadline budget left, and the stream journal and resume protocol (a
# journaled token's text was delivered before its comment)
DEADLINE_HEADER = "X-LLMK-Deadline-Ms"
JOURNAL_HEADER = "X-LLMK-Journal"
RESUME_TOKENS_HEADER = "X-LLMK-Resume-Tokens"
RESUME_STREAM_ID_HEADER = "X-LLMK-Resume-Stream-Id"
RESUME_CREATED_HEADER = "X-LLMK-Resume-Created"
REQUEST_ID_HEADER = tracing.REQUEST_ID_HEADER
# the goodput ledger's per-request attribution: the device milliseconds the
# request's engine requests consumed (all phases, waste included); the
# phase split rides the body's usage.chip_ms
CHIP_MS_HEADER = "X-LLMK-Chip-Ms"
# the disaggregated two-hop protocol (the JAX server/router.py constants):
# the router asks a prefill replica for a ticket, then sends the original
# body to a decode replica with the ticket's source, digests, tenant and
# seed; the decode replica answers how many pages it adopted
HANDOFF_HEADER = "X-LLMK-Handoff"
HANDOFF_SOURCE_HEADER = "X-LLMK-Handoff-Source"
HANDOFF_DIGESTS_HEADER = "X-LLMK-Handoff-Digests"
HANDOFF_TENANT_HEADER = "X-LLMK-Handoff-Tenant"
HANDOFF_SEED_HEADER = "X-LLMK-Handoff-Seed"
HANDOFF_TICKET_HEADER = "X-LLMK-Handoff-Ticket"
HANDOFF_ADOPTED_HEADER = "X-LLMK-Handoff-Adopted"
# cache-aware routing: the digest chain of the prompt's full pages on
# every completion response, capped (~2 KiB of header)
CACHE_DIGESTS_HEADER = "X-LLMK-Cache-Digests"
CACHE_DIGESTS_MAX = 32
# a kv fetch names at most this many pages
KV_FETCH_MAX_DIGESTS = 4096


def _adapter_from_model(model) -> Optional[str]:
    """Multi-tenant naming (the JAX server's): ``model="base:adapter"``
    addresses a LoRA adapter of the served base model; a name without a
    colon is the base model. The adapter is everything after the FIRST
    colon (adapter names cannot hold one)."""
    if isinstance(model, str) and ":" in model:
        return model.split(":", 1)[1]
    return None


def chip_ms_total(reqs) -> dict:
    """Summed per-phase chip time across a request group (n > 1 / best_of
    serve one HTTP request with many engine requests)."""
    chip: dict = {}
    for r in reqs:
        for ph, v in r.chip_ms.items():
            chip[ph] = chip.get(ph, 0.0) + v
    return chip


class BadRequest(ValueError):
    pass


class BodyTooLarge(BadRequest):
    pass


def _wire_array(a: Optional[np.ndarray]) -> Optional[dict]:
    """One payload array on the wire: base64 raw bytes, shape, dtype and a
    truncated sha256. A ``BF16_VIEW`` (uint16) array is a bf16 page: its
    dtype is sent as JAX's ``str(a.dtype)`` gives it, "bfloat16"."""
    if a is None:
        return None
    a = np.ascontiguousarray(a)
    raw = a.tobytes()
    dtype = "bfloat16" if a.dtype == np.uint16 else str(a.dtype)
    return {"b64": base64.b64encode(raw).decode("ascii"), "shape": list(a.shape),
            "dtype": dtype, "sha": hashlib.sha256(raw).hexdigest()[:16]}


def encode_kv_payload(pl: dict) -> dict:
    """The wire form of one host-tier KV page for ``/internal/kv/fetch``
    (the JAX ``_encode_kv_payload``, byte for byte): a truncated or flipped
    transfer is caught at ingest and the page treated as missing."""
    return {k: _wire_array(pl.get(k)) for k in ("k", "v", "ks", "vs")}


def decode_kv_payload(doc) -> Optional[dict]:
    """The inverse of ``encode_kv_payload`` (reads the JAX server's too);
    None for anything malformed or failing its checksum (the page is then
    missing). "bfloat16" arrays come back as ``BF16_VIEW``; the shapes and
    dtypes are checked against the pools at ingest."""
    if not isinstance(doc, dict):
        return None

    def arr(enc):
        if enc is None:
            return None
        if not isinstance(enc, dict):
            raise ValueError("bad array encoding")
        raw = base64.b64decode(enc["b64"], validate=True)
        if hashlib.sha256(raw).hexdigest()[:16] != enc.get("sha"):
            raise ValueError("checksum mismatch")
        name = str(enc["dtype"])
        a = np.frombuffer(raw, dtype=np.uint16 if name == "bfloat16" else np.dtype(name))
        return a.reshape([int(s) for s in enc["shape"]]).copy()

    try:
        out = {k: arr(doc.get(k)) for k in ("k", "v", "ks", "vs")}
    except (KeyError, ValueError, TypeError, binascii.Error):
        return None
    if out["k"] is None or out["v"] is None:
        return None
    return out


def deadline_from(headers, body: dict) -> Optional[float]:
    """The request's absolute ``time.monotonic()`` deadline, or None (the
    JAX ``_deadline_from``): ``X-LLMK-Deadline-Ms`` (milliseconds of
    budget left) wins over the body's ``timeout`` (seconds); a malformed
    header means no deadline, not a 400."""
    raw = headers.get(DEADLINE_HEADER)
    if raw is not None:
        try:
            return time.monotonic() + float(raw) / 1000.0
        except ValueError:
            return None
    t = body.get("timeout")
    if isinstance(t, (int, float)) and not isinstance(t, bool) and t > 0:
        return time.monotonic() + float(t)
    return None


def keepalive_interval_s() -> float:
    """The SSE keepalive period: ``LLMK_SSE_KEEPALIVE_S`` (default 15;
    <= 0 disables), read per stream."""
    raw = os.environ.get("LLMK_SSE_KEEPALIVE_S", "")
    try:
        return float(raw) if raw else 15.0
    except ValueError:
        return 15.0


class IncrementalDetokenizer:
    """Text deltas from a growing token list, holding back a trailing
    replacement character (a UTF-8 sequence still incomplete) until its
    bytes arrive; the final push releases everything."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        self.ids: list[int] = []
        self.sent = 0

    def push(self, ids: list[int], final: bool = False) -> str:
        self.ids += ids
        text = self.tokenizer.decode(self.ids)
        if not final and text and text[-1] == "�":
            text = text[:-1]
        delta = text[self.sent:]
        self.sent += len(delta)
        return delta


class StopChecker:
    """Stop-STRING matching on the detokenized stream (the OpenAI ``stop``
    parameter; stop token ids stay in the engine). ``push`` returns (text
    safe to emit, hit): while streaming, the last max(len(stop)) - 1
    characters are held back, so a stop split across deltas is never
    partly emitted. The earliest match in the text wins, and a longer stop
    that started before a match and may still complete defers it."""

    def __init__(self, stops: list[str]):
        self.stops = [s for s in stops if s]
        self.holdback = max((len(s) for s in self.stops), default=1) - 1
        self.text = ""
        self.emitted = 0

    def push(self, delta: str, final: bool = False) -> tuple[str, bool]:
        self.text += delta
        best = -1
        for s in self.stops:
            idx = self.text.find(s, self.emitted)
            if idx != -1 and (best == -1 or idx < best):
                best = idx
        if best != -1 and not final:
            pend = self._pending_start_before(best)
            if pend is not None:
                cut = max(self.emitted, pend)
                out = self.text[self.emitted:cut]
                self.emitted = cut
                return out, False
        if best != -1:
            out = self.text[self.emitted:best]
            self.emitted = best
            return out, True
        cut = len(self.text) if final or not self.stops else max(
            self.emitted, len(self.text) - self.holdback)
        out = self.text[self.emitted:cut]
        self.emitted = cut
        return out, False

    def _pending_start_before(self, limit: int) -> Optional[int]:
        """The earliest position < ``limit`` where a stop matches a proper
        prefix that runs off the end of the text (it may still complete)."""
        n = len(self.text)
        earliest = None
        for s in self.stops:
            for i in range(max(self.emitted, n - len(s) + 1), min(limit, n)):
                if s.startswith(self.text[i:]):
                    if earliest is None or i < earliest:
                        earliest = i
                    break
        return earliest


def _parse_stops(body: dict) -> list[str]:
    stop = body.get("stop")
    if isinstance(stop, str):
        return [stop]
    if isinstance(stop, list):
        return [s for s in stop if isinstance(s, str)]
    return []


class _Choice:
    """One engine request's events turned into response text (the JAX
    server's ``_drain``): stop-token filtering, incremental detokenizing,
    stop strings and, with logprobs, the entries (token id, logprob entry,
    emitted piece) of the tokens whose text has been emitted."""

    def __init__(self, app: "OpenAIServer", req, stops: list[str]):
        self.app, self.req = app, req
        self.detok = IncrementalDetokenizer(app.tokenizer)
        self.stopper = StopChecker(stops)
        self.stop_ids = set(req.params.stop_token_ids)
        self.nlp = req.params.logprobs
        self.total = 0            # event tokens so far (the usage count)
        self.pending: list = []   # entries whose text the stopper holds back
        self.released_chars = 0
        self.done = False
        self.warm_hit = False
        prefix = list(req.params.prefix_tokens or ())
        if prefix:
            # a resumed stream: the prefix's text reached the client from
            # the replica that died. Warm the detokenizer and the stop
            # checker with it, so the continuation's deltas splice byte for
            # byte after it (emitted characters are a function of the ids)
            _text, self.warm_hit = self.stopper.push(self.detok.push(prefix))
            self.total = len(prefix)
            self.released_chars = self.stopper.emitted

    def feed(self, toks: list[int], done: bool, reason: Optional[str]) -> tuple:
        """One engine event -> (text delta, done, finish reason, released
        logprob entries)."""
        req = self.req
        if self.warm_hit:
            # the prefix itself completes a stop string: the stream was
            # ending anyway
            self.done = True
            return "", True, "stop", []
        start = self.total
        self.total += len(toks)
        raw = [(t, req.output_logprobs[start + i] if start + i < len(req.output_logprobs)
                else None)
               for i, t in enumerate(toks)
               if not (done and reason == "stop" and t in self.stop_ids)]
        if self.nlp == 0:
            text, hit = self.stopper.push(self.detok.push([t for t, _ in raw], final=done),
                                          final=done)
            released = []
        else:
            # per-token pieces are the detokenizer's own deltas; an entry is
            # released once the stopper has emitted its text
            parts = []
            for i, (t, lp) in enumerate(raw):
                piece = self.detok.push([t], final=done and i == len(raw) - 1)
                parts.append(piece)
                self.pending.append((t, lp, piece))
            if done and not raw:
                parts.append(self.detok.push([], final=True))
            text, hit = self.stopper.push("".join(parts), final=done)
            released = []
            while self.pending:
                piece = self.pending[0][2]
                if self.released_chars + len(piece) > self.stopper.emitted:
                    break
                released.append(self.pending.pop(0))
                self.released_chars += len(piece)
            if hit and self.pending and self.released_chars < self.stopper.emitted:
                # the cut lands inside this token: it shows, so its entry does
                released.append(self.pending.pop(0))
        if hit:
            self.app.loop.abort(req)
            done, reason = True, "stop"
        self.done = done
        return text, done, reason, released


class EngineLoop(threading.Thread):
    """Drives ``Engine.step`` while there is work; sleeps on an event
    otherwise. With async scheduling (the default) ``step`` blocks in the
    engine's harvest once ``async_depth`` windows are unread, and
    ``Engine.submit`` wakes that wait. A failed step sheds every request
    with reason "error" and the loop carries on. Between steps it runs the
    callables handed to ``call`` (prompt scoring) and feeds ``metrics``.

    ``stop()`` drains: the loop steps until no work is left, the engine is
    wedged or ``drain_timeout_s`` has passed, then ends.

    After each step it drains the goodput ledger's snapshot deltas into
    ``/metrics`` (the JAX loop's), folds the step's device/host split into
    the runtime telemetry, and, when the ledger's anomaly detector fired,
    starts one bounded profile capture on a thread of its own
    (``_trigger_auto_profile``)."""

    # under the JAX server's 60 s join, as there
    drain_timeout_s = 55.0

    def __init__(self, engine: Engine, metrics: Optional[dict] = None, model_name: str = "",
                 flight: Optional[tracing.FlightRecorder] = None,
                 telemetry: Optional[RuntimeTelemetry] = None, profiles=None):
        super().__init__(name="engine-loop", daemon=True)
        self.engine = engine
        self.metrics = metrics
        self.model_name = model_name
        self.flight = flight
        self.telemetry = telemetry
        self.profiles = profiles        # ProfileManager for the anomaly capture
        self.auto_profiles = 0
        self._led_phase_seen: dict = {}
        self._led_tenant_seen: dict = {}
        self._led_frame_seen = (0.0, 0.0)
        self._wake = threading.Event()
        self._stop_evt = threading.Event()
        self._calls: "queue.SimpleQueue" = queue.SimpleQueue()
        self._ttft_seen: set[str] = set()
        self._preempt_seen = 0
        self._tenant_admitted_seen: dict = {}
        self._host_kv_seen = {"hits": 0, "misses": 0, "evictions": 0}
        self._spec_seen = {"drafted": 0, "accepted": 0}
        self._early_exit_seen = 0
        self._adapter_seen = {"hits": 0, "misses": 0, "evictions": 0}

    def _mlabel(self, r) -> str:
        """The per-request model label: ``base:adapter`` for a LoRA
        request, so the latency series separate by tenant model."""
        return f"{self.model_name}:{r.adapter}" if r.adapter else self.model_name

    def submit(self, prompt, params, on_event, deadline: Optional[float] = None,
               request_id: Optional[str] = None, tenant: Optional[str] = None,
               priority: Optional[str] = None, handoff: bool = False,
               adapter: Optional[str] = None):
        req = self.engine.submit(prompt, params, request_id=request_id, on_event=on_event,
                                 deadline=deadline, tenant=tenant, priority=priority,
                                 handoff=handoff, adapter=adapter)
        if self.metrics:
            self.metrics["requests_total"].inc()
            self.metrics["prompt_tokens"].inc(len(req.prompt))
        self._wake.set()
        return req

    def abort(self, req, reason: str = "abort") -> None:
        self.engine.abort(req, reason)
        self._wake.set()

    def call(self, fn, *args):
        """Run ``fn(*args)`` on the loop's thread between two steps and
        return its value (or raise its exception)."""
        done = threading.Event()
        box: dict = {}
        self._calls.put((fn, args, done, box))
        self._wake.set()
        while not done.wait(1.0):
            if not self.is_alive():
                raise RuntimeError("the engine loop has stopped")
        if "error" in box:
            raise box["error"]
        return box["value"]

    def stop(self) -> None:
        self._stop_evt.set()
        self._wake.set()

    def _run_calls(self) -> None:
        while True:
            try:
                fn, args, done, box = self._calls.get_nowait()
            except queue.Empty:
                return
            try:
                box["value"] = fn(*args)
            except Exception as e:  # handed back to the caller's thread
                box["error"] = e
            done.set()

    def run(self) -> None:
        eng = self.engine
        drain_deadline = None
        while True:
            self._run_calls()
            if self._stop_evt.is_set():
                if drain_deadline is None:
                    drain_deadline = time.monotonic() + self.drain_timeout_s
                if (not eng.has_work() or eng.wedged
                        or time.monotonic() >= drain_deadline):
                    return
            elif not eng.has_work():
                self._wake.wait(0.05)
                self._wake.clear()
                continue
            dw0 = eng.device_wait_s()
            t0 = time.monotonic()
            try:
                events = eng.step()
            except Exception:  # boundary: keep serving, fail the in-flight work
                log.error("engine step failed:\n%s", traceback.format_exc())
                events = eng.shed("error")
            dt = time.monotonic() - t0
            # the harvester waits concurrently, so its delta can exceed the
            # step's own wall time: clamp
            self._observe(events, dt, max(0.0, min(eng.device_wait_s() - dw0, dt)))

    def _observe(self, events, dt: float, device_s: float = 0.0) -> None:
        """Feed the step's numbers to the metrics, the runtime telemetry
        and one frame to the flight recorder, drain the ledger, and answer
        an anomaly with one capture (the JAX EngineLoop's)."""
        m, eng = self.metrics, self.engine
        if self.telemetry is not None:
            self.telemetry.record_step_split(dt, device_s)
        led = eng.ledger
        led_snap = led.snapshot() if led is not None else None
        led_util = led.utilization() if led is not None else None
        if self.flight is not None:
            tokens = sum(len(ev.new_tokens) for ev in events)
            frame = dict(
                step_ms=round(dt * 1000.0, 3),
                device_ms=round(device_s * 1000.0, 3),
                host_ms=round((dt - device_s) * 1000.0, 3),
                occupancy=sum(r is not None for r in eng.slots),
                kv_pages_used=eng.config.num_pages - 1 - eng.allocator.num_free_pages,
                waiting=len(eng.waiting), tokens=tokens,
                tokens_per_s=round(tokens / dt, 1) if dt > 0 else 0.0,
                finished=sum(ev.finished for ev in events), preemptions=eng.preemptions,
                wedged=bool(eng.wedged))
            if led_snap is not None:
                attr, waste = led_snap["attributed_ms"], led_snap["wasted_ms"]
                pa, pw = self._led_frame_seen
                self._led_frame_seen = (attr, waste)
                frame.update(chip_attr_ms=round(attr - pa, 3),
                             chip_waste_ms=round(waste - pw, 3),
                             mfu=round(led_util[0], 5))
            self.flight.record(**frame)
        if m and led_snap is not None:
            series = dict(led_snap["phase_ms"])
            series["idle"] = led_snap["idle_ms"]
            for ph, ms in series.items():
                seen = self._led_phase_seen.get(ph, 0.0)
                if ms > seen:
                    m["chip_seconds"].labels(phase=ph).inc((ms - seen) / 1000.0)
                    self._led_phase_seen[ph] = ms
            for (tenant, ph), ms in led_snap["tenant_ms"].items():
                seen = self._led_tenant_seen.get((tenant, ph), 0.0)
                if ms > seen:
                    m["tenant_chip_seconds"].labels(tenant=tenant, phase=ph).inc(
                        (ms - seen) / 1000.0)
                    self._led_tenant_seen[(tenant, ph)] = ms
            m["mfu"].set(led_util[0])
            m["mbu"].set(led_util[1])
        if led is not None and led.take_anomaly():
            self._trigger_auto_profile()
        if not m:
            return
        m["decode_step"].labels(model=self.model_name).observe(dt)
        if eng.preemptions > self._preempt_seen:
            m["preemptions"].inc(eng.preemptions - self._preempt_seen)
            self._preempt_seen = eng.preemptions
        m["batch_occupancy"].set(sum(r is not None for r in eng.slots))
        m["kv_pages_used"].set(eng.config.num_pages - 1 - eng.allocator.num_free_pages)
        m["waiting"].set(len(eng.waiting))
        m["queue_depth"].labels(model=self.model_name, role=eng.config.role).set(
            len(eng.waiting))
        m["prefix_hit_tokens"].set(eng.allocator.hit_tokens_total)
        for key, v in list(eng.tenant_admitted.items()):
            seen = self._tenant_admitted_seen.get(key, 0)
            if v > seen:
                m["tenant_admitted"].labels(tenant=key[0], priority=key[1]).inc(v - seen)
                self._tenant_admitted_seen[key] = v
        while eng.tenant_wait_obs:
            tenant, wait, _prio = eng.tenant_wait_obs.popleft()
            m["tenant_queue_wait"].labels(tenant=tenant).observe(wait)
        if eng.host_kv is not None:
            for k in ("hits", "misses", "evictions"):
                v = getattr(eng.host_kv, k)
                if v > self._host_kv_seen[k]:
                    m["kv_host_cache_" + k].inc(v - self._host_kv_seen[k])
                    self._host_kv_seen[k] = v
        while eng.kv_upload_obs:
            m["kv_upload"].observe(eng.kv_upload_obs.popleft())
        # window depth and early exit, as the JAX loop feeds them
        while eng.steps_obs:
            m["decode_steps_per_dispatch"].observe(eng.steps_obs.popleft())
        if eng.early_exit_steps > self._early_exit_seen:
            m["decode_early_exit"].inc(eng.early_exit_steps - self._early_exit_seen)
            self._early_exit_seen = eng.early_exit_steps
        # speculation, by deltas of the engine's counters (the JAX loop's)
        drafted, accepted = eng.spec_drafted_tokens, eng.spec_accepted_tokens
        if drafted > self._spec_seen["drafted"]:
            m["spec_drafted"].inc(drafted - self._spec_seen["drafted"])
            self._spec_seen["drafted"] = drafted
        if accepted > self._spec_seen["accepted"]:
            m["spec_accepted"].inc(accepted - self._spec_seen["accepted"])
            self._spec_seen["accepted"] = accepted
        if drafted > 0:
            m["spec_accept_ratio"].set(accepted / drafted)
        adp = eng.adapters
        if adp is not None:
            for k, seen in self._adapter_seen.items():
                v = adp.stats[k]
                if v > seen:
                    m["adapter_cache_" + k].inc(v - seen)
                    self._adapter_seen[k] = v
            while adp.load_times:
                m["adapter_load"].observe(adp.load_times.pop(0))
        for ev in events:
            m["tokens_generated"].inc(len(ev.new_tokens))
            r = ev.request
            if ev.finished:
                m["requests_finished"].inc()
                m["e2e_latency"].labels(model=self._mlabel(r)).observe(
                    (r.finished_at or time.monotonic()) - r.submitted_at)
            if ev.finished and ev.finish_reason == "timeout":
                # queue: shed before it was ever seated; decode: aborted
                m["deadline_exceeded"].labels(
                    phase="queue" if r.admitted_at is None else "decode").inc()
            if r.first_token_at and r.id not in self._ttft_seen:
                self._ttft_seen.add(r.id)
                m["ttft"].labels(model=self._mlabel(r)).observe(
                    r.first_token_at - r.submitted_at)
            if ev.finished:
                self._ttft_seen.discard(r.id)

    def _trigger_auto_profile(self) -> None:
        """One bounded, rate-limited capture while the step-time anomaly is
        live (the detector's cooldown is the rate limit; a capture already
        running is skipped, not queued). The capture's thread hands the
        profiler's start and stop to this loop, between steps."""
        self.auto_profiles += 1
        if self.metrics:
            self.metrics["auto_profile"].labels(reason="step_anomaly").inc()
        if self.flight is not None:
            self.flight.record(marker="auto_profile", reason="step_anomaly")
        prof = self.profiles
        if prof is None:
            return
        duration_ms = float(os.environ.get("LLMK_ANOMALY_CAPTURE_MS", "2000"))

        def cap():
            try:
                prof.capture(duration_ms=duration_ms)
            except RuntimeError as e:      # busy, or the profiler failed
                log.warning("auto profile skipped: %s", e)
            except Exception:              # profiling must never stop serving
                log.warning("auto profile failed:\n%s", traceback.format_exc())

        threading.Thread(target=cap, daemon=True, name="auto-profile").start()


# the longest close() waits for a profile capture in progress to end (an
# anomaly capture lasts LLMK_ANOMALY_CAPTURE_MS, 2 s by default)
CLOSE_CAPTURE_WAIT_S = 30.0


class OpenAIServer:
    """The HTTP front end of one engine serving one model."""

    STATE_CODES = {"loading": 0, "serving": 1, "draining": 2, "wedged": 3, "killed": 4}

    def __init__(self, engine: Engine, tokenizer, model_name: str,
                 cold_start: Optional[dict] = None):
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.registry = Registry()
        self.metrics = engine_metrics(self.registry)
        build_info_metrics(self.registry,
                           backend="gpu" if engine.device.type == "cuda" else "cpu",
                           role=engine.config.role)
        self.metrics["kv_bytes_per_token"].set(engine.cache_config.bytes_per_token)
        for phase, seconds in (cold_start or {}).items():
            self.metrics["cold_start"].labels(phase=phase).observe(seconds)
        # recent completed traces (/debug/traces), the engine flight
        # recorder (/debug/engine), and the tail-sampled OTLP export
        # (dormant without LLMK_OTLP_ENDPOINT; a skipped trace is counted)
        self.traces = tracing.TraceStore(int(os.environ.get("LLMK_TRACE_RING", "256")))
        self.flight = tracing.FlightRecorder(int(os.environ.get("LLMK_FLIGHT_STEPS", "512")))
        self.tail_sampler = tracing.TailSampler()
        self.exporter = tracing.exporter_from_env(
            "llmk-engine", self.metrics["trace_spans_exported"], self.metrics["trace_dropped"])
        # runtime telemetry (device memory, compile events, step split) and
        # the bounded profile captures (/debug/profile, the anomaly capture)
        self.telemetry = RuntimeTelemetry(self.registry, engine.device,
                                          live_bytes=self._engine_bytes)
        self.loop = EngineLoop(engine, self.metrics, model_name, flight=self.flight,
                               telemetry=self.telemetry)
        self.profiles = ProfileManager(device=engine.device.type, runner=self.loop.call)
        self.loop.profiles = self.profiles
        # the tokenizer's id -> bytes map for grammars, derived at first use
        self._token_bytes = None
        self._token_bytes_lock = threading.Lock()
        # the degraded_replica gray failure: > 1 stretches this replica's
        # event pacing while its probes stay green
        self._degraded_factor = 1.0
        self.httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # loading -> serving -> draining; "wedged" (the engine watchdog)
        # overrides all: /health fails only then, /ready passes only serving
        self._state = "loading"
        # in-flight completion handlers: a drained process waits for their
        # last writes before it stops serving
        self._active = 0
        self._active_lock = threading.Lock()
        # the /ready bloom filter over the prefix cache's digests, rebuilt
        # at most every LLMK_PREFIX_FILTER_INTERVAL_S (the JAX knobs)
        self._pf_doc: Optional[dict] = None
        self._pf_built = 0.0
        self._pf_bits = int(os.environ.get("LLMK_PREFIX_FILTER_BITS", "8192"))
        self._pf_hashes = int(os.environ.get("LLMK_PREFIX_FILTER_HASHES", "4"))
        self._pf_interval = float(os.environ.get("LLMK_PREFIX_FILTER_INTERVAL_S", "2.0"))

    def _engine_bytes(self) -> float:
        """The engine's own tensors' bytes (weights, pools, penalty
        counts): the live-bytes figure on the CPU, which has no allocator
        statistics."""
        eng = self.engine
        seen: set = set()
        total = 0

        def add(x):
            nonlocal total
            if isinstance(x, torch.Tensor):
                if x.data_ptr() not in seen:
                    seen.add(x.data_ptr())
                    total += x.numel() * x.element_size()
            elif isinstance(x, dict):
                for v in x.values():
                    add(v)
            elif isinstance(x, (list, tuple)):
                for v in x:
                    add(v)
            elif hasattr(x, "data") and hasattr(x, "scale"):     # a QTensor or GroupQTensor
                add((x.data, x.scale, getattr(x, "zero_scaled", None)))
            elif hasattr(x, "a") and hasattr(x, "b"):             # a LoRAStack
                add((x.a, x.b))

        add(eng.params)
        add((eng.k_pages, eng.v_pages, eng.token_counts))
        return float(total)

    # -- lifecycle ---------------------------------------------------------

    @property
    def state(self) -> str:
        return "wedged" if self.engine.wedged else self._state

    def bind(self, host: str = "0.0.0.0", port: int = 8080) -> ThreadingHTTPServer:
        server = self

        class Handler(_Handler):
            app = server

        self.httpd = _HTTPServer((host, port), Handler)
        return self.httpd

    def _start_serving(self) -> None:
        """Start the engine loop and turn "serving". Under the
        ``slow_cold_start`` fault the replica stays "loading" (/ready 503,
        HTTP already answering) that many seconds first."""
        delay = faults.get_float("slow_cold_start", 2.0)
        if delay is not None and delay > 0:
            t = threading.Timer(delay, self._go_serving)
            t.daemon = True
            t.start()
        else:
            self._go_serving()

    def _go_serving(self) -> None:
        self.loop.start()
        self._state = "serving"
        self.metrics["cold_start"].labels(phase="ready").observe(process_age_s())
        # preempt_replica: a spot preemption notice lands DELAY seconds
        # from now and begins the drain; one-shot across the process
        notice = faults.get_float("preempt_replica", 1.0)
        if notice is not None and faults.claim("preempt_replica"):
            t = threading.Timer(max(notice, 0.0), self.begin_drain)
            t.daemon = True
            t.start()
        # kill_prefill_replica: a prefill-role replica dies abruptly DELAY
        # seconds from now; one-shot, armed on prefill-role servers only
        crash = faults.get_float("kill_prefill_replica", 1.0)
        if (crash is not None and self.engine.config.role == "prefill"
                and faults.claim("kill_prefill_replica")):
            t = threading.Timer(max(crash, 0.0), self.kill_abrupt)
            t.daemon = True
            t.start()
        self.maybe_claim_degraded()

    def kill_abrupt(self) -> None:
        """The ``kill_prefill_replica`` crash: no grace, unlike
        ``begin_drain``. Every engine request is aborted, the state turns
        "killed" (/health and /ready 503, every request refused, a kv
        fetch too) and the engine loop stops. Idempotent."""
        if self._state == "killed":
            return
        self._state = "killed"
        self.metrics["engine_state"].set(self.STATE_CODES["killed"])
        try:
            for r in list(self.engine.waiting) + list(self.engine.slots):
                if r is not None:
                    self.loop.abort(r, "kill_prefill_replica")
        except Exception:  # a fault hook must never take the process down itself
            log.warning("kill_prefill_replica abort failed:\n%s", traceback.format_exc())
        self.loop.stop()

    def maybe_claim_degraded(self) -> None:
        """Arm ``degraded_replica`` on this replica if the fault is active
        and still unclaimed; checked at startup and at every stream, so a
        fault set later still finds one victim."""
        if self._degraded_factor > 1.0:
            return
        factor = faults.get_float("degraded_replica", 8.0)
        if factor is not None and factor > 1.0 and faults.claim("degraded_replica"):
            self._degraded_factor = float(factor)

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Serve on a background thread (tests); returns the bound port."""
        httpd = self.bind(host, port)
        self._start_serving()
        self._thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        self._thread.start()
        return httpd.server_address[1]

    def serve_forever(self, host: str, port: int) -> None:
        httpd = self.bind(host, port)
        self._start_serving()
        try:
            httpd.serve_forever()
        finally:
            self.close()

    def begin_drain(self) -> bool:
        """Refuse new requests (503) and turn /ready to 503 so routers eject
        this replica, while the engine loop finishes the work in flight
        (at most ``EngineLoop.drain_timeout_s``). Callable from any thread
        or a signal handler; returns False when already draining."""
        if self._state in ("draining", "killed"):
            return False
        self._state = "draining"
        self.metrics["engine_state"].set(self.STATE_CODES["draining"])
        self.loop.stop()
        return True

    def shutdown_when_drained(self) -> threading.Thread:
        """After ``begin_drain``: wait for the engine loop to end and the
        handlers in flight to write their last bytes, then stop serving, so
        ``serve_forever`` returns."""
        def finish():
            self.loop.join(self.loop.drain_timeout_s + 5.0)
            deadline = time.monotonic() + 10.0
            while self._active and time.monotonic() < deadline:
                time.sleep(0.05)
            if self.httpd is not None:
                self.httpd.shutdown()

        t = threading.Thread(target=finish, name="drain", daemon=True)
        t.start()
        return t

    def close(self) -> None:
        if self.httpd is not None:
            if self._thread is not None:
                self.httpd.shutdown()
                self._thread.join(timeout=10)
            self.httpd.server_close()
            self.httpd = None
        # a capture in progress (one asked for, or the anomaly detector's)
        # stops the profiler through the engine loop: let it end first, else
        # the stop runs off the engine thread, leaks the thread's profiler
        # callbacks and the process can crash at exit. A manual session is
        # stopped here, through the loop, while it still runs
        if self.profiles.manual:
            try:
                self.profiles.stop_session()
            except RuntimeError:
                log.warning("manual profile session failed to stop:\n%s",
                            traceback.format_exc())
        deadline = time.monotonic() + CLOSE_CAPTURE_WAIT_S
        while self.profiles.busy and time.monotonic() < deadline:
            time.sleep(0.01)
        self.loop.stop()
        if self.loop.is_alive():
            self.loop.join(timeout=10)
        if self.exporter is not None:
            self.exporter.close()

    def resp_model(self, reqs) -> str:
        """A response's ``model`` field: ``base:adapter`` for a LoRA
        request (every choice of one HTTP request shares its adapter)."""
        a = reqs[0].adapter if reqs else None
        return f"{self.model_name}:{a}" if a else self.model_name

    def prefix_filter_doc(self) -> Optional[dict]:
        """The serialized bloom filter of the prefix cache's page digests
        for the /ready body, rebuilt at most every ``_pf_interval`` s; None
        when LLMK_PREFIX_FILTER_BITS is 0."""
        if self._pf_bits <= 0:
            return None
        now = time.monotonic()
        if self._pf_doc is not None and now - self._pf_built < self._pf_interval:
            return self._pf_doc
        f = BloomFilter(self._pf_bits, self._pf_hashes)
        for d in self.engine.prefix_filter_digests():
            f.add(d)
        self._pf_doc = f.serialize()
        self._pf_built = now
        return self._pf_doc

    def cache_digest_header(self, reqs) -> Optional[str]:
        """``X-LLMK-Cache-Digests``: the digest chain of the first request's
        prompt (n > 1 shares one prompt), its full pages but the last when
        the prompt ends on a boundary (the handoff ticket's chain), hex,
        comma-joined, at most ``CACHE_DIGESTS_MAX``."""
        if not reqs:
            return None
        prompt = reqs[0].prompt
        n_pages = max(0, (len(prompt) - 1) // self.engine.allocator.page_size)
        if n_pages <= 0:
            return None
        digests = self.engine.handoff_digests(
            prompt[:n_pages * self.engine.allocator.page_size], salt=reqs[0].cache_salt)
        return ",".join(d.hex() for d in digests[:CACHE_DIGESTS_MAX]) or None

    def handoff_pull(self, headers, deadline: Optional[float], trace=None) -> int:
        """The decode half of a handoff (the JAX ``_handoff_pull``): pull the
        pages the router's digest header names from the prefill replica's
        ``/internal/kv/fetch`` into this host tier, on the request's thread
        (decoding, checksums and ingest never touch the engine thread), and
        return how many landed. Every failure (the ``drop_handoff`` fault,
        the network, a refusal, a corrupt page, a gap in the chain) lands
        fewer and never raises: those pages re-prefill."""
        src = headers.get(HANDOFF_SOURCE_HEADER, "").strip().rstrip("/")
        try:
            digests = [bytes.fromhex(x.strip())
                       for x in headers.get(HANDOFF_DIGESTS_HEADER, "").split(",") if x.strip()]
        except ValueError:
            digests = []
        if not src or not digests:
            return 0
        if faults.claim_n("drop_handoff"):
            return 0            # injected: every handed-off page "missing"
        if self.engine.host_kv is None:
            return 0
        budget = float(os.environ.get("LLMK_HANDOFF_PULL_TIMEOUT_S", "10"))
        if deadline is not None:
            budget = max(0.05, min(budget, deadline - time.monotonic()))
        tenant = headers.get(HANDOFF_TENANT_HEADER, "")
        # the pull is a hop of its own: a fresh traceparent (and the request
        # id) so the source's fetch fragment stitches under it
        hop = {"Content-Type": "application/json"}
        pull_sid = ""
        if trace is not None:
            hop[REQUEST_ID_HEADER] = trace.request_id
            pull_sid = tracing.new_span_id()
            hop[tracing.TRACEPARENT_HEADER] = tracing.format_traceparent(
                trace.trace_id, pull_sid, trace.sampled)
        t0 = time.monotonic()
        try:
            url = urllib.parse.urlsplit(src)
            if url.scheme != "http" or not url.hostname:
                return 0
            conn = http.client.HTTPConnection(url.hostname, url.port or 80, timeout=budget)
            try:
                conn.request("POST", "/internal/kv/fetch", body=json.dumps(
                    {"tenant": tenant, "digests": [d.hex() for d in digests]}), headers=hop)
                resp = conn.getresponse()
                if resp.status != 200:
                    return 0
                raw = resp.read()
            finally:
                conn.close()
            if time.monotonic() - t0 > budget:
                return 0
            doc = json.loads(raw)
        except (OSError, http.client.HTTPException, ValueError):
            return 0
        if trace is not None:
            trace.add_span("kv_pull", t0, time.monotonic(), span_id=pull_sid,
                           parent_span_id=trace.span_id, source=src, bytes=len(raw))
        encs = doc.get("payloads") if isinstance(doc, dict) else None
        if not isinstance(encs, list):
            return 0
        landed = 0
        for digest, enc in zip(digests, encs):
            pl = decode_kv_payload(enc) if enc is not None else None
            if pl is None or not self.engine.host_kv_ingest(tenant, digest, pl):
                break           # a gap: the pages after it are unreachable
            landed += 1
        return landed

    # -- tracing -----------------------------------------------------------

    def finalize_trace(self, trace: tracing.Trace, status: str, http_status) -> None:
        """The request's span timeline from its engine requests' stamps
        (admission, queue, prefill, decode, stream; the JAX
        ``_finalize_trace``), into the ring, one access-log line, the slow
        dump and the tail-sampled export. Never raises."""
        try:
            now = time.monotonic()
            many = len(trace.engine_reqs) > 1

            def eng_span(name, start, end, **meta):
                trace.add_span(name, start, end, span_id=tracing.new_span_id(),
                               parent_span_id=trace.span_id, **meta)

            for i, req in enumerate(trace.engine_reqs):
                meta = {"choice": i} if many else {}
                adm, ft = req.admitted_at, req.first_token_at
                fin = now if req.finished_at is None else min(req.finished_at, now)
                eng_span("admission", trace.t0, req.submitted_at, **meta)
                eng_span("queue", req.submitted_at, adm if adm is not None else fin, **meta)
                if adm is not None:
                    pre_kw = dict(meta)
                    if req.chip_ms:
                        # the ledger's device time inside the wall span
                        pre_kw["chip_ms"] = round(req.chip_ms.get("prefill", 0.0), 3)
                    eng_span("prefill", adm, ft if ft is not None else fin, **pre_kw)
                if ft is not None:
                    dec_kw = dict(meta, tokens=len(req.output))
                    if req.chip_ms:
                        dec_kw["chip_ms"] = round(req.chip_ms.get("decode", 0.0), 3)
                        waste = (req.chip_ms.get("spec_waste", 0.0)
                                 + req.chip_ms.get("early_exit", 0.0))
                        if waste:
                            dec_kw["chip_waste_ms"] = round(waste, 3)
                    eng_span("decode", ft, fin, **dec_kw)
                if fin < now:
                    eng_span("stream", fin, now, **meta)
            trace.finish(status)
            self.traces.add(trace)
            tracing.jlog("request", request_id=trace.request_id, component="api",
                         model=trace.model, status=status, http_status=http_status,
                         e2e_ms=round(trace.e2e_ms() or 0.0, 3),
                         tokens=sum(len(r.output) for r in trace.engine_reqs))
            tracing.maybe_log_slow(trace, "api")
            d = trace.to_dict()
            if self.exporter is None:
                self.metrics["trace_dropped"].labels(reason="disabled").inc()
                return
            st = d.get("status") or ""
            keep, reason = self.tail_sampler.decide(
                st == "error" or st.startswith("http_5"), d.get("e2e_ms"),
                tracing.is_multi_hop(d))
            if not keep:
                self.metrics["trace_dropped"].labels(reason=reason).inc()
                return
            self.exporter.export(d)
        except Exception:  # observability must not fail serving
            log.debug("trace finalize failed:\n%s", traceback.format_exc())

    # -- request parsing ---------------------------------------------------

    def sampling_from_body(self, body: dict, chat: bool) -> SamplingParams:
        if not chat and body.get("suffix"):
            raise BadRequest("suffix (fill-in-middle) is not supported by this model server")
        seed = body.get("seed")
        if seed is not None:
            if not isinstance(seed, int) or isinstance(seed, bool):
                raise BadRequest("seed must be an integer")
            seed &= 0x7FFFFFFF
        max_tokens = body.get("max_tokens") or body.get("max_completion_tokens") or 256
        try:
            # completions take an int (top-N a token); chat a bool plus
            # top_logprobs; at most LOGPROB_TOPK either way
            if chat:
                want = bool(body.get("logprobs", False))
                nlp = int(body.get("top_logprobs", 0) or 0) if want else 0
                if want and nlp == 0:
                    nlp = 1         # logprobs: true alone still gives the chosen
            else:
                raw = body.get("logprobs")
                if raw is not None and (not isinstance(raw, int) or isinstance(raw, bool)):
                    raise BadRequest("logprobs must be an integer")
                if raw is not None and raw < 0:
                    raise BadRequest("logprobs must be non-negative")
                nlp = int(raw or 0)
                if raw is not None:
                    nlp = max(nlp, 1)   # logprobs: 0 still gives token_logprobs
            if nlp < 0:
                raise BadRequest("logprobs/top_logprobs must be non-negative")
            if nlp > LOGPROB_TOPK:
                raise BadRequest(f"logprobs/top_logprobs supports at most {LOGPROB_TOPK} "
                                 f"alternatives, got {nlp}")
            bias: list = []
            lb = body.get("logit_bias")
            if lb is not None:
                if not isinstance(lb, dict):
                    raise BadRequest("logit_bias must be an object mapping token ids to "
                                     "bias values")
                for k, v in lb.items():
                    try:
                        tid = int(k)
                    except (TypeError, ValueError):
                        raise BadRequest(f"logit_bias key {k!r} is not a token id")
                    if not isinstance(v, (int, float)) or isinstance(v, bool):
                        raise BadRequest(f"logit_bias value for {k} must be a number")
                    if not -100.0 <= float(v) <= 100.0:
                        raise BadRequest("logit_bias values must be in [-100, 100]")
                    bias.append((tid, float(v)))
            return SamplingParams(
                temperature=float(body.get("temperature", 1.0)),
                top_p=float(body.get("top_p", 1.0)),
                top_k=int(body.get("top_k", 0)),
                max_tokens=int(max_tokens),
                stop_token_ids=tuple(sorted(self.tokenizer.eos_ids)),
                seed=seed,
                presence_penalty=float(body.get("presence_penalty", 0.0)),
                frequency_penalty=float(body.get("frequency_penalty", 0.0)),
                logprobs=nlp,
                logit_bias=tuple(bias),
            )
        except BadRequest:
            raise
        except (TypeError, ValueError) as e:
            raise BadRequest(f"bad sampling parameter: {e}")

    def chat_prompt(self, body: dict) -> tuple[list[int], bool, Optional[tuple]]:
        """A chat request's prompt, as the JAX server builds it: ``tools``
        and ``tool_choice`` validated, the tool instruction injected into
        the last user message for a "required" or named choice, the tools
        rendered by the chat template. Returns (prompt ids, whether tool
        calls are parsed from the output, the tool grammar (tools, forced
        name or None) for a "required" or named choice, else None)."""
        messages = body.get("messages")
        if not isinstance(messages, list) or not messages:
            raise BadRequest("messages must be a non-empty list")
        if any(not isinstance(m, dict) or not isinstance(m.get("content", ""), (str, type(None)))
               for m in messages):
            raise BadRequest("each message must be an object with string content")
        tools = body.get("tools")
        try:
            if tools is not None:
                tools = validate_tools(tools)
            tool_mode = validate_tool_choice(body.get("tool_choice"), tools)
        except ValueError as e:
            raise BadRequest(str(e))
        if tool_mode is not None:
            messages = inject_tool_messages(messages, tool_mode)
        try:
            # tools go to the template only when active
            if tool_mode is not None and tools:
                ids = self.tokenizer.apply_chat_template(messages, tools=tools)
            else:
                ids = self.tokenizer.apply_chat_template(messages)
        except Exception as e:  # bad roles or content: the client's input
            raise BadRequest(f"bad messages: {e}")
        # a "required" or named choice is grammar-guaranteed; "auto" is
        # parsed only. A named function is told by the body's shape, so a
        # tool literally called "required" is not taken for the mode
        tool_grammar = None
        named = isinstance(body.get("tool_choice"), dict)
        if tool_mode is not None and (named or tool_mode == "required"):
            tool_grammar = (tools, tool_mode if named else None)
        return list(ids), tool_mode is not None, tool_grammar

    def grammar_for_request(self, body: dict, tool_grammar):
        """The request's decoding constraint (an engine/grammar
        CompiledGrammar), or None: the JAX ``_grammar_for_request``. CPU
        work (about a second for generic JSON at a 128K vocabulary, cached
        per grammar and vocabulary after that), run on the request's own
        thread. ``tool_grammar`` (tools, forced name or None) excludes a
        JSON response_format. Raises GrammarError (400)."""
        rf = body.get("response_format")
        rf_active = isinstance(rf, dict) and rf.get("type") not in (None, "text")
        if tool_grammar is not None and rf_active:
            raise GrammarError(
                "response_format json_object/json_schema cannot be combined "
                "with a forced tool_choice — the constrained token stream "
                "can only satisfy one")
        if tool_grammar is None and rf is None:
            return None
        with self._token_bytes_lock:
            if self._token_bytes is None:
                self._token_bytes = token_bytes_of(self.tokenizer)
        eos = sorted(self.tokenizer.eos_ids)
        if tool_grammar is not None:
            tools, force = tool_grammar
            return compile_tool_choice(tools, force, self._token_bytes, eos)
        return compile_response_format(rf, self._token_bytes, eos)

    def prompts_from_body(self, body: dict, chat: bool) -> list[list[int]]:
        """The request's prompts: chat messages through the chat template
        (``chat_prompt``); a completions prompt as a string, token ids, or a
        list of either (one choice group each)."""
        if chat:
            return [self.chat_prompt(body)[0]]
        prompt = body.get("prompt", "")

        def is_ids(p):
            return isinstance(p, list) and all(
                isinstance(t, int) and not isinstance(t, bool) for t in p)

        if isinstance(prompt, str):
            prompts = [self.tokenizer.encode(prompt)]
        elif is_ids(prompt) and prompt:
            prompts = [list(prompt)]
        elif isinstance(prompt, list):
            prompts = []
            for p in prompt:
                if isinstance(p, str):
                    prompts.append(self.tokenizer.encode(p))
                elif is_ids(p):
                    prompts.append(list(p))
                else:
                    raise BadRequest("prompt list items must be strings or token-id lists")
        else:
            raise BadRequest("prompt must be a string or a list")
        if not prompts or any(not p for p in prompts):
            raise BadRequest("empty prompt")
        return prompts

    # -- response shaping --------------------------------------------------

    def _tok_str(self, tid: int) -> str:
        return self.tokenizer.decode([tid])

    def chat_logprobs(self, entries, nlp: int) -> dict:
        content = []
        for _tid, lp, piece in entries:
            if lp is None:
                continue
            chosen, top_ids, top_lps = lp
            content.append({
                "token": piece, "logprob": chosen, "bytes": list(piece.encode("utf-8")),
                "top_logprobs": [
                    {"token": self._tok_str(i), "logprob": v,
                     "bytes": list(self._tok_str(i).encode("utf-8"))}
                    for i, v in zip(top_ids[:nlp], top_lps[:nlp])],
            })
        return {"content": content}

    def completion_logprobs(self, entries, nlp: int, base_offset: int) -> dict:
        """Token strings and offsets from each token's emitted piece, so
        text[text_offset[i]:][:len(tokens[i])] == tokens[i]."""
        tokens, token_logprobs, top_logprobs, text_offset = [], [], [], []
        offset = base_offset
        for _tid, lp, piece in entries:
            if lp is None:
                offset += len(piece)
                continue
            chosen, top_ids, top_lps = lp
            tokens.append(piece)
            token_logprobs.append(chosen)
            top_logprobs.append({self._tok_str(i): v
                                 for i, v in zip(top_ids[:nlp], top_lps[:nlp])})
            text_offset.append(offset)
            offset += len(piece)
        return {"tokens": tokens, "token_logprobs": token_logprobs,
                "top_logprobs": top_logprobs, "text_offset": text_offset}

    def prompt_logprob_block(self, prompt_ids, score, nlp: int) -> dict:
        """The ``echo`` block: entry i scores prompt token i (null for the
        first: nothing conditions it)."""
        lps, top_ids, top_lps = score
        detok = IncrementalDetokenizer(self.tokenizer)
        tokens, token_logprobs, top_logprobs, text_offset = [], [], [], []
        offset = 0
        for i, tid in enumerate(prompt_ids):
            piece = detok.push([tid], final=i == len(prompt_ids) - 1)
            tokens.append(piece)
            if i == 0:
                token_logprobs.append(None)
                top_logprobs.append(None)
            else:
                token_logprobs.append(float(lps[i - 1]))
                top_logprobs.append({self._tok_str(t): float(v) for t, v in
                                     zip(top_ids[i - 1][:nlp], top_lps[i - 1][:nlp])})
            text_offset.append(offset)
            offset += len(piece)
        return {"tokens": tokens, "token_logprobs": token_logprobs,
                "top_logprobs": top_logprobs, "text_offset": text_offset}


class _HTTPServer(ThreadingHTTPServer):
    # a replica takes bursts of connections from routers and clients: the
    # socketserver default backlog of 5 resets some of them (aiohttp's, the
    # JAX server's, is 128)
    request_queue_size = 128
    daemon_threads = True

    def handle_error(self, request, client_address):
        # a client that hung up (a router's probe timing out, a stream
        # closed early) is not the server's error: no traceback for it
        if isinstance(sys.exc_info()[1], (BrokenPipeError, ConnectionResetError)):
            return
        super().handle_error(request, client_address)


class _Handler(BaseHTTPRequestHandler):
    app: OpenAIServer
    server_version = "llms-on-kubernetes-tpu-torch"
    request_id: Optional[str] = None
    status_code: Optional[int] = None

    def log_message(self, fmt, *args):  # keep request logs off stderr
        log.debug("%s " + fmt, self.address_string(), *args)

    # -- plumbing ----------------------------------------------------------

    def _begin(self) -> None:
        """Reconcile the correlation headers (the JAX request-id
        middleware): a valid ``traceparent`` is adopted, and a safe
        ``X-LLMK-Request-Id``; otherwise an id is minted. Every response to
        this request echoes the id (``end_headers``)."""
        self.trace_ctx = tracing.reconcile(self.headers.get(tracing.TRACEPARENT_HEADER),
                                           self.headers.get(tracing.TRACESTATE_HEADER),
                                           self.headers.get(REQUEST_ID_HEADER))
        self.request_id = self.trace_ctx["request_id"] or tracing.new_request_id()
        self.status_code = None

    def send_response(self, code, message=None):
        self.status_code = code
        super().send_response(code, message)

    def end_headers(self):
        if self.request_id:
            self.send_header(REQUEST_ID_HEADER, self.request_id)
        super().end_headers()

    def _send(self, status: int, body: bytes, ctype: str, headers: Optional[dict] = None
              ) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _json(self, status: int, obj, headers: Optional[dict] = None) -> None:
        self._send(status, json.dumps(obj).encode(), "application/json", headers)

    def _error(self, status: int, message: str, kind: str = "invalid_request_error",
               code: Optional[str] = None, headers: Optional[dict] = None) -> None:
        err = {"message": message, "type": kind}
        if code is not None:
            err["code"] = code
        self._json(status, {"error": err}, headers)

    def _bad_request(self, e: BadRequest) -> None:
        if isinstance(e, BodyTooLarge):
            self._error(413, str(e), "invalid_request_error", "request_too_large")
        else:
            self._error(400, str(e))

    def _body_length(self) -> int:
        """The declared body length; over ``MAX_BODY_BYTES`` the request is
        refused before a byte of the body is read (and the connection
        closes after the answer)."""
        try:
            n = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            raise BadRequest("malformed Content-Length")
        if n > MAX_BODY_BYTES:
            self.close_connection = True
            raise BodyTooLarge(f"request body of {n} bytes exceeds the {MAX_BODY_BYTES}-byte "
                               f"limit")
        return max(n, 0)

    def _read_json(self) -> dict:
        n = self._body_length()
        raw = self.rfile.read(n) if n > 0 else b""
        try:
            body = json.loads(raw or b"{}")
        except (json.JSONDecodeError, UnicodeDecodeError):
            raise BadRequest("invalid JSON")
        if not isinstance(body, dict):
            raise BadRequest("the request body must be a JSON object")
        return body

    def _reset_connection(self) -> None:
        """Sever the client's socket with a TCP reset (SO_LINGER 0, then
        close): a replica dying mid-stream, as the router sees it."""
        self.close_connection = True
        try:
            self.connection.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                       struct.pack("ii", 1, 0))
            self.rfile.close()          # the socket closes with its last file
            self.connection.close()
        except OSError:
            pass

    # -- routes ------------------------------------------------------------

    def do_GET(self):
        self._begin()
        app = self.app
        path, _, query = self.path.partition("?")
        args = urllib.parse.parse_qs(query)

        def arg_int(key: str, default: int) -> int:
            try:
                return int(args.get(key, [default])[0])
            except (TypeError, ValueError):
                return default

        if path == "/health":
            if app.state in ("wedged", "killed"):
                self._error(503, f"engine {app.state}", "service_unavailable")
            else:
                self._send(200, b"OK", "text/plain; charset=utf-8")
        elif path == "/ready":
            state = app.state
            flap = faults.get_float("flappy_replica", 1.0)
            if flap and state == "serving" and int(time.monotonic() / flap) % 2:
                # injected fault: readiness flaps while the engine serves
                state = "draining"
            app.metrics["engine_state"].set(app.STATE_CODES[state])
            if state == "serving":
                doc = {"state": state}
                pf = app.prefix_filter_doc()
                if pf is not None:
                    doc["prefix_filter"] = pf
                self._json(200, doc)
            else:
                self._json(503, {"state": state, "error": {
                    "message": f"not ready: {state}", "type": "service_unavailable"}})
        elif path == "/metrics":
            app.metrics["engine_state"].set(app.STATE_CODES[app.state])
            app.telemetry.refresh()
            self._send(200, app.registry.render().encode(), "text/plain; charset=utf-8")
        elif path == "/version":
            self._json(200, {"version": __version__})
        elif path == "/v1/models":
            # each served LoRA adapter is addressable as its own model id
            ids = [app.model_name]
            if app.engine.adapters is not None:
                ids += [f"{app.model_name}:{a}" for a in app.engine.adapters.names()]
            created = int(time.time())
            self._json(200, {"object": "list", "data": [{
                "id": mid, "object": "model", "created": created,
                "owned_by": "llms-on-kubernetes-tpu-torch"} for mid in ids]})
        elif path == "/debug/traces":
            # newest first; span times in ms from the request's arrival
            self._json(200, {"traces": app.traces.snapshot(
                request_id=args.get("id", [None])[0], model=args.get("model", [None])[0],
                limit=arg_int("limit", 50))})
        elif path == "/debug/engine":
            snap = app.flight.snapshot(limit=arg_int("limit", 0) or None)
            snap.update(state=app.state, model=app.model_name, role=app.engine.config.role)
            self._json(200, snap)
        elif path == "/debug/profile":
            self._json(200, {"dir": app.profiles.base_dir, "busy": app.profiles.busy,
                             "captures": app.profiles.list_captures()})
        elif path.startswith("/debug/profile/"):
            cap_id = path[len("/debug/profile/"):]
            data = app.profiles.open_archive(cap_id)
            if data is None:
                self._json(404, {"error": {"message": f"no such capture: {cap_id}"}})
            else:
                self._send(200, data, "application/gzip",
                           {"Content-Disposition": f'attachment; filename="{cap_id}.tar.gz"'})
        elif path == "/debug/kernels":
            eng = app.engine
            self._json(200, {"launches": kernels.launch_counts(),
                             "replayed_launches": kernels.replayed_counts(),
                             "device": str(eng.device),
                             "num_layers": eng.model_config.num_layers,
                             "prefill_calls": eng.prefill_calls,
                             "chunk_calls": eng.chunk_calls,
                             "decode_forwards": eng.decode_forwards,
                             "decode_steps": eng.config.decode_steps,
                             "graph_replays": eng.graph_replays,
                             "fsm_graph_replays": eng.fsm_graph_replays,
                             "verify_replays": eng.verify_replays,
                             "spec_dispatches": eng.spec_dispatches,
                             "preemptions": eng.preemptions,
                             "prefix_hit_tokens": eng.allocator.hit_tokens_total,
                             "num_pages": eng.config.num_pages,
                             "free_pages": eng.allocator.num_free_pages,
                             "evictable_pages": eng.allocator.num_evictable_pages})
        else:
            self._error(404, f"no route {self.path}", "not_found")

    def do_POST(self):
        self._begin()
        if self.path == "/debug/kernels/reset":
            kernels.reset_launches()
            self._json(200, {"launches": kernels.launch_counts()})
        elif self.path == "/debug/profile":
            self._profile_capture()
        elif self.path == "/debug/profile/start":
            self._profile_start()
        elif self.path == "/debug/profile/stop":
            self._profile_stop()
        elif self.path == "/internal/kv/fetch":
            self._kv_fetch()
        elif self.path in ("/tokenize", "/detokenize"):
            try:
                body = self._read_json()
                self._json(200, (self._tokenize if self.path == "/tokenize"
                                 else self._detokenize)(body))
            except BadRequest as e:
                self._bad_request(e)
        elif self.path == "/v1/embeddings":
            # an explicit 501, not a 404: the route is in the OpenAI surface,
            # this server hosts a generative model
            try:
                n = self._body_length()
                if n:
                    self.rfile.read(n)
            except BadRequest as e:
                self._bad_request(e)
                return
            self._json(501, {"error": {
                "message": "this server hosts a generative model; /v1/embeddings is not "
                           "supported", "type": "not_implemented"}})
        elif self.path in ("/v1/completions", "/v1/chat/completions"):
            with self.app._active_lock:
                self.app._active += 1
            try:
                self._completion(self.path == "/v1/chat/completions")
            finally:
                with self.app._active_lock:
                    self.app._active -= 1
        else:
            self._error(404, f"no route {self.path}", "not_found")

    def _profile_capture(self) -> None:
        """POST /debug/profile: one bounded capture of the live engine, run
        on this handler's thread (the profiler starts and stops between
        engine steps), answered with its id and files; 409 while another
        runs; 500 naming the cause when the profiler cannot capture."""
        try:
            body = self._read_json()
        except BadRequest:
            body = {}
        duration_ms = body.get("duration_ms", 500)
        if (not isinstance(duration_ms, (int, float)) or isinstance(duration_ms, bool)
                or duration_ms <= 0):
            self._json(400, {"error": {"message": "duration_ms must be a positive number"}})
            return
        if self.app.profiles.manual:
            self._json(409, {"error": {"message": "manual profiler session running "
                                                  "(/debug/profile/stop first)"}})
            return
        try:
            meta = self.app.profiles.capture(float(duration_ms))
        except ProfileError as e:
            self._error(500, str(e), "profiler_error")
            return
        except RuntimeError:
            self._json(409, {"error": {"message": "capture already in progress"}})
            return
        self._json(200, meta)

    def _profile_start(self) -> None:
        """POST /debug/profile/start (the JAX ``profile_start``): a manual
        session until /debug/profile/stop; 409 while a capture or session
        runs, 501 when the profiler cannot start."""
        self._drain_body()
        try:
            self._json(200, self.app.profiles.start_session())
        except ProfileError as e:
            self._json(501, {"error": {"message": f"profiler unavailable: {e}"}})
        except RuntimeError:
            self._json(409, {"error": {"message": "profiler already running"}})

    def _profile_stop(self) -> None:
        """POST /debug/profile/stop (the JAX ``profile_stop``): ends the
        manual session and answers with the capture's id and files; 409
        without a session, 500 when the profiler cannot stop."""
        self._drain_body()
        try:
            self._json(200, self.app.profiles.stop_session())
        except ProfileError as e:
            self._json(500, {"error": {"message": f"stop failed: {e}"}})
        except RuntimeError:
            self._json(409, {"error": {"message": "profiler not running"}})

    def _drain_body(self) -> None:
        """Read and drop a request body nobody needs."""
        try:
            n = self._body_length()
        except BadRequest:
            return
        if n:
            self.rfile.read(n)

    def _kv_fetch(self) -> None:
        """POST /internal/kv/fetch (the JAX ``kv_fetch``): a decode replica
        sends ``{"tenant", "digests": [hex, ...]}`` and gets ``{"payloads":
        [...]}``, position-matched, null for a page this host tier does
        not hold. The answer is written one page at a time (a page of
        llama-3-8b is 8 MiB raw), not built whole in memory, and ends
        with the connection. A killed or wedged replica refuses (503), so
        the puller re-prefills instead of hanging."""
        app = self.app
        if app.state in ("killed", "wedged"):
            self._error(503, f"replica {app.state}", "service_unavailable")
            return
        try:
            body = self._read_json()
        except BadRequest as e:
            self._bad_request(e)
            return
        raw = body.get("digests")
        if (not isinstance(raw, list) or len(raw) > KV_FETCH_MAX_DIGESTS
                or not all(isinstance(d, str) for d in raw)):
            self._error(400, f"digests must be a list of <= {KV_FETCH_MAX_DIGESTS} hex "
                             f"strings")
            return
        try:
            digests = [bytes.fromhex(d) for d in raw]
        except ValueError:
            self._error(400, "malformed digest hex")
            return
        payloads = app.engine.host_kv_export(str(body.get("tenant") or ""), digests)
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True
        try:
            self.wfile.write(b'{"payloads": [')
            for i, pl in enumerate(payloads):
                piece = "null" if pl is None else json.dumps(encode_kv_payload(pl))
                self.wfile.write(((", " if i else "") + piece).encode())
            self.wfile.write(b"]}")
        except (BrokenPipeError, ConnectionResetError):
            pass                # the puller gave up: it re-prefills

    def _tokenize(self, body: dict) -> dict:
        """{"prompt": str} or {"messages": [...]} -> {"tokens", "count",
        "max_model_len"} (vllm-openai's surface)."""
        tok = self.app.tokenizer
        prompt, messages = body.get("prompt"), body.get("messages")
        try:
            if isinstance(prompt, str):
                ids = tok.encode(prompt)
            elif isinstance(messages, list) and messages:
                ids = tok.apply_chat_template(messages)
            else:
                raise BadRequest("provide prompt (string) or messages (list)")
        except BadRequest:
            raise
        except Exception as e:  # bad roles or content: the client's input
            raise BadRequest(f"bad input: {e}")
        return {"tokens": list(ids), "count": len(ids),
                "max_model_len": self.app.engine.config.max_model_len}

    def _detokenize(self, body: dict) -> dict:
        toks = body.get("tokens")
        if not isinstance(toks, list) or any(
                not isinstance(t, int) or isinstance(t, bool) for t in toks):
            raise BadRequest("tokens must be a list of token ids")
        vocab = self.app.engine.model_config.vocab_size
        if any(not 0 <= t < vocab for t in toks):
            raise BadRequest(f"token id outside the vocabulary (size {vocab})")
        return {"prompt": self.app.tokenizer.decode(toks)}

    def _completion(self, chat: bool) -> None:
        """One completion under its trace: whatever it answers, it leaves
        a finished trace in the ring and one access-log line."""
        app = self.app
        ctx = self.trace_ctx
        trace = tracing.Trace(self.request_id, model=app.model_name,
                              trace_id=ctx.get("trace_id", ""),
                              parent_span_id=ctx.get("parent_span_id", ""),
                              component="api", sampled=bool(ctx.get("sampled", True)))
        trace.engine_reqs = []
        status = "error"
        try:
            self._serve_completion(chat, trace)
            code = self.status_code or 0
            status = "ok" if code < 400 else f"http_{code}"
        finally:
            app.finalize_trace(trace, status, self.status_code)

    def _serve_completion(self, chat: bool, trace: tracing.Trace) -> None:
        app = self.app
        if app.state in ("draining", "killed"):
            # draining: in-flight streams finish, new work goes to a live
            # replica; killed (a fault-injected crash): everything refused
            self._error(503, f"server is {app.state}; not accepting new requests",
                        "service_unavailable", "shutting_down", {"Retry-After": "5"})
            return
        try:
            body = self._read_json()
        except BadRequest as e:
            self._bad_request(e)
            return
        deadline = deadline_from(self.headers, body)
        if deadline is not None and deadline <= time.monotonic():
            # expired before the engine saw it: a queue-phase shed
            app.metrics["deadline_exceeded"].labels(phase="queue").inc()
            self._error(504, "deadline expired before processing", "timeout",
                        "deadline_exceeded")
            return
        raw_resume = self.headers.get(RESUME_TOKENS_HEADER)
        tools_on, tool_grammar = False, None
        try:
            if chat:
                prompt, tools_on, tool_grammar = app.chat_prompt(body)
                prompts = [prompt]
            params = app.sampling_from_body(body, chat)
            if not chat:
                prompts = app.prompts_from_body(body, chat)
            rf = body.get("response_format")
            if tool_grammar is not None or (rf is not None and not (
                    isinstance(rf, dict) and rf.get("type") in (None, "text"))):
                # guided decoding; an explicit {"type": "text"} skips the
                # compile (and the first-use vocabulary byte map)
                try:
                    grammar = app.grammar_for_request(body, tool_grammar)
                except GrammarError as e:
                    raise BadRequest(str(e))
                if grammar is not None:
                    params = dataclasses.replace(params, grammar=grammar)
            stream = bool(body.get("stream"))
            want_scores = bool(not chat and body.get("echo") and params.logprobs)
            if want_scores and stream:
                raise BadRequest("echo with logprobs cannot be streamed; use stream=false")
            n = body.get("n", 1)
            if not isinstance(n, int) or isinstance(n, bool) or not 1 <= n <= MAX_CHOICES:
                raise BadRequest(f"n must be an integer in [1, {MAX_CHOICES}]")
            # best_of: that many candidates a prompt, the n of highest mean
            # logprob returned (not streamed)
            best_of = body.get("best_of", n) if not chat else n
            if not isinstance(best_of, int) or isinstance(best_of, bool) or best_of < n:
                raise BadRequest("best_of must be an integer >= n")
            if best_of > MAX_CHOICES:
                raise BadRequest(f"best_of must be <= {MAX_CHOICES}")
            if best_of > n and stream:
                raise BadRequest("best_of > n cannot be streamed")
            if raw_resume is not None:
                # the router's splice: continue a stream a dead replica
                # started. Only single-choice streams are journaled, and the
                # replay is idempotent (the same prefix and seed give the
                # same continuation)
                if not stream or n != 1 or best_of != 1 or len(prompts) != 1:
                    raise BadRequest("stream resume requires a single-choice streaming request")
                try:
                    prefix = tuple(int(t) for t in raw_resume.split(",") if t.strip())
                except ValueError:
                    raise BadRequest(f"malformed {RESUME_TOKENS_HEADER} header")
                if prefix:
                    params = dataclasses.replace(params, prefix_tokens=prefix)
        except BadRequest as e:
            self._bad_request(e)
            return
        stops = _parse_stops(body)
        adapter = _adapter_from_model(body.get("model"))
        if adapter:
            trace.model = f"{app.model_name}:{adapter}"
        # the QoS identity (the routers resolve it the same way and forward
        # the class): the body's user, else its model; an invalid header
        # falls through to the engine's per-tenant config
        tenant = tenant_of(body, app.model_name)
        raw_prio = self.headers.get(PRIORITY_HEADER)
        priority = (raw_prio.strip().lower() if raw_prio is not None
                    and raw_prio.strip().lower() in PRIORITIES else None)
        # the decode hop of a handoff: the prefill replica's resolved seed,
        # so the stream samples as a colocated one would
        raw_hseed = self.headers.get(HANDOFF_SEED_HEADER)
        if raw_hseed is not None and params.seed is None:
            try:
                params = dataclasses.replace(params, seed=int(raw_hseed) & 0x7FFFFFFF)
            except ValueError:
                pass            # malformed internal header: a new seed, still correct
        # the prefill hop: a ticket instead of a stream; an ineligible shape
        # declines by serving normally (the router relays that stream)
        want_ticket = (self.headers.get(HANDOFF_HEADER, "").strip().lower() == "ticket"
                       and raw_resume is None and len(prompts) == 1
                       and n == 1 and best_of == 1 and app.engine.host_kv is not None)
        adopted = None
        if want_ticket:
            # prompt ingestion only: one token proves the prefill ran, and
            # submit(handoff=True) lands the spilled pages before its finish
            params = dataclasses.replace(params, max_tokens=1)
        elif self.headers.get(HANDOFF_SOURCE_HEADER):
            adopted = app.handoff_pull(self.headers, deadline, trace)
        events: "queue.SimpleQueue" = queue.SimpleQueue()
        reqs: list = []
        try:
            # prompt-major choice order; choice j > 0 of a seeded request
            # gets seed + j (a fixed seed would repeat the choice)
            for prompt in prompts:
                for j in range(best_of):
                    p = params
                    if best_of > 1 and params.seed is not None and j > 0:
                        p = dataclasses.replace(params, seed=(params.seed + j) & 0x7FFFFFFF)
                    idx = len(reqs)
                    # the engine request carries the request id (suffixed
                    # per choice, so engine ids stay unique)
                    eng_id = (self.request_id if len(prompts) * best_of == 1
                              else f"{self.request_id}/{idx}")
                    req = app.loop.submit(
                        prompt, p, lambda payload, idx=idx: events.put((idx, payload)),
                        deadline=deadline, request_id=eng_id, tenant=tenant,
                        priority=priority, handoff=want_ticket, adapter=adapter)
                    req.trace = trace
                    trace.engine_reqs.append(req)
                    reqs.append(req)
        except EngineStallError as e:
            self._abort_all(reqs)
            self._error(503, str(e), "service_unavailable", "engine_stalled",
                        {"Retry-After": "30"})
            return
        except UnknownAdapterError as e:
            # a 404, never a silent fallback: a mistyped adapter name must
            # not be served the base model's weights
            self._abort_all(reqs)
            self._error(404, str(e), "invalid_request_error", "adapter_not_found")
            return
        except QueueFullError as e:
            self._abort_all(reqs)
            # the backlog's drain time: queue depth x the step estimate
            est = len(app.engine.waiting) * max(app.engine._est_step, 1e-3)
            cfg = app.engine.config
            app.metrics["tenant_shed"].labels(
                tenant=tenant, priority=priority or dict(cfg.qos_priorities).get(
                    tenant, cfg.qos_default_priority), reason="overloaded").inc()
            self._error(429, str(e), "rate_limit_exceeded", "overloaded",
                        {"Retry-After": str(retry_after_s(est))})
            return
        except ValueError as e:          # engine validation (length, top_k, bias, ...)
            self._abort_all(reqs)
            self._error(400, str(e))
            return
        if want_ticket:
            self._handoff_ticket(reqs[0], events)
            return
        extra = {}
        if adopted is not None:
            # the decode hop: the pages that landed (0 with digests offered
            # is the router's counted re-prefill, never a client error)
            extra[HANDOFF_ADOPTED_HEADER] = str(adopted)
        digests = app.cache_digest_header(reqs)
        if digests:
            extra[CACHE_DIGESTS_HEADER] = digests
        rid = ("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex
        created = int(time.time())
        if raw_resume is not None:
            # the spliced continuation keeps the original stream's id and
            # created stamp
            sid = self.headers.get(RESUME_STREAM_ID_HEADER, "")
            if sid and len(sid) <= 128 and sid.isprintable():
                rid = sid
            raw_created = self.headers.get(RESUME_CREATED_HEADER, "")
            if raw_created.isdigit():
                created = int(raw_created)
        choices = [_Choice(app, r, stops) for r in reqs]
        for i, c in enumerate(choices):
            if c.warm_hit:
                app.loop.abort(c.req)
                events.put((i, ([], True, "stop")))
        try:
            if stream:
                include_usage = bool((body.get("stream_options") or {}).get("include_usage"))
                self._stream(choices, events, rid, created, chat, prompts, params.logprobs,
                             include_usage, journal=JOURNAL_HEADER in self.headers
                             and len(reqs) == 1, resumed=raw_resume is not None,
                             tools_on=tools_on, headers=extra)
                return
            scores = None
            if want_scores:
                try:
                    scores = [app.loop.call(app.engine.score_prompt, p) for p in prompts]
                except ValueError as e:
                    self._abort_all(reqs)
                    self._error(400, str(e))
                    return
            self._full(choices, events, rid, created, chat, prompts, params.logprobs, n,
                       best_of, bool(body.get("echo")) and not chat, scores, tools_on,
                       headers=extra)
        except (BrokenPipeError, ConnectionResetError):
            self._abort_all(reqs, "disconnect")
        except BaseException:
            self._abort_all(reqs)
            raise

    def _handoff_ticket(self, req, events) -> None:
        """The prefill hop's answer (the JAX ``_handoff_ticket_response``):
        wait for the one-token prefill, then answer the ticket (the page
        digests, the tenant and the resolved seed) instead of a stream. The
        router sends the original body to a decode replica, which pulls the
        pages and regenerates the stream from token zero."""
        reason = None
        try:
            while True:
                _i, (_toks, done, reason) = events.get()
                if done:
                    break
        except BaseException:
            self._abort_all([req])
            raise
        if reason == "timeout" and not req.output:
            self.app.metrics["deadline_exceeded"].labels(phase="queue").inc()
            self._error(504, "deadline expired during prefill", "timeout",
                        "deadline_exceeded")
            return
        if reason not in ("length", "stop") and not req.output:
            # stalled, aborted or killed mid-prefill: the router tries
            # another prefill replica or serves colocated
            self._error(503, f"prefill failed: {reason}", "service_unavailable",
                        "handoff_prefill_failed", {"Retry-After": "1"})
            return
        page = self.app.engine.allocator.page_size
        n_pages = max(0, (len(req.prompt) - 1) // page)
        digests = (self.app.engine.handoff_digests(req.prompt[:n_pages * page],
                                                   salt=req.cache_salt)
                   if n_pages > 0 else [])
        doc = {"object": "llmk.handoff_ticket", "model": self.app.model_name,
               "prompt_tokens": len(req.prompt), "tenant": req.tenant, "seed": req.seed,
               "digests": [d.hex() for d in digests]}
        headers = {HANDOFF_TICKET_HEADER: "1"}
        chip = chip_ms_total([req])
        if chip:
            doc["chip_ms"] = {ph: round(v, 3) for ph, v in chip.items()}
            headers[CHIP_MS_HEADER] = str(round(sum(chip.values()), 3))
        self._json(200, doc, headers)

    def _abort_all(self, reqs, reason: str = "abort") -> None:
        for r in reqs:
            self.app.loop.abort(r, reason)

    def _events(self, choices, events):
        """Yield (choice index, text, done, reason, released entries, raw
        token ids) per engine event, until every choice is done; events for
        a choice already done (after a stop string aborted it) are dropped.
        The gray-failure faults act between an event and its delivery:
        ``degraded_replica`` stretches the pacing by (factor - 1) x the
        time since the last event, ``net_jitter`` adds 0..MS ms."""
        app = self.app
        jitter_ms = faults.get_float("net_jitter", 25.0)
        app.maybe_claim_degraded()
        t_last = time.monotonic()
        while not all(c.done for c in choices):
            i, (toks, done, reason) = events.get()
            if app._degraded_factor > 1.0:
                time.sleep((time.monotonic() - t_last) * (app._degraded_factor - 1.0))
            if jitter_ms is not None and jitter_ms > 0:
                time.sleep(random.uniform(0.0, jitter_ms / 1000.0))
            t_last = time.monotonic()
            if not choices[i].done:
                yield (i, *choices[i].feed(toks, done, reason), toks)

    def _full(self, choices, events, rid, created, chat, prompts, nlp, n, best_of, echo,
              scores, tools_on: bool = False, headers: Optional[dict] = None) -> None:
        app = self.app
        texts = [""] * len(choices)
        reasons: list = [None] * len(choices)
        entries: list = [[] for _ in choices]
        for i, text, done, reason, released, _raw in self._events(choices, events):
            texts[i] += text
            entries[i] += released
            if done:
                reasons[i] = reason
        if "stalled" in reasons:
            # the watchdog shed the step this request rode: a clean 503 (a
            # retry may land on a healthy replica), not a truncated answer
            self._error(503, "engine stalled while generating; request was aborted",
                        "service_unavailable", "engine_stalled", {"Retry-After": "30"})
            return
        if all(reasons[i] == "timeout" and not texts[i] for i in range(len(choices))):
            # no choice produced anything inside its deadline: the 504 the
            # router would give (a choice with text answers 200, "timeout")
            self._error(504, "deadline exceeded before any output was generated",
                        "timeout", "deadline_exceeded")
            return
        results = [(i // best_of, texts[i], reasons[i], entries[i])
                   for i in range(len(choices))]
        if best_of > n:
            # keep each prompt's n best by mean token logprob; an empty
            # completion never wins
            def score(ents):
                lps = [lp[0] for _, lp, _ in ents if lp is not None]
                return sum(lps) / len(lps) if lps else float("-inf")

            kept = []
            for g in range(len(prompts)):
                group = [r for r in results if r[0] == g]
                group.sort(key=lambda r: score(r[3]), reverse=True)
                kept += group[:n]
            results = kept
        out = []
        blocks: dict = {}
        for i, (g, text, reason, ents) in enumerate(results):
            if chat:
                message = {"role": "assistant", "content": text}
                if tools_on:
                    # tool-call blocks become message.tool_calls
                    parser = ToolStreamParser()
                    content, _ = parser.push(text, final=True)
                    if parser.calls:
                        message["content"] = content or None
                        message["tool_calls"] = parser.calls
                        if reason == "stop":
                            reason = "tool_calls"
                choice = {"index": i, "message": message, "finish_reason": reason}
                if nlp:
                    choice["logprobs"] = app.chat_logprobs(ents, nlp)
            else:
                echo_text = app.tokenizer.decode(prompts[g]) if echo else ""
                choice = {"index": i, "text": echo_text + text, "finish_reason": reason}
                if nlp:
                    lp = app.completion_logprobs(ents, nlp, len(echo_text))
                    if scores is not None:
                        if g not in blocks:
                            blocks[g] = app.prompt_logprob_block(prompts[g], scores[g], nlp)
                        lp = {k: blocks[g][k] + lp[k] for k in lp}
                    choice["logprobs"] = lp
            out.append(choice)
        n_prompt = sum(len(p) for p in prompts)
        n_out = sum(c.total for c in choices)
        usage = {"prompt_tokens": n_prompt, "completion_tokens": n_out,
                 "total_tokens": n_prompt + n_out}
        chip = chip_ms_total([c.req for c in choices])
        headers = dict(headers or {})
        if chip:
            usage["chip_ms"] = {ph: round(v, 3) for ph, v in chip.items()}
            headers[CHIP_MS_HEADER] = str(round(sum(chip.values()), 3))
        self._json(200, {
            "id": rid, "object": "chat.completion" if chat else "text_completion",
            "created": created, "model": app.resp_model([c.req for c in choices]),
            "choices": out,
            "usage": usage}, headers)

    def _stream(self, choices, events, rid, created, chat, prompts, nlp, include_usage,
                journal: bool = False, resumed: bool = False, tools_on: bool = False,
                headers: Optional[dict] = None) -> None:
        """Server-sent events. Writes hold one lock, shared with the
        keepalive thread (``: ping`` every ``keepalive_interval_s()``
        seconds, stopped before the final chunk). With ``journal`` each
        event's data lines are followed by ``: llmk-tok <raw ids>``; a
        ``resumed`` chat stream sends no role delta (the original did).
        With ``tools_on`` (chat) tool-call blocks are cut out of the content
        and each completed one is sent as one ``tool_calls`` delta with its
        id, name and arguments; a choice that made a call finishes
        "tool_calls"."""
        app = self.app
        model = app.resp_model([c.req for c in choices])
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("X-Accel-Buffering", "no")
        self.send_header("Connection", "close")
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.close_connection = True
        obj = "chat.completion.chunk" if chat else "text_completion"
        lock = threading.Lock()
        # LLMK_FAULT=kill_mid_stream[:N]: the first stream of the process
        # to deliver N tokens dies with a TCP reset
        kill_after = faults.get_float("kill_mid_stream", 8.0)

        def send(line: str) -> None:      # the caller holds ``lock``
            self.wfile.write(line.encode())
            self.wfile.flush()

        def write(payload) -> None:
            send(f"data: {payload if isinstance(payload, str) else json.dumps(payload)}\n\n")

        def chunk(index: int, text: Optional[str], reason: Optional[str],
                  role: bool = False, ents=None, base_offset: int = 0,
                  tool_deltas=None) -> dict:
            if chat:
                delta: dict = {"role": "assistant"} if role else {}
                if text is not None:
                    delta["content"] = text
                if tool_deltas:
                    delta["tool_calls"] = tool_deltas
                choice = {"index": index, "delta": delta, "finish_reason": reason}
                if nlp and ents:
                    choice["logprobs"] = app.chat_logprobs(ents, nlp)
            else:
                choice = {"index": index, "text": text or "", "finish_reason": reason}
                if nlp and ents:
                    choice["logprobs"] = app.completion_logprobs(ents, nlp, base_offset)
            return {"id": rid, "object": obj, "created": created,
                    "model": model, "choices": [choice]}

        ka_stop = threading.Event()
        keep_s = keepalive_interval_s()
        if keep_s > 0:
            # idle-timeout balancers reap a quiet stream; clients and the
            # routers pass SSE comments over
            def keepalive() -> None:
                while not ka_stop.wait(keep_s):
                    with lock:
                        if ka_stop.is_set():
                            return
                        try:
                            send(": ping\n\n")
                        except OSError:
                            return

            threading.Thread(target=keepalive, name="sse-keepalive", daemon=True).start()
        try:
            with lock:
                if chat and not resumed:
                    for i in range(len(choices)):
                        write(chunk(i, None, None, role=True))
            signalled = [False] * len(choices)
            chars = [0] * len(choices)      # each choice's offsets run over its stream
            parsers = [ToolStreamParser() if tools_on and chat else None for _ in choices]
            n_calls = [0] * len(choices)
            for i, text, done, reason, ents, raw in self._events(choices, events):
                tool_deltas = None
                if parsers[i] is not None:
                    text, new_calls = parsers[i].push(text, final=done)
                    if new_calls:
                        tool_deltas = []
                        for c in new_calls:
                            tool_deltas.append({"index": n_calls[i], "id": c["id"],
                                                "type": c["type"], "function": c["function"]})
                            n_calls[i] += 1
                with lock:
                    if done and all(c.done for c in choices):
                        ka_stop.set()       # no ping after the final chunk
                    # a chunk is due for text, a tool call or logprob
                    # entries; the first token always gets one, even when
                    # its text is held back, so the time to the first chunk
                    # tracks the engine's first token
                    if text or tool_deltas or (nlp and ents):
                        write(chunk(i, text or None, None, ents=ents, base_offset=chars[i],
                                    tool_deltas=tool_deltas))
                        signalled[i] = True
                        if nlp:
                            chars[i] += sum(len(p) for _, _, p in ents)
                    elif not signalled[i] and not done:
                        write(chunk(i, "", None))
                        signalled[i] = True
                    if done:
                        if parsers[i] is not None and parsers[i].calls and reason == "stop":
                            reason = "tool_calls"
                        write(chunk(i, None, reason))
                    if journal and raw:
                        # after the event's data: a journaled token's text
                        # has been delivered (the splice invariant)
                        send(f": llmk-tok {','.join(str(t) for t in raw)}\n\n")
                if (kill_after is not None and choices[i].total >= kill_after
                        and faults.claim("kill_mid_stream")):
                    self._abort_all([c.req for c in choices], "kill_mid_stream")
                    self._reset_connection()
                    return
            ka_stop.set()
            with lock:
                if include_usage:
                    n_prompt = sum(len(p) for p in prompts)
                    n_out = sum(c.total for c in choices)
                    usage = {"prompt_tokens": n_prompt, "completion_tokens": n_out,
                             "total_tokens": n_prompt + n_out}
                    chip = chip_ms_total([c.req for c in choices])
                    if chip:
                        usage["chip_ms"] = {ph: round(v, 3) for ph, v in chip.items()}
                    write({"id": rid, "object": obj, "created": created,
                           "model": model, "choices": [], "usage": usage})
                write("[DONE]")
        finally:
            ka_stop.set()


def serve(model: str = "debug-tiny", *, host: str = "0.0.0.0", port: int = 8080,
          device: str = "cuda", random_weights: bool = False,
          served_model_name: Optional[str] = None,
          engine_config: Optional[EngineConfig] = None,
          model_dir: Optional[str] = None, warmup: bool = True) -> None:
    """Build the engine and serve until SIGTERM or SIGINT drains it.
    ``model`` is a registry name, a checkpoint directory, a HF id found
    in the local cache or a llama.cpp ``.gguf`` file (``_gguf_engine``:
    its config, weights and embedded tokenizer); the weights come from
    ``model_dir`` (default: ``model`` resolved by
    ``engine/weights.resolve_model_dir``, which raises FileNotFoundError
    on a miss), or are seeded random with ``random_weights``. ``device``
    "cuda" (the default) raises without a GPU. The tokenizer is read
    first, then the CUDA kernels are built and the weights loaded onto the
    device, and (``warmup``, as the JAX ``serve``) a 4-token prompt
    generates 2 greedy tokens, all before the server binds, so ``/health``
    answers only once the model has served.

    SIGTERM (and SIGINT) begins the drain: /ready answers 503, new requests
    get 503, and the process returns once the work in flight is done (at
    most ``EngineLoop.drain_timeout_s``) and its last bytes are written."""
    dev = resolve_device(device)
    cfg = engine_config or EngineConfig(model=model)
    cfg.model, cfg.device = model, dev.type
    if model.endswith(".gguf"):
        engine, tokenizer, load_s, source = _gguf_engine(model, cfg, dev, random_weights,
                                                         served_model_name)
        model_config = engine.model_config
        served_model_name = served_model_name or model_config.name
        print(f"[serve] {model_config.name}: {source} on {dev.type} in {load_s:.1f} s",
              file=sys.stderr, flush=True)
        _serve_until_drained(OpenAIServer(engine, tokenizer, served_model_name,
                                          cold_start=_warm_up(engine, load_s, warmup)),
                             host, port)
        return
    if not random_weights and model_dir is None:
        model_dir = resolve_model_dir(model)
    config_dir = model_dir or (model if os.path.isdir(model) else None)
    model_config = model_config_for(model, config_dir)
    tokenizer = load_tokenizer(config_dir or model)
    if dev.type == "cuda":
        kernels.build()
    t0 = time.perf_counter()
    engine = Engine(cfg, model_config=model_config,
                    model_dir=None if random_weights else model_dir)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    load_s = time.perf_counter() - t0
    source = "seeded random weights" if random_weights else f"weights from {model_dir}"
    print(f"[serve] {model_config.name}: {source} on {dev.type} in {load_s:.1f} s",
          file=sys.stderr, flush=True)
    _serve_until_drained(OpenAIServer(engine, tokenizer, served_model_name or model,
                                      cold_start=_warm_up(engine, load_s, warmup)), host, port)


def _warm_up(engine: Engine, load_s: float, warmup: bool) -> dict:
    """The JAX ``serve``'s warm-up (cli.py ``--no-warmup``): a 4-token
    prompt generates 2 greedy tokens through the engine before the server
    takes traffic, so the first request does not pay for the first
    prefill and window. Returns the cold-start phases: "load", and
    "compile" (the warm-up's seconds) when it ran."""
    phases = {"load": load_s}
    if not warmup:
        return phases
    t0 = time.perf_counter()
    req = engine.submit([1, 2, 3, 4], SamplingParams(temperature=0.0, max_tokens=2))
    while not req.finished:
        engine.step()
    phases["compile"] = time.perf_counter() - t0
    print(f"[serve] warmup complete in {phases['compile']:.1f} s", file=sys.stderr, flush=True)
    return phases


def _gguf_engine(path: str, cfg: EngineConfig, dev: torch.device, random_weights: bool,
                 served_model_name: Optional[str]):
    """The engine and tokenizer of a llama.cpp ``.gguf`` file (the JAX
    ``serve``'s GGUF branch): the model config from the file's metadata
    (named ``served_model_name`` when given), its weights dequantized a
    layer at a time onto ``dev`` (``engine/gguf.load_gguf_params``, int8
    with ``cfg.quantization``) or seeded random ones at its widths; the
    tokenizer files beside the file win, else the vocabulary and chat
    template it embeds, else the byte tokenizer. Returns (engine,
    tokenizer, load seconds, what the weights are)."""
    from llms_on_kubernetes_tpu_torch.engine.gguf import (
        GGUFFile, config_from_gguf, load_gguf_params,
    )
    from llms_on_kubernetes_tpu_torch.engine.tokenizer import ByteTokenizer, GGUFTokenizer

    if not os.path.isfile(path):
        raise FileNotFoundError(f"GGUF file not found: {path}")
    gf = GGUFFile(path)     # parsed once: config, weights and tokenizer
    model_config = config_from_gguf(gf, name=served_model_name)
    tokenizer = load_tokenizer(os.path.dirname(path) or ".")
    if isinstance(tokenizer, ByteTokenizer) and "tokenizer.ggml.tokens" in gf.metadata:
        tokenizer = GGUFTokenizer(gf.metadata)
    if dev.type == "cuda":
        kernels.build()
    t0 = time.perf_counter()
    params = None
    if random_weights:
        gf.close()
        source = "seeded random weights"
    else:
        _, params = load_gguf_params(gf, cfg=model_config, dtype=cfg.dtype,
                                     quantization=cfg.quantization, device=dev)
        source = f"weights from {path}"
    engine = Engine(cfg, model_config=model_config, params=params)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return engine, tokenizer, time.perf_counter() - t0, source


def _serve_until_drained(server: "OpenAIServer", host: str, port: int) -> None:
    """Serve until SIGTERM or SIGINT has drained the server."""

    def on_signal(signum, _frame):
        if server.begin_drain():
            print(f"[serve] signal {signum}: draining", file=sys.stderr, flush=True)
            server.shutdown_when_drained()

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    server.serve_forever(host, port)
    print("[serve] drained, exiting", file=sys.stderr, flush=True)
