"""Dependency-free per-request tracing, structured logs, flight recorder:
the port's copy of ``llms_on_kubernetes_tpu/server/tracing.py``, whole, so
the port imports nothing of the JAX package.

The reference stack could not answer "where did request X spend its 3
seconds?": the gateway suppressed logs entirely and nothing correlated a
router log line with an engine step (SURVEY §5). This module is the shared
observability substrate for every serving layer:

- **Request IDs**: ``X-LLMK-Request-Id`` is generated at the edge (either
  router, or the API server itself for direct traffic) and propagated
  through every hop, Dapper-style. Both routers and the API echo it on the
  response so a client can quote the id when reporting a slow request.
- **Traces**: a :class:`Trace` collects named :class:`Span` windows
  (router receive/connect/first-byte/stream-done; API queue/prefill/
  decode/stream) plus point events (preemption, deadline, stall). Completed
  traces land in a :class:`TraceStore` ring served at ``GET /debug/traces``.
- **Structured logs**: :func:`jlog` emits one-line JSON records (with the
  request id on every line) instead of ad-hoc prints; requests slower than
  ``LLMK_SLOW_REQUEST_MS`` get their full trace dumped automatically.
- **Flight recorder**: a fixed-size ring of the last N engine decode steps
  (:class:`FlightRecorder`), served at ``GET /debug/engine`` — enough to
  diagnose a wedged or slow engine post-hoc without a profiler attached.

Everything here is stdlib-only and lock-protected: spans are recorded from
the engine thread, the asyncio event loop, and router worker tasks.
"""

from __future__ import annotations

import collections
import json
import os
import random
import sys
import threading
import time
import urllib.request
import uuid
from typing import Optional

REQUEST_ID_HEADER = "X-LLMK-Request-Id"

# W3C Trace Context (https://www.w3.org/TR/trace-context/): the cross-hop
# propagation headers. Both routers and the API server mint/parse these with
# byte-identical semantics, pinned by tests/data/trace_vectors.json and the
# native router's --trace-selftest.
TRACEPARENT_HEADER = "traceparent"
TRACESTATE_HEADER = "tracestate"

# OTLP/HTTP-JSON export target (e.g. http://collector:4318/v1/traces).
# Unset ⇒ the exporter is dormant and tracing stays process-local.
OTLP_ENDPOINT_ENV = "LLMK_OTLP_ENDPOINT"
# Probability [0,1] that a boring (non-error/slow/multi-hop) trace is
# exported; error/slow/multi-hop traces always export (tail sampling).
TRACE_SAMPLE_ENV = "LLMK_TRACE_SAMPLE"
TRACE_SAMPLE_DEFAULT = 0.01

# requests slower than this (ms, end to end) get their whole trace logged;
# 0 disables the dump. Read per-call so tests can flip it cheaply.
SLOW_REQUEST_ENV = "LLMK_SLOW_REQUEST_MS"
SLOW_REQUEST_DEFAULT_MS = 10_000.0


def new_request_id() -> str:
    return uuid.uuid4().hex


def request_id_from(headers, generate: bool = True) -> tuple[str, bool]:
    """(request id, was_generated) from a mapping with ``.get``.

    The inbound header is forwarded verbatim when present (so an id minted
    by an outer proxy survives the whole path); absent or blank means this
    hop is the edge and mints one.
    """
    rid = headers.get(REQUEST_ID_HEADER) or headers.get(
        REQUEST_ID_HEADER.lower())
    if rid:
        return rid, False
    if not generate:
        return "", False
    return new_request_id(), True


# ---------------------------------------------------------------------------
# W3C traceparent: parse / mint / reconcile (pure — vector-pinned)
# ---------------------------------------------------------------------------

_HEX = frozenset("0123456789abcdef")
_RID_SAFE = frozenset(
    "0123456789abcdefghijklmnopqrstuvwxyz"
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ-_")


def _is_hex(s: str, width: int) -> bool:
    return len(s) == width and all(c in _HEX for c in s)


def new_trace_id() -> str:
    return uuid.uuid4().hex


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def parse_traceparent(value: Optional[str]):
    """Strict W3C parse → ``(trace_id, parent_span_id, flags)`` or ``None``.

    Rejections (all count as malformed, never "best effort"): version not
    2 lowercase hex or the reserved ``ff``; version ``00`` with a field
    count other than 4 (future versions tolerate extra fields); trace id
    not 32 lowercase hex or all zeros; span id not 16 lowercase hex or all
    zeros; flags not 2 lowercase hex. Mirrored byte-for-byte in
    native/router/router.cpp and pinned by tests/data/trace_vectors.json.
    """
    if not value:
        return None
    parts = value.strip(" \t").split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id, flags = parts[0], parts[1], parts[2], parts[3]
    if not _is_hex(version, 2) or version == "ff":
        return None
    if version == "00" and len(parts) != 4:
        return None
    if not _is_hex(trace_id, 32) or trace_id == "0" * 32:
        return None
    if not _is_hex(span_id, 16) or span_id == "0" * 16:
        return None
    if not _is_hex(flags, 2):
        return None
    return trace_id, span_id, int(flags, 16)


def format_traceparent(trace_id: str, span_id: str,
                       sampled: bool = True) -> str:
    return "00-%s-%s-%s" % (trace_id, span_id, "01" if sampled else "00")


def valid_tracestate(value: Optional[str]) -> bool:
    """Passthrough filter: ≤512 printable-ASCII chars, else dropped."""
    if not value or len(value) > 512:
        return False
    return all(0x20 <= ord(c) <= 0x7E for c in value)


def safe_request_id(rid: Optional[str]) -> bool:
    """A client-suppliable request id we are willing to adopt: 1–64 chars
    of [A-Za-z0-9_-]. Anything else (header injection, log forgery, 4 KiB
    of junk) is re-minted at the edge, mirroring the resume-header
    stripping treatment."""
    return bool(rid) and len(rid) <= 64 and all(c in _RID_SAFE for c in rid)


def reconcile(traceparent: Optional[str], tracestate: Optional[str],
              request_id: Optional[str]) -> dict:
    """Canonically reconcile inbound correlation headers at the edge.

    Deterministic (vector-pinned): a valid ``traceparent`` is adopted
    (trace id + parent span id + sampled flag); a malformed or absent one
    yields empty ids, meaning the caller mints fresh ones. A safe
    ``X-LLMK-Request-Id`` is adopted verbatim; an unsafe one is replaced —
    by the adopted trace id when there is one (so the rid and the trace
    stay correlated), otherwise by a caller-minted id (empty here).
    ``tracestate`` passes through only alongside an adopted traceparent
    and only when well-formed.
    """
    parsed = parse_traceparent(traceparent)
    if parsed is not None:
        trace_id, parent_span_id, flags = parsed
        adopted, reason = True, "adopted"
        sampled = bool(flags & 0x01)
    else:
        trace_id, parent_span_id = "", ""
        adopted, sampled = False, True
        reason = "absent" if not (traceparent or "").strip(" \t") \
            else "malformed"
    rid = request_id or ""
    if safe_request_id(rid):
        rid_out = rid
    elif adopted:
        rid_out = trace_id
    else:
        rid_out = ""
    state = tracestate or ""
    if not (adopted and valid_tracestate(state)):
        state = ""
    return {"trace_id": trace_id, "parent_span_id": parent_span_id,
            "sampled": sampled, "adopted": adopted, "reason": reason,
            "request_id": rid_out, "tracestate": state}


# ---------------------------------------------------------------------------
# tail-based sampling (pure decision — vector-pinned)
# ---------------------------------------------------------------------------

def tail_decision(error: bool, e2e_ms: float, slow_ms: float,
                  multi_hop: bool, sample: float,
                  rand01: float) -> tuple[bool, str]:
    """Keep-or-drop decision made AFTER the request finished (tail-based):
    errors, slow requests, and multi-hop flows (resume/hedge/handoff/
    redirect/failover) always export; the rest export with probability
    ``sample`` using the caller-supplied ``rand01`` draw. Pure so the
    native router mirrors it byte-for-byte (trace_vectors.json §sampler).
    """
    if error:
        return True, "error"
    if slow_ms > 0 and e2e_ms >= slow_ms:
        return True, "slow"
    if multi_hop:
        return True, "multi_hop"
    if sample >= 1.0:
        return True, "sampled"
    if sample <= 0.0 or rand01 >= sample:
        return False, "sampled_out"
    return True, "sampled"


def trace_sample_rate() -> float:
    raw = os.environ.get(TRACE_SAMPLE_ENV)
    if raw is None:
        return TRACE_SAMPLE_DEFAULT
    try:
        return min(1.0, max(0.0, float(raw)))
    except ValueError:
        return TRACE_SAMPLE_DEFAULT


# span names / event names that mark a trace as multi-hop even when the
# caller cannot tell (used by is_multi_hop on finished trace dicts).
_MULTI_HOP_EVENTS = frozenset({
    "hedge_launch", "hedge_won", "stream_resume", "handoff",
    "handoff_declined", "handoff_fallback_colocated", "affinity_kv_pull",
    "affinity_filter_deny", "retry", "failover",
})


def is_multi_hop(trace_dict: dict) -> bool:
    """Did this trace cross more than one upstream hop? True when any
    multi-hop event fired or a connect span needed more than one attempt."""
    for ev in trace_dict.get("events", ()):
        if ev.get("name") in _MULTI_HOP_EVENTS:
            return True
    for sp in trace_dict.get("spans", ()):
        try:
            if int(sp.get("attempts", 1)) > 1:
                return True
        except (TypeError, ValueError):
            pass
    return False


class TailSampler:
    """Env-configured wrapper around :func:`tail_decision` with an
    injectable rng so tests and the bench are deterministic."""

    def __init__(self, sample: Optional[float] = None,
                 slow_ms: Optional[float] = None, rng=None):
        self._sample = sample
        self._slow_ms = slow_ms
        self._rng = rng if rng is not None else random.random

    def decide(self, error: bool, e2e_ms: Optional[float],
               multi_hop: bool) -> tuple[bool, str]:
        sample = self._sample if self._sample is not None \
            else trace_sample_rate()
        slow = self._slow_ms if self._slow_ms is not None \
            else slow_threshold_ms()
        return tail_decision(bool(error), float(e2e_ms or 0.0), float(slow),
                             bool(multi_hop), float(sample),
                             float(self._rng()))


def slow_threshold_ms() -> float:
    raw = os.environ.get(SLOW_REQUEST_ENV)
    if raw is None:
        return SLOW_REQUEST_DEFAULT_MS
    try:
        return float(raw)
    except ValueError:
        return SLOW_REQUEST_DEFAULT_MS


class Span:
    """One named time window inside a trace (monotonic-clock endpoints).

    ``span_id``/``parent_span_id`` (16-hex each, empty when unset) place
    the window in the cross-process trace tree: a router hop span's id is
    what the upstream replica sees as its ``traceparent`` parent, so hop
    fragments stitch under it.
    """

    __slots__ = ("name", "start", "end", "meta", "span_id", "parent_span_id")

    def __init__(self, name: str, start: float, end: Optional[float] = None,
                 meta: Optional[dict] = None, span_id: str = "",
                 parent_span_id: str = ""):
        self.name = name
        self.start = start
        self.end = end
        self.meta = meta
        self.span_id = span_id
        self.parent_span_id = parent_span_id

    def duration_ms(self) -> Optional[float]:
        if self.end is None:
            return None
        return max(0.0, (self.end - self.start) * 1000.0)


class Trace:
    """Spans + point events of one request's path through this process."""

    def __init__(self, request_id: str, model: str = "",
                 clock=time.monotonic, trace_id: str = "",
                 span_id: str = "", parent_span_id: str = "",
                 component: str = "", sampled: bool = True):
        self.request_id = request_id
        self.model = model
        self.clock = clock
        # cross-process identity: this process's fragment is one span
        # (span_id) in the W3C trace (trace_id), parented under whatever
        # hop span the caller advertised via traceparent (parent_span_id).
        self.trace_id = trace_id or new_trace_id()
        self.span_id = span_id or new_span_id()
        self.parent_span_id = parent_span_id
        self.component = component
        self.sampled = sampled
        self.started_wall = time.time()
        self.t0 = clock()
        self.finished_at: Optional[float] = None
        self.status: Optional[str] = None
        self._spans: list[Span] = []
        self._events: list[dict] = []
        self._lock = threading.Lock()

    # -- recording (any thread) ----------------------------------------

    def add_span(self, name: str, start: float, end: Optional[float] = None,
                 span_id: str = "", parent_span_id: str = "",
                 **meta) -> None:
        """Record a completed (or still-open) window on this trace's clock."""
        with self._lock:
            self._spans.append(Span(name, start, end, meta or None,
                                    span_id=span_id,
                                    parent_span_id=parent_span_id))

    def event(self, name: str, **fields) -> None:
        ev = {"name": name,
              "t_ms": round((self.clock() - self.t0) * 1000.0, 3)}
        ev.update(fields)
        with self._lock:
            self._events.append(ev)

    def finish(self, status: str = "ok") -> None:
        with self._lock:
            if self.finished_at is None:
                self.finished_at = self.clock()
                self.status = status

    # -- reading -------------------------------------------------------

    def e2e_ms(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return max(0.0, (self.finished_at - self.t0) * 1000.0)

    def to_dict(self) -> dict:
        with self._lock:
            spans = []
            for s in self._spans:
                d = {
                    "name": s.name,
                    "start_ms": round(max(0.0, (s.start - self.t0) * 1e3), 3),
                    "duration_ms": (None if s.duration_ms() is None
                                    else round(s.duration_ms(), 3)),
                }
                if s.span_id:
                    d["span_id"] = s.span_id
                if s.parent_span_id:
                    d["parent_span_id"] = s.parent_span_id
                if s.meta:
                    d.update(s.meta)
                spans.append(d)
            out = {
                "id": self.request_id,
                "trace_id": self.trace_id,
                "span_id": self.span_id,
                "parent_span_id": self.parent_span_id,
                "component": self.component,
                "model": self.model,
                "started": round(self.started_wall, 6),
                "status": self.status,
                "e2e_ms": (None if self.finished_at is None
                           else round((self.finished_at - self.t0) * 1e3, 3)),
                "spans": spans,
                "events": list(self._events),
            }
        return out


class TraceStore:
    """Ring of recently completed traces (``GET /debug/traces``)."""

    def __init__(self, capacity: int = 256):
        self._ring: "collections.deque[Trace]" = collections.deque(
            maxlen=max(1, capacity))
        self._lock = threading.Lock()

    def add(self, trace: Trace) -> None:
        with self._lock:
            self._ring.append(trace)

    def snapshot(self, request_id: Optional[str] = None,
                 model: Optional[str] = None, limit: int = 50) -> list[dict]:
        """Most-recent-first trace dicts, optionally filtered by id/model.

        ``request_id`` matches either the request id or the W3C trace id,
        so ``/debug/traces?id=<trace_id>`` finds fragments minted under a
        different rid (stitching pulls use the trace id).
        """
        with self._lock:
            traces = list(self._ring)
        out = []
        for t in reversed(traces):
            if request_id and request_id not in (
                    t.request_id, getattr(t, "trace_id", None)):
                continue
            if model and t.model != model:
                continue
            out.append(t.to_dict())
            if len(out) >= max(1, limit):
                break
        return out


class FlightRecorder:
    """Fixed-size ring of per-decode-step engine snapshots.

    The engine loop records one entry per ``step()`` (step time, batch
    occupancy, KV pages, admitted/shed/preempted counters, tokens emitted);
    ``GET /debug/engine`` serves the ring so a wedged or slow engine can be
    diagnosed after the fact without a profiler attached.
    """

    def __init__(self, capacity: int = 512):
        self._ring: "collections.deque[dict]" = collections.deque(
            maxlen=max(1, capacity))
        self._lock = threading.Lock()
        self._seq = 0

    def record(self, **fields) -> None:
        with self._lock:
            self._seq += 1
            entry = {"step": self._seq, "ts": round(time.time(), 3)}
            entry.update(fields)
            self._ring.append(entry)

    def snapshot(self, limit: Optional[int] = None) -> dict:
        with self._lock:
            steps = list(self._ring)
            total = self._seq
        if limit is not None and limit > 0:
            steps = steps[-limit:]
        return {"steps_recorded": total, "capacity": self._ring.maxlen,
                "steps": steps}


# ---------------------------------------------------------------------------
# structured one-line-JSON logging
# ---------------------------------------------------------------------------

_log_lock = threading.Lock()


def jlog(event: str, request_id: Optional[str] = None, stream=None,
         **fields) -> None:
    """One JSON object per line on stderr: machine-greppable, and every
    line of a request's life carries its id. Never raises — logging must
    not take down the serving path."""
    rec: dict = {"ts": round(time.time(), 3), "event": event}
    if request_id:
        rec["request_id"] = request_id
    rec.update(fields)
    try:
        line = json.dumps(rec, separators=(",", ":"), default=str)
    except (TypeError, ValueError):
        line = json.dumps({"ts": rec["ts"], "event": event,
                           "error": "unserializable log record"})
    out = stream if stream is not None else sys.stderr
    with _log_lock:
        try:
            out.write(line + "\n")
            out.flush()
        except (OSError, ValueError):
            pass


def maybe_log_slow(trace: Trace, component: str) -> None:
    """Dump the full trace of a request slower than the threshold."""
    threshold = slow_threshold_ms()
    e2e = trace.e2e_ms()
    if threshold <= 0 or e2e is None or e2e < threshold:
        return
    jlog("slow_request", request_id=trace.request_id, component=component,
         threshold_ms=threshold, trace=trace.to_dict())


# ---------------------------------------------------------------------------
# cross-hop stitching: fragments -> one waterfall tree
# ---------------------------------------------------------------------------

def stitch_waterfall(trace_id: str, fragments: list[dict]) -> dict:
    """Assemble per-process trace fragments (``Trace.to_dict`` shape) into
    one waterfall tree for ``GET /debug/trace/<trace_id>``.

    Every fragment contributes its root span (the process window, keyed by
    the fragment's ``span_id``) plus its recorded spans; nodes are
    parented by ``parent_span_id``. Wall-clock ``started`` stamps align
    the fragments on one timeline (start_ms is relative to the earliest
    fragment). Nodes whose parent id is unknown AND non-empty are orphans
    — a correctly propagated multi-hop flow has none, so the bench gates
    on ``orphans == []``.
    """
    frags = [f for f in fragments
             if trace_id in (f.get("trace_id"), f.get("id"))]
    # dedupe: the edge router's local ring and a replica pull can both
    # return the same fragment
    seen: set = set()
    uniq: list[dict] = []
    for f in frags:
        key = f.get("span_id") or ("rid", f.get("id"), f.get("component"))
        if key in seen:
            continue
        seen.add(key)
        uniq.append(f)
    if not uniq:
        return {"trace_id": trace_id, "fragments": 0, "hops": 0,
                "orphans": [], "spans": [], "annotations": {}}

    base_wall = min(float(f.get("started") or 0.0) for f in uniq)
    nodes: dict[str, dict] = {}
    order: list[str] = []
    synth = 0

    def add_node(sid: str, parent: str, name: str, component: str,
                 start_ms: float, duration_ms, meta: dict) -> None:
        nonlocal synth
        if not sid or sid in nodes:
            synth += 1
            sid = f"{sid or 'anon'}~{synth}"
        node = {"span_id": sid, "parent_span_id": parent, "name": name,
                "component": component,
                "start_ms": round(max(0.0, start_ms), 3),
                "duration_ms": (None if duration_ms is None
                                else round(duration_ms, 3)),
                "children": []}
        node.update({k: v for k, v in meta.items() if v is not None})
        nodes[sid] = node
        order.append(sid)

    annotations: dict = {"resumes": 0, "hedge": False, "handoff": False,
                         "redirects": 0, "attempts": 0}
    for f in uniq:
        f_start = (float(f.get("started") or 0.0) - base_wall) * 1000.0
        add_node(f.get("span_id") or "", f.get("parent_span_id") or "",
                 f.get("component") or "fragment",
                 f.get("component") or "", f_start, f.get("e2e_ms"),
                 {"request_id": f.get("id"), "model": f.get("model"),
                  "status": f.get("status")})
        frag_root = order[-1]
        for s in f.get("spans", ()):
            meta = {k: v for k, v in s.items() if k not in _SPAN_RESERVED}
            add_node(s.get("span_id") or "",
                     s.get("parent_span_id") or nodes[frag_root]["span_id"],
                     s.get("name") or "span", f.get("component") or "",
                     f_start + float(s.get("start_ms") or 0.0),
                     s.get("duration_ms"), meta)
            try:
                annotations["attempts"] = max(
                    annotations["attempts"], int(s.get("attempts") or 0))
            except (TypeError, ValueError):
                pass
        for ev in f.get("events", ()):
            name = ev.get("name")
            if name == "stream_resume":
                annotations["resumes"] += 1
            elif name in ("hedge_launch", "hedge_won"):
                annotations["hedge"] = True
            elif name in ("handoff", "handoff_declined",
                          "handoff_fallback_colocated"):
                annotations["handoff"] = True
            elif name in ("affinity_kv_pull", "affinity_filter_deny"):
                annotations["redirects"] += 1

    roots: list[dict] = []
    orphans: list[str] = []
    for sid in order:
        node = nodes[sid]
        parent = node["parent_span_id"]
        if parent and parent in nodes:
            nodes[parent]["children"].append(node)
        elif parent:
            orphans.append(sid)
            roots.append(node)
        else:
            roots.append(node)
    for node in nodes.values():
        node["children"].sort(key=lambda n: n["start_ms"])
    roots.sort(key=lambda n: n["start_ms"])

    flat: list[dict] = []

    def walk(node: dict, depth: int) -> None:
        row = {k: v for k, v in node.items() if k != "children"}
        row["depth"] = depth
        flat.append(row)
        for child in node["children"]:
            walk(child, depth + 1)

    for r in roots:
        walk(r, 0)
    e2e = None
    for r in roots:
        if not r["parent_span_id"] and r["duration_ms"] is not None:
            e2e = r["duration_ms"] if e2e is None else max(e2e,
                                                           r["duration_ms"])
    return {"trace_id": trace_id, "fragments": len(uniq),
            "hops": len(uniq), "orphans": orphans, "e2e_ms": e2e,
            "annotations": annotations, "spans": flat, "tree": roots}


# ---------------------------------------------------------------------------
# OTLP/HTTP-JSON export (dependency-free: stdlib urllib only)
# ---------------------------------------------------------------------------

_SPAN_RESERVED = ("name", "start_ms", "duration_ms", "span_id",
                  "parent_span_id")


def otlp_payload(trace_dicts: list[dict], service_name: str = "llmk") -> dict:
    """Transform finished trace dicts (``Trace.to_dict`` shape) into one
    OTLP/HTTP-JSON ``resourceSpans`` payload. Each fragment becomes its
    root span (the process-level window) plus one span per recorded
    window; span meta keys ride as string attributes. Pure, so tests can
    assert the wire shape without a collector."""
    spans = []
    for t in trace_dicts:
        base_ns = int(float(t.get("started") or 0.0) * 1e9)
        tid = t.get("trace_id") or ""
        root_sid = t.get("span_id") or ""

        def attrs(d: dict) -> list[dict]:
            return [{"key": k, "value": {"stringValue": str(v)}}
                    for k, v in d.items() if v is not None]

        e2e = float(t.get("e2e_ms") or 0.0)
        spans.append({
            "traceId": tid,
            "spanId": root_sid,
            "parentSpanId": t.get("parent_span_id") or "",
            "name": t.get("component") or "request",
            "kind": 2,  # SPAN_KIND_SERVER
            "startTimeUnixNano": str(base_ns),
            "endTimeUnixNano": str(base_ns + int(e2e * 1e6)),
            "attributes": attrs({
                "llmk.request_id": t.get("id", ""),
                "llmk.model": t.get("model", ""),
                "llmk.status": t.get("status", ""),
            }),
        })
        for s in t.get("spans", ()):
            start_ns = base_ns + int(float(s.get("start_ms") or 0.0) * 1e6)
            dur_ms = float(s.get("duration_ms") or 0.0)
            meta = {k: v for k, v in s.items() if k not in _SPAN_RESERVED}
            spans.append({
                "traceId": tid,
                "spanId": s.get("span_id") or new_span_id(),
                "parentSpanId": s.get("parent_span_id") or root_sid,
                "name": s.get("name", ""),
                "kind": 1,  # SPAN_KIND_INTERNAL
                "startTimeUnixNano": str(start_ns),
                "endTimeUnixNano": str(start_ns + int(dur_ms * 1e6)),
                "attributes": attrs(meta),
            })
    return {"resourceSpans": [{
        "resource": {"attributes": [
            {"key": "service.name",
             "value": {"stringValue": service_name}}]},
        "scopeSpans": [{"scope": {"name": "llmk.tracing"}, "spans": spans}],
    }]}


def span_count(payload: dict) -> int:
    n = 0
    for rs in payload.get("resourceSpans", ()):
        for ss in rs.get("scopeSpans", ()):
            n += len(ss.get("spans", ()))
    return n


class OtlpExporter:
    """Background OTLP/HTTP-JSON span exporter with a bounded queue.

    Enqueue is non-blocking and never raises: a full queue counts a drop
    (``llm_trace_dropped_total{reason="queue_full"}``) instead of stalling
    the serving path. The worker thread batches whatever is queued into
    one POST. ``exported``/``dropped`` are labeled Counters (or None);
    ``post`` is injectable for tests (default: urllib with a short
    timeout).
    """

    def __init__(self, endpoint: str, service_name: str = "llmk",
                 timeout_s: float = 2.0, queue_max: int = 512,
                 exported=None, dropped=None, post=None):
        self.endpoint = endpoint
        self.service_name = service_name
        self.timeout_s = timeout_s
        self.export_failures = 0
        self._exported = exported
        self._dropped = dropped
        self._post = post if post is not None else self._http_post
        self._q: "collections.deque[dict]" = collections.deque()
        self._qmax = max(1, queue_max)
        self._cv = threading.Condition()
        self._closed = False
        self._inflight = 0
        self._thread = threading.Thread(
            target=self._run, name="llmk-otlp-exporter", daemon=True)
        self._thread.start()

    def export(self, trace_dict: dict) -> bool:
        with self._cv:
            if self._closed or len(self._q) >= self._qmax:
                if self._dropped is not None:
                    self._dropped.labels(reason="queue_full").inc()
                return False
            self._q.append(trace_dict)
            self._cv.notify()
        return True

    def flush(self, timeout_s: float = 5.0) -> bool:
        """Block until the queue drains (tests/bench); False on timeout."""
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while self._q or self._inflight:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(left)
        return True

    def close(self, timeout_s: float = 2.0) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout_s)

    # -- worker --------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._closed:
                    self._cv.wait(0.5)
                if not self._q and self._closed:
                    return
                batch = list(self._q)
                self._q.clear()
                self._inflight = len(batch)
            try:
                payload = otlp_payload(batch, self.service_name)
                n = span_count(payload)
                try:
                    self._post(self.endpoint, payload)
                except Exception as e:  # noqa: BLE001 — export must not raise
                    self.export_failures += 1
                    if self._exported is not None:
                        self._exported.labels(outcome="error").inc(n)
                    jlog("otlp_export_error", endpoint=self.endpoint,
                         error=str(e)[:200], spans=n)
                else:
                    if self._exported is not None:
                        self._exported.labels(outcome="ok").inc(n)
            finally:
                with self._cv:
                    self._inflight = 0
                    self._cv.notify_all()

    def _http_post(self, endpoint: str, payload: dict) -> None:
        body = json.dumps(payload, separators=(",", ":")).encode()
        req = urllib.request.Request(
            endpoint, data=body,
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            resp.read()


def exporter_from_env(service_name: str, exported=None,
                      dropped=None) -> Optional[OtlpExporter]:
    """Build the process exporter iff ``LLMK_OTLP_ENDPOINT`` is set."""
    endpoint = os.environ.get(OTLP_ENDPOINT_ENV, "").strip()
    if not endpoint:
        return None
    return OtlpExporter(endpoint, service_name=service_name,
                        exported=exported, dropped=dropped)
