"""Deterministic fault injection for the serving spine (``LLMK_FAULT=``):
the port's copy of ``llms_on_kubernetes_tpu/faults.py`` (the same grammar,
names and ``claim`` / ``claim_n`` semantics), kept so the port imports
nothing of the JAX package.

The port wires the faults that apply to one replica on one card:
``engine_stall`` and ``slow_step`` at the harvester's completion
(``engine/engine.py``), ``queue_stall`` at admission, and
``flappy_replica``, ``slow_cold_start``, ``preempt_replica``,
``degraded_replica``, ``net_jitter``, ``kill_mid_stream``,
``kill_prefill_replica`` (armed at the serving transition of a
prefill-role server) and ``drop_handoff`` (claimed per pull on the decode
side) in the server (``server/openai_api.py``). ``overload_spike`` belongs
to the Python router and ``backend_hang`` to ``bench.py``; their entries
below describe the reference.

Every fault-tolerance path in this repo — entry-point timeouts, router
retries/breakers, the engine watchdog — is testable on CPU by flipping an
environment variable instead of waiting for real infrastructure to break.
The hooks are read from the environment *at call time*, so tests can
monkeypatch ``LLMK_FAULT`` (or pass it to a subprocess) without import-order
games, and production pays one ``os.environ.get`` per hook site.

Spec grammar::

    LLMK_FAULT="<name>[:<arg>][;<name>[:<arg>]...]"

Known fault names (each documented at its injection site):

- ``backend_hang``        — accelerator-backend initialization never
  returns (simulates a wedged TPU runtime).  Injected immediately before
  the first backend touch in ``bench.py``'s probe subprocess; the parent's
  hard timeout must convert it into a clean JSON error.
- ``engine_stall[:N]``    — the harvester never observes completion of the
  N-th (default: first) device step, simulating a hung device program.
  The engine watchdog must detect it and shed in-flight work.
- ``slow_step[:SECONDS]`` — every device-step completion is delayed by
  SECONDS (default 0.2), for pacing/timeout tests that need a slow but
  live device.
- ``queue_stall``         — the engine's admission loop refuses to admit
  while the flag is set: waiting requests age in the queue without ever
  being prefilled. Drives the deadline queue-shed path and the
  queue-depth-based 429 ``Retry-After`` estimate deterministically.
- ``flappy_replica[:PERIOD]`` — the server's readiness flaps: ``/ready``
  alternates between ``serving`` and 503 ``draining`` every PERIOD
  seconds (default 1.0) while the engine keeps serving. A cluster-level
  fault (replica joining/leaving endpoints repeatedly) for exercising
  router health-probe ejection/re-admission against a live server.
- ``slow_cold_start[:SECONDS]`` — server startup holds the replica in
  ``loading`` (readiness 503) for SECONDS (default 2.0) before serving:
  a compile-cache-miss cold start in miniature, so spike/scale-out tests
  see a realistically slow replica join.
- ``kill_mid_stream[:N_TOKENS]`` — the first in-process stream to deliver
  N_TOKENS (default 8) tokens severs its client socket abruptly (TCP
  RST), simulating a replica dying mid-generation. One-shot per process
  via :func:`claim` (like ``preempt_replica``): with several in-process
  replicas behind one router, exactly ONE stream is killed — the point is
  proving the router's journal resume splices the continuation from a
  surviving replica with zero client-visible drops.
- ``preempt_replica[:DELAY]`` — DELAY seconds (default 1.0) after a
  server starts serving, it receives a simulated spot-TPU preemption
  notice and begins the graceful drain (readiness 503, in-flight streams
  finish, no new admissions). One-shot per process via :func:`claim`:
  with several in-process replicas sharing the env (tests, bench),
  exactly ONE is preempted — the point is proving the survivors absorb
  its traffic with zero dropped streams.
- ``overload_spike[:LEVEL]`` — the Python router's QoS gate treats the
  gateway as already at brownout level LEVEL (default 2, clamped 0..3)
  regardless of the real queue-depth/burn-rate signals, so the
  shed-lowest-priority-first ladder is testable without generating real
  overload. See ``server/qos.py`` for the level -> action table.
- ``kill_prefill_replica[:DELAY]`` — DELAY seconds (default 1.0) after a
  ``prefill``-role server starts serving, it dies abruptly: readiness
  goes 503 AND in-flight/new prefill requests are refused (no graceful
  drain — a prefill pod crash, not a preemption notice). One-shot per
  process via :func:`claim`, and only prefill-role servers arm it: with
  a disaggregated fleet sharing one env, exactly ONE prefill replica is
  killed — the point is proving the router retries surviving prefill
  replicas or falls back to colocated serving with zero dropped streams.
- ``degraded_replica[:FACTOR]`` — the canonical GRAY failure: one
  server's streams decode at 1/FACTOR speed (default 8; inter-event
  pacing stretched in the delivery path) while ``/health`` and
  ``/ready`` keep answering green, so probe-based ejection never fires.
  One-shot per process via :func:`claim`: with several in-process
  replicas sharing the env, exactly ONE degrades — the point is proving
  the router's latency outlier detector quarantines it from in-band
  TTFT alone (the JAX package's server/outlier.py and chaos bench).
- ``net_jitter[:MS]`` — every stream event on EVERY replica sharing the
  env is delayed by a uniform random 0..MS ms (default 25): benign
  network/scheduler latency noise. The outlier detector's cv/spread
  floors must absorb this without ejecting anyone (the false-positive
  half of the gray-failure story).
- ``drop_handoff[:N]`` — the first N (default 1) KV-handoff ingests on a
  ``decode``-role server pretend every handed-off page is missing (the
  pull is skipped entirely), forcing the counted full-re-prefill
  degraded path. Claimed per-ingest via :func:`claim_n` so N spans the
  whole process, however many decode replicas share it — the point is
  proving a dropped handoff is never a client-visible error.

Routers do not read ``LLMK_FAULT``, with one documented exception:
``overload_spike`` above, a brownout-ladder hook for the Python router
only (the native router's overload behavior is exercised through real
config-driven thresholds). All other router faults (connection resets,
stalled responses) are injected by the fake upstream backends in the test
fixtures, which is both more deterministic and closer to the real failure.
"""

from __future__ import annotations

import os
import threading
import time

ENV_VAR = "LLMK_FAULT"


def _parse(raw: str) -> dict[str, str]:
    out: dict[str, str] = {}
    for part in raw.split(";"):
        part = part.strip()
        if not part:
            continue
        name, _, arg = part.partition(":")
        out[name.strip()] = arg.strip()
    return out


def get(name: str) -> str | None:
    """Arg string of fault ``name`` ("" if given bare), or None if inactive."""
    return _parse(os.environ.get(ENV_VAR, "")).get(name)


def is_active(name: str) -> bool:
    return get(name) is not None


def get_float(name: str, default: float) -> float | None:
    """Float arg of fault ``name`` (``default`` if bare); None if inactive."""
    arg = get(name)
    if arg is None:
        return None
    try:
        return float(arg) if arg else default
    except ValueError:
        return default


def inject_hang(name: str, hang_s: float = 3600.0) -> None:
    """If fault ``name`` is active, sleep far past any caller's deadline.

    The caller is expected to wrap the hanging code path in a hard timeout
    (subprocess timeout, watchdog) — the injected hang proves that timeout
    actually fires.  Sleeps in 1 s slices, re-checking the env each slice,
    so signals still interrupt and an in-process test's monkeypatch
    teardown releases a hung background thread instead of stranding it.
    """
    if not is_active(name):
        return
    deadline = time.monotonic() + hang_s
    while time.monotonic() < deadline and is_active(name):
        time.sleep(1.0)


def inject_delay(name: str, default_s: float) -> None:
    """If fault ``name`` is active, sleep its arg (or ``default_s``)."""
    s = get_float(name, default_s)
    if s is not None and s > 0:
        time.sleep(s)


# one-shot faults: first in-process claimer wins (see preempt_replica)
_claimed: set[str] = set()
_claim_counts: dict[str, int] = {}
_claim_lock = threading.Lock()


def claim(name: str) -> bool:
    """True exactly once per process for an active fault ``name``.

    Lets N in-process replicas share one ``LLMK_FAULT`` env while only
    the first to reach the hook acts on it — a single-victim fault.
    """
    if not is_active(name):
        return False
    with _claim_lock:
        if name in _claimed:
            return False
        _claimed.add(name)
        return True


def claim_n(name: str, default_n: float = 1.0) -> bool:
    """True for the first N claims of an active fault ``name``, where N
    is the fault's arg (``default_n`` if bare). The N-shot sibling of
    :func:`claim` — ``drop_handoff:3`` drops exactly three handoffs
    process-wide, however many in-process replicas share the env."""
    n = get_float(name, default_n)
    if n is None:
        return False
    with _claim_lock:
        used = _claim_counts.get(name, 0)
        if used >= int(n):
            return False
        _claim_counts[name] = used + 1
        return True


def reset_claims() -> None:
    """Forget one-shot claims (test isolation between cases)."""
    with _claim_lock:
        _claimed.clear()
        _claim_counts.clear()
