"""Prometheus text-format metrics (the port's copy of
``llms_on_kubernetes_tpu/server/metrics.py``).

The registry, the metric kinds and the serving series keep the JAX
module's names, help strings, label names and buckets, so the charts'
scrape, alerts, dashboards and autoscalers read a port replica as they
read a JAX one. Only the series the port feeds are here: the adapter
family comes with the slice that ports LoRA.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

# stamped once at import: every exposition of this process reports the same
# start time, and the uptime is derived from it at scrape time
_PROCESS_START_WALL = time.time()


def escape_label_value(v: str) -> str:
    """Exposition escaping of a label VALUE: backslash, double quote and
    newline (model names are operator input)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _label_str(names: tuple, values: tuple) -> str:
    return ",".join(f'{n}="{escape_label_value(v)}"' for n, v in zip(names, values))


class _LabeledValue:
    """One child series of a labeled Counter or Gauge."""

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def set(self, v: float) -> None:
        self.value = v


class _Metric:
    """A scalar series, or with ``label_names`` a parent whose children are
    keyed by label values (``labels(**kv)`` makes one on first use)."""

    kind = "untyped"

    def __init__(self, name: str, help_: str, registry: "Registry",
                 label_names: tuple[str, ...] = ()):
        self.name, self.help = name, help_
        self.value = 0.0
        self.label_names = tuple(label_names)
        self._children: dict[tuple[str, ...], _LabeledValue] = {}
        registry._add(self)

    def labels(self, **kv: str) -> _LabeledValue:
        key = tuple(str(kv[n]) for n in self.label_names)
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = _LabeledValue()
        return child

    def render(self) -> str:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.kind}"]
        if not self.label_names:
            out.append(f"{self.name} {self.value}")
        else:
            for key in sorted(self._children):
                lbl = _label_str(self.label_names, key)
                out.append(f"{self.name}{{{lbl}}} {self._children[key].value}")
        return "\n".join(out) + "\n"


class Counter(_Metric):
    kind = "counter"

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge(_Metric):
    kind = "gauge"

    def set(self, v: float) -> None:
        self.value = v


class CallbackGauge(Gauge):
    """A gauge recomputed by ``fn()`` at every render; a failing callback
    keeps the previous value (a scrape must not fail on it)."""

    def __init__(self, name: str, help_: str, registry: "Registry",
                 fn: Callable[[], float]):
        super().__init__(name, help_, registry)
        self._fn = fn

    def render(self) -> str:
        try:
            self.value = float(self._fn())
        except Exception:  # keep the last value: a scrape never fails on it
            pass
        return super().render()


class _HistogramSeries:
    """One histogram series: bucket counts, sum and count."""

    def __init__(self, buckets: tuple[float, ...]):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)
        self.total = 0.0
        self.n = 0

    def observe(self, v: float) -> None:
        self.total += v
        self.n += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def _render_series(self, name: str, labels: str) -> list[str]:
        pre = labels + "," if labels else ""
        out = []
        acc = 0
        for i, b in enumerate(self.buckets):
            acc += self.counts[i]
            out.append(f'{name}_bucket{{{pre}le="{b}"}} {acc}')
        acc += self.counts[-1]
        out.append(f'{name}_bucket{{{pre}le="+Inf"}} {acc}')
        suffix = f"{{{labels}}}" if labels else ""
        out.append(f"{name}_sum{suffix} {self.total}")
        out.append(f"{name}_count{suffix} {self.n}")
        return out


class Histogram(_HistogramSeries):
    """A scalar or labeled histogram (``labels(**kv)`` as in _Metric)."""

    def __init__(self, name: str, help_: str, buckets: tuple[float, ...],
                 registry: "Registry", label_names: tuple[str, ...] = ()):
        super().__init__(tuple(sorted(buckets)))
        self.name, self.help = name, help_
        self.label_names = tuple(label_names)
        self._children: dict[tuple[str, ...], _HistogramSeries] = {}
        registry._add(self)

    def labels(self, **kv: str) -> _HistogramSeries:
        key = tuple(str(kv[n]) for n in self.label_names)
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = _HistogramSeries(self.buckets)
        return child

    def render(self) -> str:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        if not self.label_names:
            out += self._render_series(self.name, "")
        else:
            for key in sorted(self._children):
                out += self._children[key]._render_series(
                    self.name, _label_str(self.label_names, key))
        return "\n".join(out) + "\n"


class Registry:
    def __init__(self) -> None:
        self._metrics: list = []
        self._lock = threading.Lock()

    def _add(self, m) -> None:
        with self._lock:
            self._metrics.append(m)

    def render(self) -> str:
        with self._lock:
            return "".join(m.render() for m in self._metrics)


def build_info_metrics(registry: Registry, backend: str, role: str = "both") -> dict:
    """The identity and lifetime series every exposition carries:
    ``llm_build_info`` (the JAX labels; ``jax`` is "none" here, the port
    runs no JAX, and ``backend`` names the card: "gpu", or "cpu"),
    ``llm_process_start_time_seconds`` and ``llm_process_uptime_seconds``."""
    from llms_on_kubernetes_tpu_torch import __version__

    info = Gauge("llm_build_info",
                 "Build/runtime identity of this process (value is always 1)",
                 registry, label_names=("version", "jax", "backend", "role"))
    info.labels(version=__version__, jax="none", backend=backend, role=role).set(1)
    start = Gauge("llm_process_start_time_seconds", "Unix time this process started",
                  registry)
    start.set(round(_PROCESS_START_WALL, 3))
    uptime = CallbackGauge(
        "llm_process_uptime_seconds", "Seconds since process start (recomputed at scrape)",
        registry, lambda: round(time.time() - _PROCESS_START_WALL, 3))
    return {"build_info": info, "start_time": start, "uptime": uptime}


def process_age_s() -> float:
    """Seconds since this process imported the module (cold-start "ready")."""
    return time.time() - _PROCESS_START_WALL


def trace_export_metrics(registry: Registry) -> dict:
    """Tail-sampled OTLP span-export accounting (the JAX
    ``trace_export_metrics``): a trace that is not exported is counted
    dropped, by reason, never silently discarded."""
    exported = Counter(
        "llm_trace_spans_exported_total",
        "Spans handed to the OTLP exporter by outcome (ok = accepted by "
        "the collector, error = POST failed after the trace was already "
        "sampled in)", registry, label_names=("outcome",))
    dropped = Counter(
        "llm_trace_dropped_total",
        "Finished traces not exported, by reason (sampled_out = tail "
        "sampler's probabilistic drop of a boring trace, queue_full = "
        "exporter backpressure, disabled = no LLMK_OTLP_ENDPOINT)",
        registry, label_names=("reason",))
    # pre-seeded, so the series exist before the first drop or export
    exported.labels(outcome="ok")
    dropped.labels(reason="sampled_out")
    return {"trace_spans_exported": exported, "trace_dropped": dropped}


def engine_metrics(registry: Registry) -> dict:
    """The serving series the port's server feeds (the JAX set's names)."""
    m = {
        "deadline_exceeded": Counter(
            "llm_deadline_exceeded_total",
            "Requests shed at their end-to-end deadline, by phase: "
            "queue=expired while waiting (never admitted), "
            "decode=aborted in flight",
            registry, label_names=("phase",)),
        "requests_total": Counter("llm_requests_total", "Requests received", registry),
        "requests_finished": Counter(
            "llm_requests_finished_total", "Requests finished", registry),
        "tokens_generated": Counter(
            "llm_tokens_generated_total", "Output tokens sampled", registry),
        "prompt_tokens": Counter(
            "llm_prompt_tokens_total", "Prompt tokens prefilled", registry),
        "preemptions": Counter(
            "llm_preemptions_total", "Requests preempted for KV memory", registry),
        "ttft": Histogram(
            "llm_ttft_seconds", "Time to first token",
            (0.01, 0.025, 0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0), registry,
            label_names=("model",)),
        "e2e_latency": Histogram(
            "llm_e2e_latency_seconds", "Request latency, submit to finish",
            (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0),
            registry, label_names=("model",)),
        "decode_step": Histogram(
            "llm_decode_step_seconds", "Per-decode-step latency",
            (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.5), registry,
            label_names=("model",)),
        "batch_occupancy": Gauge(
            "llm_decode_batch_occupancy", "Active decode slots", registry),
        "kv_pages_used": Gauge("llm_kv_pages_used", "KV pages allocated", registry),
        "waiting": Gauge(
            "llm_waiting_requests", "Requests queued for admission", registry),
        "queue_depth": Gauge(
            "llm_queue_depth",
            "Requests queued for admission, per served model and serving "
            "role (the replica-autoscaling signal; the prefill pool "
            "scales on its own role's series)",
            registry, label_names=("model", "role")),
        "cold_start": Histogram(
            "llm_cold_start_seconds",
            "Startup phase durations: compile=warmup executable builds, "
            "load=checkpoint load + engine init, mesh=distributed init + "
            "device mesh, ready=process start to serving",
            (0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 30.0, 60.0, 120.0, 180.0, 300.0, 600.0),
            registry, label_names=("phase",)),
        "prefix_hit_tokens": Gauge(
            "llm_prefix_cache_hit_tokens_total",
            "Prompt tokens served from the prefix cache", registry),
        "engine_state": Gauge(
            "llm_engine_state",
            "Serving lifecycle: 0=loading 1=serving 2=draining 3=wedged", registry),
        "tenant_admitted": Counter(
            "llm_tenant_admitted_total",
            "Requests admitted into a decode slot, by fair-queue tenant "
            "and priority class (first admissions only; a preemption "
            "round trip is not new throughput)",
            registry, label_names=("tenant", "priority")),
        "tenant_queue_wait": Histogram(
            "llm_tenant_queue_wait_seconds",
            "Submit-to-admission wait per fair-queue tenant — the "
            "fairness signal (one tenant's p99 diverging from the rest "
            "means its weight/priority is starving it)",
            (0.005, 0.025, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0),
            registry, label_names=("tenant",)),
        "tenant_shed": Counter(
            "llm_tenant_shed_total",
            "Requests refused with 429 by tenant, priority, and reason "
            "(overloaded = queue-depth backpressure / brownout, "
            "rate_limited = the tenant's own token-bucket limits)",
            registry, label_names=("tenant", "priority", "reason")),
        "kv_host_cache_hits": Counter(
            "llm_kv_host_cache_hits_total",
            "KV pages served from the host-RAM offload tier to a "
            "resuming/returning session (each page skips page_size "
            "tokens of re-prefill)", registry),
        "kv_host_cache_misses": Counter(
            "llm_kv_host_cache_misses_total",
            "Admissions whose prefix found no host-tier pages beyond "
            "the device cache", registry),
        "kv_host_cache_evictions": Counter(
            "llm_kv_host_cache_evictions_total",
            "Host-tier KV pages dropped by LRU capacity pressure "
            "(sustained high rate vs hits = thrash; grow "
            "kvHostCacheGB)", registry),
        "kv_upload": Histogram(
            "llm_kv_upload_seconds",
            "Host->device KV page upload latency per resuming "
            "admission (stage + dispatch of the re-upload that replaces "
            "re-prefill)",
            (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 1.0),
            registry),
        "kv_bytes_per_token": Gauge(
            "llm_kv_bytes_per_token",
            "Device KV-cache bytes per cached token across all layers, "
            "both K and V, scales included (int8 pages roughly halve "
            "this vs bf16)", registry),
        "mfu": Gauge(
            "llm_mfu_ratio",
            "Model FLOPs utilization over the trailing minute: achieved "
            "FLOP/s (2 * active params per planned token, wasted rows "
            "included) over the accelerator's nominal dense peak "
            "(PaLM-style MFU; on CPU smoke runs the peak is a nominal "
            "fallback, so treat the ratio as plumbing, not hardware "
            "truth)", registry),
        "mbu": Gauge(
            "llm_mbu_ratio",
            "Memory-bandwidth utilization over the trailing minute: "
            "achieved HBM traffic (weight streaming per fused window + "
            "KV page writes) over the accelerator's nominal peak "
            "bytes/s — the decode-side twin of llm_mfu_ratio", registry),
        "chip_seconds": Counter(
            "llm_chip_seconds_total",
            "Goodput-ledger chip time by outcome: prefill/decode = "
            "attributed to live streams, spec_waste = rejected "
            "speculative tails, early_exit = masked/abandoned fused-"
            "window rows, idle = device gaps between dispatches; the "
            "phases sum to the ledger's wall-clock window "
            "(conservation is CI-gated)",
            registry, label_names=("phase",)),
        "tenant_chip_seconds": Counter(
            "llm_tenant_chip_seconds_total",
            "Chip time attributed per fair-queue tenant and ledger "
            "phase — the chargeback / capacity-planning series (waste "
            "phases bill the tenant whose speculation or early exit "
            "burned the window)",
            registry, label_names=("tenant", "phase")),
        "spec_drafted": Counter(
            "llm_spec_drafted_total",
            "Draft tokens proposed into speculative verify windows "
            "(prompt-lookup or draft-model tier; excludes the bonus "
            "token every window commits regardless)", registry),
        "spec_accepted": Counter(
            "llm_spec_accepted_total",
            "Draft tokens accepted by the target model's verify pass "
            "(exact-match under greedy decoding)", registry),
        "spec_accept_ratio": Gauge(
            "llm_spec_accept_ratio",
            "Lifetime accepted/drafted ratio of speculative decoding "
            "(0 when speculation is off or no drafts were proposed; a "
            "low ratio on steady traffic means the drafter does not fit "
            "the workload — the engine demotes drafting adaptively)",
            registry),
        "adapter_cache_hits": Counter(
            "llm_adapter_cache_hits_total",
            "LoRA adapter requests that found their adapter already "
            "resident in a device slot", registry),
        "adapter_cache_misses": Counter(
            "llm_adapter_cache_misses_total",
            "LoRA adapter requests that had to load/upload their adapter "
            "into a device slot", registry),
        "adapter_cache_evictions": Counter(
            "llm_adapter_cache_evictions_total",
            "Resident LoRA adapters evicted from a device slot to make "
            "room (sustained high rate = cache thrash; add slots)",
            registry),
        "adapter_load": Histogram(
            "llm_adapter_load_seconds",
            "LoRA adapter load+upload latency on a cache miss "
            "(host-cached reloads are upload-only)",
            (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0),
            registry),
        "decode_steps_per_dispatch": Histogram(
            "llm_decode_steps_per_dispatch",
            "Decode steps consumed per device dispatch (fused multi-step "
            "decode window depth; 1 = the single-step path)",
            (1.0, 2.0, 4.0, 8.0, 16.0, 32.0), registry),
        "decode_early_exit": Counter(
            "llm_decode_early_exit_total",
            "Planned decode row-steps wasted because a request finished "
            "or aborted mid-window (fused multi-step decode early-exit "
            "accounting; a high rate vs llm_tokens_generated_total means "
            "decode_steps is oversized for typical generations)",
            registry),
        "auto_profile": Counter(
            "llm_auto_profile_total",
            "Automatic bounded profiler captures triggered by the "
            "step-time anomaly watchdog (EWMA + z-score over per-"
            "dispatch device time; rate-limited by anomalyProfile "
            "cooldown)",
            registry, label_names=("reason",)),
    }
    m.update(trace_export_metrics(registry))
    # the auto-profile counter's only reason, seeded at zero: a labeled
    # counter with no children exports no samples
    m["auto_profile"].labels(reason="step_anomaly")
    return m
