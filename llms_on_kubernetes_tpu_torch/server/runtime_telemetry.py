"""Device/runtime telemetry: device memory, compile cost, the step's
device/host split (counterpart of
``llms_on_kubernetes_tpu/server/runtime_telemetry.py``, same series).

The serving metrics in :mod:`server.metrics` describe *requests*; this
module describes the *runtime underneath them*:

- ``llm_device_memory_bytes{device,kind}``: on a card, the caching
  allocator's statistics (``torch.cuda.memory_stats``: ``bytes_in_use``
  from ``allocated_bytes.all.current``, ``peak_bytes_in_use``,
  ``bytes_reserved``, ``num_allocs``) and ``bytes_limit``, the card's total
  memory from ``torch.cuda.mem_get_info``. The CPU has no allocator
  statistics, so there kind ``live_buffer_bytes`` carries the live-bytes
  figure, as the JAX module's CPU fallback does.
- ``llm_device_live_buffer_bytes{device}``: bytes of live tensors: the
  allocator's allocated bytes on a card, the engine's own tensors (weights,
  pools, penalty counts; ``live_bytes``) on the CPU.
- Compile counters: the JAX series count XLA compiles; the port's compile
  events are its first-use ``nvcc`` builds and its CUDA graph captures
  (``kernels.COMPILES``), counted and timed under the same names,
  ``llm_jit_compiles_total`` / ``llm_jit_compile_seconds_total``
  (``llm_jit_cache_hits_total`` stays 0: there is no persistent cache).
- ``record_step_split``: one engine step's device-wait and host seconds.

Nothing here may take ``/metrics`` down: a refresh failure is swallowed.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from llms_on_kubernetes_tpu_torch import kernels
from llms_on_kubernetes_tpu_torch.server.metrics import Counter, Gauge, Registry

# torch.cuda.memory_stats() key -> the JAX memory_stats() name it reports as
_CUDA_STAT_KEYS = (
    ("allocated_bytes.all.current", "bytes_in_use"),
    ("allocated_bytes.all.peak", "peak_bytes_in_use"),
    ("reserved_bytes.all.current", "bytes_reserved"),
    ("allocation.all.allocated", "num_allocs"),
)


def runtime_metrics(registry: Registry) -> dict:
    """The runtime telemetry metric set (the JAX module's names, help and
    labels; registered unconditionally so the series exist on every
    scrape)."""
    return {
        "device_memory": Gauge(
            "llm_device_memory_bytes",
            "Per-device allocator statistics from Device.memory_stats(); "
            "kind=live_buffer_bytes is the CPU-backend fallback",
            registry, label_names=("device", "kind")),
        "live_buffers": Gauge(
            "llm_device_live_buffer_bytes",
            "Bytes of live jax arrays per device (backend-independent)",
            registry, label_names=("device",)),
        "jit_compiles": Counter(
            "llm_jit_compiles_total",
            "Backend (XLA) compiles observed — each is a jit compile-cache "
            "miss that stalled work behind compilation", registry),
        "jit_compile_seconds": Counter(
            "llm_jit_compile_seconds_total",
            "Cumulative seconds spent in backend (XLA) compilation",
            registry),
        "jit_cache_hits": Counter(
            "llm_jit_cache_hits_total",
            "Persistent compilation-cache hits (0 unless the cache is "
            "enabled)", registry),
        "step_device_seconds": Counter(
            "llm_step_device_seconds_total",
            "Engine-step seconds spent blocked on device work "
            "(dispatch waits + device->host reads)", registry),
        "step_host_seconds": Counter(
            "llm_step_host_seconds_total",
            "Engine-step seconds spent in host-side scheduling "
            "(step wall time minus device wait)", registry),
    }


class RuntimeTelemetry:
    """Samples the PyTorch runtime of one engine's device into a
    :func:`runtime_metrics` set. ``refresh()`` runs at scrape time and is
    cheap (a dict read and the compile events since the last scrape);
    ``live_bytes`` (the CPU's live-bytes figure) is the server's."""

    def __init__(self, registry: Registry, device: torch.device,
                 live_bytes: Optional[Callable[[], float]] = None):
        self.metrics = runtime_metrics(registry)
        self.device = torch.device(device)
        self.live_bytes = live_bytes
        # compile events before this server existed (the kernel builds and
        # the first graph capture of its engine) count once, at the first
        # refresh
        self._compiles_seen = 0

    def refresh(self) -> None:
        """Re-sample device memory and fold in new compile events. Never
        raises."""
        try:
            self._refresh_compiles()
            self._refresh_device_memory()
        except Exception:
            pass

    def _refresh_compiles(self) -> None:
        events = kernels.COMPILES[self._compiles_seen:]
        self._compiles_seen += len(events)
        for _kind, seconds in events:
            self.metrics["jit_compiles"].inc()
            self.metrics["jit_compile_seconds"].inc(max(0.0, seconds))

    def _refresh_device_memory(self) -> None:
        mem = self.metrics["device_memory"]
        name = str(self.device)
        if self.device.type == "cuda":
            stats = torch.cuda.memory_stats(self.device)
            for key, kind in _CUDA_STAT_KEYS:
                v = stats.get(key)
                if isinstance(v, (int, float)):
                    mem.labels(device=name, kind=kind).set(float(v))
            _free, total = torch.cuda.mem_get_info(self.device)
            mem.labels(device=name, kind="bytes_limit").set(float(total))
            self.metrics["live_buffers"].labels(device=name).set(
                float(stats.get("allocated_bytes.all.current", 0)))
        else:
            live = float(self.live_bytes()) if self.live_bytes is not None else 0.0
            self.metrics["live_buffers"].labels(device=name).set(live)
            mem.labels(device=name, kind="live_buffer_bytes").set(live)

    def record_step_split(self, step_s: float, device_s: float) -> None:
        """Fold one engine step's device-wait / host split into the
        counters (``device_s``: the engine's device-wait delta over the
        step, clamped to the step)."""
        device_s = max(0.0, min(device_s, step_s))
        self.metrics["step_device_seconds"].inc(device_s)
        self.metrics["step_host_seconds"].inc(max(0.0, step_s - device_s))
