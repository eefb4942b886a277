"""Goodput ledger: per-request chip-time attribution + MFU/MBU accounting
(counterpart of ``llms_on_kubernetes_tpu/engine/ledger.py``, kept line for
line: the conservation identity, the 2 * N FLOPs a token, the weight bytes
from ``model_config.dtype`` alone, ``utilization``'s clip at 1.0).

The engine batches many requests into one device dispatch, fuses K-token
decode windows and early-exits masked rows, so wall-clock and per-stream
latency no longer say where chip time went. This module answers that
with an explicit accounting identity:

    attributed (prefill + decode) + wasted (spec_waste + early_exit)
      + idle  ==  ledger window (first launch -> last completion)

Every dispatch the engine launches is recorded here with its launch and
completion timestamps. Because the device executes dispatches serially,
the busy interval attributable to dispatch N is the segment from the
previous dispatch's completion (or N's own launch, whichever is later)
to N's completion: segments never overlap, gaps between them are idle,
and the sum conserves wall time by construction. Each segment is then
split across the rows that rode the dispatch, weighted by planned window
tokens: consumed tokens bill to the stream's ``prefill``/``decode``
phase, and masked or abandoned rows to ``early_exit`` (the port has no
speculation, so ``spec_waste`` stays 0) -- waste is still booked against
the request that caused it, but never counted as useful stream time.

FLOPs/bytes ride the same records (2 * active params per token for
compute; weight + KV-page traffic for memory), giving the
``llm_mfu_ratio`` / ``llm_mbu_ratio`` gauges. The peaks come from the
card's name (``torch.cuda.get_device_name``) through ``_PEAK_TABLE``: an
H100 SXM's dense bf16 989 TFLOP/s and 3.35 TB/s, an H100 PCIe's 756
TFLOP/s and 2.0 TB/s; ``LLMK_PEAK_TFLOPS`` / ``LLMK_PEAK_GBPS`` win over
the table. On the CPU the peak is the JAX module's nominal fallback, so
the ratios are plumbing there, not hardware truth. The weight bytes count
``model_config.dtype``'s width whatever the weights' storage is (int8
weights still count bf16 bytes), as the JAX ledger counts them.

:class:`StepAnomalyDetector` watches the same per-dispatch durations
with an EWMA mean/variance + z-score test; the serving loop turns a
sustained anomaly into ONE bounded, rate-limited profiler capture
(``llm_auto_profile_total{reason="step_anomaly"}``) while the slowness
is still live.
"""

from __future__ import annotations

import collections
import math
import os
import threading
from typing import Any, Optional

PHASES = ("prefill", "decode", "spec_waste", "early_exit")
WASTE_PHASES = ("spec_waste", "early_exit")

# device name (lowercased, spaces removed) substring -> (peak dense bf16
# FLOP/s, peak HBM bytes/s). Nominal public figures, the H100's ahead of
# the TPU kinds the JAX table holds; overridable via LLMK_PEAK_TFLOPS /
# LLMK_PEAK_GBPS for hardware the table has never heard of.
_PEAK_TABLE = (
    ("h100pcie", (756e12, 2.0e12)),
    ("h100", (989e12, 3.35e12)),      # SXM: "NVIDIA H100 80GB HBM3"
    ("v6e", (918e12, 1640e9)),
    ("v5p", (459e12, 2765e9)),
    ("v5e", (197e12, 819e9)),
    ("v5litepod", (197e12, 819e9)),
    ("v4", (275e12, 1228e9)),
    ("v3", (123e12, 900e9)),
)
# CPU: a deliberately small nominal peak so smoke MFU is a sane nonzero
# ratio instead of ~0 against an accelerator's peak. Never a card's.
_PEAK_FALLBACK = (5e11, 5e10)


def detect_peak(device=None) -> tuple[float, float]:
    """(peak FLOP/s, peak bytes/s) for ``device`` (default: the card when
    there is one, else the CPU).

    Env overrides win; else the card's name (``torch.cuda.
    get_device_name``) maps through the table; the CPU takes the nominal
    fallback. A card the table does not name raises, naming it: its MFU
    and MBU against the CPU's peaks would be off by orders of magnitude."""
    flops = os.environ.get("LLMK_PEAK_TFLOPS")
    gbps = os.environ.get("LLMK_PEAK_GBPS")
    if flops and gbps:
        try:
            return float(flops) * 1e12, float(gbps) * 1e9
        except ValueError:
            pass
    import torch

    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
    if dev.type != "cuda":
        return _PEAK_FALLBACK
    name = torch.cuda.get_device_name(dev)
    kind = name.lower().replace(" ", "")
    for key, peaks in _PEAK_TABLE:
        if key in kind:
            return peaks
    raise RuntimeError(
        f"no peak FLOP/s and bytes/s known for {name!r}: set LLMK_PEAK_TFLOPS and "
        f"LLMK_PEAK_GBPS to its dense bf16 rate and memory rate, or LLMK_LEDGER=0")


def _active_params(cfg: Any) -> int:
    """Parameters touched per token: for MoE, only the routed experts'
    share of the expert MLPs counts (num_params sums all experts)."""
    n = int(cfg.num_params)
    if getattr(cfg, "is_moe", False) and cfg.num_experts > 0:
        d, f, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
        all_mlp = 3 * d * f * cfg.num_experts
        active_mlp = 3 * d * f * cfg.num_experts_per_tok
        n -= L * (all_mlp - active_mlp)
    return n


class StepAnomalyDetector:
    """EWMA + z-score detector over per-dispatch device time.

    ``observe(duration_s, now)`` returns True exactly when a trigger
    fires: z-score above ``threshold`` for ``sustain`` consecutive
    samples, after ``warmup`` samples established a baseline, and not
    within ``cooldown_s`` of the previous trigger (the rate limit the
    auto-profiler relies on). Anomalous samples do NOT update the EWMA —
    otherwise a sustained slowdown would teach the baseline to accept
    itself before the sustain count is reached."""

    def __init__(self, threshold: float = 4.0, sustain: int = 3,
                 cooldown_s: float = 600.0, warmup: int = 12,
                 alpha: float = 0.05):
        self.threshold = float(threshold)
        self.sustain = max(1, int(sustain))
        self.cooldown_s = float(cooldown_s)
        self.warmup = max(2, int(warmup))
        self.alpha = float(alpha)
        self._mean = 0.0
        self._var = 0.0
        self._n = 0
        self._streak = 0
        self._cooldown_until: Optional[float] = None
        self.triggers = 0

    def zscore(self, x: float) -> float:
        if self._n < self.warmup:
            return 0.0
        # variance floor: a perfectly steady baseline (tests, mocked
        # clocks) must still register a spike instead of dividing by ~0
        std = math.sqrt(max(self._var, (0.05 * self._mean) ** 2, 1e-12))
        return (x - self._mean) / std

    def observe(self, duration_s: float, now: float) -> bool:
        z = self.zscore(duration_s)
        anomalous = self._n >= self.warmup and z > self.threshold
        if anomalous:
            self._streak += 1
        else:
            self._streak = 0
            d = duration_s - self._mean
            a = self.alpha if self._n >= self.warmup else max(
                self.alpha, 1.0 / (self._n + 1))
            self._mean += a * d
            self._var = (1.0 - a) * (self._var + a * d * d)
            self._n += 1
        if self._streak < self.sustain:
            return False
        if (self._cooldown_until is not None
                and now < self._cooldown_until):
            return False
        self._cooldown_until = now + self.cooldown_s
        self._streak = 0
        self.triggers += 1
        return True


class GoodputLedger:
    """Chip-time attribution for one engine (see module docstring).

    All mutation happens on the engine thread via :meth:`record`;
    readers (the serving loop's metrics drain, chip_smoke, /metrics
    callbacks) take the same lock through :meth:`snapshot` /
    :meth:`utilization`, so a scrape never sees a half-applied record.
    """

    def __init__(self, model_config: Any,
                 detector: Optional[StepAnomalyDetector] = None,
                 peak_flops: Optional[float] = None,
                 peak_bytes_s: Optional[float] = None,
                 device=None):
        pf, pb = (peak_flops, peak_bytes_s)
        if pf is None or pb is None:
            dpf, dpb = detect_peak(device)
            pf, pb = pf or dpf, pb or dpb
        self.peak_flops = float(pf)
        self.peak_bytes_s = float(pb)
        params = _active_params(model_config)
        dtype_bytes = 2 if "16" in str(model_config.dtype) else 4
        # compute: the standard 2*N MAC count per token (PaLM appendix B;
        # attention-score FLOPs are context-dependent and O(few %) at
        # serving batch sizes, so the weight term is the estimate)
        self.flops_per_token = 2.0 * params
        self.param_bytes = float(params * dtype_bytes)
        # KV traffic per token-step: one K+V page-write plus (amortized)
        # the read of its own history — bounded below by the write
        self.kv_bytes_per_token = float(
            2 * model_config.num_layers * model_config.kv_dim * dtype_bytes)

        self.detector = detector
        self._lock = threading.Lock()
        self._last_complete: Optional[float] = None
        self.t_first: Optional[float] = None
        self.t_last: Optional[float] = None
        self.dispatches = 0
        self.busy_ms = 0.0
        self.idle_ms = 0.0
        self.phase_ms: dict[str, float] = {p: 0.0 for p in PHASES}
        self.tenant_ms: dict[tuple[str, str], float] = {}
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.decode_tokens = 0
        self.prefill_tokens = 0
        self.anomaly_events = 0
        self._anomaly_pending = False
        # (t_done, duration_s, flops, bytes) of recent dispatches — the
        # rolling window the MFU/MBU gauges are computed over
        self._recent: "collections.deque[tuple]" = collections.deque(
            maxlen=2048)

    # -- recording (engine thread) -------------------------------------

    def record(self, t_launch: float, t_done: float,
               rows: list[tuple[Optional[Any], str, int]],
               window: int = 1) -> float:
        """Book one device dispatch.

        ``rows`` is ``[(request_or_None, phase, weight_tokens), ...]``
        — one entry per (slot, phase) share of the dispatch; a fused
        window row typically contributes a ``decode`` entry for its
        consumed tokens and a waste entry for its planned-minus-consumed
        tail. ``window`` is the fused step count K (weight-streaming
        traffic scales with it, not with batch width). Returns the busy
        segment duration in seconds."""
        rows = [(r, ph, int(w)) for r, ph, w in rows if w > 0]
        tok_w = sum(w for _r, _ph, w in rows)
        total_w = tok_w
        if not rows:
            # a dispatch whose every row was dropped (all slots finished
            # mid-flight) still burned chip time — book it as waste so
            # the conservation identity keeps holding
            rows = [(None, "early_exit", 1)]
            total_w = 1
        with self._lock:
            if self._last_complete is None:
                seg_start = t_launch
                self.t_first = t_launch
            else:
                seg_start = max(t_launch, self._last_complete)
                self.idle_ms += max(
                    0.0, (seg_start - self._last_complete)) * 1000.0
            dur = max(0.0, t_done - seg_start)
            if self._last_complete is None or t_done > self._last_complete:
                self._last_complete = t_done
            self.t_last = self._last_complete
            self.dispatches += 1
            self.busy_ms += dur * 1000.0

            for req, phase, w in rows:
                share_ms = (dur * 1000.0 * w / total_w) if total_w else 0.0
                self.phase_ms[phase] += share_ms
                tenant = getattr(req, "tenant", "") or ""
                key = (tenant, phase)
                self.tenant_ms[key] = self.tenant_ms.get(key, 0.0) + share_ms
                if req is not None:
                    req.chip_ms[phase] = req.chip_ms.get(phase, 0.0) + share_ms
                if phase == "decode":
                    self.decode_tokens += w
                elif phase == "prefill":
                    self.prefill_tokens += w

            # planned rows are computed whether or not the stream keeps
            # them — wasted FLOPs are the whole point of measuring
            flops = self.flops_per_token * tok_w
            hbm = (self.param_bytes * max(1, int(window))
                   + self.kv_bytes_per_token * tok_w)
            self.flops += flops
            self.hbm_bytes += hbm
            self._recent.append((t_done, dur, flops, hbm))

            if self.detector is not None and dur > 0.0:
                if self.detector.observe(dur, t_done):
                    self.anomaly_events += 1
                    self._anomaly_pending = True
        return dur

    def reset(self) -> None:
        """Zero all accounting (a measurement window excludes warm-up
        dispatches this way). The detector's learned baseline survives —
        forgetting it would re-open the warmup window."""
        with self._lock:
            self._last_complete = None
            self.t_first = self.t_last = None
            self.dispatches = 0
            self.busy_ms = self.idle_ms = 0.0
            self.phase_ms = {p: 0.0 for p in PHASES}
            self.tenant_ms = {}
            self.flops = self.hbm_bytes = 0.0
            self.decode_tokens = self.prefill_tokens = 0
            self.anomaly_events = 0
            self._anomaly_pending = False
            self._recent.clear()

    def take_anomaly(self) -> bool:
        """True once per detector trigger (serving-loop poll)."""
        with self._lock:
            pending, self._anomaly_pending = self._anomaly_pending, False
            return pending

    # -- reading (any thread) ------------------------------------------

    def utilization(self, window_s: float = 60.0,
                    now: Optional[float] = None) -> tuple[float, float]:
        """(MFU, MBU) over the trailing ``window_s`` of dispatches."""
        with self._lock:
            if not self._recent:
                return 0.0, 0.0
            t_hi = now if now is not None else self._recent[-1][0]
            lo = t_hi - window_s
            ent = [e for e in self._recent if e[0] >= lo]
            if not ent:
                return 0.0, 0.0
            elapsed = max(t_hi - min(e[0] - e[1] for e in ent), 1e-9)
            mfu = sum(e[2] for e in ent) / (self.peak_flops * elapsed)
            mbu = sum(e[3] for e in ent) / (self.peak_bytes_s * elapsed)
            return min(mfu, 1.0), min(mbu, 1.0)

    def snapshot(self) -> dict:
        """Cumulative totals (ms / counts), for delta-draining into
        metrics and for a conservation check; ``flops``, ``hbm_bytes`` and
        ``busy_ms`` are raw, so a reader can compute an unclipped share."""
        with self._lock:
            attributed = self.phase_ms["prefill"] + self.phase_ms["decode"]
            wasted = sum(self.phase_ms[p] for p in WASTE_PHASES)
            window_ms = ((self.t_last - self.t_first) * 1000.0
                         if self.t_first is not None else 0.0)
            return {
                "phase_ms": dict(self.phase_ms),
                "attributed_ms": attributed,
                "wasted_ms": wasted,
                "idle_ms": self.idle_ms,
                "busy_ms": self.busy_ms,
                "window_ms": window_ms,
                "dispatches": self.dispatches,
                "flops": self.flops,
                "hbm_bytes": self.hbm_bytes,
                "decode_tokens": self.decode_tokens,
                "prefill_tokens": self.prefill_tokens,
                "anomaly_events": self.anomaly_events,
                "tenant_ms": dict(self.tenant_ms),
            }
