"""The port's goodput ledger, its anomaly detector, the engine's booking
and the server's chip-time surface, against the JAX package on the CPU.

- ``GoodputLedger``: the same random ``record()`` sequences (numpy seeds,
  explicit peaks) through the JAX ledger and the port's give equal
  ``snapshot()``s, ``utilization()``s and per-request ``chip_ms``, exactly
  (the arithmetic is the same Python float arithmetic); the JAX unit cases
  (fused windows, a rejected tail, an all-dropped dispatch, conservation
  under fuzz, the clip at 1.0, reset) run on the port's.
- ``detect_peak``: the env overrides win, the H100 table is read from the
  card's name (``torch.cuda.get_device_name``, stubbed here), the CPU takes
  the JAX fallback, and a card the table does not name raises (it never
  takes the CPU's peaks).
- ``StepAnomalyDetector``: the JAX cases with an injected clock (never the
  wall clock), and the same random durations trigger the JAX detector and
  the port's at the same samples.
- Engine (debug-tiny, float32): attributed + wasted + idle equals the
  ledger's window within 1e-6 relative, the requests' ``chip_ms`` sum to
  the attributed share, windows book their planned-but-unused tokens as
  "early_exit", greedy streams are bit-identical with the ledger on and
  off, and ``LLMK_LEDGER=0`` turns it off.
- Server: ``usage.chip_ms``, ``X-LLMK-Chip-Ms``, the trace spans' and
  flight frames' chip time and the /metrics series; an anomaly (synthetic
  dispatch times on the ledger, no wall clock) takes exactly one capture,
  rate-limited by the detector's cooldown.
"""

import json
import time
import urllib.request

import numpy as np
import pytest
import torch

from llms_on_kubernetes_tpu.configs import get_config as jget_config
from llms_on_kubernetes_tpu.engine import ledger as jledger
from llms_on_kubernetes_tpu_torch.configs import get_config
from llms_on_kubernetes_tpu_torch.engine import ledger as tledger
from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
from llms_on_kubernetes_tpu_torch.engine.ledger import (
    PHASES, GoodputLedger, StepAnomalyDetector, detect_peak,
)
from llms_on_kubernetes_tpu_torch.engine.tokenizer import ByteTokenizer
from llms_on_kubernetes_tpu_torch.server.openai_api import OpenAIServer

ENGINE = dict(model="debug-tiny", dtype="float32", max_decode_slots=4, page_size=8,
              num_pages=64, pages_per_slot=8, prefill_buckets=(16, 32), decode_steps=4,
              device="cpu")


class _Req:
    """A stand-in for engine.Request in the ledger's unit cases."""

    def __init__(self, tenant=""):
        self.tenant = tenant
        self.chip_ms = {}


def _ledger(**kw):
    kw.setdefault("peak_flops", 1e12)
    kw.setdefault("peak_bytes_s", 1e11)
    return GoodputLedger(get_config("debug-tiny"), **kw)


def _conserves(snap, rel=1e-9):
    total = snap["attributed_ms"] + snap["wasted_ms"] + snap["idle_ms"]
    assert total == pytest.approx(snap["window_ms"], rel=rel, abs=1e-6)
    assert snap["busy_ms"] == pytest.approx(snap["attributed_ms"] + snap["wasted_ms"],
                                            rel=rel, abs=1e-6)


# ---------------------------------------------------------------------------
# the ledger against the JAX one
# ---------------------------------------------------------------------------

def _random_records(seed: int, n: int = 300):
    """(t_launch, t_done, [(request index, phase, weight)], window) lists:
    overlapping launches, gaps, mixed phases, zero weights, empty rows."""
    rng = np.random.default_rng(seed)
    t = 100.0
    out = []
    for _ in range(n):
        t_launch = t - rng.uniform(0.0, 0.02) if rng.random() < 0.7 else t + rng.uniform(0, 0.05)
        t = max(t, t_launch) + rng.uniform(0.0, 0.01)
        rows = [(int(rng.integers(6)), PHASES[rng.integers(4)], int(rng.integers(0, 5)))
                for _ in range(int(rng.integers(0, 4)))]
        out.append((float(t_launch), float(t), rows, int(rng.integers(1, 9))))
    return out


@pytest.mark.parametrize("model", ["debug-tiny", "llama-3-8b", "phi-3-mini"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_snapshots_equal_the_jax_ledger(model, seed):
    peaks = dict(peak_flops=989e12, peak_bytes_s=3.35e12)
    tl = GoodputLedger(get_config(model), **peaks)
    jl = jledger.GoodputLedger(jget_config(model), **peaks)
    treqs = [_Req(f"t{i % 3}") for i in range(6)]
    jreqs = [_Req(f"t{i % 3}") for i in range(6)]
    for k, (t0, t1, rows, window) in enumerate(_random_records(seed)):
        dt = tl.record(t0, t1, [(treqs[i], ph, w) for i, ph, w in rows], window=window)
        dj = jl.record(t0, t1, [(jreqs[i], ph, w) for i, ph, w in rows], window=window)
        assert dt == dj
        if k % 50 == 0:
            assert tl.snapshot() == jl.snapshot()
            assert tl.utilization(window_s=0.5) == jl.utilization(window_s=0.5)
    assert tl.snapshot() == jl.snapshot()
    assert tl.utilization() == jl.utilization()
    assert [r.chip_ms for r in treqs] == [r.chip_ms for r in jreqs]
    assert (tl.flops_per_token, tl.param_bytes, tl.kv_bytes_per_token) == \
        (jl.flops_per_token, jl.param_bytes, jl.kv_bytes_per_token)
    _conserves(tl.snapshot())


def test_fused_window_attribution_and_conservation():
    led = _ledger()
    a, b = _Req("t-a"), _Req("t-b")
    led.record(0.0, 0.1, [(a, "decode", 4), (b, "decode", 4)], window=4)
    # launched while the first was in flight: its segment is 0.1 -> 0.2
    led.record(0.05, 0.2, [(a, "decode", 4), (b, "decode", 4)], window=4)
    led.record(0.3, 0.35, [(a, "decode", 2), (a, "early_exit", 2), (b, "decode", 4)],
               window=4)
    snap = led.snapshot()
    assert snap["window_ms"] == pytest.approx(350.0)
    assert snap["idle_ms"] == pytest.approx(100.0)
    assert snap["busy_ms"] == pytest.approx(250.0)
    _conserves(snap)
    assert a.chip_ms["decode"] == pytest.approx(50 + 50 + 12.5)
    assert a.chip_ms["early_exit"] == pytest.approx(12.5)
    assert b.chip_ms["decode"] == pytest.approx(50 + 50 + 25)
    assert snap["tenant_ms"][("t-a", "decode")] == pytest.approx(112.5)
    assert snap["tenant_ms"][("t-b", "decode")] == pytest.approx(125.0)
    assert snap["decode_tokens"] == 4 + 4 + 4 + 4 + 2 + 4
    assert snap["dispatches"] == 3


def test_spec_rejected_tail_books_waste_but_keeps_flops():
    led = _ledger()
    r = _Req("spec-tenant")
    led.record(0.0, 0.08, [(r, "decode", 2), (r, "spec_waste", 2)], window=4)
    snap = led.snapshot()
    _conserves(snap)
    assert snap["phase_ms"]["spec_waste"] == pytest.approx(40.0)
    assert snap["decode_tokens"] == 2
    assert snap["flops"] == pytest.approx(led.flops_per_token * 4)
    assert snap["hbm_bytes"] == pytest.approx(led.param_bytes * 4 + led.kv_bytes_per_token * 4)


def test_zero_row_dispatch_still_conserves():
    led = _ledger()
    led.record(0.0, 0.05, [])
    snap = led.snapshot()
    _conserves(snap)
    assert snap["phase_ms"]["early_exit"] == pytest.approx(50.0)
    assert snap["flops"] == 0.0
    assert snap["tenant_ms"][("", "early_exit")] == pytest.approx(50.0)


def test_attribution_fuzz_conservation():
    rng = np.random.default_rng(7)
    led = _ledger()
    reqs = [_Req(f"t{i}") for i in range(5)]
    t = 0.0
    for _ in range(200):
        t_launch = t - rng.uniform(0.0, 0.02)
        t = t + rng.uniform(0.0, 0.01)
        rows = [(reqs[rng.integers(5)], PHASES[rng.integers(4)], int(rng.integers(0, 5)))
                for _ in range(int(rng.integers(1, 4)))]
        led.record(t_launch, t, rows, window=int(rng.integers(1, 5)))
    snap = led.snapshot()
    _conserves(snap)
    req_total = sum(v for r in reqs for v in r.chip_ms.values())
    ten_total = sum(v for (ten, _ph), v in snap["tenant_ms"].items() if ten)
    assert req_total == pytest.approx(ten_total, rel=1e-9)


def test_utilization_bounded():
    led = _ledger(peak_flops=1.0, peak_bytes_s=1.0)
    r = _Req()
    led.record(0.0, 0.1, [(r, "decode", 4)], window=4)
    assert led.utilization() == (1.0, 1.0)          # clipped, as in JAX
    # the snapshot keeps the raw numbers: an unclipped share is computable
    snap = led.snapshot()
    assert snap["flops"] / (1.0 * snap["busy_ms"] / 1000.0) > 1.0
    led2 = _ledger(peak_flops=1e18, peak_bytes_s=1e18)
    led2.record(0.0, 0.1, [(r, "decode", 4)], window=4)
    mfu2, mbu2 = led2.utilization()
    assert 0.0 < mfu2 < 1e-3 and 0.0 < mbu2 < 1e-3


def test_reset_zeroes_accounting():
    led = _ledger()
    led.record(0.0, 0.1, [(_Req("x"), "decode", 4)], window=4)
    led.reset()
    snap = led.snapshot()
    assert snap["dispatches"] == 0 and snap["window_ms"] == 0.0 and snap["tenant_ms"] == {}
    led.record(5.0, 5.1, [(_Req("x"), "decode", 4)], window=4)
    _conserves(led.snapshot())


def test_int8_weights_count_the_dtype_bytes_as_jax():
    """The weight bytes come from model_config.dtype alone (bf16 here),
    whatever the weights' storage: the JAX ledger's count, kept."""
    cfg = get_config("llama-3-8b")
    led = GoodputLedger(cfg, peak_flops=1.0, peak_bytes_s=1.0)
    assert led.param_bytes == cfg.num_params * 2
    assert led.flops_per_token == 2.0 * cfg.num_params


# ---------------------------------------------------------------------------
# the peak table
# ---------------------------------------------------------------------------

def test_detect_peak_env_overrides(monkeypatch):
    monkeypatch.setenv("LLMK_PEAK_TFLOPS", "918")
    monkeypatch.setenv("LLMK_PEAK_GBPS", "1640")
    assert detect_peak() == (918e12, 1640e9)
    monkeypatch.setenv("LLMK_PEAK_TFLOPS", "not-a-number")
    f, b = detect_peak()
    assert f > 0 and b > 0


@pytest.mark.parametrize("name,peaks", [
    ("NVIDIA H100 80GB HBM3", (989e12, 3.35e12)),
    ("NVIDIA H100 PCIe", (756e12, 2.0e12)),
])
def test_detect_peak_reads_the_cards_name(monkeypatch, name, peaks):
    monkeypatch.delenv("LLMK_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("LLMK_PEAK_GBPS", raising=False)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: name)
    assert detect_peak("cuda") == peaks
    assert GoodputLedger(get_config("debug-tiny"), device="cuda").peak_flops == peaks[0]


@pytest.mark.parametrize("name", ["NVIDIA A10G", "NVIDIA H200", "NVIDIA GH200 480GB"])
def test_detect_peak_refuses_a_card_the_table_does_not_name(monkeypatch, name):
    monkeypatch.delenv("LLMK_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("LLMK_PEAK_GBPS", raising=False)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: name)
    with pytest.raises(RuntimeError, match=name):
        detect_peak("cuda")
    with pytest.raises(RuntimeError, match="LLMK_PEAK_TFLOPS"):
        GoodputLedger(get_config("debug-tiny"), device="cuda")
    # the overrides still name its peaks
    monkeypatch.setenv("LLMK_PEAK_TFLOPS", "1979")
    monkeypatch.setenv("LLMK_PEAK_GBPS", "4800")
    assert detect_peak("cuda") == (1979e12, 4800e9)


def test_detect_peak_lets_a_failed_name_lookup_raise(monkeypatch):
    monkeypatch.delenv("LLMK_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("LLMK_PEAK_GBPS", raising=False)

    def lookup(dev=None):
        raise AssertionError("no card")

    monkeypatch.setattr(torch.cuda, "get_device_name", lookup)
    with pytest.raises(AssertionError, match="no card"):
        detect_peak("cuda")


def test_detect_peak_on_the_cpu_is_the_jax_fallback(monkeypatch):
    monkeypatch.delenv("LLMK_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("LLMK_PEAK_GBPS", raising=False)
    assert detect_peak("cpu") == tledger._PEAK_FALLBACK == jledger._PEAK_FALLBACK


# ---------------------------------------------------------------------------
# the anomaly detector, on an injected clock
# ---------------------------------------------------------------------------

def test_detector_steady_load_never_triggers():
    det = StepAnomalyDetector(threshold=4.0, sustain=3, cooldown_s=10.0, warmup=5)
    for i in range(300):
        assert not det.observe(0.010 * (1.02 if i % 2 else 0.98), now=float(i))
    assert det.triggers == 0


def test_detector_warmup_suppresses_triggers():
    det = StepAnomalyDetector(threshold=4.0, sustain=1, cooldown_s=0.0, warmup=10)
    for i in range(9):
        assert not det.observe(0.001 if i % 2 else 1.0, now=float(i))
    assert det.triggers == 0


def test_detector_trigger_sustain_cooldown_rate_limit():
    det = StepAnomalyDetector(threshold=4.0, sustain=3, cooldown_s=100.0, warmup=5)
    now = 0.0
    for _ in range(20):
        now += 1.0
        assert not det.observe(0.010, now=now)
    baseline = det._mean
    fired_at = None
    for i in range(10):
        now += 1.0
        if det.observe(0.050, now=now):
            assert fired_at is None, "second trigger inside cooldown"
            fired_at = i
    assert fired_at == 2 and det.triggers == 1
    assert det._mean == pytest.approx(baseline)
    now += 200.0
    assert det.observe(0.050, now=now)
    assert det.triggers == 2


def test_detector_brief_spike_below_sustain_is_ignored():
    det = StepAnomalyDetector(threshold=4.0, sustain=3, cooldown_s=0.0, warmup=5)
    now = 0.0
    for _ in range(20):
        now += 1.0
        det.observe(0.010, now=now)
    for dur in (0.050, 0.050, 0.010, 0.010):
        now += 1.0
        assert not det.observe(dur, now=now)
    assert det.triggers == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detector_equals_the_jax_detector(seed):
    rng = np.random.default_rng(seed)
    kw = dict(threshold=3.0, sustain=2, cooldown_s=5.0, warmup=6, alpha=0.1)
    td, jd = StepAnomalyDetector(**kw), jledger.StepAnomalyDetector(**kw)
    now, burst = 0.0, 0
    for _ in range(400):
        now += float(rng.uniform(0.0, 1.0))
        if burst == 0 and rng.random() < 0.05:
            burst = int(rng.integers(1, 6))       # a slowdown of 1-5 dispatches
        dur = 0.01 * float(rng.lognormal(0.0, 0.05)) * (6.0 if burst else 1.0)
        burst = max(0, burst - 1)
        assert td.observe(dur, now) == jd.observe(dur, now)
        assert (td._mean, td._var, td._n, td._streak) == (jd._mean, jd._var, jd._n, jd._streak)
    assert td.triggers == jd.triggers > 0


# ---------------------------------------------------------------------------
# the engine's booking
# ---------------------------------------------------------------------------

def _run(eng, reqs):
    for _ in range(10_000):
        if all(r.finished for r in reqs):
            break
        eng.step()
    if eng._async:
        eng._drain_async()
    assert all(r.finished for r in reqs)
    return reqs


PROMPTS = [[1, 2, 3], [9, 10], [11, 12, 13, 14], list(range(20, 45))]


@pytest.mark.parametrize("async_scheduling", [True, False])
def test_engine_conserves_and_attributes(async_scheduling):
    eng = Engine(EngineConfig(**ENGINE, async_scheduling=async_scheduling))
    assert eng.ledger is not None
    reqs = [eng.submit(p, SamplingParams(temperature=0.0, max_tokens=m))
            for p, m in zip(PROMPTS, (12, 7, 5, 9))]
    _run(eng, reqs)
    snap = eng.ledger.snapshot()
    _conserves(snap, rel=1e-6)
    assert snap["window_ms"] > 0 and snap["dispatches"] > 0
    total = sum(v for r in reqs for v in r.chip_ms.values())
    assert total == pytest.approx(snap["attributed_ms"] + snap["wasted_ms"], rel=1e-6)
    assert sum(r.chip_ms.get("prefill", 0.0) + r.chip_ms.get("decode", 0.0) for r in reqs) \
        == pytest.approx(snap["attributed_ms"], rel=1e-6)
    # every emitted token past the first is a consumed decode token
    assert snap["decode_tokens"] == sum(len(r.output) - 1 for r in reqs)
    assert all(r.chip_ms.get("prefill", 0.0) > 0.0 for r in reqs)
    # max_tokens 7 and 5 end inside a K=4 window: the planned tail is
    # booked "early_exit", never "decode"
    assert snap["prefill_tokens"] == sum(len(p) for p in PROMPTS)


def test_engine_windows_book_the_harvesters_completion_times():
    """The async path books each window from its launch to the time the
    harvester saw it complete, so the engine thread's later reads never
    pad the busy time."""
    eng = Engine(EngineConfig(**ENGINE))
    seen = []
    real = eng.ledger.record

    def spy(t_launch, t_done, rows, window=1):
        seen.append((t_launch, t_done, window))
        return real(t_launch, t_done, rows, window=window)

    eng.ledger.record = spy
    stamps = {}
    done_time = eng._harvester.done_time

    def stamp(key):
        stamps[key] = done_time(key)
        return stamps[key]

    eng._harvester.done_time = stamp
    _run(eng, [eng.submit([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=10))])
    windows = [s for s in seen if s[2] == 4]
    assert windows and all(t1 in stamps.values() for _t0, t1, _w in seen)
    assert all(t1 >= t0 for t0, t1, _w in seen)


def test_greedy_bit_identical_ledger_on_off():
    outs = {}
    for ledger in (True, False):
        eng = Engine(EngineConfig(**ENGINE, ledger=ledger, async_depth=2))
        assert (eng.ledger is not None) == ledger
        reqs = [eng.submit(p, SamplingParams(temperature=0.0, max_tokens=12))
                for p in PROMPTS[:3]]
        _run(eng, reqs)
        outs[ledger] = [list(r.output) for r in reqs]
        assert all(bool(r.chip_ms) == ledger for r in reqs)
    assert outs[True] == outs[False]


def test_ledger_env_switch(monkeypatch):
    monkeypatch.setenv("LLMK_LEDGER", "0")
    assert EngineConfig(**ENGINE).ledger is False
    monkeypatch.setenv("LLMK_LEDGER", "1")
    monkeypatch.setenv("LLMK_ANOMALY_Z", "6.5")
    monkeypatch.setenv("LLMK_ANOMALY_COOLDOWN_S", "-3")
    cfg = EngineConfig(**ENGINE)
    assert (cfg.ledger, cfg.anomaly_z, cfg.anomaly_cooldown_s) == (True, 6.5, 0.0)
    with pytest.raises(ValueError, match="anomaly_z"):
        EngineConfig(**ENGINE, anomaly_z=0.0)


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

def _post(base, path, body, headers=None):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, dict(r.headers), r.read()


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return r.read()


def _trace(base, rid):
    """The request's finished trace. The server records it after the
    response's last byte, so a client can ask before it lands: poll."""
    deadline = time.monotonic() + 10.0
    while True:
        traces = json.loads(_get(base, f"/debug/traces?id={rid}"))["traces"]
        if traces or time.monotonic() > deadline:
            return traces[0]
        time.sleep(0.02)


def _server(**kw):
    cfg = dict(ENGINE, page_size=4, num_pages=256, pages_per_slot=32, prefill_buckets=(32, 64))
    cfg.update(kw)
    srv = OpenAIServer(Engine(EngineConfig(**cfg)), ByteTokenizer(), "debug-tiny")
    return srv, f"http://127.0.0.1:{srv.start()}"


def test_usage_header_spans_flight_and_metrics_carry_chip_time():
    srv, base = _server()
    try:
        status, headers, raw = _post(base, "/v1/completions",
                                     {"prompt": "abcdef", "max_tokens": 8, "temperature": 0},
                                     {"X-LLMK-Request-Id": "chip-trace-1"})
        assert status == 200
        chip = json.loads(raw)["usage"]["chip_ms"]
        assert chip.get("prefill", 0.0) > 0.0 and chip.get("decode", 0.0) > 0.0
        assert float(headers["X-LLMK-Chip-Ms"]) == pytest.approx(sum(chip.values()), abs=0.01)
        spans = {s["name"]: s for s in _trace(base, "chip-trace-1")["spans"]}
        assert spans["prefill"]["chip_ms"] == pytest.approx(chip["prefill"], abs=0.01)
        assert spans["decode"]["chip_ms"] == pytest.approx(chip["decode"], abs=0.01)
        steps = json.loads(_get(base, "/debug/engine"))["steps"]
        keyed = [s for s in steps if "chip_attr_ms" in s]
        assert keyed and sum(s["chip_attr_ms"] for s in keyed) > 0.0
        assert all("mfu" in s and "device_ms" in s for s in keyed)
        # a stream's usage frame carries it too
        _status, _h, body = _post(base, "/v1/completions", {
            "prompt": "abc", "max_tokens": 4, "temperature": 0, "stream": True,
            "stream_options": {"include_usage": True}})
        frames = [json.loads(ln[6:]) for ln in body.decode().splitlines()
                  if ln.startswith("data: {")]
        assert frames[-1]["usage"]["chip_ms"]["prefill"] > 0.0
        text = _get(base, "/metrics").decode()
        for series in ('llm_chip_seconds_total{phase="prefill"}',
                       'llm_chip_seconds_total{phase="decode"}',
                       'llm_chip_seconds_total{phase="idle"}', "llm_mfu_ratio",
                       "llm_mbu_ratio",
                       'llm_tenant_chip_seconds_total{tenant="debug-tiny",phase="decode"}',
                       'llm_auto_profile_total{reason="step_anomaly"} 0'):
            assert series in text, series
        value = float(next(ln for ln in text.splitlines()
                           if ln.startswith('llm_chip_seconds_total{phase="decode"}')).split()[-1])
        snap = srv.engine.ledger.snapshot()
        assert value == pytest.approx(snap["phase_ms"]["decode"] / 1000.0, rel=1e-6)
    finally:
        srv.close()


def test_ledger_off_serves_no_chip_time():
    srv, base = _server(ledger=False)
    try:
        _status, headers, raw = _post(base, "/v1/completions",
                                      {"prompt": "abc", "max_tokens": 3, "temperature": 0})
        assert "chip_ms" not in json.loads(raw)["usage"]
        assert "X-LLMK-Chip-Ms" not in headers
    finally:
        srv.close()


class _StubProfiles:
    def __init__(self):
        self.calls = []

    def capture(self, duration_ms=None, **kw):
        self.calls.append(duration_ms)
        return {"ok": True}


def test_an_anomaly_takes_exactly_one_rate_limited_capture():
    """Synthetic dispatch times on the engine's ledger (an injected clock,
    no wall-clock dependence) fire its detector once; the loop's next step
    takes one capture, and the detector's cooldown keeps real traffic
    after it from taking another."""
    srv, base = _server(anomaly_z=4.0, anomaly_cooldown_s=3600.0)
    stub = _StubProfiles()
    srv.loop.profiles = stub
    led = srv.engine.ledger
    led.detector = StepAnomalyDetector(threshold=4.0, sustain=2, cooldown_s=3600.0, warmup=4)
    try:
        t = time.monotonic()
        for i in range(10):                 # a steady 10 ms baseline
            led.record(t, t + 0.010, [(None, "decode", 1)])
            t += 0.011
        assert not led.take_anomaly() and led.detector.triggers == 0
        for i in range(2):                  # sustained 5x: fires on the 2nd
            led.record(t, t + 0.050, [(None, "decode", 1)])
            t += 0.051
        assert led.detector.triggers == 1
        for _ in range(3):
            _post(base, "/v1/completions", {"prompt": "abcd", "max_tokens": 6,
                                            "temperature": 0})
        deadline = time.monotonic() + 10.0
        while not stub.calls and time.monotonic() < deadline:
            time.sleep(0.02)
        assert srv.loop.auto_profiles == 1 and stub.calls == [2000.0]
        assert led.detector.triggers == 1
        text = _get(base, "/metrics").decode()
        assert 'llm_auto_profile_total{reason="step_anomaly"} 1' in text
        steps = json.loads(_get(base, "/debug/engine"))["steps"]
        assert any(s.get("marker") == "auto_profile" for s in steps)
    finally:
        srv.close()
