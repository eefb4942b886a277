"""Profiling and runtime telemetry in the port, on the CPU.

- ``ProfileManager``: a CPU engine's capture is the sampling profiler's
  (``stacks.json``); captures are listed newest first and downloaded as
  .tar.gz; a malformed or unknown id gives nothing; one capture at a time,
  and none while an in-process caller holds the profiler (``reserve``);
  with no ``LLMK_PROFILE_DIR`` captures go under the process's temporary
  directory (``TMPDIR``), never a fixed path. A card's capture is ``torch.profiler`` (stubbed here: no card) started
  and stopped through the runner (the serving loop's ``call``, between
  engine steps), writing ``trace.json``; a profiler
  that cannot start raises ``ProfileError`` naming the cause, with no
  switch to the sampler.
- Server: ``POST /debug/profile`` answers with the JAX server's keys, ``GET
  /debug/profile`` lists the capture, ``GET /debug/profile/{id}`` returns
  its archive, 404 for an unknown id, 400 for a bad duration, 409 while a
  capture runs, 500 naming the cause when the profiler cannot capture.
- The manual pair (the JAX server's ``/debug/profile/start`` and
  ``/stop``): start answers ``{"status": "profiling", ...}``, stop
  ``{"status": "stopped", ...}`` with the session catalogued as a capture;
  409 for a second start, for a stop without a session and for a bounded
  capture during one, as the JAX server answers; on a card the profiler
  starts and stops on the engine loop's thread, and a server closed
  during a session stops it there.
- ``RuntimeTelemetry``: the JAX module's metric definitions; on the CPU the
  engine's own tensors are the live bytes; on a card (``torch.cuda``
  stubbed) the allocator's statistics and the card's total memory; the
  port's compile events (nvcc builds, graph captures) count as compiles;
  every step folds into the device/host seconds.
"""

import io
import json
import tarfile
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from llms_on_kubernetes_tpu.server import metrics as jmetrics
from llms_on_kubernetes_tpu.server import runtime_telemetry as jtelemetry
from llms_on_kubernetes_tpu_torch import kernels
from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig
from llms_on_kubernetes_tpu_torch.engine.tokenizer import ByteTokenizer
from llms_on_kubernetes_tpu_torch.server import metrics as tmetrics
from llms_on_kubernetes_tpu_torch.server import profiling
from llms_on_kubernetes_tpu_torch.server import runtime_telemetry as ttelemetry
from llms_on_kubernetes_tpu_torch.server.openai_api import OpenAIServer
from llms_on_kubernetes_tpu_torch.server.profiling import ProfileError, ProfileManager

SMALL = dict(model="debug-tiny", dtype="float32", max_decode_slots=4, page_size=8,
             num_pages=128, pages_per_slot=16, prefill_buckets=(32, 64), device="cpu")


def _members(data: bytes) -> list:
    with tarfile.open(fileobj=io.BytesIO(data), mode="r:gz") as tar:
        return sorted(m.name for m in tar.getmembers() if m.isfile())


def test_cpu_capture_is_the_sampler_and_round_trips(tmp_path, monkeypatch):
    monkeypatch.setenv("LLMK_PROFILE_MAX_S", "0.2")
    pm = ProfileManager(base_dir=str(tmp_path), device="cpu")
    meta = pm.capture(80)
    assert meta["source"] == "py-sampler" and meta["duration_s"] == pytest.approx(0.08)
    assert {f["name"] for f in meta["files"]} == {"stacks.json", "capture.json"}
    stacks = json.loads((tmp_path / meta["id"] / "stacks.json").read_text())
    assert stacks["kind"] == "py-sampling-profile" and stacks["samples"] > 0
    time.sleep(1.0)                         # ids carry whole seconds
    second = pm.capture(10_000_000)         # clamped to LLMK_PROFILE_MAX_S
    assert second["duration_s"] == 0.2
    listed = pm.list_captures()
    assert [c["id"] for c in listed] == [second["id"], meta["id"]]
    assert all(c["bytes"] > 0 for c in listed)
    assert _members(pm.open_archive(meta["id"])) == sorted(
        f"{meta['id']}/{n}" for n in ("stacks.json", "capture.json"))
    assert pm.open_archive("../etc") is None and pm.open_archive("cap-9-9") is None


def test_one_capture_at_a_time(tmp_path):
    pm = ProfileManager(base_dir=str(tmp_path), device="cpu")
    t = threading.Thread(target=pm.capture, args=(400,))
    t.start()
    deadline = time.monotonic() + 5
    while not pm.busy and time.monotonic() < deadline:
        time.sleep(0.005)
    with pytest.raises(RuntimeError, match="busy"):
        pm.capture(50)
    t.join()
    assert not pm.busy


class _FakeProfile:
    """Stands in for torch.profiler.profile on a machine with no card."""
    made: list = []

    def __init__(self, activities):
        self.activities = activities
        self.events = []
        _FakeProfile.made.append(self)

    def start(self):
        self.events.append(("start", threading.current_thread().name))

    def stop(self):
        self.events.append(("stop", threading.current_thread().name))

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": [{"cat": "kernel", "name": "k"}]}, f)


def test_card_capture_starts_and_stops_through_the_runner(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    ran = []

    def runner(fn):                 # the serving loop runs these between steps
        ran.append(fn.__name__)
        out: list = []
        th = threading.Thread(target=lambda: out.append(fn()), name="engine-loop")
        th.start()
        th.join()
        return out[0]

    pm = ProfileManager(base_dir=str(tmp_path), device="cuda", runner=runner)
    meta = pm.capture(60)
    prof = _FakeProfile.made[-1]
    assert meta["source"] == "torch-profiler"
    assert set(prof.activities) == {torch.profiler.ProfilerActivity.CPU,
                                    torch.profiler.ProfilerActivity.CUDA}
    assert ran == ["start", "stop"]
    assert prof.events == [("start", "engine-loop"), ("stop", "engine-loop")]
    assert {f["name"] for f in meta["files"]} == {"trace.json", "capture.json"}


def test_a_capture_whose_loop_stops_still_stops_the_profiler(tmp_path, monkeypatch):
    """The server closed mid-capture: the runner (the engine loop) refuses
    the stop, and the capture stops the process-global session on its own
    thread instead of leaving it on."""
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)

    def runner(fn):
        if fn.__name__ == "stop":
            raise RuntimeError("the engine loop has stopped")
        return fn()

    pm = ProfileManager(base_dir=str(tmp_path), device="cuda", runner=runner)
    with pytest.raises(ProfileError, match="engine loop has stopped"):
        pm.capture(50)
    prof = _FakeProfile.made[-1]
    assert [e for e, _thread in prof.events] == ["start", "stop"]
    assert not pm.busy


def test_close_lets_a_running_capture_stop_on_the_engine_thread(tmp_path, monkeypatch):
    """A server closed while a card capture runs (the anomaly detector's, on
    its own thread) waits for it: the profiler starts and stops on the
    engine loop's thread, and the capture completes."""
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    monkeypatch.setenv("LLMK_PROFILE_DIR", str(tmp_path))
    eng = Engine(EngineConfig(model="debug-tiny", dtype="float32", max_decode_slots=2,
                              page_size=4, num_pages=32, pages_per_slot=8,
                              prefill_buckets=(16,), device="cpu"))
    server = OpenAIServer(eng, ByteTokenizer(), "debug-tiny")
    server.start("127.0.0.1", 0)
    server.profiles.device = "cuda"
    out = {}

    def capture():
        try:
            out["meta"] = server.profiles.capture(400)
        except Exception as e:   # reported by the assertion below
            out["error"] = e

    th = threading.Thread(target=capture)
    th.start()
    deadline = time.monotonic() + 5
    while not server.profiles.busy and time.monotonic() < deadline:
        time.sleep(0.005)
    server.close()
    th.join(timeout=10)
    assert "error" not in out and out["meta"]["source"] == "torch-profiler"
    prof = _FakeProfile.made[-1]
    assert [e for e, _t in prof.events] == ["start", "stop"]
    assert {t for _e, t in prof.events} == {server.loop.name}
    assert not server.loop.is_alive()


def test_a_profiler_that_cannot_start_names_the_cause(tmp_path, monkeypatch):
    class Broken:
        def __init__(self, activities):
            pass

        def start(self):
            raise RuntimeError("CUPTI_ERROR_NOT_INITIALIZED")

    monkeypatch.setattr(torch.profiler, "profile", Broken)
    pm = ProfileManager(base_dir=str(tmp_path), device="cuda")
    with pytest.raises(ProfileError, match="CUPTI_ERROR_NOT_INITIALIZED"):
        pm.capture(50)
    assert not pm.busy
    capture_dir = [p for p in tmp_path.iterdir()]
    assert all(not (p / "stacks.json").exists() for p in capture_dir)   # no sampler


# ---------------------------------------------------------------------------
# the server's routes
# ---------------------------------------------------------------------------

def test_reserve_holds_the_profiler_against_captures(tmp_path, monkeypatch):
    monkeypatch.setenv("LLMK_PROFILE_MAX_S", "0.3")
    pm = ProfileManager(base_dir=str(tmp_path), device="cpu")
    with pm.reserve():
        assert pm.busy
        with pytest.raises(RuntimeError, match="busy"):
            pm.capture(60)
    assert not pm.busy and pm.capture(60)["source"] == "py-sampler"
    # a reservation waits for a running capture to end, and gives up after
    # its timeout
    th = threading.Thread(target=pm.capture, args=(300,))
    th.start()
    while not pm.busy:
        time.sleep(0.005)
    with pytest.raises(RuntimeError, match="busy"):
        with pm.reserve(timeout_s=0.01):
            pass
    t0 = time.monotonic()
    with pm.reserve(timeout_s=30):
        assert not th.is_alive() and time.monotonic() - t0 < 30
    th.join()
    assert len(pm.list_captures()) == 2


def test_default_capture_dir_is_under_the_temporary_directory(tmp_path, monkeypatch):
    import tempfile

    monkeypatch.delenv("LLMK_PROFILE_DIR", raising=False)
    monkeypatch.setenv("LLMK_PROFILE_MAX_S", "0.2")
    monkeypatch.setattr(tempfile, "tempdir", None)    # re-read TMPDIR
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    pm = ProfileManager(device="cpu")
    assert pm.base_dir == str(tmp_path / "llmk-profile")
    meta = pm.capture(60)
    assert (tmp_path / "llmk-profile" / meta["id"] / "stacks.json").is_file()
    monkeypatch.setenv("LLMK_PROFILE_DIR", str(tmp_path / "set"))
    assert ProfileManager(device="cpu").base_dir == str(tmp_path / "set")


def _req(base, path, body=None, method=None):
    data = json.dumps(body).encode() if body is not None else None
    r = urllib.request.Request(base + path, data=data, method=method or (
        "POST" if data is not None else "GET"), headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(r, timeout=60) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


@pytest.fixture()
def server(tmp_path, monkeypatch):
    monkeypatch.setenv("LLMK_PROFILE_DIR", str(tmp_path))
    srv = OpenAIServer(Engine(EngineConfig(**SMALL)), ByteTokenizer(), "debug-tiny")
    yield srv, f"http://127.0.0.1:{srv.start()}"
    srv.close()


def test_debug_profile_round_trip(server):
    srv, base = server
    _req(base, "/v1/completions", {"prompt": "abc", "max_tokens": 3, "temperature": 0})
    status, _h, raw = _req(base, "/debug/profile", {"duration_ms": 100})
    assert status == 200
    meta = json.loads(raw)
    # the JAX server's answer keys
    assert set(meta) == {"id", "source", "duration_s", "created", "files"}
    assert meta["source"] == "py-sampler"
    status, _h, raw = _req(base, "/debug/profile")
    listing = json.loads(raw)
    assert status == 200 and set(listing) == {"dir", "busy", "captures"}
    assert [c["id"] for c in listing["captures"]] == [meta["id"]] and not listing["busy"]
    status, headers, data = _req(base, f"/debug/profile/{meta['id']}")
    assert status == 200 and headers["Content-Type"] == "application/gzip"
    assert f"{meta['id']}/capture.json" in _members(data)
    assert _req(base, "/debug/profile/cap-1-1")[0] == 404
    assert _req(base, "/debug/profile", {"duration_ms": -5})[0] == 400
    assert _req(base, "/debug/profile", {"duration_ms": "x"})[0] == 400


def test_debug_profile_busy_and_failing(server, monkeypatch):
    srv, base = server
    srv.profiles._busy = True
    assert _req(base, "/debug/profile", {"duration_ms": 50})[0] == 409
    srv.profiles._busy = False
    monkeypatch.setattr(srv.profiles, "device", "cuda")

    class Broken:
        def __init__(self, activities):
            pass

        def start(self):
            raise RuntimeError("no CUPTI on this box")

    monkeypatch.setattr(torch.profiler, "profile", Broken)
    status, _h, raw = _req(base, "/debug/profile", {"duration_ms": 50})
    assert status == 500 and "no CUPTI on this box" in json.loads(raw)["error"]["message"]


def test_the_profile_runner_is_the_engine_loop(server, monkeypatch):
    """On a card the profiler's start and stop run on the engine loop's
    thread (between steps)."""
    srv, base = server
    monkeypatch.setattr(srv.profiles, "device", "cuda")
    _FakeProfile.made.clear()
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    status, _h, raw = _req(base, "/debug/profile", {"duration_ms": 60})
    assert status == 200 and json.loads(raw)["source"] == "torch-profiler"
    assert _FakeProfile.made[-1].events == [("start", "engine-loop"), ("stop", "engine-loop")]


def test_manual_session_round_trip_and_409s(server):
    srv, base = server
    status, _h, raw = _req(base, "/debug/profile/stop", {})
    assert status == 409 and json.loads(raw)["error"]["message"] == "profiler not running"
    status, _h, raw = _req(base, "/debug/profile/start", {})
    started = json.loads(raw)
    assert status == 200 and started["status"] == "profiling" and "dir" in started
    status, _h, raw = _req(base, "/debug/profile/start", {})
    assert status == 409 and json.loads(raw)["error"]["message"] == "profiler already running"
    status, _h, raw = _req(base, "/debug/profile", {"duration_ms": 50})
    assert status == 409 and "manual profiler session" in json.loads(raw)["error"]["message"]
    assert json.loads(_req(base, "/debug/profile")[2])["busy"] is True
    _req(base, "/v1/completions", {"prompt": "abc", "max_tokens": 3, "temperature": 0})
    status, _h, raw = _req(base, "/debug/profile/stop", {})
    stopped = json.loads(raw)
    assert status == 200 and stopped["status"] == "stopped"
    assert stopped["id"] == started["id"] and stopped["source"] == "py-sampler"
    assert {f["name"] for f in stopped["files"]} == {"stacks.json", "capture.json"}
    assert _req(base, "/debug/profile/stop", {})[0] == 409
    listing = json.loads(_req(base, "/debug/profile")[2])
    assert listing["busy"] is False and [c["id"] for c in listing["captures"]] == [stopped["id"]]
    assert _req(base, "/debug/profile", {"duration_ms": 50})[0] == 200   # free again


def test_manual_session_on_a_card_runs_on_the_engine_loop(server, monkeypatch):
    srv, base = server
    monkeypatch.setattr(srv.profiles, "device", "cuda")
    _FakeProfile.made.clear()
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    assert _req(base, "/debug/profile/start", {})[0] == 200
    status, _h, raw = _req(base, "/debug/profile/stop", {})
    meta = json.loads(raw)
    assert status == 200 and meta["source"] == "torch-profiler"
    assert {f["name"] for f in meta["files"]} == {"trace.json", "capture.json"}
    assert _FakeProfile.made[-1].events == [("start", "engine-loop"), ("stop", "engine-loop")]


def test_manual_session_start_failure_is_501(server, monkeypatch):
    srv, base = server
    monkeypatch.setattr(srv.profiles, "device", "cuda")

    class Broken:
        def __init__(self, activities):
            pass

        def start(self):
            raise RuntimeError("no CUPTI on this box")

    monkeypatch.setattr(torch.profiler, "profile", Broken)
    status, _h, raw = _req(base, "/debug/profile/start", {})
    assert status == 501 and "no CUPTI on this box" in json.loads(raw)["error"]["message"]
    assert not srv.profiles.busy and not srv.profiles.manual


def test_close_stops_a_manual_session_on_the_engine_thread(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    monkeypatch.setenv("LLMK_PROFILE_DIR", str(tmp_path))
    srv = OpenAIServer(Engine(EngineConfig(**SMALL)), ByteTokenizer(), "debug-tiny")
    base = f"http://127.0.0.1:{srv.start()}"
    srv.profiles.device = "cuda"
    assert _req(base, "/debug/profile/start", {})[0] == 200
    srv.close()
    prof = _FakeProfile.made[-1]
    assert [e for e, _t in prof.events] == ["start", "stop"]
    assert {t for _e, t in prof.events} == {srv.loop.name}
    assert not srv.profiles.busy and not srv.profiles.manual
    assert len(srv.profiles.list_captures()) == 1


# ---------------------------------------------------------------------------
# runtime telemetry
# ---------------------------------------------------------------------------

def test_runtime_metric_definitions_equal_the_jax_ones():
    jreg, treg = jmetrics.Registry(), tmetrics.Registry()
    jtelemetry.runtime_metrics(jreg)
    ttelemetry.runtime_metrics(treg)
    got = [(type(m).__name__, m.name, m.help, m.label_names) for m in treg._metrics]
    want = [(type(m).__name__, m.name, m.help, m.label_names) for m in jreg._metrics]
    assert got == want


def _values(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, v = line.rpartition(" ")
            out[key] = float(v)
    return out


def test_metrics_carry_the_runtime_telemetry(server):
    srv, base = server
    kernels.note_compile("graph:test", 0.25)
    _req(base, "/v1/completions", {"prompt": "abcd", "max_tokens": 4, "temperature": 0})
    values = _values(_req(base, "/metrics")[2].decode())
    live = values['llm_device_live_buffer_bytes{device="cpu"}']
    assert live == srv._engine_bytes() > 0
    assert values['llm_device_memory_bytes{device="cpu",kind="live_buffer_bytes"}'] == live
    assert values["llm_jit_compiles_total"] >= 1
    assert values["llm_jit_compile_seconds_total"] >= 0.25
    assert values["llm_step_device_seconds_total"] >= 0.0
    assert values["llm_step_host_seconds_total"] > 0.0
    # a compile event counts once
    again = _values(_req(base, "/metrics")[2].decode())
    assert again["llm_jit_compiles_total"] == values["llm_jit_compiles_total"]


def test_a_parallel_nvcc_build_is_one_compile_event_of_its_wall_time(tmp_path, monkeypatch):
    # a stand-in nvcc: 0.5 s, then the library it was asked for
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nsleep 0.5\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    n0 = len(kernels.COMPILES)
    t0 = time.perf_counter()
    paths = kernels.build(("a", "b", "c"))
    wall = time.perf_counter() - t0
    assert all(p.exists() for p in paths.values())
    events = kernels.COMPILES[n0:]
    # the three builds overlap: one event of the build's wall time, not
    # three spans that each start at the first launch
    assert [k for k, _s in events] == ["nvcc:a,b,c"]
    assert 0.5 <= events[0][1] <= wall
    assert kernels.build(("a", "b", "c")) == paths and len(kernels.COMPILES) == n0 + 1


def test_card_memory_comes_from_the_allocator(monkeypatch):
    stats = {"allocated_bytes.all.current": 7_000, "allocated_bytes.all.peak": 9_000,
             "reserved_bytes.all.current": 16_000, "allocation.all.allocated": 42}
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda dev=None: stats)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev=None: (1_000, 80_000))
    reg = tmetrics.Registry()
    tel = ttelemetry.RuntimeTelemetry(reg, torch.device("cuda", 0))
    tel.refresh()
    values = _values(reg.render())
    kinds = {k: values[f'llm_device_memory_bytes{{device="cuda:0",kind="{k}"}}']
             for k in ("bytes_in_use", "peak_bytes_in_use", "bytes_reserved", "num_allocs",
                       "bytes_limit")}
    assert kinds == {"bytes_in_use": 7_000, "peak_bytes_in_use": 9_000,
                     "bytes_reserved": 16_000, "num_allocs": 42, "bytes_limit": 80_000}
    assert values['llm_device_live_buffer_bytes{device="cuda:0"}'] == 7_000


def test_a_failing_refresh_never_raises(monkeypatch):
    def boom(dev=None):
        raise RuntimeError("device lost")

    monkeypatch.setattr(torch.cuda, "memory_stats", boom)
    tel = ttelemetry.RuntimeTelemetry(tmetrics.Registry(), torch.device("cuda", 0))
    tel.refresh()
    tel.record_step_split(0.5, 2.0)     # clamped to the step
    assert tel.metrics["step_device_seconds"].value == 0.5
