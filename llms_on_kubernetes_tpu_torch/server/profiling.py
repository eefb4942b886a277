"""On-demand, bounded-duration profile captures for a serving process
(counterpart of ``llms_on_kubernetes_tpu/server/profiling.py``).

``POST /debug/profile`` works against a *live* engine without restarting
it: the replica that misbehaves under production traffic is the one to
profile. This module owns the capture lifecycle, so the API layer stays a
thin HTTP shim:

- One capture at a time per process (the profiler is process-global): a
  second POST while one runs gets a 409 from the server, and so does one
  while an in-process caller holds the profiler (``reserve``).
- Durations are clamped to ``[0.05s, LLMK_PROFILE_MAX_S]`` (default 30 s).
- Captures land in ``LLMK_PROFILE_DIR`` (default ``llmk-profile`` under
  ``tempfile.gettempdir()``, which honours ``TMPDIR``) under an opaque
  ``cap-<n>-<stamp>`` directory; ``list_captures()`` enumerates them and
  ``open_archive()`` streams one back as a .tar.gz built with stdlib
  tarfile.
- On a card the capture is ``torch.profiler`` with CPU and CUDA activity
  (``trace.json``, a Chrome trace). It is started and stopped only between engine steps, on the
  engine thread (``runner``: the serving loop's ``call``), so a capture
  never begins or ends inside a window graph's replay. A profiler that
  cannot start raises :class:`ProfileError` naming the cause (the server
  answers 500 with it): there is no quiet switch to another profiler on a
  card. A CPU engine is profiled by the JAX module's pure-Python sampling
  profiler over ``sys._current_frames()`` (``stacks.json``), which finds a
  host-side stall.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import re
import sys
import tarfile
import tempfile
import threading
import time
import traceback
from typing import Callable, Optional

_CAPTURE_ID_RE = re.compile(r"^cap-[0-9]+-[0-9]+$")
_SAMPLE_INTERVAL_S = 0.005


class ProfileError(RuntimeError):
    """The profiler could not capture on this device (the message names
    the cause)."""


def _base_dir() -> str:
    return os.environ.get("LLMK_PROFILE_DIR",
                          os.path.join(tempfile.gettempdir(), "llmk-profile"))


def _max_duration_s() -> float:
    try:
        return float(os.environ.get("LLMK_PROFILE_MAX_S", "30"))
    except ValueError:
        return 30.0


def _dir_listing(path: str) -> list[dict]:
    """[{name, bytes}] for every regular file under path (relative names)."""
    out = []
    for root, _dirs, files in os.walk(path):
        for f in sorted(files):
            full = os.path.join(root, f)
            try:
                size = os.path.getsize(full)
            except OSError:
                continue
            out.append({"name": os.path.relpath(full, path), "bytes": size})
    return out


class _SamplingProfiler:
    """Host-stack sampler: periodically snapshots every thread's stack via
    sys._current_frames() and aggregates identical stacks with counts.
    The output (stacks.json) is a flat list sorted by sample count — the
    top entry is where the process was actually spending its time."""

    def __init__(self) -> None:
        self._counts: collections.Counter = collections.Counter()
        self._samples = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="llmk-prof-sampler", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def _run(self) -> None:
        me = threading.get_ident()
        while not self._stop.is_set():
            for tid, frame in sys._current_frames().items():
                if tid == me:
                    continue
                stack = tuple(
                    f"{fr.filename}:{fr.lineno}:{fr.name}"
                    for fr in traceback.extract_stack(frame))
                self._counts[stack] += 1
            self._samples += 1
            self._stop.wait(_SAMPLE_INTERVAL_S)

    def stop_and_dump(self, out_dir: str) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)
        stacks = [
            {"count": n, "frames": list(stack)}
            for stack, n in self._counts.most_common()
        ]
        payload = {
            "kind": "py-sampling-profile",
            "samples": self._samples,
            "interval_s": _SAMPLE_INTERVAL_S,
            "stacks": stacks,
        }
        with open(os.path.join(out_dir, "stacks.json"), "w") as f:
            json.dump(payload, f, indent=1)


class ProfileManager:
    """Capture lifecycle + capture-directory catalogue for one process.
    ``device``: the engine's ("cuda" captures with ``torch.profiler``,
    "cpu" with the sampler); ``runner(fn)`` runs ``fn`` between engine
    steps on the engine thread (the serving loop's ``call``; None runs it
    in place)."""

    def __init__(self, base_dir: str | None = None, device: str = "cpu",
                 runner: Optional[Callable] = None):
        self.base_dir = base_dir or _base_dir()
        self.device = str(device)
        self.runner = runner
        self._lock = threading.Lock()
        self._busy = False
        self._seq = 0

    @property
    def busy(self) -> bool:
        return self._busy

    def capture(self, duration_ms: float) -> dict:
        """Run one bounded capture, blocking for its duration (the server
        runs it on the request's own thread, so streams keep flowing while
        it records them).

        Raises RuntimeError("busy") if a capture is already running, and
        ProfileError when the profiler cannot capture."""
        with self._lock:
            if self._busy:
                raise RuntimeError("busy")
            self._busy = True
            self._seq += 1
            seq = self._seq
        try:
            duration_s = max(0.05, min(duration_ms / 1000.0,
                                       _max_duration_s()))
            cap_id = f"cap-{seq}-{int(time.time())}"
            out_dir = os.path.join(self.base_dir, cap_id)
            os.makedirs(out_dir, exist_ok=True)
            source = self._run_capture(out_dir, duration_s)
            meta = {
                "id": cap_id,
                "source": source,
                "duration_s": duration_s,
                "created": time.time(),
            }
            with open(os.path.join(out_dir, "capture.json"), "w") as f:
                json.dump(meta, f, indent=1)
            return dict(meta, files=_dir_listing(out_dir))
        finally:
            with self._lock:
                self._busy = False

    @contextlib.contextmanager
    def reserve(self, timeout_s: float = 60.0):
        """Hold the process-global profiler for the caller's own session
        (a script that profiles the engine in process): a capture asked
        for meanwhile, on demand or by the anomaly detector, answers busy.
        Waits up to ``timeout_s`` for a running capture to end, else
        raises RuntimeError("busy")."""
        deadline = time.monotonic() + timeout_s
        while True:
            with self._lock:
                if not self._busy:
                    self._busy = True
                    break
            if time.monotonic() > deadline:
                raise RuntimeError("busy")
            time.sleep(0.01)
        try:
            yield
        finally:
            with self._lock:
                self._busy = False

    def _run(self, fn):
        return fn() if self.runner is None else self.runner(fn)

    def _run_capture(self, out_dir: str, duration_s: float) -> str:
        """``torch.profiler`` on a card, the sampler on the CPU. Returns
        the source tag recorded in capture.json."""
        if not self.device.startswith("cuda"):
            sampler = _SamplingProfiler()
            sampler.start()
            time.sleep(duration_s)
            sampler.stop_and_dump(out_dir)
            return "py-sampler"
        from torch.profiler import ProfilerActivity, profile

        try:
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self._run(prof.start)
        except Exception as e:
            raise ProfileError(f"torch.profiler could not start on {self.device}: "
                               f"{type(e).__name__}: {e}") from e
        try:
            time.sleep(duration_s)
        finally:
            try:
                self._run(prof.stop)
            except Exception as e:
                # the runner failed (the engine loop stopped mid-capture: the
                # server closed): stop the process-global session here, or it
                # stays on and its teardown at interpreter exit can crash
                try:
                    prof.stop()
                except Exception:
                    pass
                raise ProfileError(f"torch.profiler could not stop on {self.device}: "
                                   f"{type(e).__name__}: {e}") from e
        # written off the engine thread, by kineto's own writer: parsing the
        # events in Python (key_averages) would hold the interpreter lock
        # for seconds and stall the engine thread
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
        return "torch-profiler"

    # -- catalogue ------------------------------------------------------

    def list_captures(self) -> list[dict]:
        """All completed captures under base_dir, newest first."""
        out = []
        try:
            entries = sorted(os.listdir(self.base_dir))
        except OSError:
            return []
        for name in entries:
            if not _CAPTURE_ID_RE.match(name):
                continue
            path = os.path.join(self.base_dir, name)
            meta_path = os.path.join(path, "capture.json")
            meta = {"id": name}
            try:
                with open(meta_path) as f:
                    meta.update(json.load(f))
            except (OSError, ValueError):
                continue  # in-flight or mangled capture: not listable yet
            files = _dir_listing(path)
            meta["files"] = files
            meta["bytes"] = sum(f["bytes"] for f in files)
            out.append(meta)
        out.sort(key=lambda m: m.get("created", 0), reverse=True)
        return out

    def open_archive(self, capture_id: str) -> bytes | None:
        """The capture directory as .tar.gz bytes, or None if no such
        capture. The id is validated against the strict cap-N-STAMP shape
        (never joined raw into a path) so ../ traversal is impossible."""
        if not _CAPTURE_ID_RE.match(capture_id):
            return None
        path = os.path.join(self.base_dir, capture_id)
        if not os.path.isdir(path):
            return None
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w:gz") as tar:
            tar.add(path, arcname=capture_id)
        return buf.getvalue()
