"""The port's ``serve`` command line against the JAX one's.

- A bare ``serve`` parses to the JAX ``serve``'s defaults for every option
  both have: 2,048 pages of 64 tokens, 64 pages a slot and buckets
  256/1024/4096, so a replica rendered from a spec gets the JAX context
  length (4,096 tokens).
- Every JAX ``serve`` option is the port's too, but for the parallelism
  ones the port does not have yet; the five that were missing, and
  ``--max-images-per-request``, reach ``EngineConfig``.
- The warm-up (JAX ``cli.py``: a 4-token prompt for 2 tokens) runs before
  ``/health`` answers, and ``--no-warmup`` skips it: a CPU server's
  ``/debug/kernels`` counts one prefill at its first ``/health``, or none.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

from llms_on_kubernetes_tpu import cli as jcli
from llms_on_kubernetes_tpu_torch import cli

REPO = Path(__file__).resolve().parent.parent
# JAX serve options the port does not have yet (ROADMAP queue 1 item 4)
NOT_PORTED = {"--tensor-parallel-size", "--tp", "--expert-parallel-size", "--ep",
              "--sequence-parallel-size", "--sp"}


def _serve_parsers():
    ap = argparse.ArgumentParser()
    jcli._add_serve(ap.add_subparsers(dest="cmd"))
    jserve = ap._subparsers._group_actions[0].choices["serve"]
    tserve = cli.build_parser()._subparsers._group_actions[0].choices["serve"]
    return jserve, tserve


def test_bare_serve_defaults_equal_jax():
    jserve, tserve = _serve_parsers()
    jargs = vars(jserve.parse_args(["--model", "m"]))
    targs = vars(tserve.parse_args(["--model", "m"]))
    shared = sorted(set(jargs) & set(targs))
    assert {"num_pages", "pages_per_slot", "prefill_buckets", "warmup", "ledger"} <= set(shared)
    for name in shared:
        want = jargs[name]
        if name == "prefill_buckets":          # the JAX CLI splits the string later
            want = tuple(int(b) for b in want.split(","))
        assert targs[name] == want, name
    cfg = cli.engine_config_from_args(cli.build_parser().parse_args(
        ["serve", "--model", "debug-tiny", "--random-weights", "--device", "cpu"]))
    assert cfg.max_model_len == 4096
    assert (cfg.num_pages, cfg.pages_per_slot, cfg.prefill_buckets) == (2048, 64,
                                                                        (256, 1024, 4096))


def test_serve_options_cover_the_jax_ones():
    jserve, tserve = _serve_parsers()
    jopts = {o for a in jserve._actions for o in a.option_strings}
    topts = {o for a in tserve._actions for o in a.option_strings}
    assert jopts - NOT_PORTED <= topts, sorted(jopts - NOT_PORTED - topts)
    cfg = cli.engine_config_from_args(cli.build_parser().parse_args(
        ["serve", "--model", "debug-mm", "--random-weights", "--device", "cpu",
         "--max-images-per-request", "2"]))
    assert cfg.max_images_per_request == 2


def test_ledger_and_anomaly_flags_reach_the_engine_config(monkeypatch):
    base = ["serve", "--model", "debug-tiny", "--random-weights", "--device", "cpu"]
    monkeypatch.setenv("LLMK_ANOMALY_Z", "7.5")
    cfg = cli.engine_config_from_args(cli.build_parser().parse_args(base))
    assert (cfg.ledger, cfg.anomaly_profile, cfg.anomaly_z) == (True, True, 7.5)
    cfg = cli.engine_config_from_args(cli.build_parser().parse_args(
        base + ["--no-ledger", "--no-anomaly-profile", "--anomaly-z", "3",
                "--anomaly-cooldown-s", "5"]))
    assert (cfg.ledger, cfg.anomaly_profile, cfg.anomaly_z, cfg.anomaly_cooldown_s) == \
        (False, False, 3.0, 5.0)
    assert cli.build_parser().parse_args(base + ["--no-warmup"]).warmup is False


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url: str):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


@pytest.mark.parametrize("warmup", [True, False])
def test_warmup_runs_before_health(tmp_path, warmup):
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    log = open(tmp_path / "server.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "llms_on_kubernetes_tpu_torch", "serve", "--model", "debug-tiny",
         "--random-weights", "--device", "cpu", "--host", "127.0.0.1", "--port", str(port),
         "--dtype", "float32", "--max-decode-slots", "2", "--num-pages", "64",
         "--page-size", "8", "--pages-per-slot", "8", "--prefill-buckets", "16,32"]
        + ([] if warmup else ["--no-warmup"]),
        cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        base = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 180
        while True:
            assert proc.poll() is None, (tmp_path / "server.log").read_text()
            try:
                if _get(base + "/health")[0] == 200:
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline, "no /health in 180 s"
            time.sleep(0.2)
        kernels = json.loads(_get(base + "/debug/kernels")[1])
        metrics = _get(base + "/metrics")[1]
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        log.close()
    assert kernels["prefill_calls"] == (1 if warmup else 0)
    assert ('llm_cold_start_seconds_count{phase="compile"} 1' in metrics) == warmup
    assert ("warmup complete" in (tmp_path / "server.log").read_text()) == warmup
