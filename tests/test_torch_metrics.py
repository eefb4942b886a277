"""The port's /metrics and /ready advertisement against the JAX package's.

- The exposition after real requests passes ``scripts/metrics_lint.lint``
  with the identity series required, every series it renders is one the
  JAX servers emit (``known_emitted_names``), and each metric keeps the
  JAX metric's name, kind, help, label names and buckets.
- ``BloomFilter.serialize()`` is byte-equal to the JAX filter's for the
  same digests, and the port engine's ``prefix_filter_digests()`` equal
  the JAX engine's after the same prompts (debug-tiny, float32, the JAX
  weights on both sides).
"""

import json
import sys
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest

from llms_on_kubernetes_tpu.configs import get_config as jget_config
from llms_on_kubernetes_tpu.engine.engine import Engine as JEngine
from llms_on_kubernetes_tpu.engine.engine import EngineConfig as JEngineConfig
from llms_on_kubernetes_tpu.engine.engine import SamplingParams as JSamplingParams
from llms_on_kubernetes_tpu.models.decoder import init_params as j_init_params
from llms_on_kubernetes_tpu.server import affinity as jaffinity
from llms_on_kubernetes_tpu.server import metrics as jmetrics
from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
from llms_on_kubernetes_tpu_torch.engine.tokenizer import ByteTokenizer
from llms_on_kubernetes_tpu_torch.engine.weights import params_from_numpy
from llms_on_kubernetes_tpu_torch.server import affinity as taffinity
from llms_on_kubernetes_tpu_torch.server import metrics as tmetrics
from llms_on_kubernetes_tpu_torch.server.openai_api import OpenAIServer

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
import metrics_lint  # noqa: E402

SMALL = dict(model="debug-tiny", dtype="float32", max_decode_slots=4, page_size=8,
             num_pages=64, pages_per_slot=8, prefill_buckets=(16, 32))
# the third shares the second's first three pages: a prefix-cache hit
PROMPTS = ("abc", "a longer prompt that fills pages", "a longer prompt that fills")


def _get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read()


def _post(url: str, body: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def scraped():
    """The exposition of a port server after three requests (the third a
    prefix-cache hit) and a /ready probe."""
    eng = Engine(EngineConfig(**SMALL, device="cpu"))
    srv = OpenAIServer(eng, ByteTokenizer(), "debug-tiny", cold_start={"load": 0.25})
    base = f"http://127.0.0.1:{srv.start()}"
    try:
        for prompt in PROMPTS:
            _post(base + "/v1/completions", {"prompt": prompt, "max_tokens": 5,
                                             "temperature": 0})
        _get(base + "/ready")
        yield _get(base + "/metrics").decode(), eng
    finally:
        srv.close()


def test_exposition_passes_the_lint(scraped):
    text, _ = scraped
    assert metrics_lint.lint(text, "port", require=metrics_lint.REQUIRED_SERIES) == []


def test_every_series_is_one_the_jax_servers_emit(scraped):
    text, _ = scraped
    known = metrics_lint.known_emitted_names()
    names = {line.split("{")[0].split(" ")[0] for line in text.splitlines()
             if line and not line.startswith("#")}
    assert names and names <= known, sorted(names - known)


def test_metric_definitions_equal_the_jax_ones():
    jreg, treg = jmetrics.Registry(), tmetrics.Registry()
    jmetrics.engine_metrics(jreg)
    jmetrics.build_info_metrics(jreg, backend="gpu")
    tmetrics.engine_metrics(treg)
    tmetrics.build_info_metrics(treg, backend="gpu")
    jby = {m.name: m for m in jreg._metrics}
    for m in treg._metrics:
        j = jby[m.name]
        assert (type(m).__name__, m.help, m.label_names) == \
            (type(j).__name__, j.help, j.label_names), m.name
        if isinstance(m, tmetrics.Histogram):
            assert m.buckets == j.buckets, m.name


def test_serving_series_follow_the_requests(scraped):
    text, eng = scraped
    values = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, v = line.rpartition(" ")
            values[key] = float(v)
    assert values["llm_requests_total"] == values["llm_requests_finished_total"] == 3
    assert values["llm_tokens_generated_total"] == 15
    assert values["llm_prompt_tokens_total"] == sum(len(p) for p in PROMPTS)
    assert values['llm_ttft_seconds_count{model="debug-tiny"}'] == 3
    assert values['llm_e2e_latency_seconds_count{model="debug-tiny"}'] == 3
    assert values['llm_decode_step_seconds_count{model="debug-tiny"}'] >= 3
    assert values['llm_queue_depth{model="debug-tiny",role="both"}'] == 0
    assert values["llm_prefix_cache_hit_tokens_total"] == eng.allocator.hit_tokens_total > 0
    assert values["llm_kv_bytes_per_token"] == eng.cache_config.bytes_per_token
    assert values["llm_engine_state"] == 1
    assert values['llm_cold_start_seconds_count{phase="load"}'] == 1
    assert values['llm_cold_start_seconds_count{phase="ready"}'] == 1
    assert 'llm_build_info{version="0.1.0",jax="none",backend="cpu",role="both"}' in values


@pytest.mark.parametrize("bits,hashes", [(8192, 4), (1000, 3), (64, 1), (8, 9)])
def test_bloom_filter_bytes_equal_jax(rng, bits, hashes):
    digests = [rng.bytes(32) for _ in range(int(rng.integers(0, 60)))]
    j, t = jaffinity.BloomFilter(bits, hashes), taffinity.BloomFilter(bits, hashes)
    for d in digests:
        j.add(d)
        t.add(d)
    assert t.serialize() == j.serialize()
    assert all(t.contains(d) for d in digests)
    parsed = jaffinity.BloomFilter.parse(t.serialize())
    assert parsed is not None and all(parsed.contains(d) for d in digests)


def test_prefix_filter_digests_equal_the_jax_engine():
    jparams = j_init_params(jget_config("debug-tiny"), jax.random.key(0), dtype="float32")
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    prompts = [list(range(1, 20)), list(range(1, 30)), list(range(40, 75)), [3, 4]]
    jeng = JEngine(JEngineConfig(**SMALL), params=jparams)
    teng = Engine(EngineConfig(**SMALL, device="cpu"), params=tparams)
    for p in prompts:
        jeng.generate(p, JSamplingParams(temperature=0.0, max_tokens=3))
        teng.generate(p, SamplingParams(temperature=0.0, max_tokens=3))
    got, want = teng.prefix_filter_digests(), jeng.prefix_filter_digests()
    assert len(got) >= 6 and got == want
    jf, tf = jaffinity.BloomFilter(), taffinity.BloomFilter()
    for d in want:
        jf.add(d)
    for d in got:
        tf.add(d)
    assert tf.serialize() == jf.serialize()


def test_ready_advertises_the_filter_of_the_cache(scraped, monkeypatch):
    _, eng = scraped
    want = taffinity.BloomFilter()
    for d in eng.prefix_filter_digests():
        want.add(d)
    srv = OpenAIServer(eng, ByteTokenizer(), "debug-tiny")
    assert srv.prefix_filter_doc() == want.serialize()
    monkeypatch.setenv("LLMK_PREFIX_FILTER_BITS", "0")
    assert OpenAIServer(eng, ByteTokenizer(), "debug-tiny").prefix_filter_doc() is None
