"""The port's tenants and priority classes against the JAX package's.

- ``engine/qos.TenantFairQueue``: the JAX queue and the port's, fed the
  same seeded sequences of append / appendleft / popleft / remove / peek
  (weights, three classes, starvation aging on one injected clock), give
  the same heads and the same pop order, exactly.
- ``server/qos.py``: every replica-side check of
  ``tests/data/qos_vectors.json`` (Retry-After, the token charge, tenant
  and priority resolution).
- ``EngineConfig`` refuses the QoS values the JAX config refuses and
  normalizes the maps as it does.
- debug-tiny in float32, the JAX weights on both sides: admission order,
  per-tenant accounting and preemption victims equal the JAX engine's;
  greedy streams with QoS on equal those with it off, and the JAX
  engine's. Tolerance: token streams exact.
"""

import json
import pathlib

import jax
import numpy as np
import pytest

from llms_on_kubernetes_tpu.configs import get_config as jget_config
from llms_on_kubernetes_tpu.engine import qos as jqos
from llms_on_kubernetes_tpu.engine.engine import Engine as JEngine
from llms_on_kubernetes_tpu.engine.engine import EngineConfig as JEngineConfig
from llms_on_kubernetes_tpu.engine.engine import SamplingParams as JSamplingParams
from llms_on_kubernetes_tpu.models.decoder import init_params as j_init_params
from llms_on_kubernetes_tpu.server import qos as jsqos
from llms_on_kubernetes_tpu_torch.engine import qos as tqos
from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
from llms_on_kubernetes_tpu_torch.engine.weights import params_from_numpy
from llms_on_kubernetes_tpu_torch.server import qos as tsqos

VECTORS = json.loads(
    (pathlib.Path(__file__).parent / "data" / "qos_vectors.json").read_text())
SMALL = dict(model="debug-tiny", dtype="float32", max_decode_slots=4, page_size=8,
             num_pages=64, pages_per_slot=8, prefill_buckets=(16, 32))
GREEDY = dict(temperature=0.0)


class _Req:
    def __init__(self, i, tenant, priority, submitted_at):
        self.id, self.tenant, self.priority, self.submitted_at = i, tenant, priority, submitted_at


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _drive(mod, ops, weights, default_weight, starvation_s):
    """Apply ``ops`` to a queue of ``mod``; the trace of every answer. An
    appendleft re-queues the request popped last (a preemption victim)."""
    clock = _Clock()
    q = mod.TenantFairQueue(weights=weights, default_weight=default_weight,
                            starvation_s=starvation_s, clock=clock)
    reqs: dict = {}
    popped: list = []
    out = []
    for op in ops:
        kind = op[0]
        clock.t = op[-1]
        if kind == "append":
            r = reqs[op[1]] = _Req(op[1], op[2], op[3], op[-1])
            q.append(r)
        elif kind == "appendleft":
            if popped:
                r = popped.pop()
                q.appendleft(r)
                out.append(("requeued", r.id))
        elif kind == "remove":
            try:
                if op[1] not in reqs:
                    raise ValueError("never appended")
                q.remove(reqs[op[1]])
                out.append(("removed", op[1]))
            except ValueError:
                out.append(("absent", op[1]))
        elif kind == "peek":
            h = q.peek()
            out.append(("peek", None if h is None else h.id))
        elif kind == "popleft":
            try:
                r = q.popleft()
                popped.append(r)
                out.append(("pop", r.id))
            except IndexError:
                out.append(("empty",))
        out.append(("len", len(q), [r.id for r in q]))
    while len(q):
        out.append(("drain", q.popleft().id))
    return out


def _ops(seed: int, n: int = 300):
    rng = np.random.default_rng(seed)
    tenants = ["a", "b", "c", "", "d"]
    classes = ["interactive", "normal", "batch", "bogus", None]
    ops, t, nid = [], 0.0, 0
    for _ in range(n):
        t += float(rng.choice([0.0, 0.1, 0.7, 2.5]))
        x = rng.random()
        if x < 0.4:
            ops.append(("append", nid, str(rng.choice(tenants)),
                        classes[int(rng.integers(len(classes)))], t))
            nid += 1
        elif x < 0.55:
            ops.append(("peek", t))
        elif x < 0.8:
            ops.append(("popleft", t))
        elif x < 0.9:
            ops.append(("appendleft", t))
        else:
            ops.append(("remove", int(rng.integers(max(nid, 1))), t))
    return ops


@pytest.mark.parametrize("seed,weights,dw,starve", [
    (0, {}, 1.0, 5.0),
    (1, {"a": 4.0, "b": 1.0, "c": 0.5}, 1.0, 0.0),
    (2, {"a": 0.01, "d": 3.0}, 2.0, 3.0),
    (3, {"b": 2.5}, 0.3, 1.0),
])
def test_fair_queue_pop_order_equals_jax(seed, weights, dw, starve):
    ops = _ops(seed)
    want = _drive(jqos, ops, weights, dw, starve)
    assert any(e[0] == "requeued" for e in want) and any(e[0] == "removed" for e in want)
    got = _drive(tqos, ops, weights, dw, starve)
    assert got == want


def test_priority_helpers_equal_jax():
    for p in ("interactive", "normal", "batch", "BATCH ", "vip", "", None):
        assert tqos.priority_rank(p) == jqos.priority_rank(p)
        for d in ("normal", "batch", "junk"):
            assert tqos.normalize_priority(p, d) == jqos.normalize_priority(p, d)
    assert tqos.PRIORITIES == jqos.PRIORITIES and tqos.MIN_WEIGHT == jqos.MIN_WEIGHT


@pytest.mark.parametrize("case", VECTORS["retry_after"])
def test_vector_retry_after(case):
    assert tsqos.retry_after_s(case["seconds"]) == case["expect"]


@pytest.mark.parametrize("case", VECTORS["token_charge"])
def test_vector_token_charge(case):
    assert tsqos.default_token_charge(case["doc"]) == case["expect"]


@pytest.mark.parametrize("case", VECTORS["resolve"])
def test_vector_resolve(case):
    """The replica's resolution (tenant_of, then resolve_priority over the
    tenant's configured class), which the vectors hold the routers to."""
    cfg = jsqos.QoSConfig(case["config"])
    tenant = tsqos.tenant_of(case["doc"], case["resolved_model"])
    priority = tsqos.resolve_priority(case["header"], cfg.entry(tenant)["priority"],
                                      cfg.default["priority"] or "normal")
    assert (tenant, priority) == (case["expect_tenant"], case["expect_priority"])
    assert priority == jsqos.resolve_priority(case["header"], cfg.entry(tenant)["priority"],
                                              cfg.default["priority"] or "normal")


def test_server_qos_functions_equal_jax():
    docs = [None, {}, {"user": "u"}, {"user": ""}, {"model": "m:x"}, {"user": 3, "model": ""},
            {"max_tokens": 0}, {"max_tokens": 7.9}, {"max_tokens": True}]
    for doc in docs:
        assert tsqos.tenant_of(doc, "srv") == jsqos.tenant_of(doc, "srv")
        assert tsqos.default_token_charge(doc) == jsqos.default_token_charge(doc)
    for h in (None, "Batch", " interactive ", "vip"):
        for tp in (None, "normal", "BATCH", "junk"):
            for d in ("normal", "batch", "junk"):
                assert tsqos.resolve_priority(h, tp, d) == jsqos.resolve_priority(h, tp, d)
    for sec in (-3, 0, 0.5, 1.0001, 59.2, 61, 1e9):
        assert tsqos.retry_after_s(sec) == jsqos.retry_after_s(sec)
    assert tsqos.PRIORITY_HEADER == jsqos.PRIORITY_HEADER


@pytest.mark.parametrize("bad", [
    dict(qos_weights={"a": 0.0}), dict(qos_weights=(("a", -1.0),)),
    dict(qos_priorities={"a": "vip"}), dict(qos_default_priority="urgent"),
    dict(qos_default_weight=0.001), dict(role="router"),
    dict(role="prefill", kv_host_cache_gb=0),
])
def test_engine_config_refuses_what_jax_refuses(bad):
    with pytest.raises(ValueError):
        JEngineConfig(**SMALL, **bad)
    with pytest.raises(ValueError):
        EngineConfig(**SMALL, device="cpu", **bad)


def test_engine_config_normalizes_as_jax(monkeypatch):
    monkeypatch.delenv("LLMK_ROLE", raising=False)
    monkeypatch.delenv("LLMK_KV_HOST_CACHE_GB", raising=False)
    kw = dict(qos_weights={"b": 2, "a": 1}, qos_priorities={"x": "batch"},
              kv_host_cache_gb=-1.0)
    j, t = JEngineConfig(**SMALL, **kw), EngineConfig(**SMALL, device="cpu", **kw)
    for f in ("qos_weights", "qos_priorities", "kv_host_cache_gb", "role"):
        assert getattr(t, f) == getattr(j, f), f
    monkeypatch.setenv("LLMK_ROLE", "decode")
    monkeypatch.setenv("LLMK_KV_HOST_CACHE_GB", "0.25")
    j, t = JEngineConfig(**SMALL), EngineConfig(**SMALL, device="cpu")
    assert (t.role, t.kv_host_cache_gb) == (j.role, j.kv_host_cache_gb) == ("decode", 0.25)


# -- the engines --------------------------------------------------------


@pytest.fixture(scope="module")
def jparams():
    return j_init_params(jget_config("debug-tiny"), jax.random.key(0), dtype="float32")


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _pair(jparams, tparams, **kw):
    return (JEngine(JEngineConfig(**{**SMALL, **kw}), params=jparams),
            Engine(EngineConfig(**{**SMALL, "device": "cpu", **kw}), params=tparams))


def _run(eng, limit=20_000):
    for _ in range(limit):
        if not eng.has_work():
            return
        eng.step()
    raise AssertionError("engine did not drain")


@pytest.mark.parametrize("async_scheduling", [False, True])
def test_admission_order_and_accounting_equal_jax(jparams, tparams, async_scheduling):
    """One slot, a mixed backlog of tenants and classes: the order in which
    requests are seated, and the per-(tenant, class) admission counts,
    equal the JAX engine's."""
    subs = [("bulk", "batch"), ("fe", "interactive"), ("a", None), ("b", None),
            ("a", None), ("bulk", "batch"), ("fe", "interactive"), ("b", None)]
    orders, counts = [], []
    for eng, SP in zip(_pair(jparams, tparams, max_decode_slots=1,
                             qos_weights={"a": 3.0, "b": 1.0}, qos_starvation_s=0,
                             async_scheduling=async_scheduling),
                       (JSamplingParams, SamplingParams)):
        reqs = [eng.submit([7 + i, 8, 9], SP(max_tokens=2, **GREEDY), tenant=t, priority=p)
                for i, (t, p) in enumerate(subs)]
        _run(eng)
        assert all(r.finished for r in reqs)
        orders.append([reqs.index(r) for r in sorted(reqs, key=lambda r: r.admitted_at)])
        counts.append(dict(eng.tenant_admitted))
        assert {t for t, _w, _p in eng.tenant_wait_obs} == {t for t, _p in subs}
    assert orders[1] == orders[0]
    assert orders[0][:2] == [1, 6]          # interactive overtakes the backlog
    assert counts[1] == counts[0]


def test_preemption_victims_equal_jax(jparams, tparams):
    """A pool sized to force preemption: the victims (lowest class, then
    youngest) are the JAX engine's, in order, and the streams equal the
    ones a roomy pool gives."""
    prompts = [[3, 17, 9], [40, 2, 8, 11], [7, 7, 7], [5, 6]]
    prios = ["interactive", "batch", "normal", "batch"]
    victims, streams = [], []
    for eng, SP in zip(_pair(jparams, tparams, num_pages=8, max_decode_slots=4,
                             qos_starvation_s=0),
                       (JSamplingParams, SamplingParams)):
        reqs = [eng.submit(p, SP(max_tokens=14, **GREEDY), tenant=f"t{i}", priority=pr)
                for i, (p, pr) in enumerate(zip(prompts, prios))]
        seen = []
        orig = eng._preempt_youngest

        def spy(orig=orig, eng=eng, reqs=reqs, seen=seen):
            before = {id(r) for r in eng.slots if r is not None}
            lowest = max(tqos.priority_rank(r.priority) for r in eng.slots if r is not None)
            orig()
            after = {id(r) for r in eng.slots if r is not None}
            (gone,) = [i for i, r in enumerate(reqs) if id(r) in before - after]
            # the victim is of the lowest class seated (batch while one runs)
            assert tqos.priority_rank(prios[gone]) == lowest
            seen.append(gone)

        eng._preempt_youngest = spy
        _run(eng)
        assert all(r.finished for r in reqs)
        victims.append(seen)
        streams.append([r.output for r in reqs])
    assert victims[0], "the pool was sized to force preemption"
    assert victims[1] == victims[0]
    assert streams[1] == streams[0]
    roomy = Engine(EngineConfig(**SMALL, device="cpu", async_scheduling=False),
                   params=tparams)
    assert streams[1] == [roomy.generate(p, SamplingParams(max_tokens=14, **GREEDY))
                          for p in prompts]


@pytest.mark.parametrize("async_scheduling", [False, True])
def test_greedy_streams_with_qos_equal_off_and_jax(jparams, tparams, async_scheduling):
    prompts = [[3, 17, 9], [40, 2], [7, 7, 7, 7], [100, 42, 5, 1, 9], [1, 2, 3, 4, 5, 6]]
    tenants = ["a", "b", "a", "b", "c"]
    prios = [None, "batch", "interactive", None, "batch"]
    off = Engine(EngineConfig(**SMALL, device="cpu", async_scheduling=async_scheduling),
                 params=tparams)
    roff = [off.submit(p, SamplingParams(max_tokens=8, **GREEDY)) for p in prompts]
    _run(off)
    outs = []
    for eng, SP in zip(_pair(jparams, tparams, qos_weights={"a": 3.0, "b": 1.0},
                             qos_priorities={"b": "batch"}, max_decode_slots=2,
                             async_scheduling=async_scheduling),
                       (JSamplingParams, SamplingParams)):
        reqs = [eng.submit(p, SP(max_tokens=8, **GREEDY), tenant=t, priority=pr)
                for p, t, pr in zip(prompts, tenants, prios)]
        _run(eng)
        outs.append([r.output for r in reqs])
    assert outs[1] == [r.output for r in roff]
    assert outs[1] == outs[0]


def test_serve_reads_llmk_qos_and_the_role_as_jax(monkeypatch):
    """``serve`` takes the fair-queue config from LLMK_QOS (the JAX CLI's
    keys) and the role from LLMK_ROLE; --kv-host-cache-gb wins over
    LLMK_KV_HOST_CACHE_GB, and a prefill role with the flag parses."""
    from llms_on_kubernetes_tpu_torch.cli import build_parser, engine_config_from_args

    base = ["serve", "--model", "debug-tiny", "--random-weights", "--device", "cpu"]
    monkeypatch.setenv("LLMK_QOS", json.dumps({
        "weights": {"alice": 4}, "priorities": {"bulk": "batch"},
        "default_priority": "interactive", "default_weight": 2, "starvation_s": 7}))
    monkeypatch.setenv("LLMK_ROLE", "prefill")
    monkeypatch.setenv("LLMK_KV_HOST_CACHE_GB", "0.5")
    cfg = engine_config_from_args(build_parser().parse_args(base + ["--kv-host-cache-gb", "2"]))
    assert (cfg.role, cfg.kv_host_cache_gb) == ("prefill", 2.0)
    assert cfg.qos_weights == (("alice", 4.0),) and cfg.qos_priorities == (("bulk", "batch"),)
    assert (cfg.qos_default_priority, cfg.qos_default_weight, cfg.qos_starvation_s) == \
        ("interactive", 2.0, 7.0)
    monkeypatch.setenv("LLMK_ROLE", "decode")
    assert engine_config_from_args(build_parser().parse_args(base)).kv_host_cache_gb == 0.5
    monkeypatch.setenv("LLMK_QOS", "{not json")
    with pytest.raises(SystemExit):
        engine_config_from_args(build_parser().parse_args(base))
