"""The port's default scheduler on the CPU: pipelined decode windows, the
harvester, on-demand pages and preemption (counterparts of
tests/test_engine_async.py and tests/test_decode_multistep.py).

debug-tiny in float32 with the JAX ``init_params`` weights on both sides.
Tolerance: token streams exact. Greedy streams of the port's async engine
must equal the JAX engine's under the same config (async, same depth and
K), across kv_write and int8 KV, and must not change under preemption; a
seeded sampled stream with penalties must not change under preemption
either (its penalty counts are rebuilt from the replayed output).
"""

import threading

import jax
import numpy as np
import pytest
import torch

from llms_on_kubernetes_tpu.configs import get_config as jget_config
from llms_on_kubernetes_tpu.engine.engine import Engine as JEngine
from llms_on_kubernetes_tpu.engine.engine import EngineConfig as JEngineConfig
from llms_on_kubernetes_tpu.engine.engine import SamplingParams as JSamplingParams
from llms_on_kubernetes_tpu.models.decoder import init_params as j_init_params
from llms_on_kubernetes_tpu_torch import kernels
from llms_on_kubernetes_tpu_torch.engine import engine as tengine
from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
from llms_on_kubernetes_tpu_torch.engine.weights import params_from_numpy
from llms_on_kubernetes_tpu_torch.ops import paged_attention as tpaged

# tests/test_engine_async.py's engine and prompts
SMALL = dict(model="debug-tiny", dtype="float32", max_decode_slots=4, page_size=8,
             num_pages=64, pages_per_slot=8, prefill_buckets=(16, 32))
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10], [11, 12, 13, 14], [2, 4, 6, 8, 10, 12],
           [3, 1, 4, 1, 5]]
GREEDY = dict(temperature=0.0, max_tokens=12)


@pytest.fixture(scope="module")
def jparams():
    return j_init_params(jget_config("debug-tiny"), jax.random.key(0), dtype="float32")


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _port(tparams, **kw):
    return Engine(EngineConfig(**{**SMALL, "device": "cpu", **kw}), params=tparams)


def _jax(jparams, **kw):
    kw = {k: v for k, v in kw.items() if k != "kv_write"}
    return JEngine(JEngineConfig(**{**SMALL, **kw}), params=jparams)


def _run(eng, prompts, params):
    """Submit every prompt (``params``: one for all, or one per prompt),
    step until each finishes, then drain; returns the requests."""
    params = params if isinstance(params, list) else [params] * len(prompts)
    reqs = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
    for _ in range(10_000):
        if all(r.finished for r in reqs):
            break
        eng.step()
    assert all(r.finished for r in reqs)
    for _ in range(1_000):
        if not eng.has_work():
            break
        eng.step()
    assert not eng.has_work()
    return reqs


def _streams(reqs):
    return [(r.output, r.finish_reason) for r in reqs]


CASES = [dict(async_depth=1), dict(async_depth=2), dict(async_depth=3),
         dict(decode_steps=1), dict(decode_steps=1, async_depth=3),
         dict(kv_write="fused"), dict(kv_write="fused", decode_steps=1),
         dict(kv_cache_dtype="int8"), dict(kv_cache_dtype="int8", decode_steps=1),
         dict(kv_cache_dtype="int8", kv_write="fused"), dict(admit_batch=1)]
CASE_IDS = ["depth1", "depth2", "depth3", "k1", "k1_depth3", "fused", "fused_k1", "int8",
            "int8_k1", "int8_fused", "admit1"]


@pytest.mark.parametrize("kw", CASES, ids=CASE_IDS)
def test_async_greedy_streams_equal_jax_engine(jparams, tparams, kw):
    """Six prompts over four slots (continuous admission in both buckets'
    range): the port's async streams are the JAX async engine's under the
    same depth and K, and the port's sync engine's."""
    want = _streams(_run(_jax(jparams, **kw), PROMPTS, JSamplingParams(**GREEDY)))
    eng = _port(tparams, **kw)
    assert _streams(_run(eng, PROMPTS, SamplingParams(**GREEDY))) == want
    sync = _port(tparams, async_scheduling=False, **kw)
    assert _streams(_run(sync, PROMPTS, SamplingParams(**GREEDY))) == want
    assert eng.decode_forwards > 0 and eng.graph_replays == 0     # the CPU runs eagerly


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_async_matches_sync_with_stop_tokens_mid_window(tparams, depth):
    """A stop token inside a K=4 window finishes the row where K=1 sync
    does: the device mask keeps later window steps out of the stream."""
    probe = _run(_port(tparams, async_scheduling=False, decode_steps=1), PROMPTS[:1],
                 SamplingParams(**GREEDY))[0].output
    sp = SamplingParams(stop_token_ids=(probe[5],), **GREEDY)
    want = _streams(_run(_port(tparams, async_scheduling=False, decode_steps=1), PROMPTS, sp))
    assert any(reason == "stop" for _out, reason in want)
    got = _streams(_run(_port(tparams, async_depth=depth), PROMPTS, sp))
    assert got == want


@pytest.mark.parametrize("kw", [dict(), dict(async_scheduling=False),
                                dict(kv_cache_dtype="int8"),
                                dict(kv_cache_dtype="int8", async_scheduling=False)],
                         ids=["async", "sync", "async_int8", "sync_int8"])
def test_preemption_recovers_and_matches(jparams, tparams, kw):
    """tests/test_engine_async.py:59: 11 pages (10 usable) for four
    requests that each grow to 3 pages. Some request is preempted, resumes
    by re-prefilling its prompt and output, and every stream equals the
    JAX engine's under the same config and the port's with room to spare."""
    prompts = [[1, 2, 3]] * 4
    tight = _port(tparams, num_pages=11, **kw)
    got = _streams(_run(tight, prompts, SamplingParams(temperature=0.0, max_tokens=20)))
    assert tight.preemptions > 0
    roomy = _port(tparams, **kw)
    assert got == _streams(_run(roomy, prompts, SamplingParams(temperature=0.0,
                                                               max_tokens=20)))
    assert roomy.preemptions == 0
    jeng = _jax(jparams, num_pages=11, **kw)
    assert got == _streams(_run(jeng, prompts, JSamplingParams(temperature=0.0,
                                                               max_tokens=20)))
    # every page is back: free, or cached for prefix reuse
    alloc = tight.allocator
    assert alloc.num_free_pages + alloc.num_evictable_pages == 10


def _preempted_output_lengths(eng):
    """How many output tokens each request ``eng`` preempts holds then."""
    seen = []
    preempt = eng._preempt_youngest

    def recording():
        victim = max((r for r in eng.slots if r is not None), key=lambda r: r.submitted_at)
        seen.append(len(victim.output))
        preempt()

    eng._preempt_youngest = recording
    return seen


@pytest.mark.parametrize("kw", [dict(), dict(async_scheduling=False),
                                dict(kv_cache_dtype="int8"),
                                dict(kv_cache_dtype="int8", async_scheduling=False),
                                dict(async_depth=1, kv_write="fused")],
                         ids=["async", "sync", "async_int8", "sync_int8", "depth1_fused"])
def test_preemption_right_after_the_first_token(jparams, tparams, kw):
    """Four 7-token prompts (prompt + 1 fills a page) in 4 usable pages:
    admission takes them all, the first window's growth needs more, so
    the youngest are preempted holding one output token. A resumed request
    is one with output, though it re-prefills its prompt alone: its
    pending token is restored, not sampled and emitted a second time, and
    every stream equals the JAX engine's and the port's roomy run."""
    prompts = [[1 + i, 2, 3 + i, 4, 5 + i, 6, 7] for i in range(4)]
    sp = SamplingParams(temperature=0.0, max_tokens=12)
    tight = _port(tparams, num_pages=5, **kw)
    outputs_at = _preempted_output_lengths(tight)
    got = _streams(_run(tight, prompts, sp))
    assert tight.preemptions > 0 and 1 in outputs_at
    assert got == _streams(_run(_port(tparams, **kw), prompts, sp))
    jeng = _jax(jparams, num_pages=5, **kw)
    assert got == _streams(_run(jeng, prompts, JSamplingParams(temperature=0.0,
                                                               max_tokens=12)))


@pytest.mark.parametrize("async_scheduling", [True, False], ids=["async", "sync"])
def test_seeded_penalized_stream_unchanged_by_preemption(tparams, async_scheduling):
    """Seeded sampling with presence and frequency penalties: the stream
    is keyed on (seed, position) and the penalty counts of a resumed
    request are rebuilt from its replayed output, so preemption changes
    nothing."""
    params = [SamplingParams(temperature=0.9, top_k=16, seed=100 + i, presence_penalty=0.5,
                             frequency_penalty=0.7, max_tokens=20) for i in range(4)]
    prompts = [[1, 2, 3], [4, 5, 6], [7, 8, 9], [1, 2, 3]]
    tight = _port(tparams, num_pages=11, async_scheduling=async_scheduling)
    got = _streams(_run(tight, prompts, params))
    assert tight.preemptions > 0
    roomy = _port(tparams, async_scheduling=async_scheduling)
    assert got == _streams(_run(roomy, prompts, params))
    # the penalties really bite: without them the stream differs
    plain = [SamplingParams(temperature=0.9, top_k=16, seed=100 + i, max_tokens=20)
             for i in range(4)]
    assert _streams(_run(_port(tparams), prompts, plain)) != got


def test_resumed_request_that_no_longer_fits_finishes_with_length(tparams):
    """A preempted request whose prompt + output no longer fits a slot's
    pages ends with "length" at re-admission instead of blocking the
    queue."""
    eng = _port(tparams, async_scheduling=False)
    req = eng.submit([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=30))
    while len(req.output) < 2:
        eng.step()
    eng._preempt_youngest()
    assert eng.preemptions == 1 and eng.waiting[0] is req and req.slot == -1
    req.output += [7] * 61          # as if it had grown to 64 tokens before
    events = eng.step()
    assert req.finished and req.finish_reason == "length"
    assert any(ev.request is req and ev.finished for ev in events)


class DemandGate:
    """Holds each decode window's completion until the engine thread blocks
    for it. On the CPU a window is computed inside its launch, so the
    harvester could mark it done at any moment and whether a window is
    still in flight after a step would depend on thread scheduling. Behind
    the gate the harvester reads window ``s`` only once the engine thread
    has called ``wait_done(t)`` with t >= s (backpressure or a drain), or
    after ``release()``; the non-blocking ``_collect_ready`` sees nothing
    else done. Prefill reads pass freely."""

    def __init__(self, harvester):
        self._cv = threading.Condition()
        self._demand = -1
        self._open = False
        push, wait_done = harvester.push, harvester.wait_done
        gate = self

        class Gated:
            def __init__(self, key, copy):
                self.key, self.copy = key, copy

            def read(self):
                with gate._cv:
                    gate._cv.wait_for(lambda: gate._open or gate._demand >= self.key)
                return self.copy.read()

        def gated_push(key, copy, priority=False):
            push(key, copy if priority else Gated(key, copy), priority)

        def demanding_wait(seq, *args, **kwargs):
            with self._cv:
                self._demand = max(self._demand, seq)
                self._cv.notify_all()
            wait_done(seq, *args, **kwargs)

        harvester.push, harvester.wait_done = gated_push, demanding_wait

    def release(self) -> None:
        with self._cv:
            self._open = True
            self._cv.notify_all()


@pytest.mark.parametrize("depth", [1, 2])
def test_async_abort_mid_stream_frees_slot_and_pages(tparams, depth):
    """tests/test_engine_async.py:82, and the pages: an abort with windows
    in flight finishes the request at once; the other request runs to its
    end; once drained every slot is empty and every page is back. The
    windows' completions are held by a ``DemandGate``, so the windows in
    flight after three steps do not depend on the harvester thread's
    timing."""
    eng = _port(tparams, async_depth=depth)
    gate = DemandGate(eng._harvester)
    try:
        req = eng.submit([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=60))
        other = eng.submit([4, 5], SamplingParams(temperature=0.0, max_tokens=10))
        for _ in range(3):
            eng.step()
        # below full depth a step returns with windows still in flight
        assert bool(eng._inflight) == (depth > 1)
        eng.abort(req, "client_disconnect")
        gate.release()
        eng.step()
        assert req.finished and req.finish_reason == "client_disconnect" and req.slot == -1
        for _ in range(1_000):
            if other.finished:
                break
            eng.step()
        eng._drain_async()
    finally:
        gate.release()
    assert not eng.has_work()
    assert other.finished and other.finish_reason == "length" and len(other.output) == 10
    assert all(s is None for s in eng.slots) and not eng._inflight
    alloc = eng.allocator
    assert alloc.num_free_pages + alloc.num_evictable_pages == 63


def test_async_continuous_admission(jparams, tparams):
    """tests/test_engine_async.py:99: a request submitted while another is
    mid-decode joins the batch; both streams are what a fresh engine gives.
    The windows' completions are held by a ``DemandGate`` for the first
    four steps, so the first request is mid-decode then whatever the
    harvester thread's timing."""
    eng = _port(tparams)
    gate = DemandGate(eng._harvester)
    try:
        first = eng.submit([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=15))
        for _ in range(4):
            eng.step()
        assert first.output and not first.finished
        gate.release()
        second = eng.submit([9, 10], SamplingParams(temperature=0.0, max_tokens=15))
        for _ in range(1_000):
            if first.finished and second.finished:
                break
            eng.step()
    finally:
        gate.release()
    ref = _run(_jax(jparams), [[1, 2, 3], [9, 10]], JSamplingParams(temperature=0.0,
                                                                    max_tokens=15))
    assert [first.output, second.output] == [r.output for r in ref]


def test_shed_with_windows_in_flight(tparams):
    """The serving loop's answer to a failed step: every waiting, running
    and first-token-pending request finishes, nothing is left in flight."""
    eng = _port(tparams, max_decode_slots=2)
    reqs = [eng.submit(p, SamplingParams(temperature=0.0, max_tokens=20)) for p in PROMPTS]
    eng.step()
    eng.step()
    events = eng.shed("error")
    assert len(events) == len(PROMPTS)
    assert all(r.finished and r.finish_reason == "error" for r in reqs)
    assert not eng.has_work()
    # the engine serves on after a shed
    assert eng.generate([1, 2, 3], SamplingParams(**GREEDY)) == _run(
        _port(tparams), [[1, 2, 3]], SamplingParams(**GREEDY))[0].output


def test_harvester_read_failure_surfaces_on_engine_thread(tparams, monkeypatch):
    """A failed read in the harvester thread raises, the original
    exception, on the engine thread (and keeps raising), instead of
    leaving every wait blocked."""
    class Boom(RuntimeError):
        pass

    def failing_read(self):
        raise Boom("read failed")

    monkeypatch.setattr(tengine._HostCopy, "read", failing_read)
    eng = _port(tparams)
    eng.submit([1, 2, 3], SamplingParams(**GREEDY))
    with pytest.raises(Boom):
        for _ in range(100):
            eng.step()
    with pytest.raises(Boom):
        eng._harvester.is_done(0)
    h = tengine._Harvester()
    h.start()
    try:
        h.push(0, tengine._HostCopy(torch.zeros(2, 4, dtype=torch.int32)))
        with pytest.raises(Boom):
            h.wait_done(0)
    finally:
        h.stop()
        h.join(timeout=10)
    assert not h.is_alive()


def test_harvester_marks_windows_done_in_order_and_firsts_by_key():
    h = tengine._Harvester()
    h.start()
    try:
        for seq in range(3):
            h.push(seq, tengine._HostCopy(torch.full((1, 4), seq, dtype=torch.int32)))
        h.push(-1, tengine._HostCopy(torch.full((1, 4), 9, dtype=torch.int32)), priority=True)
        h.wait_done(2)
        h.wait_key(-1)
        assert h.is_done(0) and h.is_done(2) and not h.is_done(3) and h.key_done(-1)
        assert h.get(1).tolist() == [[1] * 4] and h.get(-1).tolist() == [[9] * 4]
        h.discard_upto(1)
        assert not h.key_done(0) and h.key_done(2)
    finally:
        h.stop()
        h.join(timeout=10)
    assert not h.is_alive()


def test_engine_finalizer_joins_the_harvester(tparams):
    """The engine's finalizer (also run at interpreter exit) stops the
    harvester thread and waits for it to end."""
    eng = _port(tparams)
    eng.generate([1, 2, 3], SamplingParams(**GREEDY))
    assert eng._harvester.is_alive()
    eng._close()
    assert not eng._harvester.is_alive()


def test_submit_wakes_a_backpressure_wait(tparams):
    """wait_done(wake=...) returns at once when a submission set the wake
    event, though the window it waits for is not done."""
    eng = _port(tparams)
    eng.submit([1, 2], SamplingParams(**GREEDY))
    assert eng._admit_wake.is_set()
    eng._harvester.wait_done(10 ** 6, wake=eng._admit_wake)   # returns: woken


def test_prefill_pads_two_or_more_rows_to_admit_batch(tparams):
    """As the JAX engine does: a prefill of one row runs alone, one of two
    or more rows is padded to admit_batch rows (length 0, on slots no real
    row uses), and a padded row leaves its slot's penalty counts alone."""
    eng = _port(tparams, async_scheduling=False)
    reqs = [eng.submit(p, SamplingParams(**GREEDY)) for p in PROMPTS[:2]]
    with eng._lock:
        seats = [eng._seat_next([]) for _ in reqs]
    eng.token_counts[3, 5] = 7
    pack, toks = eng._prefill(16, [(r, r.prompt) for r in reqs])
    assert pack.shape[0] == toks.shape[0] == eng.config.admit_batch == 4
    assert [s[0] for s in seats] == [0, 1] and int(eng.token_counts[3, 5]) == 7
    one, _ = eng._prefill(16, [(reqs[0], reqs[0].prompt)])
    assert one.shape[0] == 1 and int(one[0, 0]) == int(pack[0, 0])


def test_rebuild_count_rows_counts_only_output_tokens():
    """Row 0 resets and counts its positions >= the prompt length; row 1 is
    a later chunk that adds to its slot's counts; row 2 (length 0) keeps
    its slot's counts."""
    counts = torch.zeros((4, 16), dtype=torch.int32)
    counts[3, 5] = 2
    counts[1, 7] = 1
    tokens = torch.tensor([[1, 2, 3, 4, 4, 0], [4, 5, 6, 0, 0, 0], [9, 9, 9, 9, 9, 9]],
                          dtype=torch.int32)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)
    tengine._rebuild_count_rows(counts, tokens, slots=i32(0, 1, 3), history=i32(0, 6, 0),
                                prompt_len=i32(3, 7, 0), lengths=i32(5, 3, 0),
                                reset=i32(1, 0, 1))
    want = torch.zeros((4, 16), dtype=torch.int32)
    want[0, 4] = 2                    # positions 3 and 4 of row 0
    want[1, 7] = 1
    want[1, 5] = want[1, 6] = 1       # positions 7 and 8 (history 6)
    want[3, 5] = 2
    assert torch.equal(counts, want)


def test_engine_config_async_fields_validated():
    for field in ("async_depth", "admit_batch"):
        with pytest.raises(ValueError, match=field):
            EngineConfig(**{field: 0})
    # pacing takes what the JAX field takes: > 0 paces, <= 0 is off
    for pace in (1.0, 3.0, -1.0, 0.0):
        assert EngineConfig(pace_target_steps=pace).pace_target_steps == pace
        eng = Engine(EngineConfig(**{**SMALL, "device": "cpu", "pace_target_steps": pace}))
        assert eng.config.pace_target_steps == pace and eng._est_step == 0.02


def test_launch_accounting_apart_from_the_counters():
    """counting_apart gives the calling thread's launches in the block to
    its own Counter, while another thread's go on counting in LAUNCHES;
    add_launches adds one replay's counts to LAUNCHES and to REPLAYED."""
    import threading

    before = dict(kernels.LAUNCHES), dict(kernels.REPLAYED)
    kernels.reset_launches()
    kernels.count("paged_decode")
    other = threading.Thread(target=kernels.count, args=("paged_decode_write",))
    with kernels.counting_apart() as counted:
        kernels.count("paged_decode")
        kernels.count("paged_decode")
        kernels.count("flash_prefill")
        other.start()
        other.join()
    assert dict(counted) == {"paged_decode": 2, "flash_prefill": 1}
    assert kernels.launch_counts() == {"paged_decode": 1, "paged_decode_write": 1}
    for _ in range(4):
        kernels.add_launches(counted)
    assert kernels.launch_counts() == {"paged_decode": 9, "paged_decode_write": 1,
                                       "flash_prefill": 4}
    assert kernels.replayed_counts() == {"paged_decode": 8, "flash_prefill": 4}
    kernels.reset_launches()
    assert kernels.launch_counts() == {} and kernels.replayed_counts() == {}
    kernels.LAUNCHES.update(before[0])
    kernels.REPLAYED.update(before[1])


def test_frozen_workspace_refuses_to_grow():
    """A captured window holds the workspace's addresses: once frozen, a
    call that needs no more room gets the same buffers and a larger one
    raises instead of replacing them."""
    ws = tpaged.DecodeWorkspace()
    dev = torch.device("cpu")
    part, counters = ws.get(dev, 4, 8, 2, 2, 64)
    ws.frozen = True
    again = ws.get(dev, 2, 8, 2, 2, 64)
    assert again[0].data_ptr() == part.data_ptr() and again[1].data_ptr() == counters.data_ptr()
    with pytest.raises(RuntimeError, match="captured graph"):
        ws.get(dev, 8, 8, 2, 2, 64)


def test_each_engine_owns_its_workspace(tparams):
    a, b = _port(tparams), _port(tparams, max_decode_slots=2)
    assert a.workspace is not b.workspace and a.workspace is not tpaged.WORKSPACE
