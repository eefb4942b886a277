"""Speculative decoding in the port against the JAX package and against
the port itself with speculation off (counterpart of
tests/test_speculation.py), on the CPU in float32.

- ``PromptLookupDrafter.propose`` and the ``SpecPolicy`` state after every
  call equal the JAX ones exactly, on seeded random and repetitive
  contexts; ``DraftModelDrafter`` drafts equal the JAX drafter's on the
  same weights.
- ``forward_verify`` against the JAX ``forward_verify`` on the same
  weights and pools: logits within ``LOGIT_TOL`` (1e-4), pools within
  ``POOL_TOL`` (1e-5), outside the trash pages
  (tests/test_torch_decoder.py's tolerances). Against the port's own
  sequential ``forward_decode``: the same tolerances (not bit-identical:
  float32 summation order differs, as it does between the JAX verify and
  decode on XLA's CPU).
- Engines: token streams exact. Every engine test forces drafts (a
  ``logit_bias`` pin whose token the prompt repeats, a drafter that is the
  target, or a drafter that proposes a chosen continuation) and asserts
  that speculation dispatched (``spec_dispatches > 0``); the JAX engine's
  own tests can pass with speculation never running on this tree.
"""

import dataclasses
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llms_on_kubernetes_tpu.configs import get_config as jget_config
from llms_on_kubernetes_tpu.engine import speculation as jspec
from llms_on_kubernetes_tpu.engine.cache import CacheConfig as JCacheConfig
from llms_on_kubernetes_tpu.engine.cache import init_pages as j_init_pages
from llms_on_kubernetes_tpu.engine.engine import Engine as JEngine
from llms_on_kubernetes_tpu.engine.engine import EngineConfig as JEngineConfig
from llms_on_kubernetes_tpu.engine.engine import SamplingParams as JSamplingParams
from llms_on_kubernetes_tpu.models import decoder as jdec
from llms_on_kubernetes_tpu_torch.configs import ModelConfig, get_config
from llms_on_kubernetes_tpu_torch.engine import speculation as tspec
from llms_on_kubernetes_tpu_torch.engine.cache import CacheConfig, init_pages
from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
from llms_on_kubernetes_tpu_torch.engine.graphs import (
    idle_rows, pack_accept, unpack_accept, verify_rows,
)
from llms_on_kubernetes_tpu_torch.engine.weights import params_from_numpy
from llms_on_kubernetes_tpu_torch.models import decoder as tdec

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
POOL_TOL = dict(rtol=1e-5, atol=1e-5)

# tests/test_speculation.py's engine and prompts
SMALL = dict(model="debug-tiny", dtype="float32", max_decode_slots=4, page_size=8,
             num_pages=64, pages_per_slot=8, prefill_buckets=(16, 32), async_scheduling=True,
             async_depth=2, decode_steps=4)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10], [11, 12, 13, 14]]
REPETITIVE = [5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6]
# a greedy pin: +90 on token 42 makes every greedy sample 42, and a prompt
# that ends in it gives the lookup drafter a continuation at once
PIN = ((42, 90.0),)
PINNED_PROMPT = [1, 2, 3, 42, 42, 42]


@pytest.fixture(scope="module")
def jparams():
    return jdec.init_params(jget_config("debug-tiny"), jax.random.key(0), dtype="float32")


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _port(tparams, speculation=None, **kw):
    return Engine(EngineConfig(**{**SMALL, "device": "cpu", "speculation": speculation, **kw}),
                  params=tparams)


def _run(eng, prompts, params):
    params = params if isinstance(params, list) else [params] * len(prompts)
    reqs = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
    for _ in range(10_000):
        if all(r.finished for r in reqs):
            break
        eng.step()
    assert all(r.finished for r in reqs)
    while eng.has_work():
        eng.step()
    return reqs


def _streams(reqs):
    return [(r.output, r.finish_reason) for r in reqs]


# ---------------------------------------------------------------------------
# drafters and policy against the JAX ones
# ---------------------------------------------------------------------------

def _contexts(seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = [np.asarray(REPETITIVE, np.int32), np.array([7] * 10, np.int32),
           np.array([2, 3, 4, 3, 9, 2, 3], np.int32), np.array([1], np.int32),
           np.arange(16, dtype=np.int32)]
    for n in (5, 40, 300, 1500):
        out.append(rng.integers(0, 6, n).astype(np.int32))        # repetitive
        out.append(rng.integers(0, 50_000, n).astype(np.int32))   # random
    span = rng.integers(0, 1000, 17).astype(np.int32)
    out.append(np.concatenate([span] * 9 + [span[:5]]))
    return out


@pytest.mark.parametrize("ngram", [(3, 1, 1024), (2, 2, 64), (4, 1, 16)])
def test_prompt_lookup_proposals_equal_jax(ngram):
    mx, mn, window = ngram
    t = tspec.PromptLookupDrafter(max_ngram=mx, min_ngram=mn, window=window)
    j = jspec.PromptLookupDrafter(max_ngram=mx, min_ngram=mn, window=window)
    ctxs = _contexts(mx * 10 + mn)
    for k in (0, 1, 3, 7):
        for c in ctxs:
            np.testing.assert_array_equal(t.propose(c, k), j.propose(c, k))
        got = t.propose_batch(ctxs + [None, np.zeros(0, np.int32)], k)
        want = j.propose_batch(ctxs + [None, np.zeros(0, np.int32)], k)
        assert [g.tolist() for g in got] == [w.tolist() for w in want]


def test_prompt_lookup_rejects_bad_ngram_bounds_as_jax():
    for bad in ((1, 0), (2, 3)):
        with pytest.raises(ValueError):
            jspec.PromptLookupDrafter(*bad)
        with pytest.raises(ValueError):
            tspec.PromptLookupDrafter(*bad)


def _policy_state(p) -> tuple:
    return (p.dispatches, p.drafted, p.accepted, p._ema, p._demoted, p._idle,
            p.should_draft(), p.accept_ratio)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_policy_state_sequences_equal_jax(seed):
    rng = np.random.default_rng(seed)
    kw = dict(min_accept=0.3, min_dispatches=4, probe_interval=8) if seed else {}
    t, j = tspec.SpecPolicy(**kw), jspec.SpecPolicy(**kw)
    for _ in range(400):
        op = rng.integers(0, 3)
        if op == 0:
            d = int(rng.integers(0, 4))
            a = int(rng.integers(0, d + 1)) if rng.random() < 0.4 else 0
            t.note(d, a)
            j.note(d, a)
        elif op == 1:
            t.note_empty()
            j.note_empty()
        else:
            t.tick()
            j.tick()
        assert _policy_state(t) == _policy_state(j)


def test_draft_model_drafter_equals_jax_and_the_target(tparams, jparams):
    """The drafter rolls out the target's own greedy continuation, and its
    drafts equal the JAX drafter's on the same weights (float32 pools on
    both sides)."""
    cfg = get_config("debug-tiny")
    d = tspec.DraftModelDrafter(tparams, cfg, window=32, max_draft=3)
    jd = jspec.DraftModelDrafter(jparams, jget_config("debug-tiny"), window=32, max_draft=3)
    ref = _port(tparams).generate([1, 2, 3, 4], SamplingParams(temperature=0.0, max_tokens=3))
    assert d.propose(np.array([1, 2, 3, 4], np.int32), 3).tolist() == ref
    ctxs = [np.asarray(REPETITIVE, np.int32), None, np.arange(40, dtype=np.int32) % 97,
            np.asarray(PROMPTS[1], np.int32)]
    for k in (1, 3):
        got = d.propose_batch(ctxs, k)
        want = jd.propose_batch(ctxs, k)
        assert [g.tolist() for g in got] == [w.tolist() for w in want]


def test_load_draft_model_checks_the_vocabulary():
    small = get_config("debug-tiny")
    big = dataclasses.replace(small, vocab_size=small.vocab_size + 1)
    with pytest.raises(ValueError, match="vocab_size"):
        tspec._load_draft_model("debug-tiny", big, "float32", 0, device="cpu")
    params, cfg = tspec._load_draft_model("debug-tiny", small, "float32", 0, device="cpu")
    assert cfg == small and params["embed"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the verify pass
# ---------------------------------------------------------------------------

def _pools(cfg, num_pages=32, page=4, pps=8):
    kw = dict(num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
              num_pages=num_pages, page_size=page, pages_per_slot=pps, dtype="float32")
    return j_init_pages(JCacheConfig(**kw)), init_pages(CacheConfig(**kw), device="cpu")


def _pools_close(tpools, jpools, cfg, num_pages):
    keep = np.ones(cfg.num_layers * num_pages, bool)
    keep[::num_pages] = False       # each layer's trash page
    for t, j in zip(tpools, jpools):
        np.testing.assert_allclose(t.data.numpy()[:, keep], np.asarray(j.data)[:, keep],
                                   **POOL_TOL)


def test_forward_verify_matches_jax(jparams, tparams, rng):
    """Three rows after a prefill: a full window, a partial one and an
    idle row; logits at the written positions and the pools against the
    JAX verify."""
    jcfg, cfg = jget_config("debug-tiny"), get_config("debug-tiny")
    (jk, jv), (tk, tv) = _pools(cfg)
    B, K = 3, 4
    lens = np.asarray([6, 9, 5], np.int32)
    table = np.asarray([[1, 2, 3, 4, 5, 0, 0, 0], [6, 7, 8, 9, 10, 0, 0, 0],
                        [11, 12, 13, 14, 15, 0, 0, 0]], np.int32)
    prompt = np.zeros((B, 16), np.int32)
    prompt[:, :] = rng.integers(0, 256, (B, 16))
    jl, jk, jv = jdec.forward_prefill(jparams, jcfg, jnp.asarray(prompt), jnp.asarray(lens),
                                      jk, jv, jnp.asarray(table))
    tdec.forward_prefill(tparams, cfg, torch.from_numpy(prompt), torch.from_numpy(lens),
                         tk, tv, torch.from_numpy(table))
    window = rng.integers(0, 256, (B, K)).astype(np.int32)
    w = np.asarray([4, 2, 0], np.int32)
    jlog, jk, jv = jdec.forward_verify(jparams, jcfg, jnp.asarray(window), jnp.asarray(lens),
                                       jnp.asarray(w), jk, jv, jnp.asarray(table))
    tlog, _, _ = tdec.forward_verify(tparams, cfg, torch.from_numpy(window),
                                     torch.from_numpy(lens), torch.from_numpy(w), tk, tv,
                                     torch.from_numpy(table))
    assert tlog.shape == (B, K, cfg.vocab_size) and tlog.dtype == torch.float32
    for b in range(B):
        np.testing.assert_allclose(tlog.numpy()[b, :w[b]], np.asarray(jlog)[b, :w[b]],
                                   **LOGIT_TOL)
    # the JAX write_tokens writes filler rows past a window; the kernels'
    # plain version does not: compare the rows both wrote
    for t, j in zip((tk, tv), (jk, jv)):
        tj, jj = t.data.numpy(), np.asarray(j.data)
        for b in range(B):
            for pos in range(int(lens[b] + w[b])):
                page = table[b, pos // 4]
                for layer in range(cfg.num_layers):
                    np.testing.assert_allclose(tj[:, layer * 32 + page, pos % 4],
                                               jj[:, layer * 32 + page, pos % 4], **POOL_TOL)


def test_verify_equals_sequential_decode(tparams, rng):
    """The port's verify over [the committed token, the next three greedy
    tokens] equals four sequential decode steps within the tolerance, at
    every position, and leaves the same pools."""
    cfg = get_config("debug-tiny")
    n, K = 6, 4
    prompt = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
    table = torch.tensor([[1, 2, 3, 4, 5, 6, 7, 8]], dtype=torch.int32)

    def setup():
        _, (kp, vp) = _pools(cfg)
        toks = np.zeros((1, 8), np.int32)
        toks[0, :n] = prompt
        logits, _, _ = tdec.forward_prefill(tparams, cfg, torch.from_numpy(toks),
                                            torch.tensor([n], dtype=torch.int32), kp, vp,
                                            table)
        return logits, kp, vp

    logits, kp, vp = setup()
    cur = int(torch.argmax(logits[0]))
    fed, seq = [cur], []
    for j in range(K):
        lg, _, _ = tdec.forward_decode(tparams, cfg, torch.tensor([cur], dtype=torch.int32),
                                       torch.tensor([n + 1 + j], dtype=torch.int32), kp, vp,
                                       table)
        seq.append(lg[0].numpy())
        cur = int(torch.argmax(lg[0]))
        fed.append(cur)
    _, kp2, vp2 = setup()
    vlog, _, _ = tdec.forward_verify(tparams, cfg, torch.tensor([fed[:K]], dtype=torch.int32),
                                     torch.tensor([n], dtype=torch.int32),
                                     torch.tensor([K], dtype=torch.int32), kp2, vp2, table)
    for j in range(K):
        np.testing.assert_allclose(vlog[0, j].numpy(), seq[j], **LOGIT_TOL)
    for a, b in ((kp, kp2), (vp, vp2)):
        np.testing.assert_allclose(a.data.numpy(), b.data.numpy(), **POOL_TOL)


def test_pack_accept_round_trips_at_any_width():
    for B, W in ((4, 18), (64, 18), (18, 18), (1, 5)):
        pack = torch.arange(3 * B * W, dtype=torch.int32).view(3 * B, W)
        accept = torch.arange(B, dtype=torch.int32) % 5
        host = pack_accept(pack, accept).numpy()
        got, acc = unpack_accept(host, B)
        np.testing.assert_array_equal(got, pack.numpy())
        np.testing.assert_array_equal(acc, accept.numpy())
    rows = verify_rows(idle_rows(2, 3), np.full((2, 3), -1, np.int32))
    assert rows.shape == (2, idle_rows(2, 3).shape[1] + 3) and (rows[:, -3:] == -1).all()


# ---------------------------------------------------------------------------
# the engine: streams with speculation on equal those with it off
# ---------------------------------------------------------------------------

def test_greedy_spec_on_equals_off_single(tparams):
    sp = SamplingParams(temperature=0.0, max_tokens=24, logit_bias=PIN)
    want = _streams(_run(_port(tparams), [PINNED_PROMPT], sp))
    spec = _port(tparams, "ngram")
    assert _streams(_run(spec, [PINNED_PROMPT], sp)) == want
    assert spec.spec_dispatches > 0 and spec.spec_drafted_tokens > 0
    assert spec.verify_replays == 0          # the CPU runs the verify eagerly


def test_greedy_spec_on_equals_off_mixed_batch(tparams):
    """A pinned row drives verify dispatches; free rows ride in them,
    drafting what the lookup finds, with rejections."""
    sps = [SamplingParams(temperature=0.0, max_tokens=16, logit_bias=PIN)] + \
        [SamplingParams(temperature=0.0, max_tokens=16)] * 3
    prompts = [PINNED_PROMPT, REPETITIVE] + PROMPTS[:2]
    want = _streams(_run(_port(tparams), prompts, sps))
    spec = _port(tparams, "ngram")
    assert _streams(_run(spec, prompts, sps)) == want
    assert spec.spec_dispatches > 0
    assert spec.spec_accepted_tokens < spec.spec_drafted_tokens     # some rejected


def test_spec_on_streams_equal_the_jax_engine_off(jparams, tparams):
    """The port with speculation on against the JAX engine with it off, on
    the same weights."""
    sps = [dict(temperature=0.0, max_tokens=16, logit_bias=PIN),
           dict(temperature=0.0, max_tokens=16)]
    prompts = [PINNED_PROMPT, REPETITIVE]
    jeng = JEngine(JEngineConfig(**SMALL), params=jparams)
    want = _streams(_run(jeng, prompts, [JSamplingParams(**s) for s in sps]))
    spec = _port(tparams, "ngram")
    assert _streams(_run(spec, prompts, [SamplingParams(**s) for s in sps])) == want
    assert spec.spec_dispatches > 0


def test_seeded_sampling_spec_on_equals_off(tparams):
    """Seeded sampled rows with penalties ride the verify dispatches a
    pinned row drives: the same noise (keyed on the position), the same
    penalty counts, so the same streams."""
    sps = [SamplingParams(temperature=0.0, max_tokens=20, logit_bias=PIN)] + [
        SamplingParams(temperature=0.9, top_k=8, seed=100 + i, presence_penalty=0.3,
                       frequency_penalty=0.2, max_tokens=20) for i in range(2)]
    prompts = [PINNED_PROMPT, REPETITIVE, PROMPTS[0]]
    want = _streams(_run(_port(tparams), prompts, sps))
    spec = _port(tparams, "ngram")
    assert _streams(_run(spec, prompts, sps)) == want
    assert spec.spec_dispatches > 0


def test_full_accept_drops_dispatches_per_token(tparams):
    sp = SamplingParams(temperature=0.0, max_tokens=24, logit_bias=PIN)
    spec = _port(tparams, "ngram")
    _run(spec, [PINNED_PROMPT], sp)
    steps = list(spec.steps_obs)
    assert spec.spec_accepted_tokens == spec.spec_drafted_tokens > 0
    assert len(steps) / sum(steps) < 0.286
    assert spec.decode_dispatches == len(steps)


def test_stop_token_inside_a_drafted_suffix(tparams):
    """A stop id inside the drafted region finishes the stream where
    speculation off finishes it: the drafter proposes the reference
    stream, whose token 5 is the stop id, so the verify that accepts it
    must mask the rest of its window."""
    ref = _run(_port(tparams), [REPETITIVE], SamplingParams(temperature=0.0,
                                                           max_tokens=12))[0].output
    sp = SamplingParams(temperature=0.0, max_tokens=12, stop_token_ids=(ref[5],))
    want = _streams(_run(_port(tparams), [REPETITIVE], sp))
    assert want[0][1] == "stop"
    spec = _port(tparams, "ngram")
    spec._spec.drafter = _ScriptedDrafter(REPETITIVE, ref, None)
    assert _streams(_run(spec, [REPETITIVE], sp)) == want
    assert spec.spec_dispatches > 0
    pinned = SamplingParams(temperature=0.0, max_tokens=12, stop_token_ids=(42,),
                            logit_bias=PIN)
    assert _streams(_run(_port(tparams, "ngram"), [PINNED_PROMPT], pinned)) == [([42], "stop")]


class _ScriptedDrafter:
    """Proposes, for each row, its reference stream's continuation from
    the context's end with the token at index ``wrong`` replaced (a
    rejection there), or the whole continuation when ``wrong`` is None."""

    def __init__(self, prompt, stream, wrong):
        self.full = list(prompt) + list(stream)
        self.n = len(prompt)
        self.wrong = wrong
        self.calls = 0

    def propose_batch(self, ctxs, max_draft):
        out = []
        for c in ctxs:
            if c is None:
                out.append(np.zeros(0, np.int32))
                continue
            self.calls += 1
            nxt = self.full[len(c):len(c) + max_draft]
            if self.wrong is not None and self.wrong < len(nxt):
                nxt = list(nxt)
                nxt[self.wrong] = (nxt[self.wrong] + 1) % 256
            out.append(np.asarray(nxt, np.int32))
        return out


@pytest.mark.parametrize("wrong", [0, 1, 2, None], ids=["reject0", "reject1", "reject2",
                                                         "accept_all"])
def test_rejection_mid_window_leaves_the_pages_of_speculation_off(tparams, wrong):
    """Drafts of the reference stream with draft ``wrong`` changed: the
    verify writes the rejected rows, the next dispatch overwrites them.
    The stream equals speculation off's, every committed KV row equals
    speculation off's (POOL_TOL: a verify row and a decode row differ in
    float32 summation order), and the pages all come back."""
    prompt = REPETITIVE
    sp = SamplingParams(temperature=0.0, max_tokens=14)
    off = _port(tparams)
    ref = _run(off, [prompt], sp)[0]
    spec = _port(tparams, "ngram")
    spec._spec.drafter = _ScriptedDrafter(prompt, ref.output, wrong)
    req = spec.submit(prompt, sp)
    spec.step()
    pages = list(spec.allocator.slot_pages[req.slot])
    while not req.finished:
        spec.step()
        if req.slot >= 0:
            pages = list(spec.allocator.slot_pages[req.slot])
    while spec.has_work():
        spec.step()
    assert (req.output, req.finish_reason) == (ref.output, ref.finish_reason)
    assert spec.spec_dispatches > 0
    if wrong is None:
        assert spec.spec_accepted_tokens == spec.spec_drafted_tokens
    else:
        assert spec.spec_accepted_tokens < spec.spec_drafted_tokens
    # both engines gave the request the same pages in the same order
    committed = len(prompt) + len(ref.output) - 1
    P, page = SMALL["num_pages"], SMALL["page_size"]
    for a, b in ((off.k_pages, spec.k_pages), (off.v_pages, spec.v_pages)):
        for pos in range(committed):
            pid = pages[pos // page]
            for layer in range(get_config("debug-tiny").num_layers):
                np.testing.assert_allclose(b.data[:, layer * P + pid, pos % page].numpy(),
                                           a.data[:, layer * P + pid, pos % page].numpy(),
                                           **POOL_TOL)
    alloc = spec.allocator
    assert alloc.num_free_pages + alloc.num_evictable_pages == P - 1


def test_rejections_free_every_page_and_a_recycled_slot_replays(tparams):
    """tests/test_speculation.py::test_rejection_midwindow_restores_pages_and_replays,
    with the pin forcing verify dispatches."""
    eng = _port(tparams, "ngram")
    alloc = eng.allocator
    reclaimable0 = alloc.num_free_pages + alloc.num_evictable_pages
    sps = [SamplingParams(temperature=0.0, max_tokens=12, logit_bias=PIN),
           SamplingParams(temperature=0.0, max_tokens=12)]
    _run(eng, [PINNED_PROMPT, REPETITIVE], sps)
    assert eng.spec_dispatches > 0
    assert alloc.num_free_pages + alloc.num_evictable_pages == reclaimable0
    replay = _run(eng, [[9, 10, 11]], SamplingParams(temperature=0.0, max_tokens=8))[0]
    fresh = _run(_port(tparams, "ngram"), [[9, 10, 11]],
                 SamplingParams(temperature=0.0, max_tokens=8))[0]
    assert (replay.output, replay.finish_reason) == (fresh.output, fresh.finish_reason)


def test_grammar_row_accept_checks_through_the_fsm():
    """tests/test_speculation.py's grammar case on the port, with a pinned
    free row driving verify dispatches: a constrained row rides them, its
    drafts masked by the FSM; streams equal speculation off's and the
    constrained one walks its grammar."""
    from llms_on_kubernetes_tpu_torch.engine.grammar import (
        compile_response_format, token_bytes_of,
    )
    from llms_on_kubernetes_tpu_torch.engine.tokenizer import ByteTokenizer

    eos = ByteTokenizer.EOS
    cfg = ModelConfig("debug-grammar", vocab_size=258, hidden_size=64, intermediate_size=128,
                      num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                      max_position_embeddings=512)
    g = compile_response_format({"type": "json_object"}, token_bytes_of(ByteTokenizer()), [eos])

    def mk(speculation):
        return Engine(EngineConfig(model="debug-tiny", dtype="float32", max_decode_slots=4,
                                   page_size=4, num_pages=512, pages_per_slot=64,
                                   prefill_buckets=(16, 32), decode_steps=4,
                                   speculation=speculation, device="cpu"), model_config=cfg)

    sps = [SamplingParams(temperature=1.0, max_tokens=32, stop_token_ids=(eos,), seed=7,
                          grammar=g),
           SamplingParams(temperature=0.0, max_tokens=16, logit_bias=PIN)]
    prompts = [REPETITIVE, PINNED_PROMPT]
    want = _streams(_run(mk(None), prompts, sps))
    spec = mk("ngram")
    got = _run(spec, prompts, sps)
    assert _streams(got) == want
    assert spec.spec_dispatches > 0
    s = g.start
    for t in got[0].output:
        if t == eos:
            break
        s = g.next_state(s, t)
        assert s >= 0


def test_draft_model_tier_has_full_accept(tparams):
    """The draft tier with the target as its own draft model (debug-tiny by
    registry name, the engine's seed: the same weights): every draft is
    accepted and the streams equal speculation off's."""
    sp = SamplingParams(temperature=0.0, max_tokens=16)
    base = _run(Engine(EngineConfig(**SMALL, device="cpu")), PROMPTS[:2], sp)
    spec = Engine(EngineConfig(**SMALL, device="cpu", speculation="draft",
                               draft_model="debug-tiny"))
    got = _run(spec, PROMPTS[:2], sp)
    assert _streams(got) == _streams(base)
    assert isinstance(spec._spec.drafter, tspec.DraftModelDrafter)
    assert spec.spec_accepted_tokens == spec.spec_drafted_tokens > 0


def test_demoted_policy_restores_the_pipelined_window(tparams):
    """Drafts that are always wrong: the policy demotes after its
    min_dispatches, the engine goes back to plain windows (the pipeline),
    and the stream is speculation off's."""
    sp = SamplingParams(temperature=0.0, max_tokens=60)
    ref = _run(_port(tparams), [REPETITIVE], sp)[0]
    spec = _port(tparams, "ngram")
    spec._spec.drafter = _ScriptedDrafter(REPETITIVE, ref.output, 0)
    got = _run(spec, [REPETITIVE], sp)[0]
    assert got.output == ref.output
    pol = spec._spec.policy
    assert pol._demoted
    # every dispatch accepts nothing: the EMA falls 0.9x a dispatch from 1
    n = next(n for n in range(pol.min_dispatches, 100) if pol.decay ** n < pol.min_accept)
    assert spec.spec_dispatches == n == 12
    assert spec.decode_dispatches > spec.spec_dispatches


# ---------------------------------------------------------------------------
# config plumbing
# ---------------------------------------------------------------------------

def test_speculation_env_and_validation_as_jax(monkeypatch):
    monkeypatch.setenv("LLMK_SPECULATION", "ngram")
    assert EngineConfig(model="debug-tiny").speculation == "ngram"
    assert JEngineConfig(model="debug-tiny").speculation == "ngram"
    monkeypatch.delenv("LLMK_SPECULATION")
    assert EngineConfig(model="debug-tiny").speculation is None
    assert EngineConfig(model="debug-tiny", speculation="off").speculation is None
    cfg = EngineConfig(model="debug-tiny", draft_model="debug-tiny")
    assert cfg.speculation == "draft"
    monkeypatch.setenv("LLMK_DRAFT_MODEL", "debug-tiny")
    assert EngineConfig(model="debug-tiny").speculation == "draft"
    monkeypatch.delenv("LLMK_DRAFT_MODEL")
    for bad in (dict(speculation="banana"), dict(speculation="draft")):
        with pytest.raises(ValueError):
            EngineConfig(model="debug-tiny", **bad)
        with pytest.raises(ValueError):
            JEngineConfig(model="debug-tiny", **bad)


def test_sync_scheduler_and_one_step_windows_ignore_speculation(tparams):
    p = SamplingParams(temperature=0.0, max_tokens=8, logit_bias=PIN)
    for kw in (dict(async_scheduling=False), dict(decode_steps=1)):
        eng = _port(tparams, "ngram", **kw)
        assert eng._spec is None
        base = _port(tparams, None, **kw)
        assert eng.generate(PINNED_PROMPT, p) == base.generate(PINNED_PROMPT, p)


def test_cli_flags_reach_the_engine_config(monkeypatch):
    from llms_on_kubernetes_tpu_torch.cli import build_parser, engine_config_from_args

    monkeypatch.delenv("LLMK_SPECULATION", raising=False)
    monkeypatch.delenv("LLMK_DRAFT_MODEL", raising=False)
    args = build_parser().parse_args(["serve", "--model", "debug-tiny", "--speculation",
                                      "ngram"])
    assert engine_config_from_args(args).speculation == "ngram"
    args = build_parser().parse_args(["serve", "--model", "debug-tiny", "--draft-model",
                                      "debug-tiny"])
    cfg = engine_config_from_args(args)
    assert (cfg.speculation, cfg.draft_model) == ("draft", "debug-tiny")
    monkeypatch.setenv("LLMK_SPECULATION", "ngram")
    args = build_parser().parse_args(["serve", "--model", "debug-tiny"])
    assert engine_config_from_args(args).speculation == "ngram"


# ---------------------------------------------------------------------------
# metrics and the goodput ledger
# ---------------------------------------------------------------------------

def test_rejected_tails_book_spec_waste(tparams):
    """tests/test_ledger.py::test_engine_spec_rejected_tails_book_spec_waste
    with the pin forcing verify dispatches: rejected tails book as
    spec_waste, billed to the streams that speculated, and the ledger
    still conserves its window."""
    sp = SamplingParams(temperature=0.0, max_tokens=16)
    ref = _run(_port(tparams), [REPETITIVE], sp)[0]
    eng = _port(tparams, "ngram", ledger=True)
    eng._spec.drafter = _ScriptedDrafter(REPETITIVE, ref.output, 1)   # rejects draft 1
    reqs = _run(eng, [REPETITIVE, PINNED_PROMPT],
                [sp, SamplingParams(temperature=0.0, max_tokens=16, logit_bias=PIN)])
    assert eng.spec_dispatches > 0 and eng.spec_accepted_tokens < eng.spec_drafted_tokens
    snap = eng.ledger.snapshot()
    total = snap["attributed_ms"] + snap["wasted_ms"] + snap["idle_ms"]
    assert total == pytest.approx(snap["window_ms"], rel=1e-6, abs=1e-3)
    assert snap["phase_ms"]["spec_waste"] > 0.0
    assert sum(r.chip_ms.get("spec_waste", 0.0) for r in reqs) > 0.0


def test_spec_series_equal_the_engine_counters(tparams):
    """llm_spec_drafted_total, llm_spec_accepted_total and
    llm_spec_accept_ratio follow the engine's counters (the JAX
    definitions), and usage.chip_ms carries the spec_waste phase."""
    from llms_on_kubernetes_tpu.server import metrics as jmetrics
    from llms_on_kubernetes_tpu_torch.engine.tokenizer import ByteTokenizer
    from llms_on_kubernetes_tpu_torch.server.openai_api import OpenAIServer

    eng = _port(tparams, "ngram", ledger=True)
    srv = OpenAIServer(eng, ByteTokenizer(), "debug-tiny")
    base = f"http://127.0.0.1:{srv.start()}"
    try:
        for body in ({"prompt": [5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6], "max_tokens": 16,
                      "temperature": 0},
                     {"prompt": PINNED_PROMPT, "max_tokens": 16, "temperature": 0,
                      "logit_bias": {"42": 90}}):
            req = urllib.request.Request(base + "/v1/completions",
                                         data=json.dumps(body).encode(), method="POST",
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                usage = json.loads(r.read())["usage"]
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            text = r.read().decode()
    finally:
        srv.close()
    assert eng.spec_dispatches > 0
    assert "chip_ms" in usage

    def series(name):
        return float(next(line.rsplit(" ", 1)[1] for line in text.splitlines()
                          if line.startswith(name + " ")))
    assert series("llm_spec_drafted_total") == eng.spec_drafted_tokens
    assert series("llm_spec_accepted_total") == eng.spec_accepted_tokens
    assert series("llm_spec_accept_ratio") == pytest.approx(
        eng.spec_accepted_tokens / eng.spec_drafted_tokens)
    # the JAX servers' help strings and kinds
    jm = jmetrics.engine_metrics(jmetrics.Registry())
    for key in ("spec_drafted", "spec_accepted", "spec_accept_ratio"):
        assert f"# HELP {jm[key].name} {jm[key].help}" in text
