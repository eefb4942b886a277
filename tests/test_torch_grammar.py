"""Grammar-constrained decoding in the port against the JAX package, on the
CPU.

- Compiler: ``CompiledGrammar`` tables (``class_of``, ``trans``, the start
  state, the accepting set) equal the JAX ones byte for byte for
  ``json_object``, three JSON schemas (an enum, bounded strings, nested
  arrays) and a forced and a "required" tool choice, over ``ByteTokenizer``
  and over the llama3 and phi3 files ``testing/synth_checkpoint`` writes;
  for those the port's ``token_bytes_of(JsonTokenizer)`` equals the JAX
  ``token_bytes_of(HFTokenizer)`` of the same files. The JAX compiler's unit
  cases run on the port's copy.
- FSM step: ``graphs.fsm_apply`` / ``fsm_next`` / ``fsm_scatter`` equal the
  JAX ``_fsm_apply`` / ``_fsm_next`` / ``_fsm_scatter`` on random tables
  (exact integers); ``sample(allowed=...)`` takes the same tokens as the JAX
  ``sample`` on the same Gumbel noise, rows whose allowed set is smaller
  than ``MAX_CANDIDATES`` included, logprobs within 1e-5 (float32).
- Engine (a debug-tiny sized model over the byte vocabulary, float32, the
  JAX weights on both sides): greedy constrained streams equal the JAX
  engine's token for token for ``json_object``, a schema and a forced tool
  call, beside free rows, under preemption and after a journal resume
  (``prefix_tokens``); sampled streams stay on their grammar's paths, and
  those that finish parse and validate; the registry's caps, eviction and
  waiting.
"""

import json

import jax
import jax.numpy as jnp
import jsonschema
import numpy as np
import pytest
import torch

from llms_on_kubernetes_tpu.configs import ModelConfig as JModelConfig
from llms_on_kubernetes_tpu.engine import engine as jengine
from llms_on_kubernetes_tpu.engine import grammar as jg
from llms_on_kubernetes_tpu.engine import sampling as jsampling
from llms_on_kubernetes_tpu.engine.tokenizer import HFTokenizer
from llms_on_kubernetes_tpu.models.decoder import init_params as j_init_params
from llms_on_kubernetes_tpu_torch.configs import ModelConfig
from llms_on_kubernetes_tpu_torch.engine import grammar as tg
from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
from llms_on_kubernetes_tpu_torch.engine.graphs import fsm_apply, fsm_next, fsm_scatter
from llms_on_kubernetes_tpu_torch.engine.sampling import MAX_CANDIDATES, sample
from llms_on_kubernetes_tpu_torch.engine.tokenizer import ByteTokenizer, JsonTokenizer
from llms_on_kubernetes_tpu_torch.engine.weights import params_from_numpy
from llms_on_kubernetes_tpu_torch.testing import synth_checkpoint as synth

EOS = ByteTokenizer.EOS
TOKEN_BYTES = tg.token_bytes_of(ByteTokenizer())
TOOLS = [{"type": "function", "function": {
    "name": "get_weather",
    "parameters": {"type": "object",
                   "properties": {"city": {"type": "string", "maxLength": 12},
                                  "days": {"type": "integer"}},
                   "required": ["city"]}}},
    {"type": "function", "function": {"name": "noop"}}]
SCHEMAS = {
    "schema_enum": {"type": "object",
                    "properties": {"color": {"enum": ["red", "green", "blue"]},
                                   "n": {"type": "integer"}},
                    "required": ["color", "n"]},
    "schema_strings": {"type": "object",
                       "properties": {"name": {"type": "string", "minLength": 1,
                                               "maxLength": 8},
                                      "code": {"type": "string", "maxLength": 3}},
                       "required": ["name"]},
    "schema_nested": {"type": "object",
                      "properties": {"rows": {"type": "array", "maxItems": 2,
                                              "items": {"type": "array", "maxItems": 3,
                                                        "items": {"type": "integer"}}}},
                      "required": ["rows"]},
}
GRAMMARS = ["json_object", *SCHEMAS, "tool_forced", "tool_required"]


def compile_with(mod, name, token_bytes, eos):
    if name == "json_object":
        return mod.compile_response_format({"type": "json_object"}, token_bytes, eos)
    if name in SCHEMAS:
        return mod.compile_response_format(
            {"type": "json_schema", "json_schema": {"schema": SCHEMAS[name]}}, token_bytes, eos)
    return mod.compile_tool_choice(TOOLS, "get_weather" if name == "tool_forced" else None,
                                   token_bytes, eos)


@pytest.fixture(scope="module")
def vocabs(tmp_path_factory):
    """name -> (port token bytes, JAX token bytes, eos ids)."""
    out = {"byte": (TOKEN_BYTES, jg.token_bytes_of(jengine_byte_tokenizer()), [EOS])}
    for fam in ("llama3", "phi3"):
        d = str(tmp_path_factory.mktemp(fam))
        synth.write_tokenizer(d, fam)
        tok = JsonTokenizer(d)
        out[fam] = (tg.token_bytes_of(tok), jg.token_bytes_of(HFTokenizer(d)),
                    sorted(tok.eos_ids))
    return out


def jengine_byte_tokenizer():
    from llms_on_kubernetes_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
    return JByteTokenizer()


@pytest.mark.parametrize("vocab", ["byte", "llama3", "phi3"])
def test_token_bytes_equal_the_jax_map(vocabs, vocab):
    port, jax_map, _eos = vocabs[vocab]
    assert port == jax_map
    assert any(t is None for t in port) and sum(t is not None for t in port) > 200


@pytest.mark.parametrize("vocab", ["byte", "llama3", "phi3"])
@pytest.mark.parametrize("name", GRAMMARS)
def test_tables_equal_the_jax_compiler(vocabs, vocab, name):
    port_tb, jax_tb, eos = vocabs[vocab]
    got = compile_with(tg, name, port_tb, eos)
    want = compile_with(jg, name, jax_tb, eos)
    assert (got.key, got.start, got.n_states, got.n_classes) == \
        (want.key, want.start, want.n_states, want.n_classes)
    assert got.class_of.dtype == want.class_of.dtype == np.int16
    assert got.class_of.tobytes() == want.class_of.tobytes()
    assert got.trans.tobytes() == want.trans.tobytes()
    eos_class = got.class_of[eos[0]]
    accept = np.nonzero(got.trans[:, eos_class] >= 0)[0]
    assert accept.tolist() == np.nonzero(want.trans[:, want.class_of[eos[0]]] >= 0)[0].tolist()
    assert accept.size > 0


# ---------------------------------------------------------------------------
# the compiler's unit cases, on the port's copy
# ---------------------------------------------------------------------------

def test_json_object_char_dfa_accepts_and_rejects():
    dfa = tg.compile_char_dfa(tg.json_object_ast(4))
    good = [b'{}', b'{"a": 1}', b' {"a": [1, 2, {"b": null}]} ', b'{"u": "caf\xc3\xa9"}',
            b'{"n": -1.5e3, "b": true}', b'{"s": "x\\n\\u00e9"}']
    bad = [b'[1]', b'"str"', b'{"a": }', b'{"a":1,}', b'{a: 1}', b'{"a": 1',
           b'{"u": "\xc3(">}', b'{"a": 01}']
    assert all(dfa.matches(s) for s in good)
    assert not any(dfa.matches(s) for s in bad)


def test_schema_char_dfa_order_required_and_types():
    sch = {"type": "object",
           "properties": {"name": {"type": "string"}, "age": {"type": "integer"},
                          "tags": {"type": "array", "items": {"type": "string"},
                                   "maxItems": 2}},
           "required": ["name"]}
    dfa = tg.compile_char_dfa(tg.json_schema_ast(sch))
    assert dfa.matches(b'{"name": "bob"}')
    assert dfa.matches(b'{"name": "b", "age": 3, "tags": ["x", "y"]}')
    for s in (b'{"age": 3}', b'{"age": 1, "name": "b"}', b'{"name": "b", "age": 1.5}',
              b'{"name": "b", "tags": ["x", "y", "z"]}'):
        assert not dfa.matches(s), s


def test_schema_enum_const_anyof():
    dfa = tg.compile_char_dfa(tg.json_schema_ast(
        {"anyOf": [{"enum": ["red", "green", 3]}, {"const": {"k": True}}]}))
    assert all(dfa.matches(s) for s in [b'"red"', b'"green"', b'3', b'{"k":true}'])
    assert not any(dfa.matches(s) for s in [b'"blue"', b'4', b'{"k":false}'])


def test_prefix_items_with_bounds():
    dfa = tg.compile_char_dfa(tg.json_schema_ast(
        {"type": "array", "prefixItems": [{"type": "integer"}],
         "items": {"type": "integer"}, "maxItems": 2}))
    assert dfa.matches(b'[1]') and dfa.matches(b'[1, 2]') and not dfa.matches(b'[1, 2, 3]')
    with pytest.raises(tg.GrammarError):
        tg.json_schema_ast({"type": "array", "prefixItems": [{}, {}], "maxItems": 1})


def test_unsupported_constructs_raise():
    for bad in [{"$ref": "#/x"}, {"allOf": [{}]}, {"not": {}},
                {"type": "string", "pattern": "a+"}, {"patternProperties": {"^a": {}}},
                {"if": {}, "then": {}}]:
        with pytest.raises(tg.GrammarError):
            tg.compile_char_dfa(tg.json_schema_ast(bad))


def test_tool_call_grammar():
    forced = tg.compile_char_dfa(tg.tool_call_ast(TOOLS, "get_weather"))
    assert forced.matches(b'<tool_call>\n{"name": "get_weather", "arguments": '
                          b'{"city": "SF"}}\n</tool_call>')
    assert not forced.matches(b'sure, let me check the weather')
    assert not forced.matches(b'<tool_call>{"name": "noop", "arguments": {}}</tool_call>')
    anyt = tg.compile_char_dfa(tg.tool_call_ast(TOOLS, None))
    assert anyt.matches(b'<tool_call>{"name": "noop", "arguments": {}}</tool_call>')
    with pytest.raises(tg.GrammarError):
        tg.tool_call_ast(TOOLS, "missing")


def test_token_dfa_walks_match_char_dfa():
    dfa = tg.compile_char_dfa(tg.json_object_ast(3))
    g = tg.compile_token_dfa(dfa, TOKEN_BYTES, eos_ids=[EOS])
    for s in [g.start, 5, 11]:
        if s >= g.n_states - 1:
            continue
        for b in range(256):
            exp = int(dfa.table[s, dfa.byte2class[b]])
            assert g.next_state(s, b) == (exp if exp >= 0 else -1)
    assert g.next_state(g.start, ByteTokenizer.BOS) == -1
    assert g.next_state(g.start, EOS) == -1


def test_random_token_walks_parse():
    rng = np.random.default_rng(0)
    g = tg.compile_token_dfa(tg.compile_char_dfa(tg.json_object_ast(4)), TOKEN_BYTES,
                             eos_ids=[EOS])
    parsed = 0
    for _ in range(60):
        s, out = g.start, []
        for _ in range(300):
            allowed = np.nonzero(g.allowed(s))[0]
            assert allowed.size
            t = int(rng.choice(allowed))
            if t == EOS:
                json.loads(bytes(out).decode("utf-8", "strict"))
                parsed += 1
                break
            out.append(t)
            s = g.next_state(s, t)
    assert parsed > 5


def test_the_cache_returns_the_compiled_grammar():
    a = tg.compile_response_format({"type": "json_object"}, TOKEN_BYTES, [EOS])
    assert tg.compile_response_format({"type": "json_object"}, TOKEN_BYTES, [EOS]) is a
    assert tg.compile_response_format({"type": "text"}, TOKEN_BYTES, [EOS]) is None
    with pytest.raises(tg.GrammarError):
        tg.compile_response_format({"type": "yaml"}, TOKEN_BYTES, [EOS])


# ---------------------------------------------------------------------------
# the FSM step and masked sampling against the JAX functions
# ---------------------------------------------------------------------------

def _random_fsm(rng, R=6, G=3, V=50, S=20, C=7):
    class_of = rng.integers(0, C, (G, V)).astype(np.int16)
    trans = rng.integers(-1, S, (S, C)).astype(np.int16)
    g_rows = rng.integers(-1, G, R).astype(np.int32)
    states = rng.integers(-1, S, R).astype(np.int32)
    return class_of, trans, g_rows, states


@pytest.mark.parametrize("seed", range(6))
def test_fsm_functions_equal_the_jax_ones(seed):
    rng = np.random.default_rng(seed)
    R, B, V = 6, 8, 50
    class_of, trans, g_rows, states = _random_fsm(rng, R=R, V=V)
    state_arr = rng.integers(-1, 20, B).astype(np.int32)
    jfsm = (jnp.asarray(state_arr), jnp.asarray(class_of), jnp.asarray(trans))
    j_allowed, j_nxt, j_con = jengine._fsm_apply(jfsm, jnp.asarray(g_rows), jnp.asarray(states))
    t = torch.from_numpy
    allowed, nxt, con = fsm_apply(t(class_of), t(trans), t(g_rows), t(states))
    np.testing.assert_array_equal(allowed.numpy(), np.asarray(j_allowed))
    np.testing.assert_array_equal(nxt.numpy().astype(np.int32), np.asarray(j_nxt))
    np.testing.assert_array_equal(con.numpy(), np.asarray(j_con))
    tokens = rng.integers(0, V, R).astype(np.int32)
    np.testing.assert_array_equal(fsm_next(nxt, t(tokens)).numpy(),
                                  np.asarray(jengine._fsm_next(j_nxt, jnp.asarray(tokens))))
    init = rng.integers(-1, 20, R).astype(np.int32)
    lengths = rng.integers(0, 3, R).astype(np.int32)
    slots = rng.permutation(B)[:R].astype(np.int32)
    want = jengine._fsm_scatter(jfsm, jnp.asarray(g_rows), jnp.asarray(init), j_nxt,
                                jnp.asarray(tokens), jnp.asarray(lengths), jnp.asarray(slots))
    got = fsm_scatter(t(state_arr.copy()), t(g_rows), t(init), nxt, t(tokens), t(lengths),
                      t(slots))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", range(4))
def test_masked_sampling_equals_the_jax_sample(seed):
    rng = np.random.default_rng(seed)
    B, V = 8, 300
    C = min(MAX_CANDIDATES, V)
    logits = rng.normal(0, 3, (B, V)).astype(np.float32)
    allowed = np.zeros((B, V), bool)
    for b, n in enumerate([1, 3, 10, 63, 64, 65, 200, V]):
        allowed[b, rng.permutation(V)[:n]] = True
    temps = np.array([0.0, 0.7, 1.0, 0.0, 1.3, 0.9, 0.0, 0.5], np.float32)
    top_k = np.array([0, 5, 0, 0, 40, 0, 3, 0], np.int32)
    top_p = np.array([1.0, 1.0, 0.8, 1.0, 0.95, 1.0, 1.0, 0.5], np.float32)
    counts = rng.integers(0, 3, (B, V)).astype(np.int32)
    pres = rng.uniform(-1, 1, B).astype(np.float32)
    freq = rng.uniform(-1, 1, B).astype(np.float32)
    b_ids = np.full((B, 4), -1, np.int32)
    b_vals = np.zeros((B, 4), np.float32)
    b_ids[:, 0] = rng.integers(0, V, B)
    b_vals[:, 0] = 100.0          # a +100 bias must not defeat the grammar
    keys = jax.random.split(jax.random.key(seed), B)
    noise = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (C,), jnp.float32))(keys))
    want = jsampling.sample(
        jnp.asarray(logits), keys, jnp.asarray(temps), jnp.asarray(top_k), jnp.asarray(top_p),
        penalties=(jnp.asarray(pres), jnp.asarray(freq), jnp.asarray(counts)),
        bias=(jnp.asarray(b_ids), jnp.asarray(b_vals)), allowed=jnp.asarray(allowed))
    t = torch.from_numpy
    got = sample(t(logits), t(noise.copy()), t(temps), t(top_k), t(top_p),
                 penalties=(t(pres), t(freq), t(counts)), bias=(t(b_ids), t(b_vals)),
                 allowed=t(allowed))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert allowed[np.arange(B), got.tokens.numpy()].all()
    np.testing.assert_allclose(got.logprobs.numpy(), np.asarray(want.logprobs),
                               rtol=1e-5, atol=1e-5)
    # the alternatives agree wherever they are allowed tokens (the masked
    # ones tie at NEG_INF, whose order is each top-k's own)
    real = np.asarray(want.top_logprobs) > -1e30
    np.testing.assert_array_equal(got.top_ids.numpy()[real], np.asarray(want.top_ids)[real])
    np.testing.assert_allclose(got.top_logprobs.numpy()[real],
                               np.asarray(want.top_logprobs)[real], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

BYTE_MODEL = dict(vocab_size=258, hidden_size=64, intermediate_size=128, num_layers=2,
                  num_heads=4, num_kv_heads=2, head_dim=16, max_position_embeddings=512)
ENGINE = dict(model="debug-tiny", dtype="float32", max_decode_slots=4, page_size=4,
              num_pages=512, pages_per_slot=64, prefill_buckets=(16, 32))


@pytest.fixture(scope="module")
def weights():
    jcfg = JModelConfig("debug-grammar", **BYTE_MODEL)
    jp = j_init_params(jcfg, jax.random.key(3), dtype="float32")
    return jcfg, jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _port(weights, **kw):
    return Engine(EngineConfig(**{**ENGINE, "device": "cpu", **kw}),
                  model_config=ModelConfig("debug-grammar", **BYTE_MODEL), params=weights[2])


def _jax(weights, **kw):
    return jengine.Engine(jengine.EngineConfig(**{**ENGINE, **kw}), model_config=weights[0],
                          params=weights[1])


def grammar_for(mod, kind):
    tb = TOKEN_BYTES if mod is tg else jg.token_bytes_of(jengine_byte_tokenizer())
    if kind == "json_object":
        return mod.compile_response_format({"type": "json_object"}, tb, [EOS])
    if kind == "schema":
        return mod.compile_response_format(
            {"type": "json_schema", "json_schema": {"schema": SCHEMAS["schema_enum"]}},
            tb, [EOS])
    return mod.compile_tool_choice(TOOLS, "get_weather", tb, [EOS])


def _drive(eng, reqs, limit=5000):
    for _ in range(limit):
        if all(r.finished for r in reqs):
            return reqs
        eng.step()
    raise AssertionError("requests did not finish")


def check_output(req, grammar, schema=None):
    """Every output is a path of its grammar (host replay); a stream that
    ended on EOS parses, and validates against ``schema``."""
    toks = [t for t in req.output if t != EOS]
    s = grammar.start
    for t in toks:
        s = grammar.next_state(s, t)
        assert s >= 0, (req.finish_reason, bytes(toks))
    if req.finish_reason == "stop":
        text = bytes(toks).decode("utf-8", "strict")
        if text.lstrip().startswith("<tool_call>"):
            text = text.split("<tool_call>")[1].split("</tool_call>")[0]
        obj = json.loads(text)
        if schema is not None:
            jsonschema.validate(obj, schema)
        return obj
    return None


# a greedy stream is steered to finish with logit_bias (random weights): the
# bias is applied before the grammar's mask, so it only ranks allowed tokens
STEER = ((EOS, 100.0), (ord("}"), 60.0), (ord(","), 40.0), (ord('"'), 30.0),
         (ord(":"), 28.0), (ord("{"), 25.0), (ord("<"), 22.0), (ord("1"), 20.0))


def _submit_pair(engines, kinds, steer=True, **kw):
    """The same requests on (port, JAX) engines: one per kind ("free": no
    grammar), greedy."""
    out = []
    for eng, mod, sp in ((engines[0], tg, SamplingParams),
                         (engines[1], jg, jengine.SamplingParams)):
        reqs = []
        for i, kind in enumerate(kinds):
            g = None if kind == "free" else grammar_for(mod, kind)
            reqs.append(eng.submit([1 + i, 2, 3, 4 + i], sp(
                temperature=0.0, max_tokens=kw.get("max_tokens", 48), stop_token_ids=(EOS,),
                grammar=g, logit_bias=STEER if (steer and g is not None) else ())))
        out.append(reqs)
    return out


@pytest.mark.parametrize("async_scheduling", [True, False])
def test_guided_greedy_streams_equal_the_jax_engine(weights, async_scheduling):
    engines = (_port(weights, async_scheduling=async_scheduling),
               _jax(weights, async_scheduling=async_scheduling))
    kinds = ["json_object", "schema", "tool", "free"]
    port, jaxr = _submit_pair(engines, kinds, max_tokens=96)
    _drive(engines[0], port)
    _drive(engines[1], jaxr)
    assert [r.output for r in port] == [list(r.output) for r in jaxr]
    assert [r.finish_reason for r in port] == [r.finish_reason for r in jaxr]
    for r, kind in zip(port, kinds[:3]):
        g = grammar_for(tg, kind)
        assert check_output(r, g, SCHEMAS["schema_enum"] if kind == "schema" else None) \
            is not None, bytes(t for t in r.output if t < 256)
    assert engines[0].fsm_graph_replays == 0      # the CPU runs the window eagerly


def test_unsteered_greedy_streams_equal_the_jax_engine(weights):
    engines = (_port(weights), _jax(weights))
    port, jaxr = _submit_pair(engines, ["json_object", "free", "schema"], steer=False,
                              max_tokens=24)
    _drive(engines[0], port)
    _drive(engines[1], jaxr)
    assert [r.output for r in port] == [list(r.output) for r in jaxr]
    check_output(port[0], grammar_for(tg, "json_object"))
    check_output(port[2], grammar_for(tg, "schema"))


def test_guided_streams_equal_the_jax_engine_under_preemption(weights):
    kw = dict(num_pages=30, pages_per_slot=24, admit_batch=2)
    engines = (_port(weights, **kw), _jax(weights, **kw))
    kinds = ["json_object", "schema", "json_object"]
    port, jaxr = _submit_pair(engines, kinds, steer=False, max_tokens=40)
    _drive(engines[0], port)
    _drive(engines[1], jaxr)
    assert engines[0].preemptions > 0 and engines[1].preemptions > 0
    assert [r.output for r in port] == [list(r.output) for r in jaxr]
    for r, kind in zip(port, kinds):
        check_output(r, grammar_for(tg, kind))


@pytest.mark.parametrize("cut", [1, 5, 11])
def test_guided_journal_resume_continues_the_stream(weights, cut):
    """A constrained stream resumed from ``prefix_tokens`` replays its FSM
    state on the host and continues as the uninterrupted stream, on both
    engines."""
    results = []
    for eng_fn, mod, sp in ((_port, tg, SamplingParams), (_jax, jg, jengine.SamplingParams)):
        g = grammar_for(mod, "schema")
        base = sp(temperature=0.0, max_tokens=40, stop_token_ids=(EOS,), grammar=g)
        eng = eng_fn(weights)
        full = _drive(eng, [eng.submit([7, 8, 9], base)])[0]
        out = list(full.output)
        assert len(out) > cut
        eng2 = eng_fn(weights)
        import dataclasses
        resumed = _drive(eng2, [eng2.submit([7, 8, 9], dataclasses.replace(
            base, prefix_tokens=tuple(out[:cut])))])[0]
        assert list(resumed.output) == out
        results.append(out)
    assert results[0] == results[1]
    check_output(_Out(results[0]), grammar_for(tg, "schema"))


class _Out:
    def __init__(self, output):
        self.output, self.finish_reason = output, None


# ---------------------------------------------------------------------------
# the engine's own cases (the JAX tests/test_grammar.py engine cases)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("async_scheduling", [False, True])
def test_engine_constrained_json_object(weights, async_scheduling):
    eng = _port(weights, async_scheduling=async_scheduling)
    g = grammar_for(tg, "json_object")
    reqs = [eng.submit([1, 2, 3], SamplingParams(temperature=1.0, max_tokens=64,
                                                 stop_token_ids=(EOS,), seed=i, grammar=g))
            for i in range(4)]
    _drive(eng, reqs)
    for r in reqs:
        obj = check_output(r, g)
        assert obj is None or isinstance(obj, dict)


def test_engine_constrained_schema_validates(weights):
    eng = _port(weights)
    g = grammar_for(tg, "schema")
    reqs = [eng.submit([5, 6], SamplingParams(temperature=0.8, max_tokens=96, seed=100 + i,
                                              stop_token_ids=(EOS,), grammar=g,
                                              logit_bias=STEER if i % 2 else ()))
            for i in range(4)]
    _drive(eng, reqs)
    for r in reqs:
        check_output(r, g, SCHEMAS["schema_enum"])
    assert any(r.finish_reason == "stop" for r in reqs)


def test_engine_mixed_constrained_and_free(weights):
    eng = _port(weights)
    g = grammar_for(tg, "json_object")
    con = eng.submit([1], SamplingParams(temperature=1.0, max_tokens=48,
                                         stop_token_ids=(EOS,), seed=7, grammar=g))
    free = eng.submit([2], SamplingParams(temperature=1.0, max_tokens=16, seed=8))
    _drive(eng, [con, free])
    check_output(con, g)
    assert len(free.output) == 16


def test_engine_grammar_caps_rejected(weights):
    eng = _port(weights, grammar_states=8)
    with pytest.raises(ValueError, match="grammar needs"):
        eng.submit([1], SamplingParams(grammar=grammar_for(tg, "json_object")))
    big = tg.compile_response_format({"type": "json_object"}, TOKEN_BYTES + [b"x"] * 10, [EOS])
    with pytest.raises(ValueError, match="compiled for a 268-token vocabulary"):
        _port(weights).submit([1], SamplingParams(grammar=big))
    with pytest.raises(ValueError, match="grammar_states"):
        EngineConfig(**ENGINE, grammar_states=40000)


def test_grammar_registry_eviction_and_reuse(weights):
    eng = _port(weights, max_grammars=1)
    g1, g2 = grammar_for(tg, "json_object"), grammar_for(tg, "schema")
    r1 = _drive(eng, [eng.submit([1], SamplingParams(temperature=0.5, max_tokens=24, seed=1,
                                                     stop_token_ids=(EOS,), grammar=g1))])[0]
    check_output(r1, g1)
    r2 = _drive(eng, [eng.submit([2], SamplingParams(temperature=0.5, max_tokens=24, seed=2,
                                                     stop_token_ids=(EOS,), grammar=g2))])[0]
    check_output(r2, g2)
    assert len(eng._g_resident) == 1 and r2.fsm_row == -1


def test_a_request_waits_for_a_grammar_row(weights):
    """Two grammars, one row: the second waits while the first runs (as
    under page pressure), then takes the row."""
    eng = _port(weights, max_grammars=1)
    g1, g2 = grammar_for(tg, "json_object"), grammar_for(tg, "schema")
    r1 = eng.submit([1], SamplingParams(temperature=0.0, max_tokens=20, grammar=g1,
                                        stop_token_ids=(EOS,)))
    r2 = eng.submit([2], SamplingParams(temperature=0.0, max_tokens=20, grammar=g2,
                                        stop_token_ids=(EOS,)))
    eng.step()
    assert r1.slot >= 0 and r2.slot == -1 and r2 in eng.waiting
    _drive(eng, [r1, r2])
    check_output(r1, g1)
    check_output(r2, g2)


def test_forced_tool_call_cannot_emit_text(weights):
    g = grammar_for(tg, "tool")
    eng = _port(weights)
    reqs = [eng.submit([3], SamplingParams(temperature=1.0, max_tokens=96, seed=60 + i,
                                           stop_token_ids=(EOS,), grammar=g))
            for i in range(3)]
    _drive(eng, reqs)
    for r in reqs:
        txt = bytes(t for t in r.output if t != EOS).decode("utf-8", "replace").lstrip(" \t\n\r")
        assert txt.startswith("<tool_call>") or "<tool_call>".startswith(txt), txt
        if r.finish_reason == "stop":
            obj = json.loads(txt.split("<tool_call>")[1].split("</tool_call>")[0])
            assert obj["name"] == "get_weather"
