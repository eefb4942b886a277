"""Grammar-constrained decoding: JSON / JSON-schema token-level DFAs
(counterpart of ``llms_on_kubernetes_tpu/engine/grammar.py``; a copy of
that framework-free module, numpy only, so the port never imports the JAX
package).

The reference's per-model servers are ``vllm/vllm-openai:v0.11.0``, which
serve OpenAI ``response_format`` (``json_object`` / ``json_schema``) and
grammar-guaranteed ``tool_choice`` via guided decoding (xgrammar/outlines).
This module is the equivalent for an engine whose sampled tokens NEVER
visit the host between steps (each window's tokens feed the next on the
device, ``engine/graphs.py``): the constraint must therefore be a pure
on-device function, not a host callback.

Pipeline (all host-side, at request admission; cached):

1. A JSON value grammar (or a JSON-schema instance of it) is built as a
   small regex-like AST over BYTES. JSON nesting is not regular, so
   object/array recursion is unrolled to a bounded depth (default
   ``DEFAULT_DEPTH``) — the standard FSM-serving tradeoff (outlines does
   the same). List repetition ``X (sep X)*`` shares ONE copy of ``X`` via
   a loop edge, so the unrolling is 2^depth small fragments, not 4^depth.
2. AST -> byte-level NFA (Thompson) -> DFA (subset construction over
   byte equivalence classes) -> minimized DFA.
3. The char DFA is composed with the tokenizer: for every DFA state
   reachable at a TOKEN boundary, run every vocab token's byte string
   through the DFA (vectorized over the vocab with numpy) giving a
   token-level transition table T[state, token] (-1 = token not allowed).
   EOS tokens are allowed exactly at accepting states and lead to an
   absorbing DONE state.
4. T's columns are compressed to token equivalence classes (tokens with
   identical behavior in every state share a column): the device arrays
   are ``class_of [V] int16`` and ``trans [S, C] int16``. Per decode
   step the engine computes ``nxt = trans[state, class_of]`` on device —
   one gather that yields BOTH the logit mask (``nxt >= 0``) and, for
   the sampled token, the next state. No host round trip, so constrained
   requests ride the async pipeline at full speed.

Unsupported JSON-schema constructs raise :class:`GrammarError` (the API
layer maps it to HTTP 400): ``$ref``, ``allOf``, ``not``,
``if``/``then``/``else``, ``patternProperties``, ``pattern``,
``contains``, ``dependentSchemas``, ``propertyNames``. Value-range
keywords a finite automaton cannot express (``minimum``/``maximum``/
``multipleOf``/``format``/``uniqueItems``) are accepted and ignored —
the grammar guarantees the TYPE SHAPE; range validation stays an
application concern (same stance as vLLM's default guided backend).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Optional, Sequence

import numpy as np

# bounded-depth unrolling for generic (schema-less) JSON values
DEFAULT_DEPTH = 6
# hard bounds turning pathological schemas into 400s instead of
# minutes-long compiles
MAX_REP = 256          # minLength/maxLength/minItems/maxItems cap
MAX_NFA_NODES = 300_000
MAX_DFA_STATES = 20_000

_WS = frozenset(b" \t\n\r")
_DIGITS = frozenset(b"0123456789")
_DIGITS19 = frozenset(b"123456789")
_HEX = frozenset(b"0123456789abcdefABCDEF")
# JSON string character, UTF-8-exact: ASCII printable except '"' and '\',
# plus well-formed multi-byte sequences (no overlongs, no surrogates).
# Byte-fallback vocabs (Llama-3 ships all 256 single-byte tokens) could
# otherwise be steered into emitting invalid UTF-8 that json.loads rejects.
_ASCII_CHAR = frozenset(range(0x20, 0x80)) - frozenset(b'"\\')
_CONT = frozenset(range(0x80, 0xC0))


class GrammarError(ValueError):
    """Unsupported or invalid grammar/schema (HTTP 400 at the API)."""


# ---------------------------------------------------------------------------
# regex-like AST over bytes
# ---------------------------------------------------------------------------
# nodes: ("lit", bytes) | ("cls", frozenset[int]) | ("seq", [ast...])
#      | ("alt", [ast...]) | ("star", ast) | ("opt", ast)
#      | ("seplist", item_ast, sep_ast)     # item (sep item)* — ONE item copy


def lit(s: "bytes | str"):
    return ("lit", s.encode("utf-8") if isinstance(s, str) else bytes(s))


def cls(chars: frozenset) -> tuple:
    return ("cls", frozenset(chars))


def seq(*parts) -> tuple:
    return ("seq", list(parts))


def alt(*parts) -> tuple:
    return ("alt", list(parts))


def star(x) -> tuple:
    return ("star", x)


def opt(x) -> tuple:
    return ("opt", x)


def seplist(item, sep) -> tuple:
    return ("seplist", item, sep)


def rep(x, lo: int, hi: Optional[int]) -> tuple:
    """lo..hi copies of x (hi=None => unbounded)."""
    if lo < 0 or (hi is not None and hi < lo):
        raise GrammarError(f"bad repetition bounds ({lo}, {hi})")
    if hi is not None and hi > MAX_REP:
        raise GrammarError(f"repetition bound {hi} exceeds {MAX_REP}")
    if lo > MAX_REP:
        raise GrammarError(f"repetition bound {lo} exceeds {MAX_REP}")
    parts = [x] * lo
    if hi is None:
        parts.append(star(x))
    else:
        parts.extend([opt(x)] * (hi - lo))
    return ("seq", parts)


# ---------------------------------------------------------------------------
# NFA construction (Thompson with eps edges; seplist builds a shared loop)
# ---------------------------------------------------------------------------


class _NFA:
    def __init__(self):
        self.eps: list[list[int]] = []
        self.edges: list[list[tuple[frozenset, int]]] = []

    def node(self) -> int:
        if len(self.eps) >= MAX_NFA_NODES:
            raise GrammarError(
                f"grammar too large (> {MAX_NFA_NODES} NFA nodes)")
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1

    def add_eps(self, a: int, b: int) -> None:
        self.eps[a].append(b)

    def add_edge(self, a: int, chars: frozenset, b: int) -> None:
        if chars:
            self.edges[a].append((chars, b))

    def build(self, ast) -> tuple[int, int]:
        """Compile ``ast`` into fresh nodes; returns (start, end)."""
        kind = ast[0]
        if kind == "lit":
            s = self.node()
            cur = s
            for byte in ast[1]:
                nxt = self.node()
                self.add_edge(cur, frozenset((byte,)), nxt)
                cur = nxt
            return s, cur
        if kind == "cls":
            s, e = self.node(), self.node()
            self.add_edge(s, ast[1], e)
            return s, e
        if kind == "seq":
            s = self.node()
            cur = s
            for part in ast[1]:
                ps, pe = self.build(part)
                self.add_eps(cur, ps)
                cur = pe
            return s, cur
        if kind == "alt":
            s, e = self.node(), self.node()
            for part in ast[1]:
                ps, pe = self.build(part)
                self.add_eps(s, ps)
                self.add_eps(pe, e)
            return s, e
        if kind == "star":
            s, e = self.node(), self.node()
            ps, pe = self.build(ast[1])
            self.add_eps(s, ps)
            self.add_eps(s, e)
            self.add_eps(pe, ps)
            self.add_eps(pe, e)
            return s, e
        if kind == "opt":
            s, e = self.node(), self.node()
            ps, pe = self.build(ast[1])
            self.add_eps(s, ps)
            self.add_eps(pe, e)
            self.add_eps(s, e)
            return s, e
        if kind == "seplist":
            # item (sep item)* with ONE copy of item: loop back through sep
            s, e = self.node(), self.node()
            is_, ie = self.build(ast[1])
            ss, se = self.build(ast[2])
            self.add_eps(s, is_)
            self.add_eps(ie, e)
            self.add_eps(ie, ss)
            self.add_eps(se, is_)
            return s, e
        if kind == "members":
            # ordered object members with optional skips: the separator
            # belongs to the TRANSITION between two present members, so
            # "has one been emitted yet" is encoded as two parallel node
            # chains (A = none yet, B = at least one) — LINEAR in the
            # member count, vs the 2^n duplication a naive alternation
            # over "first present member" suffers.
            items, sep = ast[1], ast[2]
            n = len(items)
            A = [self.node() for _ in range(n + 1)]
            Bc = [self.node() for _ in range(n + 1)]
            for i, (required, frag) in enumerate(items):
                fs, fe = self.build(frag)          # A-path copy (first)
                self.add_eps(A[i], fs)
                self.add_eps(fe, Bc[i + 1])
                ss, se = self.build(sep)           # B-path copy (sep+frag)
                fs2, fe2 = self.build(frag)
                self.add_eps(Bc[i], ss)
                self.add_eps(se, fs2)
                self.add_eps(fe2, Bc[i + 1])
                if not required:
                    self.add_eps(A[i], A[i + 1])
                    self.add_eps(Bc[i], Bc[i + 1])
            end = self.node()
            self.add_eps(A[n], end)   # reachable only if nothing required
            self.add_eps(Bc[n], end)
            return A[0], end
        raise GrammarError(f"unknown AST node {kind!r}")


@dataclasses.dataclass
class CharDFA:
    """Minimized byte-level DFA. ``table[state, byte2class[byte]]`` is the
    next state (-1 = reject); ``accept[state]`` marks accepting states."""

    table: np.ndarray        # [S, K] int32
    accept: np.ndarray       # [S] bool
    byte2class: np.ndarray   # [256] int32
    start: int

    def matches(self, data: bytes) -> bool:
        s = self.start
        for b in data:
            s = int(self.table[s, self.byte2class[b]])
            if s < 0:
                return False
        return bool(self.accept[s])


def _byte_classes(nfa: _NFA) -> tuple[np.ndarray, list[int]]:
    """Partition 0..255 into classes equivalent across every NFA edge set.
    Returns (byte2class [256], representative byte per class)."""
    unique_sets: list[frozenset] = []
    seen: dict[frozenset, int] = {}
    for node_edges in nfa.edges:
        for chars, _ in node_edges:
            if chars not in seen:
                seen[chars] = len(unique_sets)
                unique_sets.append(chars)
    sig = np.zeros((256, len(unique_sets)), np.bool_)
    for j, chars in enumerate(unique_sets):
        for b in chars:
            sig[b, j] = True
    _, byte2class = np.unique(sig, axis=0, return_inverse=True)
    reps: dict[int, int] = {}
    for b in range(256):
        reps.setdefault(int(byte2class[b]), b)
    rep_list = [reps[c] for c in range(len(reps))]
    return byte2class.astype(np.int32), rep_list


def _eps_closure(nfa: _NFA, states: frozenset) -> frozenset:
    stack = list(states)
    out = set(states)
    while stack:
        s = stack.pop()
        for t in nfa.eps[s]:
            if t not in out:
                out.add(t)
                stack.append(t)
    return frozenset(out)


def _subset_construct(nfa: _NFA, start: int, accept: int) -> CharDFA:
    byte2class, reps = _byte_classes(nfa)
    K = len(reps)
    start_set = _eps_closure(nfa, frozenset((start,)))
    ids: dict[frozenset, int] = {start_set: 0}
    rows: list[list[int]] = []
    accepts: list[bool] = [accept in start_set]
    work = [start_set]
    while work:
        cur = work.pop()
        i = ids[cur]
        while len(rows) <= i:
            rows.append([-1] * K)
        for c in range(K):
            rb = reps[c]
            targets = set()
            for s in cur:
                for chars, t in nfa.edges[s]:
                    if rb in chars:
                        targets.add(t)
            if not targets:
                continue
            nxt = _eps_closure(nfa, frozenset(targets))
            if nxt not in ids:
                if len(ids) >= MAX_DFA_STATES:
                    raise GrammarError(
                        f"grammar too large (> {MAX_DFA_STATES} DFA states)")
                ids[nxt] = len(ids)
                accepts.append(accept in nxt)
                work.append(nxt)
            rows[i][c] = ids[nxt]
    table = np.asarray(rows, np.int32)
    return _minimize(CharDFA(table, np.asarray(accepts, np.bool_),
                             byte2class, 0))


def _minimize(dfa: CharDFA) -> CharDFA:
    """Moore partition refinement (numpy row-signature rounds)."""
    S, K = dfa.table.shape
    # append an explicit dead state so -1 participates in refinement
    table = np.vstack([dfa.table, np.full((1, K), S, np.int32)])
    table = np.where(table < 0, S, table)
    accept = np.concatenate([dfa.accept, [False]])
    labels = accept.astype(np.int64)
    while True:
        sig = np.concatenate([labels[:, None], labels[table]], axis=1)
        _, new = np.unique(sig, axis=0, return_inverse=True)
        if np.array_equal(new, labels):
            break
        labels = new
    # rebuild: one representative per label; start's label first
    n_lab = int(labels.max()) + 1
    rep_state = np.full(n_lab, -1, np.int64)
    for s in range(S + 1):
        if rep_state[labels[s]] < 0:
            rep_state[labels[s]] = s
    dead_lab = labels[S]
    # map labels -> compact ids with start first, dead dropped
    order = [int(labels[dfa.start])] + [
        int(l) for l in range(n_lab)
        if l != labels[dfa.start] and l != dead_lab]
    lab2new = {l: i for i, l in enumerate(order)}
    S2 = len(order)
    out = np.full((S2, K), -1, np.int32)
    acc2 = np.zeros(S2, np.bool_)
    for l, i in lab2new.items():
        r = int(rep_state[l])
        acc2[i] = accept[r]
        for c in range(K):
            t_lab = int(labels[table[r, c]])
            if t_lab != dead_lab:
                out[i, c] = lab2new[t_lab]
    return CharDFA(out, acc2, dfa.byte2class, 0)


def compile_char_dfa(ast) -> CharDFA:
    nfa = _NFA()
    s, e = nfa.build(ast)
    return _subset_construct(nfa, s, e)


# ---------------------------------------------------------------------------
# JSON grammar ASTs
# ---------------------------------------------------------------------------

_ws = star(cls(_WS))


def _utf8_char_ast():
    """One well-formed UTF-8 character >= 0x20, excluding '"' and '\\'."""
    cont = cls(_CONT)
    return alt(
        cls(_ASCII_CHAR),
        seq(cls(frozenset(range(0xC2, 0xE0))), cont),
        seq(lit(b"\xe0"), cls(frozenset(range(0xA0, 0xC0))), cont),
        seq(cls(frozenset(range(0xE1, 0xED))), cont, cont),
        seq(lit(b"\xed"), cls(frozenset(range(0x80, 0xA0))), cont),
        seq(cls(frozenset((0xEE, 0xEF))), cont, cont),
        seq(lit(b"\xf0"), cls(frozenset(range(0x90, 0xC0))), cont, cont),
        seq(cls(frozenset(range(0xF1, 0xF4))), cont, cont, cont),
        seq(lit(b"\xf4"), cls(frozenset(range(0x80, 0x90))), cont, cont),
    )


def _json_string_ast(min_len: Optional[int] = None,
                     max_len: Optional[int] = None):
    escape = seq(lit("\\"), alt(cls(frozenset(b'"\\/bfnrt')),
                                seq(lit("u"), rep(cls(_HEX), 4, 4))))
    ch = alt(_utf8_char_ast(), escape)
    if min_len is None and max_len is None:
        body = star(ch)
    else:
        lo = int(min_len or 0)
        hi = None if max_len is None else int(max_len)
        body = rep(ch, lo, hi)
    return seq(lit('"'), body, lit('"'))


def _json_number_ast(integer: bool = False):
    int_part = seq(opt(lit("-")),
                   alt(lit("0"), seq(cls(_DIGITS19), star(cls(_DIGITS)))))
    if integer:
        return int_part
    frac = opt(seq(lit("."), cls(_DIGITS), star(cls(_DIGITS))))
    expo = opt(seq(cls(frozenset(b"eE")), opt(cls(frozenset(b"+-"))),
                   cls(_DIGITS), star(cls(_DIGITS))))
    return seq(int_part, frac, expo)


def _json_value_ast(depth: int):
    """Generic JSON value, object/array nesting unrolled to ``depth``."""
    scalars = [_json_string_ast(), _json_number_ast(),
               lit("true"), lit("false"), lit("null")]
    if depth <= 0:
        return alt(*scalars)
    inner = _json_value_ast(depth - 1)
    return alt(*scalars, _json_object_ast(inner), _json_array_ast(inner))


def _json_object_ast(value_ast):
    member = seq(_json_string_ast(), _ws, lit(":"), _ws, value_ast)
    members = seplist(member, seq(_ws, lit(","), _ws))
    return seq(lit("{"), _ws, opt(seq(members, _ws)), lit("}"))


def _json_array_ast(value_ast):
    items = seplist(value_ast, seq(_ws, lit(","), _ws))
    return seq(lit("["), _ws, opt(seq(items, _ws)), lit("]"))


# ---------------------------------------------------------------------------
# JSON-schema -> AST
# ---------------------------------------------------------------------------

_UNSUPPORTED = ("$ref", "allOf", "not", "if", "then", "else",
                "patternProperties", "pattern", "contains",
                "dependentSchemas", "dependentRequired", "propertyNames",
                "unevaluatedProperties", "unevaluatedItems")


def _schema_ast(schema: Any, depth: int):
    if schema is True or schema == {}:
        return _json_value_ast(depth)
    if schema is False:
        raise GrammarError("schema 'false' matches nothing")
    if not isinstance(schema, dict):
        raise GrammarError(f"schema must be an object, got {type(schema).__name__}")
    for key in _UNSUPPORTED:
        if key in schema:
            raise GrammarError(f"unsupported JSON-schema construct {key!r}")

    if "const" in schema:
        return lit(json.dumps(schema["const"], separators=(",", ":"),
                              ensure_ascii=False))
    if "enum" in schema:
        if not isinstance(schema["enum"], list) or not schema["enum"]:
            raise GrammarError("enum must be a non-empty list")
        return alt(*[lit(json.dumps(v, separators=(",", ":"),
                                    ensure_ascii=False))
                     for v in schema["enum"]])
    if "anyOf" in schema or "oneOf" in schema:
        variants = schema.get("anyOf", schema.get("oneOf"))
        if not isinstance(variants, list) or not variants:
            raise GrammarError("anyOf/oneOf must be a non-empty list")
        # oneOf exclusivity is not FSM-expressible; treated as anyOf
        return alt(*[_schema_ast(v, depth) for v in variants])

    t = schema.get("type")
    if isinstance(t, list):
        if not t:
            raise GrammarError("type list must be non-empty")
        return alt(*[_schema_ast({**schema, "type": one}, depth) for one in t])
    if t is None:
        if "properties" in schema or "required" in schema:
            t = "object"
        elif "items" in schema or "prefixItems" in schema:
            t = "array"
        else:
            return _json_value_ast(depth)

    if t == "string":
        mn, mx = schema.get("minLength"), schema.get("maxLength")
        for v in (mn, mx):
            if v is not None and (not isinstance(v, int) or v < 0):
                raise GrammarError("minLength/maxLength must be ints >= 0")
        if mx is not None and mx > MAX_REP:
            raise GrammarError(f"maxLength {mx} exceeds {MAX_REP}")
        return _json_string_ast(mn, mx)
    if t == "number":
        return _json_number_ast()
    if t == "integer":
        return _json_number_ast(integer=True)
    if t == "boolean":
        return alt(lit("true"), lit("false"))
    if t == "null":
        return lit("null")
    if t == "array":
        return _schema_array_ast(schema, depth)
    if t == "object":
        return _schema_object_ast(schema, depth)
    raise GrammarError(f"unsupported schema type {t!r}")


def _schema_array_ast(schema: dict, depth: int):
    prefix = schema.get("prefixItems")
    items = schema.get("items")
    mn, mx = schema.get("minItems", 0), schema.get("maxItems")
    for v in (mn, mx):
        if v is not None and (not isinstance(v, int) or v < 0):
            raise GrammarError("minItems/maxItems must be ints >= 0")
    sep = seq(_ws, lit(","), _ws)
    if prefix is not None:
        if not isinstance(prefix, list) or not prefix:
            raise GrammarError("prefixItems must be a non-empty list")
        k = len(prefix)
        if mx is not None and mx < k:
            raise GrammarError(
                f"maxItems {mx} below the {k} prefixItems (the generator "
                f"always emits the full prefix)")
        if mn > k and items in (None, False):
            raise GrammarError(
                f"minItems {mn} exceeds the {k} prefixItems with no "
                f"items schema for the rest")
        parts = [_schema_ast(p, depth - 1) for p in prefix]
        body = parts[0]
        for p in parts[1:]:
            body = seq(body, sep, p)
        if items not in (None, False):
            extra = _schema_ast(items if items is not True else {}, depth - 1)
            body = seq(body, rep(seq(sep, extra), max(0, mn - k),
                                 None if mx is None else mx - k))
        return seq(lit("["), _ws, body, _ws, lit("]"))
    item = _schema_ast(items if items is not None else {}, depth - 1)
    if mx is not None and mx > MAX_REP:
        raise GrammarError(f"maxItems {mx} exceeds {MAX_REP}")
    if mn == 0 and mx is None:
        body = opt(seq(seplist(item, sep), _ws))
        return seq(lit("["), _ws, body, lit("]"))
    # bounded: item (sep item){mn-1..mx-1}
    if mx == 0:
        return seq(lit("["), _ws, lit("]"))
    body = seq(item, rep(seq(sep, item), max(0, mn - 1),
                         None if mx is None else mx - 1))
    inner = opt(seq(body, _ws)) if mn == 0 else seq(body, _ws)
    return seq(lit("["), _ws, inner, lit("]"))


def _schema_object_ast(schema: dict, depth: int):
    props = schema.get("properties")
    required = schema.get("required", [])
    if not isinstance(required, list):
        raise GrammarError("required must be a list")
    if props is None:
        if required:
            raise GrammarError(
                "required without properties is not supported")
        inner = _json_value_ast(max(0, depth - 1))
        return _json_object_ast(inner)
    if not isinstance(props, dict):
        raise GrammarError("properties must be an object")
    unknown = [r for r in required if r not in props]
    if unknown:
        raise GrammarError(f"required names not in properties: {unknown}")
    if not props:
        return seq(lit("{"), _ws, lit("}"))
    # Emit properties in DECLARED ORDER (outlines/vLLM convention);
    # optional ones are skippable. The "members" NFA node keeps this
    # linear in the property count (see _NFA.build).
    members = []
    for name, sub in props.items():
        key = lit(json.dumps(name, ensure_ascii=False))
        members.append((name in set(required),
                        seq(key, _ws, lit(":"), _ws,
                            _schema_ast(sub, depth - 1))))
    comma = seq(_ws, lit(","), _ws)
    return seq(lit("{"), _ws, ("members", members, comma), _ws, lit("}"))


# ---------------------------------------------------------------------------
# top-level grammar specs
# ---------------------------------------------------------------------------

_trail_ws = rep(cls(_WS), 0, 2)


def json_object_ast(depth: int = DEFAULT_DEPTH):
    """OpenAI ``response_format: {"type": "json_object"}``: any JSON
    object (nesting bounded at ``depth``)."""
    inner = _json_value_ast(depth - 1)
    return seq(_ws, _json_object_ast(inner), _trail_ws)


def json_schema_ast(schema: Any, depth: int = DEFAULT_DEPTH):
    return seq(_ws, _schema_ast(schema, depth), _trail_ws)


def tool_call_ast(tools: Sequence[dict], force_name: Optional[str],
                  depth: int = DEFAULT_DEPTH):
    """Forced tool calling: ``<tool_call>{"name": ..., "arguments": {...}}
    </tool_call>`` blocks (the Hermes/Qwen convention ToolStreamParser
    extracts — server/tools.py). ``force_name`` pins a single call to one
    function; None ("required") allows 1+ calls to any listed tool."""
    variants = []
    for t in tools:
        fn = t["function"]
        name = fn["name"]
        if force_name is not None and name != force_name:
            continue
        params = fn.get("parameters")
        if params in (None, {}):
            args_ast = _schema_object_ast({"properties": {}}, depth)
        else:
            args_ast = _schema_ast(params, depth)
        body = seq(lit("{"), _ws,
                   lit(json.dumps("name")), _ws, lit(":"), _ws,
                   lit(json.dumps(name, ensure_ascii=False)),
                   _ws, lit(","), _ws,
                   lit(json.dumps("arguments")), _ws, lit(":"), _ws,
                   args_ast, _ws, lit("}"))
        variants.append(seq(lit("<tool_call>"), _ws, body, _ws,
                            lit("</tool_call>")))
    if not variants:
        raise GrammarError(f"tool_choice names unknown function {force_name!r}")
    call = alt(*variants)
    if force_name is not None:
        return seq(_ws, call, _trail_ws)
    return seq(_ws, seplist(call, _ws), _trail_ws)


# ---------------------------------------------------------------------------
# tokenizer composition: char DFA -> token-level tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CompiledGrammar:
    """Token-level DFA ready for the engine's device tables.

    ``trans[s, class_of[tok]]`` is the next state after emitting ``tok``
    from state ``s`` (-1 = not allowed). ``start`` is the initial state;
    EOS tokens transition accepting states into an absorbing DONE state
    (every token allowed — post-EOS steps are speculative garbage the
    engine discards). ``key`` identifies the grammar for dedup/caching."""

    key: str
    class_of: np.ndarray     # [V] int16
    trans: np.ndarray        # [S, C] int16
    start: int
    n_states: int            # S
    n_classes: int           # C

    def next_state(self, state: int, token: int) -> int:
        return int(self.trans[state, self.class_of[token]])

    def allowed(self, state: int) -> np.ndarray:
        """Host-side debug/test helper: bool[V] of allowed tokens."""
        return self.trans[state][self.class_of] >= 0


def compile_token_dfa(char_dfa: CharDFA,
                      token_bytes: "list[Optional[bytes]]",
                      eos_ids: Sequence[int],
                      key: str = "",
                      max_states: int = MAX_DFA_STATES) -> CompiledGrammar:
    """Compose a char DFA with a tokenizer's vocabulary.

    The naive build is O(states x vocab x token-length) — minutes at a
    128K BPE vocab. Two collapses make it sub-second:

    1. A token's effect on the DFA depends only on its BYTE-CLASS
       sequence; a 128K vocab has far fewer unique class sequences
       (plain-word tokens all look alike to a JSON grammar).
    2. Unique sequences sorted lexicographically share prefixes; a
       stack-based traversal composes each transition vector [S] once
       per distinct trie node, not once per (state, token).

    The resulting end-state vectors (one per unique sequence) ARE the
    transition table's columns; np.unique over them yields the token
    equivalence classes directly — the [S, V] table is never built."""
    V = len(token_bytes)
    eos = [e for e in set(int(e) for e in eos_ids) if 0 <= e < V]
    if not eos:
        raise GrammarError("no EOS token id inside the vocabulary")
    table = char_dfa.table                      # [S, K] int32
    S = int(table.shape[0])
    if S + 1 > max_states:
        raise GrammarError(
            f"grammar too large (> {max_states} token-DFA states)")

    lens = np.asarray([-1 if t is None else len(t) for t in token_bytes],
                      np.int32)
    Lmax = max(1, int(lens.max(initial=0)))
    mat = np.full((V, Lmax), 255, np.uint8)     # 255 = past-end pad
    b2c = char_dfa.byte2class.astype(np.uint8)
    for i, t in enumerate(token_bytes):
        if t:
            arr = np.frombuffer(t, np.uint8)
            mat[i, :len(arr)] = b2c[arr]

    # unique class sequences (padded rows are unique keys: 255 never a class)
    seqs, inv = np.unique(mat, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    U = seqs.shape[0]

    # Level-synchronous trie walk with STATE-VECTOR interning: every trie
    # node's effect is a function [S]->[S or dead]; distinct functions are
    # few (most prefixes collapse to "rejected everywhere except
    # string-interior"), so each level is one batched gather over the
    # distinct (function, class) pairs. -1 (reject) rides as dead index S.
    tbl = np.vstack([table, np.full((1, table.shape[1]), -1, np.int32)])
    tbl = np.where(tbl < 0, S, tbl)             # dead state index S
    ident = np.arange(S, dtype=np.int32)
    vec_rows = [ident]                           # id -> [S] vector
    vec_ids: dict[bytes, int] = {ident.tobytes(): 0}
    seq_vec = np.zeros(U, np.int64)              # per-sequence current id
    K = int(tbl.shape[1])
    for d in range(Lmax):
        act = np.nonzero(seqs[:, d] != 255)[0]
        if act.size == 0:
            break
        pairs = seq_vec[act] * 256 + seqs[act, d]
        upairs, pinv = np.unique(pairs, return_inverse=True)
        parents = (upairs // 256).astype(np.int64)
        classes = (upairs % 256).astype(np.int64)
        stacked = np.asarray([vec_rows[p] for p in parents])   # [P, S]
        children = tbl[stacked, classes[:, None]]              # [P, S]
        child_ids = np.empty(len(upairs), np.int64)
        for j in range(children.shape[0]):
            key = children[j].tobytes()
            cid = vec_ids.get(key)
            if cid is None:
                cid = len(vec_rows)
                vec_ids[key] = cid
                vec_rows.append(children[j])
            child_ids[j] = cid
        seq_vec[act] = child_ids[pinv]

    # token classes = distinct terminal vectors (already interned) +
    # dedicated reject/EOS columns
    terml, tinv = np.unique(seq_vec, return_inverse=True)
    C = len(terml)
    uF = np.asarray([vec_rows[t] for t in terml])  # [C, S]
    uF[uF == S] = -1
    class_of = tinv[inv].astype(np.int32)
    class_of[lens <= 0] = C            # specials/empty: reject class
    c_eos = C + 1
    class_of[eos] = c_eos              # EOS class (overrides byte content)

    DONE = S
    trans = np.full((S + 1, C + 2), -1, np.int32)
    trans[:S, :C] = uF.T
    trans[:S, C] = -1
    trans[:S, c_eos] = np.where(char_dfa.accept[:S], DONE, -1)
    trans[DONE, :] = DONE  # post-EOS steps are speculative; allow anything

    # dead-end check: every state reachable at a token boundary must allow
    # some token (byte-fallback vocabs make this true by construction; a
    # vocab missing bytes could violate it, which would let sampling emit
    # garbage silently)
    reachable = np.zeros(S + 1, np.bool_)
    frontier = [char_dfa.start]
    reachable[char_dfa.start] = True
    while frontier:
        s = frontier.pop()
        for t in np.unique(trans[s]):
            if t >= 0 and not reachable[t]:
                reachable[t] = True
                frontier.append(int(t))
    dead = np.nonzero(reachable & ~(trans >= 0).any(axis=1))[0]
    if dead.size:
        raise GrammarError(
            f"grammar has {dead.size} token-level dead-end state(s) — the "
            f"vocabulary cannot continue the pattern from there")

    if S + 1 > 32767 or C + 2 > 32767:
        raise GrammarError("grammar exceeds int16 table range")
    return CompiledGrammar(
        key=key,
        class_of=class_of.astype(np.int16),
        trans=trans.astype(np.int16),
        start=int(char_dfa.start),
        n_states=S + 1,
        n_classes=C + 2,
    )


# ---------------------------------------------------------------------------
# tokenizer vocab -> byte strings
# ---------------------------------------------------------------------------


def _gpt2_byte_decoder() -> dict[str, int]:
    """The byte-level-BPE unicode<->byte table (GPT-2 convention, used by
    Llama-3 / Qwen / GPT-NeoX tokenizers)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


def _json_tokenizer_bytes(tokenizer) -> "list[Optional[bytes]]":
    """The port's ``JsonTokenizer`` (a ``tokenizer.json`` read without
    ``transformers``): the id -> bytes map the HF branch below derives,
    from the file's own vocabulary and added tokens. Added tokens (special
    or not) and the special tokens of tokenizer_config.json are None; a byte-level vocabulary (llama-3) decodes through
    the GPT-2 byte table (a piece outside it is None); a SentencePiece one
    (phi-3: "▁" in the first 4,000 pieces) reads "▁" as a space and
    ``<0xNN>`` as the byte."""
    added = {int(a["id"]) for a in tokenizer.added.values()}
    for v in tokenizer.special_tokens_map.values():
        for t in (v if isinstance(v, list) else [v]):
            tid = tokenizer.token_to_id(t) if isinstance(t, str) else None
            if tid is not None:
                added.add(int(tid))
    size = max(list(tokenizer.id_to_token) + [-1]) + 1
    pieces = [tokenizer.id_to_token.get(i) for i in range(size)]
    spm = any("▁" in (p or "") for p in pieces[:4000])
    byte_dec = None if spm else _gpt2_byte_decoder()
    out: "list[Optional[bytes]]" = []
    for i, p in enumerate(pieces):
        if i in added or p is None:
            out.append(None)
            continue
        if spm:
            if p.startswith("<0x") and p.endswith(">") and len(p) == 6:
                try:
                    out.append(bytes([int(p[3:-1], 16)]))
                    continue
                except ValueError:
                    pass
            out.append(p.replace("▁", " ").encode("utf-8"))
        else:
            try:
                out.append(bytes(byte_dec[ch] for ch in p))
            except KeyError:
                out.append(None)  # non-byte-level piece
    return out


def token_bytes_of(tokenizer) -> "list[Optional[bytes]]":
    """Token id -> raw byte string (None = special/control token, never
    allowed inside a grammar). Handles the engine's tokenizer families:
    ByteTokenizer (tests), the port's JsonTokenizer (a tokenizer.json
    read in pure Python), HF byte-level BPE, HF/GGUF SentencePiece."""
    # ByteTokenizer: ids 0..255 are the bytes themselves
    from llms_on_kubernetes_tpu_torch.engine.tokenizer import ByteTokenizer, JsonTokenizer

    if isinstance(tokenizer, ByteTokenizer):
        out: "list[Optional[bytes]]" = [bytes([i]) for i in range(256)]
        out += [None, None]  # BOS, EOS
        return out
    if isinstance(tokenizer, JsonTokenizer):
        return _json_tokenizer_bytes(tokenizer)

    # GGUF (SentencePiece vocab embedded in the model file)
    tokens = getattr(tokenizer, "tokens", None)
    if tokens is not None and isinstance(tokens, list):
        control = getattr(tokenizer, "_control", set())
        byte_ids = set(getattr(tokenizer, "_byte_ids", {}).values())
        out = []
        for i, t in enumerate(tokens):
            if i in control:
                out.append(None)
            elif i in byte_ids or (t.startswith("<0x") and t.endswith(">")):
                try:
                    out.append(bytes([int(t[3:-1], 16)]))
                except ValueError:
                    out.append(None)
            else:
                out.append(t.replace("▁", " ").encode("utf-8"))
        return out

    # HF AutoTokenizer wrapper
    tok = getattr(tokenizer, "_tok", tokenizer)
    if not hasattr(tok, "convert_ids_to_tokens"):
        raise GrammarError(
            f"cannot derive a token byte map from {type(tokenizer).__name__}")
    vocab_size = len(tok)
    specials = set(getattr(tok, "all_special_ids", []) or [])
    added = getattr(tok, "added_tokens_decoder", {}) or {}
    specials |= {int(i) for i in added.keys()}
    pieces = tok.convert_ids_to_tokens(list(range(vocab_size)))
    spm = any("▁" in (p or "") for p in pieces[:4000])
    byte_dec = None if spm else _gpt2_byte_decoder()
    out = []
    for i, p in enumerate(pieces):
        if i in specials or p is None:
            out.append(None)
            continue
        if spm:
            if p.startswith("<0x") and p.endswith(">") and len(p) == 6:
                try:
                    out.append(bytes([int(p[3:-1], 16)]))
                    continue
                except ValueError:
                    pass
            out.append(p.replace("▁", " ").encode("utf-8"))
        else:
            try:
                out.append(bytes(byte_dec[ch] for ch in p))
            except KeyError:
                out.append(None)  # non-byte-level added piece
    return out


def vocab_fingerprint(token_bytes: "list[Optional[bytes]]") -> str:
    h = hashlib.sha256()
    for t in token_bytes:
        h.update(b"\xff\x00" if t is None else t + b"\xff\x01")
    return h.hexdigest()[:16]


# ---------------------------------------------------------------------------
# compile entry points (with a small in-process cache)
# ---------------------------------------------------------------------------

_cache: "dict[tuple, CompiledGrammar]" = {}
_CACHE_MAX = 32


def _cached(key: tuple, build) -> CompiledGrammar:
    hit = _cache.get(key)
    if hit is not None:
        return hit
    g = build()
    if len(_cache) >= _CACHE_MAX:
        _cache.pop(next(iter(_cache)))
    _cache[key] = g
    return g


def compile_response_format(response_format: dict,
                            token_bytes: "list[Optional[bytes]]",
                            eos_ids: Sequence[int],
                            depth: int = DEFAULT_DEPTH) -> Optional[CompiledGrammar]:
    """OpenAI ``response_format`` -> CompiledGrammar (None for type=text).
    Raises GrammarError (HTTP 400) on unsupported shapes/constructs."""
    if not isinstance(response_format, dict):
        raise GrammarError("response_format must be an object")
    kind = response_format.get("type")
    if kind in (None, "text"):
        return None
    fp = vocab_fingerprint(token_bytes)
    eos_key = tuple(sorted(set(int(e) for e in eos_ids)))
    if kind == "json_object":
        key = ("json_object", depth, fp, eos_key)
        return _cached(key, lambda: compile_token_dfa(
            compile_char_dfa(json_object_ast(depth)), token_bytes, eos_ids,
            key="json_object"))
    if kind == "json_schema":
        js = response_format.get("json_schema")
        if not isinstance(js, dict) or "schema" not in js:
            raise GrammarError(
                "response_format json_schema needs {'json_schema': "
                "{'schema': {...}}}")
        schema = js["schema"]
        skey = json.dumps(schema, sort_keys=True, separators=(",", ":"))
        key = ("json_schema", skey, depth, fp, eos_key)
        return _cached(key, lambda: compile_token_dfa(
            compile_char_dfa(json_schema_ast(schema, depth)), token_bytes,
            eos_ids, key="schema:" + hashlib.sha256(
                skey.encode()).hexdigest()[:16]))
    raise GrammarError(
        f"response_format type {kind!r} is not supported "
        f"(text | json_object | json_schema)")


def compile_tool_choice(tools: Sequence[dict], force_name: Optional[str],
                        token_bytes: "list[Optional[bytes]]",
                        eos_ids: Sequence[int],
                        depth: int = DEFAULT_DEPTH) -> CompiledGrammar:
    """Grammar for ``tool_choice: required`` (force_name=None) or a named
    function — the sampled stream CANNOT be plain text."""
    tools_key = json.dumps(tools, sort_keys=True, separators=(",", ":"))
    fp = vocab_fingerprint(token_bytes)
    eos_key = tuple(sorted(set(int(e) for e in eos_ids)))
    key = ("tools", tools_key, force_name, depth, fp, eos_key)
    return _cached(key, lambda: compile_token_dfa(
        compile_char_dfa(tool_call_ast(tools, force_name, depth)),
        token_bytes, eos_ids,
        key="tools:" + hashlib.sha256(
            (tools_key + "|" + str(force_name)).encode()).hexdigest()[:16]))
