"""Tokenizers (counterpart of ``llms_on_kubernetes_tpu/engine/tokenizer.py``).

Copies of the JAX package's ``ByteTokenizer`` (ids 0-255 are UTF-8 bytes,
256 = BOS, 257 = EOS) and ``HFTokenizer`` (``transformers``' AutoTokenizer
over local files), and its ``load_tokenizer``, so the port never imports
the JAX package.

``JsonTokenizer`` reads a HuggingFace ``tokenizer.json`` (and
``tokenizer_config.json``) in pure Python, with the standard library and
``jinja2`` for the chat template, so a checkpoint directory serves its own
text on a machine without ``transformers`` or ``tokenizers``. It does what
``transformers``' fast tokenizer does for the two families the port
serves, and raises for a component it does not implement:

- byte-level BPE (llama-3; Qwen2/Qwen3): the ``Split`` pre-tokenizer's
  regex as a scanner over ``unicodedata`` categories (Python's ``re`` has
  no ``\\p{L}``; Qwen's takes one digit a piece where llama-3's takes up
  to three), the ``NFC`` normalizer, the GPT-2 byte table,
  ``ignore_merges`` (or not) and the ``TemplateProcessing`` (or bare
  ``ByteLevel``: no BOS) post-processor;
- SentencePiece BPE (phi-3; gemma-3's layout: ``Replace`` alone and a
  ``Split`` on a string): the ``Prepend`` / ``Replace`` normalizer, a
  ``Split`` on a literal string with any ``behavior`` and ``invert``,
  ``byte_fallback`` to ``<0xNN>`` tokens, the ``Replace`` / ``ByteFallback``
  / ``Fuse`` / ``Strip`` decoder, and ``add_bos_token`` /
  ``add_eos_token`` from ``tokenizer_config.json`` (a ``LlamaTokenizer``
  or ``GemmaTokenizer`` class rebuilds its post-processor from them, as
  ``transformers`` does);
- in both: added tokens split out of the text before normalization (with
  their ``lstrip`` / ``rstrip`` flags), the merge order
  of ``tokenizers``' BPE (lowest rank, then leftmost), ``decode`` with
  ``skip_special_tokens`` and ``clean_up_tokenization_spaces``, ``eos_ids``
  by ``HFTokenizer``'s rule, and the chat template rendered as
  ``apply_chat_template(tokenize=True, add_generation_prompt=True)`` does;
  and the ``WordLevel`` model with the ``Whitespace`` pre-tokenizer.

``load_tokenizer`` gives the reader for any directory with
``tokenizer.json``, on both machines; a directory with only
``tokenizer.model`` keeps ``HFTokenizer``, which raises, naming the
directory, where ``transformers`` is missing. ``GGUFTokenizer`` (a copy
of the JAX class) reads the SentencePiece vocabulary and the chat template
a ``.gguf`` file embeds; ``load_tokenizer`` gives it for such a file.
"""

from __future__ import annotations

import heapq
import json
import os
import re
import unicodedata
from typing import Optional, Sequence


class ByteTokenizer:
    """UTF-8 byte tokenizer: ids 0-255 are bytes, 256=BOS, 257=EOS."""

    BOS = 256
    EOS = 257
    vocab_size = 258

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", errors="replace")

    def apply_chat_template(self, messages: list[dict],
                            tools: Optional[list] = None) -> list[int]:
        text = ""
        if tools:  # render schemas the way tool-aware templates do
            text += f"<tools>{json.dumps(tools, sort_keys=True)}</tools>"
        text += "".join(
            f"<{m.get('role', 'user')}>{m.get('content', '')}</{m.get('role', 'user')}>"
            for m in messages
        )
        return [self.BOS] + self.encode(text)

    @property
    def eos_ids(self) -> set[int]:
        return {self.EOS}


class HFTokenizer:
    """transformers AutoTokenizer over a checkpoint directory's own files
    (local files only)."""

    def __init__(self, path: str):
        try:
            from transformers import AutoTokenizer
        except ImportError as e:
            raise RuntimeError(
                f"{path} has tokenizer files, and reading them needs the transformers "
                f"package, which is not installed ({e})") from None
        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)

    def apply_chat_template(self, messages: list[dict],
                            tools: Optional[list] = None) -> list[int]:
        return self._tok.apply_chat_template(
            messages, tools=tools, tokenize=True, add_generation_prompt=True
        )

    @property
    def eos_ids(self) -> set[int]:
        ids = set()
        if self._tok.eos_token_id is not None:
            ids.add(int(self._tok.eos_token_id))
        # llama-3 style end-of-turn
        for tok in ("<|eot_id|>", "<|im_end|>", "<end_of_turn>"):
            tid = self._tok.convert_tokens_to_ids(tok)
            if tid is not None and tid >= 0 and tid != getattr(self._tok, "unk_token_id", None):
                ids.add(int(tid))
        return ids


# ---------------------------------------------------------------------------
# tokenizer.json, read in pure Python
# ---------------------------------------------------------------------------

# llama-3's pre-tokenizer (its tokenizer.json ``Split`` pattern), the
# regex ``_split_llama3`` implements
LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
                r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
# Qwen2's and Qwen3's (``_split_qwen``): llama-3's with one digit a piece
QWEN_SPLIT = LLAMA3_SPLIT.replace(r"\p{N}{1,3}", r"\p{N}")
# the contractions of its first alternative, case-insensitive (U+017F,
# LONG S, folds to "s")
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")
_FOLD = {"ſ": "s"}
# \s of the regex engine ``tokenizers`` uses: the Unicode White_Space set
_SPACE_CONTROLS = frozenset("\t\n\x0b\x0c\r\x85")


def _is_letter(c: str) -> bool:
    return unicodedata.category(c)[0] == "L"


def _is_number(c: str) -> bool:
    return unicodedata.category(c)[0] == "N"


def _is_space(c: str) -> bool:
    return c in _SPACE_CONTROLS or unicodedata.category(c) in ("Zs", "Zl", "Zp")


# symbols with the Alphabetic property (circled and squared Latin letters)
_ALPHABETIC_SYMBOLS = ((0x24B6, 0x24E9), (0x1F130, 0x1F149), (0x1F150, 0x1F169),
                       (0x1F170, 0x1F189))


def _is_word(c: str) -> bool:
    """\\w of the regex engine ``tokenizers`` uses: Alphabetic, marks,
    decimal and letter numbers, connector punctuation, the join controls."""
    cat = unicodedata.category(c)
    if cat[0] in "LM" or cat in ("Nd", "Nl", "Pc") or c in "\u200c\u200d":
        return True
    return cat == "So" and any(a <= ord(c) <= b for a, b in _ALPHABETIC_SYMBOLS)


def _match_llama3(t: str, i: int, digits: int = 3) -> int:
    """The end of ``LLAMA3_SPLIT``'s match at ``i`` (its alternatives in
    order, each with the backtracking a regex engine would do); ``digits``
    1: ``QWEN_SPLIT``'s."""
    n = len(t)
    c = t[i]
    if c == "'":
        for w in _CONTRACTIONS:
            seg = t[i + 1:i + 1 + len(w)]
            if len(seg) == len(w) and "".join(_FOLD.get(x, x) for x in seg.lower()) == w:
                return i + 1 + len(w)
    # [^\r\n\p{L}\p{N}]?\p{L}+
    j = i
    if c not in "\r\n" and not _is_letter(c) and not _is_number(c) and i + 1 < n \
            and _is_letter(t[i + 1]):
        j = i + 1
    if _is_letter(t[j]):
        while j < n and _is_letter(t[j]):
            j += 1
        return j
    # \p{N}{1,3} (Qwen: \p{N})
    if _is_number(c):
        j = i
        while j < n and j - i < digits and _is_number(t[j]):
            j += 1
        return j

    def other(x):
        return not _is_space(x) and not _is_letter(x) and not _is_number(x)

    # " ?[^\s\p{L}\p{N}]+[\r\n]*"
    j = i + 1 if c == " " and i + 1 < n and other(t[i + 1]) else i
    if other(t[j]):
        while j < n and other(t[j]):
            j += 1
        while j < n and t[j] in "\r\n":
            j += 1
        return j
    # the whitespace run at i
    e = i
    while e < n and _is_space(t[e]):
        e += 1
    # \s*[\r\n]+: up to the run's last CR or LF
    last = max(t.rfind("\r", i, e), t.rfind("\n", i, e))
    if last >= 0:
        return last + 1
    # \s+(?!\S), then \s+
    if e == n or e - i < 2:
        return e
    return e - 1


def _split_llama3(text: str, digits: int = 3) -> list[str]:
    pieces, i = [], 0
    while i < len(text):
        j = _match_llama3(text, i, digits)
        pieces.append(text[i:j])
        i = j
    return pieces


def _split_qwen(text: str) -> list[str]:
    return _split_llama3(text, digits=1)


# the Split patterns the reader implements, and their scanners
_SPLITS = {LLAMA3_SPLIT: _split_llama3, QWEN_SPLIT: _split_qwen}


SPLIT_BEHAVIORS = ("Removed", "Isolated", "MergedWithPrevious", "MergedWithNext", "Contiguous")


def _split_string(text: str, delim: str, behavior: str, invert: bool = False) -> list[str]:
    """``tokenizers``' ``Split`` on a literal string: the text cut into
    (piece, is a match) runs (leftmost matches, no overlap; ``invert``
    swaps which runs are matches), then joined by ``behavior``: a match is
    dropped (Removed), kept alone (Isolated), joined to the run before it
    or after it unless that run is a match too (MergedWithPrevious,
    MergedWithNext), or joined with the matches next to it (Contiguous).
    Empty pieces are dropped."""
    runs: list[list] = []
    if delim:
        prev, i = 0, text.find(delim)
        while i >= 0:
            if i != prev:
                runs.append([text[prev:i], invert])
            runs.append([delim, not invert])
            prev = i + len(delim)
            i = text.find(delim, prev)
        if prev != len(text):
            runs.append([text[prev:], invert])
    elif text:
        runs.append([text, invert])
    out: list[list] = []
    if behavior == "Removed":
        out = [r for r in runs if not r[1]]
    elif behavior == "Isolated":
        out = runs
    elif behavior == "Contiguous":
        last = False
        for r in runs:
            if r[1] == last and out:
                out[-1][0] += r[0]
            else:
                out.append(list(r))
            last = r[1]
    elif behavior == "MergedWithPrevious":
        last = False
        for r in runs:
            if r[1] and not last and out:
                out[-1][0] += r[0]
            else:
                out.append(list(r))
            last = r[1]
    elif behavior == "MergedWithNext":
        last = False
        for r in reversed(runs):
            if r[1] and not last and out:
                out[-1][0] = r[0] + out[-1][0]
            else:
                out.append(list(r))
            last = r[1]
        out.reverse()
    else:
        raise NotImplementedError(f"Split behavior {behavior!r}")
    return [r[0] for r in out if r[0]]


def _split_whitespace(text: str) -> list[str]:
    """The ``Whitespace`` pre-tokenizer: ``\\w+|[^\\w\\s]+``."""
    pieces, i, n = [], 0, len(text)
    while i < n:
        if _is_space(text[i]):
            i += 1
            continue
        word = _is_word(text[i])
        j = i
        while j < n and not _is_space(text[j]) and _is_word(text[j]) == word:
            j += 1
        pieces.append(text[i:j])
        i = j
    return pieces


def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2's byte -> printable character table (the ByteLevel one)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


BYTE_ENCODER = _bytes_to_unicode()
BYTE_DECODER = {c: b for b, c in BYTE_ENCODER.items()}


def _token_content(v) -> Optional[str]:
    """A special token of tokenizer_config.json: a string or {"content"}."""
    if isinstance(v, dict):
        return v.get("content")
    return v


def _clean_up_tokenization(text: str) -> str:
    """``transformers``' clean_up_tokenization (spaces before punctuation
    and contractions)."""
    return (text.replace(" .", ".").replace(" ?", "?").replace(" !", "!")
            .replace(" ,", ",").replace(" ' ", "'").replace(" n't", "n't")
            .replace(" 'm", "'m").replace(" 's", "'s").replace(" 've", "'ve")
            .replace(" 're", "'re"))


class JsonTokenizer:
    """A ``tokenizer.json`` directory tokenized as ``transformers``' fast
    tokenizer does it (see the module docstring for what is implemented);
    the same protocol as ``HFTokenizer``."""

    def __init__(self, path: str):
        with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as f:
            doc = json.load(f)
        cfg_path = os.path.join(path, "tokenizer_config.json")
        cfg = {}
        if os.path.exists(cfg_path):
            with open(cfg_path, encoding="utf-8") as f:
                cfg = json.load(f)
        self.path = path
        model = doc.get("model") or {}
        self.kind = model.get("type")
        if self.kind not in ("BPE", "WordLevel"):
            raise NotImplementedError(f"{path}/tokenizer.json: model {self.kind!r} is not "
                                      f"implemented (BPE, WordLevel)")
        self.vocab: dict[str, int] = dict(model["vocab"])
        self.unk_token = model.get("unk_token")
        if self.kind == "BPE":
            for key in ("continuing_subword_prefix", "end_of_word_suffix"):
                if model.get(key):
                    raise NotImplementedError(f"{path}/tokenizer.json: BPE {key} is not "
                                              f"implemented")
            if model.get("dropout"):
                raise NotImplementedError(f"{path}/tokenizer.json: BPE dropout")
            self.byte_fallback = bool(model.get("byte_fallback"))
            self.fuse_unk = bool(model.get("fuse_unk"))
            self.ignore_merges = bool(model.get("ignore_merges"))
            # (left id, right id) -> (rank, merged id)
            self.merges: dict[tuple[int, int], tuple[int, int]] = {}
            for rank, m in enumerate(model.get("merges") or []):
                a, b = m.split(" ", 1) if isinstance(m, str) else m
                self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[a + b])
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        # added tokens: split out of the raw text (normalized ones are not
        # implemented)
        self.added = {}
        for a in doc.get("added_tokens") or []:
            if (a.get("normalized") and not a.get("special")) or a.get("single_word"):
                raise NotImplementedError(f"{path}/tokenizer.json: added token "
                                          f"{a['content']!r} is normalized or single_word")
            self.added[a["content"]] = a
            self.id_to_token[a["id"]] = a["content"]
        self.special_ids = {a["id"] for a in self.added.values() if a.get("special")}
        # an alternation, longest first: the leftmost match is the longest
        self._added_re = (re.compile("|".join(re.escape(t) for t in sorted(
            self.added, key=len, reverse=True))) if self.added else None)
        self.normalizers = self._flatten(doc.get("normalizer"), "normalizers",
                                         ("Prepend", "Replace", "NFC"), "normalizer")
        self.pre_tokenizers = self._flatten(doc.get("pre_tokenizer"), "pretokenizers",
                                            ("Split", "ByteLevel", "Whitespace"), "pre_tokenizer")
        for p in self.pre_tokenizers:
            pattern = p.get("pattern", {})
            if p["type"] == "Split" and not (
                    ("String" in pattern and p.get("behavior") in SPLIT_BEHAVIORS)
                    or (pattern.get("Regex") in _SPLITS and p.get("behavior") == "Isolated"
                        and not p.get("invert"))):
                raise NotImplementedError(f"{path}/tokenizer.json: only a Split on a string "
                                          f"and llama-3's and Qwen's Split regexes are "
                                          f"implemented")
            if p["type"] == "ByteLevel" and (p.get("use_regex", True)
                                             or p.get("add_prefix_space", True)):
                raise NotImplementedError(f"{path}/tokenizer.json: a ByteLevel pre-tokenizer "
                                          f"with use_regex or add_prefix_space")
        self.decoders = self._flatten(doc.get("decoder"), "decoders",
                                      ("ByteLevel", "Replace", "ByteFallback", "Fuse", "Strip"),
                                      "decoder")
        for d in self.normalizers + self.decoders:
            if d["type"] == "Replace" and "String" not in d.get("pattern", {}):
                raise NotImplementedError(f"{path}/tokenizer.json: a Replace by regex")
        # special tokens (tokenizer_config.json), the chat template's context
        self.special_tokens_map = {}
        for key in ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token",
                    "cls_token", "mask_token"):
            v = _token_content(cfg.get(key))
            if v is not None:
                self.special_tokens_map[key] = v
        extra = cfg.get("additional_special_tokens")
        if extra:
            self.special_tokens_map["additional_special_tokens"] = [
                _token_content(v) for v in extra]
        # the ids a sequence gets around it (add_special_tokens=True)
        if str(cfg.get("tokenizer_class", "")).startswith(("LlamaTokenizer", "GemmaTokenizer")):
            # LlamaTokenizerFast and GemmaTokenizerFast rebuild their
            # post-processor from these
            bos = self.special_tokens_map.get("bos_token", "<s>")
            eos = self.special_tokens_map.get("eos_token", "</s>")
            self.prefix_ids = ([self.token_to_id(bos)]
                               if cfg.get("add_bos_token", True) else [])
            self.suffix_ids = ([self.token_to_id(eos)]
                               if cfg.get("add_eos_token", False) else [])
        else:
            self.prefix_ids, self.suffix_ids = self._template(doc.get("post_processor"))
        self.clean_up_spaces = bool(cfg.get("clean_up_tokenization_spaces", False))
        # the template: chat_template.jinja where transformers saved one
        # there, else tokenizer_config.json's (named templates: the default)
        jinja_path = os.path.join(path, "chat_template.jinja")
        if os.path.exists(jinja_path):
            with open(jinja_path, encoding="utf-8") as f:
                self.chat_template = f.read()
        else:
            self.chat_template = cfg.get("chat_template")
        if isinstance(self.chat_template, list):
            self.chat_template = next((t["template"] for t in self.chat_template
                                       if t.get("name") == "default"), None)
        self._template_fn = None

    def _flatten(self, node, key: str, known: tuple, what: str) -> list[dict]:
        if node is None:
            return []
        if node.get("type") == "Sequence":
            return [x for sub in node[key] for x in self._flatten(sub, key, known, what)]
        if node.get("type") not in known:
            raise NotImplementedError(f"{self.path}/tokenizer.json: {what} "
                                      f"{node.get('type')!r} is not implemented")
        return [node]

    def _template(self, node) -> tuple[list[int], list[int]]:
        """(ids before, ids after) a single sequence, from the
        TemplateProcessing post-processor (ByteLevel's changes no id)."""
        if node is None:
            return [], []
        if node["type"] == "Sequence":
            out = ([], [])
            for sub in node["processors"]:
                pre, post = self._template(sub)
                out = (out[0] + pre, post + out[1])
            return out
        if node["type"] == "ByteLevel":
            return [], []
        if node["type"] != "TemplateProcessing":
            raise NotImplementedError(f"{self.path}/tokenizer.json: post_processor "
                                      f"{node['type']!r} is not implemented")
        pre, post, seen = [], [], False
        for piece in node["single"]:
            if "Sequence" in piece:
                seen = True
                continue
            ids = node["special_tokens"][piece["SpecialToken"]["id"]]["ids"]
            (post if seen else pre).extend(ids)
        return pre, post

    def token_to_id(self, token: str) -> Optional[int]:
        a = self.added.get(token)
        return a["id"] if a is not None else self.vocab.get(token)

    # -- encode --------------------------------------------------------

    def _split_added(self, text: str) -> list[tuple[Optional[int], str]]:
        """(added token id or None, text) pieces, the added tokens matched
        leftmost-longest in the raw text, as ``tokenizers`` does."""
        out: list[tuple[Optional[int], str]] = []
        if self._added_re is None:
            return [(None, text)] if text else []
        start, i, n = 0, 0, len(text)
        while (m := self._added_re.search(text, i)) is not None:
            a = self.added[m.group()]
            s, e = m.start(), m.end()
            if a.get("lstrip"):
                while s > start and _is_space(text[s - 1]):
                    s -= 1
            if a.get("rstrip"):
                while e < n and _is_space(text[e]):
                    e += 1
            if start < s:
                out.append((None, text[start:s]))
            out.append((a["id"], text[s:e]))
            start = i = e
        if start < n:
            out.append((None, text[start:]))
        return out

    def _normalize(self, text: str) -> str:
        for nm in self.normalizers:
            if nm["type"] == "Prepend":
                text = nm["prepend"] + text if text else text
            elif nm["type"] == "NFC":
                text = unicodedata.normalize("NFC", text)
            else:
                text = text.replace(nm["pattern"]["String"], nm["content"])
        return text

    def _pre_tokenize(self, text: str) -> list[str]:
        pieces = [text]
        for p in self.pre_tokenizers:
            if p["type"] == "Split" and "String" in p["pattern"]:
                pieces = [x for piece in pieces for x in _split_string(
                    piece, p["pattern"]["String"], p["behavior"], bool(p.get("invert")))]
            elif p["type"] == "Split":
                scan = _SPLITS[p["pattern"]["Regex"]]
                pieces = [x for piece in pieces for x in scan(piece)]
            elif p["type"] == "Whitespace":
                pieces = [x for piece in pieces for x in _split_whitespace(piece)]
            else:       # ByteLevel, on the pieces as they are
                pieces = ["".join(BYTE_ENCODER[b] for b in piece.encode("utf-8"))
                          for piece in pieces]
        return [p for p in pieces if p]

    def _bpe(self, word: str) -> list[int]:
        """One pre-token through the BPE model: the whole word when
        ``ignore_merges`` finds it in the vocabulary, else its characters
        (or ``<0xNN>`` bytes, or the unknown token) merged lowest rank
        first, leftmost among equals (``tokenizers``' merge_all)."""
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        syms: list[int] = []
        unk: Optional[int] = None
        unk_id = self.vocab.get(self.unk_token) if self.unk_token is not None else None
        for ch in word:
            tid = self.vocab.get(ch)
            if tid is not None:
                if unk is not None:
                    syms.append(unk)
                    unk = None
                syms.append(tid)
                continue
            if self.byte_fallback:
                ids = [self.vocab.get(f"<0x{b:02X}>") for b in ch.encode("utf-8")]
                if all(i is not None for i in ids):
                    syms += ids
                    continue
            if unk_id is not None:
                if unk is not None and not self.fuse_unk:
                    syms.append(unk)
                unk = unk_id
        if unk is not None:
            syms.append(unk)
        n = len(syms)
        nxt = list(range(1, n + 1))
        prv = list(range(-1, n - 1))
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            m = self.merges.get((syms[i], syms[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            _rank, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] >= n:
                continue
            right = nxt[pos]
            m = self.merges.get((syms[pos], syms[right]))
            if m is None or m[1] != new_id:
                continue            # a stale entry
            syms[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[right] < n:
                prv[nxt[right]] = pos
            if prv[pos] >= 0:
                m = self.merges.get((syms[prv[pos]], new_id))
                if m is not None:
                    heapq.heappush(heap, (m[0], prv[pos], m[1]))
            if nxt[pos] < n:
                m = self.merges.get((new_id, syms[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [t for t, keep in zip(syms, alive) if keep]

    def _model(self, word: str) -> list[int]:
        if self.kind == "BPE":
            return self._bpe(word)
        tid = self.vocab.get(word, self.vocab.get(self.unk_token))
        if tid is None:
            raise ValueError(f"{word!r} is not in the vocabulary and there is no unk_token")
        return [tid]

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        ids: list[int] = []
        for tid, piece in self._split_added(text):
            if tid is not None:
                ids.append(tid)
                continue
            for word in self._pre_tokenize(self._normalize(piece)):
                ids += self._model(word)
        if add_special_tokens:
            ids = self.prefix_ids + ids + self.suffix_ids
        return ids

    # -- decode --------------------------------------------------------

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        toks = [self.id_to_token[i] for i in ids if i in self.id_to_token
                and not (skip_special_tokens and i in self.special_ids)]
        if not self.decoders:
            text = " ".join(toks)
        else:
            for d in self.decoders:
                toks = self._decode_step(d, toks)
            text = "".join(toks)
        return _clean_up_tokenization(text) if self.clean_up_spaces else text

    @staticmethod
    def _decode_step(d: dict, toks: list[str]) -> list[str]:
        kind = d["type"]
        if kind == "ByteLevel":
            raw = bytearray()
            for t in toks:
                if all(c in BYTE_DECODER for c in t):
                    raw += bytes(BYTE_DECODER[c] for c in t)
                else:
                    raw += t.encode("utf-8")
            return [raw.decode("utf-8", errors="replace")]
        if kind == "Replace":
            return [t.replace(d["pattern"]["String"], d["content"]) for t in toks]
        if kind == "Fuse":
            return ["".join(toks)]
        if kind == "Strip":
            out = []
            for t in toks:
                a, b = 0, len(t)
                for k in range(min(d["start"], len(t))):
                    if t[k] != d["content"]:
                        break
                    a = k + 1
                for k in range(min(d["stop"], len(t))):
                    if t[len(t) - 1 - k] != d["content"]:
                        break
                    b = len(t) - 1 - k
                out.append(t[a:max(a, b)])
            return out
        # ByteFallback: runs of <0xNN> tokens become their UTF-8 text, or one
        # replacement character a byte when they are not valid UTF-8
        out, run = [], bytearray()

        def flush():
            if run:
                try:
                    out.append(bytes(run).decode("utf-8"))
                except UnicodeDecodeError:
                    out.extend("�" for _ in run)
                run.clear()

        for t in toks:
            byte = None
            if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
                try:
                    byte = int(t[3:5], 16)
                except ValueError:
                    byte = None
            if byte is not None:
                run.append(byte)
            else:
                flush()
                out.append(t)
        flush()
        return out

    # -- chat ----------------------------------------------------------

    def render_chat(self, messages: list[dict], tools: Optional[list] = None) -> str:
        """The chat template rendered as ``transformers`` renders it: a
        sandboxed jinja2 environment with trim_blocks and lstrip_blocks,
        ``raise_exception``, its ``tojson``, the special tokens in the
        context and the generation prompt added."""
        if not self.chat_template:
            raise ValueError(f"{self.path}: tokenizer_config.json has no chat_template")
        if self._template_fn is None:
            import jinja2
            import jinja2.ext
            from jinja2.sandbox import ImmutableSandboxedEnvironment

            def raise_exception(message):
                raise jinja2.exceptions.TemplateError(message)

            def tojson(x, ensure_ascii=False, indent=None, separators=None, sort_keys=False):
                return json.dumps(x, ensure_ascii=ensure_ascii, indent=indent,
                                  separators=separators, sort_keys=sort_keys)

            def strftime_now(fmt):
                import datetime
                return datetime.datetime.now().strftime(fmt)

            env = ImmutableSandboxedEnvironment(trim_blocks=True, lstrip_blocks=True,
                                                extensions=[jinja2.ext.loopcontrols])
            env.filters["tojson"] = tojson
            env.globals["raise_exception"] = raise_exception
            env.globals["strftime_now"] = strftime_now
            self._template_fn = env.from_string(self.chat_template)
        return self._template_fn.render(messages=messages, tools=tools, documents=None,
                                        add_generation_prompt=True,
                                        **self.special_tokens_map)

    def apply_chat_template(self, messages: list[dict],
                            tools: Optional[list] = None) -> list[int]:
        """The rendered template's ids without special tokens added, as
        ``apply_chat_template(tokenize=True)`` encodes it."""
        return self.encode(self.render_chat(messages, tools), add_special_tokens=False)

    @property
    def eos_ids(self) -> set[int]:
        """``HFTokenizer.eos_ids``' rule: the eos token, and llama-3's,
        chatml's and gemma's end-of-turn tokens where the vocabulary has
        them."""
        ids = set()
        eos = self.special_tokens_map.get("eos_token")
        for tok in ((eos,) if eos is not None else ()) + ("<|eot_id|>", "<|im_end|>",
                                                          "<end_of_turn>"):
            tid = self.token_to_id(tok)
            if tid is not None:
                ids.add(int(tid))
        return ids


class GGUFTokenizer:
    """SentencePiece-style tokenizer from GGUF-embedded vocab metadata.

    llama.cpp ships the tokenizer inside the model file
    (``tokenizer.ggml.tokens`` / ``scores`` / ``token_type``); serving a
    bare .gguf (the local solution's modelPath contract, reference
    ramalama values.yaml) must therefore tokenize from the file itself:
    no tokenizer.json exists on disk. Implements the SPM scheme
    (``tokenizer.ggml.model == "llama"``): ▁-for-space normalization,
    highest-score greedy bigram merging, <0xNN> byte fallback.
    """

    def __init__(self, metadata: dict):
        if metadata.get("tokenizer.ggml.model", "llama") != "llama":
            raise ValueError(
                "only SentencePiece ('llama') GGUF tokenizers are supported; "
                f"got {metadata.get('tokenizer.ggml.model')!r}"
            )
        self.tokens: list[str] = metadata["tokenizer.ggml.tokens"]
        self.scores: list[float] = metadata.get(
            "tokenizer.ggml.scores", [0.0] * len(self.tokens))
        types = metadata.get("tokenizer.ggml.token_type", [1] * len(self.tokens))
        self._rank = {t: i for i, t in enumerate(self.tokens)}
        self._byte_ids = {}
        self._control = set()
        for i, (tok, tt) in enumerate(zip(self.tokens, types)):
            if tt == 6 or (tok.startswith("<0x") and tok.endswith(">")):
                try:
                    self._byte_ids[int(tok[3:-1], 16)] = i
                except ValueError:
                    pass
            if tt == 3:  # control
                self._control.add(i)
        self.bos_id = int(metadata.get("tokenizer.ggml.bos_token_id", 1))
        self.eos_id = int(metadata.get("tokenizer.ggml.eos_token_id", 2))
        self.add_bos = bool(metadata.get("tokenizer.ggml.add_bos_token", True))
        self._prefix = " " if metadata.get(
            "tokenizer.ggml.add_space_prefix", True) else ""
        self._byte_id_set = set(self._byte_ids.values())
        # GGUF files carry the model's own chat template
        # (``tokenizer.chat_template``, same Jinja dialect as HF
        # tokenizer_config.json); llama.cpp's server renders it. Without
        # it a Phi-3 GGUF (the reference's documented local model,
        # reference ramalama-models/README.md:102-107) would get the wrong
        # [INST]-style format.
        self.chat_template: Optional[str] = metadata.get(
            "tokenizer.chat_template") or None

    def _encode_piece(self, text: str) -> list[int]:
        """SPM merge via a bigram heap (linear-log in text length): a
        doubly-linked list of pieces; candidate merges pop best-score
        first, are revalidated against the live list, and push the two new
        neighbour bigrams. Identical output to the naive rescan-everything
        greedy loop (ties broken by position, as SPM does)."""
        import heapq

        n = len(text)
        pieces: list[Optional[str]] = list(text)
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        heap: list[tuple[float, int, int, str]] = []

        def push(i: int) -> None:
            j = nxt[i]
            if j >= n or pieces[i] is None or pieces[j] is None:
                return
            merged = pieces[i] + pieces[j]
            rank = self._rank.get(merged)
            if rank is not None:
                heapq.heappush(heap, (-self.scores[rank], i, j, merged))

        for i in range(n - 1):
            push(i)
        while heap:
            _, i, j, merged = heapq.heappop(heap)
            # stale if either side changed since this candidate was pushed
            if pieces[i] is None or pieces[j] is None or nxt[i] != j:
                continue
            if pieces[i] + pieces[j] != merged:
                continue
            pieces[i] = merged
            pieces[j] = None
            nxt[i] = nxt[j]
            if nxt[j] < n:
                prev[nxt[j]] = i
            if prev[i] >= 0:
                push(prev[i])
            push(i)

        out: list[int] = []
        for p in pieces:
            if p is None:
                continue
            rank = self._rank.get(p)
            if rank is not None:
                out.append(rank)
            else:  # byte fallback
                for b in p.encode("utf-8"):
                    if b in self._byte_ids:
                        out.append(self._byte_ids[b])
        return out

    def encode(self, text: str) -> list[int]:
        norm = (self._prefix + text).replace(" ", "▁")
        ids = self._encode_piece(norm)
        return ([self.bos_id] + ids) if self.add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        out = bytearray()
        for i in ids:
            if i in self._control or not (0 <= i < len(self.tokens)):
                continue
            if i in self._byte_id_set:
                tok = self.tokens[i]
                out.append(int(tok[3:-1], 16))
            else:
                out += self.tokens[i].replace("▁", " ").encode("utf-8")
        return out.decode("utf-8", errors="replace")

    def _encode_with_specials(self, text: str) -> list[int]:
        """Tokenize text that may contain control-token literals (chat
        template output like ``<|end|>``): split on the vocab's control
        strings so each maps to its single id — the SPM merge loop cannot
        assemble them (control pieces carry no merge scores)."""
        import re

        special_by_text = {self.tokens[i]: i for i in self._control
                           if self.tokens[i]}
        if not special_by_text:
            return self._encode_piece(text.replace(" ", "▁"))
        pattern = "(" + "|".join(
            re.escape(s) for s in sorted(special_by_text, key=len,
                                         reverse=True)) + ")"
        ids: list[int] = []
        for part in re.split(pattern, text):
            if not part:
                continue
            if part in special_by_text:
                ids.append(special_by_text[part])
            else:
                ids += self._encode_piece(part.replace(" ", "▁"))
        return ids

    def apply_chat_template(self, messages: list[dict],
                            tools: Optional[list] = None) -> list[int]:
        if self.chat_template:
            try:
                return self._render_chat_template(messages, tools=tools)
            except Exception:
                # malformed template / missing jinja2: fall back to the
                # generic format — but say WHY, once, or every chat
                # request silently degrades with no trace of the cause
                if not getattr(self, "_template_warned", False):
                    self._template_warned = True
                    import logging
                    logging.getLogger(__name__).warning(
                        "chat template rendering failed; falling back to "
                        "the generic [INST] format", exc_info=True)
        # generic [INST]-style template (llama.cpp's default for SPM models)
        text = ""
        for m in messages:
            role, content = m.get("role", "user"), m.get("content", "")
            if role == "system":
                text += f"<<SYS>>\n{content}\n<</SYS>>\n\n"
            elif role == "user":
                text += f"[INST] {content} [/INST]"
            else:
                text += f" {content} "
        return self.encode(text)

    def _render_chat_template(self, messages: list[dict],
                              tools: Optional[list] = None) -> list[int]:
        """Render ``tokenizer.chat_template`` the way HF/llama.cpp do:
        sandboxed Jinja fed messages + bos/eos token strings +
        add_generation_prompt=True, then tokenize with control-token
        splitting. BOS is prepended per add_bos unless the template already
        emitted it."""
        from jinja2.sandbox import ImmutableSandboxedEnvironment

        def raise_exception(msg):
            raise ValueError(msg)

        env = ImmutableSandboxedEnvironment(
            trim_blocks=True, lstrip_blocks=True)
        bos = self.tokens[self.bos_id] if 0 <= self.bos_id < len(self.tokens) else ""
        eos = self.tokens[self.eos_id] if 0 <= self.eos_id < len(self.tokens) else ""
        text = env.from_string(self.chat_template).render(
            messages=messages, add_generation_prompt=True, tools=tools,
            bos_token=bos, eos_token=eos, raise_exception=raise_exception,
        )
        ids = self._encode_with_specials(text)
        if self.add_bos and (not ids or ids[0] != self.bos_id):
            ids = [self.bos_id] + ids
        return ids

    @property
    def eos_ids(self) -> set[int]:
        return {self.eos_id}


TOKENIZER_FILES = ("tokenizer.json", "tokenizer.model", "tokenizer_config.json")


def load_tokenizer(model_ref: Optional[str] = None):
    """The tokenizer for ``model_ref``: ``JsonTokenizer`` for a directory
    with ``tokenizer.json``; ``HFTokenizer`` for one with other tokenizer
    files only (``tokenizer.model``: it needs ``transformers`` and raises
    without it); ``GGUFTokenizer`` for a ``.gguf`` file whose metadata
    carries a vocabulary; else the byte tokenizer (a registry name, or a
    checkpoint directory with weights only)."""
    if model_ref and os.path.isdir(model_ref):
        if os.path.exists(os.path.join(model_ref, "tokenizer.json")):
            return JsonTokenizer(model_ref)
        if any(os.path.exists(os.path.join(model_ref, f)) for f in TOKENIZER_FILES):
            return HFTokenizer(model_ref)
    if model_ref and model_ref.endswith(".gguf") and os.path.isfile(model_ref):
        from llms_on_kubernetes_tpu_torch.engine.gguf import GGUFFile

        gf = GGUFFile(model_ref)
        try:
            if "tokenizer.ggml.tokens" in gf.metadata:
                return GGUFTokenizer(gf.metadata)
        finally:
            gf.close()
    return ByteTokenizer()
