"""The port's ``tokenizer.json`` reader (``engine/tokenizer.JsonTokenizer``)
against ``tokenizers`` and the JAX ``HFTokenizer`` (``transformers``), on
the CPU.

- llama-3's pre-tokenizer (``_split_llama3``, a scanner over unicodedata
  categories) gives the pieces ``tokenizers``' ``Split`` gives, for every
  assigned character in a few contexts and under hypothesis over every
  assigned Unicode category, CR/LF runs, runs of spaces, contractions and
  special-token text; so does the ``Whitespace`` pre-tokenizer.
- Over the files ``testing/synth_checkpoint.write_tokenizer`` writes
  (llama-3 byte-level BPE, phi-3 SentencePiece BPE with byte fallback),
  and over files ``tokenizers`` trains here in both styles (phi-3's with
  ``add_bos_token``): encoded ids, decoded text (any ids, special tokens
  skipped), templated chat ids and ``eos_ids`` equal the JAX
  ``HFTokenizer``'s, exactly, under hypothesis.
- ``TOKENIZER_PROBES`` equals what ``transformers`` and the reader give.
- Qwen3's layout (the ``"qwen3"`` files: NFC, Qwen's one-digit ``Split``,
  no BOS, ``ignore_merges`` false, non-special added tokens beside the
  special ones, ChatML): Qwen's scanner gives ``tokenizers``' pieces, and
  ids, decoded text and chat ids equal ``transformers``' for digits, mixed
  scripts, input NFC changes, newlines and every added token; a checkpoint
  directory carrying the files serves its chat on the CPU.
- Gemma-3's layout, as recalled (no published gemma-3 file is in the
  repository): the phi-3 files with the ``Replace(" " -> "▁")``
  normalizer alone, a ``Split`` on the string " " with
  ``MergedWithPrevious``, byte fallback and ``tokenizer_class``
  ``GemmaTokenizer``: ids, decoded text and chat ids equal
  ``transformers``'; ``_split_string`` gives ``tokenizers``' pieces for
  every ``behavior`` and ``invert``.
- ``load_tokenizer`` gives the reader for a ``tokenizer.json`` directory;
  the reader and the writer import neither ``transformers`` nor
  ``tokenizers``.
"""

import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from llms_on_kubernetes_tpu.engine.tokenizer import HFTokenizer as JHFTokenizer
from llms_on_kubernetes_tpu_torch.engine.tokenizer import (
    LLAMA3_SPLIT, QWEN_SPLIT, SPLIT_BEHAVIORS, JsonTokenizer, _split_llama3, _split_qwen,
    _split_string, _split_whitespace, load_tokenizer,
)
from llms_on_kubernetes_tpu_torch.testing import synth_checkpoint as synth

REPO = Path(__file__).resolve().parent.parent
FAMILIES = ("llama3", "phi3")
WRITTEN = FAMILIES + ("qwen3",)       # the writer's families held to transformers here
# every assigned character (Python's Unicode tables; unassigned code points
# may be assigned in the regex engine's newer tables)
CHARS = st.characters(exclude_categories=("Cs", "Cn"))
FRAGMENTS = st.sampled_from([
    "\r\n", "\n", "\r", " ", "  ", "   ", "\t", "　", " ", " ", "'s", "'S",
    "'re", "'LL", "'d", "'ve", "'m", "'t", "ſ", "1234567", "٣٤", "Ⅻ", "½", "x", "Hello",
    "<|eot_id|>", "<|end|>", "<|user|>", "<|begin_of_text|>", "<s>", "é", "東京", "🚀",
    "<|lstrip|>", "<|rstrip|>", " <|lstrip|>", "<|rstrip|>\n ",
    "́", "_", "--", "!?", "<|im_start|>", "<|im_end|>", "<|endoftext|>", "<think>",
    "</tool_call>", "e\u0301", "\u212b", "ﬁ", "9876543210"])
TEXT = st.lists(st.one_of(CHARS, FRAGMENTS), max_size=40).map("".join)


def _quiet(fn, *args):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args)


# ---------------------------------------------------------------------------
# the pre-tokenizer against tokenizers' Split
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def split():
    from tokenizers import Regex, pre_tokenizers

    return pre_tokenizers.Split(Regex(LLAMA3_SPLIT), behavior="isolated")


@settings(max_examples=1500, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(text=TEXT)
def test_llama3_split_equals_tokenizers(split, text):
    assert _split_llama3(text) == [p for p, _ in split.pre_tokenize_str(text)]


def _every_character():
    import unicodedata

    for cp in range(0x110000):
        c = chr(cp)
        if not 0xD800 <= cp <= 0xDFFF and unicodedata.category(c) != "Cn":
            yield c


def test_llama3_split_equals_tokenizers_for_every_character(split):
    """Every assigned character, between letters, after a space and a
    digit, doubled before CR LF: the scanner's Unicode classes are the
    regex engine's."""
    bad = []
    for c in _every_character():
        for t in ("a" + c + "b", " " + c + "1", " " + c + c + "\r\n "):
            if _split_llama3(t) != [p for p, _ in split.pre_tokenize_str(t)]:
                bad.append(hex(ord(c)))
                break
    assert not bad, bad[:20]


def test_whitespace_split_equals_tokenizers_for_every_character():
    from tokenizers import pre_tokenizers

    ws = pre_tokenizers.Whitespace()
    bad = [hex(ord(c)) for c in _every_character()
           if _split_whitespace("a" + c + "b " + c) != [
               p for p, _ in ws.pre_tokenize_str("a" + c + "b " + c)]]
    assert not bad, bad[:20]


@pytest.fixture(scope="module")
def qwen_split():
    from tokenizers import Regex, pre_tokenizers

    return pre_tokenizers.Split(Regex(QWEN_SPLIT), behavior="isolated")


@settings(max_examples=1000, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(text=TEXT)
def test_qwen_split_equals_tokenizers(qwen_split, text):
    assert _split_qwen(text) == [p for p, _ in qwen_split.pre_tokenize_str(text)]


def test_qwen_split_equals_tokenizers_for_every_character(qwen_split):
    """Every assigned character between digits and letters: one digit a
    piece, the rest as llama-3's scanner."""
    bad = []
    for c in _every_character():
        for t in ("1" + c + "23", " " + c + "a4"):
            if _split_qwen(t) != [p for p, _ in qwen_split.pre_tokenize_str(t)]:
                bad.append(hex(ord(c)))
                break
    assert not bad, bad[:20]


@pytest.mark.parametrize("text", [
    "it's", "IT'S 'LL 'll", "ſ'ſ", "'ſ", "a\r\n\r\nb", "  \n  x", "x  ", "   ", "a \n", "1234567",
    "$100.00", " !!!\n\n", "\t\tindented", "end.\n", "　　x", "a b"])
def test_llama3_split_edge_cases(split, text):
    assert _split_llama3(text) == [p for p, _ in split.pre_tokenize_str(text)]


SPLIT_TEXT = st.lists(st.sampled_from(["a", "b", " ", "  ", "▁", "ab", "é", "\n", "x y"]),
                      max_size=12).map("".join)


@pytest.mark.parametrize("behavior", SPLIT_BEHAVIORS)
@pytest.mark.parametrize("invert", [False, True])
@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(text=SPLIT_TEXT, delim=st.sampled_from([" ", "  ", "ab", "▁", "b", "x y"]))
def test_string_split_equals_tokenizers(behavior, invert, text, delim):
    """A ``Split`` on a literal string, every behaviour, inverted or not."""
    from tokenizers import pre_tokenizers

    ref = pre_tokenizers.Split(delim, behavior=behavior.lower().replace(
        "mergedwith", "merged_with_"), invert=invert)
    assert _split_string(text, delim, behavior, invert) == [
        p for p, _ in ref.pre_tokenize_str(text)]


# ---------------------------------------------------------------------------
# the writer's files
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """family -> (directory, the port's reader, the JAX HFTokenizer)."""
    out = {}
    for fam in WRITTEN:
        path = tmp_path_factory.mktemp(f"tok-{fam}")
        synth.write_tokenizer(str(path), fam)
        out[fam] = (path, JsonTokenizer(str(path)), _quiet(JHFTokenizer, str(path)))
    return out


@pytest.mark.parametrize("fam", WRITTEN)
def test_probes_table_equals_transformers_and_the_reader(written, fam):
    _path, reader, hf = written[fam]
    want = synth.TOKENIZER_PROBES[fam]
    assert [hf.encode(t) for t in synth.PROBE_TEXTS] == want["texts"]
    assert [reader.encode(t) for t in synth.PROBE_TEXTS] == want["texts"]
    chat = [dict(m) for m in synth.PROBE_CHAT]
    assert hf.apply_chat_template(chat) == want["chat"]
    assert reader.apply_chat_template(chat) == want["chat"]


@pytest.mark.parametrize("fam", WRITTEN)
def test_written_files_have_the_published_layout(written, fam):
    path, reader, _hf = written[fam]
    tok = json.loads((path / "tokenizer.json").read_text())
    special = synth.special_tokens(fam)
    assert {a["id"]: a["content"] for a in tok["added_tokens"]} == special
    # the models' vocabularies (Qwen3-30B-A3B's and Qwen3-8B's 151,936)
    assert max(special) < {"llama3": 128256, "phi3": 32064, "qwen3": 151936}[fam]
    merges = tok["model"]["merges"]
    assert 2000 <= len(merges) <= synth.TOKENIZER_MERGES
    if fam == "llama3":
        assert tok["pre_tokenizer"]["pretokenizers"][0]["pattern"]["Regex"] == LLAMA3_SPLIT
        assert tok["model"]["ignore_merges"] and reader.prefix_ids == [128000]
        assert reader.eos_ids == {128009}
    elif fam == "qwen3":
        assert tok["normalizer"] == {"type": "NFC"}
        assert tok["pre_tokenizer"]["pretokenizers"][0]["pattern"]["Regex"] == QWEN_SPLIT
        assert tok["post_processor"]["type"] == "ByteLevel"
        assert not tok["model"]["ignore_merges"] and reader.prefix_ids == []
        assert reader.eos_ids == {151645}
        assert {a["id"] for a in tok["added_tokens"] if a["special"]} == set(synth.QWEN3_SPECIAL)
        assert {a["content"]: a["id"] for a in tok["added_tokens"]}["<|im_start|>"] == 151644
        assert reader.special_ids == set(synth.QWEN3_SPECIAL)
    else:
        assert tok["model"]["byte_fallback"] and tok["model"]["vocab"]["<0x0A>"] == 13
        assert reader.prefix_ids == [] and reader.eos_ids == {32007}


@pytest.mark.parametrize("fam", WRITTEN)
@settings(max_examples=300, deadline=None,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.function_scoped_fixture])
@given(text=TEXT)
def test_written_files_encode_as_transformers(written, fam, text):
    _path, reader, hf = written[fam]
    ids = hf.encode(text)
    assert reader.encode(text) == ids
    assert reader.decode(ids) == hf.decode(ids)


@pytest.mark.parametrize("fam", WRITTEN)
@settings(max_examples=300, deadline=None,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.function_scoped_fixture])
@given(data=st.data())
def test_written_files_decode_any_ids_as_transformers(written, fam, data):
    """Any ids, special, byte and out-of-vocabulary ones among them."""
    _path, reader, hf = written[fam]
    top = max(reader.id_to_token) + 4
    ids = data.draw(st.lists(st.one_of(st.integers(0, 300), st.integers(0, top),
                                       st.sampled_from(sorted(reader.special_ids))),
                             max_size=24))
    assert reader.decode(ids) == hf.decode(ids)


@pytest.mark.parametrize("fam", WRITTEN)
@settings(max_examples=80, deadline=None,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.function_scoped_fixture])
@given(msgs=st.lists(st.tuples(st.sampled_from(["system", "user", "assistant"]), TEXT),
                     min_size=1, max_size=4))
def test_written_files_chat_as_transformers(written, fam, msgs):
    _path, reader, hf = written[fam]
    messages = [{"role": r, "content": c} for r, c in msgs]
    assert reader.apply_chat_template(messages) == hf.apply_chat_template(messages)
    assert reader.eos_ids == hf.eos_ids


QWEN3_CASES = [
    "1234567890 apples, 3.14159 and 2026-10-18", "Ж東京 mixed: عربى, हिन्दी, 한국어 and ελληνικά",
    "e\u0301 cafe\u0301 A\u030a \u212b \u1e9b\u0323 vs é Å", "line one\n\nline two\r\n\tthree \n",
    "  leading and trailing  ", "ﬁ ① ½ Ⅻ 𝔸 🚀🚀", "don't WE'LL ſ'S",
    *(f"before {t} after{t}{t}" for t in synth.QWEN3_ADDED.values()),
]


@pytest.mark.parametrize("text", QWEN3_CASES)
def test_qwen3_files_as_transformers(written, text):
    """Digits (one a piece), mixed scripts, input NFC composes, newlines and
    every added token (special or not) of the Qwen3 layout: ids, decoded
    text with and without special tokens, and the text in a chat."""
    _path, reader, hf = written["qwen3"]
    ids = hf.encode(text)
    assert reader.encode(text) == ids
    assert reader.decode(ids) == hf.decode(ids)
    assert reader.decode(ids, skip_special_tokens=False) == \
        hf._tok.decode(ids, skip_special_tokens=False)
    chat = [{"role": "system", "content": text}, {"role": "user", "content": text}]
    assert reader.apply_chat_template(chat) == hf.apply_chat_template(chat)


def test_qwen3vl_files_are_qwen3s_with_its_image_markers(written, tmp_path):
    """The multimodal Qwen3-VL family: Qwen3's files, and a chat with an
    image part renders the vision markers at their published ids."""
    synth.write_tokenizer(str(tmp_path), "qwen3vl")
    a = json.loads((tmp_path / "tokenizer.json").read_text())
    b = json.loads((written["qwen3"][0] / "tokenizer.json").read_text())
    assert a == b
    reader, hf = JsonTokenizer(str(tmp_path)), _quiet(JHFTokenizer, str(tmp_path))
    chat = [{"role": "user", "content": [{"type": "image"}, {"type": "text", "text": "hi 12"}]}]
    ids = reader.apply_chat_template(chat)
    assert ids == hf.apply_chat_template(chat)
    user, assistant = reader.encode("user"), reader.encode("assistant")
    assert ids[:len(user) + 5] == [151644, *user, 10, 151652, 151655, 151653]
    assert ids[-len(assistant) - 2:] == [151644, *assistant, 10]


def gemma3_as_recalled(out_dir, add_bos: bool = True) -> None:
    """Gemma-3's tokenizer.json layout as recalled (no published file is in
    the repository): the phi-3 files with the ``Replace(" " -> "▁")``
    normalizer alone, the pre-tokenizer ``Split({"String": " "},
    "MergedWithPrevious")``, the decoder without its ``Strip`` and
    ``tokenizer_class`` ``GemmaTokenizer``."""
    tok, cfg = synth.tokenizer_files("phi3")
    tok["normalizer"] = {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}
    tok["pre_tokenizer"] = {"type": "Split", "pattern": {"String": " "},
                            "behavior": "MergedWithPrevious", "invert": False}
    tok["decoder"]["decoders"] = tok["decoder"]["decoders"][:3]
    cfg.update(tokenizer_class="GemmaTokenizer", add_bos_token=add_bos)
    (out_dir / "tokenizer.json").write_text(json.dumps(tok, ensure_ascii=False))
    (out_dir / "tokenizer_config.json").write_text(json.dumps(cfg, ensure_ascii=False))


@pytest.fixture(scope="module", params=[True, False], ids=["bos", "no_bos"])
def gemma3(request, tmp_path_factory):
    path = tmp_path_factory.mktemp("tok-gemma3")
    gemma3_as_recalled(path, add_bos=request.param)
    return JsonTokenizer(str(path)), _quiet(JHFTokenizer, str(path))


GEMMA3_CASES = ["Hello world  x", "  leading and trailing  ", "line one\n\nline two\r\n\tx",
                "東京 🚀 é ſ ½", "<|user|>hi<|end|>", "", " ", "a▁b ▁ c"]


@pytest.mark.parametrize("text", GEMMA3_CASES)
def test_gemma3_layout_as_recalled_as_transformers(gemma3, text):
    """The layout loads, and its ids, decoded text and chat ids equal
    ``transformers``'."""
    reader, hf = gemma3
    ids = hf.encode(text)
    assert reader.encode(text) == ids
    assert reader.decode(ids) == hf.decode(ids)
    chat = [{"role": "system", "content": text}, {"role": "user", "content": text}]
    assert reader.apply_chat_template(chat) == hf.apply_chat_template(chat)
    assert reader.eos_ids == hf.eos_ids


@settings(max_examples=200, deadline=None,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.function_scoped_fixture])
@given(text=TEXT)
def test_gemma3_layout_as_recalled_encodes_any_text_as_transformers(gemma3, text):
    reader, hf = gemma3
    ids = hf.encode(text)
    assert reader.encode(text) == ids
    assert reader.decode(ids) == hf.decode(ids)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_a_qwen3_checkpoint_dir_serves_its_chat_on_the_cpu(tmp_path):
    """``serve --model <dir> --device cpu`` of a checkpoint carrying the
    Qwen3 files (a debug MoE at Qwen3's vocabulary): /tokenize of the probe
    strings and chat gives ``TOKENIZER_PROBES["qwen3"]``, a chat's
    prompt_tokens is the templated count, and +100 on ``<|im_end|>`` stops
    the chat at once with no text."""
    import dataclasses
    import time
    import urllib.request

    from llms_on_kubernetes_tpu_torch.configs import get_config

    cfg = dataclasses.replace(get_config("debug-moe"), name="debug-moe-qwen3-vocab",
                              vocab_size=151936)
    ckpt = tmp_path / "ckpt"
    synth.write_checkpoint(cfg, str(ckpt), dtype="float32", tokenizer="qwen3")
    assert isinstance(load_tokenizer(str(ckpt)), JsonTokenizer)
    want = synth.TOKENIZER_PROBES["qwen3"]
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    log = open(tmp_path / "server.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "llms_on_kubernetes_tpu_torch", "serve", "--model", str(ckpt),
         "--device", "cpu", "--host", "127.0.0.1", "--port", str(port), "--dtype", "float32",
         "--max-decode-slots", "2", "--num-pages", "64", "--page-size", "8",
         "--pages-per-slot", "16", "--prefill-buckets", "64"],
        cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)

    def post(path, body):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                     data=json.dumps(body).encode(), method="POST",
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    try:
        deadline = time.monotonic() + 240
        while True:
            assert proc.poll() is None, (tmp_path / "server.log").read_text()
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=5) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            assert time.monotonic() < deadline, "no /health in 240 s"
            time.sleep(0.5)
        for text, ids in zip(synth.PROBE_TEXTS, want["texts"]):
            assert post("/tokenize", {"prompt": text})["tokens"] == ids
        chat = [dict(m) for m in synth.PROBE_CHAT]
        assert post("/tokenize", {"messages": chat})["tokens"] == want["chat"]
        d = post("/v1/chat/completions", {"messages": chat, "max_tokens": 4, "temperature": 0,
                                          "logit_bias": {"151645": 100}})
        assert d["usage"]["prompt_tokens"] == len(want["chat"])
        assert d["choices"][0]["finish_reason"] == "stop"
        assert d["choices"][0]["message"]["content"] == ""
        assert d["usage"]["completion_tokens"] == 1
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        log.close()


# ---------------------------------------------------------------------------
# files tokenizers trains here
# ---------------------------------------------------------------------------

def _corpus() -> list[str]:
    return (REPO / "README.md").read_text().splitlines()[:400]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """family -> (directory, reader, the JAX HFTokenizer) over files
    ``tokenizers`` trains: llama-3 style (byte-level BPE, the Split
    pre-tokenizer, ignore_merges, a BOS template) and phi-3 style
    (SentencePiece BPE with byte fallback, no pre-tokenizer, a
    LlamaTokenizer class with add_bos_token, rstrip chat tokens)."""
    from tokenizers import (
        AddedToken, Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers,
        processors, trainers,
    )
    from transformers import PreTrainedTokenizerFast

    out = {}
    # llama-3 style
    tok = Tokenizer(models.BPE(ignore_merges=True))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA3_SPLIT), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(_corpus(), trainers.BpeTrainer(
        vocab_size=1500, special_tokens=["<|begin_of_text|>", "<|eot_id|>",
                                         "<|start_header_id|>", "<|end_header_id|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(), show_progress=False))
    # an added token that takes the whitespace before it, and one after it
    tok.add_special_tokens([AddedToken("<|lstrip|>", lstrip=True, normalized=False,
                                       special=True),
                            AddedToken("<|rstrip|>", rstrip=True, normalized=False,
                                       special=True)])
    bos = tok.token_to_id("<|begin_of_text|>")
    tok.post_processor = processors.TemplateProcessing(
        single="<|begin_of_text|> $A", special_tokens=[("<|begin_of_text|>", bos)])
    path = tmp_path_factory.mktemp("trained-llama3")
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<|begin_of_text|>",
                                   eos_token="<|eot_id|>")
    fast.chat_template = synth.LLAMA3_CHAT_TEMPLATE
    fast.save_pretrained(str(path))
    out["llama3"] = path
    # phi-3 style
    tok = Tokenizer(models.BPE(unk_token="<unk>", fuse_unk=True, byte_fallback=True))
    tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                           normalizers.Replace(" ", "▁")])
    tok.decoder = decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(),
                                     decoders.Fuse(), decoders.Strip(" ", 1, 0)])
    tok.train_from_iterator(_corpus(), trainers.BpeTrainer(
        vocab_size=1500, special_tokens=["<unk>", "<s>", "</s>"]
        + [f"<0x{b:02X}>" for b in range(256)], show_progress=False))
    tok.add_special_tokens([AddedToken(t, rstrip=True, normalized=False, special=True)
                            for t in ("<|user|>", "<|assistant|>", "<|system|>", "<|end|>")])
    path = tmp_path_factory.mktemp("trained-phi3")
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<s>", eos_token="<|end|>",
                                   unk_token="<unk>")
    fast.chat_template = synth.PHI3_CHAT_TEMPLATE
    fast.save_pretrained(str(path))
    cfg_path = path / "tokenizer_config.json"
    cfg = json.loads(cfg_path.read_text())
    cfg.update(tokenizer_class="LlamaTokenizer", add_bos_token=True, add_eos_token=False,
               legacy=False)
    cfg_path.write_text(json.dumps(cfg))
    out["phi3"] = path
    return {fam: (p, JsonTokenizer(str(p)), _quiet(JHFTokenizer, str(p)))
            for fam, p in out.items()}


@pytest.mark.parametrize("fam", FAMILIES)
@settings(max_examples=300, deadline=None,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.function_scoped_fixture])
@given(text=TEXT)
def test_trained_files_encode_and_decode_as_transformers(trained, fam, text):
    _path, reader, hf = trained[fam]
    ids = hf.encode(text)
    assert reader.encode(text) == ids
    assert reader.decode(ids) == hf.decode(ids)


@pytest.mark.parametrize("fam", FAMILIES)
def test_trained_files_probes_chat_and_eos_as_transformers(trained, fam):
    _path, reader, hf = trained[fam]
    for text in synth.PROBE_TEXTS + (open(REPO / "SURVEY.md").read()[:4000],):
        assert reader.encode(text) == hf.encode(text)
    chat = [dict(m) for m in synth.PROBE_CHAT]
    assert reader.apply_chat_template(chat) == hf.apply_chat_template(chat)
    assert reader.eos_ids == hf.eos_ids
    if fam == "phi3":
        assert reader.prefix_ids == [reader.token_to_id("<s>")]     # add_bos_token
    top = max(reader.id_to_token) + 3
    ids = list(range(top))
    assert reader.decode(ids) == hf.decode(ids)


# ---------------------------------------------------------------------------
# load_tokenizer and the imports
# ---------------------------------------------------------------------------

def test_load_tokenizer_gives_the_reader_for_tokenizer_json(written, tmp_path, monkeypatch):
    path = written["llama3"][0]
    assert isinstance(load_tokenizer(str(path)), JsonTokenizer)
    # a directory with tokenizer.model only keeps HFTokenizer, which needs
    # transformers and, without it, raises naming the directory
    spm = tmp_path / "spm"
    spm.mkdir()
    (spm / "tokenizer.model").write_bytes(b"\x00")
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(RuntimeError, match="transformers"):
        load_tokenizer(str(spm))


def test_the_reader_and_the_writer_need_neither_transformers_nor_tokenizers(tmp_path):
    """In a fresh interpreter where importing either fails, the writer
    writes the phi-3 files and the reader serves the probes' ids."""
    code = f"""
import sys
sys.modules["transformers"] = None
sys.modules["tokenizers"] = None
from llms_on_kubernetes_tpu_torch.engine.tokenizer import load_tokenizer
from llms_on_kubernetes_tpu_torch.testing import synth_checkpoint as synth
synth.write_tokenizer({str(tmp_path)!r}, "phi3")
tok = load_tokenizer({str(tmp_path)!r})
assert [tok.encode(t) for t in synth.PROBE_TEXTS] == synth.TOKENIZER_PROBES["phi3"]["texts"]
assert tok.apply_chat_template(list(synth.PROBE_CHAT)) == synth.TOKENIZER_PROBES["phi3"]["chat"]
print("ok", type(tok).__name__)
"""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "ok JsonTokenizer" in res.stdout, res.stderr[-2000:]


@pytest.mark.parametrize("doc,what", [
    ({"model": {"type": "Unigram", "vocab": []}}, "Unigram"),
    ({"model": {"type": "BPE", "vocab": {}, "merges": []},
      "added_tokens": [{"id": 0, "content": "<m>", "single_word": True}]}, "single_word"),
    ({"model": {"type": "BPE", "vocab": {}, "merges": []},
      "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": True, "use_regex": False}},
     "add_prefix_space"),
    ({"model": {"type": "BPE", "vocab": {}, "merges": []},
      "pre_tokenizer": {"type": "Split", "pattern": {"Regex": "\\s+"},
                        "behavior": "Isolated"}}, "Split"),
    ({"model": {"type": "BPE", "vocab": {}, "merges": []},
      "normalizer": {"type": "NFKC"}}, "NFKC"),
    ({"model": {"type": "BPE", "vocab": {}, "merges": []},
      "pre_tokenizer": {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT},
                        "behavior": "MergedWithPrevious"}}, "Split"),
    ({"model": {"type": "BPE", "vocab": {}, "merges": []},
      "pre_tokenizer": {"type": "Split", "pattern": {"String": " "},
                        "behavior": "Sideways"}}, "Split"),
], ids=["unigram", "single_word", "add_prefix_space", "other_split", "nfkc",
        "regex_split_merged", "string_split_unknown_behavior"])
def test_the_reader_refuses_what_it_does_not_implement(tmp_path, doc, what):
    (tmp_path / "tokenizer.json").write_text(json.dumps(doc))
    with pytest.raises(NotImplementedError, match=what):
        JsonTokenizer(str(tmp_path))
