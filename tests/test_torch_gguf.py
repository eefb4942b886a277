"""GGUF checkpoints in the port against the JAX package (tests/test_gguf.py),
on the CPU.

- Each of the seven dequantizers (``engine/gguf.dequantize``, and
  ``GGUFFile.tensor``, which cuts a large tensor into pieces on threads)
  is bit-equal to the JAX ``dequantize`` on the same payloads.
- ``GGUFFile`` metadata and ``config_from_gguf`` equal the JAX ones, on
  files from the port's writer (``testing/synth_gguf.py``) and from the
  JAX tests' ``write_gguf``.
- ``load_gguf_params`` equals the JAX ``load_gguf_params`` exactly in
  float32 (llama names, phi3's fused qkv and gate+up); with
  ``quantization="int8"`` the int8 data and scales equal the JAX
  ``quantize_params``'.
- ``GGUFTokenizer`` encode, decode and chat template equal the JAX class's
  on probes; ``load_tokenizer`` takes a ``.gguf``.
- A ``.gguf`` served on the CPU (``serve``'s GGUF branch, the port's
  server) greedy-decodes the tokens the JAX engine decodes from the same
  file.
"""

import json
import os
import struct
import urllib.request

import jax
import numpy as np
import pytest
import torch

from llms_on_kubernetes_tpu.engine import gguf as JG
from llms_on_kubernetes_tpu.engine import tokenizer as jtok
from llms_on_kubernetes_tpu.engine.engine import Engine as JEngine
from llms_on_kubernetes_tpu.engine.engine import EngineConfig as JEngineConfig
from llms_on_kubernetes_tpu.engine.engine import SamplingParams as JSamplingParams
from llms_on_kubernetes_tpu_torch.engine import gguf as G
from llms_on_kubernetes_tpu_torch.engine import tokenizer as ttok
from llms_on_kubernetes_tpu_torch.engine.engine import EngineConfig
from llms_on_kubernetes_tpu_torch.ops.quant import QTensor
from llms_on_kubernetes_tpu_torch.testing import synth_gguf as S
from test_gguf import REFS, rand_payload, write_gguf

TYPES = [G.GGML_F32, G.GGML_F16, G.GGML_Q4_0, G.GGML_Q4_1, G.GGML_Q8_0, G.GGML_Q4_K,
         G.GGML_Q6_K]

# small models in the presets' layouts (every matrix a whole number of blocks)
TINY_LLAMA = dict(S.PRESETS["tinyllama-1.1b"], hidden=64, layers=2, heads=4, kv_heads=2,
                  head_dim=16, ffn=256, vocab=512, matrix=S.GGML_Q4_0, embed=S.GGML_F16,
                  output=S.GGML_Q6_K)
TINY_PHI3 = dict(S.PRESETS["phi-3-mini"], hidden=64, layers=2, heads=4, kv_heads=4,
                 head_dim=16, ffn=256, vocab=32064)
TINY_TIED = dict(S.PRESETS["llama-3.2-1b"], hidden=64, layers=2, heads=4, kv_heads=2,
                 head_dim=16, ffn=128, vocab=256, matrix=S.GGML_Q4_1, embed=S.GGML_Q8_0)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("gguf")
    out = {}
    for name, spec in (("llama", TINY_LLAMA), ("phi3", TINY_PHI3), ("tied", TINY_TIED)):
        out[name] = str(d / f"{name}.gguf")
        S.write_model(out[name], spec, seed=len(name))
    return out


# ---------------------------------------------------------------------------
# dequantizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ggml_type", TYPES)
def test_dequantizers_bit_equal_jax(ggml_type):
    rng = np.random.default_rng(ggml_type)
    n = 4 * 256
    raw = S.payload(rng, ggml_type, n, 0.05)
    got = G.dequantize(ggml_type, raw, n)
    want = JG.dequantize(ggml_type, raw, n)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    if ggml_type in (G.GGML_Q8_0, G.GGML_Q4_0, G.GGML_Q4_K, G.GGML_Q6_K,
                     G.GGML_F32, G.GGML_F16):
        # the JAX tests' own payloads too
        raw = np.frombuffer(rand_payload(rng, ggml_type, n), np.uint8)
        np.testing.assert_array_equal(G.dequantize(ggml_type, raw, n).view(np.uint32),
                                      JG.dequantize(ggml_type, raw, n).view(np.uint32))


@pytest.mark.parametrize("ggml_type", sorted(REFS))
def test_dequantizers_equal_the_scalar_references(ggml_type):
    """tests/test_gguf.py's scalar transcriptions of the ggml block
    formats, against the port's one-pass K quants too."""
    rng = np.random.default_rng(100 + ggml_type)
    n = 3 * 256
    raw = S.payload(rng, ggml_type, n, 0.05)
    np.testing.assert_array_equal(G.dequantize(ggml_type, raw, n),
                                  REFS[ggml_type](raw.tobytes(), n))


@pytest.mark.parametrize("ggml_type", [G.GGML_Q8_0, G.GGML_Q4_K, G.GGML_Q6_K, G.GGML_Q4_1])
def test_threaded_tensor_reads_equal_one_call(tmp_path, monkeypatch, ggml_type):
    """A tensor past two pieces dequantized on four threads equals one
    call of the JAX ``dequantize`` over the whole tensor, bit for bit."""
    monkeypatch.setattr(G, "_PIECE", 1 << 12)
    monkeypatch.setattr(G, "_dequant_threads", lambda: 4)
    shape = (48, 512)
    path = tmp_path / "t.gguf"
    S.write_gguf(str(path), [], [("w", shape, ggml_type, 0.1)], seed=ggml_type)
    gf, jgf = G.GGUFFile(str(path)), JG.GGUFFile(str(path))
    np.testing.assert_array_equal(gf.tensor("w").view(np.uint32),
                                  jgf.tensor("w").view(np.uint32))
    gf.close()
    jgf.close()


# ---------------------------------------------------------------------------
# the container and the config
# ---------------------------------------------------------------------------

def _config_fields(cfg) -> dict:
    keep = ("name", "vocab_size", "hidden_size", "intermediate_size", "num_layers",
            "num_heads", "num_kv_heads", "head_dim", "rope_theta", "rms_norm_eps",
            "max_position_embeddings", "tie_word_embeddings", "sliding_window",
            "rope_scaling", "dtype")
    return {k: getattr(cfg, k) for k in keep}


@pytest.mark.parametrize("name", ["llama", "phi3", "tied"])
def test_container_and_config_equal_jax_on_the_port_writer(files, name):
    gf, jgf = G.GGUFFile(files[name]), JG.GGUFFile(files[name])
    assert gf.metadata == jgf.metadata
    assert gf.tensors == jgf.tensors
    cfg, jcfg = G.config_from_gguf(gf), JG.config_from_gguf(jgf)
    assert _config_fields(cfg) == _config_fields(jcfg)
    assert _config_fields(G.config_from_gguf(gf, name="x")) == \
        _config_fields(JG.config_from_gguf(jgf, name="x"))
    for t in gf.tensors:
        np.testing.assert_array_equal(gf.tensor(t).view(np.uint32),
                                      jgf.tensor(t).view(np.uint32))
    gf.close()
    jgf.close()


def test_container_and_config_equal_jax_on_the_jax_writer(tmp_path):
    """tests/test_gguf.py's tiny llama file, byte-assembled by the JAX
    tests' writer."""
    from test_gguf import _tiny_llama_gguf

    path, tensors = _tiny_llama_gguf(tmp_path, np.random.default_rng(7))
    gf, jgf = G.GGUFFile(str(path)), JG.GGUFFile(str(path))
    assert gf.metadata == jgf.metadata and gf.tensors == jgf.tensors
    assert _config_fields(G.config_from_gguf(gf)) == _config_fields(JG.config_from_gguf(jgf))
    for name, _shape, _t, _payload in tensors:
        np.testing.assert_array_equal(gf.tensor(name), jgf.tensor(name))
    gf.close()
    jgf.close()


def test_gguf_v2_and_bad_files_as_jax(tmp_path):
    meta = {"general.architecture": (8, "llama")}
    write_gguf(tmp_path / "v3.gguf", meta, [])
    raw = (tmp_path / "v3.gguf").read_bytes()
    (tmp_path / "v2.gguf").write_bytes(raw[:4] + struct.pack("<I", 2) + raw[8:])
    (tmp_path / "v1.gguf").write_bytes(raw[:4] + struct.pack("<I", 1) + raw[8:])
    (tmp_path / "bad.gguf").write_bytes(b"GGML" + raw[4:])
    assert G.GGUFFile(str(tmp_path / "v2.gguf")).metadata == meta_values(meta)
    for bad in ("v1.gguf", "bad.gguf"):
        with pytest.raises(ValueError):
            G.GGUFFile(str(tmp_path / bad))
        with pytest.raises(ValueError):
            JG.GGUFFile(str(tmp_path / bad))


def meta_values(meta: dict) -> dict:
    return {k: v for k, (_t, v) in meta.items()}


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _jax_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("name", ["llama", "phi3", "tied"])
def test_load_gguf_params_equal_jax_f32(files, name):
    cfg, params = G.load_gguf_params(files[name], dtype="float32", device="cpu")
    jcfg, jparams = JG.load_gguf_params(files[name], dtype="float32")
    jp = _jax_numpy(jparams)
    assert _config_fields(cfg) == _config_fields(jcfg)
    assert set(params) == set(jp) and set(params["layers"]) == set(jp["layers"])
    for k, v in params["layers"].items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), jp["layers"][k], err_msg=k)
    for k in set(params) - {"layers"}:
        np.testing.assert_array_equal(params[k].numpy(), jp[k], err_msg=k)
    assert ("lm_head" in params) == (name != "tied")


@pytest.mark.parametrize("name", ["llama", "phi3"])
def test_load_gguf_params_int8_equal_jax_quantize_params(files, name):
    cfg, params = G.load_gguf_params(files[name], dtype="float32", quantization="int8",
                                     device="cpu")
    _, jparams = JG.load_gguf_params(files[name], dtype="float32", quantization="int8")
    for k, v in params["layers"].items():
        j = jparams["layers"][k]
        if isinstance(v, QTensor):
            np.testing.assert_array_equal(v.data.numpy(), np.asarray(j.data), err_msg=k)
            np.testing.assert_array_equal(v.scale.numpy(), np.asarray(j.scale), err_msg=k)
        else:
            np.testing.assert_array_equal(v.numpy(), np.asarray(j), err_msg=k)
    assert isinstance(params["layers"]["wq"], QTensor)
    assert not isinstance(params["embed"], QTensor)


def test_load_gguf_params_bf16_casts_the_float32_values(files):
    _, p32 = G.load_gguf_params(files["phi3"], dtype="float32", device="cpu")
    _, p16 = G.load_gguf_params(files["phi3"], dtype="bfloat16", device="cpu")
    for k, v in p16["layers"].items():
        assert v.dtype == torch.bfloat16
        assert torch.equal(v, p32["layers"][k].to(torch.bfloat16))
    with pytest.raises(ValueError):
        G.load_gguf_params(files["phi3"], quantization="fp8", device="cpu")


# ---------------------------------------------------------------------------
# the tokenizer
# ---------------------------------------------------------------------------

PROBES = ["Hello, world! The engine serves 1,234,567 tokens on the card.",
          "naïve café — 東京 🚀\n\n  indented\r\nline's end", "<|end|> and <|user|> as text",
          "", " leading space", "paged attention reads the cache through a table of pages"]
CHATS = [[{"role": "user", "content": "hi"}],
         [{"role": "system", "content": "You are terse."},
          {"role": "user", "content": "What is 2 + 2?"},
          {"role": "assistant", "content": "4"}, {"role": "user", "content": "And 3 + 3?"}]]


@pytest.mark.parametrize("name", ["llama", "phi3"])
def test_gguf_tokenizer_equals_jax(files, name):
    gf = G.GGUFFile(files[name])
    t, j = ttok.GGUFTokenizer(gf.metadata), jtok.GGUFTokenizer(gf.metadata)
    gf.close()
    for text in PROBES:
        ids = t.encode(text)
        assert ids == j.encode(text)
        assert t.decode(ids) == j.decode(ids)
    for chat in CHATS:
        assert t.apply_chat_template(chat) == j.apply_chat_template(chat)
    assert t.eos_ids == j.eos_ids and t.chat_template == j.chat_template
    ids = list(range(0, len(t.tokens), 97))
    assert t.decode(ids) == j.decode(ids)


def test_gguf_tokenizer_unit_cases_as_jax():
    """tests/test_gguf.py's SPM merge and fallback cases on the port's class."""
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    types = [2, 3, 3] + [6] * 256
    for t, _s in [("h", -10.0), ("e", -10.0), ("l", -10.0), ("o", -10.0), ("▁", -5.0),
                  ("he", -1.0), ("ll", -2.0), ("hell", -0.5), ("hello", -0.2),
                  ("▁hello", -0.1)]:
        tokens.append(t)
        types.append(1)
    scores = [0.0] * 259 + [-10.0, -10.0, -10.0, -10.0, -5.0, -1.0, -2.0, -0.5, -0.2, -0.1]
    md = {"tokenizer.ggml.model": "llama", "tokenizer.ggml.tokens": tokens,
          "tokenizer.ggml.scores": scores, "tokenizer.ggml.token_type": types,
          "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2}
    t, j = ttok.GGUFTokenizer(md), jtok.GGUFTokenizer(md)
    for text in ("hello", "h€", "hello hello", "lol"):
        assert t.encode(text) == j.encode(text)
    assert t.tokens[t.encode("hello")[1]] == "▁hello"
    assert t.decode(t.encode("h€")).endswith("h€")
    with pytest.raises(ValueError):
        ttok.GGUFTokenizer({**md, "tokenizer.ggml.model": "gpt2"})
    # a malformed template falls back to the generic format, as in JAX
    bad = {**md, "tokenizer.chat_template": "{% bogus %}"}
    chat = [{"role": "user", "content": "hello"}]
    assert ttok.GGUFTokenizer(bad).apply_chat_template(chat) == \
        jtok.GGUFTokenizer(bad).apply_chat_template(chat)


def test_load_tokenizer_reads_a_gguf(files, tmp_path):
    assert isinstance(ttok.load_tokenizer(files["phi3"]), ttok.GGUFTokenizer)
    # a file without a vocabulary gives the byte tokenizer, as in JAX
    assert isinstance(ttok.load_tokenizer(files["tied"]), ttok.ByteTokenizer)
    assert isinstance(jtok.load_tokenizer(files["tied"]), jtok.ByteTokenizer)


def test_grammar_byte_map_of_a_gguf_vocabulary(files):
    """engine/grammar.token_bytes_of maps a GGUF SentencePiece vocabulary
    to bytes as the JAX one does, so guided decoding serves a .gguf."""
    from llms_on_kubernetes_tpu.engine.grammar import token_bytes_of as j_token_bytes
    from llms_on_kubernetes_tpu_torch.engine.grammar import token_bytes_of

    gf = G.GGUFFile(files["phi3"])
    t, j = ttok.GGUFTokenizer(gf.metadata), jtok.GGUFTokenizer(gf.metadata)
    gf.close()
    assert token_bytes_of(t) == j_token_bytes(j)


# ---------------------------------------------------------------------------
# serving a .gguf on the CPU
# ---------------------------------------------------------------------------

def _post(url: str, body: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


ENGINE = dict(dtype="float32", max_decode_slots=2, page_size=16, num_pages=32,
              pages_per_slot=8, prefill_buckets=(16, 64))


@pytest.mark.parametrize("name,quant", [("phi3", None), ("llama", None), ("llama", "int8")],
                         ids=["phi3", "llama", "llama_int8"])
def test_served_gguf_decodes_the_jax_engines_tokens(files, name, quant):
    """``serve``'s GGUF branch on the CPU (the model config, weights and
    embedded tokenizer from the file) behind the port's server: a chat
    completion's prompt is the embedded template's, and its greedy tokens
    are those of the JAX engine on the JAX loader's params of that file."""
    from llms_on_kubernetes_tpu_torch.server.openai_api import OpenAIServer, _gguf_engine

    path = files[name]
    cfg = EngineConfig(model=path, device="cpu", quantization=quant, **ENGINE)
    eng, tok, _load_s, source = _gguf_engine(path, cfg, torch.device("cpu"), False, None)
    assert isinstance(tok, ttok.GGUFTokenizer) and source.startswith("weights from")
    srv = OpenAIServer(eng, tok, eng.model_config.name)
    base = f"http://127.0.0.1:{srv.start()}"
    chat = CHATS[0]
    try:
        d = _post(base + "/v1/chat/completions", {"messages": chat, "max_tokens": 8,
                                                  "temperature": 0})
        got = eng  # the engine's last request is the chat's
    finally:
        srv.close()
    prompt = tok.apply_chat_template(chat)
    assert d["usage"]["prompt_tokens"] == len(prompt)
    jcfg, jparams = JG.load_gguf_params(path, dtype="float32", quantization=quant)
    jeng = JEngine(JEngineConfig(model=jcfg.name, **ENGINE), model_config=jcfg, params=jparams)
    stops = tuple(sorted(tok.eos_ids))
    want = jeng.generate(prompt, JSamplingParams(temperature=0.0, max_tokens=8,
                                                 stop_token_ids=stops))
    want_text = tok.decode([t for t in want if t not in tok.eos_ids])
    assert d["choices"][0]["message"]["content"] == want_text
    assert got.decode_forwards > 0


def test_tokenizer_files_beside_the_gguf_win(files, tmp_path):
    """Tokenizer files in the .gguf's directory win over its embedded
    vocabulary (the JAX serve rule)."""
    from llms_on_kubernetes_tpu_torch.server.openai_api import _gguf_engine
    from llms_on_kubernetes_tpu_torch.testing.synth_checkpoint import write_tokenizer

    d = tmp_path / "with-files"
    d.mkdir()
    path = d / "m.gguf"
    path.write_bytes(open(files["tied"], "rb").read())
    write_tokenizer(str(d), "llama3")
    cfg = EngineConfig(model=str(path), device="cpu", **ENGINE)
    _eng, tok, _s, _src = _gguf_engine(str(path), cfg, torch.device("cpu"), True, "mine")
    assert isinstance(tok, ttok.JsonTokenizer) and _eng.model_config.name == "mine"
    os.remove(d / "tokenizer.json")
    os.remove(d / "tokenizer_config.json")
    _eng, tok, _s, src = _gguf_engine(str(path), cfg, torch.device("cpu"), True, None)
    assert isinstance(tok, ttok.ByteTokenizer) and src == "seeded random weights"


def test_cli_serve_refuses_a_missing_gguf(tmp_path, capsys):
    from llms_on_kubernetes_tpu_torch.cli import main

    assert main(["serve", "--model", str(tmp_path / "nope.gguf"), "--device", "cpu"]) == 1
    assert "GGUF file not found" in capsys.readouterr().err


def test_draft_model_from_a_gguf(files):
    """The draft tier loads a .gguf draft (the tied-embedding file's 256 ids
    cover debug-tiny's) and drafts with it."""
    from llms_on_kubernetes_tpu_torch.configs import get_config
    from llms_on_kubernetes_tpu_torch.engine.speculation import (
        DraftModelDrafter, build_speculator,
    )

    ecfg = EngineConfig(model="debug-tiny", dtype="float32", speculation="draft",
                        draft_model=files["tied"], device="cpu")
    spec = build_speculator(ecfg, get_config("debug-tiny"), "cpu")
    assert isinstance(spec.drafter, DraftModelDrafter) and spec.max_draft == 3
    d = spec.propose_batch([np.arange(20, dtype=np.int32), None])
    assert d[0].shape == (3,) and d[1].size == 0
    assert spec.drafter.params["embed"].dtype == torch.float32
