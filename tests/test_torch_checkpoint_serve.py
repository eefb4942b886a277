"""Serving a checkpoint directory with the port, on the CPU.

- The port's Engine built from a tiny checkpoint gives the JAX Engine's
  greedy streams from the same checkpoint (float32): a registry model
  written by the port's writer, and a phi3 checkpoint (fused tensors, its
  config from config.json) written by ``transformers``.
- ``python -m llms_on_kubernetes_tpu_torch serve --model <dir> --device
  cpu`` loads the directory before it binds and answers
  ``/v1/chat/completions`` over HTTP; a missing directory, or no weights
  without ``--random-weights``, exits non-zero naming the flag.
- A directory with tokenizer.json gets the port's reader of it, which
  answers as the JAX ``load_tokenizer``'s HF tokenizer does, with or
  without ``transformers``; a directory with only tokenizer.model needs
  ``transformers``, raises without it and never falls back to the byte
  tokenizer.
"""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest
import torch

from llms_on_kubernetes_tpu.configs import from_hf_config as j_from_hf_config
from llms_on_kubernetes_tpu.configs import get_config as jget_config
from llms_on_kubernetes_tpu.engine.engine import Engine as JEngine
from llms_on_kubernetes_tpu.engine.engine import EngineConfig as JEngineConfig
from llms_on_kubernetes_tpu.engine.engine import SamplingParams as JSamplingParams
from llms_on_kubernetes_tpu.engine.tokenizer import load_tokenizer as j_load_tokenizer
from llms_on_kubernetes_tpu_torch import cli
from llms_on_kubernetes_tpu_torch.configs import get_config
from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
from llms_on_kubernetes_tpu_torch.engine.tokenizer import (
    ByteTokenizer, JsonTokenizer, load_tokenizer,
)
from llms_on_kubernetes_tpu_torch.testing.synth_checkpoint import write_checkpoint

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(dtype="float32", max_decode_slots=4, page_size=4, num_pages=128,
             pages_per_slot=16, prefill_buckets=(16, 32))
PROMPTS = [[3, 17, 9], [40, 2] * 9, [7, 7, 7, 7], [50, 42, 5, 1, 9] * 5, [11] * 40]


def _run(eng, prompts, params):
    reqs = [eng.submit(p, params) for p in prompts]
    for _ in range(500):
        if not eng.has_work():
            break
        eng.step()
    assert all(r.finished for r in reqs)
    return [r.output for r in reqs]


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("debug-tiny-ckpt")
    write_checkpoint(get_config("debug-tiny"), str(path), dtype="float32",
                     max_shard_bytes=100_000)
    return path


@pytest.fixture(scope="module")
def phi3_dir(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.Phi3ForCausalLM(transformers.Phi3Config(
        vocab_size=96, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=128,
        sliding_window=20, pad_token_id=0, tie_word_embeddings=False))
    for p in hf.parameters():
        torch.nn.init.normal_(p, std=0.05)
    path = tmp_path_factory.mktemp("phi3-ckpt")
    hf.eval().to(torch.float32).save_pretrained(path, safe_serialization=True)
    return path


def test_engine_from_a_checkpoint_equals_jax_engine(tiny_dir, phi3_dir):
    greedy = dict(max_tokens=10, temperature=0.0)
    for model, path, cfg_j in (("debug-tiny", tiny_dir, jget_config("debug-tiny")),
                               (str(phi3_dir), phi3_dir,
                                j_from_hf_config(str(phi3_dir / "config.json"),
                                                 name=str(phi3_dir)))):
        prompts = [[t % cfg_j.vocab_size for t in p] for p in PROMPTS]
        jeng = JEngine(JEngineConfig(model=model, **SMALL), model_config=cfg_j,
                       model_dir=str(path))
        want = _run(jeng, prompts, JSamplingParams(**greedy))
        eng = Engine(EngineConfig(model=model, device="cpu", **SMALL), model_dir=str(path))
        assert eng.model_config.num_layers == cfg_j.num_layers
        assert eng.model_config.sliding_window == cfg_j.sliding_window
        got = _run(eng, prompts, SamplingParams(**greedy))
        assert got == want, model
        # one prompt past the largest bucket went through the chunk path
        assert eng.chunk_calls >= 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(url, body, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def test_serve_a_checkpoint_dir_over_http(tiny_dir, tmp_path):
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    log = open(tmp_path / "server.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "llms_on_kubernetes_tpu_torch", "serve", "--model", str(tiny_dir),
         "--device", "cpu", "--host", "127.0.0.1", "--port", str(port), "--dtype", "float32",
         "--max-decode-slots", "2", "--num-pages", "64", "--page-size", "8",
         "--pages-per-slot", "16", "--prefill-buckets", "16,64"],
        cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        base = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 180
        while True:
            assert proc.poll() is None, (tmp_path / "server.log").read_text()
            try:
                with urllib.request.urlopen(base + "/health", timeout=5) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            assert time.monotonic() < deadline, "no /health in 180 s"
            time.sleep(0.5)
        status, data = _post(base + "/v1/chat/completions", {
            "model": str(tiny_dir), "messages": [{"role": "user", "content": "hello"}],
            "max_tokens": 6, "temperature": 0})
        assert status == 200 and data["object"] == "chat.completion"
        assert data["model"] == str(tiny_dir)
        assert data["usage"]["completion_tokens"] == 6
        assert isinstance(data["choices"][0]["message"]["content"], str)
        with urllib.request.urlopen(base + "/v1/models", timeout=10) as r:
            assert json.loads(r.read())["data"][0]["id"] == str(tiny_dir)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        log.close()
    out = (tmp_path / "server.log").read_text()
    assert f"weights from {tiny_dir}" in out and " s" in out   # the load seconds


def test_missing_weights_exit_non_zero(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    assert cli.main(["serve", "--model", str(tmp_path / "no-such-dir"), "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "--random-weights" in err and "no-such-dir" in err
    assert cli.main(["serve", "--model", "phi-3-mini", "--device", "cpu"]) == 1
    assert "--random-weights" in capsys.readouterr().err
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-m", "llms_on_kubernetes_tpu_torch", "serve",
                          "--model", str(tmp_path / "missing"), "--device", "cpu"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "--random-weights" in res.stderr


@pytest.fixture(scope="module")
def tokenizer_dir(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2, **{w: i + 3 for i, w in enumerate(
        "hello world the card serves a model".split())}}
    tok = Tokenizer(models.WordLevel(vocab=vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    fast = transformers.PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>",
                                                bos_token="<s>", eos_token="</s>")
    fast.chat_template = ("{% for m in messages %}{{ m['content'] }} {% endfor %}"
                          "{% if add_generation_prompt %}the{% endif %}")
    path = tmp_path_factory.mktemp("tok")
    fast.save_pretrained(path)
    return path


def test_a_tokenizer_dir_gets_the_hf_tokenizer(tokenizer_dir, tiny_dir):
    """A directory with tokenizer.json gets the port's reader of it
    (``JsonTokenizer``), which answers as the JAX ``HFTokenizer`` does."""
    got, want = load_tokenizer(str(tokenizer_dir)), j_load_tokenizer(str(tokenizer_dir))
    assert isinstance(got, JsonTokenizer) and type(want).__name__ == "HFTokenizer"
    text = "hello world the card serves a model"
    assert got.encode(text) == want.encode(text)
    ids = got.encode(text)
    assert got.decode(ids) == want.decode(ids)
    msgs = [{"role": "user", "content": "hello world"}]
    assert got.apply_chat_template(msgs) == want.apply_chat_template(msgs)
    assert got.eos_ids == want.eos_ids == {2}
    # a checkpoint with weights only, and a registry name: the byte tokenizer
    assert isinstance(load_tokenizer(str(tiny_dir)), ByteTokenizer)
    assert type(j_load_tokenizer(str(tiny_dir))).__name__ == "ByteTokenizer"
    assert isinstance(load_tokenizer("phi-3-mini"), ByteTokenizer)


def test_a_tokenizer_dir_without_transformers_raises(tokenizer_dir, tmp_path, monkeypatch):
    """Without transformers (as on the card's machine) a tokenizer.json
    directory is still read, by the port's reader; a directory with only
    tokenizer.model needs transformers and raises, never falling back to
    the byte tokenizer."""
    monkeypatch.setitem(sys.modules, "transformers", None)   # import fails, as on the card
    assert isinstance(load_tokenizer(str(tokenizer_dir)), JsonTokenizer)
    (tmp_path / "tokenizer.model").write_bytes(b"\x00")
    with pytest.raises(RuntimeError, match="transformers"):
        load_tokenizer(str(tmp_path))
