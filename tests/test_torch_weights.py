"""The port's checkpoint loader against the JAX package's and against
HuggingFace ``transformers``, on tiny random checkpoints written by
``save_pretrained`` (as tests/test_weights.py writes them).

- ``load_hf_params`` gives the JAX ``load_hf_params``'s tree, bit for bit
  (bfloat16 compared as its bits), in float32 and bfloat16, for llama,
  qwen2, qwen3, phi3 (fused tensors split), gemma2 (four norms) and a
  gemma-3 text model nested as ``model.language_model.*`` under a
  ``text_config`` wrapper.
- The port's ``forward_prefill`` over those weights gives HF's last-token
  logits within rtol = atol = 4e-3 (the JAX test's tolerance: float32,
  two implementations' summation orders and activation forms).
- a Mixtral checkpoint loads under ``quantization="int8"`` with the JAX
  loader's int8 stacks; ``resolve_model_dir`` finds what the JAX one finds.
"""

import json

import jax
import numpy as np
import pytest
import torch

from llms_on_kubernetes_tpu.configs import from_hf_config as j_from_hf_config
from llms_on_kubernetes_tpu.engine.weights import load_hf_params as j_load_hf_params
from llms_on_kubernetes_tpu.engine.weights import resolve_model_dir as j_resolve_model_dir
from llms_on_kubernetes_tpu_torch.configs import from_hf_config
from llms_on_kubernetes_tpu_torch.engine.cache import CacheConfig, PageAllocator, init_pages
from llms_on_kubernetes_tpu_torch.engine.weights import load_hf_params, resolve_model_dir
from llms_on_kubernetes_tpu_torch.models.decoder import forward_prefill

transformers = pytest.importorskip("transformers")

COMMON = dict(vocab_size=96, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
              rms_norm_eps=1e-5, rope_theta=10000.0)
FAMILIES = ["llama", "qwen2", "qwen3", "phi3", "gemma2", "gemma3_nested"]
PROMPT = [1, 5, 9, 42, 17, 3, 60, 2]


def _hf_model(family):
    t = transformers
    if family == "llama":
        return t.LlamaForCausalLM(t.LlamaConfig(attention_bias=False, tie_word_embeddings=False,
                                                **COMMON))
    if family == "qwen2":
        return t.Qwen2ForCausalLM(t.Qwen2Config(tie_word_embeddings=False, **COMMON))
    if family == "qwen3":
        return t.Qwen3ForCausalLM(t.Qwen3Config(head_dim=8, tie_word_embeddings=False, **COMMON))
    if family == "phi3":
        # the default pad_token_id (32000) would index past the tiny vocab
        return t.Phi3ForCausalLM(t.Phi3Config(pad_token_id=0, tie_word_embeddings=False,
                                              **COMMON))
    if family == "gemma2":
        cfg = t.Gemma2Config(head_dim=8, query_pre_attn_scalar=8, sliding_window=4,
                             final_logit_softcapping=30.0, attn_logit_softcapping=50.0,
                             pad_token_id=0, **COMMON)
        cfg._attn_implementation = "eager"   # softcapping runs only in eager attention
        return t.Gemma2ForCausalLM(cfg)
    cfg = t.Gemma3TextConfig(head_dim=8, query_pre_attn_scalar=8, sliding_window=4,
                             rope_local_base_freq=10000.0, pad_token_id=0, **COMMON)
    cfg._attn_implementation = "eager"
    return t.Gemma3ForCausalLM(cfg)


def _nest_gemma3(path):
    """Rewrite a saved gemma-3 text checkpoint as a multimodal wrapper
    stores it: tensors under ``model.language_model.*``, the text config
    under ``text_config`` of a ``gemma3`` config (no vision tower)."""
    import safetensors.torch

    files = sorted(path.glob("*.safetensors"))
    for f in files:
        tensors = safetensors.torch.load_file(str(f))
        nested = {("model.language_model." + k[len("model."):] if k.startswith("model.") else k): v
                  for k, v in tensors.items()}
        safetensors.torch.save_file(nested, str(f), metadata={"format": "pt"})
    idx = path / "model.safetensors.index.json"
    if idx.exists():
        index = json.loads(idx.read_text())
        index["weight_map"] = {("model.language_model." + k[len("model."):]
                                if k.startswith("model.") else k): v
                               for k, v in index["weight_map"].items()}
        idx.write_text(json.dumps(index))
    text = json.loads((path / "config.json").read_text())
    (path / "config.json").write_text(json.dumps({
        "model_type": "gemma3", "architectures": ["Gemma3ForConditionalGeneration"],
        "text_config": text}))


@pytest.fixture(scope="module", params=FAMILIES)
def checkpoint(request, tmp_path_factory):
    """(family, checkpoint dir, the HF model in float32)."""
    family = request.param
    torch.manual_seed(0)
    hf = _hf_model(family)
    for p in hf.parameters():
        torch.nn.init.normal_(p, std=0.05)
    hf = hf.eval().to(torch.float32)
    path = tmp_path_factory.mktemp(family)
    # two shards and an index for half the families
    hf.save_pretrained(path, safe_serialization=True,
                       max_shard_size="40KB" if family in ("llama", "phi3", "gemma3_nested")
                       else "5GB")
    if family == "gemma3_nested":
        _nest_gemma3(path)
    return family, path, hf


def _np(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.uint16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_hf_params_equals_jax_bit_for_bit(checkpoint, dtype):
    family, path, _ = checkpoint
    hf_cfg = json.loads((path / "config.json").read_text())
    cfg = from_hf_config(hf_cfg, name=family)
    jcfg = j_from_hf_config(hf_cfg, name=family)
    got = load_hf_params(cfg, str(path), device="cpu", dtype=dtype)
    want = j_load_hf_params(jcfg, str(path), dtype=dtype)
    assert set(got) == set(want)
    assert set(got["layers"]) == set(want["layers"])
    if family.startswith("gemma"):
        assert {"attn_post_norm", "mlp_post_norm"} <= set(got["layers"])
    pairs = [(k, got[k], want[k]) for k in got if k != "layers"]
    pairs += [(f"layers.{k}", got["layers"][k], want["layers"][k]) for k in got["layers"]]
    for name, g, w in pairs:
        w = _jnp(w)
        assert g.dtype == getattr(torch, dtype), name
        assert g.is_contiguous(), name
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(_np(g), w, err_msg=name)


def _prefill_logits(cfg, params, prompt):
    cc = CacheConfig(num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
                     head_dim=cfg.head_dim, num_pages=32, page_size=4, pages_per_slot=8,
                     dtype="float32")
    kp, vp = init_pages(cc, device="cpu")
    al = PageAllocator(cc.num_pages, cc.page_size, 1, cc.pages_per_slot)
    al.allocate(0, len(prompt))
    logits, _, _ = forward_prefill(
        params, cfg, torch.tensor([prompt], dtype=torch.int32),
        torch.tensor([len(prompt)], dtype=torch.int32), kp, vp,
        torch.from_numpy(np.asarray(al.page_tables)))
    return logits[0].numpy()


def test_prefill_logits_match_transformers(checkpoint):
    family, path, hf = checkpoint
    cfg = from_hf_config(json.loads((path / "config.json").read_text()), name=family)
    params = load_hf_params(cfg, str(path), device="cpu", dtype="float32")
    with torch.no_grad():
        want = hf(torch.tensor([PROMPT])).logits[0, -1].numpy()
    got = _prefill_logits(cfg, params, PROMPT)
    np.testing.assert_allclose(got, want, rtol=4e-3, atol=4e-3)


def test_moe_vision_and_quantized_checkpoints_raise(tmp_path):
    """What the port loads now that it once refused: a transformers-written
    Mixtral checkpoint under ``quantization="int8"`` gives the JAX
    loader's int8 expert stacks and scales (the router in the dtype), and
    a vision config goes on to the directory (which raises here for
    holding no weights)."""
    from llms_on_kubernetes_tpu.ops.quant import QTensor as JQTensor
    from llms_on_kubernetes_tpu_torch.ops.quant import QTensor

    torch.manual_seed(0)
    moe = transformers.MixtralForCausalLM(transformers.MixtralConfig(
        num_local_experts=4, num_experts_per_tok=2, **COMMON))
    moe.save_pretrained(tmp_path / "moe", safe_serialization=True)
    hf = str(tmp_path / "moe" / "config.json")
    got = load_hf_params(from_hf_config(hf, name="moe"), str(tmp_path / "moe"), device="cpu",
                         quantization="int8")
    want = j_load_hf_params(j_from_hf_config(hf, name="moe"), str(tmp_path / "moe"),
                            quantization="int8")
    for name, w in want["layers"].items():
        g = got["layers"][name]
        assert isinstance(g, QTensor) == isinstance(w, JQTensor), name
        if isinstance(w, JQTensor):
            np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data), err_msg=name)
            np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale), err_msg=name)
        else:
            np.testing.assert_array_equal(g.float().numpy(), np.asarray(w).astype(np.float32),
                                          err_msg=name)
    assert isinstance(got["layers"]["w_gate"], QTensor)
    assert not isinstance(got["layers"]["router"], QTensor)

    # a vision tower is loaded now (both loaders on synthetic multimodal
    # checkpoints: tests/test_torch_multimodal.py): no refusal, the loader
    # goes on to the directory, which holds no weights here
    vision_cfg = dict(model_type="gemma3", text_config=dict(COMMON, model_type="gemma3_text"),
                      vision_config=dict(hidden_size=16, intermediate_size=32,
                                         num_hidden_layers=1, num_attention_heads=2,
                                         image_size=16, patch_size=4))
    with pytest.raises(FileNotFoundError):
        load_hf_params(from_hf_config(vision_cfg, name="mm"), str(tmp_path), device="cpu")


def test_missing_tensor_and_missing_files_raise(tmp_path):
    from llms_on_kubernetes_tpu_torch.configs import get_config

    with pytest.raises(FileNotFoundError):
        load_hf_params(get_config("debug-tiny"), str(tmp_path), device="cpu")
    import safetensors.numpy
    safetensors.numpy.save_file({"model.embed_tokens.weight": np.zeros((256, 64), np.float32)},
                                str(tmp_path / "model.safetensors"))
    with pytest.raises(KeyError, match="missing tensor"):
        load_hf_params(get_config("debug-tiny"), str(tmp_path), device="cpu")


def _snapshot(root, repo, files):
    snap = root / "hub" / ("models--" + repo.replace("/", "--")) / "snapshots" / "abc123"
    snap.mkdir(parents=True)
    for f in files:
        (snap / f).write_text("{}")
    return snap


def test_resolve_model_dir_as_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    d = tmp_path / "ckpt"
    d.mkdir()
    assert resolve_model_dir(str(d)) == j_resolve_model_dir(str(d)) == str(d)
    for ref in ("nonexistent/model", "phi-3-mini"):
        for fn in (resolve_model_dir, j_resolve_model_dir):
            with pytest.raises(FileNotFoundError):
                fn(ref, cache_dir=str(tmp_path))
    # a complete snapshot under the canonical repo id of a registry name
    snap = _snapshot(tmp_path, "microsoft/Phi-3-mini-4k-instruct",
                     ["config.json", "tokenizer.json", "model.safetensors"])
    for ref in ("phi-3-mini", "microsoft/Phi-3-mini-4k-instruct"):
        assert resolve_model_dir(ref, cache_dir=str(tmp_path)) == str(snap)
        assert j_resolve_model_dir(ref, cache_dir=str(tmp_path)) == str(snap)
    # incomplete: a shard named by the index is missing; no tokenizer file
    _snapshot(tmp_path, "org/sharded", ["config.json", "tokenizer.json",
                                        "model-00001-of-00002.safetensors"])
    idx = (tmp_path / "hub" / "models--org--sharded" / "snapshots" / "abc123" /
           "model.safetensors.index.json")
    idx.write_text(json.dumps({"weight_map": {"a": "model-00001-of-00002.safetensors",
                                              "b": "model-00002-of-00002.safetensors"}}))
    _snapshot(tmp_path, "org/notok", ["config.json", "model.safetensors"])
    for ref in ("org/sharded", "org/notok"):
        for fn in (resolve_model_dir, j_resolve_model_dir):
            with pytest.raises(FileNotFoundError):
                fn(ref, cache_dir=str(tmp_path))
    # HF_HUB_CACHE points at the hub directory itself
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    assert resolve_model_dir("phi-3-mini") == j_resolve_model_dir("phi-3-mini") == str(snap)


def test_jax_params_tree_is_the_port_layout(checkpoint):
    """The loaded tree has the layouts the JAX init_params gives (so the
    decoder takes a checkpoint as it takes random weights)."""
    family, path, _ = checkpoint
    from llms_on_kubernetes_tpu.models.decoder import init_params as j_init_params

    jcfg = j_from_hf_config(json.loads((path / "config.json").read_text()), name=family)
    init = j_init_params(jcfg, jax.random.key(0), dtype="float32")
    got = load_hf_params(from_hf_config(json.loads((path / "config.json").read_text()),
                                        name=family), str(path), device="cpu", dtype="float32")
    assert set(got) == set(init)
    for k, v in init["layers"].items():
        assert tuple(got["layers"][k].shape) == tuple(v.shape), k
