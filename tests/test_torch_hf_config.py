"""The port's ``from_hf_config`` and registry against the JAX package's.

``from_hf_config`` must give the JAX one's ``ModelConfig`` field for field
on every family's ``config.json`` shape (rope scaling kinds, biases, q/k
norms, phi-3's window, gemma-2's softcaps, gemma-3's ``text_config``
wrapper, the multimodal wrappers' vision fields), and raise where the JAX
one raises. Every JAX registry entry without MoE or a vision tower must be
in the port's registry, equal to it.
"""

import dataclasses

import pytest

from llms_on_kubernetes_tpu import configs as jconfigs
from llms_on_kubernetes_tpu_torch import configs as tconfigs

COMMON = dict(vocab_size=96, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
              rms_norm_eps=1e-5, rope_theta=10000.0)

HF_CONFIGS = {
    "llama": dict(COMMON, model_type="llama", tie_word_embeddings=False),
    "llama3_rope": dict(COMMON, model_type="llama", rope_scaling=dict(
        rope_type="llama3", factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
        original_max_position_embeddings=8192)),
    "linear_rope": dict(COMMON, model_type="llama",
                        rope_scaling={"type": "linear", "factor": 2.0}),
    "default_rope": dict(COMMON, model_type="llama", rope_scaling={"rope_type": "default"}),
    "mistral_window": dict(COMMON, model_type="mistral", sliding_window=4096),
    "qwen2": dict(COMMON, model_type="qwen2", rope_theta=1e6, tie_word_embeddings=True),
    "qwen3": dict(COMMON, model_type="qwen3", head_dim=16, rms_norm_eps=1e-6),
    "phi3": dict(COMMON, model_type="phi3", num_key_value_heads=4, sliding_window=2047,
                 rope_scaling=None),
    "gemma2": dict(COMMON, model_type="gemma2", head_dim=16, query_pre_attn_scalar=16,
                   final_logit_softcapping=30.0, attn_logit_softcapping=50.0,
                   sliding_window=4096),
    "gemma2_default_softcaps": dict(COMMON, model_type="gemma2", final_logit_softcapping=None,
                                    attn_logit_softcapping=None),
    "gemma3_text": dict(COMMON, model_type="gemma3_text", sliding_window=1024,
                        sliding_window_pattern=6, rope_local_base_freq=10000.0,
                        rope_scaling={"rope_type": "linear", "factor": 8.0},
                        query_pre_attn_scalar=168.0),
    "gemma3_wrapper": dict(model_type="gemma3", text_config=dict(
        COMMON, model_type="gemma3_text", sliding_window=512, rope_theta=1e6)),
    "gemma3_wrapper_with_vision": dict(
        model_type="gemma3", mm_tokens_per_image=64, image_token_index=262144,
        text_config=dict(COMMON, model_type="gemma3_text"),
        vision_config=dict(hidden_size=16, intermediate_size=32, num_hidden_layers=1,
                           num_attention_heads=2, image_size=16, patch_size=4)),
    "qwen3_vl_wrapper": dict(
        model_type="qwen3_vl", text_config=dict(
            COMMON, model_type="qwen3_vl_text",
            rope_scaling={"rope_type": "default", "mrope_section": [3, 3, 2],
                          "mrope_interleaved": True}),
        vision_config=dict(hidden_size=16, intermediate_size=32, depth=2, num_heads=2,
                           patch_size=4, spatial_merge_size=2, image_size=18,
                           out_hidden_size=32, num_position_embeddings=16,
                           deepstack_visual_indexes=[0])),
    "mixtral": dict(COMMON, model_type="mixtral", num_local_experts=4, num_experts_per_tok=2),
    "qwen3_moe": dict(COMMON, model_type="qwen3_moe", num_experts=8, num_experts_per_tok=2,
                      moe_intermediate_size=24, norm_topk_prob=True),
    "no_kv_heads_key": dict({k: v for k, v in COMMON.items() if k != "num_key_value_heads"},
                            model_type="llama"),
}

REFUSED = {
    "yarn": dict(COMMON, model_type="llama", rope_scaling={"rope_type": "yarn", "factor": 4.0}),
    "longrope": dict(COMMON, model_type="phi3",
                     rope_scaling={"type": "longrope", "short_factor": [1.0],
                                   "long_factor": [1.0]}),
    "mrope_with_yarn": dict(COMMON, model_type="qwen3_vl_text", rope_scaling={
        "rope_type": "yarn", "mrope_section": [3, 3, 2]}),
    "mrope_sectioned": dict(COMMON, model_type="qwen3_vl_text", rope_scaling={
        "mrope_section": [3, 3, 2], "mrope_interleaved": False}),
    "qwen3_moe_no_renorm": dict(COMMON, model_type="qwen3_moe", num_experts=8),
    "qwen3_moe_dense_layers": dict(COMMON, model_type="qwen3_moe", num_experts=8,
                                   norm_topk_prob=True, decoder_sparse_step=2),
    "qwen3_moe_mlp_only_layers": dict(COMMON, model_type="qwen3_moe", num_experts=8,
                                      norm_topk_prob=True, mlp_only_layers=[0]),
}


_fields = dataclasses.asdict     # nested dataclasses (VisionConfig) become dicts too


@pytest.mark.parametrize("case", list(HF_CONFIGS))
def test_from_hf_config_equals_jax(case):
    hf = HF_CONFIGS[case]
    got = tconfigs.from_hf_config(dict(hf), name=case)
    want = jconfigs.from_hf_config(dict(hf), name=case)
    assert _fields(got) == _fields(want)


@pytest.mark.parametrize("case", list(REFUSED))
def test_from_hf_config_refuses_what_jax_refuses(case):
    with pytest.raises(NotImplementedError) as jax_err:
        jconfigs.from_hf_config(dict(REFUSED[case]), name=case)
    with pytest.raises(NotImplementedError) as port_err:
        tconfigs.from_hf_config(dict(REFUSED[case]), name=case)
    assert str(port_err.value) == str(jax_err.value)


def test_from_hf_config_reads_a_path(tmp_path):
    import json

    path = tmp_path / "config.json"
    path.write_text(json.dumps(HF_CONFIGS["phi3"]))
    assert _fields(tconfigs.from_hf_config(str(path), name="p")) == _fields(
        jconfigs.from_hf_config(str(path), name="p"))


def test_every_dense_text_jax_entry_is_in_the_port_registry():
    """The reverse of test_configs_match_the_jax_registry: each JAX entry
    that has no MoE and no vision tower is in the port's registry and
    equal to it, with the same HF aliases and canonical repo id."""
    dense = {n: c for n, c in jconfigs.REGISTRY.items() if not c.is_moe and c.vision is None}
    assert {"phi-3-mini", "gemma-3-27b", "llama-3-8b", "gemma-2-9b"} <= set(dense)
    for name, jcfg in dense.items():
        assert name in tconfigs.REGISTRY, name
        assert _fields(tconfigs.REGISTRY[name]) == _fields(jcfg), name
        assert tconfigs.CANONICAL_HF_IDS.get(name) == jconfigs.CANONICAL_HF_IDS.get(name)
    for alias, name in jconfigs.ALIASES.items():
        if name in dense:
            assert tconfigs.ALIASES[alias] == name
    assert tconfigs.get_config("microsoft/Phi-3-mini-4k-instruct").head_dim == 96
    assert tconfigs.get_config("google/gemma-3-27b-it").sliding_window_pattern == 6


@pytest.mark.parametrize("ref", ["phi-3-mini", "microsoft/phi-3-mini-4k-instruct",
                                 "someone/some-model", "./local/dir", "/abs/dir", "~/dir",
                                 "not a repo", "a/b/c"])
def test_hf_repo_for_equals_jax(ref):
    assert tconfigs.hf_repo_for(ref) == jconfigs.hf_repo_for(ref)
