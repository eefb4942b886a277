"""The port's vision towers and multimodal ops against the JAX package, on
the CPU in float32, from the JAX ``init_*_params`` weights and numpy-seeded
inputs.

- SigLIP (``debug-mm``) and Qwen3-VL (``debug-qwen-mm``, two grids)
  tower outputs and Qwen3-VL's DeepStack taps: atol = rtol = 1e-5
  (float32 on both sides; einsum and softmax orders differ).
- ``apply_mrope``: 1e-6 against JAX; equal to ``apply_rope`` when the
  three axes are equal. ``qwen_mrope_positions``: exactly.
- The plain prefill attention with ``mm_groups`` against the JAX
  ``prefill_attention`` (window and global, one and two images): 1e-5;
  ``mm_spans`` gives each image position its run.
- The registry's ``debug-mm`` / ``debug-qwen-mm`` and ``from_hf_config``
  of both wrappers (the published gemma-3-27b-it and Qwen3-VL-30B-A3B
  ``config.json`` values, and small ones) equal the JAX configs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llms_on_kubernetes_tpu import configs as jconfigs
from llms_on_kubernetes_tpu.models import vision as jvision
from llms_on_kubernetes_tpu.ops import attention as jattn
from llms_on_kubernetes_tpu.ops import rope as jrope
from llms_on_kubernetes_tpu_torch import configs as tconfigs
from llms_on_kubernetes_tpu_torch.engine.weights import params_from_numpy
from llms_on_kubernetes_tpu_torch.models import vision as tvision
from llms_on_kubernetes_tpu_torch.ops import attention as tattn
from llms_on_kubernetes_tpu_torch.ops import rope as trope
from llms_on_kubernetes_tpu_torch.ops.flash_attention import mm_spans

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    return {k: (v if not isinstance(v, dict) else dict(v)) for k, v in d.items()}


def test_siglip_tower_matches_jax():
    cfg = jconfigs.get_config("debug-mm")
    v = cfg.vision
    jp = jvision.init_vision_params(v, cfg.hidden_size, jax.random.PRNGKey(1))
    px = np.random.default_rng(0).standard_normal((2, v.image_size, v.image_size, 3)).astype(
        np.float32)
    want = np.asarray(jvision.encode_images(jp, v, jnp.asarray(px)))
    tv = tconfigs.get_config("debug-mm").vision
    got, deep = tvision.vision_encode(params_from_numpy(_np(jp), device="cpu"), tv,
                                      torch.from_numpy(px))
    assert deep is None and got.shape == (2, v.mm_tokens_per_image, cfg.hidden_size)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("hw", [(16, 16), (8, 32), (32, 8)])
def test_qwen3vl_tower_and_deepstack_match_jax(hw):
    cfg = jconfigs.get_config("debug-qwen-mm")
    v = cfg.vision
    jp = jvision.init_qwen3vl_vision_params(v, jax.random.PRNGKey(2))
    px = np.random.default_rng(hw[0]).standard_normal((1, *hw, 3)).astype(np.float32)
    soft, deep = jvision.encode_images_qwen3vl(jp, v, jnp.asarray(px))
    tv = tconfigs.get_config("debug-qwen-mm").vision
    tsoft, tdeep = tvision.vision_encode(params_from_numpy(_np(jp), device="cpu"), tv,
                                         torch.from_numpy(px))
    np.testing.assert_allclose(tsoft.numpy(), np.asarray(soft), **TOL)
    assert tdeep.shape == deep.shape
    np.testing.assert_allclose(tdeep.numpy(), np.asarray(deep), **TOL)


def test_init_params_shapes_equal_jax():
    for name in ("debug-mm", "debug-qwen-mm"):
        cfg = jconfigs.get_config(name)
        tcfg = tconfigs.get_config(name)
        if cfg.vision.family == "qwen3vl":
            jp = jvision.init_qwen3vl_vision_params(cfg.vision, jax.random.PRNGKey(0))
            tp = tvision.init_qwen3vl_vision_params(tcfg.vision, torch.Generator().manual_seed(0),
                                                    device="cpu")
        else:
            jp = jvision.init_vision_params(cfg.vision, cfg.hidden_size, jax.random.PRNGKey(0))
            tp = tvision.init_vision_params(tcfg.vision, tcfg.hidden_size,
                                            torch.Generator().manual_seed(0), device="cpu")
        jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
        tshapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), tp)
        assert jshapes == tshapes


@pytest.mark.parametrize("section", [(3, 3, 2), (24, 20, 20)])
def test_apply_mrope_matches_jax(section):
    hd = 16 if section == (3, 3, 2) else 128
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 9, 4, hd)).astype(np.float32)
    k = rng.standard_normal((2, 9, 2, hd)).astype(np.float32)
    pos3 = rng.integers(0, 50, (2, 3, 9)).astype(np.int32)
    inv = jrope.rope_frequencies(hd, 5e6)
    jq, jk = jrope.apply_mrope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos3),
                               jnp.asarray(inv), section)
    tq, tk = trope.apply_mrope(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(pos3),
                               torch.from_numpy(trope.rope_frequencies(hd, 5e6)), section)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-6, atol=1e-6)
    # equal axes: exactly apply_rope
    same = np.repeat(pos3[:, :1], 3, axis=1)
    inv_t = torch.from_numpy(trope.rope_frequencies(hd, 5e6))
    mq, mk = trope.apply_mrope(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(same),
                               inv_t, section)
    rq, rk = trope.apply_rope(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(same[:, 0]), inv_t)
    assert torch.equal(mq, rq) and torch.equal(mk, rk)


@pytest.mark.parametrize("grids", [None, [(2, 2), (1, 4)]])
def test_qwen_mrope_positions_equal_jax(grids):
    img = 260
    prompt = [1, 2, 258] + [img] * 4 + [259, 5, 258] + [img] * 4 + [259, 7]
    # generated tokens past the prompt stay text, an image id among them too
    for toks, plen in ((prompt, None), (prompt + [img, 8], len(prompt))):
        want = jvision.qwen_mrope_positions(toks, img, 4, prompt_len=plen, grids=grids)
        got = tvision.qwen_mrope_positions(toks, img, 4, prompt_len=plen, grids=grids)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]


def _groups(T, runs):
    g = np.full((1, T), -1, np.int32)
    for i, (s, n) in enumerate(runs):
        g[0, s:s + n] = i
    return g


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("runs", [[(2, 4)], [(1, 4), (7, 4)]])
def test_mm_groups_mask_matches_jax(window, runs):
    rng = np.random.default_rng(4)
    T = 14
    q = rng.standard_normal((1, T, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, T, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, T, 2, 16)).astype(np.float32)
    lengths = np.array([12], np.int32)
    g = _groups(T, runs)
    want = jattn.prefill_attention(*(jnp.asarray(a) for a in (q, k, v, lengths)), scale=0.25,
                                   sliding_window=window, mm_groups=jnp.asarray(g))
    got = tattn.prefill_attention(*(torch.from_numpy(a) for a in (q, k, v, lengths)),
                                  scale=0.25, sliding_window=window,
                                  mm_groups=torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy()[:, :12], np.asarray(want)[:, :12], **TOL)
    lo, hi = mm_spans(torch.from_numpy(g))
    for i, (s, n) in enumerate(runs):
        assert (lo[0, s:s + n] == s).all() and (hi[0, s:s + n] == s + n).all()
    assert ((lo == 0) & (hi == 0))[torch.from_numpy(g) < 0].all()


def test_registry_mm_entries_equal_jax():
    for name in ("debug-mm", "debug-qwen-mm"):
        assert _fields(tconfigs.get_config(name)) == _fields(jconfigs.get_config(name))


@pytest.mark.parametrize("repo", sorted(tconfigs.PUBLISHED_MM_CONFIGS))
def test_from_hf_config_published_wrappers_equal_jax(repo):
    hf = tconfigs.PUBLISHED_MM_CONFIGS[repo]
    t, j = tconfigs.from_hf_config(hf, repo), jconfigs.from_hf_config(hf, repo)
    assert _fields(t) == _fields(j)
    if t.vision.family == "qwen3vl":
        assert (t.num_layers, t.hidden_size, t.intermediate_size, t.num_experts,
                t.num_experts_per_tok, t.mrope_section) == (48, 2048, 768, 128, 8, (24, 20, 20))
        assert (t.vision.num_layers, t.vision.image_size, t.vision.mm_tokens_per_image,
                t.vision.deepstack_indexes) == (27, 768, 576, (8, 16, 24))
    else:
        text = dataclasses.replace(t, name="gemma-3-27b", vision=None, image_token_id=None,
                                   boi_token_id=None, eoi_token_id=None)
        assert _fields(text) == _fields(tconfigs.get_config("gemma-3-27b"))
        assert (t.vision.num_layers, t.vision.hidden_size, t.vision.image_size,
                t.vision.patch_size, t.vision.mm_tokens_per_image) == (27, 1152, 896, 14, 256)
