"""The port's multimodal path against the JAX package, on the CPU in float32.

- ``forward_prefill_mm`` logits for both families (gemma-3's image blocks
  through ``mm_groups``, Qwen3-VL's mrope and DeepStack), then decode steps
  after the image (Qwen3-VL with ``pos_delta``): the decoder tests' 1e-4.
- Greedy engine streams equal to the JAX engine's, token for token, on
  ``debug-mm`` and ``debug-qwen-mm`` (sync and async scheduling): an image
  request beside text ones; a second submission whose prefix hit covers
  the image (the remainder runs the chunk path, with the mrope delta); a
  hit that stops before the last image token (rolled back: a full
  multimodal prefill); two images in one request; a preempted image
  request's resume.
- Synthetic multimodal checkpoints (gemma-3 in both namings, Qwen3-VL)
  load to equal parameters through both loaders, tower included, and
  their ``config.json`` reads back to the config.
- The server: a PNG ``image_url`` answers with the soft tokens counted in
  ``usage.prompt_tokens``; a CMYK JPEG, a remote URL, an undecodable
  ``video_url``, an image on a text model and more images than
  ``max_images_per_request`` answer 400; the engine refuses malformed
  image prompts.
"""

import base64
import dataclasses
import io
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llms_on_kubernetes_tpu.configs import from_hf_config as j_from_hf_config
from llms_on_kubernetes_tpu.configs import get_config as jget_config
from llms_on_kubernetes_tpu.engine.cache import CacheConfig as JCacheConfig
from llms_on_kubernetes_tpu.engine.cache import init_pages as j_init_pages
from llms_on_kubernetes_tpu.engine.engine import Engine as JEngine
from llms_on_kubernetes_tpu.engine.engine import EngineConfig as JEngineConfig
from llms_on_kubernetes_tpu.engine.engine import SamplingParams as JSamplingParams
from llms_on_kubernetes_tpu.engine.weights import load_hf_params as j_load_hf_params
from llms_on_kubernetes_tpu.models import decoder as jdec
from llms_on_kubernetes_tpu.models import vision as jvision
from llms_on_kubernetes_tpu_torch.configs import from_hf_config, get_config
from llms_on_kubernetes_tpu_torch.engine.cache import CacheConfig, init_pages
from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
from llms_on_kubernetes_tpu_torch.engine.weights import load_hf_params, params_from_numpy
from llms_on_kubernetes_tpu_torch.models import decoder as tdec
from llms_on_kubernetes_tpu_torch.models import vision as tvision
from llms_on_kubernetes_tpu_torch.server.openai_api import OpenAIServer
from llms_on_kubernetes_tpu_torch.testing import synth_checkpoint as sc

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
MODELS = ("debug-mm", "debug-qwen-mm")


def _run_of(cfg):
    return [cfg.boi_token_id] + [cfg.image_token_id] * cfg.vision.mm_tokens_per_image + [
        cfg.eoi_token_id]


def _pixels(cfg, seed, hw=None):
    v = cfg.vision
    hw = hw or (v.image_size, v.image_size)
    return np.random.default_rng(seed).standard_normal((*hw, 3)).astype(np.float32)


@pytest.fixture(scope="module", params=MODELS)
def weights(request):
    jcfg = jget_config(request.param)
    jp = jdec.init_params(jcfg, jax.random.key(0), dtype="float32")
    return request.param, jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                                device="cpu")


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------

def test_prefill_mm_and_decode_after_match_jax(weights):
    name, jp, tp = weights
    jcfg, tcfg = jget_config(name), get_config(name)
    T, pps, page = 24, 8, 4
    run = _run_of(jcfg)
    prompt = [1, 2] + run + [40, 41] + run + [42]
    n = len(prompt)
    tokens = np.zeros((1, T), np.int32)
    tokens[0, :n] = prompt
    lengths = np.array([n], np.int32)
    table = np.arange(1, pps + 1, dtype=np.int32)[None]
    kw = dict(num_layers=jcfg.num_layers, num_kv_heads=jcfg.num_kv_heads,
              head_dim=jcfg.head_dim, num_pages=16, page_size=page, pages_per_slot=pps,
              dtype="float32")
    jk, jv = j_init_pages(JCacheConfig(**kw))
    tk, tv = init_pages(CacheConfig(**kw), device="cpu")
    px = np.stack([_pixels(jcfg, 1), _pixels(jcfg, 2)])
    qwen = jcfg.vision.family == "qwen3vl"
    if qwen:
        soft, deep = jvision.encode_images_qwen3vl(jp["vision"], jcfg.vision, jnp.asarray(px))
        deep = deep.reshape(deep.shape[0], 1, -1, deep.shape[-1])
        p3, delta = jvision.qwen_mrope_positions(prompt, jcfg.image_token_id,
                                                 jcfg.vision.mm_tokens_per_image)
        pos3 = np.zeros((1, 3, T), np.int32)
        pos3[0, :, :n] = p3
    else:
        soft = jvision.encode_images(jp["vision"], jcfg.vision, jnp.asarray(px))
        deep, pos3, delta = None, None, 0
    jlog, jk, jv = jdec.forward_prefill_mm(
        jp, jcfg, jnp.asarray(tokens), jnp.asarray(lengths), jk, jv, jnp.asarray(table),
        soft[None], deepstack=deep, pos3=None if pos3 is None else jnp.asarray(pos3),
        prompt_len=jnp.asarray(lengths))
    tsoft, tdeep = tvision.vision_encode(tp["vision"], tcfg.vision, torch.from_numpy(px))
    if qwen:
        tdeep = tdeep.reshape(tdeep.shape[0], 1, -1, tdeep.shape[-1])
    tlog, _, _ = tdec.forward_prefill_mm(
        tp, tcfg, torch.from_numpy(tokens), torch.from_numpy(lengths), tk, tv,
        torch.from_numpy(table), tsoft[None], deepstack=tdeep,
        pos3=None if pos3 is None else torch.from_numpy(pos3),
        prompt_len=torch.from_numpy(lengths))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
    lens = lengths.copy()
    d = np.array([delta], np.int32)
    for tok in (7, 9, 11):
        lens = lens + 1
        toks = np.array([tok], np.int32)
        jlog, jk, jv = jdec.forward_decode(jp, jcfg, jnp.asarray(toks), jnp.asarray(lens), jk, jv,
                                           jnp.asarray(table),
                                           pos_delta=jnp.asarray(d) if qwen else None)
        tlog, _, _ = tdec.forward_decode(tp, tcfg, torch.from_numpy(toks), torch.from_numpy(lens),
                                         tk, tv, torch.from_numpy(table),
                                         pos_delta=torch.from_numpy(d) if qwen else None)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)


# ---------------------------------------------------------------------------
# the engine, stream for stream beside the JAX engine
# ---------------------------------------------------------------------------

SMALL = dict(dtype="float32", max_decode_slots=2, page_size=8, num_pages=64, pages_per_slot=8,
             prefill_buckets=(64,))


def _engines(weights, **kw):
    name, jp, tp = weights
    cfg = {**SMALL, **kw, "model": name}
    return (JEngine(JEngineConfig(**cfg), params=jp),
            Engine(EngineConfig(**cfg, device="cpu"), params=tp))


def _drain(eng, reqs):
    steps = 0
    while not all(r.finished for r in reqs):
        eng.step()
        steps += 1
        assert steps < 10_000
    return [list(r.output) for r in reqs]


def _scenario(eng, S, jobs, sequential=False):
    """``jobs``: (prompt, images or None, max_tokens); all submitted at
    once, or one after the other's finish."""
    outs = []
    reqs = []
    for prompt, imgs, n in jobs:
        r = eng.submit(list(prompt), S(temperature=0.0, max_tokens=n), images=imgs)
        if sequential:
            outs += _drain(eng, [r])
        else:
            reqs.append(r)
    return outs + _drain(eng, reqs)


@pytest.mark.parametrize("async_scheduling", [True, False])
def test_image_request_beside_text_equals_jax(weights, async_scheduling):
    jeng, teng = _engines(weights, async_scheduling=async_scheduling)
    cfg = jeng.model_config
    img = [_pixels(cfg, 0)]
    jobs = [([1, 2] + _run_of(cfg) + [40, 41, 42], img, 8), ([3, 4, 5, 6], None, 8),
            ([9] * 12, None, 6)]
    want = _scenario(jeng, JSamplingParams, jobs)
    assert _scenario(teng, SamplingParams, jobs) == want
    assert teng.mm_prefill_calls == 1 and teng.images_encoded == 1


def test_prefix_hits_equal_jax(weights):
    jeng, teng = _engines(weights)
    cfg = jeng.model_config
    img = [_pixels(cfg, 3)]
    run = _run_of(cfg)
    covering = [1, 2] + run + list(range(40, 52))     # pages 0-1 hold the image
    late = list(range(60, 69)) + run + [70, 71]       # the first page stops before it
    other = list(range(60, 68)) + [99] + run + [72]
    jobs = [(covering, img, 6), (covering, img, 6), (late, img, 5), (other, img, 5)]
    want = _scenario(jeng, JSamplingParams, jobs, sequential=True)
    assert _scenario(teng, SamplingParams, jobs, sequential=True) == want
    # the second covering request hit the image's pages and ran the chunk
    # path; the request sharing only a text page before the image prefilled
    # its images again
    assert teng.chunk_calls == 1
    assert teng.mm_prefill_calls == 3


def test_two_images_in_one_request_equal_jax(weights):
    jeng, teng = _engines(weights)
    cfg = jeng.model_config
    run = _run_of(cfg)
    jobs = [([1] + run + [5, 6] + run + [7], [_pixels(cfg, 4), _pixels(cfg, 5)], 8)]
    if cfg.vision.family == "qwen3vl":     # two grids, one request
        v = cfg.vision
        jobs.append(([2] + run + [8] + run + [9],
                     [_pixels(cfg, 6, (8, 32)), _pixels(cfg, 7, (32, 8))], 8))
        assert v.patch_size * v.spatial_merge_size == 8
    want = _scenario(jeng, JSamplingParams, jobs)
    assert _scenario(teng, SamplingParams, jobs) == want


def test_preempted_image_request_resumes_as_jax(weights):
    jeng, teng = _engines(weights, num_pages=9)
    cfg = jeng.model_config
    run = _run_of(cfg)
    jobs = [([1, 2] + run + list(range(30, 42)), [_pixels(cfg, 8)], 20),
            ([3] + run + list(range(50, 62)), [_pixels(cfg, 9)], 20)]
    want = _scenario(jeng, JSamplingParams, jobs)
    assert _scenario(teng, SamplingParams, jobs) == want
    assert jeng.preemptions > 0 and teng.preemptions > 0


def test_engine_refuses_malformed_image_prompts():
    eng = Engine(EngineConfig(model="debug-mm", **SMALL, device="cpu",
                              max_images_per_request=1))
    cfg = eng.model_config
    run = _run_of(cfg)
    S = SamplingParams(max_tokens=2)
    with pytest.raises(ValueError, match="soft tokens"):
        eng.submit([1, 2], S, images=[_pixels(cfg, 0)])
    with pytest.raises(ValueError, match="runs of exactly"):
        eng.submit([1] + run[:3] + [5] + run[3:], S, images=[_pixels(cfg, 0)])
    with pytest.raises(ValueError, match="per request"):
        eng.submit([1] + run + run, S, images=[_pixels(cfg, 0)] * 2)
    with pytest.raises(ValueError, match="must be 16x16"):
        eng.submit([1] + run, S, images=[_pixels(cfg, 0, (8, 8))])
    text = Engine(EngineConfig(model="debug-tiny", **SMALL, device="cpu"))
    with pytest.raises(ValueError, match="no vision tower"):
        text.submit([1] + run, S, images=[_pixels(cfg, 0)])


# ---------------------------------------------------------------------------
# synthetic multimodal checkpoints, both loaders
# ---------------------------------------------------------------------------

def _gemma_mm():
    mm = get_config("debug-mm")
    return dataclasses.replace(get_config("debug-gemma"), name="debug-gemma-mm", vocab_size=300,
                               vision=mm.vision, image_token_id=mm.image_token_id,
                               boi_token_id=mm.boi_token_id, eoi_token_id=mm.eoi_token_id)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("case", ["gemma-nested", "gemma-legacy", "qwen"])
def test_synthetic_mm_checkpoint_loads_as_jax(tmp_path, case):
    cfg = get_config("debug-qwen-mm") if case == "qwen" else _gemma_mm()
    naming = "legacy" if case == "gemma-legacy" else "nested"
    sc.write_checkpoint(cfg, str(tmp_path), dtype="float32", naming=naming)
    path = str(tmp_path / "config.json")
    tcfg = from_hf_config(path, name=cfg.name)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    got = load_hf_params(tcfg, str(tmp_path), device="cpu", dtype="float32")
    want = j_load_hf_params(j_from_hf_config(path, name=cfg.name), str(tmp_path),
                            dtype="float32")
    got_l, want_l = dict(_leaves(got)), dict(_leaves(jax.tree_util.tree_map(np.asarray, want)))
    assert sorted(got_l) == sorted(want_l)
    assert any(k.startswith("/vision/") for k in got_l)
    for k, t in got_l.items():
        assert np.array_equal(t.numpy(), want_l[k]), k


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

class MMTokenizer:
    """Bytes, and an image part as the model's begin-of-image id (the
    server splices the soft-token run)."""

    def __init__(self, boi):
        self.boi = boi

    def encode(self, text):
        return list(text.encode())

    def decode(self, ids):
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", errors="replace")

    def apply_chat_template(self, messages, tools=None):
        ids = [257]
        for m in messages:
            content = m.get("content", "")
            for part in (content if isinstance(content, list) else [{"text": content}]):
                ids += [self.boi] if part.get("type") == "image" else self.encode(
                    part.get("text", ""))
        return ids

    @property
    def eos_ids(self):
        return {256}


def _data_url(fmt="PNG", mode="RGB"):
    from PIL import Image

    buf = io.BytesIO()
    Image.new(mode, (20, 12), (120, 30, 200)).save(buf, fmt)
    return f"data:image/{fmt.lower()};base64," + base64.b64encode(buf.getvalue()).decode()


@pytest.fixture(scope="module")
def mm_server():
    eng = Engine(EngineConfig(model="debug-mm", **SMALL, device="cpu", max_images_per_request=1))
    server = OpenAIServer(eng, MMTokenizer(eng.model_config.boi_token_id), "debug-mm")
    port = server.start("127.0.0.1", 0)
    yield f"http://127.0.0.1:{port}"
    server.close()


def _post(base, body):
    req = urllib.request.Request(base + "/v1/chat/completions", data=json.dumps(body).encode(),
                                 method="POST", headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _image_msg(url, kind="image_url"):
    return {"model": "debug-mm", "max_tokens": 4, "temperature": 0,
            "messages": [{"role": "user", "content": [
                {"type": "text", "text": "look: "}, {"type": kind, kind: {"url": url}},
                {"type": "text", "text": " describe"}]}]}


def test_server_answers_png_image_url(mm_server):
    status, raw = _post(mm_server, _image_msg(_data_url()))
    assert status == 200, raw
    doc = json.loads(raw)
    # BOS + "look: " + [boi, 4 soft tokens, eoi] + " describe"
    assert doc["usage"]["prompt_tokens"] == 1 + 6 + 6 + 9
    body = dict(_image_msg(_data_url()), stream=True)
    status, raw = _post(mm_server, body)
    assert status == 200 and raw.decode().rstrip().endswith("data: [DONE]")


@pytest.mark.parametrize("case", ["jpeg", "remote", "video", "two_images", "bad_base64",
                                  "two_jpegs"])
def test_server_answers_400(mm_server, case):
    if case == "jpeg":          # a CMYK JPEG: JPEG the port does not read
        body = _image_msg(_data_url("JPEG", "CMYK"))
    elif case == "remote":
        body = _image_msg("http://example.invalid/x.png")
    elif case == "video":
        body = _image_msg("data:video/mp4;base64,AAAA", kind="video_url")
    elif case == "bad_base64":
        body = _image_msg("data:image/png;base64,@@@@")
    else:       # over --max-images-per-request 1: counted before any is decoded
        url = _data_url("JPEG" if case == "two_jpegs" else "PNG")
        body = _image_msg(url)
        body["messages"][0]["content"].append({"type": "image_url", "image_url": {"url": url}})
    status, raw = _post(mm_server, body)
    assert status == 400, raw
    msg = json.loads(raw)["error"]["message"]
    expect = {"jpeg": "4-component", "remote": "data: URL", "video": "undecodable",
              "two_images": "per request", "bad_base64": "undecodable",
              "two_jpegs": "per request"}[case]
    assert expect in msg


def test_image_on_a_text_model_is_400():
    eng = Engine(EngineConfig(model="debug-tiny", **SMALL, device="cpu"))
    server = OpenAIServer(eng, MMTokenizer(258), "debug-tiny")
    try:
        base = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
        status, raw = _post(base, _image_msg(_data_url()))
        assert status == 400 and "does not accept images" in json.loads(raw)["error"]["message"]
    finally:
        server.close()
