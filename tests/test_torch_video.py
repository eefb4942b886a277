"""The port's ``video_url`` path against the JAX package, on the CPU.

- ``openai_api.extract_video`` (what to keep, and when) followed by
  ``images.decode_video_frames`` gives the frames and the per-temporal-
  patch timestamps the JAX ``OpenAIServer._extract_video`` gives (called
  on a stub that carries ``engine.model_config.vision``), exactly, for
  PIL-written animated GIFs (disposal, transparency, local palettes,
  interlacing, zero, tiny and huge delays) and APNGs, and still PNG, JPEG
  and GIF files, under several ``LLMK_MAX_VIDEO_FRAMES``; the frame-count
  and pixel limits answer with the JAX texts, before any frame is decoded.
- Each frame preprocessed on the Qwen grid equals the JAX preprocessing.
- ``encode_video_qwen3vl`` equals JAX's on ``debug-qwen-mm`` in float32
  (soft tokens and DeepStack), at ``test_torch_vision.py``'s 1e-5.
- A video chat (and a video beside an image) through the port's
  ``chat_prompt`` gives the JAX server's prompt ids and pixels, and the
  port engine's greedy stream equals the JAX engine's, a second
  submission through its prefix hit too; the HTTP server answers it with
  the soft tokens counted.
- Refusals: video on a SigLIP tower (server and engine), an odd frame
  count, a video on a text model, more blocks than
  ``max_images_per_request``.
"""

import base64
import io
import json
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from llms_on_kubernetes_tpu.configs import get_config as jget_config
from llms_on_kubernetes_tpu.engine.engine import Engine as JEngine
from llms_on_kubernetes_tpu.engine.engine import EngineConfig as JEngineConfig
from llms_on_kubernetes_tpu.engine.engine import SamplingParams as JSamplingParams
from llms_on_kubernetes_tpu.models import decoder as jdec
from llms_on_kubernetes_tpu.models import vision as jvision
from llms_on_kubernetes_tpu.server.openai_api import OpenAIServer as JOpenAIServer
from llms_on_kubernetes_tpu_torch.configs import get_config
from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig, SamplingParams
from llms_on_kubernetes_tpu_torch.engine.images import (
    decode_video_frames, preprocess_image_qwen3vl,
)
from llms_on_kubernetes_tpu_torch.engine.weights import params_from_numpy
from llms_on_kubernetes_tpu_torch.models import vision as tvision
from llms_on_kubernetes_tpu_torch.server.openai_api import BadRequest, OpenAIServer, extract_video
from test_torch_multimodal import MMTokenizer

TOL = dict(rtol=1e-5, atol=1e-5)
SMALL = dict(dtype="float32", max_decode_slots=2, page_size=8, num_pages=64, pages_per_slot=8,
             prefill_buckets=(64,))


def _jax_video(model: str, part: dict):
    """The JAX ``_extract_video`` on a stub that carries only what it reads."""
    s = types.SimpleNamespace(engine=types.SimpleNamespace(model_config=jget_config(model)),
                              model_name=model)
    s._decode_data_url = lambda url, what: JOpenAIServer._decode_data_url(s, url, what)
    return JOpenAIServer._extract_video(s, part)


def _video(model: str, part: dict):
    return extract_video(part, get_config(model).vision, model)


def _frames(n: int, w: int, h: int, seed: int, alpha: bool = False):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w, 4 if alpha else 3), dtype=np.uint8)
    out = []
    for i in range(n):
        f = base.copy()
        y, x = (i * 3) % h, (i * 5) % w
        f[y:y + h // 3, x:x + w // 3] = rng.integers(0, 256, 4 if alpha else 3)
        if alpha:
            f[..., 3] = np.where((np.arange(w)[None, :] + i) % 3 == 0, 0, 255)
        out.append(f)
    return out


def _media(kind: str) -> bytes:
    buf = io.BytesIO()
    if kind in ("gif13", "gif3", "gif_disposal"):
        n = {"gif13": 13, "gif3": 3, "gif_disposal": 6}[kind]
        pal = np.random.default_rng(1).integers(0, 256, (16, 3), dtype=np.uint8)
        idx = [np.random.default_rng(i).integers(0, 16, (18, 24)) for i in range(n)]
        ims = []
        for i, f in enumerate(idx):
            im = Image.fromarray(f.astype(np.uint8), "P")
            im.putpalette((pal if i % 2 == 0 else pal[::-1]).tobytes())
            ims.append(im)
        durations = [0, 5, 20_000, 100, 40, 70, 10, 30, 50, 0, 90, 60, 20][:n]
        kw = dict(disposal=[0, 2, 3, 1, 2, 3][:n], transparency=3) if kind == "gif_disposal" else {}
        ims[0].save(buf, "GIF", save_all=True, append_images=ims[1:], duration=durations,
                    loop=0, **kw)
    elif kind == "apng":
        ims = [Image.fromarray(f, "RGBA") for f in _frames(5, 20, 14, 2, alpha=True)]
        ims[0].save(buf, "PNG", save_all=True, append_images=ims[1:],
                    duration=[40, 0, 100, 33, 10], disposal=[0, 2, 1, 2, 0], blend=[0, 1, 1, 0, 1])
    elif kind == "apng_default":     # the IDAT outside the animation: no duration
        ims = [Image.fromarray(f) for f in _frames(4, 16, 16, 3)]
        ims[0].save(buf, "PNG", save_all=True, append_images=ims[1:], duration=25,
                    default_image=True)
    else:
        fmt = {"png": "PNG", "jpeg": "JPEG", "gif_still": "GIF"}[kind]
        Image.fromarray(_frames(1, 21, 13, 4)[0]).save(buf, fmt)
    return buf.getvalue()


def _part(data: bytes) -> dict:
    return {"type": "video_url",
            "video_url": {"url": "data:video/x;base64," + base64.b64encode(data).decode()}}


KINDS = ["gif13", "gif3", "gif_disposal", "apng", "apng_default", "png", "jpeg", "gif_still"]


@pytest.mark.parametrize("cap", [None, "3", "2", "16"])
@pytest.mark.parametrize("kind", KINDS)
def test_video_frames_and_times_equal_jax(kind, cap, monkeypatch):
    if cap is not None:
        monkeypatch.setenv("LLMK_MAX_VIDEO_FRAMES", cap)
    part = _part(_media(kind))
    jframes, jts = _jax_video("debug-qwen-mm", part)
    raw, idx, ts = _video("debug-qwen-mm", part)
    assert ts == jts
    assert len(idx) == len(jframes) and len(idx) % 2 == 0
    frames = decode_video_frames(raw, idx)
    for i, jf in zip(idx, jframes):
        assert np.array_equal(frames[i], np.asarray(jf.convert("RGB")))
    tv, jv = get_config("debug-qwen-mm").vision, jget_config("debug-qwen-mm").vision
    got = np.stack([preprocess_image_qwen3vl(frames[i], tv) for i in idx])
    want = np.stack([jvision.preprocess_image_qwen3vl(f, jv) for f in jframes])
    assert np.array_equal(got, want)


@pytest.mark.parametrize("env", [("LLMK_MAX_VIDEO_INPUT_FRAMES", "12"),
                                 ("LLMK_MAX_VIDEO_PIXELS", "5000")])
def test_video_limits_answer_as_jax(env, monkeypatch):
    monkeypatch.setenv(*env)
    part = _part(_media("gif13"))
    with pytest.raises(ValueError) as j:
        _jax_video("debug-qwen-mm", part)
    with pytest.raises(BadRequest) as t:
        _video("debug-qwen-mm", part)
    assert str(t.value) == str(j.value)


def test_video_on_a_text_model_answers_as_jax():
    part = _part(_media("gif3"))
    with pytest.raises(ValueError) as j:
        _jax_video("debug-tiny", part)
    with pytest.raises(BadRequest) as t:
        _video("debug-tiny", part)
    assert str(t.value) == str(j.value)


@pytest.mark.parametrize("shape", [(4, 16, 16), (2, 8, 32), (6, 32, 8)])
def test_encode_video_matches_jax(shape):
    cfg = jget_config("debug-qwen-mm")
    v = cfg.vision
    jp = jvision.init_qwen3vl_vision_params(v, jax.random.PRNGKey(3))
    px = np.random.default_rng(shape[0]).standard_normal((*shape, 3)).astype(np.float32)
    soft, deep = jvision.encode_video_qwen3vl(jp, v, jnp.asarray(px))
    tv = get_config("debug-qwen-mm").vision
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    tsoft, tdeep = tvision.vision_encode(tp, tv, torch.from_numpy(px), video=True)
    assert tsoft.shape == soft.shape == (shape[0] // 2, v.mm_tokens_per_image,
                                         v.out_hidden_size)
    np.testing.assert_allclose(tsoft.numpy(), np.asarray(soft), **TOL)
    np.testing.assert_allclose(tdeep.numpy(), np.asarray(deep), **TOL)
    # a temporal patch of one frame repeated is that frame as an image
    still = np.repeat(px[:1], 2, axis=0)
    one, _ = tvision.vision_encode(tp, tv, torch.from_numpy(still), video=True)
    img, _ = tvision.vision_encode(tp, tv, torch.from_numpy(px[:1]))
    np.testing.assert_allclose(one.numpy(), img.numpy(), **TOL)


# ---------------------------------------------------------------------------
# the chat path, against the JAX server's prompt and the JAX engine's stream
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen_engines():
    jcfg = jget_config("debug-qwen-mm")
    jp = jdec.init_params(jcfg, jax.random.key(0), dtype="float32")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    cfg = {**SMALL, "model": "debug-qwen-mm", "num_pages": 80, "pages_per_slot": 32,
           "prefill_buckets": (256,)}     # the timestamps' text makes long prompts
    jeng = JEngine(JEngineConfig(**cfg), params=jp)
    teng = Engine(EngineConfig(**cfg, device="cpu"), params=tp)
    tok = MMTokenizer(teng.model_config.boi_token_id)
    return jeng, teng, tok


def _body(*parts, max_tokens=8):
    return {"model": "debug-qwen-mm", "max_tokens": max_tokens, "temperature": 0,
            "messages": [{"role": "user", "content": [
                {"type": "text", "text": "watch: "}, *parts, {"type": "text", "text": " ok"}]}]}


def _image_part(seed: int) -> dict:
    buf = io.BytesIO()
    Image.fromarray(_frames(1, 30, 12, seed)[0]).save(buf, "JPEG", quality=90)
    return {"type": "image_url",
            "image_url": {"url": "data:image/jpeg;base64," + base64.b64encode(
                buf.getvalue()).decode()}}


def _jax_prompt(jeng, tok, body):
    """The JAX server's chat prompt and pixels (its ``chat_completions``
    up to ``_serve``)."""
    jsrv = JOpenAIServer(jeng, tok, "debug-qwen-mm")
    messages, media = jsrv._extract_images(body["messages"])
    vis = jeng.model_config.vision
    ids = tok.apply_chat_template(messages)
    n_blocks = sum(len(e[1]) // vis.temporal_patch_size if isinstance(e, tuple) else 1
                   for e in media)
    ids = jsrv._splice_image_tokens(ids, n_blocks)
    pixels = [np.stack([jvision.preprocess_image_qwen3vl(f, vis) for f in e[1]])
              if isinstance(e, tuple) else jvision.preprocess_image_qwen3vl(e, vis)
              for e in media]
    return ids, pixels


def _drain(eng, req):
    steps = 0
    while not req.finished:
        eng.step()
        steps += 1
        assert steps < 10_000
    return list(req.output)


@pytest.mark.parametrize("case", ["gif", "apng", "video_and_image"])
def test_video_chat_equals_jax(qwen_engines, case):
    jeng, teng, tok = qwen_engines
    if case == "gif":
        body = _body(_part(_media("gif3")))
    elif case == "apng":
        body = _body(_part(_media("apng")))
    else:
        body = _body(_image_part(5), {"type": "text", "text": " then "},
                     _part(_media("apng_default")))
    jids, jpix = _jax_prompt(jeng, tok, body)
    tsrv = OpenAIServer(teng, tok, "debug-qwen-mm")
    ids, _tools, _grammar, pix = tsrv.chat_prompt(body)
    assert ids == jids
    assert len(pix) == len(jpix) and all(np.array_equal(a, b) for a, b in zip(pix, jpix))
    want = _drain(jeng, jeng.submit(jids, JSamplingParams(temperature=0.0, max_tokens=8),
                                    images=jpix))
    got = _drain(teng, teng.submit(ids, SamplingParams(temperature=0.0, max_tokens=8),
                                   images=pix))
    assert got == want


def test_video_prefix_hit_equals_jax(qwen_engines):
    """The same video request twice: the second adopts the first's pages
    (salted with the frames' hash), which cover every video block, and
    runs the chunk path with the mrope delta; both streams equal JAX's."""
    jeng, teng, tok = qwen_engines
    # a video no other test sends, and text after it past a page, so the
    # hit (whole pages) covers every video block
    body = _body(_part(_media("gif_disposal")), {"type": "text", "text": " and then?" * 4},
                 max_tokens=6)
    jids, jpix = _jax_prompt(jeng, tok, body)
    ids, _t, _g, pix = OpenAIServer(teng, tok, "debug-qwen-mm").chat_prompt(body)
    c0 = teng.chunk_calls
    for _ in range(2):
        want = _drain(jeng, jeng.submit(jids, JSamplingParams(temperature=0.0, max_tokens=6),
                                        images=jpix))
        got = _drain(teng, teng.submit(ids, SamplingParams(temperature=0.0, max_tokens=6),
                                       images=pix))
        assert got == want
    assert teng.chunk_calls - c0 == 1


def test_video_chat_over_http(qwen_engines):
    _jeng, teng, tok = qwen_engines
    srv = OpenAIServer(teng, tok, "debug-qwen-mm")
    try:
        base = f"http://127.0.0.1:{srv.start('127.0.0.1', 0)}"
        body = _body(_part(_media("gif13")), max_tokens=3)
        req = urllib.request.Request(base + "/v1/chat/completions",
                                     data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            doc = json.loads(r.read())
        ids = srv.chat_prompt(body)[0]
        assert doc["usage"]["prompt_tokens"] == len(ids)
        # 13 frames -> 8 sampled -> 4 temporal patches, each a run of soft tokens
        v = teng.model_config.vision
        assert ids.count(teng.model_config.image_token_id) == 4 * v.mm_tokens_per_image
    finally:
        srv.close()


def test_video_refusals():
    eng = Engine(EngineConfig(model="debug-mm", **SMALL, device="cpu"))
    srv = OpenAIServer(eng, MMTokenizer(eng.model_config.boi_token_id), "debug-mm")
    with pytest.raises(BadRequest, match="does not accept video input"):
        srv.chat_prompt(_body(_part(_media("gif3"))))
    cfg = eng.model_config
    run = [cfg.boi_token_id] + [cfg.image_token_id] * cfg.vision.mm_tokens_per_image + [
        cfg.eoi_token_id]
    frames = np.zeros((2, 16, 16, 3), np.float32)
    with pytest.raises(ValueError, match="does not accept video input"):
        eng.submit([1] + run, SamplingParams(max_tokens=2), images=[frames])
    qeng = Engine(EngineConfig(model="debug-qwen-mm", **SMALL, device="cpu",
                               max_images_per_request=2))
    qcfg = qeng.model_config
    qrun = [qcfg.boi_token_id] + [qcfg.image_token_id] * qcfg.vision.mm_tokens_per_image + [
        qcfg.eoi_token_id]
    with pytest.raises(ValueError, match="positive multiple of 2"):
        qeng.submit([1] + qrun, SamplingParams(max_tokens=2),
                    images=[np.zeros((3, 16, 16, 3), np.float32)])
    with pytest.raises(ValueError, match="per request"):
        qeng.submit([1] + qrun * 3, SamplingParams(max_tokens=2),
                    images=[np.zeros((6, 16, 16, 3), np.float32)])
    qsrv = OpenAIServer(qeng, MMTokenizer(qcfg.boi_token_id), "debug-qwen-mm")
    with pytest.raises(BadRequest, match="per request"):     # 13 frames -> 4 blocks > 2
        qsrv.chat_prompt(_body(_part(_media("gif13"))))
