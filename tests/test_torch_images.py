"""The port's image reader against PIL and the JAX preprocessing, on the CPU.

- ``decode_png`` is bit-equal to PIL's ``Image.open(...).convert("RGB")``
  for every supported colour type (L, LA, RGB, RGBA, palette), under
  PIL's adaptive filtering, with no compression and with ``optimize``,
  and for hand-built files that hold each of the five row filters alone.
- ``resize_bicubic`` is bit-equal to PIL's BICUBIC resize, shrinking and
  growing, square and not.
- ``preprocess_image`` / ``preprocess_image_qwen3vl`` (and the grid
  choice) equal the JAX functions, which use PIL, exactly.
- Everything the port does not read (CMYK JPEG, a GIF whose frame grows
  its screen past ``MAX_IMAGE_PIXELS``, WebP, 16-bit, interlaced, a bad
  CRC) raises ValueError from ``decode_image`` naming it.
- A header over ``MAX_IMAGE_PIXELS`` and image data that inflates past
  what its header declares (a zlib bomb) raise ValueError having
  allocated under 4 MB (``tracemalloc``, which sees numpy's buffers).

PIL is imported here only; the port never imports it
(tests/test_torch_imports.py).
"""

import io
import struct
import tracemalloc
import zlib

import numpy as np
import pytest
from PIL import Image

from llms_on_kubernetes_tpu.configs import get_config as jget_config
from llms_on_kubernetes_tpu.models import vision as jvision
from llms_on_kubernetes_tpu_torch.configs import get_config
from llms_on_kubernetes_tpu_torch.engine import images
from llms_on_kubernetes_tpu_torch.testing import synth_media

MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}


def _encode(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG", **kw)
    return buf.getvalue()


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _picture(rng, h, w, c):
    """Noise below a smooth ramp: PIL's adaptive filter picks several
    filters over it."""
    a = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    a[: h // 2] = (np.arange(w)[None, :, None] * 5 + np.arange(c)[None, None, :] * 40) % 256
    return a


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("opts", ["default", "optimize", "stored"])
def test_decode_png_equals_pil(mode, opts):
    rng = np.random.default_rng(len(mode))
    a = _picture(rng, 29, 41, MODES[mode])
    img = Image.fromarray(a[..., 0] if mode == "L" else a, mode)
    kw = {"default": {}, "optimize": {"optimize": True}, "stored": {"compress_level": 0}}[opts]
    data = _encode(img, **kw)
    assert np.array_equal(images.decode_png(data), _pil_rgb(data))


def test_decode_palette_png_equals_pil():
    rng = np.random.default_rng(5)
    img = Image.fromarray(_picture(rng, 23, 31, 3)).quantize(64)
    data = _encode(img)
    assert Image.open(io.BytesIO(data)).mode == "P"
    assert np.array_equal(images.decode_png(data), _pil_rgb(data))


def _png(rows: np.ndarray, ctype: int, filt: int, interlace=0, depth=8) -> bytes:
    """A PNG whose every row uses filter ``filt`` (encoded here)."""
    H, W, C = rows.shape
    raw = rows.reshape(H, W * C).astype(np.int32)
    prev = np.zeros(W * C, np.int32)
    out = bytearray()
    for y in range(H):
        cur = raw[y]
        left = np.concatenate([np.zeros(C, np.int32), cur[:-C]])
        upleft = np.concatenate([np.zeros(C, np.int32), prev[:-C]])
        if filt == 0:
            f = cur
        elif filt == 1:
            f = cur - left
        elif filt == 2:
            f = cur - prev
        elif filt == 3:
            f = cur - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            f = cur - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(filt)
        out += (f & 255).astype(np.uint8).tobytes()
        prev = cur

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))
    ihdr = struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, interlace)
    return (images.PNG_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("filt", range(5))
@pytest.mark.parametrize("ctype", [0, 2, 6])
def test_each_row_filter_equals_pil(filt, ctype):
    C = {0: 1, 2: 3, 6: 4}[ctype]
    rng = np.random.default_rng(filt * 7 + ctype)
    data = _png(_picture(rng, 13, 17, C), ctype, filt)
    assert np.array_equal(images.decode_png(data), _pil_rgb(data))


@pytest.mark.parametrize("shape,size", [((29, 41), (16, 16)), ((16, 16), (45, 37)),
                                        ((100, 80), (33, 97)), ((300, 200), (224, 224)),
                                        ((64, 96), (64, 96)), ((7, 5), (96, 128))])
def test_resize_bicubic_equals_pil(shape, size):
    rng = np.random.default_rng(shape[0])
    a = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(a).resize(size, Image.Resampling.BICUBIC))
    assert np.array_equal(images.resize_bicubic(a, *size), want)


def test_preprocess_image_equals_jax():
    rng = np.random.default_rng(1)
    for shape in ((20, 20, 3), (31, 17, 4), (9, 40)):
        a = rng.integers(0, 256, shape, dtype=np.uint8)
        assert np.array_equal(images.preprocess_image(a, 16), jvision.preprocess_image(a, 16))


@pytest.mark.parametrize("size", [(20, 20), (40, 10), (10, 37), (64, 16)])
def test_qwen_preprocess_and_grids_equal_jax(size):
    w, h = size
    tv, jv = get_config("debug-qwen-mm").vision, jget_config("debug-qwen-mm").vision
    assert images.qwen_grid_candidates(tv) == jvision.qwen_grid_candidates(jv)
    assert images.select_qwen_grid(w, h, tv) == jvision.select_qwen_grid(w, h, jv)
    a = np.random.default_rng(w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    got = images.preprocess_image_qwen3vl(a, tv)
    assert np.array_equal(got, jvision.preprocess_image_qwen3vl(a, jv))


def _other(kind: str) -> bytes:
    a = np.random.default_rng(0).integers(0, 256, (12, 12, 3), dtype=np.uint8)
    img = Image.fromarray(a)
    if kind == "png16":
        buf = io.BytesIO()
        Image.fromarray(a[..., 0].astype(np.uint16) * 257).save(buf, "PNG")
        return buf.getvalue()
    if kind == "interlaced":
        return _png(a, 2, 0, interlace=1)
    if kind == "bad_crc":
        data = bytearray(_encode(img))
        data[40] ^= 0xFF
        return bytes(data)
    buf = io.BytesIO()
    if kind == "jpeg":          # CMYK: JPEG the port does not read
        img.convert("CMYK").save(buf, "JPEG")
        return buf.getvalue()
    if kind == "gif":           # a frame that grows the screen past MAX_IMAGE_PIXELS
        return synth_media.encode_gif([a[..., 0] % 16], a[:16, 0], rects=[(60_000, 60_000)])
    img.save(buf, "WEBP")
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["jpeg", "gif", "webp", "png16", "interlaced", "bad_crc"])
def test_unsupported_input_raises_value_error(kind):
    """What ``decode_image`` does not read raises ValueError naming it (and,
    but for a GIF too large and a bad CRC, the formats the port reads)."""
    with pytest.raises(ValueError) as e:
        images.decode_image(_other(kind))
    assert {"jpeg": "4-component", "gif": str(images.MAX_IMAGE_PIXELS), "webp": "WebP",
            "png16": "16-bit", "interlaced": "interlaced", "bad_crc": "CRC"}[kind] in str(e.value)
    if kind not in ("bad_crc", "gif"):
        assert "PNG" in str(e.value) and "JPEG" in str(e.value)



def _rgb_png(W: int, H: int, idat: bytes) -> bytes:
    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))
    return (images.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", idat) + chunk(b"IEND", b""))


def _zeros_stream(n: int) -> bytes:
    """A zlib stream of n zero bytes, compressed a megabyte at a time."""
    z = zlib.compressobj(9)
    mb = bytes(1 << 20)
    return b"".join(z.compress(mb[:min(1 << 20, n - i)]) for i in range(0, n, 1 << 20)) + z.flush()


@pytest.mark.parametrize("case", ["oversized_header", "zlib_bomb", "one_byte_over"])
def test_oversized_images_raise_without_allocating(case):
    W, H = (20_000, 20_000) if case == "oversized_header" else (16, 16)
    size = H * (3 * W + 1)          # filter byte + RGB row, all zeros: filter None
    data = _rgb_png(W, H, _zeros_stream(size + 1 if case == "one_byte_over" else 64 << 20))
    tracemalloc.start()
    try:
        with pytest.raises(ValueError) as e:
            images.decode_png(data)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 4 << 20, peak
    assert ("pixels" if case == "oversized_header" else "more than its header") in str(e.value)
    # the same header over exactly its bytes decodes
    if case != "oversized_header":
        assert not images.decode_png(_rgb_png(W, H, _zeros_stream(size))).any()
