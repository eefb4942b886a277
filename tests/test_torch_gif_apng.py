"""The port's GIF (``engine/gif.py``, LZW in ``csrc/host/media.c``) and
APNG (``engine/images.py``) readers against PIL 12, on the CPU.

- Every frame of a PIL-written animated GIF equals PIL's ``seek(i)`` then
  ``convert("RGB")``, with PIL's ``info["duration"]``, over palette, RGB,
  grey and RGBA sources (global and local palettes, PIL's cropped frame
  rectangles), disposal 0-3 (one for all frames, or a mix), transparency,
  interlaced frames (PIL interlaces frames of 16 pixels and more) and
  zero delays; a still GIF ``image_url`` is frame 0.
- Every frame of a PIL-written APNG (RGB and RGBA) equals PIL's, with the
  duration: dispose ops none, background and previous, blend ops source
  and over (PIL's integer alpha blend), with and without a default image
  outside the animation.
- ``synth_media.encode_gif`` and ``encode_apng`` files read in PIL to the
  port's pixels and durations (disposal, transparency, rectangles, local
  palettes, interlacing; blend and dispose ops).
- Frames whose rectangles leave the logical screen grow it as PIL grows
  it (colour and grey files); a grey frame 0 followed by a frame with a
  colour table is refused.
- Truncated GIFs and LZW codes past the table raise ValueError; under
  hypothesis, mutated and truncated GIFs and APNGs only ever decode or
  raise ValueError (the C stage never crashes).
"""

import io
import struct
import zlib

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from llms_on_kubernetes_tpu_torch.engine import images
from llms_on_kubernetes_tpu_torch.engine.gif import decode_gif, decode_gif_frames, gif_frames
from llms_on_kubernetes_tpu_torch.testing import synth_media


def _pil_frames(data: bytes) -> tuple[list, list]:
    im = Image.open(io.BytesIO(data))
    frames, durations = [], []
    for i in range(im.n_frames):
        im.seek(i)
        frames.append(np.asarray(im.convert("RGB")))
        durations.append(im.info.get("duration"))
    return frames, durations


def _held(data: bytes, decode) -> None:
    want, durations = _pil_frames(data)
    n, got, got_durations = decode(data, range(len(want)))
    assert n == len(want) and got_durations == durations
    for i, w in enumerate(want):
        assert np.array_equal(got[i], w), (i, int((got[i] != w).any(axis=-1).sum()))


def _indices(n: int, w: int, h: int, colors: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    base = rng.integers(0, colors, (h, w))
    out = []
    for _ in range(n):
        f = base.copy()
        y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        f[y0:y0 + h // 3, x0:x0 + w // 3] = rng.integers(0, colors)
        out.append(f)
    return out


def _pil_gif(mode: str, disposal, transparency, optimize: bool, size) -> bytes:
    w, h = size
    rng = np.random.default_rng(zlib.crc32(repr((mode, disposal, transparency, optimize,
                                                 size)).encode()))
    pal = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    idx = _indices(5, w, h, 16, 1)
    if mode == "P":           # two palettes: local tables
        ims = []
        for k, f in enumerate(idx):
            im = Image.fromarray(f.astype(np.uint8), "P")
            im.putpalette((pal if k % 2 == 0 else pal[::-1]).tobytes())
            ims.append(im)
    elif mode == "L":
        ims = [Image.fromarray((f * 16).astype(np.uint8), "L") for f in idx]
    elif mode == "RGBA":
        ims = [Image.fromarray(np.dstack([pal[f], np.where(f == 1, 0, 255).astype(np.uint8)]),
                               "RGBA") for f in idx]
    else:
        ims = [Image.fromarray(pal[f]) for f in idx]
    kw = dict(save_all=True, append_images=ims[1:], duration=[30, 0, 100, 40, 10],
              disposal=disposal, optimize=optimize, loop=0)
    if transparency is not None and mode != "RGBA":
        kw["transparency"] = transparency
    buf = io.BytesIO()
    ims[0].save(buf, "GIF", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("size", [(20, 18), (7, 5)], ids=["interlaced", "small"])
@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("transparency", [None, 0, 3])
@pytest.mark.parametrize("disposal", [0, 1, 2, 3, [0, 2, 3, 1, 2]], ids=str)
@pytest.mark.parametrize("mode", ["P", "RGB", "L", "RGBA"])
def test_pil_gif_frames_bit_equal(mode, disposal, transparency, optimize, size):
    data = _pil_gif(mode, disposal, transparency, optimize, size)
    _held(data, decode_gif_frames)
    assert gif_frames(data)[2] == _pil_frames(data)[1]


@pytest.mark.parametrize("mode", ["P", "RGB", "L"])
def test_still_gif_is_frame_0(mode):
    data = _pil_gif(mode, 2, 3, True, (24, 17))
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert np.array_equal(decode_gif(data), want)
    assert np.array_equal(images.decode_image(data), want)


def _random_gif(seed: int, grey: bool) -> bytes:
    """A GIF of 2-4 frames whose rectangles leave a logical screen smaller
    than they are (even 0 x 0): disposal, transparency, local palettes and
    interlacing drawn at random; ``grey`` makes every table the identity
    grey one PIL reads as "L"."""
    rng = np.random.default_rng(seed)
    n, colors = int(rng.integers(2, 5)), int(rng.choice([2, 4, 16, 256]))

    def table():
        if grey:
            return np.repeat(np.arange(colors, dtype=np.uint8)[:, None], 3, axis=1)
        return rng.integers(0, 256, (colors, 3), dtype=np.uint8)

    frames = [rng.integers(0, colors, (int(rng.integers(1, 12)), int(rng.integers(1, 12))),
                           dtype=np.uint8) for _ in range(n)]
    return synth_media.encode_gif(
        frames, table(), delays=[10 * i for i in range(n)],
        disposal=[int(rng.integers(0, 4)) for _ in range(n)],
        transparency=[None if rng.random() < 0.5 else int(rng.integers(0, colors))
                      for _ in range(n)],
        rects=[(int(rng.integers(0, 8)), int(rng.integers(0, 8))) for _ in range(n)],
        local_palettes=[None if grey or rng.random() < 0.6 else table() for _ in range(n)],
        interlace=[bool(rng.random() < 0.3) for _ in range(n)],
        screen=(int(rng.integers(0, 10)), int(rng.integers(0, 10))),
        background=int(rng.integers(0, colors)))


@pytest.mark.parametrize("grey", [False, True], ids=["colour", "grey"])
@pytest.mark.parametrize("seed", range(16))
def test_frames_past_the_screen_grow_it_as_pil_does(seed, grey):
    data = _random_gif(seed, grey)
    _held(data, decode_gif_frames)
    im = Image.open(io.BytesIO(data))
    assert gif_frames(data)[:2] == im.size         # the size the server's budget reads
    assert np.array_equal(decode_gif(data), np.asarray(im.convert("RGB")))


def test_pil_gif_with_a_too_small_screen_reads_as_pil_reads_it():
    data = _pil_gif("P", [0, 2, 3, 1, 2], 3, True, (20, 18))
    small = data[:6] + struct.pack("<HH", 8, 0) + data[10:]
    _held(small, decode_gif_frames)
    want = np.asarray(Image.open(io.BytesIO(small)).convert("RGB"))
    assert np.array_equal(images.decode_image(small), want)


def test_grey_first_frame_then_a_colour_table_is_refused():
    """PIL keeps such a GIF grey and its later frames' pixels come from its
    internals (or it raises): the port refuses the frames after frame 0."""
    grey = np.repeat(np.arange(4, dtype=np.uint8)[:, None], 3, axis=1)
    frames = [np.zeros((4, 4), np.uint8), np.ones((4, 4), np.uint8)]
    data = synth_media.encode_gif(frames, grey, local_palettes=[None, grey[::-1]])
    assert np.array_equal(decode_gif(data), np.asarray(Image.open(io.BytesIO(data))
                                                        .convert("RGB")))
    with pytest.raises(ValueError, match="first frame is grey"):
        decode_gif_frames(data, [1])


def _pil_apng(mode: str, disposal, blend, default_image: bool) -> bytes:
    rng = np.random.default_rng(zlib.crc32(repr((mode, disposal, blend,
                                                 default_image)).encode()))
    w, h = 13, 11
    ims = []
    for i in range(5):
        a = rng.integers(0, 256, (h, w, 4 if mode == "RGBA" else 3), dtype=np.uint8)
        if mode == "RGBA":
            a[..., 3] = rng.choice([0, 128, 255, 37], (h, w))
        if i % 2:
            a[:5, :6] = a[0, 0]       # a frame PIL crops to its changed rectangle
        ims.append(Image.fromarray(a, mode))
    buf = io.BytesIO()
    ims[0].save(buf, "PNG", save_all=True, append_images=ims[1:],
                duration=[40, 0, 100, 33, 10], disposal=disposal, blend=blend,
                default_image=default_image)
    return buf.getvalue()


@pytest.mark.parametrize("default_image", [False, True])
@pytest.mark.parametrize("blend", [0, 1, [1, 0, 1, 1, 0]], ids=str)
@pytest.mark.parametrize("disposal", [0, 1, 2, [0, 2, 1, 2, 0]], ids=str)
@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_pil_apng_frames_bit_equal(mode, disposal, blend, default_image):
    data = _pil_apng(mode, disposal, blend, default_image)
    _held(data, images.decode_apng_frames)
    W, H, n, durations = images.apng_frames(data)
    assert (W, H, n) == (13, 11, Image.open(io.BytesIO(data)).n_frames)
    assert images.video_frames(data) == (W, H, n, durations)


def test_apng_image_url_is_its_default_image():
    data = _pil_apng("RGBA", 1, 1, True)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert np.array_equal(images.decode_image(data), want)


# ---------------------------------------------------------------------------
# the writers the card uses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["plain", "disposal", "rects_local_interlaced", "two_colours"])
def test_gif_writer_files_read_in_pil_to_the_ports_pixels(case):
    rng = np.random.default_rng(5)
    pal = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    if case == "two_colours":
        frames = [rng.integers(0, 2, (9, 11), dtype=np.uint8) for _ in range(3)]
        data = synth_media.encode_gif(frames, pal[:2], delays=[20, 30, 40])
    elif case == "rects_local_interlaced":
        frames = [rng.integers(0, 256, (30, 40), dtype=np.uint8),
                  rng.integers(0, 16, (10, 12), dtype=np.uint8),
                  rng.integers(0, 256, (17, 21), dtype=np.uint8)]
        data = synth_media.encode_gif(frames, pal, delays=[100, 0, 70],
                                      rects=[(0, 0), (5, 7), (19, 13)],
                                      local_palettes=[None, pal[:16][::-1], None],
                                      interlace=[False, True, True], transparency=[None, 2, 9],
                                      disposal=[1, 3, 2])
    else:
        frames = [rng.integers(0, 256, (30, 40), dtype=np.uint8) for _ in range(4)]
        kw = (dict(disposal=[0, 2, 3, 1], transparency=[None, 5, 7, None])
              if case == "disposal" else {})
        data = synth_media.encode_gif(frames, pal, delays=[100, 50, 0, 70], **kw)
    _held(data, decode_gif_frames)


@pytest.mark.parametrize("channels", [3, 4])
def test_apng_writer_files_read_in_pil_to_the_ports_pixels(channels):
    rng = np.random.default_rng(6)
    frames = [rng.integers(0, 256, (9, 12, channels), dtype=np.uint8) for _ in range(4)]
    frames[1] = frames[1][:4, :5]
    data = synth_media.encode_apng(frames, delays=[50, 20, 70, 0], dispose=[0, 2, 1, 0],
                                   blend=[0, 1, 1, 0], rects=[(0, 0), (3, 2), (0, 0), (0, 0)])
    _held(data, images.decode_apng_frames)
    assert np.array_equal(images.decode_image(data), _pil_frames(data)[0][0])


# ---------------------------------------------------------------------------
# truncation, corruption
# ---------------------------------------------------------------------------

def test_truncated_gif_raises_value_error():
    data = _pil_gif("P", 0, None, False, (20, 18))
    for keep in (0.5, 0.8, 0.95):
        with pytest.raises(ValueError):
            decode_gif_frames(data[:int(len(data) * keep)], range(5))


def test_lzw_code_past_the_table_raises_value_error():
    frames = [np.arange(16, dtype=np.uint8).reshape(4, 4)]
    data = bytearray(synth_media.encode_gif(frames, np.zeros((16, 3), np.uint8)))
    start = data.index(b"\x2c") + 10                  # descriptor, then the code size
    assert data[start] == 4
    data[start + 2] = 0x10                            # 5-bit codes: clear (16), then 24,
    data[start + 3] = 0x03                            # which no table holds yet
    with pytest.raises(ValueError, match="LZW"):
        decode_gif(bytes(data))


FUZZ_BASES = {
    "gif": synth_media.encode_gif(
        [np.random.default_rng(i).integers(0, 8, (6, 7), dtype=np.uint8) for i in range(3)],
        np.random.default_rng(9).integers(0, 256, (8, 3), dtype=np.uint8),
        disposal=[2, 3, 1], transparency=[None, 1, 2]),
    "pil_gif": _pil_gif("P", [0, 2, 3, 1, 2], 3, True, (20, 18)),
    "apng": synth_media.encode_apng(
        [np.random.default_rng(i).integers(0, 256, (5, 6, 4), dtype=np.uint8)
         for i in range(3)], dispose=[1, 2, 0], blend=[0, 1, 1]),
}


@pytest.mark.parametrize("base", sorted(FUZZ_BASES))
@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(data=st.data())
def test_mutated_files_decode_or_raise_value_error(base, data):
    raw = bytearray(FUZZ_BASES[base])
    for _ in range(data.draw(st.integers(1, 6))):
        op = data.draw(st.sampled_from(["flip", "set", "insert", "cut"]))
        i = data.draw(st.integers(0, len(raw) - 1))
        if op == "flip":
            raw[i] ^= 1 << data.draw(st.integers(0, 7))
        elif op == "set":
            raw[i] = data.draw(st.sampled_from([0x00, 0xFF, 0x21, 0x2C, 0x3B, 0x80]))
        elif op == "insert":
            raw[i:i] = bytes(data.draw(st.lists(st.integers(0, 255), max_size=8)))
        else:
            del raw[i:]
        if len(raw) < 8:
            break
    try:
        frames = images.decode_video_frames(bytes(raw), range(4))
    except ValueError:
        return
    assert all(f.dtype == np.uint8 and f.ndim == 3 for f in frames.values())
