"""The port's JPEG reader (``engine/jpeg.py`` over the C entropy stage in
``csrc/host/media.c``) against PIL 12 with libjpeg-turbo, on the CPU.

- Bit-equal to ``Image.open(...).convert("RGB")`` (``L`` for grey) over a
  PIL-written corpus: qualities 10, 50, 95 and 100; 4:4:4, 4:2:2 and 4:2:0
  (and 4:4:0, which PIL does not write: ``synth_media``'s writer); grey;
  baseline and progressive; ``optimize=True``; restart intervals (in
  blocks and in rows); odd sizes (1 x 1, 17 x 9, 1,601 x 1,199); 16-bit
  quantization tables; an RGB (Adobe transform 0) file.
- ``synth_media.encode_jpeg``'s files (4:4:4, 4:2:2, 4:2:0, 4:4:0, grey,
  restart intervals) read in PIL to the port's pixels.
- Refused with a ValueError naming it: lossless, arithmetic and
  hierarchical frames, 12-bit samples, CMYK, 4 x 1 sampling, a header over
  ``MAX_IMAGE_PIXELS`` (before any entropy decoding, allocating little).
- Huffman tables that over-subscribe their codes (DC and AC, tables 0
  and 3, at lengths 1, 8 and 9), a scan naming a component the frame
  lacks and a coefficient past index 63 raise ValueError; the C stage
  refuses such a table on its own as well.
- Truncated files raise ValueError where PIL raises OSError; under
  hypothesis, mutated and truncated files only ever decode or raise
  ValueError (the C stage never crashes).
- The host library is built from the repo's source into ``_build/``; with
  no compiler, or a failed build, decoding raises with the compiler's
  output (there is no Python fallback).
"""

import ctypes
import io
import struct
import tracemalloc

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from llms_on_kubernetes_tpu_torch import kernels
from llms_on_kubernetes_tpu_torch.engine import images
from llms_on_kubernetes_tpu_torch.engine.jpeg import MAX_IMAGE_PIXELS, decode_jpeg
from llms_on_kubernetes_tpu_torch.testing import synth_media


def _picture(w: int, h: int, seed: int = 0) -> np.ndarray:
    """Gradients, edges and noise: every coefficient band gets used."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                     ((x // 5 + y // 3) % 2) * 200], axis=-1)
    return np.clip(base + rng.integers(-40, 41, (h, w, 3)), 0, 255).astype(np.uint8)


def _pil_jpeg(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil_pixels(data: bytes) -> np.ndarray:
    im = Image.open(io.BytesIO(data))
    return np.asarray(im if im.mode == "L" else im.convert("RGB"))


def _same(data: bytes) -> None:
    got, want = decode_jpeg(data), _pil_pixels(data)
    assert got.shape == want.shape
    assert np.array_equal(got, want), int((got != want).sum())


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("quality", [10, 50, 95, 100])
@pytest.mark.parametrize("size", [(1, 1), (17, 9), (64, 48), (33, 70)])
def test_pil_corpus_bit_equal(size, quality, subsampling, progressive):
    img = _picture(*size, seed=quality + subsampling)
    _same(_pil_jpeg(img, quality=quality, subsampling=subsampling, progressive=progressive))


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("size", [(1, 1), (17, 9), (64, 48)])
def test_grey_bit_equal(size, progressive):
    img = _picture(*size)[..., 1]
    data = _pil_jpeg(img, quality=80, progressive=progressive)
    assert decode_jpeg(data).ndim == 2
    _same(data)
    assert np.array_equal(images.decode_image(data),
                          np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


@pytest.mark.parametrize("opts", [
    dict(optimize=True), dict(optimize=True, progressive=True, subsampling=1),
    dict(restart_marker_blocks=1), dict(restart_marker_blocks=7, subsampling=2),
    dict(restart_marker_rows=1, progressive=True), dict(keep_rgb=True),
    dict(qtables=[[300] * 64, [2] * 64]), dict(qtables=[list(range(1, 65)) * 1, [900] * 64],
                                               progressive=True),
], ids=["optimize", "optimize_progressive", "restart_1", "restart_7", "restart_rows_progressive",
        "adobe_rgb", "dqt16", "dqt16_progressive"])
def test_pil_options_bit_equal(opts):
    for size in ((17, 9), (64, 48)):
        _same(_pil_jpeg(_picture(*size, seed=3), **opts))


@pytest.mark.parametrize("opts", [dict(subsampling=2, quality=90), dict(progressive=True)])
def test_large_odd_size_bit_equal(opts):
    _same(_pil_jpeg(_picture(1601, 1199, seed=9), **opts))


def test_decode_image_sniffs_jpeg():
    data = _pil_jpeg(_picture(30, 20), quality=70)
    assert np.array_equal(images.decode_image(data), _pil_pixels(data))


# ---------------------------------------------------------------------------
# the writer the card uses
# ---------------------------------------------------------------------------

def test_writer_tables_are_libjpegs():
    """The writer's Huffman tables are the ones libjpeg writes by default."""
    d = _pil_jpeg(_picture(16, 16), quality=75)
    tables, i = {}, 0
    while (i := d.find(b"\xff\xc4", i)) >= 0:
        n = struct.unpack(">H", d[i + 2:i + 4])[0]
        seg, j = d[i + 4:i + 2 + n], 0
        while j < len(seg):
            k = sum(seg[j + 1:j + 17])
            tables[seg[j]] = (list(seg[j + 1:j + 17]), list(seg[j + 17:j + 17 + k]))
            j += 17 + k
        i += 2
    for key, table in ((0x00, synth_media.DC_LUMA), (0x10, synth_media.AC_LUMA),
                       (0x01, synth_media.DC_CHROMA), (0x11, synth_media.AC_CHROMA)):
        assert tables[key] == (list(table[0]), list(table[1]))


@pytest.mark.parametrize("restart", [0, 1, 5])
@pytest.mark.parametrize("subsampling", ["444", "422", "420", "440", "grey"])
@pytest.mark.parametrize("size", [(1, 1), (17, 9), (64, 48)])
def test_writer_files_read_in_pil_to_the_ports_pixels(size, subsampling, restart):
    img = _picture(*size, seed=7)
    if subsampling == "grey":
        data = synth_media.encode_jpeg(img[..., 0], 85, restart=restart)
    else:
        data = synth_media.encode_jpeg(img, 85, subsampling, restart=restart)
    _same(data)


def test_writer_writes_the_picture():
    """Up to the coding loss: a smooth picture comes back within a few levels."""
    y, x = np.mgrid[0:48, 0:64]
    img = np.stack([x * 4, y * 5, (x + y) * 2], axis=-1).astype(np.uint8)
    for sub in ("444", "420"):
        got = decode_jpeg(synth_media.encode_jpeg(img, 95, sub)).astype(int)
        assert np.abs(got - img).mean() < 2


# ---------------------------------------------------------------------------
# refusals, truncation, corruption
# ---------------------------------------------------------------------------

def _sof_at(data: bytes) -> int:
    return next(i for i in range(len(data) - 1)
                if data[i] == 0xFF and data[i + 1] in (0xC0, 0xC1, 0xC2))


def _patched(data: bytes, offset: int, value: bytes) -> bytes:
    return data[:offset] + value + data[offset + len(value):]


@pytest.mark.parametrize("case,what", [
    ("lossless", "lossless"), ("arithmetic", "arithmetic"), ("hierarchical", "hierarchical"),
    ("twelve_bit", "12-bit"), ("cmyk", "4-component"), ("sampling_4x1", "sampling factors 4x1"),
])
def test_unsupported_jpegs_are_refused(case, what):
    base = _pil_jpeg(_picture(32, 16), quality=80)
    s = _sof_at(base)
    if case == "cmyk":
        buf = io.BytesIO()
        Image.fromarray(_picture(32, 16)).convert("CMYK").save(buf, "JPEG")
        data = buf.getvalue()
    elif case in ("lossless", "arithmetic", "hierarchical"):
        data = _patched(base, s + 1, bytes([{"lossless": 0xC3, "arithmetic": 0xC9,
                                             "hierarchical": 0xC5}[case]]))
    elif case == "twelve_bit":
        data = _patched(base, s + 4, b"\x0c")
    else:
        data = _patched(base, s + 11, b"\x41")      # the first component's h, v
    with pytest.raises(ValueError, match="unsupported image") as e:
        decode_jpeg(data)
    assert what in str(e.value)


def test_oversized_header_is_refused_before_decoding():
    base = _pil_jpeg(_picture(32, 16), quality=80)
    data = _patched(base, _sof_at(base) + 5, struct.pack(">HH", 20_000, 20_000))
    tracemalloc.start()
    try:
        with pytest.raises(ValueError, match=str(MAX_IMAGE_PIXELS)):
            decode_jpeg(data)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 4 << 20, peak


def _bad_huffman_counts(length: int) -> list:
    """Code lengths that over-subscribe ``length``: one code at each shorter
    length, then three at it (the second and third past its all-ones code)."""
    counts = [0] * 16
    for i in range(length - 1):
        counts[i] = 1
    counts[length - 1] = 3
    return counts


def _with_bad_table(cls: int, table: int, length: int) -> bytes:
    """A grey baseline file whose scan decodes with an over-subscribed DC
    (``cls`` 0) or AC (1) table ``table``."""
    base = _pil_jpeg(_picture(8, 8)[..., 0], quality=80)
    counts = _bad_huffman_counts(length)
    dht = bytes([cls << 4 | table]) + bytes(counts) + bytes(range(sum(counts)))
    sos = base.index(b"\xff\xda")
    seg = b"\xff\xc4" + struct.pack(">H", 2 + len(dht)) + dht
    data = bytearray(base[:sos] + seg + base[sos:])
    data[sos + len(seg) + 6] = table << 4 if cls == 0 else table   # the scan's selectors
    return bytes(data)


@pytest.mark.parametrize("table", [0, 3])
@pytest.mark.parametrize("cls", [0, 1], ids=["dc", "ac"])
@pytest.mark.parametrize("length", [1, 8, 9])
def test_oversubscribed_huffman_table_raises_value_error(length, cls, table):
    data = _with_bad_table(cls, table, length)
    with pytest.raises(OSError):
        Image.open(io.BytesIO(data)).load()
    with pytest.raises(ValueError, match="over-subscribes"):
        decode_jpeg(data)


@pytest.mark.parametrize("table", [0, 3])
@pytest.mark.parametrize("cls", [0, 1], ids=["dc", "ac"])
@pytest.mark.parametrize("length", [1, 8, 9])
def test_entropy_stage_refuses_an_oversubscribed_table_itself(length, cls, table):
    """The C stage checks a table before it fills any lookup entry from it,
    whatever the Python side checked first."""
    scan = kernels.host_function("llmk_jpeg_scan")
    tables = np.zeros(8 * 272, np.uint8)
    for t in range(8):                         # every table: one code of length 1
        tables[272 * t] = 1
    bad = 272 * (4 * cls + table)
    counts = _bad_huffman_counts(length)
    tables[bad:bad + 16] = counts
    tables[bad + 16:bad + 16 + sum(counts)] = np.arange(sum(counts))
    present = np.ones(8, np.int32)
    info = np.array([[1, 1, 1, 1, table, table, 1, 1]], np.int32)
    plane = np.zeros(64, np.int16)
    planes = (ctypes.c_void_p * 1)(plane.ctypes.data)
    data = b"\x00" * 64 + b"\xff\xd9"
    p = ctypes.c_int64(0)
    err = scan(data, len(data), ctypes.byref(p), 1, info.ctypes.data, planes,
               tables.ctypes.data, present.ctypes.data, 1, 1, 0, 63, 0, 0, 0, 0)
    assert err == -2


def test_scan_naming_a_missing_component_raises_value_error():
    base = _pil_jpeg(_picture(8, 8)[..., 0], quality=80)
    data = bytearray(base)
    data[base.index(b"\xff\xda") + 5] = 99            # the scan's component id
    with pytest.raises(OSError):
        Image.open(io.BytesIO(bytes(data))).load()
    with pytest.raises(ValueError, match="names component 99"):
        decode_jpeg(bytes(data))


def test_coefficient_index_past_63_raises_value_error():
    """A hand-made 8 x 8 grey file whose only AC symbol is ZRL-with-a-value
    (run 15, size 1): the fourth one puts a coefficient at index 64."""
    def seg(marker: int, payload: bytes) -> bytes:
        return bytes([0xFF, marker]) + struct.pack(">H", 2 + len(payload)) + payload

    one_code = bytes([1] + [0] * 15)
    data = (b"\xff\xd8" + seg(0xDB, b"\x00" + b"\x01" * 64)
            + seg(0xC0, b"\x08\x00\x08\x00\x08\x01\x01\x11\x00")
            + seg(0xC4, b"\x00" + one_code + b"\x00")
            + seg(0xC4, b"\x10" + one_code + b"\xf1")
            + seg(0xDA, b"\x01\x01\x00\x00\x3f\x00") + b"\x00\x00" + b"\xff\xd9")
    with pytest.raises(ValueError, match="past index 63"):
        decode_jpeg(data)


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("keep", [0.3, 0.6, 0.9, 0.999])
def test_truncated_files_raise_value_error_as_pil_raises(keep, progressive):
    data = _pil_jpeg(_picture(64, 48), quality=90, progressive=progressive)
    cut = data[:int(len(data) * keep)]
    with pytest.raises(OSError):
        Image.open(io.BytesIO(cut)).load()
    with pytest.raises(ValueError):
        decode_jpeg(cut)


FUZZ_BASES = {
    "baseline": _pil_jpeg(_picture(24, 16, 1), quality=60, subsampling=2),
    "progressive": _pil_jpeg(_picture(24, 16, 2), quality=60, progressive=True),
    "restart": _pil_jpeg(_picture(24, 16, 3), quality=60, restart_marker_blocks=1),
}


@pytest.mark.parametrize("base", sorted(FUZZ_BASES))
@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(data=st.data())
def test_mutated_files_decode_or_raise_value_error(base, data):
    """Byte flips, insertions and truncations anywhere: the C stage never
    reads past its buffers or crashes; every failure is a ValueError."""
    raw = bytearray(FUZZ_BASES[base])
    for _ in range(data.draw(st.integers(1, 6))):
        op = data.draw(st.sampled_from(["flip", "set", "insert", "cut"]))
        i = data.draw(st.integers(0, len(raw) - 1))
        if op == "flip":
            raw[i] ^= 1 << data.draw(st.integers(0, 7))
        elif op == "set":
            raw[i] = data.draw(st.sampled_from([0x00, 0xFF, 0xD0, 0xD9, 0xC4, 0x7F]))
        elif op == "insert":
            raw[i:i] = bytes(data.draw(st.lists(st.integers(0, 255), max_size=8)))
        else:
            del raw[i:]
        if len(raw) < 4:
            break
    try:
        out = images.decode_image(bytes(raw))
    except ValueError:
        return
    assert out.dtype == np.uint8 and out.ndim == 3


# ---------------------------------------------------------------------------
# the host build
# ---------------------------------------------------------------------------

def test_host_library_builds_from_the_repos_source():
    path = kernels.build_host("media")
    assert path.parent == kernels.BUILD_DIR and path.exists()
    assert path.name.startswith("host-media-")
    assert (kernels.HOST_CSRC / "media.c").exists()


@pytest.mark.parametrize("case", ["no_compiler", "failed_build"])
def test_no_compiler_or_a_failed_build_raises(case, tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(kernels, "_host_funcs", {})
    if case == "no_compiler":
        for var in ("CC", "CXX"):
            monkeypatch.delenv(var, raising=False)
        monkeypatch.setenv("PATH", str(tmp_path))
        match = "no host C compiler"
    else:
        bad = tmp_path / "badcc"
        bad.write_text("#!/bin/sh\necho 'media.c: error: this compiler refuses'\nexit 3\n")
        bad.chmod(0o755)
        monkeypatch.setenv("CC", str(bad))
        match = "this compiler refuses"
    with pytest.raises(RuntimeError, match=match):
        decode_jpeg(_pil_jpeg(_picture(8, 8)))
