"""Image decoding and preprocessing for the vision path, without PIL
(counterpart of what ``llms_on_kubernetes_tpu/server/openai_api.py`` and
``llms_on_kubernetes_tpu/models/vision.py`` ask of PIL).

The card's machine has no PIL, so the port reads images itself:

- ``decode_image``: the one entry point for an ``image_url``; it sniffs
  the magic bytes and sends PNG to ``decode_png``, JPEG to
  ``engine/jpeg.py`` and GIF (frame 0) to ``engine/gif.py``. Anything
  else (WebP among them) raises ``ValueError`` naming what the port
  reads (``FORMATS``).
- ``decode_png``: PNG with ``zlib`` and numpy, 8 bits a sample, not
  interlaced, colour types greyscale, greyscale + alpha, RGB, RGBA and
  palette, all five row filters; an APNG's default image (its IDAT), as
  PIL's ``open`` gives it. A chunk whose CRC does not match, 16-bit or
  interlaced data raise ``ValueError``. The result is converted to RGB as
  PIL's ``convert("RGB")`` does: alpha dropped, grey repeated, the palette
  looked up.
- ``decode_apng_frames``: every frame of an 8-bit RGB or RGBA APNG
  (acTL, fcTL, fdAT) composited as PIL 12 composites it: dispose ops
  none, background (zeros) and previous, blend ops source and over, the
  latter libImaging's integer alpha mix (``_div255``) on all four
  channels; each frame's duration as PIL's ``info["duration"]``.
- ``video_frames`` / ``decode_video_frames``: a ``video_url``'s frame
  count and durations without decoding (GIF, APNG; a still image is one
  frame), then only the wanted frames, every earlier one composited.
- Size: a header of more than ``MAX_IMAGE_PIXELS`` pixels (PIL's
  ``Image.MAX_IMAGE_PIXELS``, above which PIL warns of a decompression
  bomb) is refused before anything is inflated, and the image data is
  inflated to at most the bytes the header needs: a stream that holds
  more is refused. Decoding an accepted image takes a few copies of its
  own size and no more.
- Row filters: None, Sub and Up rows are reconstructed a whole row at a
  time (Sub is a running sum modulo 256). Average and Paeth read the
  reconstructed left neighbour, so they cannot run a row as one vector;
  an image holding such rows is reconstructed along anti-diagonals
  instead (pixel (y, x) depends on (y, x - 1), (y - 1, x) and
  (y - 1, x - 1) only, so every pixel of one diagonal is ready at once):
  W + H - 1 steps of a few vector operations, in place, on the image
  padded with a zero row and column. A row of that copy is W + 1 pixels
  long, so one diagonal is a strided slice of it (step W pixels), and
  its three neighbours are the same slice shifted.
- ``resize_bicubic``: PIL's ``Image.resize(..., BICUBIC)`` on 8-bit RGB,
  byte for byte: the cubic of ``a = -0.5`` with its support widened by
  the scale when shrinking, the coefficients normalised and rounded to
  22-bit fixed point as ``libImaging/Resample.c`` rounds them, a
  horizontal pass, then a vertical pass, each rounding and clipping to
  uint8.
- ``preprocess_image`` (SigLIP, gemma-3) and ``preprocess_image_qwen3vl``
  (Qwen3-VL's aspect-closest grid of a fixed patch budget), with
  ``qwen_grid_candidates`` and ``select_qwen_grid``: the JAX functions of
  the same names on top of the two above.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np

FORMATS = ("PNG: 8-bit greyscale, greyscale+alpha, RGB, RGBA or palette, not interlaced "
           "(APNG: RGB or RGBA); JPEG: baseline, extended sequential or progressive "
           "Huffman, 8-bit, greyscale or 3-component, sampling factors 1 or 2; GIF")
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples a pixel of each colour type at 8 bits
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# PIL's Image.MAX_IMAGE_PIXELS: the most pixels a header may declare
MAX_IMAGE_PIXELS = 89_478_485
# PIL's fixed point for 8-bit resampling (libImaging/Resample.c)
PRECISION_BITS = 32 - 8 - 2


def _unsupported(why: str) -> ValueError:
    return ValueError(f"unsupported image: {why}; the server reads {FORMATS}")


def _chunks(data: bytes):
    """(type, payload) of each chunk, CRCs checked."""
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + n
        if end + 4 > len(data):
            raise ValueError("truncated PNG chunk")
        payload = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"PNG chunk {kind!r} has a bad CRC")
        yield kind, payload
        if kind == b"IEND":
            return
        pos = end + 4
    raise ValueError("PNG has no IEND chunk")


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(rows: np.ndarray, types: np.ndarray, bpp: int) -> np.ndarray:
    """None, Sub and Up rows, a whole row at a time: [H, W, bpp]."""
    H, n = rows.shape
    out = np.empty_like(rows)
    prev = np.zeros(n, np.uint8)
    for y in range(H):
        f = rows[y]
        if types[y] == 1:      # Sub: a running sum modulo 256 per channel
            f = np.cumsum(f.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif types[y] == 2:    # Up
            f = f + prev
        out[y] = f
        prev = out[y]
    return out.reshape(H, n // bpp, bpp)


def _unfilter_diagonals(rows: np.ndarray, types: np.ndarray, bpp: int) -> np.ndarray:
    """Every filter type, along anti-diagonals of pixels, in place on a
    copy padded with a zero row above and a zero column to the left
    (pixel (y, x) at flat index (y + 1) * (W + 1) + x + 1). Diagonal d's
    pixels are then the slice from (lo, d - lo) in steps of W, and its
    left, upper and upper-left neighbours the same slice shifted by 1,
    W + 1 and W + 2. Returns a [H, W, bpp] view of the copy."""
    H, n = rows.shape
    W = n // bpp
    P = W + 1
    buf = np.zeros(((H + 1) * P, bpp), np.uint8)
    buf.reshape(H + 1, P, bpp)[1:, 1:] = rows.reshape(H, W, bpp)
    masks = [(types == k).astype(np.int16)[:, None] for k in range(5)]
    # the first row past each row whose filter differs from its own
    change = np.flatnonzero(np.diff(types)) + 1
    same_until = np.append(change, H)[np.searchsorted(change, np.arange(H), side="right")]
    for d in range(H + W - 1):
        lo, hi = max(0, d - W + 1), min(H - 1, d) + 1
        s = P + 1 + d + lo * W                 # pixel (lo, d - lo)
        e = s + (hi - lo - 1) * W + 1
        a = buf[s - 1:e - 1:W].astype(np.int16)            # (y, x - 1)
        b = buf[s - P:e - P:W].astype(np.int16)            # (y - 1, x)
        if same_until[lo] >= hi:               # one filter along the diagonal
            kind = types[lo]
            if kind == 4:
                pred = _paeth(a, b, buf[s - P - 1:e - P - 1:W].astype(np.int16))
            else:
                pred = 0 if kind == 0 else a if kind == 1 else b if kind == 2 else (a + b) >> 1
        else:
            c = buf[s - P - 1:e - P - 1:W].astype(np.int16)  # (y - 1, x - 1)
            pred = (masks[1][lo:hi] * a + masks[2][lo:hi] * b
                    + masks[3][lo:hi] * ((a + b) >> 1) + masks[4][lo:hi] * _paeth(a, b, c))
        buf[s:e:W] = (buf[s:e:W] + pred) & 255
    return buf.reshape(H + 1, P, bpp)[1:, 1:]


def _inflate(data: bytes, size: int) -> bytes:
    """The first ``size`` bytes a zlib stream holds; ValueError if it holds
    fewer or more (a stream that inflates past the image is refused after
    one byte more, not inflated)."""
    z = zlib.decompressobj()
    try:
        raw = z.decompress(data, size)
        surplus = b"" if z.eof else z.decompress(z.unconsumed_tail, 1)
    except zlib.error as e:
        raise ValueError(f"PNG image data is corrupt: {e}")
    if len(raw) < size:
        raise ValueError("PNG image data is truncated")
    if surplus:
        raise ValueError("PNG image data holds more than its header declares")
    return raw


def _png_header(chunks) -> tuple:
    """(W, H, depth, colour type, interlace) from the IHDR, checked and
    refused as ``FORMATS`` says."""
    header = next((p for k, p in chunks if k == b"IHDR"), None)
    if header is None or len(header) != 13:
        raise ValueError("PNG has no IHDR chunk")
    W, H, depth, ctype, _comp, _filt, interlace = struct.unpack(">IIBBBBB", header)
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG colour type {ctype} is invalid")
    if depth != 8:
        raise _unsupported(f"{depth}-bit PNG")
    if interlace:
        raise _unsupported("interlaced PNG")
    if W == 0 or H == 0:
        raise ValueError("PNG has no pixels")
    if W * H > MAX_IMAGE_PIXELS:
        raise ValueError(f"PNG of {W}x{H} pixels is larger than the {MAX_IMAGE_PIXELS} "
                         f"pixels the server decodes")
    return W, H, depth, ctype, interlace


def _png_pixels(zdata: bytes, W: int, H: int, ctype: int) -> np.ndarray:
    """A zlib stream of filtered rows -> the samples [H, W, bpp]."""
    bpp = _CHANNELS[ctype]
    stride = W * bpp + 1
    raw = _inflate(zdata, H * stride)
    rows = np.frombuffer(raw, np.uint8).reshape(H, stride)
    types = rows[:, 0].astype(np.int32)
    if (types > 4).any():
        raise ValueError("PNG row filter type is invalid")
    rows = rows[:, 1:]
    if (types >= 3).any():
        return _unfilter_diagonals(rows, types, bpp)
    return _unfilter_rows(rows, types, bpp)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, 3] RGB (``convert("RGB")``'s bytes); an
    APNG gives its default image (the IDAT), as PIL's ``open`` does.
    Raises ValueError for anything outside ``FORMATS``."""
    if not data.startswith(PNG_SIGNATURE):
        raise _unsupported(_kind(data))
    chunks = list(_chunks(data))
    W, H, _depth, ctype, _i = _png_header(chunks)
    palette = next((np.frombuffer(p, np.uint8)[:len(p) // 3 * 3].reshape(-1, 3)
                    for k, p in chunks if k == b"PLTE"), None)
    px = _png_pixels(b"".join(p for k, p in chunks if k == b"IDAT"), W, H, ctype)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG has no PLTE chunk")
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[px[..., 0]]
    return to_rgb(px)


# ---------------------------------------------------------------------------
# APNG
# ---------------------------------------------------------------------------

def _div255(x: np.ndarray) -> np.ndarray:
    """libImaging's DIV255: (x + 128 + ((x + 128) >> 8)) >> 8."""
    t = x + 128
    return ((t >> 8) + t) >> 8


def _apng(data: bytes):
    """(W, H, colour type, frames): each frame (duration ms or None,
    dispose op, blend op, (x0, y0, w, h), zlib data), frame 0 the default
    image, in PIL's numbering (the IDAT is frame 0 whether or not an fcTL
    puts it in the animation)."""
    chunks = list(_chunks(data))
    W, H, _depth, ctype, _i = _png_header(chunks)
    actl = next((p for k, p in chunks if k == b"acTL"), None)
    if actl is None:
        return W, H, ctype, None, 1
    if len(actl) != 8:
        raise ValueError("APNG acTL chunk is malformed")
    if ctype not in (2, 6) or any(k == b"tRNS" for k, _ in chunks):
        raise _unsupported("an APNG other than 8-bit RGB or RGBA without tRNS")
    frames, cur, seen_idat = [], None, False
    for kind, p in chunks:
        if kind == b"fcTL":
            if len(p) != 26:
                raise ValueError("APNG fcTL chunk is malformed")
            _seq, w, h, x0, y0, num, den, dop, bop = struct.unpack(">IIIIIHHBB", p)
            if w == 0 or h == 0 or x0 + w > W or y0 + h > H:
                raise ValueError("APNG contains invalid frames")
            if seen_idat and cur is not None and not cur[4]:
                raise ValueError("APNG missing frame data")
            cur = [float(num) / float(den or 100) * 1000, dop, bop, (x0, y0, w, h), []]
            frames.append(cur)
        elif kind == b"IDAT":
            if not seen_idat:
                if cur is None:         # the default image is not an animation frame
                    cur = [None, None, None, (0, 0, W, H), []]
                    frames.append(cur)
                seen_idat = True
            cur[4].append(p)
        elif kind == b"fdAT" and seen_idat and cur is not None:
            cur[4].append(p[4:])
    if not frames or not frames[0][4]:
        raise ValueError("PNG has no IDAT chunk")
    if frames[0][3] != (0, 0, W, H):
        raise ValueError("APNG's first frame does not cover the canvas")
    declared = struct.unpack(">I", actl[:4])[0] + (frames[0][0] is None)
    frames = [f for f in frames if f[4]]
    return W, H, ctype, [(f[0], f[1], f[2], f[3], b"".join(f[4])) for f in frames], declared


def apng_frames(data: bytes) -> tuple[int, int, int, list]:
    """(width, height, frame count as PIL's ``n_frames`` gives it (acTL's,
    plus a default image outside the animation), each frame's duration in
    ms or None) of a PNG or APNG (a still PNG: one frame, no duration), no
    pixel decoded. The durations list the frames the file holds, which may
    be fewer than it declares."""
    W, H, _c, frames, n = _apng(data)
    return W, H, n, [None] if frames is None else [f[0] for f in frames]


def decode_apng_frames(data: bytes, want) -> tuple[int, dict, list]:
    """(frame count, {i: uint8 [H, W, 3]} for each i in ``want``, every
    frame's duration), compositing as PIL's ``PngImagePlugin`` does: before
    a frame, the last one's disposal is pasted (op 1 zeros its rectangle, op
    2 restores the rectangle as it was before that frame; op 2 on frame 0
    is op 1); the frame's pixels then replace its rectangle (blend op 0),
    or, blend op 1 (RGBA), are mixed into what was there by their alpha,
    every channel alpha included: DIV255(old * (255 - a) + new * a)."""
    W, H, ctype, frames, _n = _apng(data)
    if frames is None:
        return 1, ({0: decode_png(data)} if 0 in set(want) else {}), [None]
    want = set(want)
    last = max(want) if want else -1
    c = _CHANNELS[ctype]
    out: dict = {}
    canvas = None
    dispose = None
    for i, (_dur, dop, bop, (x0, y0, w, h), z) in enumerate(frames[:last + 1]):
        px = _png_pixels(z, w, h, ctype)
        ys, xs = slice(y0, y0 + h), slice(x0, x0 + w)
        if i == 0:
            canvas = px.copy()
            prev = None
        else:
            if dispose is not None:
                canvas[dispose[0]] = dispose[1]
            prev = canvas.copy()
            if bop == 1 and c == 4:
                a = px[..., 3:].astype(np.int32)
                old = canvas[ys, xs].astype(np.int32)
                canvas[ys, xs] = _div255(old * (255 - a) + px.astype(np.int32) * a)
            else:
                canvas[ys, xs] = px
        if dop == 2 and prev is None:
            dop = 1
        dispose = None
        if dop == 2:
            dispose = ((ys, xs), prev[ys, xs])
        elif dop == 1:
            dispose = ((ys, xs), 0)
        if i in want:
            out[i] = canvas[..., :3].copy()
    return len(frames), out, [f[0] for f in frames]


def _kind(data: bytes) -> str:
    return ("JPEG" if data[:3] == b"\xff\xd8\xff" else
            "GIF" if data[:4] == b"GIF8" else
            "WebP" if data[:4] == b"RIFF" and data[8:12] == b"WEBP" else
            "PNG" if data.startswith(PNG_SIGNATURE) else "an unknown format")


def decode_image(data: bytes) -> np.ndarray:
    """Image bytes -> uint8 [H, W, 3], as PIL's ``open`` then
    ``convert("RGB")``: PNG (an APNG's default image), JPEG and GIF (frame
    0), told apart by their magic bytes. Raises ValueError for anything
    outside ``FORMATS``."""
    kind = _kind(data)
    if kind == "PNG":
        return decode_png(data)
    if kind == "JPEG":
        from llms_on_kubernetes_tpu_torch.engine.jpeg import decode_jpeg

        return to_rgb(decode_jpeg(data))
    if kind == "GIF":
        from llms_on_kubernetes_tpu_torch.engine.gif import decode_gif

        return decode_gif(data)
    raise _unsupported(kind)


def video_frames(data: bytes) -> tuple[int, int, int, list]:
    """(width, height, frame count, the durations in ms (or None) of the
    frames the file holds) of a video's bytes (an animated GIF or APNG; a
    still PNG, JPEG or GIF is one frame), no pixel decoded: what the server
    checks before decoding."""
    kind = _kind(data)
    if kind == "GIF":
        from llms_on_kubernetes_tpu_torch.engine.gif import gif_frames

        W, H, durations = gif_frames(data)
        return W, H, len(durations), durations
    if kind == "PNG":
        return apng_frames(data)
    if kind == "JPEG":
        from llms_on_kubernetes_tpu_torch.engine.jpeg import jpeg_size

        return (*jpeg_size(data), 1, [None])
    raise _unsupported(kind)


def decode_video_frames(data: bytes, want) -> dict:
    """{i: uint8 [H, W, 3]} for each frame index in ``want``, every frame
    before the last one wanted composited as PIL composites it."""
    kind = _kind(data)
    if kind == "GIF":
        from llms_on_kubernetes_tpu_torch.engine.gif import decode_gif_frames

        return decode_gif_frames(data, want)[1]
    if kind == "PNG":
        return decode_apng_frames(data, want)[1]
    img = decode_image(data)
    return {0: img} if 0 in set(want) else {}


def to_rgb(img: np.ndarray) -> np.ndarray:
    """An 8-bit image [H, W] or [H, W, 1..4] -> [H, W, 3] as PIL converts
    L, LA, RGB and RGBA to RGB (alpha dropped, grey repeated)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"images must be uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in (1, 2, 3, 4):
        raise ValueError(f"an image must be [H, W] or [H, W, 1-4], got {img.shape}")
    if img.shape[2] <= 2:
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _coeffs(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """(source index [out, k], fixed-point weight [out, k]) of one axis, as
    ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` make them."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) cast truncates toward zero; a negative start clamps to 0
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    j = np.arange(ksize)
    w = _bicubic((j[None, :] + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(j[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros((out_size, 1))
    for c in range(ksize):          # in order, as the C loop adds them
        ww = ww + w[:, c:c + 1]
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    fixed = np.where(w < 0, np.trunc(-0.5 + w * (1 << PRECISION_BITS)),
                     np.trunc(0.5 + w * (1 << PRECISION_BITS))).astype(np.int64)
    idx = np.minimum(xmin[:, None] + j[None, :], in_size - 1)
    return idx, fixed.astype(np.int32)


def _pass(x: np.ndarray, idx: np.ndarray, k: np.ndarray, axis: int) -> np.ndarray:
    """One resampling pass along ``axis`` (0 rows, 1 columns) of uint8
    [H, W, C], rounded and clipped as ``clip8``: one tap at a time, the
    integer sum exact in any order and within int32, as in the C loop."""
    acc = None
    for j in range(idx.shape[1]):
        if axis == 0:
            term = x[idx[:, j]].astype(np.int32) * k[:, j, None, None]
        else:
            term = x[:, idx[:, j]].astype(np.int32) * k[None, :, j, None]
        acc = term if acc is None else acc + term
    acc += 1 << (PRECISION_BITS - 1)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bicubic(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 [H, W, 3] -> [height, width, 3], PIL's BICUBIC resize."""
    H, W = img.shape[:2]
    if (W, H) == (width, height):
        return img.copy()
    out = img
    if W != width:
        out = _pass(out, *_coeffs(W, width), axis=1)
    if H != height:
        out = _pass(out, *_coeffs(H, height), axis=0)
    return out


def _normalize(img: np.ndarray) -> np.ndarray:
    x = np.asarray(img, np.float32) / 255.0
    return (x - 0.5) / 0.5


def preprocess_image(img: np.ndarray, image_size: int) -> np.ndarray:
    """An 8-bit image -> [image_size, image_size, 3] float32, SigLIP's
    rescale by 1/255 and mean = std = 0.5 (the JAX ``preprocess_image``)."""
    return _normalize(resize_bicubic(to_rgb(img), image_size, image_size))


def qwen_grid_candidates(vcfg) -> list[tuple[int, int]]:
    """All (sh, sw) patch grids with sh * sw == S^2 (a fixed token budget)
    and both sides multiples of the spatial merge size."""
    S = vcfg.image_size // vcfg.patch_size
    m = vcfg.spatial_merge_size
    total = S * S
    return [(sh, total // sh) for sh in range(m, total // m + 1, m)
            if total % sh == 0 and (total // sh) % m == 0]


def select_qwen_grid(width: int, height: int, vcfg) -> tuple[int, int]:
    """The aspect-closest allowed patch grid for a width x height image
    (log-aspect distance, ties to the squarer grid)."""
    aspect = math.log(max(height, 1) / max(width, 1))
    return min(qwen_grid_candidates(vcfg),
               key=lambda g: (abs(math.log(g[0] / g[1]) - aspect), abs(math.log(g[0] / g[1]))))


def preprocess_image_qwen3vl(img: np.ndarray, vcfg) -> np.ndarray:
    """An 8-bit image -> [sh * p, sw * p, 3] float32 on its aspect-closest
    grid, mean = std = 0.5 (the JAX ``preprocess_image_qwen3vl``)."""
    img = to_rgb(img)
    sh, sw = select_qwen_grid(img.shape[1], img.shape[0], vcfg)
    p = vcfg.patch_size
    return _normalize(resize_bicubic(img, sw * p, sh * p))
