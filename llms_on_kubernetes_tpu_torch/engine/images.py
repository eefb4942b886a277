"""Image decoding and preprocessing for the vision path, without PIL
(counterpart of what ``llms_on_kubernetes_tpu/server/openai_api.py`` and
``llms_on_kubernetes_tpu/models/vision.py`` ask of PIL).

The card's machine has no PIL, so the port reads images itself:

- ``decode_png``: PNG with ``zlib`` and numpy, 8 bits a sample, not
  interlaced, colour types greyscale, greyscale + alpha, RGB, RGBA and
  palette, all five row filters. A chunk whose CRC does not match, or any
  other input (JPEG, GIF, WebP, 16-bit or interlaced PNG), raises
  ``ValueError`` naming what the port reads (``FORMATS``). The result is
  converted to RGB as PIL's ``convert("RGB")`` does: alpha dropped, grey
  repeated, the palette looked up.
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

FORMATS = ("PNG: 8-bit greyscale, greyscale+alpha, RGB, RGBA or palette, "
           "not interlaced")
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


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, 3] RGB (``convert("RGB")``'s bytes).
    Raises ValueError for anything outside ``FORMATS``."""
    if not data.startswith(PNG_SIGNATURE):
        kind = ("JPEG" if data[:3] == b"\xff\xd8\xff" else
                "GIF" if data[:4] == b"GIF8" else
                "WebP" if data[:4] == b"RIFF" and data[8:12] == b"WEBP" else "not a PNG")
        raise _unsupported(kind)
    header, palette, idat = None, None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    W, H, depth, ctype, _comp, _filt, interlace = header
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
    bpp = _CHANNELS[ctype]
    stride = W * bpp + 1
    raw = _inflate(b"".join(idat), H * stride)
    rows = np.frombuffer(raw, np.uint8).reshape(H, stride)
    types = rows[:, 0].astype(np.int32)
    if (types > 4).any():
        raise ValueError("PNG row filter type is invalid")
    rows = rows[:, 1:]
    if (types >= 3).any():
        px = _unfilter_diagonals(rows, types, bpp)
    else:
        px = _unfilter_rows(rows, types, bpp)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG has no PLTE chunk")
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[px[..., 0]]
    return to_rgb(px)


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
