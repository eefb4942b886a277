"""Media writers on numpy alone, for a machine without PIL (the card's):
baseline JPEG, GIF and APNG files that PIL reads, to the pixels the
port's decoders (``engine/jpeg.py``, ``engine/gif.py``,
``engine/images.py``) give. ``tests/test_torch_jpeg.py`` and
``tests/test_torch_gif_apng.py`` hold each writer's files to PIL.

- ``encode_jpeg``: baseline (SOF0) JPEG with JFIF's APP0, Annex K's
  quantization tables scaled by a quality as libjpeg scales them, Annex
  K's Huffman tables, 4:4:4, 4:2:2, 4:2:0 or 4:4:0 chroma (box-averaged),
  grey input as one component, and an optional restart interval (in
  MCUs). The
  DCT is a float matrix product; the entropy coding is vectorised.
- ``encode_gif``: frames of palette indices, one global palette (and
  optional local ones), per-frame delay, disposal, transparency and
  rectangle. The LZW data holds literal codes only, a clear code after
  every ``2 ** min_code_size - 2`` of them so the code width never grows:
  valid for any decoder and written with no Python loop over pixels.
- ``encode_apng``: RGB or RGBA frames as an animated PNG (acTL, fcTL,
  IDAT for frame 0, fdAT after), each frame's rectangle, delay, dispose
  and blend ops.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# Annex K.1 tables (natural order)
LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99], np.int64)
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)
# Annex K.3 Huffman tables: (16 counts, symbols)
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a16"
    "1718191a25262728292a3435363738393a434445464748494a535455565758595a63646566676869"
    "6a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6"
    "b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"))
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434"
    "e125f11718191a262728292a35363738393a434445464748494a535455565758595a636465666768"
    "696a737475767778797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4"
    "b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))
SUBSAMPLING = {"444": (1, 1), "422": (2, 1), "420": (2, 2), "440": (1, 2)}


def quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's ``jpeg_quality_scaling`` and baseline clamp to 1..255."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _codes(table) -> tuple[np.ndarray, np.ndarray]:
    """symbol -> (code, length) [256] from (counts, symbols)."""
    counts, symbols = table
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code_of[symbols[k]], len_of[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _dht(tc: int, th: int, table) -> bytes:
    counts, symbols = table
    body = bytes([tc << 4 | th]) + bytes(counts) + bytes(symbols)
    return b"\xff\xc4" + struct.pack(">H", 2 + len(body)) + body


def _nbits(v: np.ndarray) -> np.ndarray:
    """The JPEG size category of each value: the bit length of |v|."""
    a = np.abs(v).astype(np.int64)
    n = np.zeros_like(a)
    while (a > 0).any():
        n += a > 0
        a >>= 1
    return n


def _pack(vals: np.ndarray, lens: np.ndarray) -> bytes:
    """Concatenate (value, length) bit fields MSB first, pad the last byte
    with ones and stuff a 0x00 after every 0xFF."""
    if len(vals) == 0:
        return b""
    width = int(lens.max())
    shifts = lens[:, None] - 1 - np.arange(width)[None, :]
    bits = ((vals[:, None] >> np.maximum(shifts, 0)) & 1).astype(np.uint8)
    bits = bits[shifts >= 0]
    pad = (-len(bits)) % 8
    bits = np.concatenate([bits, np.ones(pad, np.uint8)])
    out = np.packbits(bits)
    ff = np.flatnonzero(out == 0xFF)
    return np.insert(out, ff + 1, 0).tobytes()


def _blocks(plane: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """A plane padded to [bh * 8, bw * 8] by edge replication -> [bh, bw, 64]."""
    H, W = plane.shape
    p = np.pad(plane, ((0, bh * 8 - H), (0, bw * 8 - W)), mode="edge")
    return p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(bh, bw, 64)


_DCT = np.array([[(np.sqrt(1 / 8) if u == 0 else np.sqrt(2 / 8))
                  * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
                 for u in range(8)])


def encode_jpeg(img: np.ndarray, quality: int = 75, subsampling: str = "420",
                restart: int = 0) -> bytes:
    """uint8 [H, W, 3] (or [H, W] grey) -> baseline JPEG bytes."""
    img = np.asarray(img, np.uint8)
    grey = img.ndim == 2
    H, W = img.shape[:2]
    if grey:
        planes, factors = [img.astype(np.float64)], [(1, 1)]
        hmax = vmax = 1
    else:
        r, g, b = (img[..., i].astype(np.float64) for i in range(3))
        y = 0.299 * r + 0.587 * g + 0.114 * b
        cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
        cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128
        hmax, vmax = SUBSAMPLING[subsampling]
        planes, factors = [y], [(hmax, vmax)]
        for c in (cb, cr):
            ph, pw = -(-H // vmax) * vmax, -(-W // hmax) * hmax
            c = np.pad(c, ((0, ph - H), (0, pw - W)), mode="edge")
            planes.append(c.reshape(ph // vmax, vmax, pw // hmax, hmax).mean(axis=(1, 3)))
            factors.append((1, 1))
    mx, my = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    qt = [quality_table(LUMA_Q, quality), quality_table(CHROMA_Q, quality)]
    # quantized coefficients of every block, zigzag order, in MCU order
    coefs, comp_of = [], []
    per_comp = []
    for ci, (p, (h, v)) in enumerate(zip(planes, factors)):
        blk = _blocks(np.clip(np.round(p), 0, 255) - 128.0, my * v, mx * h)
        d = np.einsum("ux,abxy,vy->abuv", _DCT, blk.reshape(my * v, mx * h, 8, 8), _DCT)
        q = qt[min(ci, 1)].reshape(8, 8)
        z = np.round(d / q).astype(np.int64).reshape(my * v, mx * h, 64)[..., ZIGZAG]
        # [my, mx, v, h, 64]: the MCU's blocks row by row
        per_comp.append(z.reshape(my, v, mx, h, 64).transpose(0, 2, 1, 3, 4)
                        .reshape(my, mx, v * h, 64))
        comp_of.append(np.full(v * h, ci))
    mcu = np.concatenate(per_comp, axis=2)                  # [my, mx, blocks a MCU, 64]
    comp = np.concatenate(comp_of)
    nb = mcu.shape[2]
    coefs = mcu.reshape(-1, nb, 64)                         # [MCUs, blocks, 64]
    n_mcu = coefs.shape[0]
    intervals = [(s, min(s + restart, n_mcu)) for s in range(0, n_mcu, restart)] \
        if restart else [(0, n_mcu)]
    tabs = [(_codes(DC_LUMA), _codes(AC_LUMA)), (_codes(DC_CHROMA), _codes(AC_CHROMA))]
    data = b""
    for k, (s, e) in enumerate(intervals):
        if k:
            data += bytes([0xFF, 0xD0 + (k - 1) % 8])
        data += _entropy(coefs[s:e], comp, tabs)
    header = b"\xff\xd8" + b"\xff\xe0" + struct.pack(">H5sBBBHHBB", 16, b"JFIF\0", 1, 1, 0,
                                                       1, 1, 0, 0)
    for t, tab in enumerate(qt[:1 if grey else 2]):
        header += b"\xff\xdb" + struct.pack(">HB", 67, t) + bytes(tab[ZIGZAG].astype(np.uint8))
    nf = len(planes)
    sof = struct.pack(">BHHB", 8, H, W, nf)
    for ci, (h, v) in enumerate(factors):
        sof += bytes([ci + 1, h << 4 | v, min(ci, 1)])
    header += b"\xff\xc0" + struct.pack(">H", 2 + len(sof)) + sof
    header += _dht(0, 0, DC_LUMA) + _dht(1, 0, AC_LUMA)
    if not grey:
        header += _dht(0, 1, DC_CHROMA) + _dht(1, 1, AC_CHROMA)
    if restart:
        header += b"\xff\xdd" + struct.pack(">HH", 4, restart)
    sos = bytes([nf]) + b"".join(bytes([ci + 1, min(ci, 1) << 4 | min(ci, 1)])
                                 for ci in range(nf)) + bytes([0, 63, 0])
    header += b"\xff\xda" + struct.pack(">H", 2 + len(sos)) + sos
    return header + data + b"\xff\xd9"


def _entropy(coefs: np.ndarray, comp: np.ndarray, tabs) -> bytes:
    """Huffman-code MCUs [n, blocks, 64] (zigzag) of one restart interval."""
    n, nb, _ = coefs.shape
    flat = coefs.reshape(-1, 64)
    cidx = np.tile(comp, n)                                 # component of each block
    tab = np.minimum(cidx, 1)
    # DC differences, each component against its previous block
    dc = flat[:, 0]
    diff = np.empty_like(dc)
    for c in np.unique(comp):
        sel = np.flatnonzero(cidx == c)
        diff[sel] = np.diff(dc[sel], prepend=0)
    keys, vals, lens = [], [], []
    nblk = len(flat)
    sz = _nbits(diff)
    extra = np.where(diff < 0, diff + (1 << sz) - 1, diff)
    dc_code = np.stack([tabs[0][0][0][sz], tabs[1][0][0][sz]])[tab, np.arange(nblk)]
    dc_len = np.stack([tabs[0][0][1][sz], tabs[1][0][1][sz]])[tab, np.arange(nblk)]
    keys.append(np.arange(nblk) * 256)
    vals.append((dc_code << sz) | extra)
    lens.append(dc_len + sz)
    # AC: each non-zero coefficient after its zero run, runs over 15 as ZRLs
    b, k = np.nonzero(flat[:, 1:])
    k = k + 1
    first = np.r_[True, b[1:] != b[:-1]] if len(b) else np.zeros(0, bool)
    prev = np.where(first, 0, np.r_[0, k[:-1]])
    run = k - prev - 1
    v = flat[b, k]
    s = _nbits(v)
    ext = np.where(v < 0, v + (1 << s) - 1, v)
    sym = (run % 16) * 16 + s
    t = tab[b]
    ac_code = np.where(t == 0, tabs[0][1][0][sym], tabs[1][1][0][sym])
    ac_len = np.where(t == 0, tabs[0][1][1][sym], tabs[1][1][1][sym])
    keys.append(b * 256 + 2 * k)
    vals.append((ac_code << s) | ext)
    lens.append(ac_len + s)
    nzrl = run // 16
    if nzrl.any():
        rep = np.repeat(np.arange(len(b)), nzrl)
        zt = t[rep]
        keys.append(b[rep] * 256 + 2 * k[rep] - 1)
        vals.append(np.where(zt == 0, tabs[0][1][0][0xF0], tabs[1][1][0][0xF0]))
        lens.append(np.where(zt == 0, tabs[0][1][1][0xF0], tabs[1][1][1][0xF0]))
    # EOB after a block's last non-zero coefficient unless that is index 63
    last = np.full(nblk, 0)
    if len(b):
        last[b] = k                     # the last write per block wins: its largest k
    eob = np.flatnonzero(last < 63)
    keys.append(eob * 256 + 200)
    vals.append(np.where(tab[eob] == 0, tabs[0][1][0][0], tabs[1][1][0][0]))
    lens.append(np.where(tab[eob] == 0, tabs[0][1][1][0], tabs[1][1][1][0]))
    keys, vals, lens = (np.concatenate(x) for x in (keys, vals, lens))
    order = np.argsort(keys, kind="stable")
    return _pack(vals[order], lens[order])


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------

def _lzw_literals(idx: np.ndarray, code_size: int) -> bytes:
    """Indices as an LZW stream of literal codes: clear, then at most
    2 ** code_size - 2 literals before the next clear, then end; each code
    ``code_size + 1`` bits, LSB first; in data sub-blocks of 255 bytes."""
    clear, end, width = 1 << code_size, (1 << code_size) + 1, code_size + 1
    run = (1 << code_size) - 2
    px = idx.reshape(-1).astype(np.int64)
    n = len(px)
    groups = -(-n // run)
    codes = np.full(groups * (run + 1), -1, np.int64)
    pos = np.arange(n) + np.arange(n) // run + 1      # one clear before each group
    codes[pos] = px
    codes[np.arange(groups) * (run + 1)] = clear
    codes = np.concatenate([codes[codes >= 0], [clear if n == 0 else end]])
    if n == 0:
        codes = np.array([clear, end])
    bits = ((codes[:, None] >> np.arange(width)[None, :]) & 1).astype(np.uint8).reshape(-1)
    raw = np.packbits(bits, bitorder="little").tobytes()
    out = bytes([code_size])
    for i in range(0, len(raw), 255):
        chunk = raw[i:i + 255]
        out += bytes([len(chunk)]) + chunk
    return out + b"\x00"


def _table_bits(palette: np.ndarray) -> int:
    """The colour table's size field: 2 ** (bits + 1) entries hold it."""
    bits = 0
    while (2 << bits) < len(palette):
        bits += 1
    return bits


def _table(palette: np.ndarray) -> bytes:
    n = 2 << _table_bits(palette)
    p = np.zeros((n, 3), np.uint8)
    p[:len(palette)] = palette
    return p.tobytes()


def encode_gif(frames, palette: np.ndarray, delays=None, disposal=None, transparency=None,
               rects=None, local_palettes=None, interlace=False, background: int = 0,
               loop: int = 0, screen=None) -> bytes:
    """Frames of palette indices (uint8 [h, w] each; the first one sets the
    screen unless ``rects`` gives (x0, y0) per frame over the first frame's
    size) -> GIF89a bytes. Per frame (lists, or one value for every frame):
    ``delays`` in ms (written in centiseconds), ``disposal`` 0-3,
    ``transparency`` index or None, ``local_palettes`` (None for the
    global one), ``interlace``. ``screen`` (width, height) writes another
    logical screen size than the first frame's."""
    n = len(frames)

    def per(x, default):
        if x is None:
            return [default] * n
        return list(x) if isinstance(x, (list, tuple)) else [x] * n

    delays, disposal, transparency = per(delays, 100), per(disposal, 0), per(transparency, None)
    local_palettes, interlace = per(local_palettes, None), per(interlace, False)
    rects = rects or [(0, 0)] * n
    H, W = frames[0].shape
    if screen is not None:
        W, H = screen
    palette = np.asarray(palette, np.uint8)
    out = b"GIF89a" + struct.pack("<HHBBB", W, H, 0xF0 | _table_bits(palette), background, 0)
    out += _table(palette)
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\x00"
    for i, idx in enumerate(frames):
        idx = np.asarray(idx, np.uint8)
        t = transparency[i]
        flags = (disposal[i] & 7) << 2 | (1 if t is not None else 0)
        out += b"\x21\xf9\x04" + struct.pack("<BHB", flags, int(round(delays[i] / 10)),
                                             t or 0) + b"\x00"
        h, w = idx.shape
        x0, y0 = rects[i]
        pal = local_palettes[i]
        fl = 0x40 if interlace[i] else 0
        if pal is not None:
            pal = np.asarray(pal, np.uint8)
            fl |= 0x80 | _table_bits(pal)
        out += b"\x2c" + struct.pack("<HHHHB", x0, y0, w, h, fl)
        if pal is not None:
            out += _table(pal)
        rows = idx
        if interlace[i]:
            rows = idx[np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                                       np.arange(2, h, 4), np.arange(1, h, 2)])]
        size = max(2, _table_bits(pal if pal is not None else palette) + 1)
        out += _lzw_literals(rows, size)
    return out + b"\x3b"


# ---------------------------------------------------------------------------
# APNG
# ---------------------------------------------------------------------------

def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def _rows(px: np.ndarray) -> bytes:
    """Filter type 1 (Sub) on every row, zlib-compressed."""
    h, w, c = px.shape
    cur = px.reshape(h, w * c).astype(np.int32)
    left = np.hstack([np.zeros((h, c), np.int32), cur[:, :-c]])
    rows = np.hstack([np.ones((h, 1), np.int32), (cur - left) & 255]).astype(np.uint8)
    return zlib.compress(rows.tobytes(), 6)


def encode_apng(frames, delays=None, dispose=None, blend=None, rects=None,
                loop: int = 0) -> bytes:
    """RGB or RGBA frames (uint8 [h, w, C]; the first one is the canvas'
    size and sits at (0, 0)) -> APNG bytes. Per frame (lists, or one value
    for every frame): ``delays`` in ms (num/1000), ``dispose`` 0 none, 1
    background, 2 previous, ``blend`` 0 source, 1 over, ``rects`` (x0, y0)."""
    n = len(frames)

    def per(x, default):
        if x is None:
            return [default] * n
        return list(x) if isinstance(x, (list, tuple)) else [x] * n

    delays, dispose, blend = per(delays, 100), per(dispose, 0), per(blend, 0)
    rects = rects or [(0, 0)] * n
    H, W, c = np.asarray(frames[0]).shape
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", W, H, 8, 2 if c == 3 else 6, 0, 0, 0))
    out += _chunk(b"acTL", struct.pack(">II", n, loop))
    seq = 0
    for i, f in enumerate(frames):
        f = np.asarray(f, np.uint8)
        h, w, _ = f.shape
        x0, y0 = rects[i]
        out += _chunk(b"fcTL", struct.pack(">IIIIIHHBB", seq, w, h, x0, y0,
                                           int(round(delays[i])), 1000, dispose[i], blend[i]))
        seq += 1
        data = _rows(f)
        if i == 0:
            out += _chunk(b"IDAT", data)
        else:
            out += _chunk(b"fdAT", struct.pack(">I", seq) + data)
            seq += 1
    return out + _chunk(b"IEND", b"")
