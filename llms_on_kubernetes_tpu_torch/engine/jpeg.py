"""JPEG decoding without PIL, byte for byte as PIL 12 decodes it with
libjpeg-turbo (``Image.open(...).load()``; counterpart of what
``llms_on_kubernetes_tpu/server/openai_api.py`` asks of PIL).

- Markers: SOI, DQT (8- and 16-bit tables), SOF0 (baseline), SOF1
  (extended sequential, 8-bit) and SOF2 (progressive), DHT, SOS, DRI,
  RST0-7, APPn (JFIF's APP0 and Adobe's APP14 transform), COM, EOI.
- Sizes: 1 or 3 components, sampling factors 1 or 2 each way (4:4:4,
  4:2:2, 4:2:0, 4:4:0).
- Refused with a ``ValueError`` naming what the server reads
  (``images.FORMATS``):
  SOF3 and SOF5-15 (lossless, hierarchical, arithmetic), 12-bit samples,
  4 components (CMYK, YCCK), other sampling factors, a header of more than
  ``MAX_IMAGE_PIXELS`` pixels (before any entropy decoding), and a
  progressive file that leaves a coefficient of one of the first ten
  unrefined (libjpeg smooths such blocks; the port does not).
- Truncated or corrupt data raises ``ValueError`` where PIL raises
  ``OSError``; entropy data that libjpeg decodes with a warning (a bad
  Huffman code, a coefficient past 63, a restart marker out of sequence, a
  scan cut short by a marker) is refused too.

The entropy stage (Huffman decoding into quantized coefficients, natural
order, one int16 plane a component, padded to whole MCUs) is C
(``csrc/host/media.c``, ``kernels.host_function``), built on first use;
there is no Python fallback. The rest is libjpeg-turbo's integer
arithmetic, vectorised over every block in int32 numpy (int64 where a
coefficient is large enough to overflow int32; the results are the same):

- dequantization, each table latched at its component's first scan, as
  libjpeg latches it;
- the "islow" IDCT of ``jidctint.c`` (``CONST_BITS`` 13, ``PASS1_BITS``
  2; its all-zero-AC shortcuts give the same values and are not taken),
  with the output range-limit table indexed by ``& RANGE_MASK``, so an
  out-of-range value wraps as that table makes it;
- "fancy" triangle upsampling (``jdsample.c``: h2v1 and h2v2 when the
  component is wider than 2 samples, else box; h1v2 always), with its
  alternating rounding biases and the edge rows and columns replicated;
- YCbCr to RGB with the tables of ``jdcolor.c`` (``SCALEBITS`` 16). A
  3-component file is YCbCr unless it has no JFIF marker and Adobe's
  transform is 0, or, with neither marker, its component ids are "R", "G",
  "B" (``jdapimin.c``'s rule).

EXIF orientation is not applied, as neither PIL's ``open`` nor the JAX
server applies it.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from llms_on_kubernetes_tpu_torch.engine.images import FORMATS, MAX_IMAGE_PIXELS

# zigzag index -> natural (row-major) index
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

_ERRORS = {
    -1: "the data ends before the scan does (truncated, or a marker inside the scan)",
    -2: "a Huffman table over-subscribes its codes",
    -3: "corrupt entropy data (no Huffman code matches)",
    -4: "corrupt entropy data (a coefficient past index 63)",
    -5: "a restart marker is missing or out of sequence",
    -6: "a scan uses a Huffman table that is not defined",
    -7: "scan parameters out of range",
}
_SOF_NAMES = {0xC3: "lossless", 0xC5: "hierarchical", 0xC6: "hierarchical progressive",
              0xC7: "hierarchical lossless", 0xC9: "arithmetic", 0xCA: "arithmetic progressive",
              0xCB: "arithmetic lossless", 0xCD: "hierarchical arithmetic",
              0xCE: "hierarchical arithmetic progressive",
              0xCF: "hierarchical arithmetic lossless"}


def _unsupported(why: str) -> ValueError:
    return ValueError(f"unsupported image: {why}; the server reads {FORMATS}")


def _range_limit(x: np.ndarray) -> np.ndarray:
    """libjpeg's post-IDCT table at ``x & RANGE_MASK`` (1023): the value
    wrapped into [-512, 511], then offset by 128 and clipped to [0, 255]."""
    return np.clip(((x + 512) & 1023) - 512 + 128, 0, 255).astype(np.uint8)


def _idct_pass(x, shift: int):
    """One 1-D pass of ``jpeg_idct_islow`` over inputs x[0..7] (arrays of
    one shape): the eight outputs, descaled by ``shift``."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * 4433                       # FIX_0_541196100
    tmp2 = z1 + z3 * -15137                     # FIX_1_847759065
    tmp3 = z1 + z2 * 6270                       # FIX_0_765366865
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633                       # FIX_1_175875602
    t0 = t0 * 2446                              # FIX_0_298631336
    t1 = t1 * 16819                             # FIX_2_053119869
    t2 = t2 * 25172                             # FIX_3_072711026
    t3 = t3 * 12299                             # FIX_1_501321110
    z1 = z1 * -7373                             # FIX_0_899976223
    z2 = z2 * -20995                            # FIX_2_562915447
    z3 = z3 * -16069 + z5                       # FIX_1_961570560
    z4 = z4 * -3196 + z5                        # FIX_0_390180644
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    half = 1 << (shift - 1)
    return [(v + half) >> shift for v in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """Quantized coefficients [N, 64] (natural order) and their table [64]
    -> samples uint8 [N, 8, 8], as ``jpeg_idct_islow`` computes them."""
    # DEQUANTIZE: (short) coef * (short) quantval, in int
    deq = coef.astype(np.int32) * quant.astype(np.int16).astype(np.int32)[None]
    wide = np.int64 if np.abs(deq).max(initial=0) >= 1 << 13 else np.int32
    c = deq.astype(wide).reshape(-1, 8, 8).transpose(1, 0, 2)      # [row k, N, col]
    ws = np.stack(_idct_pass(c, 11)).astype(np.int32)              # [row, N, col]
    wide = np.int64 if np.abs(ws).max(initial=0) >= 1 << 12 else np.int32
    w = ws.astype(wide).transpose(2, 1, 0)                          # [col k, N, row]
    out = np.stack(_idct_pass(w, 18))                               # [col, N, row]
    return _range_limit(out).transpose(1, 2, 0)                     # [N, row, col]


def _h2_fancy(s: np.ndarray, odd_bias: int, even_bias: int, scale: int, sh: int):
    """Horizontal triangle filter of rows ``s`` [R, w] (w > 2): output
    column 2i weighs column i by 3 and i - 1 by 1, 2i + 1 column i by 3 and
    i + 1 by 1, the edges taking their own column's ``scale`` times."""
    s = s.astype(np.int32)
    R, w = s.shape
    out = np.empty((R, 2 * w), np.int32)
    out[:, 2:2 * w:2] = (3 * s[:, 1:] + s[:, :-1] + even_bias) >> sh
    out[:, 1:2 * w - 2:2] = (3 * s[:, :-1] + s[:, 1:] + odd_bias) >> sh
    out[:, 0] = (s[:, 0] * scale + even_bias) >> sh
    out[:, 2 * w - 1] = (s[:, -1] * scale + odd_bias) >> sh
    return out


def upsample(s: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """A component's samples [dh, dw] (its downsampled size) -> [fv * dh,
    fh * dw], as libjpeg-turbo's upsampler with ``do_fancy_upsampling``."""
    dh, dw = s.shape
    if fh == 1 and fv == 1:
        return s
    if fh == 1:                                   # h1v2_fancy_upsample
        x = s.astype(np.int32)
        above = np.concatenate([x[:1], x[:-1]])
        below = np.concatenate([x[1:], x[-1:]])
        out = np.empty((2 * dh, dw), np.int32)
        out[0::2] = (3 * x + above + 1) >> 2
        out[1::2] = (3 * x + below + 2) >> 2
        return out.astype(np.uint8)
    if dw <= 2:                                   # box: h2v1_upsample / h2v2_upsample
        return np.repeat(np.repeat(s, fh, axis=1), fv, axis=0)
    if fv == 1:                                   # h2v1_fancy_upsample
        return _h2_fancy(s, 2, 1, 4, 2).astype(np.uint8)
    x = s.astype(np.int32)                        # h2v2_fancy_upsample
    above = np.concatenate([x[:1], x[:-1]])
    below = np.concatenate([x[1:], x[-1:]])
    out = np.empty((2 * dh, 2 * dw), np.int32)
    out[0::2] = _h2_fancy(3 * x + above, 7, 8, 4, 4)
    out[1::2] = _h2_fancy(3 * x + below, 7, 8, 4, 4)
    return out.astype(np.uint8)


def _fix(x: float) -> int:
    return int(x * (1 << 16) + 0.5)


_I = np.arange(256, dtype=np.int64) - 128
_CR_R = ((_fix(1.40200) * _I + (1 << 15)) >> 16).astype(np.int16)
_CB_B = ((_fix(1.77200) * _I + (1 << 15)) >> 16).astype(np.int16)
# RIGHT_SHIFT(Cb_g_tab[cb] + Cr_g_tab[cr], SCALEBITS), one entry a (cb, cr)
_G = (((-_fix(0.34414) * _I + (1 << 15))[:, None] - _fix(0.71414) * _I[None, :]) >> 16
      ).astype(np.int16).reshape(-1)


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """``jdcolor.c``'s ycc_rgb_convert: uint8 planes -> uint8 [H, W, 3]."""
    out = np.empty(y.shape + (3,), np.uint8)
    yy = y.astype(np.int16)
    for ch, off in enumerate((_CR_R[cr], _G[cb.astype(np.int32) * 256 + cr], _CB_B[cb])):
        v = yy + off
        out[..., ch] = np.clip(v, 0, 255, out=v)
    return out


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.quant = None       # the table latched at its first scan
        self.plane = None
        self.bits = None        # progressive: the lowest bit each coefficient has got, -1 none


def _segment(data: bytes, pos: int) -> tuple[int, bytes]:
    if pos + 4 > len(data):
        raise ValueError("JPEG marker segment is truncated")
    (n,) = struct.unpack(">H", data[pos + 2:pos + 4])
    if n < 2 or pos + 2 + n > len(data):
        raise ValueError("JPEG marker segment is truncated")
    return pos + 2 + n, data[pos + 4:pos + 2 + n]


def jpeg_size(data: bytes) -> tuple[int, int]:
    """(width, height) from the frame header, without decoding."""
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        m = data[pos + 1]
        if m == 0xFF or m == 0x00 or 0xD0 <= m <= 0xD8 or m == 0x01:
            pos += 1 if m == 0xFF else 2
            continue
        end, seg = _segment(data, pos)
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            if len(seg) < 5:
                raise ValueError("JPEG frame header is truncated")
            _p, H, W = struct.unpack(">BHH", seg[:5])
            return W, H
        pos = end
    raise ValueError("JPEG has no frame header")


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> uint8 [H, W, 3] (3 components) or [H, W] (grey), the
    pixels PIL's ``load()`` gives. Raises ValueError for anything outside
    ``FORMATS`` and for truncated or corrupt data."""
    from llms_on_kubernetes_tpu_torch import kernels

    if not data.startswith(b"\xff\xd8"):
        raise ValueError("not a JPEG")
    quant: dict = {}
    tables = np.zeros(8 * 272, np.uint8)
    present = np.zeros(8, np.int32)
    comps: list[_Component] = []
    frame = None
    progressive = False
    restart = 0
    jfif = False
    adobe = None
    scans = 0
    pos = 2
    n = len(data)
    scan_fn = kernels.host_function("llmk_jpeg_scan")
    while True:
        # the next marker: 0xFF (fill 0xFF bytes allowed) and a code; other
        # bytes between segments are skipped, as libjpeg skips them
        while pos < n and data[pos] != 0xFF:
            pos += 1
        while pos + 1 < n and data[pos + 1] == 0xFF:
            pos += 1
        if pos + 1 >= n:
            raise ValueError("JPEG is truncated (no EOI marker)")
        m = data[pos + 1]
        if m == 0xD9:                                       # EOI
            break
        if m == 0x00 or m == 0x01 or 0xD0 <= m <= 0xD7:      # stray stuffing, TEM, RSTn
            pos += 2
            continue
        if m == 0xD8:
            raise ValueError("JPEG has a second SOI marker")
        end, seg = _segment(data, pos)
        if m == 0xDB:                                       # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                size = 128 if pq else 64
                if tq > 3 or pq > 1 or i + 1 + size > len(seg):
                    raise ValueError("JPEG quantization table is malformed")
                vals = np.frombuffer(seg[i + 1:i + 1 + size], ">u2" if pq else np.uint8)
                q = np.zeros(64, np.int64)
                q[NATURAL] = vals
                quant[tq] = q
                i += 1 + size
        elif m == 0xC4:                                     # DHT
            i = 0
            while i < len(seg):
                if i + 17 > len(seg):
                    raise ValueError("JPEG Huffman table is malformed")
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = seg[i + 1:i + 17]
                k = sum(counts)
                if tc > 1 or th > 3 or k > 256 or i + 17 + k > len(seg):
                    raise ValueError("JPEG Huffman table is malformed")
                t = (tc * 4 + th) * 272
                tables[t:t + 272] = 0
                tables[t:t + 16] = np.frombuffer(counts, np.uint8)
                tables[t + 16:t + 16 + k] = np.frombuffer(seg[i + 17:i + 17 + k], np.uint8)
                present[tc * 4 + th] = 1
                i += 17 + k
        elif m in (0xC0, 0xC1, 0xC2):                       # SOF0, SOF1, SOF2
            if frame is not None:
                raise ValueError("JPEG has two frame headers")
            if len(seg) < 6:
                raise ValueError("JPEG frame header is truncated")
            prec, H, W, nf = struct.unpack(">BHHB", seg[:6])
            if prec != 8:
                raise _unsupported(f"{prec}-bit JPEG samples")
            if nf == 4:
                raise _unsupported("4-component (CMYK or YCCK) JPEG")
            if nf not in (1, 3):
                raise _unsupported(f"{nf}-component JPEG")
            if H == 0 or W == 0:
                raise ValueError("JPEG frame has no pixels (or a DNL height)")
            if W * H > MAX_IMAGE_PIXELS:
                raise ValueError(f"JPEG of {W}x{H} pixels is larger than the "
                                 f"{MAX_IMAGE_PIXELS} pixels the server decodes")
            if len(seg) < 6 + 3 * nf:
                raise ValueError("JPEG frame header is truncated")
            for c in range(nf):
                cid, hv, tq = seg[6 + 3 * c:9 + 3 * c]
                h, v = hv >> 4, hv & 15
                if h not in (1, 2) or v not in (1, 2):
                    raise _unsupported(f"sampling factors {h}x{v}")
                if tq > 3:
                    raise ValueError("JPEG component names a quantization table past 3")
                if any(k.id == cid for k in comps):
                    raise ValueError("JPEG has two components with one id")
                comps.append(_Component(cid, h, v, tq))
            progressive = m == 0xC2
            hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
            mx, my = -(-W // (8 * hmax)), -(-H // (8 * vmax))
            if nf == 1:       # one component: MCUs of one block over its own width
                mx, my = -(-W // 8), -(-H // 8)
                comps[0].h = comps[0].v = hmax = vmax = 1
            for c in comps:
                c.plane = np.zeros((my * c.v, mx * c.h, 64), np.int16)
                # the component's own extent in blocks (a non-interleaved scan's)
                c.dw = -(-W * c.h // hmax)
                c.dh = -(-H * c.v // vmax)
                if progressive:
                    c.bits = np.full(64, -1, np.int64)
            frame = (W, H, hmax, vmax, mx, my)
        elif 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            raise _unsupported(f"{_SOF_NAMES.get(m, 'SOF')} JPEG (SOF{m - 0xC0})")
        elif m == 0xCC:
            raise _unsupported("arithmetic-coded JPEG")
        elif m == 0xDD:                                     # DRI
            if len(seg) < 2:
                raise ValueError("JPEG restart interval is truncated")
            (restart,) = struct.unpack(">H", seg[:2])
        elif m == 0xE0:                                     # APP0
            if len(seg) >= 14 and seg[:5] == b"JFIF\0":
                jfif = True
        elif m == 0xEE:                                     # APP14
            if len(seg) >= 12 and seg[:5] == b"Adobe":
                adobe = seg[11]
        elif m == 0xDA:                                     # SOS
            if frame is None:
                raise ValueError("JPEG scan before its frame header")
            pos = _scan(data, end, seg, comps, frame, progressive, restart, quant, tables,
                        present, scan_fn)
            scans += 1
            continue
        pos = end
    if frame is None or not scans:
        raise ValueError("JPEG has no frame or no scan")
    for c in comps:
        if c.quant is None:
            raise ValueError(f"JPEG component {c.id} appears in no scan")
        if progressive and c.bits[0] >= 0 and (c.bits[1:10] != 0).any():
            raise _unsupported("a progressive JPEG that leaves low coefficients unrefined "
                               "(libjpeg's block smoothing)")
    return _pixels(comps, frame, jfif, adobe)


def huffman_table_valid(counts) -> bool:
    """Whether the code lengths (16 counts) leave every length's all-ones
    code unused, as libjpeg requires: no table over-subscribes its codes."""
    code = 0
    for length, n in enumerate(counts, 1):
        code += int(n)
        if code >= 1 << length:
            return False
        code <<= 1
    return True


def _scan(data, start, seg, comps, frame, progressive, restart, quant, tables, present,
          scan_fn) -> int:
    """Decode one scan into the component planes; returns the position of
    the marker that ends it."""
    W, H, hmax, vmax, mx, my = frame
    if not seg:
        raise ValueError("JPEG scan header is truncated")
    ns = seg[0]
    if not 1 <= ns <= 4 or len(seg) < 1 + 2 * ns + 3:
        raise ValueError("JPEG scan header is malformed")
    ss, se, a = seg[1 + 2 * ns:4 + 2 * ns]
    ah, al = a >> 4, a & 15
    if progressive:
        bad = (se != 0 if ss == 0 else (ss > se or se > 63 or ns != 1)) or al > 13 or (
            ah != 0 and al != ah - 1)
        if bad:
            raise ValueError("JPEG progressive scan parameters are invalid")
    else:
        ss, se, ah, al = 0, 63, 0, 0
    info = np.zeros((ns, 8), np.int32)
    planes = (ctypes.c_void_p * ns)()
    in_scan = []
    for k in range(ns):
        cid, t = seg[1 + 2 * k:3 + 2 * k]
        c = next((x for x in comps if x.id == cid), None)
        if c is None:
            raise ValueError(f"JPEG scan names component {cid}, which the frame lacks")
        if c in in_scan:
            raise ValueError("JPEG scan names a component twice")
        in_scan.append(c)
        if c.quant is None:
            if c.tq not in quant:
                raise ValueError(f"JPEG quantization table {c.tq} is not defined")
            c.quant = quant[c.tq].copy()
        info[k] = (c.h, c.v, c.plane.shape[1], c.plane.shape[0], t >> 4, t & 15,
                   -(-c.dw // 8), -(-c.dh // 8))
        planes[k] = c.plane.ctypes.data
        if progressive:
            c.bits[ss:se + 1] = al
    if ns > 1 and sum(c.h * c.v for c in in_scan) > 10:
        raise ValueError("JPEG MCU holds more than 10 blocks")
    # the tables the scan decodes with, checked when used as libjpeg checks
    # them (a table no scan uses may be malformed); the C stage checks again
    used = set()
    for k in range(ns):
        dc, ac = seg[2 + 2 * k] >> 4, seg[2 + 2 * k] & 15
        if dc > 3 or ac > 3:
            raise ValueError("JPEG scan names a Huffman table past 3")
        if ss == 0 and ah == 0:
            used.add(dc)
        if ss > 0 or not progressive:
            used.add(4 + ac)
    for t in sorted(used):
        if present[t] and not huffman_table_valid(tables[272 * t:272 * t + 16]):
            raise ValueError(f"JPEG scan: {_ERRORS[-2]} ({'AC' if t >= 4 else 'DC'} table "
                             f"{t & 3})")
    p = ctypes.c_int64(start)
    err = scan_fn(data, len(data), ctypes.byref(p), ns, info.ctypes.data, planes,
                  tables.ctypes.data, present.ctypes.data, mx, my, ss, se, ah, al,
                  int(progressive), restart)
    if err:
        raise ValueError(f"JPEG scan: {_ERRORS.get(err, f'error {err}')}")
    return p.value


def _pixels(comps, frame, jfif: bool, adobe) -> np.ndarray:
    W, H, hmax, vmax, _mx, _my = frame
    full = []
    for c in comps:
        bh, bw = c.plane.shape[:2]
        blocks = idct_islow(c.plane.reshape(-1, 64), c.quant)
        s = blocks.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)
        s = s[:c.dh, :c.dw]
        full.append(upsample(s, hmax // c.h, vmax // c.v)[:H, :W])
    if len(comps) == 1:
        return np.ascontiguousarray(full[0])
    ids = tuple(c.id for c in comps)
    rgb = (not jfif) and (adobe == 0 if adobe is not None else ids == (82, 71, 66))
    if rgb:
        return np.ascontiguousarray(np.stack(full, axis=-1))
    return ycc_to_rgb(*full)
