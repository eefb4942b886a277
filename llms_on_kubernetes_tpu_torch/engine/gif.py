"""GIF decoding without PIL, frame by frame as PIL 12 composites it
(counterpart of what ``llms_on_kubernetes_tpu/server/openai_api.py`` asks
of PIL for a GIF ``image_url`` or ``video_url``).

- Read: the logical screen, global and local colour tables, the graphic
  control extension (delay, disposal, transparency), interlaced frames;
  application, comment and other extensions are skipped.
- ``gif_frames``: the size (the logical screen, grown to hold frame 0
  as PIL's ``open`` grows it), the frame count and each frame's duration
  without decoding any pixels (PIL's ``size``, ``n_frames`` and
  ``info["duration"]``).
- ``decode_gif_frames(data, want)`` walks every frame up to the last one
  wanted, composites each as PIL's default ``LOADING_STRATEGY``
  (``RGB_AFTER_FIRST``) does, and returns the wanted frames as RGB, which
  is what PIL's ``seek(i)`` then ``convert("RGB")`` give:

  - a frame whose rectangle leaves the logical screen grows the screen to
    hold it, when that frame is decoded (PIL's ``size`` then stays the
    larger one); a later frame's new area is black where the frame has a
    transparent index, else its palette's entry 0, and the rest keeps the
    composite;
  - frame 0 is a palette (or, without a palette, grey) image: the screen
    filled with the frame's transparent index (else 0), the frame's
    pixels written over its rectangle, all of them;
  - each later frame is drawn over the composite: the pixels that are not
    its transparent index replace the composite's, in the frame's own
    palette;
  - disposal (the last non-zero disposal method read, as PIL keeps it):
    2 fills the frame's rectangle, before the next frame, with the colour
    of its transparent index, else of the screen's background index; 3
    restores the rectangle as it was before the frame (black where it lay
    outside the screen; on frame 0, the transparent index's colour, or
    nothing without one);
  - palette lookups past a table's end give black; a frame without any
    palette (or with PIL's identity grey one) is grey. When frame 0 is
    grey, PIL keeps the image grey: disposal 2 then fills with frame 0's
    transparent index where it has one, and a later frame with a colour
    table is refused (PIL's pixels there come from its internals, or it
    raises), as is a frame without one that grows a colour GIF's screen
    (PIL raises).
- ``decode_gif(data)``: frame 0, as a still ``image_url`` is read.

The LZW stage is C (``csrc/host/media.c``, ``kernels.host_function``),
built on first use; there is no Python fallback. Truncated data, an LZW
code past the table or a screen grown past ``MAX_IMAGE_PIXELS`` raises
``ValueError``.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from llms_on_kubernetes_tpu_torch.engine.images import MAX_IMAGE_PIXELS

_RAMP = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)


class _Frame:
    """One image descriptor and what precedes it."""

    __slots__ = ("x0", "y0", "w", "h", "interlace", "palette", "transparency", "duration",
                 "disposal", "code_size", "data_pos")


def _palette(raw: bytes):
    """The colour table, or None where PIL finds it needless (entry i is
    (i, i, i) throughout)."""
    p = np.frombuffer(raw, np.uint8).reshape(-1, 3)
    if (p == np.arange(len(p), dtype=np.uint8)[:, None]).all() and len(p) <= 256:
        return None
    return p


def _lut(palette) -> np.ndarray:
    """Index -> RGB [256, 3]: the palette, black past its end; grey without
    one (PIL's "L" mode)."""
    if palette is None:
        return _RAMP
    lut = np.zeros((256, 3), np.uint8)
    lut[:min(len(palette), 256)] = palette[:256]
    return lut


def _skip_blocks(data: bytes, pos: int) -> int:
    """The position after a chain of data sub-blocks."""
    n = len(data)
    while True:
        if pos >= n:
            raise ValueError("GIF is truncated")
        k = data[pos]
        pos += 1 + k
        if k == 0:
            return pos


def _check_pixels(W: int, H: int) -> None:
    if W * H > MAX_IMAGE_PIXELS:
        raise ValueError(f"GIF of {W}x{H} pixels is larger than the {MAX_IMAGE_PIXELS} "
                         f"pixels the server decodes")


def parse_gif(data: bytes):
    """(width, height, global palette or None, background index or None,
    frames): the structure of every frame, no pixel decoded. The size is
    the logical screen's, grown to hold frame 0."""
    if len(data) < 13 or data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF")
    W, H, flags, bg, _aspect = struct.unpack("<HHBBB", data[6:13])
    _check_pixels(W, H)
    pos, gpal, background = 13, None, None
    if flags & 0x80:
        size = 3 << ((flags & 7) + 1)
        if pos + size > len(data):
            raise ValueError("GIF is truncated")
        gpal = _palette(data[pos:pos + size])
        background = bg
        pos += size
    frames = []
    gce = {}
    disposal = 0
    n = len(data)
    while True:
        if pos >= n:
            if frames:      # PIL stops at the end of the data as at a trailer
                break
            raise ValueError("GIF is truncated")
        c = data[pos]
        if c == 0x3B:                                   # trailer
            break
        if c == 0x21:                                   # extension
            if pos + 2 > n:
                raise ValueError("GIF is truncated")
            label = data[pos + 1]
            if label == 0xF9 and pos + 3 < n and data[pos + 2] >= 4:
                blk = data[pos + 3:pos + 3 + data[pos + 2]]
                if len(blk) < 4:
                    raise ValueError("GIF is truncated")
                fl = blk[0]
                gce = {"duration": struct.unpack("<H", blk[1:3])[0] * 10,
                       "transparency": blk[3] if fl & 1 else None}
                if (fl >> 2) & 7:
                    disposal = (fl >> 2) & 7
            pos = _skip_blocks(data, pos + 2)
            continue
        if c != 0x2C:           # any other byte is skipped, as PIL skips it
            pos += 1
            continue
        if pos + 10 > n:
            raise ValueError("GIF is truncated")
        f = _Frame()
        f.x0, f.y0, f.w, f.h, fl = struct.unpack("<HHHHB", data[pos + 1:pos + 10])
        pos += 10
        f.interlace = bool(fl & 0x40)
        f.palette = gpal
        if fl & 0x80:
            size = 3 << ((fl & 7) + 1)
            if pos + size > n:
                raise ValueError("GIF is truncated")
            f.palette = _palette(data[pos:pos + size])
            if f.palette is None:       # a needless local table: grey, not the global one
                f.palette = False
            pos += size
        if pos >= n:
            raise ValueError("GIF is truncated")
        f.code_size = data[pos]
        f.data_pos = pos + 1
        f.duration = gce.get("duration")
        f.transparency = gce.get("transparency")
        f.disposal = disposal
        frames.append(f)
        gce = {}
        pos = _skip_blocks(data, pos + 1)
    if not frames:
        raise ValueError("GIF has no image")
    W, H = _grown(W, H, frames[0])
    return W, H, gpal, background, frames


def _grown(W: int, H: int, f: _Frame) -> tuple[int, int]:
    """The screen grown to hold the frame's rectangle, as PIL grows it."""
    W, H = max(W, f.x0 + f.w), max(H, f.y0 + f.h)
    _check_pixels(W, H)
    return W, H


def gif_frames(data: bytes) -> tuple[int, int, list]:
    """(width, height, each frame's duration in ms or None), no pixel
    decoded."""
    W, H, _p, _b, frames = parse_gif(data)
    return W, H, [f.duration for f in frames]


def _indices(data: bytes, f: _Frame, lzw) -> np.ndarray:
    """The frame's palette indices [h, w] in display order; pixels the
    data does not reach keep the fill index (the transparent one, else 0)."""
    npix = f.w * f.h
    out = np.full(npix, f.transparency or 0, np.uint8)
    p, written = ctypes.c_int64(f.data_pos), ctypes.c_int64(0)
    err = lzw(data, len(data), ctypes.byref(p), f.code_size, out.ctypes.data, npix,
              ctypes.byref(written))
    if err == -1:
        raise ValueError("GIF image data is truncated")
    if err:
        raise ValueError("GIF image data is corrupt (an LZW code past the table)"
                         if err == -8 else f"GIF image data is invalid (error {err})")
    rows = out.reshape(f.h, f.w)
    if f.interlace:
        order = np.concatenate([np.arange(0, f.h, 8), np.arange(4, f.h, 8),
                                np.arange(2, f.h, 4), np.arange(1, f.h, 2)])
        fixed = np.empty_like(rows)
        fixed[order] = rows
        rows = fixed
    return rows


def decode_gif_frames(data: bytes, want) -> tuple[int, dict, list]:
    """(frame count, {i: uint8 [H, W, 3]} for each i in ``want``, every
    frame's duration in ms or None), compositing every frame up to the
    last one wanted as PIL does."""
    from llms_on_kubernetes_tpu_torch import kernels

    W, H, _gpal, background, frames = parse_gif(data)
    want = set(want)
    last = max(want) if want else -1
    lzw = kernels.host_function("llmk_gif_lzw")
    out: dict = {}
    canvas = None          # RGB composite (frames >= 1)
    dispose = None         # (y0, y1, x0, x1, RGB block) to paste before the next frame
    # a grey frame 0 keeps PIL's image grey ("L") for good: it composites
    # raw indices, and its disposal colour is frame 0's transparent index
    grey = frames[0].palette is None or frames[0].palette is False
    for i, f in enumerate(frames[:last + 1]):
        pal = None if f.palette is False else f.palette
        if i > 0 and grey and pal is not None:
            raise ValueError("unsupported image: a GIF whose first frame is grey and a later "
                             "frame has a colour table")
        lut = _lut(pal)
        idx = _indices(data, f, lzw)
        ys, xs = slice(f.y0, f.y0 + f.h), slice(f.x0, f.x0 + f.w)
        t = f.transparency
        if i == 0:
            screen = np.full((H, W), t if t is not None else 0, np.uint8)
            prior = None if t is None else lut[screen[ys, xs]]
            screen[ys, xs] = idx
            canvas = lut[screen]
        else:
            if dispose is not None:
                canvas[dispose[0]] = dispose[1]
            # the rectangle before the frame, black past the old screen
            prior = np.zeros((f.h, f.w, 3), np.uint8)
            old = canvas[ys, xs]
            prior[:old.shape[0], :old.shape[1]] = old
            W, H = _grown(W, H, f)
            if (H, W) != canvas.shape[:2]:
                if t is None and pal is None and not grey:
                    raise ValueError("GIF frame without a colour table grows the screen of a "
                                     "colour GIF (PIL finds no palette for it)")
                grown = np.empty((H, W, 3), np.uint8)
                grown[...] = 0 if t is not None else lut[0]
                grown[:canvas.shape[0], :canvas.shape[1]] = canvas
                canvas = grown
            if t is None:
                canvas[ys, xs] = lut[idx]
            else:
                keep = idx == t
                canvas[ys, xs] = np.where(keep[..., None], canvas[ys, xs], lut[idx])
        # the disposal this frame leaves for the next
        dispose = None
        if f.disposal == 2:
            t0 = frames[0].transparency if grey and i > 0 else None
            color = t0 if t0 is not None else t if t is not None else (background or 0)
            rgb = _color(pal, color) if i > 0 else lut[color]
            dispose = ((ys, xs), rgb)
        elif f.disposal == 3 and (i > 0 or t is not None):
            dispose = ((ys, xs), prior)
        if i in want:
            out[i] = canvas.copy()
    return len(frames), out, [f.duration for f in frames]


def _color(palette, color: int) -> np.ndarray:
    """PIL's ``_rgb``: a palette entry (entry 0 past the table's end), or
    grey without a palette."""
    if palette is None:
        return np.array([color] * 3, np.uint8)
    if color * 3 + 3 > palette.size:
        color = 0
    return palette[color]


def decode_gif(data: bytes) -> np.ndarray:
    """GIF bytes -> frame 0 as uint8 [H, W, 3] (``convert("RGB")``)."""
    _n, frames, _d = decode_gif_frames(data, [0])
    return frames[0]
