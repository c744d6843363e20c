"""Headless raster drawing primitives + PNG IO (pure numpy + stdlib).

The reference's visualizers render through OpenCV ``highgui`` windows
(``Modules/Visualization/FrameVisualizer.cc``); a compute host is
headless, so this framework renders to numpy images and writes PNG files
instead. Zero hard third-party dependencies: PNG encoding uses ``zlib`` +
``struct`` from the stdlib.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# BGR-free: we work in RGB uint8.
GREEN = (0, 255, 0)
RED = (255, 0, 0)
BLUE = (0, 0, 255)
BLACK = (0, 0, 0)
WHITE = (255, 255, 255)
YELLOW = (255, 255, 0)


def to_rgb(im) -> np.ndarray:
    """Grayscale/float image -> uint8 RGB canvas."""
    a = np.asarray(im)
    if a.dtype != np.uint8:
        a = np.clip(a, 0, 255).astype(np.uint8)
    if a.ndim == 2:
        a = np.stack([a, a, a], axis=-1)
    return a.copy()


def draw_circle(im, x, y, radius: int, color, thickness: int = 1) -> None:
    """Rasterize a circle outline (or disk when thickness < 0) in place."""
    h, w = im.shape[:2]
    x, y = float(x), float(y)
    r = int(max(radius, 1))
    y0, y1 = max(int(y) - r - 1, 0), min(int(y) + r + 2, h)
    x0, x1 = max(int(x) - r - 1, 0), min(int(x) + r + 2, w)
    if y0 >= y1 or x0 >= x1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    d = np.sqrt((yy - y) ** 2 + (xx - x) ** 2)
    if thickness < 0:
        sel = d <= r
    else:
        sel = np.abs(d - r) <= max(thickness, 1) * 0.6
    im[y0:y1, x0:x1][sel] = color


def draw_line(im, x0, y0, x1, y1, color, thickness: int = 1) -> None:
    """Rasterize a line segment in place (dense sampling; fine for overlays)."""
    h, w = im.shape[:2]
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) * 2 + 1
    t = np.linspace(0.0, 1.0, n)
    xs = np.round(x0 + (x1 - x0) * t).astype(int)
    ys = np.round(y0 + (y1 - y0) * t).astype(int)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    xs, ys = xs[ok], ys[ok]
    im[ys, xs] = color
    if thickness > 1:
        for dy in range(-(thickness // 2), thickness // 2 + 1):
            for dx in range(-(thickness // 2), thickness // 2 + 1):
                xs2, ys2 = xs + dx, ys + dy
                ok = (xs2 >= 0) & (xs2 < w) & (ys2 >= 0) & (ys2 < h)
                im[ys2[ok], xs2[ok]] = color


def hstack_images(im1: np.ndarray, im2: np.ndarray) -> np.ndarray:
    """Side-by-side canvas (pads heights), as cv::drawMatches lays out."""
    h = max(im1.shape[0], im2.shape[0])
    out = np.zeros((h, im1.shape[1] + im2.shape[1], 3), dtype=np.uint8)
    out[: im1.shape[0], : im1.shape[1]] = im1
    out[: im2.shape[0], im1.shape[1] :] = im2
    return out


def write_png(path: str, im: np.ndarray) -> None:
    """Minimal RGB(A)/gray PNG writer (stdlib only)."""
    a = np.asarray(im)
    if a.dtype != np.uint8:
        a = np.clip(a, 0, 255).astype(np.uint8)
    if a.ndim == 2:
        color_type = 0
        raw = a[:, :, None]
    elif a.shape[2] == 3:
        color_type = 2
        raw = a
    else:
        color_type = 6
        raw = a
    h, w = raw.shape[:2]
    # Filter byte 0 (None) per scanline.
    scanlines = b"".join(b"\x00" + raw[i].tobytes() for i in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
    data += chunk(b"IDAT", zlib.compress(scanlines, 6)) + chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader for images written by :func:`write_png` (8-bit,
    non-interlaced, filter 0/1/2/3/4)."""
    with open(path, "rb") as f:
        blob = f.read()
    assert blob[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    w = h = None
    color_type = 0
    idat = b""
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos : pos + 4])
        tag = blob[pos + 4 : pos + 8]
        payload = blob[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, color_type, *_ = struct.unpack(">IIBBBBB", payload)
            assert depth == 8, "only 8-bit PNGs supported"
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    nch = {0: 1, 2: 3, 6: 4}[color_type]
    raw = zlib.decompress(idat)
    stride = w * nch
    out = np.zeros((h, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    pos = 0
    for i in range(h):
        ftype = raw[pos]
        line = np.frombuffer(raw[pos + 1 : pos + 1 + stride], dtype=np.uint8).astype(np.int32)
        pos += 1 + stride
        if ftype == 0:
            rec = line
        elif ftype == 2:  # Up
            rec = (line + prev) % 256
        else:  # Sub / Average / Paeth need sequential reconstruction
            rec = np.zeros(stride, dtype=np.int32)
            for j in range(stride):
                left = rec[j - nch] if j >= nch else 0
                up = int(prev[j])
                ul = int(out[i - 1, j - nch]) if (i > 0 and j >= nch) else 0
                if ftype == 1:
                    pred = left
                elif ftype == 3:
                    pred = (left + up) // 2
                else:
                    p = left + up - ul
                    pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
                    pred = left if (pa <= pb and pa <= pc) else (up if pb <= pc else ul)
                rec[j] = (line[j] + pred) % 256
        out[i] = rec.astype(np.uint8)
        prev = out[i]
    a = out.reshape(h, w, nch)
    return a[:, :, 0] if nch == 1 else a
