"""A PNG reader and writer (standard library ``zlib``, numpy and the port's
host library).

It stands in for ``cv2.imread`` on the single-screenshot path, so the port
does not depend on OpenCV, and gives what ``cv2.imread(path)`` gives: three
8-bit channels. It reads every PNG that the standard allows: grayscale, RGB
and palette images, with or without alpha, at 1 to 16 bits per sample,
interlaced (Adam7) or not. Alpha is dropped without compositing, 16-bit
samples keep their high byte, and grayscale below 8 bits is scaled to 0..255,
as libpng does for OpenCV. Any other file raises ``ValueError``.

``write_png`` writes uint8 BGR or gray images (filter 0, ``zlib``): the
counterpart of ``cv2.imwrite`` of a PNG.

The row filters are undone in C++ (``csrc/host.cpp::png_unfilter``, bound in
``runtime/native.py``); ``_unfilter`` is its plain twin, kept for the tests.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from manual_yolo_tpu_torch.runtime import native

SUPPORTED = ("PNG: grayscale, RGB or palette, with or without alpha, 1 to 16 bits "
             "per sample, interlaced or not")
_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples per pixel, allowed bit depths)
_FORMATS = {
    0: (1, (1, 2, 4, 8, 16)),  # grayscale
    2: (3, (8, 16)),  # RGB
    3: (1, (1, 2, 4, 8)),  # palette
    4: (2, (8, 16)),  # grayscale + alpha
    6: (4, (8, 16)),  # RGBA
}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, height: int, width: int, bpp: int) -> np.ndarray:
    """Plain twin of ``native.png_unfilter``: rows of ``width * bpp`` bytes."""
    stride = width * bpp
    rows = raw.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:  # None
            cur = line.copy()
        elif ftype == 1:  # Sub: running sum along the row, per channel, mod 256
            cur = np.cumsum(line.reshape(width, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype in (3, 4):  # Average / Paeth: each byte needs its left neighbour
            cur_l = [0] * stride
            ln, up = line.tolist(), prev.tolist()
            for i in range(stride):
                a = cur_l[i - bpp] if i >= bpp else 0
                c = up[i - bpp] if i >= bpp else 0
                pred = (a + up[i]) >> 1 if ftype == 3 else _paeth(a, up[i], c)
                cur_l[i] = (ln[i] + pred) & 0xFF
            cur = np.asarray(cur_l, np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype} in row {y}")
        out[y] = cur
        prev = cur
    return out.reshape(height, width, bpp)


def _samples(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered rows (h, stride) -> (h, width, channels) uint8 samples."""
    h = rows.shape[0]
    if depth == 16:  # big-endian pairs: keep the high byte
        return rows.reshape(h, width, channels, 2)[..., 0]
    if depth == 8:
        return rows.reshape(h, width, channels)
    bits = np.unpackbits(rows, axis=1)[:, :width * depth].reshape(h, width, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=-1, dtype=np.uint8)[..., None]


def _bad(path: str, why: str) -> ValueError:
    return ValueError(f"{path}: {why}; only PNG files are read ({SUPPORTED})")


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file to an (H, W, 3) uint8 RGB array."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise _bad(path, "not a PNG file")
    pos, header, palette, idat = 8, None, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            if len(body) != 13:
                raise _bad(path, "malformed IHDR chunk")
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8)[:len(body) // 3 * 3].reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise _bad(path, "no IHDR chunk")
    width, height, depth, color, comp, filt, interlace = header
    if color not in _FORMATS or depth not in _FORMATS[color][1]:
        raise _bad(path, f"colour type {color} at bit depth {depth} is not a PNG format")
    if comp != 0 or filt != 0 or interlace not in (0, 1):
        raise _bad(path, f"compression {comp}, filter method {filt}, interlace {interlace}")
    if color == 3 and palette is None:
        raise _bad(path, "palette image without a PLTE chunk")
    channels = _FORMATS[color][0]
    bits = channels * depth
    bpp = max(1, bits // 8)
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise _bad(path, f"corrupt image data ({e})") from e

    img = np.empty((height, width, channels), np.uint8)
    offset = 0
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        stride = (pw * bits + 7) // 8
        n = ph * (stride + 1)
        if offset + n > raw.size:
            raise _bad(path, f"image data has {raw.size} bytes, too few for {width}x{height}")
        rows = native.png_unfilter(raw[offset:offset + n], ph, stride, bpp)
        img[y0::dy, x0::dx] = _samples(rows, pw, channels, depth)
        offset += n
    if offset != raw.size:
        raise _bad(path, f"image data has {raw.size} bytes, expected {offset}")

    if color == 3:
        if int(img.max(initial=0)) >= len(palette):
            raise _bad(path, "palette index out of range")
        return palette[img[..., 0]]
    if color in (0, 4):
        gray = img[..., 0]
        if depth < 8:
            gray = gray * np.uint8(255 // ((1 << depth) - 1))
        return np.repeat(gray[..., None], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def imread_bgr(path: str) -> np.ndarray:
    """Read an image file as (H, W, 3) uint8 BGR, as ``cv2.imread`` returns it."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"cannot read image: {path}")
    return np.ascontiguousarray(read_png(path)[..., ::-1])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """Write an (H, W, 3) uint8 BGR or (H, W) uint8 gray image as an 8-bit
    PNG (RGB or grayscale, no interlace, every row with filter 0), as
    ``cv2.imwrite(path, img)`` stores it."""
    x = np.asarray(img)
    if x.dtype != np.uint8 or x.ndim not in (2, 3) or (x.ndim == 3 and x.shape[2] != 3) or 0 in x.shape:
        raise ValueError(f"write_png takes (H, W, 3) BGR or (H, W) gray uint8, got {x.dtype} {x.shape}")
    h, w = x.shape[:2]
    rows = x if x.ndim == 2 else x[..., ::-1]
    raw = np.zeros((h, 1 + w * (1 if x.ndim == 2 else 3)), np.uint8)
    raw[:, 1:] = rows.reshape(h, -1)
    header = struct.pack(">IIBBBBB", w, h, 8, 0 if x.ndim == 2 else 2, 0, 0, 0)
    data = (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)
