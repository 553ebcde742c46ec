"""A BMP reader and writer: what ``cv2.imread`` gives for a BMP file, and what
``cv2.imencode(".bmp")`` writes, with numpy and the standard library.

``encode_bmp`` writes cv2's bytes: a 14-byte file header and a 40-byte
BITMAPINFOHEADER (no resolution, image size 0), rows bottom-up, each padded
to 4 bytes; 24-bit BGR for (H, W, 3) input, 8-bit with a 256-entry gray
palette for (H, W) input.

``read_bmp`` reads uncompressed BMP files as OpenCV's decoder does: 1-, 4-
and 8-bit palette images, 24-bit, and 32-bit (BI_RGB, or BI_BITFIELDS with
the standard masks, the layout cv2 writes for BGRA), bottom-up or top-down,
with any of the header sizes (12 to 124 bytes). The result is (H, W, 3)
uint8 BGR; alpha is dropped. RLE-compressed, 16-bit and other bit-field
files raise ``ValueError`` naming the file (cv2 reads those).
"""

from __future__ import annotations

import struct

import numpy as np

SIGNATURE = b"BM"
SUPPORTED = ("BMP: uncompressed 1-, 4- or 8-bit palette, 24-bit, or 32-bit "
             "(BI_RGB or standard bit fields)")
_FILE_HEADER = 14
_INFO_HEADER = 40
_GRAY_PALETTE = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 4, axis=1)
_GRAY_PALETTE[:, 3] = 0
_STD_MASKS = (0x00FF0000, 0x0000FF00, 0x000000FF)  # R, G, B


def _stride(width: int, bits: int) -> int:
    return (width * bits + 31) // 32 * 4


def encode_bmp(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 BGR or (H, W) uint8 gray -> the bytes of
    ``cv2.imencode(".bmp", img)``."""
    x = np.asarray(img)
    if x.dtype != np.uint8 or x.ndim not in (2, 3) or (x.ndim == 3 and x.shape[2] != 3) or 0 in x.shape:
        raise ValueError(f"encode_bmp takes (H, W, 3) BGR or (H, W) gray uint8, got {x.dtype} {x.shape}")
    h, w = x.shape[:2]
    bits = 8 if x.ndim == 2 else 24
    stride = _stride(w, bits)
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * bits // 8] = x[::-1].reshape(h, -1)
    palette = _GRAY_PALETTE.tobytes() if bits == 8 else b""
    offset = _FILE_HEADER + _INFO_HEADER + len(palette)
    header = (struct.pack("<2sIII", SIGNATURE, offset + rows.size, 0, offset)
              + struct.pack("<IiiHHIIiiII", _INFO_HEADER, w, h, 1, bits, 0, 0, 0, 0, 0, 0))
    return header + palette + rows.tobytes()


def write_bmp(path: str, img: np.ndarray) -> None:
    """Write ``img`` to ``path`` as ``cv2.imwrite`` writes a ``.bmp``."""
    data = encode_bmp(img)
    with open(path, "wb") as f:
        f.write(data)


def _bad(path: str, why: str) -> ValueError:
    return ValueError(f"{path}: {why}; only these BMP files are read ({SUPPORTED})")


def read_bmp(path: str) -> np.ndarray:
    """Decode a BMP file to (H, W, 3) uint8 BGR, as ``cv2.imread`` does."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != SIGNATURE or len(data) < _FILE_HEADER + 12:
        raise _bad(path, "not a BMP file")
    (offset,) = struct.unpack_from("<I", data, 10)
    (size,) = struct.unpack_from("<I", data, _FILE_HEADER)
    if not 40 <= size <= 124 or len(data) < _FILE_HEADER + 40:
        raise _bad(path, f"a {size}-byte info header")
    w, h, _planes, bits, compression, _, _, _, colors = struct.unpack_from(
        "<iiHHIIiiI", data, _FILE_HEADER + 4)
    top_down = h < 0
    h = abs(h)
    if w <= 0 or h == 0:
        raise _bad(path, f"a {w}x{h} image")
    if bits in (1, 4, 8) and compression == 0:
        n = colors or (1 << bits)
        start = _FILE_HEADER + size
        table = np.frombuffer(data, np.uint8, n * 4, start).reshape(n, 4)[:, :3]
    elif bits == 24 and compression == 0:
        table = None
    elif bits == 32 and compression in (0, 3):
        if compression == 3:
            at = _FILE_HEADER + 40  # in the V4/V5 header, or just after the 40-byte one
            if tuple(struct.unpack_from("<III", data, at)) != _STD_MASKS:
                raise _bad(path, "32-bit with non-standard bit fields")
        table = None
    else:
        raise _bad(path, f"{bits}-bit with compression {compression}")
    stride = _stride(w, bits)
    if offset + stride * h > len(data):
        raise _bad(path, f"{len(data) - offset} bytes of pixels, too few for {w}x{h} at {bits} bits")
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h, stride)
    if not top_down:
        rows = rows[::-1]
    if table is None:
        return np.ascontiguousarray(rows[:, :w * bits // 8].reshape(h, w, bits // 8)[..., :3])
    if bits == 8:
        idx = rows[:, :w]
    else:  # 1 or 4 bits, most significant first
        idx = np.unpackbits(rows, axis=1)[:, :w * bits].reshape(h, w, bits)
        idx = (idx * (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)).sum(-1, dtype=np.uint8)
    if int(idx.max(initial=0)) >= len(table):
        raise _bad(path, "palette index out of range")
    return np.ascontiguousarray(table[idx])
