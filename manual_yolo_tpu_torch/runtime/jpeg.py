"""A JPEG reader and writer: what ``cv2.imread`` gives for a JPEG file, and
what ``cv2.imencode(".jpg")`` writes, without OpenCV.

Baseline, extended (8-bit) and progressive Huffman JPEG with one or three
components are decoded by the host library (``csrc/host.cpp::jpeg_decode``,
bound in ``runtime/native.py``), byte for byte as libjpeg-turbo decodes with
its defaults (islow IDCT, fancy upsampling), in one call that releases the
interpreter lock. The decoder alone walks the markers (skipping stray bytes
between segments, as libjpeg does) and hands back the first APP1 segment,
whose EXIF orientation (tag 0x0112, values 1 to 8) is applied here as
``cv2.imread`` applies it by default. Grayscale gives three equal channels,
as ``IMREAD_COLOR`` does.

Where cv2 differs: a truncated or corrupt stream raises ``ValueError`` (cv2
returns what it decoded, the rest grey), and so do arithmetic coding, 12-bit
samples, CMYK or YCCK files and lossless or hierarchical JPEG, which cv2
reads. Every error names the file and the reason.

``encode_jpeg`` writes the bytes of ``cv2.imencode(".jpg", img,
[IMWRITE_JPEG_QUALITY, quality])`` byte for byte (``csrc/host.cpp::jpeg_encode``,
one call that releases the interpreter lock): libjpeg-turbo's defaults, a
JFIF header, baseline Huffman coding with the standard tables, 4:2:0 YCbCr
for BGR and one component for a 2-D gray array. cv2's other JPEG options
(progressive, optimised tables, restart intervals, other samplings) are not
offered.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from manual_yolo_tpu_torch.runtime import native

SIGNATURE = b"\xff\xd8\xff"  # SOI and the first marker's 0xFF
SUPPORTED = "JPEG: baseline or progressive Huffman coding, 8-bit, grayscale or 3-component"


def exif_orientation(app1: Optional[bytes]) -> int:
    """The orientation tag (0x0112) of IFD0 in an APP1 body, 1 without one.

    As OpenCV's ExifReader reads it: the TIFF header starts 6 bytes in (after
    ``Exif\\0\\0``), little ("II") or big ("MM") endian, 42, the IFD0 offset,
    then 12-byte entries whose value field holds the orientation as a short.
    Whatever does not parse means no orientation."""
    if app1 is None or len(app1) < 6 + 8:
        return 1
    tiff = app1[6:]
    order = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if order is None or struct.unpack(order + "H", tiff[2:4])[0] != 42:
        return 1
    (ifd,) = struct.unpack(order + "I", tiff[4:8])
    if ifd + 2 > len(tiff):
        return 1
    (count,) = struct.unpack(order + "H", tiff[ifd:ifd + 2])
    for i in range(count):
        entry = ifd + 2 + 12 * i
        if entry + 12 > len(tiff):
            break
        if struct.unpack(order + "H", tiff[entry:entry + 2])[0] == 0x0112:
            return struct.unpack(order + "H", tiff[entry + 8:entry + 10])[0]
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """Turn a decoded image upright as OpenCV's ``ExifTransform`` does: 2-4
    flip, 5-8 transpose and then flip; any other value leaves it as it is."""
    if 5 <= orientation <= 8:
        img = img.transpose(1, 0, 2)
    flips = {2: (slice(None), slice(None, None, -1)), 3: (slice(None, None, -1),) * 2,
             4: (slice(None, None, -1),), 6: (slice(None), slice(None, None, -1)),
             7: (slice(None, None, -1),) * 2, 8: (slice(None, None, -1),)}
    if orientation in flips:
        img = img[flips[orientation]]
    return np.ascontiguousarray(img)


def read_jpeg(path: str) -> np.ndarray:
    """Decode a JPEG file to (H, W, 3) uint8 BGR, EXIF orientation applied."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        img, app1 = native.jpeg_decode(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}; only these JPEG files are read ({SUPPORTED})") from None
    return apply_orientation(img, exif_orientation(app1))


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """(H, W, 3) uint8 BGR or (H, W) uint8 gray -> the JPEG file's bytes, as
    ``cv2.imencode`` writes them at ``quality`` (0 to 100; cv2's default 95)."""
    return native.jpeg_encode(img, quality)


def write_jpeg(path: str, img: np.ndarray, quality: int = 95) -> None:
    """Write ``img`` to ``path`` as ``cv2.imwrite`` writes a ``.jpg``."""
    data = encode_jpeg(img, quality)
    with open(path, "wb") as f:
        f.write(data)
