"""Boxes and labels on a BGR image: the port's ``cv2.rectangle``,
``cv2.getTextSize`` and ``cv2.putText`` (FONT_HERSHEY_SIMPLEX), in numpy.

``rectangle`` gives cv2's pixels (LINE_8, no shift) at thickness 1, 2 and
-1 (filled): cv2 strokes each side as a band 1 pixel (thickness 1) or 3
pixels (thickness 2) across, from corner to corner, and the union of the
four bands is the frame; a thickness-2 corner therefore misses its outer
diagonal pixel, as cv2's does. Corners may come in any order and lie
outside the image (the bands are clipped); a degenerate box is a point or a
line. Other thicknesses raise ``ValueError``.

``text_size`` and ``put_text`` draw OpenCV 5's antialiased font from the
coverage bitmaps in ``runtime/glyphs.py`` (written from cv2's own
rendering by ``tests/torch_font_cases.py``) at the scales the port labels
with, 0.4 and 0.5, thickness 1; another scale or thickness raises
``ValueError``. Glyphs sit at whole-pixel advances with no kerning, and
each one is blended over the image in turn as cv2 blends it,
``(dst * (255 - a) + color * a + 127) // 255``, so the pixels are cv2's. A
character outside printable ASCII is drawn as ``?`` (cv2 draws its own
glyph).
"""

from __future__ import annotations

import base64
import functools
from typing import Dict, Sequence, Tuple

import numpy as np

from manual_yolo_tpu_torch.runtime.glyphs import FONT

Point = Tuple[int, int]


def _color(img: np.ndarray, color: Sequence[float]) -> np.ndarray:
    channels = 1 if img.ndim == 2 else img.shape[2]
    return np.clip([int(round(c)) for c in tuple(color)[:channels]], 0, 255).astype(np.int64)


def _fill(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, color: np.ndarray) -> None:
    """Set the inclusive box [x1, x2] x [y1, y2], clipped to the image."""
    h, w = img.shape[:2]
    x1, y1, x2, y2 = max(x1, 0), max(y1, 0), min(x2, w - 1), min(y2, h - 1)
    if x1 <= x2 and y1 <= y2:
        img[y1:y2 + 1, x1:x2 + 1] = color if img.ndim == 3 else color[0]


def rectangle(img: np.ndarray, p1: Point, p2: Point, color: Sequence[float],
              thickness: int = 1) -> np.ndarray:
    """Draw the box with corners ``p1`` and ``p2`` into ``img`` (uint8, in
    place) as ``cv2.rectangle(img, p1, p2, color, thickness)`` does; returns
    ``img``."""
    if thickness not in (1, 2, -1):
        raise ValueError(f"rectangle draws at thickness 1, 2 or -1 (filled), not {thickness}")
    if img.dtype != np.uint8:
        raise ValueError(f"rectangle draws on uint8 images, not {img.dtype}")
    col = _color(img, color)
    xa, xb = sorted((int(p1[0]), int(p2[0])))
    ya, yb = sorted((int(p1[1]), int(p2[1])))
    if thickness < 0:
        _fill(img, xa, ya, xb, yb, col)
        return img
    r = thickness - 1  # the band's half-width across: 0 or 1
    for y in (ya, yb):
        _fill(img, xa, y - r, xb, y + r, col)
    for x in (xa, xb):
        _fill(img, x - r, ya, x + r, yb, col)
    return img


@functools.lru_cache(maxsize=None)
def _font(scale: float) -> Dict:
    if scale not in FONT:
        raise ValueError(f"the label font has scales {sorted(FONT)}, not {scale!r}")
    f = FONT[scale]
    chars = {}
    for c, (adv, width, base, dx, dy, w, h, b64) in f["chars"].items():
        ink = np.frombuffer(base64.b64decode(b64), np.uint8).reshape(h, w).astype(np.int64)
        chars[c] = (adv, width, base, dx, dy, ink)
    return {"height": f["height"], "chars": chars}


def _glyphs(text: str, scale: float, thickness: int):
    if thickness != 1:
        raise ValueError(f"the label font is drawn at thickness 1, not {thickness}")
    font = _font(float(scale))
    chars = font["chars"]
    return font, [chars.get(c, chars["?"]) for c in text]


def text_size(text: str, scale: float, thickness: int = 1) -> Tuple[Tuple[int, int], int]:
    """``((width, height), baseline)`` as ``cv2.getTextSize(text,
    FONT_HERSHEY_SIMPLEX, scale, thickness)`` gives it."""
    font, glyphs = _glyphs(text, scale, thickness)
    if not glyphs:
        return (0, 0), 0
    width = sum(g[0] for g in glyphs[:-1]) + glyphs[-1][1]
    return (width, font["height"]), max(g[2] for g in glyphs)


def put_text(img: np.ndarray, text: str, org: Point, scale: float, color: Sequence[float],
             thickness: int = 1) -> np.ndarray:
    """Draw ``text`` into ``img`` (uint8, in place) with the left end of its
    baseline at ``org``, as ``cv2.putText(img, text, org,
    FONT_HERSHEY_SIMPLEX, scale, color, thickness)`` does; returns ``img``."""
    if img.dtype != np.uint8:
        raise ValueError(f"put_text draws on uint8 images, not {img.dtype}")
    _, glyphs = _glyphs(text, scale, thickness)
    col = _color(img, color)
    h, w = img.shape[:2]
    pen = int(org[0])
    for adv, _width, _base, dx, dy, ink in glyphs:
        x0, y0 = pen + dx, int(org[1]) + dy
        pen += adv
        gh, gw = ink.shape
        cx1, cy1, cx2, cy2 = max(x0, 0), max(y0, 0), min(x0 + gw, w), min(y0 + gh, h)
        if cx1 >= cx2 or cy1 >= cy2:
            continue
        a = ink[cy1 - y0:cy2 - y0, cx1 - x0:cx2 - x0]
        dst = img[cy1:cy2, cx1:cx2]
        if img.ndim == 3:
            a = a[..., None]
        dst[...] = (dst.astype(np.int64) * (255 - a) + col * a + 127) // 255
    return img
