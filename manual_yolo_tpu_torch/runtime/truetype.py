"""The parts of PIL's TrueType text and blur that the OCR trainers call, from
a committed table (``truetype.npz`` beside this file), so that the port
renders the JAX package's training text without PIL, FreeType or the fonts.

``tests/torch_truetype_cases.py`` writes the table from PIL's own layout
and FreeType's bitmaps for the six DejaVu fonts of ``train/ocr.py::FONTS``,
sizes 14 to 29, and the CRNN charset. What this module does with it is
PIL's own arithmetic (``_imagingft.c``, ``Draw.c``, ``BoxBlur.c``):

  * layout: first the fonts' default ligatures (ff, fi, fl, ffi, ffl in
    all but the Mono faces), lookup by lookup as HarfBuzz applies them;
    then pen positions, the running sum of the advances and pair kerning
    in 1/64 px, each glyph drawn at ``(pos + 32) >> 6``;
  * ``getbbox``: the glyphs' control boxes and the pen line from 0 to the
    rounded end, y measured from the ascender (PIL's default anchor "la");
  * ``getmask``: the glyph bitmaps at their positions, each laid over the
    mask as ``src + target * (255 - src) / 255`` (PIL's MULDIV255);
  * ``draw_text``: the mask blended into an L or RGB canvas with the fill,
    ``(dst * (255 - m) + ink * m) / 255`` rounded as PIL's ``DIV255``;
  * ``gaussian_blur``: PIL's extended box blur, three passes each way on
    uint8 with 24-bit fixed-point weights.

Fonts are named by their file path, as ``ImageFont.truetype`` takes them;
only the file's base name is looked up.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "truetype.npz")


@functools.lru_cache(maxsize=1)
def _table() -> Dict[str, np.ndarray]:
    with np.load(TABLE) as z:
        t = {k: z[k] for k in z.files}
    t["index"] = {c: i for i, c in enumerate(str(t["chars"]))}
    t["ligatures"] = json.loads(str(t["ligatures"]))
    return t


def substitute(text: str, lookups: Sequence[Sequence[Tuple[str, str]]]) -> str:
    """Apply ligature lookups in order, each left to right over the text, at
    each position the first rule whose characters follow (GSUB type 4)."""
    for rules in lookups:
        out: List[str] = []
        i = 0
        while i < len(text):
            for seq, lig in rules:
                if text.startswith(seq, i):
                    out.append(lig)
                    i += len(seq)
                    break
            else:
                out.append(text[i])
                i += 1
        text = "".join(out)
    return text


def _muldiv255(a, b):
    """PIL's MULDIV255: ``a * b / 255`` rounded, in integers."""
    v = a * b + 128
    return ((v >> 8) + v) >> 8


def _pixel(x):
    """PIL's PIXEL(): 26.6 fixed point to the nearest pixel."""
    return (x + 32) >> 6


class FreeTypeFont:
    """``ImageFont.truetype(path, size)`` for a font and size of the table."""

    def __init__(self, path: str, size: int):
        t = _table()
        fonts = [str(f) for f in t["fonts"]]
        name = os.path.basename(path)
        if name not in fonts or size not in t["sizes"]:
            raise ValueError(f"no glyph table for {name} at {size} px "
                             f"(fonts {fonts}, sizes {t['sizes'].min()}..{t['sizes'].max()})")
        fi, si = fonts.index(name), int(np.flatnonzero(t["sizes"] == size)[0])
        self.path, self.size = path, size
        self._adv = t["adv"][fi, si].astype(np.int64)
        self._kern = t["kern"][fi, si].astype(np.int64)
        self._box = t["box"][fi, si].astype(np.int64)
        self._offset = t["offset"][fi, si]
        self._asc = int(t["asc"][fi, si])
        self._pixels = t["pixels"]
        self._index = t["index"]
        self._ligatures = t["ligatures"][fi]

    def _ids(self, text: str) -> np.ndarray:
        try:
            return np.array([self._index[c] for c in text], np.int64)
        except KeyError as e:
            raise ValueError(f"character {e.args[0]!r} is not in the glyph table") from None

    def _layout(self, text: str):
        """(glyph ids, pen position of each glyph in 1/64 px, end position)."""
        ids = self._ids(substitute(text, self._ligatures))
        step = self._adv[ids]
        if len(ids) > 1:
            step[:-1] += self._kern[ids[:-1], ids[1:]]
        ends = np.cumsum(step)
        return ids, ends - step, int(ends[-1]) if len(ids) else 0

    def _extent(self, text: str) -> Tuple[int, int, int, int]:
        """(x_min, y_min, x_max, y_max) in px, y up from the baseline, the
        origin and the rounded pen end included."""
        ids, pos, end = self._layout(text)
        if not len(ids):
            return 0, 0, 0, 0
        left, top, width, rows = self._box[ids].T
        px = _pixel(pos)
        x_min = min(0, int((px + left).min()))
        x_max = max(_pixel(end), int((px + left + width).max()))
        y_min = min(0, int((top - rows).min()))
        y_max = max(0, int(top.max()))
        return x_min, y_min, x_max, y_max

    def getlength(self, text: str) -> float:
        return self._layout(text)[2] / 64.0

    def getbbox(self, text: str) -> Tuple[int, int, int, int]:
        x_min, y_min, x_max, y_max = self._extent(text)
        if not text:
            return 0, 0, 0, 0
        return x_min, self._asc - y_max, x_max, self._asc - y_min

    def getmask(self, text: str) -> Tuple[np.ndarray, Tuple[int, int]]:
        """(coverage (h, w) uint8, (dx, dy) of its top-left from the text origin)."""
        x_min, y_min, x_max, y_max = self._extent(text)
        mask = np.zeros((y_max - y_min, x_max - x_min), np.uint8)
        if not text:
            return mask, (0, 0)
        ids, pos, _ = self._layout(text)
        h, w = mask.shape
        for g, p in zip(ids.tolist(), _pixel(pos).tolist()):
            left, top, gw, gh = self._box[g].tolist()
            if not gw or not gh:
                continue
            cover = self._pixels[self._offset[g]:self._offset[g] + gw * gh].reshape(gh, gw)
            x0, y0 = p - x_min + left, y_max - top
            cx0, cy0 = max(0, -x0), max(0, -y0)
            cx1, cy1 = min(gw, w - x0), min(gh, h - y0)
            if cx0 >= cx1 or cy0 >= cy1:
                continue
            dst = mask[y0 + cy0:y0 + cy1, x0 + cx0:x0 + cx1]
            src = cover[cy0:cy1, cx0:cx1].astype(np.int32)
            dst[...] = src + _muldiv255(dst.astype(np.int32), 255 - src)
        return mask, (x_min, self._asc - y_max)


@functools.lru_cache(maxsize=None)
def truetype(path: str, size: int) -> FreeTypeFont:
    return FreeTypeFont(path, int(size))


def draw_text(img: np.ndarray, xy: Tuple[int, int], text: str, font: FreeTypeFont,
              fill) -> None:
    """``ImageDraw.Draw(img).text(xy, text, fill=fill, font=font)`` in place on
    an (H, W) or (H, W, C) uint8 array; ``fill`` is a level or one per channel."""
    mask, (dx, dy) = font.getmask(text)
    x0, y0 = int(xy[0]) + dx, int(xy[1]) + dy
    h, w = img.shape[:2]
    mh, mw = mask.shape
    cx0, cy0 = max(0, -x0), max(0, -y0)
    cx1, cy1 = min(mw, w - x0), min(mh, h - y0)
    if cx0 >= cx1 or cy0 >= cy1:
        return
    m = mask[cy0:cy1, cx0:cx1].astype(np.int64)
    region = img[y0 + cy0:y0 + cy1, x0 + cx0:x0 + cx1]
    ink = np.asarray(fill, np.int64)
    if img.ndim == 3:
        m = m[..., None]
        ink = np.broadcast_to(ink, (img.shape[2],))
    v = region.astype(np.int64) * (255 - m) + ink * m + 128
    region[...] = ((v >> 8) + v) >> 8


def _blur_radius(radius: float, passes: int) -> np.float32:
    """PIL's ``_gaussian_blur_radius``: the extended box's radius for a
    Gaussian of ``radius`` (its sigma) in ``passes`` box passes."""
    f = np.float32
    sigma2 = f(radius) * f(radius) / f(passes)
    big = f(np.sqrt(12.0 * np.float64(sigma2) + 1.0))
    lo = f(np.floor((np.float64(big) - 1.0) / 2.0))
    a = (f(2) * lo + f(1)) * (lo * (lo + f(1)) - f(3) * sigma2)
    a = a / (f(6) * (sigma2 - (lo + f(1)) * (lo + f(1))))
    return lo + a


def _box_pass(img: np.ndarray, radius: np.float32) -> np.ndarray:
    """One horizontal box pass over (H, W) uint8, edges clamped."""
    r = int(radius)
    ww = np.uint32(np.float32(1 << 24) / (radius * np.float32(2) + np.float32(1)))
    fw = np.uint32((np.uint32(1 << 24) - np.uint32(2 * r + 1) * ww) // 2)
    w = img.shape[1]
    x = np.arange(w)
    acc = np.zeros(img.shape, np.uint64)
    for k in range(-r, r + 1):
        acc += img[:, np.clip(x + k, 0, w - 1)]
    far = (img[:, np.clip(x - r - 1, 0, w - 1)].astype(np.uint64)
           + img[:, np.clip(x + r + 1, 0, w - 1)])
    bulk = (acc * np.uint64(ww) + far * np.uint64(fw)) & np.uint64(0xFFFFFFFF)
    return ((bulk + np.uint64(1 << 23)) >> np.uint64(24)).astype(np.uint8)


def gaussian_blur(img: np.ndarray, radius: float, passes: int = 3) -> np.ndarray:
    """``Image.filter(ImageFilter.GaussianBlur(radius))`` of an (H, W) uint8 image."""
    r = _blur_radius(radius, passes)
    out = np.asarray(img, np.uint8)
    if r == 0:
        return out.copy()
    for _ in range(passes):
        out = _box_pass(out, r)
    out = out.T
    for _ in range(passes):
        out = _box_pass(out, r)
    return np.ascontiguousarray(out.T)
