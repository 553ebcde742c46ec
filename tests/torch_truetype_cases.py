"""Write the port's TrueType table, ``manual_yolo_tpu_torch/runtime/truetype.npz``,
from PIL's own rendering of the DejaVu fonts (a helper with no tests; needs
PIL with FreeType and raqm, and the fonts under /usr/share/fonts).

    python tests/torch_truetype_cases.py [OUT.npz]

It also writes ``tests/torch_truetype_expect.json``: for a few strings of
every font at 14, 21 and 29 px, PIL's bounding box, length and the SHA-256
of its text mask and of a blurred render, which the card's host (no PIL)
holds the port to (``tests/test_torch_gpu.py``).

For each font of ``FONTS``, each size 14..29 and each character of the
CRNN charset, the table holds what ``ImageFont.truetype(path, size)`` lays
out and renders:

  * ``adv``: the character's advance in 1/64 px, ``font.getlength(c) * 64``
    (raqm's unhinted advance);
  * ``kern``: for every ordered pair, ``getlength(a + b) * 64`` less the two
    advances (the font's pair kerning as raqm applies it);
  * ``box``: the glyph's bitmap placement, (left, top, width, rows), and
    ``pixels`` from ``offset``: its coverage, as FreeType renders it for
    PIL (read through the FreeType library PIL itself loads);
  * ``asc``: the ascender in px, where PIL's default anchor "la" puts y 0;
  * ``ligatures``: per font, the GSUB ligature lookups of the features raqm
    applies by default, in lookup order, each an ordered list of
    (characters, ligature); the ligatures' glyphs (U+FB00..U+FB04) follow
    the charset in ``chars``, with their advances, kerning and bitmaps.

Rerun this script, and say why in CHANGES.md, if PIL, its FreeType or
HarfBuzz, or the fonts change; ``tests/test_torch_truetype.py`` compares
the committed table with a fresh one.
"""

from __future__ import annotations

import ctypes
import glob
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "manual_yolo_tpu_torch", "runtime", "truetype.npz")
EXPECT = os.path.join(REPO, "tests", "torch_truetype_expect.json")
EXPECT_TEXTS = ("Game ID : 232025507", "$1,250,000", "fiddle_ffl.", "Pot: 3.5K", "Wj(q)/#")
EXPECT_BLUR = 0.7
FONT_DIR = "/usr/share/fonts/truetype/dejavu"
FONTS = ("DejaVuSans.ttf", "DejaVuSans-Bold.ttf", "DejaVuSansMono.ttf",
         "DejaVuSansMono-Bold.ttf", "DejaVuSerif.ttf", "DejaVuSerif-Bold.ttf")
SIZES = tuple(range(14, 30))
# ligature lookups of the features HarfBuzz applies by default
DEFAULT_FEATURES = ("ccmp", "locl", "rlig", "liga", "clig", "calt")

# FT_FaceRec and FT_GlyphSlotRec field offsets on a 64-bit host (FreeType 2)
_FACE_GLYPH = 152
_SLOT_BITMAP = 152  # rows, width (uint), pitch (int), buffer at +16
_SLOT_BITMAP_LEFT = 192
_SLOT_OUTLINE = 200
FT_LOAD_RENDER = 4


class _BBox(ctypes.Structure):
    _fields_ = [(n, ctypes.c_long) for n in ("xMin", "yMin", "xMax", "yMax")]


def _charset() -> str:
    from manual_yolo_tpu_torch.models.crnn import CHARSET

    return CHARSET


def _ligatures(path: str, chars: str):
    """[[(characters, ligature character), ...] per lookup, in lookup order],
    for ligatures of ``chars`` whose glyph the cmap reaches."""
    from fontTools.ttLib import TTFont

    font = TTFont(path)
    glyph_char = {}
    for code, glyph in sorted(font.getBestCmap().items()):
        glyph_char.setdefault(glyph, chr(code))
    gsub = font["GSUB"].table
    lookups = sorted({i for rec in gsub.FeatureList.FeatureRecord
                      if rec.FeatureTag in DEFAULT_FEATURES for i in rec.Feature.LookupListIndex})
    out = []
    for li in lookups:
        lookup = gsub.LookupList.Lookup[li]
        rules = []
        for sub in lookup.SubTable:
            if lookup.LookupType == 7:
                sub = sub.ExtSubTable
            if sub.LookupType != 4:
                continue
            for first, ligs in sub.ligatures.items():
                for lig in ligs:
                    seq = "".join(glyph_char.get(g, "\0") for g in [first, *lig.Component])
                    if all(c in chars for c in seq):
                        rules.append((seq, glyph_char[lig.LigGlyph]))
        if rules:
            out.append(rules)
    return out


def _freetype():
    import PIL

    libs = glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs",
                                  "libfreetype-*.so*"))
    lib = ctypes.CDLL(libs[0])
    handle = ctypes.c_void_p()
    assert lib.FT_Init_FreeType(ctypes.byref(handle)) == 0
    return lib, handle


def _glyphs(lib, handle, path: str, size: int, chars: str):
    """Per character: (left, top, width, rows) and the (rows, width) coverage."""
    face = ctypes.c_void_p()
    assert lib.FT_New_Face(handle, path.encode(), 0, ctypes.byref(face)) == 0
    assert lib.FT_Set_Pixel_Sizes(face, 0, size) == 0
    slot = ctypes.c_void_p.from_address(face.value + _FACE_GLYPH).value
    at = lambda off, t: t.from_address(slot + off).value  # noqa: E731
    out = []
    for c in chars:
        assert lib.FT_Load_Char(face, ord(c), 0) == 0
        cb = _BBox()
        lib.FT_Outline_Get_CBox(ctypes.c_void_p(slot + _SLOT_OUTLINE), ctypes.byref(cb))
        assert lib.FT_Load_Char(face, ord(c), FT_LOAD_RENDER) == 0
        rows, width = at(_SLOT_BITMAP, ctypes.c_uint), at(_SLOT_BITMAP + 4, ctypes.c_uint)
        pitch = at(_SLOT_BITMAP + 8, ctypes.c_int)
        left, top = at(_SLOT_BITMAP_LEFT, ctypes.c_int), at(_SLOT_BITMAP_LEFT + 4, ctypes.c_int)
        cover = np.zeros((rows, width), np.uint8)
        if rows and width:
            buf = at(_SLOT_BITMAP + 16, ctypes.c_void_p)
            raw = bytes((ctypes.c_ubyte * (pitch * rows)).from_address(buf))
            cover = np.frombuffer(raw, np.uint8).reshape(rows, pitch)[:, :width].copy()
        # the bitmap spans the outline's grid-fitted control box, which PIL's
        # bounding box reads too
        if rows and width:
            assert (left, top - rows, left + width, top) == (
                cb.xMin >> 6, cb.yMin >> 6, -(-cb.xMax >> 6), -(-cb.yMax >> 6)), c
        out.append(((left, top, width, rows), cover))
    lib.FT_Done_Face(face)
    return out


def table(sizes=SIZES) -> dict:
    from PIL import ImageFont, features

    assert features.check("raqm"), "PIL lays text out with raqm here; this table assumes it"
    from manual_yolo_tpu_torch.runtime.truetype import substitute

    charset = _charset()
    ligatures = [_ligatures(os.path.join(FONT_DIR, name), charset) for name in FONTS]
    chars = charset + "".join(sorted({lig for font in ligatures for rules in font
                                      for _, lig in rules}))
    lib, handle = _freetype()
    n_f, n_s, n_c = len(FONTS), len(sizes), len(chars)
    adv = np.zeros((n_f, n_s, n_c), np.int32)
    kern = np.zeros((n_f, n_s, n_c, n_c), np.int16)
    box = np.zeros((n_f, n_s, n_c, 4), np.int16)
    asc = np.zeros((n_f, n_s), np.int16)
    offset = np.zeros((n_f, n_s, n_c), np.int64)
    pixels = []
    at = 0
    for fi, name in enumerate(FONTS):
        path = os.path.join(FONT_DIR, name)
        for si, size in enumerate(sizes):
            font = ImageFont.truetype(path, size)
            for ci, c in enumerate(chars):
                adv[fi, si, ci] = round(font.getlength(c) * 64)
            for ai, a in enumerate(chars):
                for bi, b in enumerate(chars):
                    if len(substitute(a + b, ligatures[fi])) == 2:  # else they ligate
                        kern[fi, si, ai, bi] = (round(font.getlength(a + b) * 64)
                                                - adv[fi, si, ai] - adv[fi, si, bi])
            for ci, ((left, top, width, rows), cover) in enumerate(
                    _glyphs(lib, handle, path, size, chars)):
                box[fi, si, ci] = (left, top, width, rows)
                offset[fi, si, ci] = at
                pixels.append(cover.reshape(-1))
                at += cover.size
            # PIL's bbox top for "A" is the ascender less the glyph's top
            ia = chars.index("A")
            asc[fi, si] = font.getbbox("A")[1] + max(0, int(box[fi, si, ia, 1]))
    return {"fonts": np.array(FONTS), "sizes": np.array(sizes, np.int16),
            "chars": np.array(chars), "adv": adv, "kern": kern, "box": box,
            "asc": asc, "offset": offset, "pixels": np.concatenate(pixels),
            "ligatures": np.array(json.dumps(ligatures))}


def expectations() -> list:
    """PIL's results for EXPECT_TEXTS in every font at 14, 21 and 29 px: the
    bounding box, the length, the mask's shape, offset and SHA-256, and the
    SHA-256 of the text drawn in 40 on an L canvas of 230 blurred at
    EXPECT_BLUR."""
    import hashlib

    from PIL import Image, ImageDraw, ImageFilter, ImageFont

    out = []
    for name in FONTS:
        for size in (14, 21, 29):
            font = ImageFont.truetype(os.path.join(FONT_DIR, name), size)
            for text in EXPECT_TEXTS:
                mask, off = font.getmask2(text, "L")
                arr = np.array(mask, np.uint8).reshape(mask.size[1], mask.size[0])
                x0, y0, x1, y1 = font.getbbox(text)
                img = Image.new("L", (x1 - x0 + 8, y1 - y0 + 8), 230)
                ImageDraw.Draw(img).text((4 - x0, 4 - y0), text, fill=40, font=font)
                blur = np.asarray(img.filter(ImageFilter.GaussianBlur(EXPECT_BLUR)))
                out.append({"font": name, "size": size, "text": text,
                            "bbox": list(font.getbbox(text)), "length": font.getlength(text),
                            "mask_shape": list(arr.shape), "mask_offset": list(off),
                            "mask_sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
                            "blur_sha256": hashlib.sha256(blur.tobytes()).hexdigest()})
    return out


def port_expectations() -> list:
    """``expectations()`` computed by the port (runtime/truetype.py), no PIL."""
    import hashlib

    from manual_yolo_tpu_torch.runtime import truetype

    out = []
    for name in FONTS:
        for size in (14, 21, 29):
            font = truetype.truetype(os.path.join(FONT_DIR, name), size)
            for text in EXPECT_TEXTS:
                arr, off = font.getmask(text)
                x0, y0, x1, y1 = font.getbbox(text)
                img = np.full((y1 - y0 + 8, x1 - x0 + 8), 230, np.uint8)
                truetype.draw_text(img, (4 - x0, 4 - y0), text, font, 40)
                blur = truetype.gaussian_blur(img, EXPECT_BLUR)
                out.append({"font": name, "size": size, "text": text,
                            "bbox": list(font.getbbox(text)), "length": font.getlength(text),
                            "mask_shape": list(arr.shape), "mask_offset": list(off),
                            "mask_sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
                            "blur_sha256": hashlib.sha256(blur.tobytes()).hexdigest()})
    return out


if __name__ == "__main__":
    np.savez_compressed(sys.argv[1] if len(sys.argv) > 1 else OUT, **table())
    with open(EXPECT, "w") as f:
        json.dump(expectations(), f, indent=1)
        f.write("\n")
