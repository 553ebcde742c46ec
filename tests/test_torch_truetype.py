"""The port's TrueType stand-in (``runtime/truetype.py``) against PIL.

For every font of the OCR trainer at sizes 14, 21 and 29: ``getbbox``,
``getlength``, the text mask and ``draw_text`` on L and RGB canvases,
pixel for pixel against ``ImageFont.truetype`` / ``ImageDraw.text``, on
the trainers' own strings and on random strings of the whole charset;
``gaussian_blur`` against ``ImageFilter.GaussianBlur``; the committed
glyph table against one regenerated from the installed PIL and fonts.
Every comparison is exact."""

import os

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")
PIL = pytest.importorskip("PIL")
from PIL import Image, ImageDraw, ImageFilter, ImageFont, features  # noqa: E402

from manual_yolo_tpu_torch.models.crnn import CHARSET  # noqa: E402
from manual_yolo_tpu_torch.runtime import truetype  # noqa: E402
from manual_yolo_tpu_torch.train import ocr as pocr  # noqa: E402

HAVE_FONTS = all(os.path.exists(f) for f in pocr.FONTS) and features.check("raqm")
needs_fonts = pytest.mark.skipif(not HAVE_FONTS, reason="needs the DejaVu fonts and PIL with raqm")


def _strings(seed: int, n: int):
    """The trainers' strings (labels and suffixes), random charset strings and
    the ligature sequences."""
    rng = np.random.default_rng(seed)
    out = ["ffi", "ffl", "office flow", "fiddle", "Influx", "a", ".", "W_j,"]
    for _ in range(n):
        label, suffix = pocr.random_sample(rng)
        out += [label] + ([suffix] if suffix else [])
        k = int(rng.integers(1, 14))
        out.append("".join(CHARSET[i] for i in rng.integers(0, len(CHARSET), k)))
    return out


def _pil_mask(font, text):
    m, off = font.getmask2(text, "L")
    return np.array(m, np.uint8).reshape(m.size[1], m.size[0]), tuple(off)


@needs_fonts
@pytest.mark.parametrize("size", [14, 21, 29])
@pytest.mark.parametrize("font", pocr.FONTS, ids=os.path.basename)
def test_text_matches_pil(font, size):
    ref, got = ImageFont.truetype(font, size), truetype.truetype(font, size)
    rng = np.random.default_rng(size)
    for text in _strings(size + len(font), 30):
        assert got.getbbox(text) == ref.getbbox(text), text
        assert got.getlength(text) == ref.getlength(text), text
        mask, off = got.getmask(text)
        ref_mask, ref_off = _pil_mask(ref, text)
        assert off == ref_off, text
        np.testing.assert_array_equal(mask, ref_mask, err_msg=text)
        x0, y0, x1, y1 = ref.getbbox(text)
        h, w = y1 - y0 + 8, x1 - x0 + 10
        xy = (int(rng.integers(-4, 8)) - x0, int(rng.integers(-4, 6)) - y0)
        fill = int(rng.integers(0, 256))
        gray = rng.integers(0, 256, (h, w), dtype=np.uint8)
        pil = Image.fromarray(gray.copy())
        ImageDraw.Draw(pil).text(xy, text, fill=fill, font=ref)
        truetype.draw_text(gray, xy, text, got, fill)
        np.testing.assert_array_equal(gray, np.asarray(pil), err_msg=text)
        rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        pil = Image.fromarray(rgb.copy())
        ImageDraw.Draw(pil).text(xy, text, fill=(fill,) * 3, font=ref)
        truetype.draw_text(rgb, xy, text, got, (fill,) * 3)
        np.testing.assert_array_equal(rgb, np.asarray(pil), err_msg=text)


def test_empty_text_and_unknown_glyphs():
    font = truetype.truetype(pocr.FONTS[0], 20)
    assert font.getbbox("") == (0, 0, 0, 0) and font.getlength("") == 0.0
    with pytest.raises(ValueError, match="not in the glyph table"):
        font.getbbox("é")
    with pytest.raises(ValueError, match="no glyph table"):
        truetype.truetype(pocr.FONTS[0], 30)


@pytest.mark.parametrize("radius", [0.0, 0.05, 0.3, 0.5, 0.75, 0.9, 1.1, 1.19])
def test_gaussian_blur_matches_pil(radius):
    rng = np.random.default_rng(int(radius * 100))
    for shape in ((1, 1), (3, 40), (25, 2), (30, 180), (17, 63)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        if shape[0] > 20:
            img = np.where(img > 128, 255, 0).astype(np.uint8)  # text-like edges
        ref = np.asarray(Image.fromarray(img).filter(ImageFilter.GaussianBlur(radius)))
        np.testing.assert_array_equal(truetype.gaussian_blur(img, radius), ref)


@needs_fonts
def test_committed_table_matches_regeneration():
    """The table for sizes 14, 21 and 29, regenerated from the installed PIL,
    its FreeType and the fonts, equals the committed one's slices (a PIL or
    font change shows here; rerun tests/torch_truetype_cases.py then)."""
    import torch_truetype_cases

    fresh = torch_truetype_cases.table(sizes=(14, 21, 29))
    with np.load(truetype.TABLE) as z:
        com = {k: z[k] for k in z.files}
    for k in ("fonts", "chars", "ligatures"):
        assert str(fresh[k]) == str(com[k]), k
    idx = [list(com["sizes"]).index(s) for s in (14, 21, 29)]
    for k in ("adv", "kern", "box"):
        np.testing.assert_array_equal(fresh[k], com[k][:, idx], err_msg=k)
    np.testing.assert_array_equal(fresh["asc"], com["asc"][:, idx])
    for f in range(len(fresh["fonts"])):
        for j, i in enumerate(idx):
            for c in range(len(str(com["chars"]))):
                n = int(np.prod(com["box"][f, i, c, 2:]))
                a, b = com["offset"][f, i, c], fresh["offset"][f, j, c]
                np.testing.assert_array_equal(fresh["pixels"][b:b + n], com["pixels"][a:a + n])


@needs_fonts
def test_expectations_file_matches_pil_and_port():
    """tests/torch_truetype_expect.json (what the card's host holds the port
    to) is PIL's result now, and the port's."""
    import json

    import torch_truetype_cases

    with open(torch_truetype_cases.EXPECT) as f:
        committed = json.load(f)
    assert committed == torch_truetype_cases.expectations()
    assert committed == torch_truetype_cases.port_expectations()
