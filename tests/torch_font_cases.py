"""Write the port's label font, ``manual_yolo_tpu_torch/runtime/glyphs.py``,
from OpenCV's own rendering (a helper with no tests; needs cv2).

    python tests/torch_font_cases.py

For each printable ASCII character and each scale the port draws at (0.4
and 0.5, thickness 1), cv2 renders the character alone in white on black
with ``cv2.putText(..., FONT_HERSHEY_SIMPLEX, ...)``: its coverage is the
pixel value, cropped to the ink, with the crop's offset from the text
origin. ``cv2.getTextSize`` gives the character's width and baseline, the
line height, and its advance (the width of ``c + "x"`` less that of
``"x"``). OpenCV 5 draws this font at whole-pixel advances without kerning,
so a string is its characters' glyphs at those advances, blended one after
another (``runtime/draw.py``). Rerun this script, and say why in CHANGES.md,
if the installed OpenCV changes its font.
"""

from __future__ import annotations

import base64
import os
import sys

import numpy as np

SCALES = (0.4, 0.5)
CHARS = "".join(chr(i) for i in range(32, 127))
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "manual_yolo_tpu_torch", "runtime", "glyphs.py")
ORIGIN = (40, 60)  # x, y of the baseline's left end on the render canvas


def font(scale: float) -> dict:
    """{"height": h, "chars": {c: (advance, width, baseline, dx, dy, w, h, base64)}}."""
    import cv2

    face = cv2.FONT_HERSHEY_SIMPLEX
    x_width = cv2.getTextSize("x", face, scale, 1)[0][0]
    heights, chars = set(), {}
    for c in CHARS:
        (width, height), baseline = cv2.getTextSize(c, face, scale, 1)
        heights.add(height)
        advance = cv2.getTextSize(c + "x", face, scale, 1)[0][0] - x_width
        canvas = np.zeros((120, 160, 3), np.uint8)
        cv2.putText(canvas, c, ORIGIN, face, scale, (255, 255, 255), 1)
        cover = canvas[..., 0]
        assert (canvas == cover[..., None]).all()
        ys, xs = np.nonzero(cover)
        if xs.size == 0:
            chars[c] = (advance, width, baseline, 0, 0, 0, 0, "")
            continue
        crop = np.ascontiguousarray(cover[ys.min():ys.max() + 1, xs.min():xs.max() + 1])
        chars[c] = (advance, width, baseline, int(xs.min()) - ORIGIN[0], int(ys.min()) - ORIGIN[1],
                    crop.shape[1], crop.shape[0], base64.b64encode(crop.tobytes()).decode())
    assert len(heights) == 1, heights
    return {"height": heights.pop(), "chars": chars}


def source() -> str:
    import cv2

    lines = [
        '"""The label font of ``runtime/draw.py``: coverage bitmaps of',
        "OpenCV's FONT_HERSHEY_SIMPLEX at thickness 1, as cv2 "
        f"{cv2.__version__} draws it.",
        "",
        "Written by ``tests/torch_font_cases.py`` (do not edit). ``FONT[scale]``:",
        '``"height"``, the line height of ``cv2.getTextSize``, and ``"chars"``:',
        "for each printable ASCII character, (advance, width, baseline, dx, dy,",
        "w, h, coverage): the pen advance, the character's own getTextSize width",
        "and baseline, and its ink, an (h, w) uint8 coverage array in base64",
        "whose top-left pixel lies at (dx, dy) from the text origin.",
        '"""',
        "",
        "FONT = {",
    ]
    for scale in SCALES:
        f = font(scale)
        lines.append(f"    {scale}: {{")
        lines.append(f'        "height": {f["height"]},')
        lines.append('        "chars": {')
        for c, entry in f["chars"].items():
            lines.append(f"            {c!r}: {entry!r},")
        lines.append("        },")
        lines.append("    },")
    lines.append("}")
    return "\n".join(lines) + "\n"


if __name__ == "__main__":
    text = source()
    with open(sys.argv[1] if len(sys.argv) > 1 else OUT, "w") as f:
        f.write(text)
