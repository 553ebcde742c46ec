"""The port's drawing (``runtime/draw.py``) against cv2: ``rectangle``
against ``cv2.rectangle`` pixel for pixel on seeded boxes at thickness 1, 2
and -1 (swapped corners, degenerate and out-of-bounds boxes included);
``text_size`` against ``cv2.getTextSize`` and ``put_text`` against
``cv2.putText`` (FONT_HERSHEY_SIMPLEX, the anti-aliased font of OpenCV 5)
on every ``class:text`` label the screenshot draws and on seeded strings,
colours and origins; the committed font table against a fresh render; and
``annotate`` against the JAX package's drawing of the same detections."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from manual_yolo_tpu_torch.game import taxonomy  # noqa: E402
from manual_yolo_tpu_torch.runtime import draw  # noqa: E402
from manual_yolo_tpu_torch.runtime.shot import annotate  # noqa: E402

import torch_font_cases  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "docs", "examples", "poker_labeled.png")
FONT = cv2.FONT_HERSHEY_SIMPLEX
PRINTABLE = [chr(i) for i in range(32, 127)]


def _example_texts() -> list:
    """The field texts of the example: its golden detections' reads and the
    values of its result JSON."""
    with open(os.path.join(REPO, "tests", "golden", "test2_detections.json")) as f:
        texts = {d["ocr_text"] for d in json.load(f)}
    with open(os.path.join(REPO, "docs", "examples", "poker_result.json")) as f:
        result = json.load(f)
    for key in ("game_id", "card1", "card2", "my_stack", "my_bet"):
        texts.add(result[key])
    for v in result["villains"]:
        texts.update(v.values())
    texts.update(result["community_cards"])
    return sorted(texts)


LABELS = [f"{name}:{text}" for name in taxonomy.CLASSES.values() for text in _example_texts()]


def _ink_box(a: np.ndarray, b: np.ndarray):
    ys, xs = np.nonzero((a != b).any(-1))
    return (xs.min(), ys.min(), xs.max() + 1, ys.max() + 1) if xs.size else None


def _iou(p, q) -> float:
    ix = max(0, min(p[2], q[2]) - max(p[0], q[0]))
    iy = max(0, min(p[3], q[3]) - max(p[1], q[1]))
    inter = ix * iy
    area = lambda r: (r[2] - r[0]) * (r[3] - r[1])  # noqa: E731
    return inter / (area(p) + area(q) - inter)


@pytest.mark.parametrize("thickness", [1, 2, -1])
def test_rectangle_matches_cv2(thickness):
    """300 seeded boxes on seeded images: corners anywhere from 15 px
    outside to 15 px past the far edge, in either order; every fifth box a
    point, every seventh a vertical line."""
    rng = np.random.default_rng(thickness + 10)
    for i in range(300):
        h, w = (int(v) for v in rng.integers(5, 60, 2))
        base = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        p1 = tuple(int(v) for v in rng.integers(-15, max(h, w) + 15, 2))
        p2 = tuple(int(v) for v in rng.integers(-15, max(h, w) + 15, 2))
        if i % 5 == 0:
            p2 = p1
        elif i % 7 == 0:
            p2 = (p1[0], p2[1])
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        ref = cv2.rectangle(base.copy(), p1, p2, color, thickness)
        got = draw.rectangle(base.copy(), p1, p2, color, thickness)
        np.testing.assert_array_equal(got, ref, err_msg=f"{(h, w)} {p1} {p2}")


def test_rectangle_thick_corners_and_gray():
    """The thickness-2 frame of the shot: each corner misses its outer
    diagonal pixel, as cv2's does; gray images take the first colour."""
    img = np.zeros((12, 14, 3), np.uint8)
    draw.rectangle(img, (9, 7), (3, 3), (255, 0, 0), 2)
    np.testing.assert_array_equal(img, cv2.rectangle(np.zeros_like(img), (3, 3), (9, 7),
                                                     (255, 0, 0), 2))
    assert img[2, 2, 0] == 0 and img[2, 3, 0] == 255 and img[3, 2, 0] == 255
    gray = np.full((20, 20), 9, np.uint8)
    np.testing.assert_array_equal(draw.rectangle(gray.copy(), (2, 3), (15, 11), (200, 0, 0), 2),
                                  cv2.rectangle(gray.copy(), (2, 3), (15, 11), (200,), 2))
    with pytest.raises(ValueError, match="thickness"):
        draw.rectangle(img, (0, 0), (3, 3), (0, 0, 0), 3)


@pytest.mark.parametrize("scale", [0.5, 0.4])
def test_text_size_matches_cv2_on_shot_labels(scale):
    """Every class:text label of the 64 classes with the example's texts:
    height and baseline equal, width equal (the contract asks within 10%)."""
    assert len(taxonomy.CLASSES) == 64 and len(LABELS) > 64 * 10
    for label in LABELS:
        (w, h), base = draw.text_size(label, scale, 1)
        (rw, rh), rbase = cv2.getTextSize(label, FONT, scale, 1)
        assert h == rh and base == rbase, label
        assert abs(w - rw) <= 0.1 * rw and w == rw, (label, w, rw)
    assert draw.text_size("", scale) == cv2.getTextSize("", FONT, scale, 1)


@pytest.mark.parametrize("scale", [0.5, 0.4])
def test_put_text_ink_matches_cv2_on_shot_labels(scale):
    """At the shot's anchor on the example: the ink box of each label meets
    cv2's at IoU >= 0.8, lies inside the box text_size gives, and the
    pixels are cv2's."""
    frame = cv2.imread(EXAMPLE)[300:360, 200:700]
    org = (7, 30)
    for label in LABELS:
        ref = cv2.putText(frame.copy(), label, org, FONT, scale, (0, 255, 0), 1)
        got = draw.put_text(frame.copy(), label, org, scale, (0, 255, 0), 1)
        box_ref, box_got = _ink_box(ref, frame), _ink_box(got, frame)
        assert _iou(box_got, box_ref) >= 0.8, label
        (w, h), base = draw.text_size(label, scale)
        assert (box_got[0] >= org[0] and box_got[2] <= org[0] + w
                and box_got[1] >= org[1] - h and box_got[3] <= org[1] + base + 1), label
        np.testing.assert_array_equal(got, ref, err_msg=label)


def test_put_text_matches_cv2_on_seeded_strings():
    """Seeded printable strings, colours, backgrounds and origins (partly
    or wholly outside the image), BGR and gray."""
    rng = np.random.default_rng(5)
    for i in range(400):
        scale = (0.4, 0.5)[i % 2]
        text = "".join(rng.choice(PRINTABLE, int(rng.integers(1, 25))))
        h, w = int(rng.integers(10, 80)), int(rng.integers(10, 300))
        shape = (h, w) if i % 4 == 3 else (h, w, 3)
        base = rng.integers(0, 256, shape, dtype=np.uint8)
        org = (int(rng.integers(-20, w)), int(rng.integers(-5, h + 10)))
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        ref = cv2.putText(base.copy(), text, org, FONT, scale, color, 1)
        got = draw.put_text(base.copy(), text, org, scale, color, 1)
        np.testing.assert_array_equal(got, ref, err_msg=repr(text))
        assert draw.text_size(text, scale) == cv2.getTextSize(text, FONT, scale, 1)


def test_font_table_is_cv2s_render():
    """runtime/glyphs.py is what tests/torch_font_cases.py writes from this
    cv2; other scales and thicknesses raise."""
    path = os.path.join(REPO, "manual_yolo_tpu_torch", "runtime", "glyphs.py")
    with open(path) as f:
        assert f.read() == torch_font_cases.source()
    img = np.zeros((20, 40, 3), np.uint8)
    with pytest.raises(ValueError, match="scales"):
        draw.put_text(img, "a", (1, 15), 0.6, (255, 255, 255))
    with pytest.raises(ValueError, match="thickness"):
        draw.text_size("a", 0.5, 2)


def test_annotate_matches_cv2_drawing():
    """The shot's annotation of canned detections (boxes at the frame's
    edges, labels above the top edge) equals the JAX package's cv2 calls."""
    frame = cv2.imread(EXAMPLE)
    dets = [{"class_name": "card1_rank", "bbox": [889, 603, 932, 640], "ocr_text": "6"},
            {"class_name": "game_id", "bbox": [850, 2, 1008, 30], "ocr_text": "232025507"},
            {"class_name": "button_fold", "bbox": [-3, 850, 40, 905], "ocr_text": None},
            {"class_name": "villian5_stack", "bbox": [1500, 10, 1620, 40], "ocr_text": "4.6K"}]
    ref = frame.copy()
    for d in dets:
        x1, y1, x2, y2 = d["bbox"]
        cv2.rectangle(ref, (x1, y1), (x2, y2), (255, 0, 0), 2)
        cv2.putText(ref, f"{d['class_name']}:{d.get('ocr_text') or ''}", (x1, max(0, y1 - 5)),
                    FONT, 0.5, (0, 255, 0), 1)
    got = annotate(frame, dets)
    np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(got, frame)
