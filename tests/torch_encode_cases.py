"""JPEG encoder cases, and the SHA-256 of what ``cv2.imencode`` writes for them.

A helper with no tests. ``python tests/torch_encode_cases.py`` (needs cv2)
writes ``tests/torch_jpeg/cv2_encode.json``: for each case, the SHA-256 and
length of ``cv2.imencode(".jpg", img, [IMWRITE_JPEG_QUALITY, q])``.
``chip_smoke.py`` holds the port's encoder to those hashes on a host without
cv2; ``tests/test_torch_jpeg_encode.py`` checks them against cv2 here. The
inputs are built without cv2 (``sources``): the committed example as the
port reads it (the pixels of ``cv2.imread``), the seeded 1200x1920 frame of
``chip_smoke.py``, and a gray crop of odd size (the example's green channel).
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HASHES = os.path.join(REPO, "tests", "torch_jpeg", "cv2_encode.json")
EXAMPLE = os.path.join(REPO, "docs", "examples", "poker_labeled.png")
# name -> (source, quality)
CASES = {
    "example_q95": ("example", 95),
    "example_q85": ("example", 85),
    "frame_1200x1920_q95": ("frame_1200x1920", 95),
    "frame_1200x1920_q85": ("frame_1200x1920", 85),
    "example_gray_crop_q50": ("example_gray_crop", 50),
}


def sources(imread) -> dict:
    """The cases' input arrays; ``imread`` reads the example (cv2.imread, or
    the port's imread_bgr, which gives the same pixels)."""
    example = imread(EXAMPLE)
    return {
        "example": example,
        "frame_1200x1920": np.random.default_rng(0).integers(0, 256, (1200, 1920, 3),
                                                            dtype=np.uint8),
        "example_gray_crop": np.ascontiguousarray(example[101:422, 203:690, 1]),
    }


def sha256_of(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def load_hashes() -> dict:
    with open(HASHES) as f:
        return json.load(f)


def main() -> None:
    import cv2

    src = sources(cv2.imread)
    out = {"cv2": cv2.__version__, "cases": {}}
    for name, (source, quality) in CASES.items():
        ok, buf = cv2.imencode(".jpg", src[source], [cv2.IMWRITE_JPEG_QUALITY, quality])
        assert ok
        out["cases"][name] = {"source": source, "quality": quality,
                              "shape": list(src[source].shape), "bytes": int(buf.size),
                              "sha256": sha256_of(buf.tobytes())}
    with open(HASHES, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
