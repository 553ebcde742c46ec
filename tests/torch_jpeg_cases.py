"""JPEG fixtures: the committed example as JPEG files, and what cv2 reads.

A helper with no tests. ``python tests/torch_jpeg_cases.py`` (needs cv2)
writes ``tests/torch_jpeg/``: ``docs/examples/poker_labeled.png`` encoded by
``cv2.imencode`` at each chroma sampling (4:4:4, 4:2:2, 4:2:0, 4:4:0,
4:1:1), progressive and with restart markers, and the example resized to a
1200x1920 frame, and ``cv2_decode.json``, the SHA-256 of the BGR bytes that
``cv2.imread`` gives for each file, with its shape and encode parameters.
``chip_smoke.py`` holds the port's decoder to those hashes on a host without
cv2; ``tests/test_torch_jpeg.py`` checks the hashes against cv2 here.
"""

from __future__ import annotations

import hashlib
import json
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "torch_jpeg")
HASHES = os.path.join(FIXTURES, "cv2_decode.json")
EXAMPLE = os.path.join(REPO, "docs", "examples", "poker_labeled.png")
QUALITY = 90
FRAME_HW = (1200, 1920)

# name -> (sampling, progressive, restart interval in MCUs, source)
FIXTURE_SPECS = {
    "poker_labeled_444.jpg": ("444", False, 0, "example"),
    "poker_labeled_422.jpg": ("422", False, 0, "example"),
    "poker_labeled_420.jpg": ("420", False, 0, "example"),
    "poker_labeled_440.jpg": ("440", False, 0, "example"),
    "poker_labeled_411.jpg": ("411", False, 0, "example"),
    "poker_labeled_progressive.jpg": ("420", True, 0, "example"),
    "poker_labeled_restart.jpg": ("420", False, 7, "example"),
    "frame_1200x1920.jpg": ("420", False, 0, "frame"),
}


def sha256_of(img) -> str:
    return hashlib.sha256(img.tobytes()).hexdigest()


def load_hashes() -> dict:
    with open(HASHES) as f:
        return json.load(f)


def encode_params(cv2, quality: int, sampling: str, progressive: bool, restart: int) -> list:
    flags = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
             "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flags[sampling]]
    if progressive:
        params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    return params


def main() -> None:
    import cv2

    example = cv2.imread(EXAMPLE)
    sources = {"example": example,
               "frame": cv2.resize(example, FRAME_HW[::-1], interpolation=cv2.INTER_LINEAR)}
    os.makedirs(FIXTURES, exist_ok=True)
    out = {"cv2": cv2.__version__, "quality": QUALITY, "files": {}}
    for name, (sampling, progressive, restart, source) in FIXTURE_SPECS.items():
        ok, buf = cv2.imencode(".jpg", sources[source],
                               encode_params(cv2, QUALITY, sampling, progressive, restart))
        assert ok
        path = os.path.join(FIXTURES, name)
        with open(path, "wb") as f:
            f.write(buf.tobytes())
        img = cv2.imread(path)
        out["files"][name] = {"sha256": sha256_of(img), "shape": list(img.shape),
                              "sampling": sampling, "progressive": progressive,
                              "restart_interval": restart, "source": source}
    with open(HASHES, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"wrote {len(FIXTURE_SPECS)} files and {HASHES}")


if __name__ == "__main__":
    main()
