"""The port's JPEG encoder against ``cv2.imencode``.

``csrc/host.cpp::jpeg_encode`` through ``runtime/jpeg.py::encode_jpeg`` and
``write_jpeg``: the bytes of ``cv2.imencode(".jpg", img,
[IMWRITE_JPEG_QUALITY, q])`` (libjpeg-turbo's defaults) byte for byte, on
seeded BGR and gray images from 1x1 through odd, 8- and 16-multiple sizes
to 1200x1920 at qualities 1 to 100 and on the committed example; the files
decode through the port's reader as ``cv2.imdecode`` decodes them; the
committed hashes of ``tests/torch_jpeg/cv2_encode.json`` (which
``chip_smoke.py`` holds the card's host to) are cv2's; and what the encoder
refuses."""

import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from manual_yolo_tpu_torch.runtime import jpeg as pt_jpeg  # noqa: E402
from manual_yolo_tpu_torch.runtime.png import imread_bgr  # noqa: E402

import torch_encode_cases as cases  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "docs", "examples", "poker_labeled.png")
QUALITIES = [1, 10, 35, 50, 75, 85, 90, 95, 100]
SIZES = [(1, 1), (1, 9), (9, 1), (2, 2), (5, 7), (8, 8), (8, 16), (16, 16), (16, 8),
         (17, 17), (15, 31), (24, 40), (33, 47), (64, 48), (65, 130), (100, 75)]


def _cv2(img, quality) -> bytes:
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    return buf.tobytes()


def _image(rng, h, w, gray: bool) -> np.ndarray:
    """Seeded content with smooth, flat and noisy parts, so blocks code DC
    runs, long zero runs and every AC size."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = (yy * 255 // max(h - 1, 1) + xx * 3) % 256
    chans = 1 if gray else 3
    img = np.stack([(base + 40 * c) % 256 for c in range(chans)], -1).astype(np.int64)
    img += rng.integers(-30, 31, img.shape)
    img[: h // 3, : w // 2] = rng.integers(0, 256, chans)  # a flat patch
    img[h // 2:, w // 2:] = rng.integers(0, 256, img[h // 2:, w // 2:].shape)  # noise
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if gray else img


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("kind", ["bgr", "gray"])
def test_encode_matches_cv2_bytes(kind, quality):
    rng = np.random.default_rng(quality)
    for h, w in SIZES:
        img = _image(rng, h, w, kind == "gray")
        assert pt_jpeg.encode_jpeg(img, quality) == _cv2(img, quality), (h, w)


@pytest.mark.parametrize("quality", [95, 85, 35])
def test_encode_large_frame_matches_cv2(quality):
    """A seeded 1200x1920 frame (noise, the worst case for the coder) and a
    smooth one, BGR; gray at the training augmentation's low quality."""
    rng = np.random.default_rng(1200 + quality)
    noise = rng.integers(0, 256, (1200, 1920, 3), dtype=np.uint8)
    smooth = _image(rng, 1200, 1920, gray=False)
    for img in (noise, smooth, smooth[..., 1]):
        assert pt_jpeg.encode_jpeg(img, quality) == _cv2(img, quality)


@pytest.mark.parametrize("quality", [95, 85, 50])
def test_encode_example_matches_cv2(quality):
    img = imread_bgr(EXAMPLE)
    assert pt_jpeg.encode_jpeg(img, quality) == _cv2(img, quality)
    crop = img[37:300, 11:458]  # a non-contiguous view, as a crop is
    assert pt_jpeg.encode_jpeg(crop, quality) == _cv2(crop, quality)


@pytest.mark.parametrize("kind", ["bgr", "gray"])
def test_round_trip_through_port_reader_matches_cv2(tmp_path, kind):
    rng = np.random.default_rng(7)
    for (h, w), q in zip([(1, 1), (17, 23), (64, 48), (301, 457)], [95, 50, 10, 85]):
        img = _image(rng, h, w, kind == "gray")
        path = tmp_path / f"rt_{h}x{w}.jpg"
        pt_jpeg.write_jpeg(str(path), img, q)
        ref = cv2.imdecode(np.frombuffer(_cv2(img, q), np.uint8), cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(imread_bgr(str(path)), ref)


def test_write_jpeg_equals_cv2_imwrite(tmp_path):
    img = imread_bgr(EXAMPLE)[200:400, 300:700]
    cv2.imwrite(str(tmp_path / "cv2.jpg"), img)
    pt_jpeg.write_jpeg(str(tmp_path / "port.jpg"), img)
    assert (tmp_path / "port.jpg").read_bytes() == (tmp_path / "cv2.jpg").read_bytes()


def test_committed_hashes_are_cv2s():
    """tests/torch_jpeg/cv2_encode.json holds cv2's bytes for every case,
    and the port's encoder gives them."""
    committed = cases.load_hashes()["cases"]
    assert set(committed) == set(cases.CASES)
    src = cases.sources(cv2.imread)
    np.testing.assert_array_equal(cases.sources(imread_bgr)["example"], src["example"])
    for name, (source, quality) in cases.CASES.items():
        ref = _cv2(src[source], quality)
        assert committed[name]["sha256"] == cases.sha256_of(ref), name
        assert committed[name]["bytes"] == len(ref)
        assert cases.sha256_of(pt_jpeg.encode_jpeg(src[source], quality)) == cases.sha256_of(ref)


def test_encoder_runs_in_threads():
    """Four threads encode at once (the call releases the interpreter lock):
    each gets cv2's bytes."""
    rng = np.random.default_rng(3)
    imgs = [_image(rng, 300, 400, gray=i == 3) for i in range(4)]
    refs = [_cv2(img, q) for img, q in zip(imgs, (95, 85, 50, 35))]
    got = [None] * 4

    def run(i, q):
        got[i] = pt_jpeg.encode_jpeg(imgs[i], q)

    threads = [threading.Thread(target=run, args=(i, q)) for i, q in enumerate((95, 85, 50, 35))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert got == refs


@pytest.mark.parametrize("img, quality, match", [
    (np.zeros((4, 4, 4), np.uint8), 95, "takes"),
    (np.zeros((4, 4, 3), np.float32), 95, "takes"),
    (np.zeros((4, 4, 3), np.uint8), 101, "quality"),
    (np.zeros((0, 4, 3), np.uint8), 95, "1 to 65500"),
    (np.zeros((1, 65501), np.uint8), 95, "1 to 65500"),
])
def test_encoder_refuses(img, quality, match):
    with pytest.raises(ValueError, match=match):
        pt_jpeg.encode_jpeg(img, quality)
