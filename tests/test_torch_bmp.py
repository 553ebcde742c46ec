"""The port's BMP writer and reader against cv2, and ``imwrite``.

``runtime/bmp.py::encode_bmp`` gives the bytes of ``cv2.imencode(".bmp")``
(24-bit BGR, 8-bit gray with a gray palette, rows padded to 4 bytes);
``read_bmp`` through ``runtime/png.py::imread_bgr`` gives ``cv2.imread``'s
pixels on those files and on 1-, 4- and 8-bit palette, 24- and 32-bit files
that PIL and cv2 write, bottom-up and top-down; what it refuses; frame
sources over BMP files against the JAX package's; and ``imwrite``'s choice
of writer by extension against ``cv2.imwrite``."""

import io
import os
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")

from manual_yolo_tpu.runtime import capture as jax_capture  # noqa: E402
from manual_yolo_tpu_torch.runtime import bmp as pt_bmp  # noqa: E402
from manual_yolo_tpu_torch.runtime import capture as pt_capture  # noqa: E402
from manual_yolo_tpu_torch.runtime.png import imread_bgr, imwrite  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "docs", "examples", "poker_labeled.png")
WIDTHS = [1, 2, 3, 4, 5, 7, 13, 64]


def _seeded(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _pil_bmp(img, mode) -> bytes:
    from PIL import Image

    im = Image.fromarray(np.ascontiguousarray(img[..., ::-1]))
    if mode == "P8":
        im = im.convert("P", palette=Image.ADAPTIVE, colors=200)
    elif mode == "P4":
        im = im.convert("P", palette=Image.ADAPTIVE, colors=16)
    elif mode != "RGB":
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, "BMP")
    return buf.getvalue()


@pytest.mark.parametrize("w", WIDTHS)
def test_encode_bmp_matches_cv2_bytes(w):
    for h in (1, 2, 9):
        img = _seeded(h, w, seed=w * 10 + h)
        assert pt_bmp.encode_bmp(img) == cv2.imencode(".bmp", img)[1].tobytes()
        gray = np.ascontiguousarray(img[..., 1])
        assert pt_bmp.encode_bmp(gray) == cv2.imencode(".bmp", gray)[1].tobytes()


def test_encode_bmp_example_and_write(tmp_path):
    img = imread_bgr(EXAMPLE)[::3, ::3]  # a strided view, 534 wide (padded rows)
    pt_bmp.write_bmp(str(tmp_path / "port.bmp"), img)
    cv2.imwrite(str(tmp_path / "cv2.bmp"), img)
    assert (tmp_path / "port.bmp").read_bytes() == (tmp_path / "cv2.bmp").read_bytes()


@pytest.mark.parametrize("mode", ["cv2_bgr", "cv2_gray", "cv2_bgra", "RGB", "RGBA", "L",
                                  "P8", "P4", "1"])
def test_read_bmp_matches_cv2(tmp_path, mode):
    """Files of each layout, at widths whose rows need padding."""
    for h, w in ((1, 1), (5, 7), (6, 13), (33, 20)):
        img = _seeded(h, w, seed=h * w)
        if mode == "cv2_bgr":
            data = cv2.imencode(".bmp", img)[1].tobytes()
        elif mode == "cv2_gray":
            data = cv2.imencode(".bmp", img[..., 0])[1].tobytes()
        elif mode == "cv2_bgra":  # 32-bit, V5 header, BI_BITFIELDS
            data = cv2.imencode(".bmp", np.dstack([img, img[..., :1]]))[1].tobytes()
        else:
            data = _pil_bmp(img, mode)
        path = tmp_path / f"{mode}_{h}x{w}.bmp"
        path.write_bytes(data)
        np.testing.assert_array_equal(imread_bgr(str(path)), cv2.imread(str(path)))


def test_read_bmp_top_down(tmp_path):
    """A negative height stores the rows top-down."""
    img = _seeded(6, 5, seed=3)
    data = bytearray(pt_bmp.encode_bmp(img))
    stride = 16
    rows = np.frombuffer(bytes(data[54:]), np.uint8).reshape(6, stride)[::-1]
    data[22:26] = struct.pack("<i", -6)
    data[54:] = rows.tobytes()
    path = tmp_path / "top_down.bmp"
    path.write_bytes(bytes(data))
    np.testing.assert_array_equal(imread_bgr(str(path)), cv2.imread(str(path)))
    np.testing.assert_array_equal(imread_bgr(str(path)), img)


def test_read_bmp_refuses(tmp_path):
    """RLE compression and 16-bit pixels raise, naming the file (cv2 reads
    them); so does a file cut short."""
    img = _seeded(4, 4, seed=1)
    base = bytearray(pt_bmp.encode_bmp(img[..., 0]))
    rle = bytearray(base)
    rle[30:34] = struct.pack("<I", 1)
    sixteen = bytearray(pt_bmp.encode_bmp(img))
    sixteen[28:30] = struct.pack("<H", 16)
    for name, data, match in (("rle.bmp", rle, "8-bit with compression 1"),
                              ("b16.bmp", sixteen, "16-bit"),
                              ("short.bmp", base[:-5], "too few")):
        path = tmp_path / name
        path.write_bytes(bytes(data))
        with pytest.raises(ValueError, match=f"{name}: .*{match}"):
            imread_bgr(str(path))


def test_file_source_reads_bmp_directory_like_jax(tmp_path):
    rng = np.random.default_rng(9)
    for i, hw in enumerate([(30, 41), (12, 7)]):
        cv2.imwrite(str(tmp_path / f"f{i}.bmp"), rng.integers(0, 256, hw + (3,), dtype=np.uint8))
    cv2.imwrite(str(tmp_path / "g.png"), rng.integers(0, 256, (9, 9, 3), dtype=np.uint8))
    got = list(pt_capture.file_source(str(tmp_path)))
    ref = list(jax_capture.file_source(str(tmp_path)))
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("ext", [".png", ".jpg", ".jpeg", ".JPG", ".bmp"])
def test_imwrite_picks_the_writer_by_extension(tmp_path, ext):
    """JPEG and BMP files are cv2.imwrite's bytes; a PNG (whose deflate
    stream differs) reads back to the same pixels."""
    img = imread_bgr(EXAMPLE)[100:227, 200:391]
    for arr in (img, np.ascontiguousarray(img[..., 2])):
        port, ref = tmp_path / f"port{ext}", tmp_path / f"cv2{ext}"
        imwrite(str(port), arr)
        assert cv2.imwrite(str(ref), arr)
        if ext == ".png":
            np.testing.assert_array_equal(cv2.imread(str(port), cv2.IMREAD_UNCHANGED), arr)
        else:
            assert port.read_bytes() == ref.read_bytes()


def test_imwrite_refuses_other_extensions(tmp_path):
    for name in ("x.tiff", "x.webp", "noext"):
        with pytest.raises(ValueError, match=name):
            imwrite(str(tmp_path / name), np.zeros((4, 4, 3), np.uint8))
        assert not (tmp_path / name).exists()
