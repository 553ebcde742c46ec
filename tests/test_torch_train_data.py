"""PyTorch port vs the JAX package: the trainers' host data path, with no
cv2 or yaml in the port.

The same seed on both sides gives the same crops, boxes, masks and
generator state; pixels are byte-exact where cv2's arithmetic is copied
(the uint8 linear and area resizes, BGR->HSV) and within stated tolerances
where it is cv2's vectorised float path (HSV->BGR, warpAffine)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")
yaml = pytest.importorskip("yaml")

from manual_yolo_tpu.train import data as jdata  # noqa: E402
from manual_yolo_tpu.train.metrics import mean_average_precision as jax_map  # noqa: E402
from manual_yolo_tpu_torch.runtime.png import read_png, write_png  # noqa: E402
from manual_yolo_tpu_torch.train import data as pdata  # noqa: E402
from manual_yolo_tpu_torch.train.metrics import mean_average_precision  # noqa: E402
from torch_train_cases import yolo_dataset  # noqa: E402

# cv2's warpAffine float path rounds differently from the f32 arithmetic
# copied here on a few values per million: one level, on at most this share
# of values
PIXEL_SHARE = 1e-4


def _close_u8(got, ref, max_level=1, share=PIXEL_SHARE):
    d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    assert got.shape == ref.shape
    assert d.max() <= max_level and (d > 0).mean() <= share, (d.max(), (d > 0).mean())


YAMLS = {
    "flow": "train: ../train/images\nnames: ['ace', \"two's\", 'x y', king]  # flow\nnc: 4\n",
    "block": "nc: 3\nnames:\n  - ace\n  - 'two: 2'\n  - \"k#\"  # comment\nroboflow:\n  workspace: w\n",
    "mapping": "path: .\nnames:\n  0: ace\n  1: two\n  10: 'ten'\n",
}


@pytest.mark.parametrize("form", sorted(YAMLS))
def test_load_yolo_names_matches_yaml(tmp_path, form):
    (tmp_path / "data.yaml").write_text(YAMLS[form])
    names = yaml.safe_load(YAMLS[form])["names"]
    ref = {int(k): v for k, v in names.items()} if isinstance(names, dict) else dict(enumerate(names))
    assert pdata.load_yolo_names(str(tmp_path)) == ref == jdata.load_yolo_names(str(tmp_path))


def test_load_classify_folder_matches_jax(tmp_path):
    """Crops of several sizes and aspect ratios (resized by cv2's uint8
    INTER_LINEAR and centre-cropped): equal to JAX's, bit for bit."""
    rng = np.random.default_rng(0)
    for c, sizes in (("a", [(64, 64), (80, 50)]), ("b", [(33, 97), (120, 64)])):
        os.makedirs(tmp_path / c)
        for i, (h, w) in enumerate(sizes):
            write_png(str(tmp_path / c / f"{i}.png"), rng.integers(0, 256, (h, w, 3), np.uint8))
    got = pdata.load_classify_folder(str(tmp_path), 64)
    ref = jdata.load_classify_folder(str(tmp_path), 64)
    assert got[2] == ref[2] == ["a", "b"]
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[0], ref[0])


def test_jpeg_raises_naming_the_file(tmp_path):
    """A JPEG folder reads as the JAX package's cv2 reads it; a JPEG that
    is cut short raises naming the file (cv2 would return a partial image)."""
    os.makedirs(tmp_path / "a")
    img = np.random.default_rng(2).integers(0, 256, (40, 56, 3), np.uint8)
    cv2.imwrite(str(tmp_path / "a" / "x.jpg"), img)
    got = pdata.load_classify_folder(str(tmp_path))
    ref = jdata.load_classify_folder(str(tmp_path))
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[2] == ref[2] == ["a"]
    data = (tmp_path / "a" / "x.jpg").read_bytes()
    (tmp_path / "a" / "x.jpg").write_bytes(data[:len(data) // 2])
    with pytest.raises(ValueError, match="x.jpg.*ends early"):
        pdata.load_classify_folder(str(tmp_path))


def _yolo_root(tmp_path):
    return yolo_dataset(str(tmp_path / "ds"), n_train=5, n_valid=3, hw=(150, 230), names=("a", "b"))


def test_load_yolo_split_and_eval_batch_match_jax(tmp_path):
    """``load_yolo_split`` with and without ``max_side`` (cv2's INTER_AREA
    downscale) and ``make_eval_batch``: images, boxes and classes equal."""
    root = _yolo_root(tmp_path)
    for max_side in (None, 96, 115):
        got = pdata.load_yolo_split(root, "train", max_side)
        ref = jdata.load_yolo_split(root, "train", max_side)
        assert len(got) == len(ref) == 5
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.image, r.image)
            np.testing.assert_array_equal(g.boxes, r.boxes)
            np.testing.assert_array_equal(g.classes, r.classes)
    got = pdata.make_eval_batch(pdata.load_yolo_split(root, "valid"), 96)
    ref = jdata.make_eval_batch(jdata.load_yolo_split(root, "valid"), 96)
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("mosaic", [True, False])
def test_make_detect_batch_matches_jax(tmp_path, mosaic):
    """Same seed: targets and masks equal, the generator in the same state
    afterwards, images within tolerance: a warped pixel one level off (see
    PIXEL_SHARE) can move its hue by a step, and so a channel by a few levels
    after the HSV jitter, so at most 0.1% of the values may differ."""
    root = _yolo_root(tmp_path)
    got_s = pdata.load_yolo_split(root, "train", 144)
    ref_s = jdata.load_yolo_split(root, "train", 144)
    g_rng, r_rng = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(2):
        got = pdata.make_detect_batch(g_rng, got_s, 4, 96, 8, mosaic=mosaic)
        ref = jdata.make_detect_batch(r_rng, ref_s, 4, 96, 8, mosaic=mosaic)
        np.testing.assert_array_equal(got[1], ref[1])
        np.testing.assert_array_equal(got[2], ref[2])
        assert got[2].any()
        d = np.abs(got[0].astype(np.int64) - ref[0])
        assert (d > 0).mean() <= 1e-3, (d > 0).mean()
    assert g_rng.bit_generator.state == r_rng.bit_generator.state


def test_augment_classify_batch_matches_jax():
    """Same seed: the same crops, flips and erasing (generator state equal
    after), pixels equal (``cv_resize`` is cv2's f32 linear resize bit for
    bit)."""
    x = np.random.default_rng(0).uniform(0, 1, (12, 64, 64, 3)).astype(np.float32)
    g_rng, r_rng = np.random.default_rng(3), np.random.default_rng(3)
    got = pdata.augment_classify_batch(g_rng, x)
    ref = jdata.augment_classify_batch(r_rng, x)
    np.testing.assert_array_equal(got, ref)
    assert g_rng.bit_generator.state == r_rng.bit_generator.state


def test_hsv_and_warp_helpers_against_cv2():
    """HSV: BGR->HSV over every colour and HSV->BGR over every HSV triple
    byte-exact, so the jitter round trip is too; the warp within one level on
    at most PIXEL_SHARE of values; the host library's loops equal their numpy twins
    byte for byte."""
    rng = np.random.default_rng(1)
    every = np.stack(np.meshgrid(*[np.arange(256)] * 3, indexing="ij"), -1).reshape(-1, 256, 3)
    every = every.astype(np.uint8)
    np.testing.assert_array_equal(pdata.bgr_to_hsv_u8(every), cv2.cvtColor(every, cv2.COLOR_BGR2HSV))
    every_hsv = every[:180]
    np.testing.assert_array_equal(pdata.hsv_to_bgr_u8(every_hsv),
                                  cv2.cvtColor(every_hsv, cv2.COLOR_HSV2BGR))
    img = rng.integers(0, 256, (192, 256, 3), np.uint8)
    for r in (np.array([1.01, 0.5, 1.3]), np.array([0.99, 1.6, 0.7])):
        luts = pdata.hsv_luts(r)
        h, s, v = cv2.split(cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
        ref = cv2.cvtColor(cv2.merge((cv2.LUT(h, luts[0]), cv2.LUT(s, luts[1]), cv2.LUT(v, luts[2]))),
                           cv2.COLOR_HSV2BGR)
        plain = pdata.hsv_jitter_u8_plain(img, luts)
        np.testing.assert_array_equal(plain, ref)
        np.testing.assert_array_equal(pdata.hsv_jitter_u8(img, luts), plain)
    for s, t in ((0.6, (10.3, -7.9)), (1.37, (-40.2, 3.1)), (1.0, (0.0, 0.0))):
        m = np.array([[s, 0, t[0]], [0, s, t[1]]], np.float32)
        ref = cv2.warpAffine(img, m, (160, 160), borderValue=(114, 114, 114))
        plain = pdata.warp_affine_u8_plain(img, m, 160)
        _close_u8(plain, ref)
        np.testing.assert_array_equal(pdata.warp_affine_u8(img, m, 160), plain)


@pytest.mark.parametrize("out", [(120, 80), (97, 61), (160, 96), (77, 33)])
def test_resize_area_matches_cv2(out):
    img = np.random.default_rng(2).integers(0, 256, (192, 240, 3), np.uint8)
    np.testing.assert_array_equal(pdata.resize_area_u8(img, *out),
                                  cv2.resize(img, out, interpolation=cv2.INTER_AREA))


def test_write_png_reads_back(tmp_path):
    """``write_png`` of BGR and gray images: ``cv2.imread`` and ``read_png``
    give the pixels back."""
    rng = np.random.default_rng(4)
    for name, img in (("c.png", rng.integers(0, 256, (37, 53, 3), np.uint8)),
                      ("g.png", rng.integers(0, 256, (9, 70), np.uint8))):
        path = str(tmp_path / name)
        write_png(path, img)
        np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
        rgb = read_png(path)
        np.testing.assert_array_equal(rgb, img[..., ::-1] if img.ndim == 3 else np.stack([img] * 3, -1))
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "bad.png"), np.zeros((4, 4, 2), np.uint8))


def test_mean_average_precision_matches_jax():
    rng = np.random.default_rng(6)
    preds, gts = [], []
    for _ in range(5):
        g = rng.uniform(0, 80, (6, 2))
        gb = np.concatenate([g, g + rng.uniform(5, 30, (6, 2))], -1)
        gts.append({"boxes": gb, "classes": rng.integers(0, 3, 6)})
        pb = np.concatenate([gb, gb[:3] + rng.normal(0, 3, (3, 4))])
        preds.append({"boxes": pb, "classes": np.concatenate([gts[-1]["classes"], rng.integers(0, 3, 3)]),
                      "scores": rng.uniform(0, 1, 9)})
    got = mean_average_precision(preds, gts)
    assert got == jax_map(preds, gts) and 0 < got["map50_95"] < got["map50"] <= 1
    assert mean_average_precision([], []) == jax_map([], []) == {"map50": 0.0, "map50_95": 0.0}
