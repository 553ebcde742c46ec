"""``cli.unlabel`` of the port against the JAX package's: on a small YOLO
split of the committed JPEG fixtures (``tests/torch_jpeg/*.jpg``) and PNGs,
labelled with the example's golden boxes (rank and other classes, a box
past the frame's edge, an empty box, a short line, a label without an
image), both write the same crop files, byte for byte, and print the same
lines."""

import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")
pytest.importorskip("yaml")  # the JAX CLI reads data.yaml with PyYAML

from manual_yolo_tpu.cli import unlabel as jax_unlabel  # noqa: E402
from manual_yolo_tpu_torch.cli import unlabel as pt_unlabel  # noqa: E402
from manual_yolo_tpu_torch.game import taxonomy  # noqa: E402
from manual_yolo_tpu_torch.runtime.jpeg import encode_jpeg  # noqa: E402
from manual_yolo_tpu_torch.runtime.png import imread_bgr  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JPEG_DIR = os.path.join(REPO, "tests", "torch_jpeg")
EXAMPLE = os.path.join(REPO, "docs", "examples", "poker_labeled.png")


def _label_rows(h: int, w: int, shift: int) -> list:
    with open(os.path.join(REPO, "tests", "golden", "test2_detections.json")) as f:
        dets = json.load(f)
    ids = {n: i for i, n in taxonomy.CLASSES.items()}
    rows = []
    for d in dets:
        x1, y1, x2, y2 = (v + shift for v in d["bbox"])
        rows.append(f"{ids[d['class_name']]} {(x1 + x2) / 2 / w:.6f} {(y1 + y2) / 2 / h:.6f} "
                    f"{(x2 - x1) / w:.6f} {(y2 - y1) / h:.6f}")
    rank = ids["card1_rank"]
    rows += [f"{rank} 0.002 0.5 0.03 0.05",  # past the left edge: clipped at 0
             f"{rank} 0.5 0.5 0.0 0.0",  # empty: skipped
             f"{rank} 0.5",  # short: skipped
             f"{ids['flop1_rank']}.0 0.9990 0.9990 0.02 0.02"]  # past the far corner
    return rows


def _rank_slices(rows: list, h: int, w: int) -> dict:
    """line index -> (class name, (y slice, x slice)) of each rank row that
    gives a non-empty crop, by the reference's arithmetic."""
    out = {}
    for idx, row in enumerate(rows):
        parts = row.split()
        if len(parts) < 5 or not taxonomy.CLASSES[int(float(parts[0]))].endswith("_rank"):
            continue
        xc, yc, bw, bh = (float(v) for v in parts[1:5])
        x1, y1 = int((xc - bw / 2) * w), int((yc - bh / 2) * h)
        x2, y2 = int((xc + bw / 2) * w), int((yc + bh / 2) * h)
        if x2 > max(0, x1) and y2 > max(0, y1):
            out[idx] = (taxonomy.CLASSES[int(float(parts[0]))],
                        (slice(max(0, y1), y2), slice(max(0, x1), x2)))
    return out


def _dataset(root: str) -> int:
    """train/images: three JPEG fixtures and the example as a PNG; labels
    for each, and one for a missing image. data.yaml: the 64 names as a
    flow list. -> the number of rank crops expected."""
    img_dir, lbl_dir = os.path.join(root, "train", "images"), os.path.join(root, "train", "labels")
    os.makedirs(img_dir)
    os.makedirs(lbl_dir)
    shots = {"a420": os.path.join(JPEG_DIR, "poker_labeled_420.jpg"),
             "b_prog": os.path.join(JPEG_DIR, "poker_labeled_progressive.jpg"),
             "c_frame": os.path.join(JPEG_DIR, "frame_1200x1920.jpg"),
             "d_png": EXAMPLE}
    expected = 0
    for i, (stem, src) in enumerate(shots.items()):
        shutil.copyfile(src, os.path.join(img_dir, stem + os.path.splitext(src)[1]))
        h, w = imread_bgr(src).shape[:2]
        rows = _label_rows(h, w, shift=3 * i)
        with open(os.path.join(lbl_dir, stem + ".txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
        expected += len(_rank_slices(rows, h, w))
    with open(os.path.join(lbl_dir, "missing.txt"), "w") as f:
        f.write("6 0.5 0.5 0.1 0.1\n")
    with open(os.path.join(root, "data.yaml"), "w") as f:
        f.write(f"nc: {len(taxonomy.CLASSES)}\n")
        f.write("names: [" + ", ".join(f"'{taxonomy.CLASSES[i]}'"
                                       for i in range(len(taxonomy.CLASSES))) + "]\n")
    return expected


def test_unlabel_matches_jax(tmp_path, capsys):
    data = str(tmp_path / "data")
    expected = _dataset(data)
    outs = {}
    for name, cli in (("pt", pt_unlabel), ("jax", jax_unlabel)):
        out = tmp_path / f"crops_{name}"
        assert cli.main(["--data", data, "--split", "train", "--out", str(out)]) == 0
        outs[name] = (out, capsys.readouterr().out.replace(str(out), "OUT"))
    (pt_out, pt_log), (jx_out, jx_log) = outs["pt"], outs["jax"]
    assert pt_log == jx_log
    names = sorted(os.listdir(pt_out))
    assert names == sorted(os.listdir(jx_out))
    assert len(names) == expected >= 4 * 6
    for n in names:
        assert (pt_out / n).read_bytes() == (jx_out / n).read_bytes(), n
    # each crop of the PNG is encode_jpeg of the frame slice its label gives
    frame = imread_bgr(EXAMPLE)
    with open(os.path.join(data, "train", "labels", "d_png.txt")) as f:
        rows = f.read().splitlines()
    slices = _rank_slices(rows, *frame.shape[:2])
    assert len(slices) >= 6
    for idx, (cls, (ys, xs)) in slices.items():
        got = (pt_out / f"d_png_{cls}_{idx}.jpg").read_bytes()
        assert got == encode_jpeg(frame[ys, xs], 95), (cls, idx)
        np.testing.assert_array_equal(imread_bgr(str(pt_out / f"d_png_{cls}_{idx}.jpg")),
                                      cv2.imread(str(jx_out / f"d_png_{cls}_{idx}.jpg")))
