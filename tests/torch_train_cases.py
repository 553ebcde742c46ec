"""Inputs shared by the training tests (tests/test_torch_train_*.py and the
card tests in tests/test_torch_gpu.py): small PNG datasets written with the
port's ``write_png``, a seeded detection batch, and the sources of a matched
rank dataset (JPEG screenshots, labels and named rank crops). No JAX and no
cv2 here: the card's host has neither (``chip_smoke.py`` uses them too)."""

import os
import shutil

import numpy as np

from manual_yolo_tpu_torch.runtime.png import imread_bgr, write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MATCHED = os.path.join(REPO, "data", "rank_matched.npz")


def yolo_dataset(root, n_train=4, n_valid=2, hw=(64, 64), names=("a", "b"), seed=0):
    """A YOLO dataset of PNGs: random pixels, a red square labelled class
    ``i % 2`` and a second box of class 1, ``data.yaml`` as a flow list."""
    rng = np.random.default_rng(seed)
    h, w = hw
    for split, n in (("train", n_train), ("valid", n_valid)):
        os.makedirs(os.path.join(root, split, "images"), exist_ok=True)
        os.makedirs(os.path.join(root, split, "labels"), exist_ok=True)
        for i in range(n):
            img = rng.integers(0, 255, (h, w, 3), np.uint8)
            img[h // 4 : 3 * h // 4, w // 4 : 3 * w // 4] = (0, 0, 255)
            write_png(os.path.join(root, split, "images", f"i{i}.png"), img)
            with open(os.path.join(root, split, "labels", f"i{i}.txt"), "w") as f:
                f.write(f"{i % 2} 0.5 0.5 0.5 0.5\n1 0.8 0.75 0.2 0.3\n")
    with open(os.path.join(root, "data.yaml"), "w") as f:
        f.write("names: [" + ", ".join(f"'{n}'" for n in names) + f"]\nnc: {len(names)}\n")
    return root


def rank_folder_dataset(root, per_class=(3, 1)):
    """A folder dataset (``train/``, ``valid/``, 13 class folders) of PNG
    crops from ``data/rank_matched.npz``: the first ``per_class`` crops of
    each class of its train and valid splits."""
    z = np.load(MATCHED)
    names = [str(s) for s in z["names"]]
    for split, k in zip(("train", "valid"), per_class):
        x, y = z[f"{split}_x"], z[f"{split}_y"]
        for c, name in enumerate(names):
            os.makedirs(os.path.join(root, split, name), exist_ok=True)
            for j, idx in enumerate(np.flatnonzero(y == c)[:k]):
                write_png(os.path.join(root, split, name, f"{j}.png"), x[idx][..., ::-1])
    return root, names


def matched_sources(det_root, rank_root, screenshots, names=None):
    """What ``build_matched_rank_dataset`` and ``cli.train_cls
    --build-matched`` read: ``screenshots`` (JPEG files) copied into a YOLO
    train split as ``shot{i}.jpg``, each with 13 label rows (row r of class
    r, boxes on a 5x3 grid), and a rank folder dataset whose crops (PNG, cut
    at the label boxes) are named ``shot{i}_flop1_rank_{r}.png``: the first
    screenshot's in ``train/``, the others' in ``valid/``. Returns the class
    names (the matched dataset's by default)."""
    if names is None:
        names = [str(v) for v in np.load(MATCHED)["names"]]
    os.makedirs(os.path.join(det_root, "train", "images"), exist_ok=True)
    os.makedirs(os.path.join(det_root, "train", "labels"), exist_ok=True)
    for i, src in enumerate(screenshots):
        stem = f"shot{i}"
        shutil.copyfile(src, os.path.join(det_root, "train", "images", stem + ".jpg"))
        img = imread_bgr(src)
        h, w = img.shape[:2]
        rows = []
        for r in range(len(names)):
            cx, cy = (r % 5 + 0.5) * w / 5, (r // 5 + 0.5) * h / 3
            bw, bh = 26 + 3 * (r % 4), 38 + 2 * (r % 3)
            rows.append(f"{r} {cx / w:.6f} {cy / h:.6f} {bw / w:.6f} {bh / h:.6f}")
            split = "train" if i == 0 else "valid"
            d = os.path.join(rank_root, split, names[r])
            os.makedirs(d, exist_ok=True)
            crop = img[int(cy - bh / 2):int(cy + bh / 2), int(cx - bw / 2):int(cx + bw / 2)]
            write_png(os.path.join(d, f"{stem}_flop1_rank_{r}.png"), np.ascontiguousarray(crop))
        with open(os.path.join(det_root, "train", "labels", stem + ".txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
    return names


def detect_batch(b=2, imgsz=64, m=6, nc=4, seed=0):
    """A seeded uint8 batch with boxes: (images (B,S,S,3) u8, targets
    (B,M,5), mask (B,M)); the last frame has no boxes."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (b, imgsz, imgsz, 3), np.uint8)
    tgts = np.zeros((b, m, 5), np.float32)
    mask = np.zeros((b, m), bool)
    for i in range(b - 1):
        n = m - 2
        # large boxes: a random-init head predicts boxes of about 15
        # strides, and smaller gts would align with no anchor
        wh = rng.uniform(imgsz * 0.45, imgsz * 0.9, (n, 2))
        xy = rng.uniform(0, 1, (n, 2)) * (imgsz - wh)
        tgts[i, :n, 0] = rng.integers(0, nc, n)
        tgts[i, :n, 1:3] = xy
        tgts[i, :n, 3:5] = xy + wh
        mask[i, :n] = True
    return imgs, tgts, mask
