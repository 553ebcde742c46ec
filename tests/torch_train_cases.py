"""Inputs shared by the training tests (tests/test_torch_train_*.py and the
card tests in tests/test_torch_gpu.py): small PNG datasets written with the
port's ``write_png`` and a seeded detection batch. No JAX here: the card's
host has none."""

import os

import numpy as np

from manual_yolo_tpu_torch.runtime.png import write_png

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
