"""Distribution-matched rank-classifier crops.

Counterpart of ``manual_yolo_tpu/train/matched_crops.py``. The fused frame
pipeline extracts rank crops on the device with
``runtime/pipeline.py::crop_resize_center`` (bilinear gather, pad=6), while
the classifier was trained on host-preprocessed folder crops (PIL short-side
resize + center crop). The two distributions differ enough to flip
borderline glyphs at inference.

``build_matched_rank_dataset`` regenerates the human-labelled
``rank_classifier`` dataset *through the pipeline's own crop function*: each
crop filename encodes its source image and label row
(``<img>_<class>_<labelrow>.jpg``, produced by the reference's
``unlabel.py:63-65``), so the original detection box is recovered and
re-cropped from the full screenshot (a JPEG of the YOLO dataset, read by
``runtime/jpeg.py``) exactly the way inference will. Train crops get small
box jitter to cover detector-vs-label box noise. The dataset it built ships
as ``data/rank_matched.npz``.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from manual_yolo_tpu_torch.core.device import resolve_device
from manual_yolo_tpu_torch.runtime.pipeline import crop_resize_center
from manual_yolo_tpu_torch.runtime.png import imread_bgr

_CROP_RE = re.compile(r"^(?P<stem>.+)_(?P<cls>[a-z0-9]+_rank)_(?P<row>\d+)$")


def parse_crop_name(fname: str) -> Optional[Tuple[str, str, int]]:
    """``<imgstem>_<class>_<labelrow>.jpg`` -> (imgstem, class_name, row)."""
    base = os.path.splitext(os.path.basename(fname))[0]
    m = _CROP_RE.match(base)
    if not m:
        return None
    return m.group("stem"), m.group("cls"), int(m.group("row"))


def _label_box(label_path: str, row: int) -> Optional[Tuple[int, np.ndarray]]:
    """Return (class_id, normalized cxcywh) for a 0-based label row."""
    try:
        with open(label_path) as f:
            lines = [l.strip() for l in f if l.strip()]
    except OSError:
        return None
    if row >= len(lines):
        return None
    parts = lines[row].split()
    return int(parts[0]), np.asarray([float(v) for v in parts[1:5]], np.float64)


def build_matched_rank_dataset(
    rank_root: str,
    det_root: str,
    split: str = "train",
    pad: float = 6.0,
    jitter: int = 0,
    jitter_frac: float = 0.08,
    seed: int = 0,
    size: int = 64,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Re-crop ``rank_root/<split>`` through the device crop function.

    Returns (crops uint8 (N,size,size,3) RGB, labels int32, class names).
    ``jitter`` > 0 adds that many jittered variants per train crop (box
    corners perturbed by up to ``jitter_frac`` of the box size), drawn from
    ``np.random.default_rng(seed)`` in the JAX package's order. One
    ``crop_resize_center`` call per source image, on ``device``. A crop name
    that does not parse, a label row that does not exist and a missing
    screenshot are skipped and counted, as in the JAX package; a screenshot
    that cannot be read raises.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    root = os.path.join(rank_root, split)
    names = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
    )
    # YOLO image/label dirs; the rank crops come from the train images
    img_dir = os.path.join(det_root, "train", "images")
    lbl_dir = os.path.join(det_root, "train", "labels")

    out_crops: List[np.ndarray] = []
    out_labels: List[int] = []
    skipped = 0
    # group work per source image: ONE device call per image
    per_image: Dict[str, List[Tuple[np.ndarray, int]]] = {}
    for ci, cname in enumerate(names):
        d = os.path.join(root, cname)
        for f in sorted(os.listdir(d)):
            parsed = parse_crop_name(f)
            if parsed is None:
                skipped += 1
                continue
            stem, _cls, row = parsed
            got = _label_box(os.path.join(lbl_dir, stem + ".txt"), row)
            if got is None:
                skipped += 1
                continue
            per_image.setdefault(stem, []).append((got[1], ci))

    for stem, items in sorted(per_image.items()):
        path = os.path.join(img_dir, stem + ".jpg")
        if not os.path.exists(path):
            skipped += len(items)
            continue
        img = imread_bgr(path)
        h, w = img.shape[:2]
        boxes, labels = [], []
        for cxywh, ci in items:
            cx, cy, bw, bh = cxywh * np.asarray([w, h, w, h])
            base = np.asarray(
                [cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], np.float32
            )
            boxes.append(base)
            labels.append(ci)
            for _ in range(jitter):
                amp = jitter_frac * np.asarray([bw, bh, bw, bh])
                boxes.append((base + rng.uniform(-amp, amp)).astype(np.float32))
                labels.append(ci)
        rgb = torch.from_numpy(np.ascontiguousarray(img[..., ::-1])).to(dev)
        with torch.inference_mode():
            crops = crop_resize_center(rgb, torch.from_numpy(np.stack(boxes)).to(dev), size, pad)
        out_crops.append(np.clip(crops.cpu().numpy(), 0, 255).astype(np.uint8))
        out_labels.extend(labels)

    if skipped:
        print(f"matched_crops[{split}]: skipped {skipped} unmappable crops")
    x = np.concatenate(out_crops) if out_crops else np.zeros((0, size, size, 3), np.uint8)
    return x, np.asarray(out_labels, np.int32), names


def save_matched_dataset(out_path: str, **splits) -> None:
    """Save {'<split>_x': u8, '<split>_y': i32, 'names': ...} as one npz."""
    arrays = {}
    names = None
    for split, (x, y, n) in splits.items():
        arrays[f"{split}_x"] = x
        arrays[f"{split}_y"] = y
        names = n
    arrays["names"] = np.asarray(names)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez_compressed(out_path, **arrays)


def load_matched_dataset(path: str):
    """-> dict of split -> (x float32 [0,1] RGB, y int32), plus 'names'."""
    z = np.load(path, allow_pickle=False)
    names = [str(s) for s in z["names"]]
    out = {}
    for k in z.files:
        if k.endswith("_x"):
            split = k[:-2]
            out[split] = (
                z[k].astype(np.float32) / 255.0,
                z[f"{split}_y"].astype(np.int32),
            )
    return out, names
