"""Distribution-matched rank-classifier crops: the dataset file and names.

Counterpart of ``manual_yolo_tpu/train/matched_crops.py`` less
``build_matched_rank_dataset``, which re-crops the source screenshots of the
YOLO dataset, JPEG files the port cannot read yet (ROADMAP, Queue 1 item 7).
The dataset it built ships as ``data/rank_matched.npz``.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import numpy as np

_CROP_RE = re.compile(r"^(?P<stem>.+)_(?P<cls>[a-z0-9]+_rank)_(?P<row>\d+)$")


def parse_crop_name(fname: str) -> Optional[Tuple[str, str, int]]:
    """``<imgstem>_<class>_<labelrow>.jpg`` -> (imgstem, class_name, row)."""
    base = os.path.splitext(os.path.basename(fname))[0]
    m = _CROP_RE.match(base)
    if not m:
        return None
    return m.group("stem"), m.group("cls"), int(m.group("row"))


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
