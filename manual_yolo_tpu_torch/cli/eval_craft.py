"""CRAFT text-detector evaluation on real table pixels. Counterpart of
``manual_yolo_tpu/cli/eval_craft.py``.

The detection dataset's own single-line text fields (villianN_name /
_stack / _bet, total_pot, game_id, ...) are the ground-truth lines. For
every labelled image of the chosen splits, name-over-stack panels and
padded single fields become regions; each goes through the CRAFT pass of
``OCREngine.read_region`` (side a multiple of 32 in 64..512, the crop
resized into the canvas's corner with cv2's linear resize) and
``text_regions_from_scores``; a GT line is found when a predicted box
covers its centre with IoU >= 0.3.

    python -m manual_yolo_tpu_torch.cli.eval_craft --weights weights/craft_real.npz

Runs on the card unless ``--device cpu`` is given, in f32. ``data.yaml``'s
class names are read by ``train/data.py::load_yolo_names`` (no yaml);
images by ``runtime/png.py::imread_bgr``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

DATASET_ROOT = "roadmap1.v3i.yolov8"  # the reference dataset's directory, as cli.train_det

TEXT_SUFFIX = ("_name", "_stack", "_bet")
TEXT_NAMES = ("total_pot", "game_id", "my_stack", "my_bet", "iinput_field")


def _is_text(name: str) -> bool:
    return name.endswith(TEXT_SUFFIX) or name in TEXT_NAMES


def load_labeled_images(splits=("test",), dataset_root: str = "") -> List[Tuple[str, List]]:
    """[(image_path, [(class_name, (x1, y1, x2, y2) normalised), ...])] for
    the text fields of every labelled image of ``splits``."""
    from manual_yolo_tpu_torch.train.data import load_yolo_names

    root = dataset_root or DATASET_ROOT
    names = load_yolo_names(root)
    out = []
    for split in splits:
        ldir = os.path.join(root, split, "labels")
        idir = os.path.join(root, split, "images")
        if not os.path.isdir(ldir):
            continue
        for fn in sorted(os.listdir(ldir)):
            stem = fn[:-4]
            img_path = os.path.join(idir, stem + ".jpg")
            if not os.path.exists(img_path):
                continue
            fields = []
            with open(os.path.join(ldir, fn)) as f:
                for ln in f:
                    p = ln.split()
                    if len(p) < 5:
                        continue
                    cname = names[int(p[0])]
                    if not _is_text(cname):
                        continue
                    xc, yc, bw, bh = (float(v) for v in p[1:5])
                    fields.append((cname, (xc - bw / 2, yc - bh / 2, xc + bw / 2, yc + bh / 2)))
            if fields:
                out.append((img_path, fields))
    return out


def build_regions(fields, w: int, h: int):
    """villainN name/stack/bet panels (multi-line) and every other field as a
    padded single-line region: [(region_xyxy, [gt_line_xyxy, ...])]."""
    px = lambda b: (int(b[0] * w), int(b[1] * h), int(b[2] * w), int(b[3] * h))  # noqa: E731
    groups: Dict[str, List] = {}
    singles = []
    for cname, b in fields:
        if cname.startswith("villian") and "_" in cname:
            groups.setdefault(cname.split("_")[0], []).append(px(b))
        else:
            singles.append(px(b))
    regions = []
    for lines in groups.values():
        x1 = min(l[0] for l in lines) - 6
        y1 = min(l[1] for l in lines) - 6
        x2 = max(l[2] for l in lines) + 6
        y2 = max(l[3] for l in lines) + 6
        regions.append(((max(0, x1), max(0, y1), min(w, x2), min(h, y2)), lines))
    for l in singles:
        x1, y1, x2, y2 = l
        regions.append(((max(0, x1 - 8), max(0, y1 - 8), min(w, x2 + 8), min(h, y2 + 8)), [l]))
    return regions


def craft_boxes(model, crop_bgr, text_threshold=0.7):
    """The CRAFT pass of ``read_region`` on one BGR crop -> line boxes in the
    crop's pixels."""
    from manual_yolo_tpu_torch.models import craft as craft_mod
    from manual_yolo_tpu_torch.ops.image import cv_resize

    h, w = crop_bgr.shape[:2]
    side = int(np.clip(max(h, w), 64, 512))
    side = (side + 31) // 32 * 32
    rgb = crop_bgr[..., ::-1].astype(np.float32) / 255.0
    canvas = np.zeros((side, side, 3), np.float32)
    s = min(side / h, side / w)
    nh, nw = max(1, round(h * s)), max(1, round(w * s))
    canvas[:nh, :nw] = cv_resize(rgb, (nh, nw), cubic=False)
    dev = next(model.parameters()).device
    with torch.inference_mode():
        scores = model(torch.from_numpy(canvas[None]).to(dev))[0].cpu().numpy()
    boxes = craft_mod.text_regions_from_scores(scores, text_threshold=text_threshold)
    return [(int(x1 / s), int(y1 / s), int(x2 / s), int(y2 / s)) for x1, y1, x2, y2 in boxes]


def evaluate(weights: str, splits=("test",), text_threshold: float = 0.7,
             limit: int = 0, device="cuda", dataset_root: str = "") -> Dict:
    from manual_yolo_tpu_torch.cli.eval_ocr import imread_or_none
    from manual_yolo_tpu_torch.core.device import resolve_device
    from manual_yolo_tpu_torch.models import craft as craft_mod
    from manual_yolo_tpu_torch.train.craft import _iou

    model = craft_mod.load_npz(weights, resolve_device(device))
    images = load_labeled_images(splits, dataset_root)
    if limit:
        images = images[:limit]
    tp = fp = fn = 0
    panel_tp = panel_fn = 0
    n_regions = 0
    for img_path, fields in images:
        img = imread_or_none(img_path)
        if img is None:
            continue
        h, w = img.shape[:2]
        for (rx1, ry1, rx2, ry2), gt_lines in build_regions(fields, w, h):
            crop = img[ry1:ry2, rx1:rx2]
            if crop.size == 0 or crop.shape[0] < 8 or crop.shape[1] < 8:
                continue
            n_regions += 1
            pred = craft_boxes(model, crop, text_threshold)
            gts = [(x1 - rx1, y1 - ry1, x2 - rx1, y2 - ry1) for x1, y1, x2, y2 in gt_lines]
            matched = set()
            for g in gts:
                hit = False
                gcx, gcy = (g[0] + g[2]) / 2, (g[1] + g[3]) / 2
                for pi, p in enumerate(pred):
                    if pi in matched:
                        continue
                    covers = p[0] <= gcx <= p[2] and p[1] <= gcy <= p[3]
                    if covers and _iou(g, p) >= 0.3:
                        matched.add(pi)
                        hit = True
                        break
                tp += int(hit)
                fn += int(not hit)
                if len(gts) > 1:
                    panel_tp += int(hit)
                    panel_fn += int(not hit)
            fp += len(pred) - len(matched)
    recall = tp / max(tp + fn, 1)
    precision = tp / max(tp + fp, 1)
    return {
        "weights": weights,
        "splits": list(splits),
        "regions": n_regions,
        "gt_lines": tp + fn,
        "recall": round(recall, 4),
        "precision": round(precision, 4),
        "f1": round(2 * precision * recall / max(precision + recall, 1e-9), 4),
        "panel_recall": round(panel_tp / max(panel_tp + panel_fn, 1), 4),
    }


def main(argv=None) -> int:
    from manual_yolo_tpu_torch.core.serialization import resolve_weight_path

    ap = argparse.ArgumentParser(description="Evaluate CRAFT on real UI text")
    ap.add_argument("--weights", default="weights/craft_real.npz")
    ap.add_argument("--splits", default="test")
    ap.add_argument("--text-threshold", type=float, default=0.7)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--dataset-root", default=DATASET_ROOT,
                    help="YOLO dataset root (data.yaml + splits)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    res = evaluate(resolve_weight_path(args.weights), splits=tuple(args.splits.split(",")),
                   text_threshold=args.text_threshold, limit=args.limit,
                   device=args.device, dataset_root=args.dataset_root)
    print(json.dumps(res, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
