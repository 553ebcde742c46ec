"""Detection mAP (50, 50-95), numpy, host-side.

A copy of ``manual_yolo_tpu/train/metrics.py``: 101-point-interpolated
COCO-style AP per class, averaged over the classes that have ground truth.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-9)


def _ap_from_pr(recall: np.ndarray, precision: np.ndarray) -> float:
    """101-point interpolated AP (COCO style)."""
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[1.0], precision, [0.0]])
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    return float(np.trapezoid(np.interp(x, mrec, mpre), x))


def mean_average_precision(
    preds: Sequence[Dict[str, np.ndarray]],
    gts: Sequence[Dict[str, np.ndarray]],
    iou_thresholds: Sequence[float] = tuple(np.arange(0.5, 1.0, 0.05)),
) -> Dict[str, float]:
    """preds/gts: per-image dicts with 'boxes' (N,4) xyxy, 'classes' (N,), preds
    also 'scores' (N,). Returns {'map50': ..., 'map50_95': ...}.
    """
    classes = set()
    for g in gts:
        classes.update(np.asarray(g["classes"]).tolist())
    classes = sorted(classes)
    aps = np.zeros((len(classes), len(iou_thresholds)))
    for ci, c in enumerate(classes):
        # gather detections of class c over all images, sorted by score
        recs = []
        npos = 0
        for img_i, (p, g) in enumerate(zip(preds, gts)):
            gm = np.asarray(g["classes"]) == c
            npos += int(gm.sum())
            pm = np.asarray(p["classes"]) == c
            for score, box in zip(np.asarray(p["scores"])[pm], np.asarray(p["boxes"])[pm]):
                recs.append((float(score), img_i, box))
        if npos == 0:
            aps[ci] = np.nan
            continue
        recs.sort(key=lambda r: -r[0])
        for ti, thr in enumerate(iou_thresholds):
            matched = {i: np.zeros(int((np.asarray(g["classes"]) == c).sum()), bool)
                       for i, g in enumerate(gts)}
            tp = np.zeros(len(recs))
            fp = np.zeros(len(recs))
            for ri, (score, img_i, box) in enumerate(recs):
                g = gts[img_i]
                gm = np.asarray(g["classes"]) == c
                gboxes = np.asarray(g["boxes"])[gm]
                if len(gboxes) == 0:
                    fp[ri] = 1
                    continue
                ious = _iou_matrix(box[None], gboxes)[0]
                # COCO-style: best UNMATCHED GT above threshold
                order = np.argsort(-ious)
                hit = False
                for j in order:
                    if ious[j] < thr:
                        break
                    if not matched[img_i][j]:
                        tp[ri] = 1
                        matched[img_i][j] = True
                        hit = True
                        break
                if not hit:
                    fp[ri] = 1
            ctp = np.cumsum(tp)
            cfp = np.cumsum(fp)
            recall = ctp / npos
            precision = ctp / np.maximum(ctp + cfp, 1e-9)
            aps[ci, ti] = _ap_from_pr(recall, precision)
    valid = ~np.isnan(aps[:, 0])
    if not valid.any():
        return {"map50": 0.0, "map50_95": 0.0}
    return {
        "map50": float(np.nanmean(aps[valid, 0])),
        "map50_95": float(np.nanmean(aps[valid])),
    }
