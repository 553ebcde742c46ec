"""Tiling a large frame into one detector batch, and merging the tiles back.

Counterpart of ``manual_yolo_tpu/parallel/inference.py:94-160``
(``tiled_frames`` and ``merge_tile_detections``, copied; host numpy). The
tiles go through ``DetectorEngine.detect_batch`` as one batch; the merge is
the JAX package's greedy loop on the host (its own ``1e-9`` epsilon and
same-class test, not the NMS kernel's). ``ShardedDetector`` is not ported.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from manual_yolo_tpu_torch.ops import nms as nms_ops


def tiled_frames(frame: np.ndarray, tile: int = 640, overlap: float = 0.2):
    """Slice a large frame into overlapping tiles + offsets (SAHI-equivalent,
    reference pipe.py:183-194 — but emitted as ONE batch)."""
    H, W = frame.shape[:2]
    stride = max(1, int(tile * (1 - overlap)))
    ys = list(range(0, max(H - tile, 0) + 1, stride)) or [0]
    xs = list(range(0, max(W - tile, 0) + 1, stride)) or [0]
    if ys[-1] + tile < H:
        ys.append(H - tile)
    if xs[-1] + tile < W:
        xs.append(W - tile)
    tiles, offsets = [], []
    for y in ys:
        for x in xs:
            t = frame[y : y + tile, x : x + tile]
            if t.shape[0] < tile or t.shape[1] < tile:
                pad = np.full((tile, tile, 3), 114, frame.dtype)
                pad[: t.shape[0], : t.shape[1]] = t
                t = pad
            tiles.append(t)
            offsets.append((x, y))
    return np.stack(tiles), offsets


def merge_tile_detections(
    det: nms_ops.Detections, offsets, conf_thres: float = 0.25,
    iou_thres: float = 0.7, max_det: int = 300,
) -> Dict[str, np.ndarray]:
    """Merge per-tile detections back into frame space with a global NMS."""
    det = nms_ops.Detections(*(np.asarray(t.cpu()) for t in det))
    boxes, scores, classes = [], [], []
    for ti, (ox, oy) in enumerate(offsets):
        n = int(det.count[ti])
        if not n:
            continue
        b = np.asarray(det.boxes[ti][:n]) + np.array([ox, oy, ox, oy], np.float32)
        boxes.append(b)
        scores.append(np.asarray(det.scores[ti][:n]))
        classes.append(np.asarray(det.classes[ti][:n]))
    if not boxes:
        return {"boxes": np.zeros((0, 4)), "scores": np.zeros(0), "classes": np.zeros(0, int)}
    boxes = np.concatenate(boxes)
    scores = np.concatenate(scores)
    classes = np.concatenate(classes)
    order = np.argsort(-scores)
    keep = []
    for i in order[: max_det * 4]:
        ok = True
        for j in keep:
            if classes[i] != classes[j]:
                continue
            bi, bj = boxes[i], boxes[j]
            x1, y1 = max(bi[0], bj[0]), max(bi[1], bj[1])
            x2, y2 = min(bi[2], bj[2]), min(bi[3], bj[3])
            inter = max(0, x2 - x1) * max(0, y2 - y1)
            a = (bi[2] - bi[0]) * (bi[3] - bi[1])
            b2 = (bj[2] - bj[0]) * (bj[3] - bj[1])
            if inter / (a + b2 - inter + 1e-9) > iou_thres:
                ok = False
                break
        if ok and scores[i] > conf_thres:
            keep.append(i)
        if len(keep) >= max_det:
            break
    keep = np.asarray(keep, int)
    return {"boxes": boxes[keep], "scores": scores[keep], "classes": classes[keep]}
