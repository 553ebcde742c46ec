"""Sharded batch inference, and tiling a large frame into one batch.

Counterpart of ``manual_yolo_tpu/parallel/inference.py``.
``ShardedDetector`` splits a batch of frames over the data ranks of a
``Mesh`` (``parallel/mesh.py``): each rank runs ``DetectorEngine.detect_batch``
(letterbox -> forward -> decode -> ``nms_batch``, on the card one launch of
the CUDA keep kernel, ``csrc/nms_keep.cu``, per rank per call ->
unletterbox) on its frames, and the fixed-size results are all-gathered in
rank order; a batch that does not split evenly is padded with zero frames
and the padding dropped, as JAX pads. A mesh of one rank calls the engine
alone. ``tiled_frames`` and ``merge_tile_detections`` are copied (host
numpy): the tiles go through ``DetectorEngine.detect_batch`` as one batch;
the merge is the JAX package's greedy loop on the host (its own ``1e-9``
epsilon and same-class test, not the NMS kernel's).
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch
import torch.distributed as dist

from manual_yolo_tpu_torch.models import yolov8
from manual_yolo_tpu_torch.ops import nms as nms_ops
from manual_yolo_tpu_torch.runtime.engine import DetectorEngine


class ShardedDetector:
    """Data-parallel detector over a mesh: (B, H, W, 3) uint8 BGR frames ->
    Detections with a leading B on every rank (boxes in source pixels)."""

    def __init__(
        self,
        params,
        spec: yolov8.ModelSpec,
        mesh,
        imgsz: int = 640,
        conf: float = 0.25,
        iou: float = 0.7,
        max_det: int = 300,
        compute_dtype: torch.dtype = torch.bfloat16,
        data_axis: str = "data",
        device: Union[str, torch.device] = "cuda",
    ):
        """``params``: a folded JAX-layout tree, as the JAX class takes."""
        model = yolov8.load_jax_params(yolov8.build_model(spec, compute_dtype), params)
        self.engine = DetectorEngine(model, imgsz=imgsz, conf=conf, iou=iou, max_det=max_det,
                                     device=device)
        # one rank's program on a batch (no collective): what a mesh of one
        # rank computes for the whole batch
        self.local = self.engine.detect_batch
        self.group = mesh.group(data_axis)
        self.n, self.rank = mesh.shape[data_axis], mesh.coord(data_axis)

    @torch.inference_mode()
    def __call__(self, frames_bgr: np.ndarray) -> nms_ops.Detections:
        if self.n == 1:
            return self.local(frames_bgr)
        b = frames_bgr.shape[0]
        pad = (-b) % self.n
        if pad:
            frames_bgr = np.concatenate(
                [frames_bgr, np.zeros((pad,) + frames_bgr.shape[1:], frames_bgr.dtype)])
        per = frames_bgr.shape[0] // self.n
        mine = self.local(frames_bgr[self.rank * per:(self.rank + 1) * per])
        out = []
        for t in mine:
            parts = [torch.empty_like(t) for _ in range(self.n)]
            dist.all_gather(parts, t.contiguous(), group=self.group)
            out.append(torch.cat(parts)[:b])
        return nms_ops.Detections(*out)


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
