"""Fixed-shape NMS. Counterpart of ``manual_yolo_tpu/ops/nms.py:29-107``.

  1. per-anchor best class (first index on ties, as ``jnp.argmax``),
  2. confidence gate,
  3. top-K pre-selection (``pre_nms``),
  4. class-aware greedy suppression by the coordinate-offset trick
     (``cls * MAX_WH`` added in f32): the keep mask comes from
     ``nms_keep`` — the CUDA kernel on the card, its plain twin on the CPU,
  5. ``max_det`` output slots, padded, with a count.

Top-k is a stable descending sort, so equal scores keep the lower index
first as ``jax.lax.top_k`` does (``torch.topk`` gives no such order).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from manual_yolo_tpu_torch.ops.nms_kernel import nms_keep

MAX_WH = 7680.0  # class-offset multiplier (any value larger than image side)


class Detections(NamedTuple):
    """Fixed-size detection set. Invalid slots have score 0 and class -1."""

    boxes: torch.Tensor  # (MAX_DET, 4) xyxy, image pixels
    scores: torch.Tensor  # (MAX_DET,)
    classes: torch.Tensor  # (MAX_DET,) int32, -1 for padding
    count: torch.Tensor  # () int32 number of valid detections


class Candidates(NamedTuple):
    """The ``pre_nms`` best anchors, score-descending: NMS's input."""

    boxes: torch.Tensor  # (K, 4) xyxy
    nms_boxes: torch.Tensor  # (K, 4) boxes + class offset
    conf: torch.Tensor  # (K,)
    classes: torch.Tensor  # (K,) int32
    valid: torch.Tensor  # (K,) bool, a prefix


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim, ties broken by the lower index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms_candidates(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    conf_thres: float = 0.25,
    pre_nms: int = 512,
    class_aware: bool = True,
) -> Candidates:
    """boxes (A,4), scores (A,nc) -> the ``pre_nms`` candidates NMS scans."""
    cls = scores.argmax(dim=-1).to(torch.int32)
    conf = scores.amax(dim=-1)
    valid = conf > conf_thres
    conf = torch.where(valid, conf, 0.0)

    k = min(pre_nms, boxes.shape[0])
    top_conf, top_idx = top_k(conf, k)
    top_boxes = boxes[top_idx]
    top_cls = cls[top_idx]
    top_valid = top_conf > conf_thres
    if class_aware:
        nms_boxes = top_boxes + top_cls.to(boxes.dtype)[:, None] * MAX_WH
    else:
        nms_boxes = top_boxes
    return Candidates(top_boxes, nms_boxes, top_conf, top_cls, top_valid)


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    conf_thres: float = 0.25,
    iou_thres: float = 0.7,
    pre_nms: int = 512,
    max_det: int = 300,
    class_aware: bool = True,
) -> Detections:
    """boxes (A,4) xyxy f32, scores (A,nc) -> fixed-size Detections.

    Matches ultralytics ``non_max_suppression`` defaults (conf 0.25, iou 0.7,
    max_det 300, class-aware)."""
    cand = nms_candidates(boxes, scores, conf_thres, pre_nms, class_aware)
    kept = nms_keep(cand.nms_boxes[None].contiguous(), cand.valid[None], iou_thres)[0]

    k = cand.conf.shape[0]
    out_conf = torch.where(kept, cand.conf, 0.0)
    m = min(max_det, k)
    sel_conf, sel = top_k(out_conf, m)
    sel_valid = sel_conf > 0.0
    det_boxes = torch.where(sel_valid[:, None], cand.boxes[sel], 0.0)
    det_cls = torch.where(sel_valid, cand.classes[sel], -1)
    if m < max_det:
        pad = max_det - m
        det_boxes = torch.nn.functional.pad(det_boxes, (0, 0, 0, pad))
        sel_conf = torch.nn.functional.pad(sel_conf, (0, pad))
        det_cls = torch.nn.functional.pad(det_cls, (0, pad), value=-1)
    return Detections(
        boxes=det_boxes,
        scores=sel_conf,
        classes=det_cls,
        count=sel_valid.sum(dtype=torch.int32),
    )
