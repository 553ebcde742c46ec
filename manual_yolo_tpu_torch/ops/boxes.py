"""Box geometry. Counterpart of ``manual_yolo_tpu/ops/boxes.py``.

The operation order matches the JAX functions (and the NMS kernel), so the
IoU values agree bit for bit in f32. Every function takes leading batch
dimensions.
"""

from __future__ import annotations

import math

import torch


def box_area(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)


def pairwise_iou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """IoU matrix between (..., N, 4) and (..., M, 4) xyxy boxes -> (..., N, M)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return inter / (union + eps)


def _ciou_terms(a, b, iou, eps):
    """CIoU of broadcast box pairs ``a``, ``b`` (..., 4) given their IoU."""
    elt = torch.minimum(a[..., :2], b[..., :2])
    erb = torch.maximum(a[..., 2:], b[..., 2:])
    cwh = (erb - elt).clamp(min=0)
    c2 = cwh[..., 0] ** 2 + cwh[..., 1] ** 2 + eps  # enclosing box diagonal
    ac = (a[..., :2] + a[..., 2:]) / 2
    bc = (b[..., :2] + b[..., 2:]) / 2
    d2 = ((ac - bc) ** 2).sum(-1)  # centre distance
    aw = (a[..., 2] - a[..., 0]).clamp(min=eps)
    ah = (a[..., 3] - a[..., 1]).clamp(min=eps)
    bw = (b[..., 2] - b[..., 0]).clamp(min=eps)
    bh = (b[..., 3] - b[..., 1]).clamp(min=eps)
    v = (4 / math.pi**2) * (torch.atan(bw / bh) - torch.atan(aw / ah)) ** 2
    alpha = (v / (v - iou + (1.0 + eps))).detach()
    return iou - d2 / c2 - alpha * v


def pairwise_ciou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Complete-IoU between (..., N, 4) and (..., M, 4) xyxy boxes -> (..., N, M).
    The aspect-ratio weight ``alpha`` carries no gradient."""
    iou = pairwise_iou(a, b, eps)
    return _ciou_terms(a[..., :, None, :], b[..., None, :, :], iou, eps)


def elementwise_ciou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """CIoU between matched box pairs: (..., 4) x (..., 4) -> (...)."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    iou = inter / (box_area(a) + box_area(b) - inter + eps)
    return _ciou_terms(a, b, iou, eps)


def xywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def xyxy_to_xywh(b: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)
