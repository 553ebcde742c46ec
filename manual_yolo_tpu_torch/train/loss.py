"""YOLOv8 detection loss: task-aligned assignment + CIoU + DFL + BCE.

Counterpart of ``manual_yolo_tpu/train/loss.py``: TaskAlignedAssigner
(top-k 10, alpha 0.5, beta 6), CIoU box loss, distribution-focal loss over
16 bins, BCE classification over all anchors, gains box 7.5 / cls 0.5 /
dfl 1.5. Dense and batched: the JAX ``vmap`` over frames is a leading
batch dimension here.

``jax.lax.top_k`` becomes the stable ``ops/nms.py::top_k`` (equal values
keep the lower index first), and the ``argmax`` of a boolean mask its first
``True``, as in JAX.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from manual_yolo_tpu_torch.models import yolov8
from manual_yolo_tpu_torch.ops.boxes import elementwise_ciou, pairwise_ciou
from manual_yolo_tpu_torch.ops.nms import top_k

TAL_TOPK = 10
TAL_ALPHA = 0.5
TAL_BETA = 6.0
EPS = 1e-9


class AssignOut(NamedTuple):
    target_scores: torch.Tensor  # ([B,] A, nc)
    target_boxes: torch.Tensor  # ([B,] A, 4) canvas pixels
    fg_mask: torch.Tensor  # ([B,] A) bool


def assign(
    scores_sig: torch.Tensor,  # (B, A, nc) sigmoid scores (detached)
    pred_boxes: torch.Tensor,  # (B, A, 4) xyxy pixels (detached)
    anchor_px: torch.Tensor,  # (A, 2) anchor centres in pixels
    gt_cls: torch.Tensor,  # (B, M) int
    gt_boxes: torch.Tensor,  # (B, M, 4) xyxy pixels
    gt_mask: torch.Tensor,  # (B, M) bool
    nc: int,
) -> AssignOut:
    """Task-aligned assignment of B frames at once (JAX ``assign_one``, vmapped)."""
    B, A = scores_sig.shape[:2]
    M = gt_boxes.shape[1]
    anc = anchor_px[None, :, None, :]
    # candidate anchors: centre strictly inside the gt box
    deltas = torch.cat([anc - gt_boxes[:, None, :, :2], gt_boxes[:, None, :, 2:] - anc], dim=-1)
    in_gts = deltas.amin(dim=-1) > EPS  # (B, A, M)

    overlaps = pairwise_ciou(pred_boxes, gt_boxes).clamp(min=0.0)  # (B, A, M)
    cls_idx = gt_cls.long()[:, None, :].expand(B, A, M)
    cls_score = torch.take_along_dim(scores_sig, cls_idx, dim=2)  # (B, A, M)
    align = cls_score**TAL_ALPHA * overlaps**TAL_BETA

    candidate = in_gts & gt_mask[:, None, :]
    align_c = torch.where(candidate, align, 0.0)

    # top-k anchors per gt
    k = min(TAL_TOPK, A)
    top_vals, top_idx = top_k(align_c.transpose(1, 2), k)  # (B, M, k)
    is_topk = torch.zeros((B, M, A), dtype=torch.bool, device=align.device)
    is_topk.scatter_(2, top_idx, top_vals > EPS)
    mask_pos = is_topk.transpose(1, 2) & candidate  # (B, A, M)

    # resolve anchors claimed by multiple gts: keep the highest-overlap gt
    multi = mask_pos.sum(dim=2, keepdim=True) > 1
    best = torch.where(mask_pos, overlaps, -1.0).argmax(dim=2)  # first max
    only_best = F.one_hot(best, M).bool()
    mask_pos = torch.where(multi, mask_pos & only_best, mask_pos)

    fg = mask_pos.any(dim=2)  # (B, A)
    assigned = mask_pos.to(torch.uint8).argmax(dim=2)  # first True, 0 if none

    # normalised target scores (ultralytics-style)
    align_m = torch.where(mask_pos, align, 0.0)
    overlaps_m = torch.where(mask_pos, overlaps, 0.0)
    pos_align = align_m.amax(dim=1)  # (B, M)
    pos_overlap = overlaps_m.amax(dim=1)
    norm = align_m * (pos_overlap / (pos_align + EPS))[:, None, :]
    score_at_assigned = torch.take_along_dim(norm, assigned[..., None], dim=2)[..., 0]

    tgt_cls = torch.take_along_dim(gt_cls.long(), assigned, dim=1)
    onehot = F.one_hot(tgt_cls, nc).float()
    target_scores = onehot * torch.where(fg, score_at_assigned, 0.0)[..., None]
    target_boxes = torch.take_along_dim(gt_boxes, assigned[..., None], dim=1)
    return AssignOut(target_scores, target_boxes, fg)


def assign_one(scores_sig, pred_boxes, anchor_px, gt_cls, gt_boxes, gt_mask, nc) -> AssignOut:
    """One frame: (A, nc), (A, 4), (A, 2), (M,), (M, 4), (M,) -> AssignOut."""
    out = assign(scores_sig[None], pred_boxes[None], anchor_px, gt_cls[None],
                 gt_boxes[None], gt_mask[None], nc)
    return AssignOut(*(t[0] for t in out))


def detection_loss(
    model: yolov8.YOLOv8Detect,
    images: torch.Tensor,  # (B, H, W, 3) [0,1] RGB, or uint8
    targets: torch.Tensor,  # (B, M, 5) [cls, x1, y1, x2, y2] canvas px
    tmask: torch.Tensor,  # (B, M) bool
    box_gain: float = 7.5,
    cls_gain: float = 0.5,
    dfl_gain: float = 1.5,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss of one batch through ``model`` (a train model: in train
    mode its BN uses, and updates, the batch statistics)."""
    H, W = images.shape[1:3]
    nc = model.spec.nc
    if images.dtype == torch.uint8:  # uint8 batches normalise on device
        images = images.float() / 255.0
    raw = model(images)

    dists, logits = [], []
    for box, cls in raw:
        b, h, w, _ = box.shape
        dists.append(box.reshape(b, h * w, 4 * yolov8.REG_MAX))
        logits.append(cls.reshape(b, h * w, nc))
    pred_dist = torch.cat(dists, dim=1)  # (B, A, 64)
    pred_logits = torch.cat(logits, dim=1)  # (B, A, nc)

    anchors_np, astride_np = yolov8.make_anchors((H, W), model.spec.strides)
    anchors = torch.from_numpy(anchors_np).to(images.device)  # (A, 2) stride units
    astride = torch.from_numpy(astride_np).to(images.device)  # (A, 1)
    anchor_px = anchors * astride

    # decoded boxes in pixels (used both for assignment and box loss)
    ltrb = yolov8.dfl_decode(pred_dist)  # (B, A, 4) stride units
    x1y1 = (anchors[None] - ltrb[..., :2]) * astride[None]
    x2y2 = (anchors[None] + ltrb[..., 2:]) * astride[None]
    pred_boxes = torch.cat([x1y1, x2y2], dim=-1)

    with torch.no_grad():
        target_scores, target_boxes, fg = assign(
            torch.sigmoid(pred_logits), pred_boxes, anchor_px,
            targets[..., 0].to(torch.int32), targets[..., 1:5], tmask, nc,
        )

    ts_sum = target_scores.sum().clamp(min=1.0)

    # classification: BCE with soft targets over ALL anchors
    bce = (pred_logits.clamp(min=0) - pred_logits * target_scores
           + torch.log1p(torch.exp(-pred_logits.abs())))
    loss_cls = bce.sum() / ts_sum

    # box: CIoU on foreground, weighted by assigned target score
    weight = target_scores.sum(dim=-1)  # (B, A)
    iou = elementwise_ciou(pred_boxes, target_boxes)  # (B, A)
    loss_box = torch.where(fg, (1.0 - iou) * weight, 0.0).sum() / ts_sum

    # DFL on foreground
    tgt_ltrb = torch.cat([anchor_px[None] - target_boxes[..., :2],
                          target_boxes[..., 2:] - anchor_px[None]], dim=-1) / astride[None]
    tgt_ltrb = tgt_ltrb.clamp(0.0, yolov8.REG_MAX - 1 - 0.01)
    tl = torch.floor(tgt_ltrb)
    wr = tgt_ltrb - tl
    wl = 1.0 - wr
    logp = torch.log_softmax(pred_dist.reshape(pred_dist.shape[:-1] + (4, yolov8.REG_MAX)), dim=-1)
    tl_i = tl.long()
    tr_i = (tl_i + 1).clamp(max=yolov8.REG_MAX - 1)
    ce = -(torch.take_along_dim(logp, tl_i[..., None], dim=-1)[..., 0] * wl
           + torch.take_along_dim(logp, tr_i[..., None], dim=-1)[..., 0] * wr)  # (B, A, 4)
    dfl = ce.mean(dim=-1)  # (B, A)
    loss_dfl = torch.where(fg, dfl * weight, 0.0).sum() / ts_sum

    total = box_gain * loss_box + cls_gain * loss_cls + dfl_gain * loss_dfl
    aux = {"box": loss_box, "cls": loss_cls, "dfl": loss_dfl, "num_fg": fg.sum()}
    return total, aux
