"""Frame pipeline: uint8 BGR frame -> detections + rank-class probabilities.

Counterpart of ``manual_yolo_tpu/runtime/pipeline.py``. One call runs,
on the pipeline's device and with no host sync until the results are read:

  letterbox -> YOLOv8 detect -> DFL decode -> NMS (CUDA keep-mask kernel on
  the card) -> unletterbox -> top-8 rank-class boxes -> 64x64 crops
  (bilinear, short side scaled, center crop, pad 6) -> rank classifier (f32)
  -> softmax

The JAX package ``vmap``s the crop over the 8 boxes; here the boxes are a
batch dimension. There is no jit: PyTorch runs eagerly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from manual_yolo_tpu_torch.game import taxonomy
from manual_yolo_tpu_torch.game.text import VALID_CARD_RANKS, normalize_rank_text
from manual_yolo_tpu_torch.models import yolov8
from manual_yolo_tpu_torch.ops import nms as nms_ops
from manual_yolo_tpu_torch.ops.letterbox import letterbox, unletterbox_boxes


class FrameResult(NamedTuple):
    boxes: torch.Tensor  # (MAX_DET, 4) xyxy source pixels
    scores: torch.Tensor  # (MAX_DET,)
    classes: torch.Tensor  # (MAX_DET,) int32 (-1 pad)
    count: torch.Tensor  # () int32
    rank_det_idx: torch.Tensor  # (MAX_RANK,) index into boxes (-1 pad)
    rank_probs: torch.Tensor  # (MAX_RANK, n_rank_classes)


def crop_resize_center(
    frame: torch.Tensor, boxes: torch.Tensor, out_size: int, pad: float
) -> torch.Tensor:
    """Bilinear-sample boxes (R, 4) from an (H, W, 3) frame -> (R, out, out, 3) f32.

    The box's SHORT side maps to ``out_size`` and the long side is
    center-cropped, as the classifier's host preprocessing does.
    """
    H, W = frame.shape[0], frame.shape[1]
    x1, y1 = boxes[:, 0] - pad, boxes[:, 1] - pad
    x2, y2 = boxes[:, 2] + pad, boxes[:, 3] + pad
    w = (x2 - x1).clamp(min=1.0)
    h = (y2 - y1).clamp(min=1.0)
    step = torch.minimum(w, h) / out_size  # source pixels per output pixel
    cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
    grid = torch.arange(out_size, dtype=torch.float32, device=frame.device) - (out_size - 1) / 2.0
    idx = grid[None, :] * step[:, None]  # (R, out)
    xs = (cx[:, None] + idx).clamp(0.0, W - 1.0)
    ys = (cy[:, None] + idx).clamp(0.0, H - 1.0)
    x0 = xs.floor().long()
    y0 = ys.floor().long()
    x1i = (x0 + 1).clamp(max=W - 1)
    y1i = (y0 + 1).clamp(max=H - 1)
    fx = (xs - x0)[:, None, :, None]
    fy = (ys - y0)[:, :, None, None]
    f = frame.float()
    rows0, rows1 = y0[:, :, None], y1i[:, :, None]
    cols0, cols1 = x0[:, None, :], x1i[:, None, :]
    tl = f[rows0, cols0]
    tr = f[rows0, cols1]
    bl = f[rows1, cols0]
    br = f[rows1, cols1]
    top = tl * (1 - fx) + tr * fx
    bot = bl * (1 - fx) + br * fx
    return top * (1 - fy) + bot * fy


@dataclass
class FusedPipeline:
    """Detector + rank classifier over one frame, on ``device``."""

    det_model: yolov8.YOLOv8Detect
    cls_model: yolov8.YOLOv8Classify
    names: Dict[int, str]
    rank_names: Dict[int, str]
    device: torch.device
    imgsz: int = 640
    conf: float = 0.25
    iou: float = 0.7
    max_det: int = 300
    max_rank: int = 8
    crop_pad: float = 6.0

    def __post_init__(self):
        self._rank_class_ids = torch.tensor(
            [i for i, n in self.names.items() if n in taxonomy.RANK_CLASSES],
            dtype=torch.int32, device=self.device,
        )

    @torch.inference_mode()
    def __call__(self, frame_bgr: np.ndarray) -> FrameResult:
        H = W = self.imgsz
        frame = torch.from_numpy(np.ascontiguousarray(frame_bgr)).to(self.device)
        src_hw = (frame.shape[0], frame.shape[1])
        rgb = frame.flip(-1)
        canvas, ratio, padlt = letterbox(rgb, (H, W), scaleup=True)
        raw = self.det_model(canvas[None])
        boxes, scores = yolov8.decode_boxes(raw, (H, W), self.det_model.spec.strides)
        det = nms_ops.nms(
            boxes[0], scores[0], conf_thres=self.conf, iou_thres=self.iou,
            pre_nms=512, max_det=self.max_det,
        )
        src_boxes = unletterbox_boxes(det.boxes, ratio, padlt, src_hw)
        src_boxes = torch.where(det.scores[:, None] > 0, src_boxes, 0.0)

        # select top-K rank-class detections
        is_rank = (det.classes[:, None] == self._rank_class_ids[None, :]).any(dim=1)
        rank_score = torch.where(is_rank, det.scores, 0.0)
        top_scores, top_idx = nms_ops.top_k(rank_score, self.max_rank)
        valid = top_scores > 0.0
        rank_det_idx = torch.where(valid, top_idx, -1)

        crops = crop_resize_center(rgb, src_boxes[top_idx], 64, self.crop_pad) / 255.0
        # the classifier runs f32 (cls_model's dtype): it is tiny and bf16
        # flips borderline rank reads near the confidence thresholds
        logits = self.cls_model(crops)
        probs = torch.softmax(logits, dim=-1)
        probs = torch.where(valid[:, None], probs, 0.0)
        return FrameResult(src_boxes, det.scores, det.classes, det.count, rank_det_idx, probs)

    def process_frame(self, frame_bgr: np.ndarray) -> List[Dict]:
        """Per-detection list with rank text resolved: class_name, bbox, conf
        and, for rank classes, the classifier's reading above 0.40 (0.20 for
        turn/river)."""
        res = FrameResult(*(t.cpu().numpy() for t in self(frame_bgr)))
        n = int(res.count)
        dets: List[Dict] = []
        for i in range(n):
            cid = int(res.classes[i])
            x1, y1, x2, y2 = (int(v) for v in res.boxes[i])
            dets.append(
                {
                    "class_id": cid,
                    "class_name": self.names.get(cid, f"class{cid}"),
                    "bbox": [x1, y1, x2, y2],
                    "conf": round(float(res.scores[i]), 3),
                    "ocr_text": "",
                }
            )
        for slot in range(len(res.rank_det_idx)):
            di = int(res.rank_det_idx[slot])
            if di < 0 or di >= n:
                continue
            probs = res.rank_probs[slot]
            top = int(np.argmax(probs))
            conf = float(probs[top])
            cname = dets[di]["class_name"]
            thr = 0.20 if ("turn" in cname or "river" in cname) else 0.40
            if conf >= thr:
                pred = self.rank_names.get(top, "")
                cleaned = normalize_rank_text(pred)
                dets[di]["ocr_text"] = (
                    cleaned if cleaned in VALID_CARD_RANKS else pred.upper()
                )
        return dets
