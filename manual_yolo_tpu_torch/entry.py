"""The flagship's one-call frame program. Counterpart of
``__graft_entry__.py::entry``.

    python -m manual_yolo_tpu_torch.entry [--device cpu]

``entry()`` returns ``(fn, example_args)``. ``fn(det_model, cls_model,
frame)`` runs, in the JAX program's order and on the models' device:

  BGR -> RGB -> letterbox to 640 (``scaleup=True``) -> YOLOv8n detect (bf16)
  -> DFL decode -> NMS at conf 0.25, IoU 0.7 (the CUDA keep-mask kernel on
  the card, one launch) -> unletterbox to the frame -> the 8 best rank-class
  detections -> 64x64 crops (pad 6) / 255 -> YOLOv8n-cls logits (bf16)

and returns ``(src_boxes (300, 4), scores (300,), classes (300,), count (),
logits (8, 13))``, as the JAX ``fn`` does. Nothing is read back to the host
between the detector and the classifier; PyTorch runs eagerly, so there is
no compile step.

Where it differs from the JAX ``entry()``: JAX draws random parameters from
``PRNGKey(0)`` and ``PRNGKey(1)``, which torch cannot reproduce and whose
scores keep no box at conf 0.25, so the example arguments here are the
committed checkpoints (``weights/poker_detector_n.npz``,
``weights/rank_classifier_matched.npz``), folded; and the example frame is
seeded (``np.random.default_rng(0)``) where JAX's is not.
"""

from __future__ import annotations

import argparse
from typing import Any, Optional, Tuple

import numpy as np
import torch

from manual_yolo_tpu_torch.core.device import resolve_device
from manual_yolo_tpu_torch.core.serialization import load_params
from manual_yolo_tpu_torch.game import taxonomy
from manual_yolo_tpu_torch.models import yolov8
from manual_yolo_tpu_torch.ops import nms as nms_ops
from manual_yolo_tpu_torch.ops.letterbox import letterbox, unletterbox_boxes
from manual_yolo_tpu_torch.runtime.pipeline import crop_resize_center

DET_WEIGHTS = "weights/poker_detector_n.npz"
CLS_WEIGHTS = "weights/rank_classifier_matched.npz"
DET_SPEC = yolov8.build_spec("detect", "n", nc=64)
CLS_SPEC = yolov8.build_spec("classify", "n", nc=13)
SRC_HW = (1200, 1920)
IMGSZ = 640
MAX_RANK = 8
RANK_IDS = [i for i, n in taxonomy.CLASSES.items() if n in taxonomy.RANK_CLASSES]


def build_models(det_params: Any, cls_params: Any, device: torch.device,
                 dtype: torch.dtype = torch.bfloat16) -> Tuple[yolov8.YOLOv8Detect, yolov8.YOLOv8Classify]:
    """The detector and the rank classifier from JAX-layout parameter trees
    (numpy leaves, BN folded or not), folded, in ``dtype`` on ``device``."""
    det = yolov8.build_model(DET_SPEC, dtype)
    cls = yolov8.build_model(CLS_SPEC, dtype)
    yolov8.load_jax_params(det, yolov8.fold_params(det_params, DET_SPEC))
    yolov8.load_jax_params(cls, yolov8.fold_params(cls_params, CLS_SPEC))
    return det.to(device).eval(), cls.to(device).eval()


def make_fn(device: torch.device):
    """The frame program for models on ``device``."""
    rank_ids = torch.tensor(RANK_IDS, dtype=torch.int32, device=device)

    @torch.inference_mode()
    def fn(det_model, cls_model, frame):
        frame = torch.as_tensor(frame, device=device)
        rgb = frame.flip(-1)
        canvas, ratio, pad = letterbox(rgb, (IMGSZ, IMGSZ), scaleup=True)
        raw = det_model(canvas[None])
        boxes, scores = yolov8.decode_boxes(raw, (IMGSZ, IMGSZ), DET_SPEC.strides)
        det = nms_ops.nms(boxes[0], scores[0], conf_thres=0.25, iou_thres=0.7)
        src_boxes = unletterbox_boxes(det.boxes, ratio, pad, tuple(frame.shape[:2]))
        is_rank = (det.classes[:, None] == rank_ids[None, :]).any(dim=1)
        rscore = torch.where(is_rank, det.scores, 0.0)
        _, top_idx = nms_ops.top_k(rscore, MAX_RANK)
        crops = crop_resize_center(rgb, src_boxes[top_idx], 64, 6.0) / 255.0
        logits = cls_model(crops)
        return src_boxes, det.scores, det.classes, det.count, logits

    return fn


def entry(device: Optional[str] = None):
    """Returns (fn, example_args): the frame program and the committed
    YOLOv8n detector and rank classifier in bf16 on ``device`` (the card
    unless the caller asks for the CPU), with a seeded 1200x1920 frame."""
    dev = resolve_device(device or "cuda")
    det_model, cls_model = build_models(load_params(DET_WEIGHTS)[0], load_params(CLS_WEIGHTS)[0], dev)
    frame = np.random.default_rng(0).integers(0, 255, SRC_HW + (3,), np.uint8)
    return make_fn(dev), (det_model, cls_model, frame)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run the one-call frame program once")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    fn, example = entry(args.device)
    out = fn(*example)
    print("entry ok:", [tuple(o.shape) for o in out])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
