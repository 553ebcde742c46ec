"""Detection engine: raw frames -> fixed-size detections on one device.

Counterpart of ``manual_yolo_tpu/runtime/engine.py`` (``DetectorEngine``).
One call runs, on the engine's device:

  BGR->RGB -> letterbox (batched) -> YOLOv8 detect -> DFL decode ->
  NMS (one keep-mask call for all frames: the CUDA kernel on the card) ->
  unletterbox -> zeroed boxes in empty slots

``detect_batch`` takes B same-shape frames (the tiles of a frame, in the
hand session) through one forward and one NMS: the JAX package's
``jax.vmap`` of its per-frame program. ``detect`` is its B=1 case.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from manual_yolo_tpu_torch.core.device import resolve_device
from manual_yolo_tpu_torch.core.serialization import load_params
from manual_yolo_tpu_torch.game import taxonomy
from manual_yolo_tpu_torch.models import yolov8
from manual_yolo_tpu_torch.ops import nms as nms_ops
from manual_yolo_tpu_torch.ops.letterbox import letterbox_batch, unletterbox_boxes

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def load_detector(
    path: str, compute_dtype: str = "bfloat16"
) -> Tuple[yolov8.YOLOv8Detect, Dict[int, str]]:
    """A native detector checkpoint -> (model on the CPU, class names). The
    convs run in ``compute_dtype`` ("bfloat16" or "float32"; any other value
    raises ``ValueError``)."""
    if compute_dtype not in DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(DTYPES)}, got {compute_dtype!r}")
    params, meta = load_params(path)
    sp = meta.get("spec", {})
    spec = yolov8.build_spec("detect", sp.get("scale", "n"), int(sp.get("nc", 64)))
    model = yolov8.build_model(spec, DTYPES[compute_dtype])
    yolov8.load_jax_params(model, yolov8.fold_params(params, spec))
    names = {int(k): v for k, v in meta.get("names", {}).items()} or taxonomy.CLASSES
    return model, names


class DetectorEngine:
    """YOLOv8 detector with ultralytics-equivalent postprocess, on ``device``."""

    def __init__(
        self,
        model: yolov8.YOLOv8Detect,
        names: Optional[Dict[int, str]] = None,
        imgsz: int = 640,
        conf: float = 0.25,
        iou: float = 0.7,
        max_det: int = 300,
        pre_nms: int = 512,
        device: Union[str, torch.device] = "cuda",
    ):
        if model.spec.variant != "detect":
            raise ValueError(f"DetectorEngine needs a detect model, got {model.spec.variant!r}")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.spec = model.spec
        self.names = names or {}
        self.imgsz = int(imgsz)
        self.conf = conf
        self.iou = iou
        self.max_det = max_det
        self.pre_nms = pre_nms

    @classmethod
    def from_npz(
        cls,
        path: str,
        imgsz: int = 640,
        conf: float = 0.25,
        iou: float = 0.7,
        compute_dtype: str = "bfloat16",
        device: Union[str, torch.device] = "cuda",
    ) -> "DetectorEngine":
        """Build from a native detector checkpoint (``load_detector``)."""
        dev = resolve_device(device)
        model, names = load_detector(path, compute_dtype)
        return cls(model, names, imgsz=imgsz, conf=conf, iou=iou, device=dev)

    @torch.inference_mode()
    def detect_batch(self, frames_bgr) -> nms_ops.Detections:
        """frames (B, H, W, 3) uint8 BGR -> Detections with a leading B, on
        the engine's device; boxes in source-frame pixels."""
        H = W = self.imgsz
        frames = torch.as_tensor(np.ascontiguousarray(frames_bgr)).to(self.device)
        src_hw = (frames.shape[1], frames.shape[2])
        rgb = frames.flip(-1)  # the reference feeds BGR; the network expects RGB
        canvas, ratio, pad = letterbox_batch(rgb, (H, W), scaleup=True)
        raw = self.model(canvas)
        boxes, scores = yolov8.decode_boxes(raw, (H, W), self.spec.strides)
        det = nms_ops.nms_batch(
            boxes, scores, conf_thres=self.conf, iou_thres=self.iou,
            pre_nms=self.pre_nms, max_det=self.max_det,
        )
        out_boxes = unletterbox_boxes(det.boxes, ratio, pad, src_hw)
        out_boxes = torch.where(det.scores[..., None] > 0, out_boxes, 0.0)
        return nms_ops.Detections(out_boxes, det.scores, det.classes, det.count)

    def detect(self, frame_bgr: np.ndarray) -> nms_ops.Detections:
        """frame (H, W, 3) uint8 BGR -> Detections (tensors on the device)."""
        det = self.detect_batch(np.asarray(frame_bgr)[None])
        return nms_ops.Detections(*(t[0] for t in det))

    def detect_to_list(self, frame_bgr: np.ndarray) -> List[Dict]:
        """Reference-parity output: a list of dicts like the reference's
        parsed ultralytics results (``pipe.py:100-135``). Box corners are
        truncated to int as the JAX package does."""
        det = nms_ops.Detections(*(t.cpu().numpy() for t in self.detect(frame_bgr)))
        n = int(det.count)
        out = []
        h, w = frame_bgr.shape[:2]
        for i in range(n):
            x1, y1, x2, y2 = det.boxes[i].tolist()
            cid = int(det.classes[i])
            out.append(
                {
                    "x1": max(0, int(x1)),
                    "y1": max(0, int(y1)),
                    "x2": min(w - 1, int(x2)),
                    "y2": min(h - 1, int(y2)),
                    "conf": float(det.scores[i]),
                    "class_id": cid,
                    "class_name": self.names.get(cid, f"class{cid}"),
                }
            )
        return out
