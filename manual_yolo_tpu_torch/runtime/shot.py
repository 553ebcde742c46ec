"""Single-screenshot pipeline: image file in -> flat result JSON out.

Counterpart of ``manual_yolo_tpu/runtime/shot.py`` (``process_screenshot``,
``load_fused_pipeline``). The image is read by the port's own PNG reader
(``runtime/png.py``) instead of ``cv2.imread``. Rank fields are read by the
batched rank classifier inside ``FusedPipeline``.

Not ported yet: the annotated output image (it needs OpenCV's text
rendering), the OCR pass for numeric/name fields and the vision-LLM
fallback. Asking for any of them raises ``NotImplementedError``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from manual_yolo_tpu_torch.core.device import resolve_device
from manual_yolo_tpu_torch.core.serialization import load_params
from manual_yolo_tpu_torch.game import schema, taxonomy
from manual_yolo_tpu_torch.game.accumulate import merge_detected_values
from manual_yolo_tpu_torch.game.text import suit_char
from manual_yolo_tpu_torch.models import yolov8
from manual_yolo_tpu_torch.models.classifier import RankClassifier
from manual_yolo_tpu_torch.runtime.pipeline import FusedPipeline
from manual_yolo_tpu_torch.runtime.png import read_png

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def imread_bgr(path: str) -> np.ndarray:
    """Read an image file as (H, W, 3) uint8 BGR, as ``cv2.imread`` returns it."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"cannot read image: {path}")
    return np.ascontiguousarray(read_png(path)[..., ::-1])


def process_screenshot(
    pipeline: FusedPipeline,
    image_path: str,
    output_json: str = "poker_result.json",
    output_image: Optional[str] = None,
    ocr=None,
    accumulate: bool = False,
    use_llm_fallback: bool = False,
) -> Dict:
    """Run the single-shot pipeline on an image file; returns the result dict.

    ``accumulate=True`` merges newly-read fields into the existing output
    JSON fill-don't-overwrite."""
    if output_image:
        raise NotImplementedError("the annotated output image is not ported yet")
    if ocr is not None or use_llm_fallback:
        raise NotImplementedError("OCR and the vision-LLM fallback are not ported yet")

    dets = pipeline.process_frame(imread_bgr(image_path))

    card_ranks: Dict[str, str] = {}
    card_suits: Dict[str, str] = {}
    community: Dict[str, str] = {}
    buttons: List[Dict] = []

    for d in dets:
        name = d["class_name"]
        x1, y1, x2, y2 = d["bbox"]
        text = d.get("ocr_text") or ""

        if "_rank" in name and text:
            card_ranks[name] = text
        elif "_suite_" in name:
            # class name encodes the suit; store under the matching rank key
            card_suits[name.split("_suite_")[0] + "_rank"] = suit_char(name)
        elif text:
            card_ranks[name] = text

        if name.startswith(("flop", "turn", "river")) and "_rank" in name and text:
            community[name] = text + card_suits.get(name, "")

        if name.startswith("button_"):
            buttons.append(
                {"button": name, "center": [(x1 + x2) // 2, (y1 + y2) // 2]}
            )

    result = schema.build_flat_result(card_ranks, card_suits, community, buttons)
    if accumulate and os.path.exists(output_json):
        try:
            with open(output_json, encoding="utf-8") as f:
                existing = json.load(f)
        except (OSError, json.JSONDecodeError):
            existing = {}
        result, _changes = merge_detected_values(existing, result)
    schema.write_json_atomic(os.path.abspath(output_json), result)
    return result


def load_fused_pipeline(
    detector_weights: str,
    classifier_weights: str,
    imgsz: int = 640,
    conf: float = 0.25,
    iou: float = 0.7,
    compute_dtype: str = "bfloat16",
    device: Union[str, torch.device] = "cuda",
) -> FusedPipeline:
    """Build the pipeline from native ``.npz`` weights on ``device``.

    The detector runs in ``compute_dtype``; the classifier always in f32."""
    dev = resolve_device(device)
    det_params, det_meta = load_params(detector_weights)
    sp = det_meta.get("spec", {})
    det_spec = yolov8.build_spec("detect", sp.get("scale", "n"), int(sp.get("nc", 64)))
    det_model = yolov8.build_model(det_spec, _DTYPES[compute_dtype])
    yolov8.load_jax_params(det_model, yolov8.fold_params(det_params, det_spec))
    names = {int(k): v for k, v in det_meta.get("names", {}).items()} or taxonomy.CLASSES

    clf = RankClassifier.from_npz(classifier_weights, device=dev)
    return FusedPipeline(
        det_model=det_model.to(dev).eval(),
        cls_model=clf.model,
        names=names,
        rank_names=clf.names,
        device=dev,
        imgsz=imgsz,
        conf=conf,
        iou=iou,
    )
