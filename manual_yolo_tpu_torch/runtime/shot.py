"""Single-screenshot pipeline: image file in -> flat result JSON out.

Counterpart of ``manual_yolo_tpu/runtime/shot.py`` (``process_screenshot``,
``load_fused_pipeline``, ``llm_should_escalate``). The image, PNG or JPEG,
is read by the port's own readers (``runtime/png.py::imread_bgr``) instead
of ``cv2.imread``. Rank
fields are read by the batched rank classifier inside ``FusedPipeline``;
every OCR-class field it leaves empty (stacks, bets, pot, names, game_id, and
ranks below the classifier's gate) is read by the OCR engine when one is
given (``runtime/ocr.py``).

Not ported yet: the annotated output image (it needs OpenCV's text
rendering) and the vision-LLM fallback. Asking for either raises
``NotImplementedError``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from manual_yolo_tpu_torch.core.device import resolve_device
from manual_yolo_tpu_torch.game import schema, taxonomy
from manual_yolo_tpu_torch.game.accumulate import merge_detected_values
from manual_yolo_tpu_torch.game.text import suit_char
from manual_yolo_tpu_torch.models.classifier import RankClassifier
from manual_yolo_tpu_torch.runtime.engine import load_detector
from manual_yolo_tpu_torch.runtime.ocr import OCREngine, field_kind
from manual_yolo_tpu_torch.runtime.pipeline import FusedPipeline
from manual_yolo_tpu_torch.runtime.png import imread_bgr


def _safe_crop(frame: np.ndarray, bbox: List[int]) -> np.ndarray:
    x1, y1, x2, y2 = bbox
    return frame[max(0, y1) : max(y1 + 1, y2), max(0, x1) : max(x1 + 1, x2)]


def llm_should_escalate(d: Dict) -> bool:
    """The cascade's per-field failure gate: escalate when the local read is
    empty, or when its confidence (as ``OCREngine.read_fields_conf`` records
    it, collapse-demoted) falls below the kind's ``OCREngine.LLM_GATE``."""
    if not d.get("ocr_text"):
        return True
    conf = d.get("ocr_conf")
    if conf is None or conf < 0:
        return False  # no confidence signal (e.g. classifier rank path)
    gate = OCREngine.LLM_GATE.get(field_kind(d["class_name"]), 0.0)
    return conf < gate


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

    ``ocr`` reads the OCR-class fields the pipeline left empty: an object with
    ``read_fields_conf`` (an ``OCREngine``) or ``read_fields``, or a
    ``(crop_bgr, class_name) -> text`` callable. ``accumulate=True`` merges
    newly-read fields into the existing output JSON fill-don't-overwrite.
    ``output_image`` and ``use_llm_fallback=True`` raise
    ``NotImplementedError``: the annotated image and the vision-LLM fallback
    are not ported."""
    if output_image:
        raise NotImplementedError("the annotated output image is not ported yet")
    if use_llm_fallback:
        raise NotImplementedError("the vision-LLM fallback is not ported yet")

    frame = imread_bgr(image_path)
    dets = pipeline.process_frame(frame)

    # pass 1: OCR every text field the pipeline left empty (rank classes
    # included: a classifier read below its gate falls through)
    if ocr is not None:
        todo = [
            d for d in dets
            if not d.get("ocr_text") and d["class_name"] in taxonomy.OCR_CLASSES
        ]
        read_fields_conf = getattr(ocr, "read_fields_conf", None)
        read_fields = getattr(ocr, "read_fields", None)
        if todo and read_fields_conf is not None:
            pairs = read_fields_conf(
                [_safe_crop(frame, d["bbox"]) for d in todo],
                [d["class_name"] for d in todo],
            )
            for d, (t, c) in zip(todo, pairs):
                d["ocr_text"] = t or ""
                d["ocr_conf"] = round(float(c), 3)
        elif todo and read_fields is not None:
            texts = read_fields(
                [_safe_crop(frame, d["bbox"]) for d in todo],
                [d["class_name"] for d in todo],
            )
            for d, t in zip(todo, texts):
                d["ocr_text"] = t or ""
        else:
            for d in todo:
                d["ocr_text"] = ocr(_safe_crop(frame, d["bbox"]), d["class_name"]) or ""

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
            # non-rank field values (stack/bet/pot/name/game_id)
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
    """Build the pipeline on ``device`` from a native ``.npz`` detector and a
    native ``.npz`` or ultralytics ``.pt`` classifier.

    The detector runs in ``compute_dtype`` ("bfloat16" or "float32"; any
    other value raises ``ValueError``); the classifier always in f32."""
    det_model, names = load_detector(detector_weights, compute_dtype)
    dev = resolve_device(device)
    clf = RankClassifier.load(classifier_weights, device=dev)
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
