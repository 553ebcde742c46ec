"""Single-screenshot pipeline: image file in -> flat result JSON and
annotated image out.

Counterpart of ``manual_yolo_tpu/runtime/shot.py`` (``process_screenshot``,
``load_fused_pipeline``, ``llm_should_escalate``, ``_llm_escalate``). The
image, PNG, JPEG or BMP, is read by the port's own readers
(``runtime/png.py::imread_bgr``) instead of ``cv2.imread``. Rank fields are
read by the batched rank classifier inside ``FusedPipeline``; every
OCR-class field it leaves empty (stacks, bets, pot, names, game_id, and
ranks below the classifier's gate) is read by the OCR engine when one is
given (``runtime/ocr.py``); important fields still empty or below the
kind's confidence gate go to the vision-LLM fallback
(``runtime/llm_fallback.py``) when it is on, by default when
``OPENAI_API_KEY`` is set. The annotated image is drawn by
``runtime/draw.py`` (cv2's rectangle and label pixels) and written by
``runtime/png.py::imwrite`` (PNG, JPEG or BMP by the extension).
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
from manual_yolo_tpu_torch.runtime import llm_fallback
from manual_yolo_tpu_torch.runtime.draw import put_text, rectangle
from manual_yolo_tpu_torch.runtime.engine import load_detector
from manual_yolo_tpu_torch.runtime.ocr import OCREngine, field_kind
from manual_yolo_tpu_torch.runtime.pipeline import FusedPipeline
from manual_yolo_tpu_torch.runtime.png import imread_bgr, imwrite


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


def _llm_escalate(frame: np.ndarray, dets: List[Dict]) -> int:
    """Vision-LLM fallback for important fields that local reads left empty
    or read below the kind's confidence gate (reference ``yolo.py:629-747``).

    Builds a labelled collage of the failing crops, queries the LLM once,
    validates each returned value with the OCR engine's per-kind rules, and
    fills the detections in place. Returns the number of fields filled."""
    important = set(llm_fallback.IMPORTANT_KEYS)
    missing = [
        d for d in dets
        if d["class_name"] in taxonomy.OCR_CLASSES
        and d["class_name"] in important
        and llm_should_escalate(d)
    ]
    if not missing:
        return 0
    collage = llm_fallback.build_collage(
        [(d["class_name"], _safe_crop(frame, d["bbox"])) for d in missing]
    )
    if collage is None:
        return 0
    values = llm_fallback.query_vision_llm(collage, [d["class_name"] for d in missing])
    filled = 0
    for d in missing:
        raw = values.get(d["class_name"])
        if not raw:
            continue
        kind = field_kind(d["class_name"])
        text = OCREngine._validate(kind, d["class_name"].lower(), str(raw))
        if text:
            d["ocr_text"] = text
            filled += 1
    return filled


def annotate(frame: np.ndarray, dets: List[Dict]) -> np.ndarray:
    """A copy of ``frame`` with each detection's box (blue, 2 px) and its
    ``class_name:ocr_text`` label (green, scale 0.5) drawn as the JAX
    package draws them with cv2."""
    annotated = frame.copy()
    for d in dets:
        x1, y1, x2, y2 = d["bbox"]
        label = f"{d['class_name']}:{d.get('ocr_text') or ''}"
        rectangle(annotated, (x1, y1), (x2, y2), (255, 0, 0), 2)
        put_text(annotated, label, (x1, max(0, y1 - 5)), 0.5, (0, 255, 0), 1)
    return annotated


def process_screenshot(
    pipeline: FusedPipeline,
    image_path: str,
    output_json: str = "poker_result.json",
    output_image: Optional[str] = "poker_labeled.png",
    ocr=None,
    accumulate: bool = False,
    use_llm_fallback: Optional[bool] = None,
) -> Dict:
    """Run the single-shot pipeline on an image file; returns the result dict.

    ``ocr`` reads the OCR-class fields the pipeline left empty: an object with
    ``read_fields_conf`` (an ``OCREngine``) or ``read_fields``, or a
    ``(crop_bgr, class_name) -> text`` callable. ``use_llm_fallback=None``
    turns the vision-LLM escalation on when ``OPENAI_API_KEY`` is set; the
    query gives nothing offline. ``accumulate=True`` merges newly-read fields
    into the existing output JSON fill-don't-overwrite. ``output_image``
    (``.png``, ``.jpg``/``.jpeg`` or ``.bmp``; ``None`` for none) gets the
    frame with every detection drawn (``annotate``)."""
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

    # pass 2: vision-LLM escalation for important fields still empty or unsure
    if use_llm_fallback is None:
        use_llm_fallback = bool(os.environ.get("OPENAI_API_KEY"))
    if use_llm_fallback:
        _llm_escalate(frame, dets)

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

    if output_image:
        imwrite(output_image, annotate(frame, dets))
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
