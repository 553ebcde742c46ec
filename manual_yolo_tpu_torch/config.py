"""Typed configuration — replaces the reference's three UPPERCASE constant
blocks (``detect.py:12-56``, ``pipe.py:33-70``, ``yolo.py:26-59``) with one
dataclass hierarchy, loadable from JSON and overridable from CLI flags.

Copy of ``manual_yolo_tpu/config.py`` for the port, which reads JSON only
(it does not depend on ``yaml``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass
class ScreenRegion:
    """Capture region; reference detect.py:18 / pipe.py:35 / yolo.py:32."""

    top: int = 48
    left: int = 970
    width: int = 930
    height: int = 1130


@dataclass
class DetectorConfig:
    weights: str = "weights/poker_detector.npz"
    imgsz: int = 640
    conf: float = 0.25  # ultralytics default used by detect.py/yolo.py config
    iou: float = 0.7
    max_det: int = 300
    compute_dtype: str = "bfloat16"


@dataclass
class RankClassifierConfig:
    # trained on folder crops + distribution-matched device crops; top-1
    # 0.9552 on the reference valid split (ref best 0.9403, BASELINE.md) and
    # 0.9552 on pipeline-matched crops (runs_tpu/rank_classifier_matched)
    weights: str = "weights/rank_classifier_matched.npz"
    conf_threshold: float = 0.40  # detect.py:131
    turn_river_threshold: float = 0.20  # detect.py:129
    crop_pad: int = 6  # safe_crop pad, detect.py:586


@dataclass
class OCRConfig:
    enabled: bool = True
    min_confidence: float = 0.35  # detect.py:189
    turn_river_min_confidence: float = 0.15  # detect.py:187
    recognizer_weights: str = ""  # optional CRNN weights (.pth import or .npz)
    detector_weights: str = ""  # optional CRAFT weights


@dataclass
class PipeConfig:
    """Hand-session pipeline knobs (reference pipe.py:33-70)."""

    input_fps: int = 6
    yolo_imgsz: int = 1280
    yolo_conf: float = 0.35
    tile: int = 640
    tile_overlap: float = 0.2
    deepsort_max_age: int = 6
    deepsort_n_init: int = 1
    deepsort_max_cosine_distance: float = 0.25
    deepsort_nn_budget: int = 100
    hand_timeout: float = 6.0
    output_folder: str = "hand_outputs"


@dataclass
class TrackConfig:
    """Appearance-embedder selection for DeepSORT-style tracking.

    The reference's deep-sort-realtime ships a purpose-trained appearance
    net (pipe.py:48-51, default ``embedder='mobilenet'``); ours is the
    metric-learned re-id checkpoint from ``train/embedder.py``. Kept
    SEPARATE from ``rank.weights`` so selecting the re-id embedder cannot
    also swap the rank classifier (advisor r3, medium)."""

    # empty -> auto: weights/reid_embedder.npz when present, else fall back
    # to the rank-classifier backbone features
    embedder_weights: str = ""


@dataclass
class LiveConfig:
    """Live detect loop knobs (reference detect.py:12-56)."""

    output_folder: str = "live_output"
    screenshot_interval: float = 0.5
    game_update_interval: float = 0.5
    show_window: bool = False


@dataclass
class ParallelConfig:
    """Device-mesh layout for multi-chip serving/training."""

    data_parallel: int = -1  # -1: all devices
    mesh_axis_name: str = "data"


@dataclass
class AppConfig:
    region: ScreenRegion = field(default_factory=ScreenRegion)
    detector: DetectorConfig = field(default_factory=DetectorConfig)
    rank: RankClassifierConfig = field(default_factory=RankClassifierConfig)
    ocr: OCRConfig = field(default_factory=OCRConfig)
    pipe: PipeConfig = field(default_factory=PipeConfig)
    track: TrackConfig = field(default_factory=TrackConfig)
    live: LiveConfig = field(default_factory=LiveConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    @classmethod
    def load(cls, path: Optional[str] = None, **overrides) -> "AppConfig":
        cfg = cls()
        if path and os.path.exists(path):
            if path.endswith((".yaml", ".yml")):
                raise ValueError(f"{path}: the port reads JSON config files only")
            with open(path) as f:
                data = json.load(f)
            cfg = _merge(cfg, data)
        if overrides:
            cfg = _merge(cfg, overrides)
        return cfg

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _merge(cfg, data: Dict[str, Any]):
    for k, v in data.items():
        if not hasattr(cfg, k):
            continue
        cur = getattr(cfg, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            setattr(cfg, k, _merge(cur, v))
        else:
            setattr(cfg, k, v)
    return cfg
