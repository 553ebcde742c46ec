"""Hand-session pipeline — the reference ``pipe.py``.

Counterpart of ``manual_yolo_tpu/runtime/hands.py``. Per step: detect at
imgsz 1280 / conf 0.35; if fewer than 6 detections OR small-object-hint
classes are present, detect again on 640-px tiles at 20% overlap — all
tiles as ONE batch through ``DetectorEngine.detect_batch`` (one forward,
one NMS-kernel launch), merged with a global NMS on the host — and the tiles'
detections replace the full frame's when there are any; DeepSORT update;
per-track majority class vote over a 7-deep history with averaged bboxes;
button/input-field extraction; game-id OCR; hand finalisation on game-id
change or 6 s of button inactivity.

The debug window (``run(show=True)``) needs OpenCV and is not ported: it
raises ``NotImplementedError`` before the first frame.
"""

from __future__ import annotations

import os
import time
from collections import Counter, defaultdict, deque
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from manual_yolo_tpu_torch.game import schema, taxonomy
from manual_yolo_tpu_torch.parallel.inference import merge_tile_detections, tiled_frames
from manual_yolo_tpu_torch.runtime.engine import DetectorEngine
from manual_yolo_tpu_torch.track.deepsort import DeepSortTracker
from manual_yolo_tpu_torch.utils.profiling import StageTimer


def avg_bbox(history: deque) -> Tuple[int, int, int, int]:
    if not history:
        return (0, 0, 0, 0)
    arr = np.asarray(history, np.float64)
    return tuple(int(v) for v in arr.mean(axis=0))


@dataclass
class HandSessionPipeline:
    engine: DetectorEngine
    output_dir: str = "hand_outputs"
    hand_timeout: float = 6.0
    tile: int = 640
    tile_overlap: float = 0.2
    min_dets_before_tiling: int = 6
    ocr: Optional[object] = None  # OCREngine.read_field-compatible
    tracker: DeepSortTracker = field(
        default_factory=lambda: DeepSortTracker(
            max_age=6, n_init=1, max_cosine_distance=0.25, nn_budget=100
        )
    )
    # per-stage rolling wall times (detect/track/ocr); --stats in cli.pipe
    timer: StageTimer = field(default_factory=StageTimer)

    def __post_init__(self):
        os.makedirs(self.output_dir, exist_ok=True)
        self.track_history = defaultdict(
            lambda: {"class_votes": deque(maxlen=7), "bboxes": deque(maxlen=7),
                     "last_seen_ts": 0.0}
        )
        self.hand_index = 0
        self.hand_start_ts: Optional[float] = None
        self.last_button_seen_ts: Optional[float] = None
        self.last_game_id: Optional[str] = None

    # ------------------------------------------------------------------
    def _detect(self, frame: np.ndarray) -> List[Dict]:
        dets = self.engine.detect_to_list(frame)
        need_tiles = len(dets) < self.min_dets_before_tiling or any(
            d["class_name"] in taxonomy.SMALL_OBJ_HINT_CLASSES for d in dets
        )
        if need_tiles:
            tiled = self._detect_tiled(frame)
            if tiled:
                dets = tiled  # tiles are more sensitive; replace (pipe.py:299-300)
        return dets

    def _detect_tiled(self, frame: np.ndarray) -> List[Dict]:
        tiles, offsets = tiled_frames(frame, self.tile, self.tile_overlap)
        det = self.engine.detect_batch(tiles)
        merged = merge_tile_detections(
            det, offsets, conf_thres=self.engine.conf, iou_thres=self.engine.iou
        )
        out = []
        h, w = frame.shape[:2]
        for box, score, cid in zip(merged["boxes"], merged["scores"], merged["classes"]):
            out.append(
                {
                    "x1": max(0, int(box[0])), "y1": max(0, int(box[1])),
                    "x2": min(w - 1, int(box[2])), "y2": min(h - 1, int(box[3])),
                    "conf": float(score), "class_id": int(cid),
                    "class_name": self.engine.names.get(int(cid), f"class{int(cid)}"),
                }
            )
        return out

    def _update_tracks(self, frame, dets: List[Dict], ts: float) -> List[Dict]:
        ds_in = [
            ([d["x1"], d["y1"], d["x2"], d["y2"]], d["conf"], d["class_name"])
            for d in dets
        ]
        tracks = self.tracker.update_tracks(ds_in, frame=frame)
        active = []
        for tr in tracks:
            tid = tr.track_id
            ltrb = tr.to_ltrb()
            h = self.track_history[tid]
            h["class_votes"].append(tr.det_class)
            h["bboxes"].append(tuple(int(v) for v in ltrb))
            h["last_seen_ts"] = ts
            active.append({"track_id": tid, "class": tr.det_class, "bbox": h["bboxes"][-1]})
        stale = [t for t, h in self.track_history.items() if ts - h["last_seen_ts"] > 30]
        for t in stale:
            del self.track_history[t]
        return active

    def _buttons_and_input(self, active: List[Dict]):
        buttons, input_area = [], None
        for t in active:
            tid = t["track_id"]
            votes = list(self.track_history[tid]["class_votes"])
            label = Counter(votes).most_common(1)[0][0] if votes else t["class"]
            a = avg_bbox(self.track_history[tid]["bboxes"])
            entry = {
                "track_id": tid, "class": label,
                "bbox": {"x1": a[0], "y1": a[1], "x2": a[2], "y2": a[3]},
            }
            if label.startswith(taxonomy.BUTTON_CLASS_PREFIX):
                buttons.append(entry)
                self.last_button_seen_ts = time.time()
                if self.hand_start_ts is None:
                    self.hand_start_ts = time.time()
            elif label == taxonomy.INPUT_FIELD_CLASS:
                input_area = entry
        return buttons, input_area

    def finalize_hand(self, buttons, input_area) -> str:
        self.hand_index += 1
        record = schema.build_hand_record(
            self.hand_index, buttons, input_area, self.hand_start_ts
        )
        fname = os.path.join(
            self.output_dir, f"hand_{self.hand_index}_{int(time.time())}.json"
        )
        schema.write_json_atomic(fname, record)
        self.hand_start_ts = None
        self.last_button_seen_ts = None
        return fname

    def step(self, frame: np.ndarray) -> Dict:
        ts = time.time()
        with self.timer.stage("detect"):
            dets = self._detect(frame)
        with self.timer.stage("track"):
            active = self._update_tracks(frame, dets, ts)
        buttons, input_area = self._buttons_and_input(active)

        # game-id OCR + change detection (pipe.py:309-328)
        if self.ocr is not None:
            with self.timer.stage("ocr"):
                for d in dets:
                    if d["class_name"] != taxonomy.GAME_ID_CLASS:
                        continue
                    crop = frame[d["y1"] : d["y2"], d["x1"] : d["x2"]]
                    gid = self.ocr(crop, taxonomy.GAME_ID_CLASS)
                    if gid:
                        if self.last_game_id is None:
                            self.last_game_id = gid
                        elif gid != self.last_game_id:
                            self.finalize_hand(buttons, input_area)
                            self.last_game_id = gid

        if (
            self.hand_start_ts
            and self.last_button_seen_ts
            and time.time() - self.last_button_seen_ts > self.hand_timeout
        ):
            self.finalize_hand(buttons, input_area)

        return {"active": active, "buttons": buttons, "input": input_area,
                "detections": dets}

    def run(self, source: Iterator[np.ndarray], fps: int = 6,
            max_frames: Optional[int] = None, show: bool = False):
        if show:
            raise NotImplementedError("the debug window needs a display; not ported yet")
        interval = 1.0 / max(1, fps)
        last = 0.0
        n = 0
        for frame in source:
            now = time.time()
            if now - last < interval:
                time.sleep(interval - (now - last))
            last = time.time()
            info = self.step(frame)
            print(
                f"hand#{self.hand_index} active:{len(info['active'])} "
                f"buttons:{len(info['buttons'])}"
            )
            n += 1
            if max_frames is not None and n >= max_frames:
                break
