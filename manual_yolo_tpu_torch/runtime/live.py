"""Live detection loop — the reference ``detect.py`` main loop.

Counterpart of ``manual_yolo_tpu/runtime/live.py``. Per frame: detect and
rank-classify (``FusedPipeline``, on its device) -> OCR of the text fields
left empty (one ``read_fields`` call) -> ByteTrack -> game-state update ->
periodic game JSON -> one row appended to ``detections.jsonl``.

Per-field OCR errors and tracking errors are printed and the frame goes on,
as in the JAX package; the loop counts them in ``errors``. With
``save_screenshots`` the frame is written, at most once every
``screenshot_interval`` seconds, as ``screenshot_frame_{n}_{int(now)}.jpg``
in ``output_dir`` (``runtime/jpeg.py::write_jpeg`` at quality 95: the bytes
of the JAX package's ``cv2.imwrite``). The display window needs a display
and OpenCV's GUI and is not ported: ``show_window=True`` raises
``NotImplementedError`` when the loop is built.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional

import numpy as np

from manual_yolo_tpu_torch.game import taxonomy
from manual_yolo_tpu_torch.game.state import GameTracker
from manual_yolo_tpu_torch.runtime.jpeg import write_jpeg
from manual_yolo_tpu_torch.runtime.pipeline import FusedPipeline
from manual_yolo_tpu_torch.track.bytetrack import ByteTrack
from manual_yolo_tpu_torch.utils.profiling import StageTimer


@dataclass
class LiveLoop:
    pipeline: FusedPipeline
    output_dir: str = "live_output"
    game_update_interval: float = 0.5
    screenshot_interval: float = 0.5
    save_screenshots: bool = False
    show_window: bool = False
    ocr: Optional[object] = None  # OCREngine.read_field-compatible callable
    tracker: ByteTrack = field(default_factory=ByteTrack)
    # per-stage rolling wall times (infer/ocr/track/persist)
    timer: StageTimer = field(default_factory=StageTimer)

    def __post_init__(self):
        if self.show_window:
            raise NotImplementedError("show_window needs a display window; not ported")
        os.makedirs(self.output_dir, exist_ok=True)
        self.game = GameTracker(output_dir=self.output_dir)
        self._jsonl = open(
            os.path.join(self.output_dir, "detections.jsonl"), "a", encoding="utf-8"
        )
        self._last_save = 0.0
        self._last_shot = 0.0
        self.frame_count = 0
        self.errors = 0  # caught per-field OCR and tracking errors

    def close(self):
        # final save mirrors reference detect.py:702-706
        cards = self.game.state["hero"]["cards"]
        if cards[0]["rank"] or cards[1]["rank"]:
            self.game.save()
        self._jsonl.close()

    def step(self, frame_bgr: np.ndarray) -> Dict:
        t0 = time.time()
        with self.timer.stage("infer"):
            dets = self.pipeline.process_frame(frame_bgr)

        # OCR for text fields the fused pipeline left empty. Rank classes land
        # here only when the classifier was below threshold (detect.py:242-245).
        # Per-field failures never kill the frame (detect.py:227-229).
        if self.ocr is not None:
            todo = [
                d for d in dets
                if not d["ocr_text"] and d["class_name"] in taxonomy.OCR_CLASSES
            ]
            if todo:
                with self.timer.stage("ocr"):
                    crops = []
                    for d in todo:
                        x1, y1, x2, y2 = d["bbox"]
                        crops.append(
                            frame_bgr[
                                max(0, y1) : max(y1 + 1, y2),
                                max(0, x1) : max(x1 + 1, x2),
                            ]
                        )
                    read_fields = getattr(self.ocr, "read_fields", None)
                    if read_fields is not None:
                        # one recognizer call per field kind instead of one per crop
                        texts = read_fields(crops, [d["class_name"] for d in todo])
                        for d, t in zip(todo, texts):
                            d["ocr_text"] = t or ""
                    else:
                        for d, crop in zip(todo, crops):
                            try:
                                d["ocr_text"] = self.ocr(crop, d["class_name"]) or ""
                            except Exception as e:
                                self.errors += 1
                                print(f"OCR error for {d['class_name']}: {e}")

        # tracking errors degrade to untracked detections (detect.py:560-564)
        try:
            with self.timer.stage("track"):
                tracked = self.tracker.update(
                    [
                        {
                            "x1": d["bbox"][0], "y1": d["bbox"][1],
                            "x2": d["bbox"][2], "y2": d["bbox"][3],
                            "conf": d["conf"], "class_id": d["class_id"],
                        }
                        for d in dets
                    ]
                )
        except Exception as e:
            self.errors += 1
            print(f"Tracking error: {e}")
            tracked = [dict(tracker_id=-1) for _ in dets]
        for d, t in zip(dets, tracked):
            d["tracker_id"] = t["tracker_id"]
            d["frame"] = self.frame_count

        self.game.update(dets)

        now = time.time()
        if now - self._last_save >= self.game_update_interval:
            self.game.save()
            self._last_save = now
        if self.save_screenshots and now - self._last_shot >= self.screenshot_interval:
            write_jpeg(
                os.path.join(
                    self.output_dir,
                    f"screenshot_frame_{self.frame_count}_{int(now)}.jpg",
                ),
                frame_bgr,
            )
            self._last_shot = now

        with self.timer.stage("persist"):
            self._jsonl.write(
                json.dumps(
                    {"frame": self.frame_count, "timestamp": now, "detections": dets}
                )
                + "\n"
            )
            self._jsonl.flush()

        self.frame_count += 1
        return {
            "frame": self.frame_count - 1,
            "detections": dets,
            "game_id": self.game.game_id,
            "fps": 1.0 / max(time.time() - t0, 1e-6),
        }

    def run(self, source: Iterator[np.ndarray], max_frames: Optional[int] = None):
        try:
            for frame in source:
                info = self.step(frame)
                print(
                    f"Frame {info['frame']} | FPS: {info['fps']:.2f} | "
                    f"Detections: {len(info['detections'])} | Game: {info['game_id']}"
                )
                if max_frames is not None and self.frame_count >= max_frames:
                    break
        finally:
            self.close()


def export_detections_array(output_dir: str) -> str:
    """Compat shim: convert detections.jsonl to the reference's single-array
    ``detections.json`` format on demand (instead of rewriting every frame)."""
    src = os.path.join(output_dir, "detections.jsonl")
    dst = os.path.join(output_dir, "detections.json")
    rows = []
    with open(src, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    with open(dst, "w", encoding="utf-8") as f:
        json.dump(rows, f, indent=2)
    return dst
