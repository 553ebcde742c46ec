"""ByteTrack-style multi-object tracker (host-side).

Equivalent of the supervision ``ByteTrack`` the reference uses
(``detect.py:22,561``): two-stage association — high-confidence detections
matched first by IoU, remaining tracks matched against low-confidence
detections — with Kalman motion prediction and a lost-track buffer.
Defaults mirror supervision's (activation 0.25, lost buffer 30 frames,
matching IoU 0.8 -> cost 0.2).

API: ``update(detections) -> detections-with-tracker_id`` where detections
is the host dict-list produced by ``DetectorEngine.detect_to_list``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from manual_yolo_tpu_torch.track.kalman import (
    KalmanBoxFilter,
    cxcyah_to_xyxy,
    xyxy_to_cxcyah,
)

_KF = KalmanBoxFilter()


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-9)


def _linear_assignment(cost: np.ndarray, thresh: float):
    """Hungarian matching with gating; returns (matches, unmatched_a, unmatched_b)."""
    if cost.size == 0:
        return [], list(range(cost.shape[0])), list(range(cost.shape[1]))
    from scipy.optimize import linear_sum_assignment

    rows, cols = linear_sum_assignment(cost)
    matches, ua, ub = [], set(range(cost.shape[0])), set(range(cost.shape[1]))
    for r, c in zip(rows, cols):
        if cost[r, c] <= thresh:
            matches.append((r, c))
            ua.discard(r)
            ub.discard(c)
    return matches, sorted(ua), sorted(ub)


@dataclass
class _Track:
    track_id: int
    mean: np.ndarray
    cov: np.ndarray
    class_id: int
    conf: float
    state: str = "tracked"  # tracked | lost
    frames_lost: int = 0
    hits: int = 1

    @property
    def xyxy(self) -> np.ndarray:
        return cxcyah_to_xyxy(self.mean)

    def predict(self):
        self.mean, self.cov = _KF.predict(self.mean, self.cov)

    def update(self, box_xyxy: np.ndarray, conf: float, class_id: int):
        self.mean, self.cov = _KF.update(self.mean, self.cov, xyxy_to_cxcyah(box_xyxy))
        self.conf = conf
        self.class_id = class_id
        self.state = "tracked"
        self.frames_lost = 0
        self.hits += 1


class ByteTrack:
    def __init__(
        self,
        track_activation_threshold: float = 0.25,
        lost_track_buffer: int = 30,
        minimum_matching_threshold: float = 0.8,
        low_conf_threshold: float = 0.1,
    ):
        self.high_thresh = track_activation_threshold
        self.low_thresh = low_conf_threshold
        self.max_lost = lost_track_buffer
        self.match_thresh = minimum_matching_threshold
        self.tracks: List[_Track] = []
        self._next_id = 1

    def reset(self):
        self.tracks = []
        self._next_id = 1

    def update(self, detections: List[Dict]) -> List[Dict]:
        """detections: dicts with x1/y1/x2/y2/conf/class_id; returns the same
        dicts (copied) with 'tracker_id' filled for matched/new tracks."""
        boxes = np.array(
            [[d["x1"], d["y1"], d["x2"], d["y2"]] for d in detections], np.float32
        ).reshape(-1, 4)
        confs = np.array([d.get("conf", 1.0) for d in detections], np.float32)
        high_idx = [i for i, c in enumerate(confs) if c >= self.high_thresh]
        low_idx = [
            i for i, c in enumerate(confs) if self.low_thresh <= c < self.high_thresh
        ]

        for t in self.tracks:
            t.predict()

        out = [dict(d, tracker_id=-1) for d in detections]

        # stage 1: active tracks vs high-confidence detections
        active = [t for t in self.tracks if t.state == "tracked"]
        lost = [t for t in self.tracks if t.state == "lost"]
        tboxes = np.array([t.xyxy for t in active], np.float32).reshape(-1, 4)
        cost = 1.0 - _iou_matrix(tboxes, boxes[high_idx])
        matches, un_tracks, un_dets = _linear_assignment(cost, 1 - (1 - self.match_thresh))
        for r, c in matches:
            di = high_idx[c]
            active[r].update(boxes[di], float(confs[di]), int(detections[di]["class_id"]))
            out[di]["tracker_id"] = active[r].track_id

        # stage 2: unmatched active tracks vs low-confidence detections
        rem_tracks = [active[i] for i in un_tracks]
        tboxes2 = np.array([t.xyxy for t in rem_tracks], np.float32).reshape(-1, 4)
        cost2 = 1.0 - _iou_matrix(tboxes2, boxes[low_idx])
        matches2, un_tracks2, _ = _linear_assignment(cost2, 0.5)
        for r, c in matches2:
            di = low_idx[c]
            rem_tracks[r].update(boxes[di], float(confs[di]), int(detections[di]["class_id"]))
            out[di]["tracker_id"] = rem_tracks[r].track_id

        # stage 3: lost tracks vs remaining high-confidence detections
        rem_dets = [high_idx[i] for i in un_dets]
        lboxes = np.array([t.xyxy for t in lost], np.float32).reshape(-1, 4)
        cost3 = 1.0 - _iou_matrix(lboxes, boxes[rem_dets])
        matches3, _, un_dets3 = _linear_assignment(cost3, 1 - (1 - self.match_thresh))
        for r, c in matches3:
            di = rem_dets[c]
            lost[r].update(boxes[di], float(confs[di]), int(detections[di]["class_id"]))
            out[di]["tracker_id"] = lost[r].track_id

        # mark unmatched active tracks lost; age out stale lost tracks
        for i in un_tracks2:
            rem_tracks[i].state = "lost"
        for t in self.tracks:
            if t.state == "lost":
                t.frames_lost += 1
        self.tracks = [t for t in self.tracks if t.frames_lost <= self.max_lost]

        # new tracks from remaining high-confidence detections
        for c in un_dets3:
            di = rem_dets[c]
            mean, cov = _KF.initiate(xyxy_to_cxcyah(boxes[di]))
            t = _Track(
                self._next_id, mean, cov, int(detections[di]["class_id"]),
                float(confs[di]),
            )
            self._next_id += 1
            self.tracks.append(t)
            out[di]["tracker_id"] = t.track_id
        return out
