"""DeepSORT-style tracker (host-side) with optional appearance features.

Equivalent of the ``deep_sort_realtime`` tracker used by the reference's
hand-session pipeline (``pipe.py:161-162``) with the same lifecycle
parameters: ``max_age=6``, ``n_init=1``, ``max_cosine_distance=0.25``,
``nn_budget=100`` (``pipe.py:48-51``).

Appearance embeddings are OPTIONAL and pluggable: pass an ``embedder``
callable (crops -> (N, D) unit vectors). The TPU-native embedder in
runtime/embedder.py batches all crops through the classifier backbone in one
device call; without one the tracker degrades to motion+IoU (which is what
the poker UI actually needs — elements don't cross paths).

Track API mirrors what pipe.py consumes: ``update_tracks`` returns confirmed
tracks with ``track_id``, ``to_ltrb()`` and ``det_class``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from manual_yolo_tpu_torch.track.bytetrack import _iou_matrix, _linear_assignment
from manual_yolo_tpu_torch.track.kalman import (
    KalmanBoxFilter,
    cxcyah_to_xyxy,
    xyxy_to_cxcyah,
)

_KF = KalmanBoxFilter()


@dataclass
class Track:
    track_id: int
    mean: np.ndarray
    cov: np.ndarray
    det_class: str
    conf: float
    n_init: int
    hits: int = 1
    age: int = 0
    time_since_update: int = 0
    features: List[np.ndarray] = field(default_factory=list)
    nn_budget: int = 100

    def is_confirmed(self) -> bool:
        return self.hits >= self.n_init

    def to_ltrb(self) -> np.ndarray:
        return cxcyah_to_xyxy(self.mean)

    def predict(self):
        self.mean, self.cov = _KF.predict(self.mean, self.cov)
        self.age += 1
        self.time_since_update += 1

    def update(self, box, conf, det_class, feature=None):
        self.mean, self.cov = _KF.update(self.mean, self.cov, xyxy_to_cxcyah(box))
        self.conf = conf
        self.det_class = det_class
        self.hits += 1
        self.time_since_update = 0
        if feature is not None:
            self.features.append(feature)
            if len(self.features) > self.nn_budget:
                self.features.pop(0)


class DeepSortTracker:
    def __init__(
        self,
        max_age: int = 6,
        n_init: int = 1,
        max_cosine_distance: float = 0.25,
        nn_budget: int = 100,
        max_iou_distance: float = 0.7,
        embedder: Optional[Callable] = None,
    ):
        self.max_age = max_age
        self.n_init = n_init
        self.max_cos = max_cosine_distance
        self.nn_budget = nn_budget
        self.max_iou = max_iou_distance
        self.embedder = embedder
        self.tracks: List[Track] = []
        self._next_id = 1

    def _cosine_cost(self, tracks: Sequence[Track], feats: np.ndarray) -> np.ndarray:
        cost = np.ones((len(tracks), len(feats)), np.float32)
        for i, t in enumerate(tracks):
            if not t.features:
                continue
            gallery = np.stack(t.features)
            sim = gallery @ feats.T  # unit vectors -> cosine similarity
            cost[i] = 1.0 - sim.max(axis=0)
        return cost

    def update_tracks(
        self, detections: Sequence[tuple], frame: Optional[np.ndarray] = None
    ) -> List[Track]:
        """detections: list of ([x1,y1,x2,y2] or (bbox, conf, class)) like
        deep-sort-realtime's input (``pipe.py:197-202``)."""
        boxes, confs, classes = [], [], []
        for d in detections:
            bbox, conf, cls = d
            boxes.append(np.asarray(bbox, np.float32))
            confs.append(float(conf))
            classes.append(cls)
        boxes = np.array(boxes, np.float32).reshape(-1, 4)

        feats = None
        if self.embedder is not None and frame is not None and len(boxes):
            crops = []
            H, W = frame.shape[:2]
            for b in boxes:
                x1, y1, x2, y2 = (int(v) for v in b)
                x1, y1 = max(0, x1), max(0, y1)
                x2, y2 = min(W, max(x2, x1 + 1)), min(H, max(y2, y1 + 1))
                crops.append(frame[y1:y2, x1:x2])
            feats = np.asarray(self.embedder(crops), np.float32)

        for t in self.tracks:
            t.predict()

        confirmed = [t for t in self.tracks if t.is_confirmed()]
        tentative = [t for t in self.tracks if not t.is_confirmed()]

        # appearance-gated matching for confirmed tracks (falls back to IoU)
        det_idx = list(range(len(boxes)))
        matches: List[tuple] = []
        if confirmed and det_idx:
            if feats is not None:
                cost = self._cosine_cost(confirmed, feats)
                gate = 1.0 - _iou_matrix(
                    np.stack([t.to_ltrb() for t in confirmed]), boxes
                )
                cost = np.where(gate > 0.9999, 1.0, cost)  # no-overlap gating
                m, ut, ud = _linear_assignment(cost, self.max_cos)
            else:
                cost = 1.0 - _iou_matrix(
                    np.stack([t.to_ltrb() for t in confirmed]), boxes
                )
                m, ut, ud = _linear_assignment(cost, self.max_iou)
            matches = [(confirmed[r], c) for r, c in m]
            rem_tracks = [confirmed[i] for i in ut]
            det_idx = ud
        else:
            rem_tracks = list(confirmed)

        # IoU matching for tentative + unmatched confirmed tracks
        pool = tentative + rem_tracks
        if pool and det_idx:
            cost = 1.0 - _iou_matrix(
                np.stack([t.to_ltrb() for t in pool]), boxes[det_idx]
            )
            m, ut, ud = _linear_assignment(cost, self.max_iou)
            matches += [(pool[r], det_idx[c]) for r, c in m]
            det_idx = [det_idx[i] for i in ud]

        for t, di in matches:
            t.update(
                boxes[di], confs[di], classes[di],
                feats[di] if feats is not None else None,
            )

        # age out
        self.tracks = [t for t in self.tracks if t.time_since_update <= self.max_age]

        # new tracks
        for di in det_idx:
            mean, cov = _KF.initiate(xyxy_to_cxcyah(boxes[di]))
            t = Track(
                self._next_id, mean, cov, classes[di], confs[di],
                n_init=self.n_init, nn_budget=self.nn_budget,
            )
            if feats is not None:
                t.features.append(feats[di])
            self._next_id += 1
            self.tracks.append(t)

        return [t for t in self.tracks if t.is_confirmed() and t.time_since_update == 0]
