"""Constant-velocity Kalman filter over box state (cx, cy, aspect, h).

Host-side sequential math (trackers are inherently serial state machines —
SURVEY.md §2b routes them host-side). Standard 8-dim state used by both the
ByteTrack- and DeepSORT-style trackers.
"""

from __future__ import annotations

import numpy as np

_STD_WEIGHT_POS = 1.0 / 20
_STD_WEIGHT_VEL = 1.0 / 160


class KalmanBoxFilter:
    def __init__(self):
        self._F = np.eye(8)
        for i in range(4):
            self._F[i, i + 4] = 1.0
        self._H = np.eye(4, 8)

    def initiate(self, measurement: np.ndarray):
        """measurement: (4,) [cx, cy, a, h] -> (mean (8,), cov (8,8))."""
        mean = np.zeros(8)
        mean[:4] = measurement
        h = measurement[3]
        std = [
            2 * _STD_WEIGHT_POS * h, 2 * _STD_WEIGHT_POS * h, 1e-2, 2 * _STD_WEIGHT_POS * h,
            10 * _STD_WEIGHT_VEL * h, 10 * _STD_WEIGHT_VEL * h, 1e-5, 10 * _STD_WEIGHT_VEL * h,
        ]
        cov = np.diag(np.square(std))
        return mean, cov

    def predict(self, mean, cov):
        h = mean[3]
        q = np.diag(
            np.square(
                [
                    _STD_WEIGHT_POS * h, _STD_WEIGHT_POS * h, 1e-2, _STD_WEIGHT_POS * h,
                    _STD_WEIGHT_VEL * h, _STD_WEIGHT_VEL * h, 1e-5, _STD_WEIGHT_VEL * h,
                ]
            )
        )
        mean = self._F @ mean
        cov = self._F @ cov @ self._F.T + q
        return mean, cov

    def update(self, mean, cov, measurement):
        h = mean[3]
        r = np.diag(
            np.square([_STD_WEIGHT_POS * h, _STD_WEIGHT_POS * h, 1e-1, _STD_WEIGHT_POS * h])
        )
        s = self._H @ cov @ self._H.T + r
        k = cov @ self._H.T @ np.linalg.inv(s)
        innovation = measurement - self._H @ mean
        mean = mean + k @ innovation
        cov = (np.eye(8) - k @ self._H) @ cov
        return mean, cov


def xyxy_to_cxcyah(b: np.ndarray) -> np.ndarray:
    w = b[2] - b[0]
    h = b[3] - b[1]
    return np.array([b[0] + w / 2, b[1] + h / 2, w / max(h, 1e-6), h])


def cxcyah_to_xyxy(m: np.ndarray) -> np.ndarray:
    cx, cy, a, h = m[:4]
    w = a * h
    return np.array([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2])
