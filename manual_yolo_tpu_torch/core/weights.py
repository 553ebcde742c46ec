"""Weight layout helpers (host numpy).

Counterpart of ``manual_yolo_tpu/core/weights.py:197-219``. The checkpoints
store conv kernels in the JAX layout (HWIO); the port's convs take OIHW.
"""

from __future__ import annotations

import numpy as np


def conv_oihw_to_hwio(w: np.ndarray) -> np.ndarray:
    """torch conv weight (O, I, kH, kW) -> JAX NHWC conv weight (kH, kW, I, O)."""
    return np.transpose(w, (2, 3, 1, 0))


def conv_hwio_to_oihw(w: np.ndarray) -> np.ndarray:
    """JAX conv weight (kH, kW, I, O) -> torch conv weight (O, I, kH, kW)."""
    return np.transpose(w, (3, 2, 0, 1))


def fold_batchnorm(
    conv_w_oihw: np.ndarray,
    gamma: np.ndarray,
    beta: np.ndarray,
    mean: np.ndarray,
    var: np.ndarray,
    eps: float = 1e-3,
):
    """Fold inference-mode BatchNorm into the preceding conv.

    ultralytics ``Conv`` uses ``BatchNorm2d(c2, eps=0.001)``; folding is exact
    for inference: w' = w * g/sqrt(v+eps), b' = b - g*m/sqrt(v+eps).
    Returns (HWIO weight, per-channel bias), as the JAX package does.
    """
    scale = gamma / np.sqrt(var + eps)
    w = conv_w_oihw * scale[:, None, None, None]
    b = beta - mean * scale
    return conv_oihw_to_hwio(w).astype(np.float32), b.astype(np.float32)
