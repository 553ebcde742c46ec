"""Batched appearance embedder for DeepSORT-style tracking.

Counterpart of ``manual_yolo_tpu/runtime/embedder.py``. All detection crops
of a frame are resized on the host to a 64x64 canvas (``cv_resize_u8``, bit
for bit ``cv2.resize(..., INTER_LINEAR)``) and pushed through a classifier
backbone in ONE device call; the last feature map, mean-pooled and
L2-normalised in f32, is the appearance vector. The batch is padded to a
power of two (at most ``max_batch``), so the same rows go through the model
as in the JAX package.

Plugs into :class:`manual_yolo_tpu_torch.track.deepsort.DeepSortTracker`
via its ``embedder`` argument (crops -> (N, D) unit vectors).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Union

import numpy as np
import torch

from manual_yolo_tpu_torch.core.device import resolve_device
from manual_yolo_tpu_torch.core.serialization import load_params, resolve_weight_path
from manual_yolo_tpu_torch.models import yolov8
from manual_yolo_tpu_torch.ops.image import cv_resize_u8


class AppearanceEmbedder:
    """crops (variable-size BGR uint8) -> (N, D) float32 unit vectors."""

    def __init__(
        self,
        model: yolov8.YOLOv8Classify,
        size: int = 64,
        max_batch: int = 64,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.size = size
        self.max_batch = max_batch

    @classmethod
    def from_npz(cls, path: str, device: Union[str, torch.device] = "cuda",
                 **kw) -> "AppearanceEmbedder":
        """Build from a native classifier checkpoint (backbone reused), f32."""
        dev = resolve_device(device)
        params, meta = load_params(path)
        sp = meta.get("spec", {})
        spec = yolov8.build_spec(
            sp.get("variant", "classify"), sp.get("scale", "n"),
            int(sp.get("nc", 13)),
        )
        model = yolov8.build_model(spec, torch.float32)
        yolov8.load_jax_params(model, yolov8.fold_params(params, spec))
        return cls(model, device=dev, **kw)

    def _preprocess(self, crop_bgr: np.ndarray) -> np.ndarray:
        if crop_bgr.ndim == 2:
            crop_bgr = np.stack([crop_bgr] * 3, axis=-1)
        if crop_bgr.size == 0:
            return np.zeros((self.size, self.size, 3), np.float32)
        img = cv_resize_u8(crop_bgr, (self.size, self.size))
        return img[..., ::-1].astype(np.float32) / 255.0  # BGR -> RGB

    @torch.inference_mode()
    def _embed(self, batch: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(batch).to(self.device).permute(0, 3, 1, 2)
        with self.model._precision():
            feats = self.model.forward_features(x)
        pooled = feats[-1].float().mean(dim=(2, 3))
        norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
        return (pooled / norm.clamp(min=1e-6)).cpu().numpy()

    def __call__(self, crops: Sequence[np.ndarray]) -> np.ndarray:
        if not len(crops):
            return np.zeros((0, 1), np.float32)
        batch = np.stack([self._preprocess(c) for c in crops])
        # pad to power-of-two buckets, as the JAX package does for its jit
        n = len(batch)
        bucket = min(self.max_batch, 1 << (max(n - 1, 0)).bit_length() or 1)
        bucket = max(bucket, 1)
        if n < bucket:
            batch = np.concatenate(
                [batch, np.zeros((bucket - n,) + batch.shape[1:], batch.dtype)]
            )
        return self._embed(batch)[:n]


REID_WEIGHTS = "weights/reid_embedder.npz"
FALLBACK_WEIGHTS = "weights/rank_classifier_matched.npz"


def default_embedder(
    weights: str = "", device: Union[str, torch.device] = "cuda"
) -> Optional[AppearanceEmbedder]:
    """Resolve the tracking embedder (cfg.track.embedder_weights).

    Empty ``weights`` selects the purpose-trained re-id checkpoint when it
    exists, else the rank-classifier backbone; relative paths are found from
    the working directory or the repo root. None when no candidate file
    exists; a file that exists but fails to load raises."""
    for cand in ([weights] if weights else [REID_WEIGHTS, FALLBACK_WEIGHTS]):
        cand = resolve_weight_path(cand)
        if cand and os.path.exists(cand):
            return AppearanceEmbedder.from_npz(cand, device=device)
    return None
