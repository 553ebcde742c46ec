"""Rank classifier. Counterpart of ``manual_yolo_tpu/models/classifier.py:50-107``.

A yolov8n-cls network over 64x64 card-rank crops, 13 classes, run batched
in f32. The host preprocessing of variable-size crops
(``preprocess_crop_host``, PIL in the JAX package) is not ported yet; the
frame pipeline cuts its crops on the device.
"""

from __future__ import annotations

from typing import Dict, Union

import torch

from manual_yolo_tpu_torch.core.device import resolve_device
from manual_yolo_tpu_torch.core.serialization import load_params
from manual_yolo_tpu_torch.models import yolov8

IMG_SIZE = 64
RANK_NAMES_13 = ["10", "2", "3", "4", "5", "6", "7", "8", "9", "A", "J", "K", "Q"]


class RankClassifier:
    """Batched rank classifier over (N, 64, 64, 3) RGB crops in [0, 1]."""

    def __init__(self, model: yolov8.YOLOv8Classify, names: Dict[int, str]):
        self.model = model
        self.spec = model.spec
        self.names = dict(names)

    @classmethod
    def from_npz(cls, path: str, device: Union[str, torch.device] = "cuda") -> "RankClassifier":
        """Load a native checkpoint (BN folded on the host, then moved); f32."""
        dev = resolve_device(device)
        params, meta = load_params(path)
        sp = meta.get("spec", {})
        spec = yolov8.build_spec(
            sp.get("variant", "classify"), sp.get("scale", "n"), int(sp.get("nc", 13))
        )
        model = yolov8.build_model(spec, torch.float32)
        yolov8.load_jax_params(model, yolov8.fold_params(params, spec))
        names = {int(k): v for k, v in meta.get("names", {}).items()}
        return cls(model.to(dev).eval(),
                   names or {i: n for i, n in enumerate(RANK_NAMES_13)})

    @torch.inference_mode()
    def logits(self, batch: torch.Tensor) -> torch.Tensor:
        """batch: (N, 64, 64, 3) RGB float in [0,1] -> (N, nc) logits."""
        return self.model(batch)

    def predict_probs(self, batch: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.logits(batch), dim=-1)
