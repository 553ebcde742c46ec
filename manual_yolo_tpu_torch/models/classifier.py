"""Rank classifier. Counterpart of ``manual_yolo_tpu/models/classifier.py``.

A yolov8n-cls network over 64x64 card-rank crops, 13 classes, run batched
in f32, loaded from a native ``.npz`` or an ultralytics ``.pt`` checkpoint.
``classify_crops`` is the reference's per-crop API (``[(name, conf)]``) as
one batched forward; its host preprocessing, ``preprocess_crop_host``,
resizes as PIL's ``Image.BILINEAR`` does, byte for byte, in numpy (the JAX
package calls PIL). The frame pipeline cuts its crops on the device instead.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from manual_yolo_tpu_torch.core.device import resolve_device
from manual_yolo_tpu_torch.core.serialization import load_params
from manual_yolo_tpu_torch.core.weights import load_torch_checkpoint
from manual_yolo_tpu_torch.models import yolov8

IMG_SIZE = 64
RANK_NAMES_13 = ["10", "2", "3", "4", "5", "6", "7", "8", "9", "A", "J", "K", "Q"]
PRECISION_BITS = 22  # Pillow's fixed-point resampling coefficients (32 - 8 - 2)


def _bilinear_coeffs(in_size: int, out_size: int, first: int, count: int):
    """Pillow's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` for the
    BILINEAR (triangle) filter, for output indices ``first .. first+count-1``:
    (input indices, fixed-point weights), both (count, ksize). The support is
    widened by the scale on a downscale, so it antialiases there."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(first, first + count) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    k = np.arange(ksize)
    t = np.abs(((k[None, :] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where((t < 1.0) & (k[None, :] < xmax[:, None]), 1.0 - t, 0.0)
    ww = np.cumsum(w, axis=1)[:, -1:]  # C's running sum (zeros past xmax add nothing)
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    scaled = w * (1 << PRECISION_BITS)
    fixed = np.trunc(np.where(w < 0, scaled - 0.5, scaled + 0.5)).astype(np.int64)
    idx = np.minimum(xmin[:, None] + k[None, :], in_size - 1)
    return idx, fixed


def _resample(img: np.ndarray, axis: int, in_size: int, out_size: int, first: int,
              count: int) -> np.ndarray:
    """One 8-bit pass of Pillow's ``ImagingResample`` along ``axis`` (1:
    columns, 0: rows) of an (H, W, C) uint8 image, output indices ``first ..
    first+count-1``: accumulate from 1 << 21, shift by 22, clamp to 0..255."""
    if out_size == in_size:  # Pillow skips the pass
        return img[first:first + count] if axis == 0 else img[:, first:first + count]
    idx, fixed = _bilinear_coeffs(in_size, out_size, first, count)
    src = img.astype(np.int64)
    if axis == 1:
        acc = np.einsum("hokc,ok->hoc", src[:, idx, :], fixed)
    else:
        acc = np.einsum("okwc,ok->owc", src[idx], fixed)
    acc += 1 << (PRECISION_BITS - 1)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def preprocess_crop_host(bgr: np.ndarray, size: int = IMG_SIZE) -> np.ndarray:
    """Host preprocessing of one variable-size (H, W, 3) uint8 BGR crop, as
    ``manual_yolo_tpu/models/classifier.py:29-47`` does with PIL: BGR->RGB,
    the short side resized to ``size`` (``Image.BILINEAR``: two separable
    passes, horizontal first, uint8 between), centre-crop to ``size`` x
    ``size``, /255 in float32. Only the cropped part is resampled, which
    gives the same bytes: each output sample depends on its own window."""
    x = np.asarray(bgr)
    if x.dtype != np.uint8 or x.ndim != 3 or x.shape[2] != 3 or 0 in x.shape:
        raise ValueError(f"preprocess_crop_host takes an (H, W, 3) uint8 BGR crop, "
                         f"got {x.dtype} {x.shape}")
    rgb = x[..., ::-1]
    h, w = rgb.shape[:2]
    scale = size / min(w, h)
    nw, nh = max(size, round(w * scale)), max(size, round(h * scale))
    left, top = (nw - size) // 2, (nh - size) // 2
    img = _resample(rgb, 1, w, nw, left, size)
    img = _resample(img, 0, h, nh, top, size)
    return img.astype(np.float32) / 255.0


def _default_names(names: Dict[int, str]) -> Dict[int, str]:
    return names or {i: n for i, n in enumerate(RANK_NAMES_13)}


def _npz_tree(path: str):
    params, meta = load_params(path)
    sp = meta.get("spec", {})
    spec = yolov8.build_spec(
        sp.get("variant", "classify"), sp.get("scale", "n"), int(sp.get("nc", 13))
    )
    names = {int(k): v for k, v in meta.get("names", {}).items()}
    return yolov8.fold_params(params, spec), spec, _default_names(names)


def _pt_tree(path: str):
    ckpt = load_torch_checkpoint(path)
    nc = len(ckpt.names) or 13
    scale = (ckpt.arch_yaml or {}).get("scale", "n")
    spec = yolov8.build_spec("classify", scale, nc)
    return yolov8.import_torch_state(ckpt.state, spec, fold=True), spec, _default_names(ckpt.names)


def load_classifier_tree(path: str) -> Tuple[list, yolov8.ModelSpec, Dict[int, str]]:
    """A native ``.npz`` or ultralytics ``.pt`` classifier checkpoint as
    (folded JAX-layout tree, spec, class names; ``RANK_NAMES_13`` without
    names), on the host."""
    return (_pt_tree if path.endswith(".pt") else _npz_tree)(path)


class RankClassifier:
    """Batched rank classifier over (N, 64, 64, 3) RGB crops in [0, 1]."""

    def __init__(self, model: yolov8.YOLOv8Classify, names: Dict[int, str]):
        self.model = model
        self.spec = model.spec
        self.names = dict(names)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @classmethod
    def _from_tree(cls, params, spec: yolov8.ModelSpec, names: Dict[int, str],
                   device) -> "RankClassifier":
        """A folded JAX-layout tree on ``device`` (f32)."""
        dev = resolve_device(device)
        model = yolov8.load_jax_params(yolov8.build_model(spec, torch.float32), params)
        return cls(model.to(dev).eval(), names)

    @classmethod
    def from_npz(cls, path: str, device: Union[str, torch.device] = "cuda") -> "RankClassifier":
        """Load a native checkpoint (BN folded on the host, then moved); f32."""
        return cls._from_tree(*_npz_tree(path), device)

    @classmethod
    def load(cls, path: str, device: Union[str, torch.device] = "cuda") -> "RankClassifier":
        """A native ``.npz`` or ultralytics ``.pt`` checkpoint, by its suffix."""
        return cls._from_tree(*load_classifier_tree(path), device)

    @classmethod
    def from_torch_checkpoint(cls, path: str,
                              device: Union[str, torch.device] = "cuda") -> "RankClassifier":
        """Load an ultralytics ``.pt`` (its ``ema`` weights when present):
        the scale from its yaml, ``nc`` from its names (13 without them)."""
        return cls._from_tree(*_pt_tree(path), device)

    @classmethod
    def random_init(cls, scale: str = "n", nc: int = 13,
                    generator: Optional[torch.Generator] = None,
                    device: Union[str, torch.device] = "cuda") -> "RankClassifier":
        """Random weights drawn from ``generator`` (seed 0 without one).
        Torch's generator cannot repeat JAX's ``init_params`` draws: only the
        spec and the shapes match the JAX package's."""
        spec = yolov8.build_spec("classify", scale, nc)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        params = yolov8.fold_params(yolov8.init_params(g, spec), spec)
        return cls._from_tree(params, spec, {i: n for i, n in enumerate(RANK_NAMES_13[:nc])},
                              device)

    @torch.inference_mode()
    def logits(self, batch: torch.Tensor) -> torch.Tensor:
        """batch: (N, 64, 64, 3) RGB float in [0,1] -> (N, nc) logits."""
        return self.model(batch)

    def predict_probs(self, batch: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.logits(batch), dim=-1)

    def classify_crops(self, crops_bgr: Sequence[np.ndarray]) -> List[Tuple[str, float]]:
        """Reference-parity API: BGR crops -> [(rank_name, conf)], top-1 of
        the softmax, from ONE batched forward on the classifier's device."""
        if not crops_bgr:
            return []
        batch = np.stack([preprocess_crop_host(c) for c in crops_bgr])
        probs = self.predict_probs(torch.from_numpy(batch).to(self.device)).cpu().numpy()
        out = []
        for p in probs:
            top = int(np.argmax(p))
            out.append((self.names.get(top, str(top)), float(p[top])))
        return out
