"""Letterbox preprocessing. Counterpart of ``manual_yolo_tpu/ops/letterbox.py``.

Aspect-preserving resize (bilinear, half-pixel centers, no antialias — the
JAX package's ``jax.image.resize(..., antialias=False)``, which matches
cv2.INTER_LINEAR), centered on a canvas padded with gray 114, scaled to
[0, 1]. The geometry (``letterbox_params``) keeps Python ``round`` so it is
the JAX package's to the pixel.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

PAD_VALUE = 114.0


def letterbox_params(
    src_hw: Tuple[int, int], dst_hw: Tuple[int, int], scaleup: bool = True
) -> Tuple[float, int, int, int, int]:
    """Static letterbox geometry: (ratio, new_h, new_w, pad_top, pad_left)."""
    h, w = src_hw
    H, W = dst_hw
    r = min(H / h, W / w)
    if not scaleup:
        r = min(r, 1.0)
    new_h, new_w = round(h * r), round(w * r)
    pad_h, pad_w = H - new_h, W - new_w
    # center padding, matching the reference's letterbox (dw/2, dh/2 rounding)
    top = int(round(pad_h / 2 - 0.1))
    left = int(round(pad_w / 2 - 0.1))
    return r, new_h, new_w, top, left


def letterbox(
    frame: torch.Tensor,
    dst_hw: Tuple[int, int],
    scaleup: bool = True,
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, float, Tuple[int, int]]:
    """Letterbox a (H, W, 3) uint8/float frame to (H_t, W_t, 3) in [0,1].

    Returns (canvas, ratio, (pad_top, pad_left)); ratio and pads are Python
    values for the inverse box mapping.
    """
    h, w = frame.shape[0], frame.shape[1]
    H, W = dst_hw
    r, new_h, new_w, top, left = letterbox_params((h, w), (H, W), scaleup)
    img = frame.to(dtype)
    if (new_h, new_w) != (h, w):
        img = F.interpolate(
            img.permute(2, 0, 1)[None], size=(new_h, new_w), mode="bilinear",
            align_corners=False, antialias=False,
        )[0].permute(1, 2, 0)
    canvas = torch.full((H, W, 3), PAD_VALUE, dtype=dtype, device=frame.device)
    canvas[top:top + new_h, left:left + new_w] = img
    return canvas / 255.0, r, (top, left)


def unletterbox_boxes(
    boxes_xyxy: torch.Tensor, ratio: float, pad: Tuple[int, int], src_hw: Tuple[int, int]
) -> torch.Tensor:
    """Map boxes from letterbox-canvas pixels back to source-frame pixels."""
    top, left = pad
    h, w = src_hw
    shift = torch.tensor([left, top, left, top], dtype=boxes_xyxy.dtype, device=boxes_xyxy.device)
    out = (boxes_xyxy - shift) / ratio
    lim = torch.tensor([w, h, w, h], dtype=out.dtype, device=out.device)
    return torch.minimum(out.clamp(min=0.0), lim)
