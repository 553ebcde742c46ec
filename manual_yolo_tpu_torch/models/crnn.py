"""CRNN text recognizer (feature CNN + bi-LSTM + CTC head) as a PyTorch module.

Counterpart of ``manual_yolo_tpu/models/crnn.py``. Input: gray crops
(N, H, W, 1) in [0, 1], H a multiple of 8 (32 for the canonical canvas, 64
for the high-resolution member). Output: (N, W/4, |charset|+1) logits, class
0 = CTC blank.

  * every conv carries a layer scale: ``relu(conv(x) * g + b)``;
  * the last max-pool spans the whole remaining height (4 rows at 32 px, 8 at
    64 px), so one module serves both geometries;
  * the two bi-LSTM layers are one ``nn.LSTM(bidirectional=True,
    num_layers=2)`` (cuDNN's RNN on the card). The JAX cell adds +1 to the
    forget gate (``sigmoid(f + 1.0)``); ``from_jax_params`` folds it into the
    forget slice of ``bias_ih``. Torch's gate order i, f, g, o is the JAX
    split's;
  * the forward runs in f32 with TF32 off (``core.device.full_f32``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from manual_yolo_tpu_torch.core.device import full_f32
from manual_yolo_tpu_torch.core.weights import conv_hwio_to_oihw
from manual_yolo_tpu_torch.ops.image import cv_resize

# charset: blank + printable subset used by every field type
CHARSET = (
    "0123456789"
    "abcdefghijklmnopqrstuvwxyz"
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    ".,$_-kKmMbB#:/() "
)
_seen: set = set()
CHARSET = "".join(c for c in CHARSET if not (c in _seen or _seen.add(c)))
BLANK = 0
NUM_CLASSES = len(CHARSET) + 1  # + blank

IMG_H = 32
_CONVS = (("c1", 1, 64), ("c2", 64, 128), ("c3", 128, 256),
          ("c4", 256, 256), ("c5", 256, 512), ("c6", 512, 512))


class ScaledConv(nn.Module):
    """3x3 'SAME' conv, then ``relu(y * g + b)``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1, bias=False)
        self.g = nn.Parameter(torch.ones(cout))
        self.b = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv(x) * self.g[:, None, None] + self.b[:, None, None])


class CRNN(nn.Module):
    def __init__(self, hidden: int = 256, nc: int = NUM_CLASSES):
        super().__init__()
        for name, cin, cout in _CONVS:
            setattr(self, name, ScaledConv(cin, cout))
        self.lstm = nn.LSTM(512, hidden, num_layers=2, bidirectional=True)
        self.proj = nn.Linear(2 * hidden, nc)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, H, W, 1) in [0, 1] -> logits (N, W // 4, nc) f32."""
        with full_f32():
            y = x.permute(0, 3, 1, 2)
            y = F.max_pool2d(self.c1(y), (2, 2))  # H/2 x W/2
            y = F.max_pool2d(self.c2(y), (2, 2))  # H/4 x W/4
            y = F.max_pool2d(self.c4(self.c3(y)), (2, 1))  # H/8 x W/4
            y = self.c6(self.c5(y))
            # global max over the remaining height (4 at 32 px, 8 at 64 px)
            y = F.max_pool2d(y, (y.shape[2], 1))  # (N, 512, 1, T)
            seq = y[:, :, 0].permute(2, 0, 1).contiguous()  # (T, N, 512)
            h, _ = self.lstm(seq)  # (T, N, 2H): [forward, backward]
            return self.proj(h).transpose(0, 1)  # (N, T, nc)


def from_jax_params(params: Dict, device="cpu") -> CRNN:
    """Build a CRNN from the JAX package's parameter tree (numpy leaves, as
    ``core.serialization.load_params`` returns them)."""
    hidden = int(np.asarray(params["lstm_fw1"]["wh"]).shape[0])
    nc = int(np.asarray(params["proj"]["b"]).shape[0])
    model = CRNN(hidden, nc)
    f32 = lambda a: torch.from_numpy(np.array(a, dtype=np.float32, order="C"))  # noqa: E731
    state = {}
    for name, _, _ in _CONVS:
        p = params[name]
        state[f"{name}.conv.weight"] = f32(conv_hwio_to_oihw(np.asarray(p["w"])))
        state[f"{name}.g"] = f32(p["g"])
        state[f"{name}.b"] = f32(p["b"])
    forget = np.zeros(4 * hidden, np.float32)
    forget[hidden:2 * hidden] = 1.0  # sigmoid(f + 1.0) of the JAX cell
    for layer in (1, 2):
        for suffix, key in (("", f"lstm_fw{layer}"), ("_reverse", f"lstm_bw{layer}")):
            p = params[key]
            sfx = f"_l{layer - 1}{suffix}"
            state[f"lstm.weight_ih{sfx}"] = f32(np.asarray(p["wi"]).T)
            state[f"lstm.weight_hh{sfx}"] = f32(np.asarray(p["wh"]).T)
            state[f"lstm.bias_ih{sfx}"] = f32(np.asarray(p["b"]) + forget)
            state[f"lstm.bias_hh{sfx}"] = torch.zeros(4 * hidden)
    state["proj.weight"] = f32(np.asarray(params["proj"]["w"]).T)
    state["proj.bias"] = f32(params["proj"]["b"])
    model.load_state_dict(state, strict=True)
    return model.to(device).eval()


def preprocess_gray(
    crop_gray: np.ndarray, target_w: int,
    pad: Optional[int] = None, img_h: Optional[int] = None,
) -> np.ndarray:
    """Host: (h, w) uint8/float gray -> (img_h, target_w) [0,1], aspect kept,
    a few background-padded pixels on each side (CTC drops glyphs that touch
    the crop edge), the rest right-padded with the edge median.

    Upscales with cubic and shrinks with linear interpolation, as
    ``cv2.resize`` does in the JAX package (``ops.image.cv_resize``).
    ``pad`` overrides the lateral background pad (default h//8); ``img_h``
    selects the canvas height (default 32). The JAX package's training-only
    ``stretch`` is not ported."""
    if img_h is None:
        img_h = IMG_H
    h, w = crop_gray.shape[:2]
    if crop_gray.dtype != np.float32:
        crop_gray = crop_gray.astype(np.float32) / 255.0
    bg = float(np.median(crop_gray))
    if pad is None:
        pad = max(2, h // 8)
    crop_gray = np.pad(crop_gray, ((2, 2), (pad, pad)), constant_values=bg)
    h, w = crop_gray.shape[:2]
    scale = img_h / max(h, 1)
    nw = max(1, min(target_w, int(round(w * scale))))
    resized = cv_resize(crop_gray, (img_h, nw), cubic=scale > 1.0)
    canvas = np.full((img_h, target_w), float(np.median(resized[:, -1])), np.float32)
    canvas[:, :nw] = resized
    return canvas
