"""CRNN text recognizer (feature CNN + bi-LSTM + CTC head) as a PyTorch module.

Counterpart of ``manual_yolo_tpu/models/crnn.py``. Input: gray crops
(N, H, W, 1) in [0, 1], H a multiple of 8 (32 for the canonical canvas, 64
for the high-resolution member). Output: (N, W/4, |charset|+1) logits, class
0 = CTC blank.

  * every conv carries a layer scale: ``relu(conv(x) * g + b)``;
  * the last max-pool spans the whole remaining height (4 rows at 32 px, 8 at
    64 px), so one module serves both geometries;
  * the two bi-LSTM layers are one ``nn.LSTM(bidirectional=True,
    num_layers=2)`` (cuDNN's RNN on the card, always). The JAX cell adds +1 to the
    forget gate (``sigmoid(f + 1.0)``); ``from_jax_params`` folds it into the
    forget slice of ``bias_ih``. Torch's gate order i, f, g, o is the JAX
    split's;
  * the forward runs in f32 with TF32 off (``core.device.full_f32``).

Training (``train/ocr.py``): ``init_params`` draws the JAX package's
initial distributions from a ``torch.Generator``; ``for_training`` moves the
forget offset into ``bias_hh`` and freezes it there, so that ``bias_ih`` is
the JAX cell's one bias ``b``, trained and decayed once (``nn.LSTM`` adds
both biases, so two trainable ones would move their sum at twice the
step); ``to_jax_params`` gives the JAX tree back from either layout.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from manual_yolo_tpu_torch.core.device import cudnn_enabled, full_f32
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


def char_to_id(c: str) -> int:
    return CHARSET.index(c) + 1


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
            with cudnn_enabled(True):  # also where a train step turns it off for the convs
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
    forget = _forget_offset(hidden)  # sigmoid(f + 1.0) of the JAX cell
    for key, sfx in _lstm_names():
        p = params[key]
        state[f"lstm.weight_ih{sfx}"] = f32(np.asarray(p["wi"]).T)
        state[f"lstm.weight_hh{sfx}"] = f32(np.asarray(p["wh"]).T)
        state[f"lstm.bias_ih{sfx}"] = f32(np.asarray(p["b"]) + forget)
        state[f"lstm.bias_hh{sfx}"] = torch.zeros(4 * hidden)
    state["proj.weight"] = f32(np.asarray(params["proj"]["w"]).T)
    state["proj.bias"] = f32(params["proj"]["b"])
    model.load_state_dict(state, strict=True)
    return model.to(device).eval()


def _forget_offset(hidden: int) -> np.ndarray:
    """The JAX cell's ``sigmoid(f + 1.0)`` as a bias: 1 on the forget slice."""
    forget = np.zeros(4 * hidden, np.float32)
    forget[hidden:2 * hidden] = 1.0
    return forget


def init_params(gen: torch.Generator, hidden: int = 256, nc: int = NUM_CLASSES) -> Dict:
    """A fresh parameter tree in the JAX package's layout and distributions
    (``manual_yolo_tpu/models/crnn.py::init_params``): convs uniform in
    +-sqrt(6 / fan_in) (HWIO), scale 1, bias 0; LSTM weights uniform in
    +-sqrt(1 / hidden), bias 0, the two directions of a layer drawn alike
    (JAX gives them one key); the projection uniform in +-sqrt(6 / fan_in)."""

    def uniform(shape, bound):
        u = torch.rand(shape, generator=gen, dtype=torch.float32)
        return ((u * 2.0 - 1.0) * bound).numpy()

    params: Dict = {}
    for name, cin, cout in _CONVS:
        params[name] = {"w": uniform((3, 3, cin, cout), math.sqrt(6.0 / (cin * 9))),
                        "b": np.zeros(cout, np.float32), "g": np.ones(cout, np.float32)}
    for layer, cin in ((1, 512), (2, 2 * hidden)):
        bound = math.sqrt(1.0 / hidden)
        cell = {"wi": uniform((cin, 4 * hidden), bound),
                "wh": uniform((hidden, 4 * hidden), bound),
                "b": np.zeros(4 * hidden, np.float32)}
        params[f"lstm_fw{layer}"] = cell
        params[f"lstm_bw{layer}"] = {k: v.copy() for k, v in cell.items()}
    params["proj"] = {"w": uniform((2 * hidden, nc), math.sqrt(6.0 / (2 * hidden))),
                      "b": np.zeros(nc, np.float32)}
    return params


def _lstm_names():
    for layer in (1, 2):
        for suffix, key in (("", f"lstm_fw{layer}"), ("_reverse", f"lstm_bw{layer}")):
            yield key, f"_l{layer - 1}{suffix}"


def for_training(model: CRNN) -> CRNN:
    """Put the forget offset in ``bias_hh`` and freeze it: ``bias_ih`` is then
    the JAX cell's ``b``, the only trainable LSTM bias."""
    hidden = model.lstm.hidden_size
    forget = torch.from_numpy(_forget_offset(hidden)).to(model.proj.weight.device)
    with torch.no_grad():
        for _, sfx in _lstm_names():
            b_ih, b_hh = getattr(model.lstm, f"bias_ih{sfx}"), getattr(model.lstm, f"bias_hh{sfx}")
            b_ih += b_hh - forget
            b_hh.copy_(forget)
            b_hh.requires_grad_(False)
    return model


def to_jax_params(model: CRNN) -> Dict:
    """The JAX package's parameter tree of ``model`` (numpy f32, or f64 for an
    f64 model), the inverse of ``from_jax_params``: ``b = bias_ih + bias_hh
    - forget offset``."""
    hidden = model.lstm.hidden_size
    np32 = lambda t: (t.detach().cpu().double() if t.dtype == torch.float64  # noqa: E731
                      else t.detach().float().cpu()).numpy().copy()
    params: Dict = {}
    for name, _, _ in _CONVS:
        m = getattr(model, name)
        params[name] = {"w": np.ascontiguousarray(np32(m.conv.weight).transpose(2, 3, 1, 0)),
                        "b": np32(m.b), "g": np32(m.g)}
    for key, sfx in _lstm_names():
        get = lambda n: np32(getattr(model.lstm, f"{n}{sfx}"))  # noqa: E731
        params[key] = {"wi": np.ascontiguousarray(get("weight_ih").T),
                       "wh": np.ascontiguousarray(get("weight_hh").T),
                       "b": get("bias_ih") + get("bias_hh") - _forget_offset(hidden)}
    params["proj"] = {"w": np.ascontiguousarray(np32(model.proj.weight).T),
                      "b": np32(model.proj.bias)}
    return params


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
