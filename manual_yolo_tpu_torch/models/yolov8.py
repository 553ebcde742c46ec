"""YOLOv8 graphs (detect + classify) as PyTorch modules.

Counterpart of ``manual_yolo_tpu/models/yolov8.py``. The layer graph
(``build_spec``) is the same; the forward is ``nn.Module``s:

  * NCHW inside (cuDNN's layout); the public functions take and return the
    JAX package's layout, (N, H, W, C), so the two compare like with like;
  * parameters come from the JAX package's folded numpy tree
    (``load_params`` + ``fold_params``) through ``load_jax_params``;
  * hidden conv layers keep the bias + SiLU epilogue in the compute dtype,
    head layers (``act=False``) promote to f32, as the JAX ``conv_block``
    does (``manual_yolo_tpu/models/yolov8.py:425-461``);
  * a float32 forward turns TF32 off for its convs and matmuls: cuDNN's
    TF32 default keeps ~3 decimal digits and flips borderline rank reads.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from manual_yolo_tpu_torch.core.weights import conv_hwio_to_oihw, fold_batchnorm

BN_EPS = 1e-3  # ultralytics Conv uses BatchNorm2d(eps=0.001)
REG_MAX = 16  # DFL bins in the Detect head

# depth_multiple, width_multiple, max_channels per scale
SCALES = {
    "n": (0.33, 0.25, 1024),
    "s": (0.33, 0.50, 1024),
    "m": (0.67, 0.75, 576),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.25, 512),
}
# classification variant caps channels at 1024 for every scale
CLS_SCALES = {k: (d, w, 1024) for k, (d, w, _) in SCALES.items()}


def make_divisible(x: float, divisor: int = 8) -> int:
    return max(divisor, int(x + divisor / 2) // divisor * divisor)


@dataclass(frozen=True)
class Layer:
    kind: str  # conv | c2f | sppf | upsample | concat | detect | classify
    cin: int = 0
    cout: int = 0
    k: int = 1
    s: int = 1
    n: int = 1  # bottleneck repeats for c2f
    shortcut: bool = False
    src: Tuple[int, ...] = (-1,)  # input layer indices (concat has 2)


@dataclass(frozen=True)
class ModelSpec:
    variant: str  # "detect" | "classify"
    scale: str
    nc: int
    layers: Tuple[Layer, ...]
    out_channels: Tuple[int, ...] = ()  # detect: per-level channels
    strides: Tuple[int, ...] = (8, 16, 32)


def _scaled(c: int, width: float, max_ch: int) -> int:
    return make_divisible(min(c, max_ch) * width)


def build_spec(variant: str = "detect", scale: str = "n", nc: int = 64) -> ModelSpec:
    """Construct the layer graph for a yolov8{scale}[-cls] model."""
    depth, width, max_ch = (CLS_SCALES if variant == "classify" else SCALES)[scale]
    d = lambda n: max(round(n * depth), 1)
    w = lambda c: _scaled(c, width, max_ch)

    L: List[Layer] = []
    # --- backbone (shared) ---
    L.append(Layer("conv", 3, w(64), 3, 2))                                   # 0  P1/2
    L.append(Layer("conv", w(64), w(128), 3, 2))                              # 1  P2/4
    L.append(Layer("c2f", w(128), w(128), n=d(3), shortcut=True))             # 2
    L.append(Layer("conv", w(128), w(256), 3, 2))                             # 3  P3/8
    L.append(Layer("c2f", w(256), w(256), n=d(6), shortcut=True))             # 4
    L.append(Layer("conv", w(256), w(512), 3, 2))                             # 5  P4/16
    L.append(Layer("c2f", w(512), w(512), n=d(6), shortcut=True))             # 6
    L.append(Layer("conv", w(512), w(1024), 3, 2))                            # 7  P5/32
    L.append(Layer("c2f", w(1024), w(1024), n=d(3), shortcut=True))           # 8

    if variant == "classify":
        L.append(Layer("classify", w(1024), nc))                              # 9
        return ModelSpec(variant, scale, nc, tuple(L))

    L.append(Layer("sppf", w(1024), w(1024), k=5))                            # 9
    # --- FPN/PAN neck + head ---
    L.append(Layer("upsample"))                                               # 10
    L.append(Layer("concat", src=(-1, 6)))                                    # 11
    L.append(Layer("c2f", w(1024) + w(512), w(512), n=d(3), shortcut=False))  # 12
    L.append(Layer("upsample"))                                               # 13
    L.append(Layer("concat", src=(-1, 4)))                                    # 14
    L.append(Layer("c2f", w(512) + w(256), w(256), n=d(3), shortcut=False))   # 15 (P3)
    L.append(Layer("conv", w(256), w(256), 3, 2))                             # 16
    L.append(Layer("concat", src=(-1, 12)))                                   # 17
    L.append(Layer("c2f", w(256) + w(512), w(512), n=d(3), shortcut=False))   # 18 (P4)
    L.append(Layer("conv", w(512), w(512), 3, 2))                             # 19
    L.append(Layer("concat", src=(-1, 9)))                                    # 20
    L.append(Layer("c2f", w(512) + w(1024), w(1024), n=d(3), shortcut=False)) # 21 (P5)
    L.append(Layer("detect", src=(15, 18, 21)))                               # 22
    return ModelSpec(
        variant, scale, nc, tuple(L), out_channels=(w(256), w(512), w(1024))
    )


def fold_params(params: List[Any], spec: ModelSpec) -> List[Any]:
    """Fold explicit BN sub-dicts into conv biases (training -> inference).

    Host numpy in, host numpy out; leaves without BN pass through."""

    def fold_conv(p):
        if "bn" not in p:
            return {k: np.asarray(v) for k, v in p.items()}
        bn = p["bn"]
        w = conv_hwio_to_oihw(np.asarray(p["w"]))
        wf, bf = fold_batchnorm(
            w,
            np.asarray(bn["gamma"]),
            np.asarray(bn["beta"]),
            np.asarray(bn["mean"]),
            np.asarray(bn["var"]),
            BN_EPS,
        )
        return {"w": wf, "b": bf}

    def rec(p):
        if isinstance(p, dict):
            if "w" in p:
                return fold_conv(p)
            return {k: rec(v) for k, v in p.items()}
        if isinstance(p, list):
            return [rec(v) for v in p]
        return p

    return [rec(p) for p in params]


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _full_f32():
    """Turn TF32 off for the convs and matmuls inside (restored after)."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


class ConvBlock(nn.Module):
    """Conv + bias (+ SiLU), BN folded. Counterpart of JAX ``conv_block``.

    The kernel is held in the compute dtype. A hidden layer (``act=True``)
    adds its bias and applies SiLU in the compute dtype; a head layer
    (``act=False``) adds an f32 bias, which promotes its output to f32.
    """

    def __init__(self, cin: int, cout: int, k: int = 1, s: int = 1,
                 act: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = act
        self.conv = nn.Conv2d(cin, cout, k, s, padding=k // 2, bias=False, dtype=dtype)
        self.bias = nn.Parameter(
            torch.zeros(cout, dtype=dtype if act else torch.float32),
            requires_grad=False,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x.to(self.conv.weight.dtype))
        if self.act:
            return F.silu(y + self.bias[:, None, None])
        return y.float() + self.bias[:, None, None]


class Bottleneck(nn.Module):
    def __init__(self, c: int, shortcut: bool, dtype: torch.dtype):
        super().__init__()
        self.cv1 = ConvBlock(c, c, 3, dtype=dtype)
        self.cv2 = ConvBlock(c, c, 3, dtype=dtype)
        self.shortcut = shortcut

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


class C2f(nn.Module):
    """Split in half, grow by one bottleneck output per repeat, concat, fuse."""

    def __init__(self, cin: int, cout: int, n: int, shortcut: bool, dtype: torch.dtype):
        super().__init__()
        c = int(cout * 0.5)
        self.cv1 = ConvBlock(cin, 2 * c, 1, dtype=dtype)
        self.cv2 = ConvBlock((2 + n) * c, cout, 1, dtype=dtype)
        self.m = nn.ModuleList(Bottleneck(c, shortcut, dtype) for _ in range(n))

    def forward(self, x):
        y = self.cv1(x)
        parts = list(y.chunk(2, dim=1))
        for m in self.m:
            parts.append(m(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    """1x1 conv, three chained k x k stride-1 max pools, concat, 1x1 conv."""

    def __init__(self, cin: int, cout: int, k: int, dtype: torch.dtype):
        super().__init__()
        c_ = cin // 2
        self.k = k
        self.cv1 = ConvBlock(cin, c_, 1, dtype=dtype)
        self.cv2 = ConvBlock(c_ * 4, cout, 1, dtype=dtype)

    def forward(self, x):
        y = self.cv1(x)
        pool = lambda v: F.max_pool2d(v, self.k, 1, self.k // 2)
        p1 = pool(y)
        p2 = pool(p1)
        p3 = pool(p2)
        return self.cv2(torch.cat([y, p1, p2, p3], dim=1))


class ClassifyHead(nn.Module):
    def __init__(self, cin: int, nc: int, dtype: torch.dtype):
        super().__init__()
        self.conv = ConvBlock(cin, 1280, 1, dtype=dtype)
        self.linear = nn.Linear(1280, nc, dtype=dtype)
        self.linear.requires_grad_(False)
        # the JAX head adds its bias in f32 whatever the compute dtype
        self.linear.bias = nn.Parameter(torch.zeros(nc), requires_grad=False)

    def forward(self, x):
        y = self.conv(x).mean(dim=(2, 3))  # global average pool
        w = self.linear.weight
        return F.linear(y.to(w.dtype), w).float() + self.linear.bias


class Detect(nn.Module):
    """Per level: a box branch (4*REG_MAX DFL logits) and a class branch."""

    def __init__(self, spec: ModelSpec, dtype: torch.dtype):
        super().__init__()
        ch = spec.out_channels
        c2 = max(16, ch[0] // 4, REG_MAX * 4)
        c3 = max(ch[0], min(spec.nc, 100))

        def branch(c, cmid, cout):
            return nn.ModuleList([
                ConvBlock(c, cmid, 3, dtype=dtype),
                ConvBlock(cmid, cmid, 3, dtype=dtype),
                ConvBlock(cmid, cout, 1, act=False, dtype=dtype),
            ])

        self.box = nn.ModuleList(branch(c, c2, 4 * REG_MAX) for c in ch)
        self.cls = nn.ModuleList(branch(c, c3, spec.nc) for c in ch)

    @staticmethod
    def _run(branch, x):
        for layer in branch:
            x = layer(x)
        return x

    def forward(self, feats: Sequence[torch.Tensor]):
        return [(self._run(b, f), self._run(c, f)) for b, c, f in zip(self.box, self.cls, feats)]


class _YOLOv8(nn.Module):
    """The shared graph. ``layers.{i}`` mirrors ``params[i]`` of the JAX tree."""

    def __init__(self, spec: ModelSpec, compute_dtype: torch.dtype):
        super().__init__()
        self.spec = spec
        self.compute_dtype = compute_dtype
        mods = []
        for layer in spec.layers:
            if layer.kind == "conv":
                mods.append(ConvBlock(layer.cin, layer.cout, layer.k, layer.s, dtype=compute_dtype))
            elif layer.kind == "c2f":
                mods.append(C2f(layer.cin, layer.cout, layer.n, layer.shortcut, compute_dtype))
            elif layer.kind == "sppf":
                mods.append(SPPF(layer.cin, layer.cout, layer.k, compute_dtype))
            elif layer.kind == "classify":
                mods.append(ClassifyHead(layer.cin, layer.cout, compute_dtype))
            elif layer.kind == "detect":
                mods.append(Detect(spec, compute_dtype))
            else:  # upsample / concat — no params
                mods.append(nn.Identity())
        self.layers = nn.ModuleList(mods)

    def forward_features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x NCHW -> saved per-layer features (NCHW), stopping before the head."""
        feats: List[torch.Tensor] = []
        y = x
        for layer, mod in zip(self.spec.layers, self.layers):
            if layer.kind in ("conv", "c2f", "sppf"):
                y = mod(y)
            elif layer.kind == "upsample":
                y = F.interpolate(y, scale_factor=2, mode="nearest")
            elif layer.kind == "concat":
                y = torch.cat([y, feats[layer.src[1]]], dim=1)
            else:  # classify / detect head: handled by the subclass
                feats.append(y)
                return feats
            feats.append(y)
        return feats

    def _precision(self):
        return _full_f32() if self.compute_dtype == torch.float32 else contextlib.nullcontext()


class YOLOv8Detect(_YOLOv8):
    """x (N, H, W, 3) float in [0, 1] RGB -> per level (box_dist (N,h,w,64),
    cls_logit (N,h,w,nc)), both f32. Counterpart of ``forward_detect_raw``."""

    def forward(self, x: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        with self._precision():
            feats = self.forward_features(x.permute(0, 3, 1, 2))
            raw = self.layers[-1]([feats[s] for s in self.spec.layers[-1].src])
        return [(b.permute(0, 2, 3, 1), c.permute(0, 2, 3, 1)) for b, c in raw]


class YOLOv8Classify(_YOLOv8):
    """x (N, H, W, 3) float in [0, 1] RGB -> logits (N, nc) f32.
    Counterpart of ``forward_classify``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with self._precision():
            feats = self.forward_features(x.permute(0, 3, 1, 2))
            return self.layers[-1](feats[-1])


def build_model(spec: ModelSpec, compute_dtype: torch.dtype = torch.float32) -> _YOLOv8:
    cls = YOLOv8Classify if spec.variant == "classify" else YOLOv8Detect
    return cls(spec, compute_dtype)


def load_jax_params(module: _YOLOv8, params: List[Any]) -> _YOLOv8:
    """Copy the JAX package's folded parameter tree (numpy leaves) into
    ``module``. Paths map one to one: ``params[i]["m"][0]["cv1"]`` is
    ``layers.i.m.0.cv1``. Conv kernels go HWIO -> OIHW, the classify linear
    (in, out) -> (out, in). Every parameter of the module must be set."""
    loaded = set()

    def put(name: str, value: np.ndarray):
        t = module.get_parameter(name)
        v = torch.from_numpy(np.array(value, dtype=np.float32, order="C"))
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"{name}: checkpoint shape {tuple(v.shape)} != {tuple(t.shape)}")
        with torch.no_grad():
            t.copy_(v)
        loaded.add(name)

    def rec(p, path: str):
        if isinstance(p, dict) and "w" in p:
            if "bn" in p:
                raise ValueError(f"{path}: BN is not folded; run fold_params first")
            mod = module.get_submodule(path)
            if isinstance(mod, nn.Linear):
                put(f"{path}.weight", np.asarray(p["w"]).T)
                put(f"{path}.bias", p["b"])
            else:
                put(f"{path}.conv.weight", conv_hwio_to_oihw(np.asarray(p["w"])))
                put(f"{path}.bias", p["b"])
        elif isinstance(p, dict):
            for k, v in p.items():
                rec(v, f"{path}.{k}")
        elif isinstance(p, (list, tuple)):
            for i, v in enumerate(p):
                rec(v, f"{path}.{i}")

    for i, p in enumerate(params):
        rec(p, f"layers.{i}")
    missing = {n for n, _ in module.named_parameters()} - loaded
    if missing:
        raise ValueError(f"parameters not in the checkpoint: {sorted(missing)[:5]}")
    return module


# ---------------------------------------------------------------------------
# Box decode
# ---------------------------------------------------------------------------


def dfl_decode(box_dist: torch.Tensor) -> torch.Tensor:
    """Distribution Focal Loss decode: (..., 4*REG_MAX) -> (..., 4) expected offsets."""
    d = box_dist.reshape(box_dist.shape[:-1] + (4, REG_MAX))
    p = torch.softmax(d, dim=-1)
    bins = torch.arange(REG_MAX, dtype=p.dtype, device=p.device)
    return (p * bins).sum(dim=-1)


def make_anchors(
    img_hw: Tuple[int, int], strides: Sequence[int], offset: float = 0.5
) -> Tuple[np.ndarray, np.ndarray]:
    """Anchor points (cell centers, units of stride) and per-anchor stride,
    concatenated over levels."""
    pts, strs = [], []
    H, W = img_hw
    for s in strides:
        h, w = H // s, W // s
        xs = (np.arange(w, dtype=np.float32) + offset)
        ys = (np.arange(h, dtype=np.float32) + offset)
        gx, gy = np.meshgrid(xs, ys)
        pts.append(np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1))
        strs.append(np.full((h * w, 1), s, dtype=np.float32))
    return np.concatenate(pts, 0), np.concatenate(strs, 0)


def decode_boxes(
    raw: List[Tuple[torch.Tensor, torch.Tensor]],
    img_hw: Tuple[int, int],
    strides: Sequence[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode raw head outputs into (boxes_xyxy (N,A,4) pixels, scores (N,A,nc))."""
    device = raw[0][0].device
    anchors, astr = (torch.from_numpy(a).to(device) for a in make_anchors(img_hw, strides))
    dists, clss = [], []
    for box, cls in raw:
        n, h, w, _ = box.shape
        dists.append(box.reshape(n, h * w, 4 * REG_MAX))
        clss.append(cls.reshape(n, h * w, cls.shape[-1]))
    dist = torch.cat(dists, dim=1)
    cls = torch.cat(clss, dim=1)
    ltrb = dfl_decode(dist)  # (N, A, 4) in stride units
    lt, rb = ltrb[..., :2], ltrb[..., 2:]
    x1y1 = (anchors[None] - lt) * astr[None]
    x2y2 = (anchors[None] + rb) * astr[None]
    boxes = torch.cat([x1y1, x2y2], dim=-1)
    scores = torch.sigmoid(cls)
    return boxes, scores
