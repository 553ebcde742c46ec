"""YOLOv8 graphs (detect + classify) as PyTorch modules.

Counterpart of ``manual_yolo_tpu/models/yolov8.py``. The layer graph
(``build_spec``) is the same; the forward is ``nn.Module``s:

  * NCHW inside (cuDNN's layout); the public functions take and return the
    JAX package's layout, (N, H, W, C), so the two compare like with like;
  * parameters come from the JAX package's numpy tree (``load_params``,
    folded by ``fold_params`` for inference) through ``load_jax_params``;
  * hidden conv layers keep the bias + SiLU epilogue in the compute dtype,
    head layers (``act=False``) promote to f32, as the JAX ``conv_block``
    does (``manual_yolo_tpu/models/yolov8.py:425-461``);
  * a float32 forward turns TF32 off for its convs and matmuls: cuDNN's
    TF32 default keeps ~3 decimal digits and flips borderline rank reads;
  * ``build_model(..., train=True)`` is the trainable model: f32 master
    weights and explicit BN (``TrainConvBlock``), loaded from and exported to
    the unfolded tree (``load_jax_params``, ``export_params``);
  * ``import_torch_state`` maps an ultralytics state dict (``.pt``, read by
    ``core/weights.py::load_torch_checkpoint``) onto the same tree.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from manual_yolo_tpu_torch.core.device import full_f32
from manual_yolo_tpu_torch.core.weights import conv_hwio_to_oihw, conv_oihw_to_hwio, fold_batchnorm

BN_EPS = 1e-3  # ultralytics Conv uses BatchNorm2d(eps=0.001)
BN_MOMENTUM = 0.03
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


class ConvBlock(nn.Module):
    """Conv + bias (+ SiLU), BN folded. Counterpart of JAX ``conv_block``.

    The kernel is held in the compute dtype. A hidden layer (``act=True``)
    adds its bias and applies SiLU in the compute dtype; a head layer
    (``act=False``) adds an f32 bias, which promotes its output to f32.
    ``bn`` is accepted so that both block kinds share one constructor
    signature: with BN folded, every block has a bias.
    """

    def __init__(self, cin: int, cout: int, k: int = 1, s: int = 1,
                 act: bool = True, bn: bool = True, dtype: torch.dtype = torch.float32):
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


class TrainConvBlock(nn.Module):
    """Conv + BN (or bias) (+ SiLU) with f32 master weights: the JAX
    ``conv_block`` on an unfolded tree (``manual_yolo_tpu/models/yolov8.py:425-461``).

    The forward casts the kernel and the input to the compute dtype, as
    ``_conv2d`` does. BN runs in the master weights' dtype (f32) on the conv
    output: in train mode on the batch statistics, updating the running mean
    from the biased statistic and the running var from the unbiased one with
    momentum ``BN_MOMENTUM`` (what ``BNCtx`` records); in eval mode on the
    running statistics. A conv without BN (the Detect head's last) adds an
    f32 bias."""

    def __init__(self, cin: int, cout: int, k: int = 1, s: int = 1,
                 act: bool = True, bn: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = act
        self.compute_dtype = dtype
        self.conv = nn.Conv2d(cin, cout, k, s, padding=k // 2, bias=False)
        if bn:
            self.bn = nn.BatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM)
        else:
            self.bn = None
            self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        y = F.conv2d(x.to(self.compute_dtype), c.weight.to(self.compute_dtype),
                     None, c.stride, c.padding)
        if self.bn is not None:
            y = self.normalize(y.to(self.bn.weight.dtype))
        else:
            y = y + (self.bias.to(y.dtype) if self.act else self.bias)[:, None, None]
        return F.silu(y) if self.act else y

    def normalize(self, y: torch.Tensor) -> torch.Tensor:
        """BN of the conv output. On the card ``nn.BatchNorm2d``; on the CPU
        the JAX ``conv_block``'s own arithmetic (the batch mean, the mean
        squared deviation, ``(y - mean) * (gamma * rsqrt(var + eps)) +
        beta``): PyTorch's CPU kernel loses f32 precision in its batch
        statistics, 3.8e-5 of the largest output from f64 at a 640-px
        batch's stem (``tests/test_torch_train_model.py``), which moved
        SPPF's max pools off the card's (PERF.md §6). The running
        statistics move as the module moves them."""
        bn = self.bn
        if y.device.type != "cpu":
            return bn(y)
        if self.training:
            mean = y.mean(dim=(0, 2, 3))
            var = (y - mean[:, None, None]).square().mean(dim=(0, 2, 3))
            n = y.numel() // y.shape[1]
            with torch.no_grad():
                bn.running_mean.mul_(1 - bn.momentum).add_(mean, alpha=bn.momentum)
                bn.running_var.mul_(1 - bn.momentum).add_(var * (n / max(n - 1, 1)), alpha=bn.momentum)
                bn.num_batches_tracked.add_(1)
        else:
            mean, var = bn.running_mean, bn.running_var
        scale = bn.weight * torch.rsqrt(var + bn.eps)
        return (y - mean[:, None, None]) * scale[:, None, None] + bn.bias[:, None, None]


class Bottleneck(nn.Module):
    def __init__(self, c: int, shortcut: bool, conv):
        super().__init__()
        self.cv1 = conv(c, c, 3)
        self.cv2 = conv(c, c, 3)
        self.shortcut = shortcut

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


class C2f(nn.Module):
    """Split in half, grow by one bottleneck output per repeat, concat, fuse."""

    def __init__(self, cin: int, cout: int, n: int, shortcut: bool, conv):
        super().__init__()
        c = int(cout * 0.5)
        self.cv1 = conv(cin, 2 * c, 1)
        self.cv2 = conv((2 + n) * c, cout, 1)
        self.m = nn.ModuleList(Bottleneck(c, shortcut, conv) for _ in range(n))

    def forward(self, x):
        y = self.cv1(x)
        parts = list(y.chunk(2, dim=1))
        for m in self.m:
            parts.append(m(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    """1x1 conv, three chained k x k stride-1 max pools, concat, 1x1 conv."""

    def __init__(self, cin: int, cout: int, k: int, conv):
        super().__init__()
        c_ = cin // 2
        self.k = k
        self.cv1 = conv(cin, c_, 1)
        self.cv2 = conv(c_ * 4, cout, 1)

    def forward(self, x):
        y = self.cv1(x)
        pool = lambda v: F.max_pool2d(v, self.k, 1, self.k // 2)
        p1 = pool(y)
        p2 = pool(p1)
        p3 = pool(p2)
        return self.cv2(torch.cat([y, p1, p2, p3], dim=1))


class ClassifyHead(nn.Module):
    """1x1 conv to 1280, global average pool, linear. The matmul runs in the
    compute dtype and its f32 bias promotes the logits to f32, as in JAX."""

    def __init__(self, cin: int, nc: int, conv, dtype: torch.dtype, train: bool):
        super().__init__()
        self.compute_dtype = dtype
        self.conv = conv(cin, 1280, 1)
        self.linear = nn.Linear(1280, nc, dtype=torch.float32 if train else dtype)
        self.linear.requires_grad_(train)
        self.linear.bias = nn.Parameter(torch.zeros(nc), requires_grad=train)

    def forward(self, x):
        y = self.conv(x).mean(dim=(2, 3))  # global average pool
        w = self.linear.weight.to(self.compute_dtype)
        return F.linear(y.to(self.compute_dtype), w).float() + self.linear.bias


class Detect(nn.Module):
    """Per level: a box branch (4*REG_MAX DFL logits) and a class branch."""

    def __init__(self, spec: ModelSpec, conv):
        super().__init__()
        ch = spec.out_channels
        c2 = max(16, ch[0] // 4, REG_MAX * 4)
        c3 = max(ch[0], min(spec.nc, 100))

        def branch(c, cmid, cout):
            return nn.ModuleList([
                conv(c, cmid, 3),
                conv(cmid, cmid, 3),
                conv(cmid, cout, 1, act=False, bn=False),
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
    """The shared graph. ``layers.{i}`` mirrors ``params[i]`` of the JAX tree.

    ``train=False`` builds the inference model (BN folded, weights in the
    compute dtype); ``train=True`` the trainable one (``TrainConvBlock``s,
    f32 master weights, BN in train or eval mode as the module is)."""

    def __init__(self, spec: ModelSpec, compute_dtype: torch.dtype, train: bool = False):
        super().__init__()
        self.spec = spec
        self.compute_dtype = compute_dtype
        block = TrainConvBlock if train else ConvBlock

        def conv(cin, cout, k=1, s=1, act=True, bn=True):
            return block(cin, cout, k, s, act=act, bn=bn, dtype=compute_dtype)

        mods = []
        for layer in spec.layers:
            if layer.kind == "conv":
                mods.append(conv(layer.cin, layer.cout, layer.k, layer.s))
            elif layer.kind == "c2f":
                mods.append(C2f(layer.cin, layer.cout, layer.n, layer.shortcut, conv))
            elif layer.kind == "sppf":
                mods.append(SPPF(layer.cin, layer.cout, layer.k, conv))
            elif layer.kind == "classify":
                mods.append(ClassifyHead(layer.cin, layer.cout, conv, compute_dtype, train))
            elif layer.kind == "detect":
                mods.append(Detect(spec, conv))
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
        return full_f32() if self.compute_dtype == torch.float32 else contextlib.nullcontext()


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


def build_model(spec: ModelSpec, compute_dtype: torch.dtype = torch.float32,
                train: bool = False) -> _YOLOv8:
    cls = YOLOv8Classify if spec.variant == "classify" else YOLOv8Detect
    return cls(spec, compute_dtype, train)


def _state(module: nn.Module) -> Dict[str, torch.Tensor]:
    """Parameters and BN running statistics by name (not the batch counter)."""
    state = dict(module.named_parameters())
    state.update((n, b) for n, b in module.named_buffers() if not n.endswith("num_batches_tracked"))
    return state


def load_jax_params(module: _YOLOv8, params: List[Any]) -> _YOLOv8:
    """Copy a JAX-layout parameter tree (numpy leaves) into ``module``.

    Paths map one to one: ``params[i]["m"][0]["cv1"]`` is ``layers.i.m.0.cv1``.
    Conv kernels go HWIO -> OIHW, the classify linear (in, out) -> (out, in).
    A folded tree (``{"w", "b"}``) loads into the inference model; an
    unfolded one (``{"w", "bn": {gamma, beta, mean, var}}``) into the train
    model, ``bn`` going to ``weight``/``bias``/``running_mean``/``running_var``.
    Every parameter and BN statistic of the module must be set."""
    state = _state(module)
    loaded = set()

    def put(name: str, value):
        if name not in state:
            raise ValueError(f"{name}: not in the module")
        t = state[name]
        v = torch.from_numpy(np.array(value, dtype=np.float32, order="C"))
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"{name}: checkpoint shape {tuple(v.shape)} != {tuple(t.shape)}")
        with torch.no_grad():
            t.copy_(v)
        loaded.add(name)

    def rec(p, path: str):
        if isinstance(p, dict) and "w" in p:
            mod = module.get_submodule(path)
            if isinstance(mod, nn.Linear):
                put(f"{path}.weight", np.asarray(p["w"]).T)
                put(f"{path}.bias", p["b"])
                return
            put(f"{path}.conv.weight", conv_hwio_to_oihw(np.asarray(p["w"])))
            if "bn" not in p:
                put(f"{path}.bias", p["b"])
            elif getattr(mod, "bn", None) is None:
                raise ValueError(f"{path}: BN is not folded; run fold_params first")
            else:
                for k, name in (("gamma", "weight"), ("beta", "bias"),
                                ("mean", "running_mean"), ("var", "running_var")):
                    put(f"{path}.bn.{name}", p["bn"][k])
        elif isinstance(p, dict):
            for k, v in p.items():
                rec(v, f"{path}.{k}")
        elif isinstance(p, (list, tuple)):
            for i, v in enumerate(p):
                rec(v, f"{path}.{i}")

    for i, p in enumerate(params):
        rec(p, f"layers.{i}")
    missing = set(state) - loaded
    if missing:
        raise ValueError(f"parameters not in the checkpoint: {sorted(missing)[:5]}")
    return module


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _export_conv(m) -> Dict[str, Any]:
    w = np.ascontiguousarray(_np(m.conv.weight).transpose(2, 3, 1, 0))  # OIHW -> HWIO
    bn = getattr(m, "bn", None)
    if bn is None:
        return {"w": w, "b": _np(m.bias)}
    return {"w": w, "bn": {"gamma": _np(bn.weight), "beta": _np(bn.bias),
                           "mean": _np(bn.running_mean), "var": _np(bn.running_var)}}


def _export_pair(m) -> Dict[str, Any]:
    return {"cv1": _export_conv(m.cv1), "cv2": _export_conv(m.cv2)}


def export_params(module: _YOLOv8) -> List[Any]:
    """The inverse of ``load_jax_params``: the module's parameters (and BN
    statistics) as the JAX package's tree of f32 numpy arrays, HWIO kernels,
    ``bn`` dicts in a train model. ``save_params`` writes it as a checkpoint
    the JAX package reads; ``fold_params`` turns it into the inference tree."""
    out: List[Any] = []
    for layer, mod in zip(module.spec.layers, module.layers):
        if layer.kind == "conv":
            out.append(_export_conv(mod))
        elif layer.kind == "c2f":
            out.append(dict(_export_pair(mod), m=[_export_pair(b) for b in mod.m]))
        elif layer.kind == "sppf":
            out.append(_export_pair(mod))
        elif layer.kind == "classify":
            out.append({"conv": _export_conv(mod.conv),
                        "linear": {"w": np.ascontiguousarray(_np(mod.linear.weight).T),
                                   "b": _np(mod.linear.bias)}})
        elif layer.kind == "detect":
            out.append({k: [{str(j): _export_conv(c) for j, c in enumerate(branch)}
                            for branch in getattr(mod, k)] for k in ("box", "cls")})
        else:
            out.append({})
    return out


# ---------------------------------------------------------------------------
# torch state-dict import (ultralytics names)
# ---------------------------------------------------------------------------


def _import_conv(state: Dict[str, np.ndarray], prefix: str, fold: bool) -> Dict[str, Any]:
    w = state[prefix + "conv.weight"]
    if prefix + "bn.weight" in state:
        g, b = state[prefix + "bn.weight"], state[prefix + "bn.bias"]
        m, v = state[prefix + "bn.running_mean"], state[prefix + "bn.running_var"]
        if fold:
            wf, bf = fold_batchnorm(w, g, b, m, v, BN_EPS)
            return {"w": wf, "b": bf}
        return {"w": conv_oihw_to_hwio(w),
                "bn": {"gamma": g, "beta": b, "mean": m, "var": v}}
    p = {"w": conv_oihw_to_hwio(w)}
    if prefix + "conv.bias" in state:
        p["b"] = state[prefix + "conv.bias"]
    return p


def _import_plain_conv(state, prefix: str) -> Dict[str, Any]:
    """A bare nn.Conv2d (no BN), e.g. the last conv of each Detect branch."""
    p = {"w": conv_oihw_to_hwio(state[prefix + "weight"])}
    if prefix + "bias" in state:
        p["b"] = state[prefix + "bias"]
    return p


def _import_c2f(state, prefix: str, n: int, fold: bool) -> Dict[str, Any]:
    return {
        "cv1": _import_conv(state, prefix + "cv1.", fold),
        "cv2": _import_conv(state, prefix + "cv2.", fold),
        "m": [{"cv1": _import_conv(state, f"{prefix}m.{i}.cv1.", fold),
               "cv2": _import_conv(state, f"{prefix}m.{i}.cv2.", fold)} for i in range(n)],
    }


def import_torch_state(
    state: Dict[str, np.ndarray], spec: ModelSpec, fold: bool = True
) -> List[Any]:
    """An ultralytics flat state dict (``model.{i}.conv.weight``, ``.bn.*``,
    ``m.{j}.cv1.``, ``linear.weight``, a Detect head's ``cv2.{i}``/``cv3.{i}``)
    as the JAX-layout tree of numpy arrays that ``load_jax_params`` takes.
    Counterpart of ``manual_yolo_tpu/models/yolov8.py:292-340``.

    ``fold=True`` folds BatchNorm into conv biases (inference); ``fold=False``
    keeps ``bn`` dicts, for the trainer's warm start. A missing key raises
    ``KeyError``."""
    params: List[Any] = []
    for idx, layer in enumerate(spec.layers):
        pre = f"model.{idx}."
        if layer.kind == "conv":
            params.append(_import_conv(state, pre, fold))
        elif layer.kind == "c2f":
            params.append(_import_c2f(state, pre, layer.n, fold))
        elif layer.kind == "sppf":
            params.append({"cv1": _import_conv(state, pre + "cv1.", fold),
                           "cv2": _import_conv(state, pre + "cv2.", fold)})
        elif layer.kind == "classify":
            params.append({"conv": _import_conv(state, pre + "conv.", fold),
                           "linear": {"w": np.ascontiguousarray(state[pre + "linear.weight"].T),
                                      "b": state[pre + "linear.bias"]}})
        elif layer.kind == "detect":
            params.append({
                key: [{"0": _import_conv(state, f"{pre}{branch}.{i}.0.", fold),
                       "1": _import_conv(state, f"{pre}{branch}.{i}.1.", fold),
                       "2": _import_plain_conv(state, f"{pre}{branch}.{i}.2.")}
                      for i in range(len(spec.out_channels))]
                for key, branch in (("box", "cv2"), ("cls", "cv3"))})
        else:
            params.append({})
    return params


# ---------------------------------------------------------------------------
# Random init (training from scratch)
# ---------------------------------------------------------------------------


def _uniform(g: torch.Generator, shape, bound: float) -> np.ndarray:
    return ((torch.rand(shape, generator=g) * 2 - 1) * bound).numpy()


def _init_conv(g, cin, cout, k, with_bn=True) -> Dict[str, Any]:
    # kaiming-uniform fan_in, matching torch's default conv init behaviour
    p = {"w": _uniform(g, (k, k, cin, cout), math.sqrt(6.0 / (cin * k * k)))}
    if with_bn:
        p["bn"] = {"gamma": np.ones(cout, np.float32), "beta": np.zeros(cout, np.float32),
                   "mean": np.zeros(cout, np.float32), "var": np.ones(cout, np.float32)}
    else:
        p["b"] = np.zeros(cout, np.float32)
    return p


def _init_c2f(g, cin, cout, n) -> Dict[str, Any]:
    c = int(cout * 0.5)
    return {"cv1": _init_conv(g, cin, 2 * c, 1), "cv2": _init_conv(g, (2 + n) * c, cout, 1),
            "m": [{"cv1": _init_conv(g, c, c, 3), "cv2": _init_conv(g, c, c, 3)}
                  for _ in range(n)]}


def _init_detect(g, spec: ModelSpec) -> Dict[str, Any]:
    ch, nc = spec.out_channels, spec.nc
    c2 = max(16, ch[0] // 4, REG_MAX * 4)
    c3 = max(ch[0], min(nc, 100))
    box, cls = [], []
    for c, s in zip(ch, spec.strides):
        box.append({"0": _init_conv(g, c, c2, 3), "1": _init_conv(g, c2, c2, 3),
                    "2": _init_conv(g, c2, 4 * REG_MAX, 1, with_bn=False)})
        cls.append({"0": _init_conv(g, c, c3, 3), "1": _init_conv(g, c3, c3, 3),
                    "2": _init_conv(g, c3, nc, 1, with_bn=False)})
        # bias init per ultralytics Detect.bias_init: box bias 1.0,
        # cls bias log(5/nc/(640/stride)^2)
        box[-1]["2"]["b"] = np.full(4 * REG_MAX, 1.0, np.float32)
        cls[-1]["2"]["b"] = np.full(nc, math.log(5 / nc / (640 / s) ** 2), np.float32)
    return {"box": box, "cls": cls}


def init_params(g: torch.Generator, spec: ModelSpec) -> List[Any]:
    """Random-init a JAX-layout tree for ``spec``, drawn from ``g``: the
    distributions of ``manual_yolo_tpu/models/yolov8.py:130-237`` (JAX's
    random streams cannot be reproduced, so the values differ)."""
    params: List[Any] = []
    for layer in spec.layers:
        if layer.kind == "conv":
            params.append(_init_conv(g, layer.cin, layer.cout, layer.k))
        elif layer.kind == "c2f":
            params.append(_init_c2f(g, layer.cin, layer.cout, layer.n))
        elif layer.kind == "sppf":
            c_ = layer.cin // 2
            params.append({"cv1": _init_conv(g, layer.cin, c_, 1),
                           "cv2": _init_conv(g, c_ * 4, layer.cout, 1)})
        elif layer.kind == "classify":
            params.append({"conv": _init_conv(g, layer.cin, 1280, 1),
                           "linear": {"w": _uniform(g, (1280, layer.cout), math.sqrt(1.0 / 1280)),
                                      "b": np.zeros(layer.cout, np.float32)}})
        elif layer.kind == "detect":
            params.append(_init_detect(g, spec))
        else:  # upsample / concat — no params
            params.append({})
    return params


def flops_per_image(spec: ModelSpec, imgsz: int) -> int:
    """Analytic conv FLOPs (2 * MACs) of one forward at ``imgsz``: every
    conv and the classify linear; elementwise, pool and BN left out. Taps
    that fall on zero padding are not counted, as XLA's cost model counts
    them. Counterpart of ``manual_yolo_tpu/models/yolov8.py:600-648``, the
    same integer."""

    def taps(h: int, k: int, s: int) -> int:
        # in-bounds kernel taps summed over the 'same'-padded output
        # positions along one dimension (the count is separable)
        p = k // 2
        return sum(min(o * s - p + k, h) - max(o * s - p, 0) for o in range(h // s))

    def conv(h, w, cin, cout, k, s):
        return 2 * cin * cout * taps(h, k, s) * taps(w, k, s)

    total = 0
    sizes: List[Tuple[int, int]] = []  # each layer's output (h, w)
    h = w = imgsz
    for layer in spec.layers:
        if layer.kind == "conv":
            total += conv(h, w, layer.cin, layer.cout, layer.k, layer.s)
            h, w = h // layer.s, w // layer.s
        elif layer.kind == "c2f":
            c = layer.cout // 2
            total += conv(h, w, layer.cin, 2 * c, 1, 1)
            total += layer.n * 2 * conv(h, w, c, c, 3, 1)
            total += conv(h, w, (2 + layer.n) * c, layer.cout, 1, 1)
        elif layer.kind == "sppf":
            c_ = layer.cin // 2
            total += conv(h, w, layer.cin, c_, 1, 1)
            total += conv(h, w, 4 * c_, layer.cout, 1, 1)
        elif layer.kind == "upsample":
            h, w = h * 2, w * 2
        elif layer.kind == "concat":  # joins at the lateral source's size
            h, w = sizes[layer.src[1]]
        elif layer.kind == "classify":
            total += conv(h, w, layer.cin, 1280, 1, 1)
            total += 2 * 1280 * layer.cout
        elif layer.kind == "detect":
            c2 = max(16, spec.out_channels[0] // 4, REG_MAX * 4)
            c3 = max(spec.out_channels[0], min(spec.nc, 100))
            for src, cin in zip(layer.src, spec.out_channels):
                hh, ww = sizes[src]
                total += conv(hh, ww, cin, c2, 3, 1) + conv(hh, ww, c2, c2, 3, 1)
                total += conv(hh, ww, c2, 4 * REG_MAX, 1, 1)
                total += conv(hh, ww, cin, c3, 3, 1) + conv(hh, ww, c3, c3, 3, 1)
                total += conv(hh, ww, c3, spec.nc, 1, 1)
        sizes.append((h, w))
    return int(total)


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
