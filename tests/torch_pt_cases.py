"""Writes ultralytics-shaped ``.pt`` checkpoints without ultralytics.

A helper with no tests, for the ``.pt`` import tests and ``chip_smoke.py``
(so it imports torch and the port, never JAX). ``write_ultralytics_pt`` saves
a JAX-layout parameter tree (BN unfolded, as the trainers write it) the way
ultralytics stores ``best.pt``: a dict with ``model`` and ``ema`` module
objects (``ClassificationModel`` or ``DetectionModel`` over an
``nn.Sequential`` of ``Conv``/``C2f``/``SPPF``/``Classify``/``Detect``
layers), fp16 tensors, ``names``, ``yaml`` and ``train_args``. The stand-in
classes are registered under the ``ultralytics.nn.*`` module names only
while ``torch.save`` runs, so the pickle names them as ultralytics would.

    python tests/torch_pt_cases.py OUT.pt [NPZ]

writes ``weights/rank_classifier_matched.npz`` (or NPZ) as OUT.pt.
"""

from __future__ import annotations

import contextlib
import os
import sys
import types
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from manual_yolo_tpu_torch.core.serialization import load_params  # noqa: E402
from manual_yolo_tpu_torch.core.weights import conv_hwio_to_oihw  # noqa: E402
from manual_yolo_tpu_torch.models import yolov8  # noqa: E402
from manual_yolo_tpu_torch.models.classifier import RANK_NAMES_13  # noqa: E402

CLS_NPZ = os.path.join(REPO, "weights", "rank_classifier_matched.npz")


class ClassificationModel(nn.Module):
    pass


class DetectionModel(nn.Module):
    pass


class Conv(nn.Module):
    pass


class Bottleneck(nn.Module):
    pass


class C2f(nn.Module):
    pass


class SPPF(nn.Module):
    pass


class Classify(nn.Module):
    pass


class Detect(nn.Module):
    pass


class DFL(nn.Module):
    pass


class Concat(nn.Module):
    pass


STAND_INS = {
    "ultralytics.nn.tasks": (ClassificationModel, DetectionModel),
    "ultralytics.nn.modules.conv": (Conv, Concat),
    "ultralytics.nn.modules.block": (Bottleneck, C2f, SPPF, DFL),
    "ultralytics.nn.modules.head": (Classify, Detect),
}


@contextlib.contextmanager
def ultralytics_names():
    """Make the stand-ins pickle as ``ultralytics.nn.*`` classes, for the
    duration of the block (fake modules in ``sys.modules``)."""
    added, saved = [], {}
    for modname, classes in STAND_INS.items():
        parts = modname.split(".")
        for i in range(1, len(parts) + 1):
            name = ".".join(parts[:i])
            if name not in sys.modules:
                sys.modules[name] = types.ModuleType(name)
                added.append(name)
        for cls in classes:
            saved[cls] = cls.__module__
            cls.__module__ = modname
            setattr(sys.modules[modname], cls.__name__, cls)
    try:
        yield
    finally:
        for cls, mod in saved.items():
            cls.__module__ = mod
        for name in added:
            del sys.modules[name]


def _conv(p: Dict[str, Any]) -> Conv:
    w = torch.from_numpy(np.ascontiguousarray(conv_hwio_to_oihw(np.asarray(p["w"], np.float32))))
    m = Conv()
    m.conv = nn.Conv2d(w.shape[1], w.shape[0], w.shape[2], padding=w.shape[2] // 2, bias=False)
    m.bn = nn.BatchNorm2d(w.shape[0], eps=1e-3, momentum=0.03)
    m.act = nn.SiLU()
    with torch.no_grad():
        m.conv.weight.copy_(w)
        for key, name in (("gamma", "weight"), ("beta", "bias")):
            getattr(m.bn, name).copy_(torch.from_numpy(np.asarray(p["bn"][key], np.float32)))
        m.bn.running_mean.copy_(torch.from_numpy(np.asarray(p["bn"]["mean"], np.float32)))
        m.bn.running_var.copy_(torch.from_numpy(np.asarray(p["bn"]["var"], np.float32)))
    return m


def _plain_conv(p: Dict[str, Any]) -> nn.Conv2d:
    w = torch.from_numpy(np.ascontiguousarray(conv_hwio_to_oihw(np.asarray(p["w"], np.float32))))
    m = nn.Conv2d(w.shape[1], w.shape[0], w.shape[2])
    with torch.no_grad():
        m.weight.copy_(w)
        m.bias.copy_(torch.from_numpy(np.asarray(p["b"], np.float32)))
    return m


def _pair(cls, p: Dict[str, Any]) -> nn.Module:
    m = cls()
    m.cv1, m.cv2 = _conv(p["cv1"]), _conv(p["cv2"])
    return m


def build_module(params: List[Any], spec: yolov8.ModelSpec, names: Dict[int, str],
                 scale: str) -> nn.Module:
    """The ultralytics module tree of an unfolded JAX-layout tree (f32)."""
    layers = []
    for layer, p in zip(spec.layers, params):
        if layer.kind == "conv":
            layers.append(_conv(p))
        elif layer.kind == "c2f":
            m = _pair(C2f, p)
            m.m = nn.ModuleList(_pair(Bottleneck, b) for b in p["m"])
            layers.append(m)
        elif layer.kind == "sppf":
            m = _pair(SPPF, p)
            m.m = nn.MaxPool2d(5, 1, 2)
            layers.append(m)
        elif layer.kind == "classify":
            m = Classify()
            m.conv = _conv(p["conv"])
            m.pool = nn.AdaptiveAvgPool2d(1)
            m.drop = nn.Dropout(0.0)
            lw = np.asarray(p["linear"]["w"], np.float32)
            m.linear = nn.Linear(lw.shape[0], lw.shape[1])
            with torch.no_grad():
                m.linear.weight.copy_(torch.from_numpy(np.ascontiguousarray(lw.T)))
                m.linear.bias.copy_(torch.from_numpy(np.asarray(p["linear"]["b"], np.float32)))
            layers.append(m)
        elif layer.kind == "detect":
            m = Detect()
            for key, branch in (("box", "cv2"), ("cls", "cv3")):
                setattr(m, branch, nn.ModuleList(
                    nn.Sequential(_conv(b["0"]), _conv(b["1"]), _plain_conv(b["2"]))
                    for b in p[key]))
            m.dfl = DFL()
            m.dfl.conv = nn.Conv2d(yolov8.REG_MAX, 1, 1, bias=False).requires_grad_(False)
            with torch.no_grad():
                m.dfl.conv.weight.copy_(torch.arange(yolov8.REG_MAX, dtype=torch.float32)
                                        .view(1, yolov8.REG_MAX, 1, 1))
            m.nc, m.nl, m.reg_max = spec.nc, len(spec.out_channels), yolov8.REG_MAX
            layers.append(m)
        elif layer.kind == "upsample":
            layers.append(nn.Upsample(scale_factor=2.0, mode="nearest"))
        else:
            layers.append(Concat())
    top = ClassificationModel() if spec.variant == "classify" else DetectionModel()
    top.model = nn.Sequential(*layers)
    top.names = dict(names)
    top.yaml = {"nc": spec.nc, "scale": scale, "backbone": [], "head": []}
    top.stride = torch.tensor(spec.strides if spec.variant == "detect" else (32,), dtype=torch.float32)
    return top


def write_ultralytics_pt(path: str, params: List[Any], spec: yolov8.ModelSpec,
                         names: Optional[Dict[int, str]] = None, ema: str = "same",
                         extra: Optional[Dict[str, Any]] = None, protocol: int = 2) -> None:
    """Save ``params`` (unfolded JAX-layout tree) as an ultralytics ``.pt``
    with fp16 tensors. ``ema``: "same" puts the weights in both ``model`` and
    ``ema``; "model_off" puts them in ``ema`` and a perturbed copy in
    ``model`` (so a loader that ignores ``ema`` reads other weights);
    "none" saves ``ema=None`` with the weights in ``model``. ``extra``
    entries are added to the checkpoint dict; ``protocol`` is the pickle
    protocol (torch.save's default, 2, pickles bytes through ``_codecs``)."""
    names = dict(names if names is not None else enumerate(RANK_NAMES_13[:spec.nc]))
    good = build_module(params, spec, names, spec.scale).half()
    model = good
    if ema == "model_off":
        model = build_module(params, spec, names, spec.scale).half()
        with torch.no_grad():
            for t in model.parameters():
                t.add_(0.25)
    ckpt = {
        "date": "2024-01-01T00:00:00", "version": "8.0.0", "epoch": -1,
        "best_fitness": None, "model": model, "ema": None if ema == "none" else good,
        "updates": 0, "optimizer": None,
        "train_args": {"task": "classify" if spec.variant == "classify" else "detect",
                       "imgsz": 64 if spec.variant == "classify" else 640, "epochs": 50,
                       "model": f"yolov8{spec.scale}{'-cls' if spec.variant == 'classify' else ''}.pt"},
        "train_metrics": {}, "train_results": {},
    }
    ckpt.update(extra or {})
    with ultralytics_names():
        torch.save(ckpt, path, pickle_protocol=protocol)


def write_from_npz(path: str, npz: str = CLS_NPZ, **kwargs) -> None:
    """A native classifier checkpoint (e.g. the committed rank classifier) as
    an ultralytics ``.pt``; its f16 values survive the fp16 tensors exactly."""
    params, meta = load_params(npz)
    sp = meta.get("spec", {})
    spec = yolov8.build_spec(sp.get("variant", "classify"), sp.get("scale", "n"),
                             int(sp.get("nc", 13)))
    names = {int(k): v for k, v in meta.get("names", {}).items()} or None
    write_ultralytics_pt(path, params, spec, names, **kwargs)


if __name__ == "__main__":
    write_from_npz(sys.argv[1], *sys.argv[2:3])
    print(f"wrote {sys.argv[1]}")
