"""Checkpoint import (ultralytics ``.pt`` pickles) and weight layout helpers.

Counterpart of ``manual_yolo_tpu/core/weights.py``. The reference stack
stores its weights as torch pickles written by ultralytics (e.g.
``rank_classifier.pt``). ``load_torch_checkpoint`` reads one without
ultralytics installed: an unpickler resolves only the allow-listed machinery
that rebuilds tensors and plain containers, and every other class becomes an
inert stub whose ``__setstate__`` keeps the attribute dict. Torch's storage
layer still materialises the tensors, so the module tree (``_modules``,
``_parameters``, ``_buffers``) gives a flat ``{qualified_name: ndarray}``
state plus the class names, the architecture yaml and the train args.

A pickle's ``REDUCE`` of anything off the allow-list (``os.system``,
``builtins.exec``, ...) calls a stub class, which stores its arguments and
runs nothing. Nothing on the list unpickles or calls its arguments; this is
where the port's list differs from the JAX package's, which still resolves
``torch.storage._load_from_bytes`` (a ``torch.load`` with the standard
unpickler).

The native checkpoints store conv kernels in the JAX layout (HWIO); the
port's convs take OIHW.
"""

from __future__ import annotations

import pickle
import sys
import types
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np


class _Stub:
    """Placeholder for unimportable classes inside a torch pickle."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state


_STUB_CACHE: Dict[Any, type] = {}

_SAFE_BUILTINS = {
    "set", "frozenset", "list", "dict", "tuple", "complex", "bytearray",
    "slice", "range", "bool", "int", "float", "str", "bytes",
}


def _resolve_allowed(module: str, name: str):
    """Resolve ``module.name`` only if it is on the reconstruction allow-list.

    A torch pickle is arbitrary code execution by default: REDUCE can call any
    importable callable (``os.system``, ``builtins.exec``). Only the machinery
    needed to rebuild tensors and ndarrays, plus benign containers, resolves;
    everything else is stubbed (the stub's ``__setstate__`` still captures
    attributes, so metadata like ultralytics module objects survives as inert
    attribute bags). Returns the object, or None if not allowed.
    """
    if module == "collections" and name in {"OrderedDict", "deque"}:
        import collections

        return getattr(collections, name)
    if module == "builtins" and name in _SAFE_BUILTINS:
        import builtins

        return getattr(builtins, name)
    if module in ("numpy", "numpy.core.multiarray", "numpy._core.multiarray"):
        if name in {"ndarray", "dtype", "_reconstruct", "scalar"}:
            __import__(module)
            return getattr(sys.modules[module], name)
        return None
    if module == "argparse" and name == "Namespace":
        import argparse

        return argparse.Namespace
    if module == "pathlib" and name in {
        "Path", "PosixPath", "PurePosixPath", "PureWindowsPath",
    }:
        import pathlib

        return getattr(pathlib, name)
    if module.startswith("torch"):
        import torch

        if module == "torch._utils" and name.startswith("_rebuild_"):
            return getattr(torch._utils, name)
        if module == "torch.nn.parameter" and name == "Parameter":
            return torch.nn.Parameter
        # not torch.storage._load_from_bytes: it calls torch.load on its
        # argument with the standard unpickler, so a nested pickle would run
        # whatever it names; torch.save's zip files restore storages through
        # persistent_load and never call it
        if module == "torch.storage" and name in {"TypedStorage", "UntypedStorage"}:
            import torch.storage

            return getattr(torch.storage, name)
        if module == "torch.serialization" and name == "_get_layout":
            import torch.serialization

            return torch.serialization._get_layout
        if module == "torch":
            obj = getattr(torch, name, None)
            if (
                name in {"Tensor", "Size", "device"}
                or name.endswith("Storage")
                or isinstance(obj, torch.dtype)
            ):
                return obj
        return None
    return None


class _StubUnpickler(pickle.Unpickler):
    def find_class(self, module, name):  # noqa: D102
        try:
            obj = _resolve_allowed(module, name)
        except Exception:
            obj = None
        if obj is not None:
            return obj
        key = (module, name)
        if key not in _STUB_CACHE:
            _STUB_CACHE[key] = type(name, (_Stub,), {"__module__": module})
        return _STUB_CACHE[key]


def _stub_pickle_module() -> types.ModuleType:
    mod = types.ModuleType("manual_yolo_tpu_torch_stub_pickle")
    mod.Unpickler = _StubUnpickler
    mod.load = lambda f, **k: _StubUnpickler(f).load()
    mod.Pickler = pickle.Pickler
    mod.dump = pickle.dump
    mod.dumps = pickle.dumps
    mod.loads = pickle.loads
    return mod


def _flatten_module(obj, prefix: str = "") -> Dict[str, np.ndarray]:
    """Walk a (stubbed) torch module tree collecting params and buffers as
    float32 numpy (ultralytics saves ``best.pt`` in fp16)."""
    out: Dict[str, np.ndarray] = {}
    for attr in ("_parameters", "_buffers"):
        for k, v in (getattr(obj, attr, None) or {}).items():
            if v is None:
                continue
            arr = v.detach().cpu().float().numpy() if hasattr(v, "detach") else np.asarray(v)
            out[prefix + k] = arr
    for k, v in (getattr(obj, "_modules", None) or {}).items():
        if v is not None:
            out.update(_flatten_module(v, prefix + k + "."))
    return out


@dataclass
class TorchCheckpoint:
    """An imported ultralytics checkpoint.

    Attributes:
      state: flat ``{name: float32 ndarray}`` (torch layout, e.g. conv OIHW).
      names: class-id -> class-name mapping (``model.names`` in ultralytics).
      arch_yaml: the ultralytics architecture dict (backbone/head spec).
      train_args: hyperparameters the checkpoint was trained with.
      raw: the full unpickled top-level dict (stubbed objects).
    """

    state: Dict[str, np.ndarray]
    names: Dict[int, str] = field(default_factory=dict)
    arch_yaml: Optional[dict] = None
    train_args: Optional[dict] = None
    raw: Any = None


def load_torch_checkpoint(path: str, prefer_ema: bool = True) -> TorchCheckpoint:
    """Import an ultralytics ``.pt`` checkpoint into numpy.

    Uses the EMA weights when present and not None (ultralytics saves
    ``best.pt`` with both ``model`` and ``ema``; inference uses the ema copy).
    """
    import torch

    ckpt = torch.load(
        path, map_location="cpu", pickle_module=_stub_pickle_module(), weights_only=False
    )
    model = None
    if isinstance(ckpt, dict):
        if prefer_ema and ckpt.get("ema") is not None:
            model = ckpt["ema"]
        elif ckpt.get("model") is not None:
            model = ckpt["model"]
    if model is None:
        model = ckpt

    state = _flatten_module(model)
    names = dict(getattr(model, "names", {}) or {})
    arch = getattr(model, "yaml", None)
    targs = ckpt.get("train_args") if isinstance(ckpt, dict) else None
    return TorchCheckpoint(state=state, names=names, arch_yaml=arch, train_args=targs, raw=ckpt)


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
