"""The repo's native ``.npz`` checkpoints: reader and writer.

Counterpart of ``manual_yolo_tpu/core/serialization.py``. The file is a JSON
structure template (``__struct__``, uint8 bytes) plus the numbered leaf
arrays ``a0, a1, ...``; the template rebuilds the nested dict/list/tuple
tree. No pickle is involved. A file either package writes loads in the
other.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np


def _encode(tree, leaves: list):
    if isinstance(tree, dict):
        return {"t": "d", "k": {k: _encode(v, leaves) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {
            "t": "l" if isinstance(tree, list) else "t",
            "v": [_encode(v, leaves) for v in tree],
        }
    leaves.append(np.asarray(tree))
    return {"t": "a", "i": len(leaves) - 1}


def _decode(node, leaves):
    t = node["t"]
    if t == "d":
        return {k: _decode(v, leaves) for k, v in node["k"].items()}
    if t in ("l", "t"):
        seq = [_decode(v, leaves) for v in node["v"]]
        return seq if t == "l" else tuple(seq)
    return leaves[node["i"]]


def save_params(
    path: str, params: Any, meta: Optional[Dict[str, Any]] = None, dtype=np.float16
):
    """Save a tree (nested dict/list/tuple of numpy arrays) to ``path`` (.npz).

    float32 leaves are stored as ``dtype`` (f16 by default; ``None`` keeps
    them). The file is written next to ``path`` and renamed over it, so a
    reader never sees half a checkpoint."""
    leaves: list = []
    struct = _encode(params, leaves)
    payload = {"__struct__": np.frombuffer(
        json.dumps({"struct": struct, "meta": meta or {}}).encode(), dtype=np.uint8
    )}
    for i, a in enumerate(leaves):
        if dtype is not None and a.dtype == np.float32:
            a = a.astype(dtype)
        payload[f"a{i}"] = a
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def resolve_weight_path(path: str) -> str:
    """Resolve a relative weight path against the repo root when it does not
    exist in the CWD, so the CLI defaults (``weights/<name>.npz``) work from
    any directory."""
    if not path or os.path.isabs(path) or os.path.exists(path):
        return path
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    cand = os.path.join(root, path)
    return cand if os.path.exists(cand) else path


def load_params(path: str, dtype=np.float32) -> Tuple[Any, Dict[str, Any]]:
    """Load a params tree of numpy arrays; returns (params, meta).

    Float leaves are cast to ``dtype`` (the files store f16)."""
    path = resolve_weight_path(path)
    with np.load(path, allow_pickle=False) as z:
        header = json.loads(bytes(z["__struct__"].tobytes()).decode())
        n = sum(1 for k in z.files if k.startswith("a"))
        leaves = []
        for i in range(n):
            a = z[f"a{i}"]
            if dtype is not None and a.dtype in (np.float16, np.float32, np.float64):
                a = a.astype(dtype)
            leaves.append(a)
    params = _decode(header["struct"], leaves)
    return params, header.get("meta", {})
