"""Reader for the repo's native ``.npz`` checkpoints.

Counterpart of ``manual_yolo_tpu/core/serialization.py`` (reading side only).
The file is a JSON structure template (``__struct__``, uint8 bytes) plus the
numbered leaf arrays ``a0, a1, ...``; the template rebuilds the nested
dict/list/tuple tree. No pickle is involved.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np


def _decode(node, leaves):
    t = node["t"]
    if t == "d":
        return {k: _decode(v, leaves) for k, v in node["k"].items()}
    if t in ("l", "t"):
        seq = [_decode(v, leaves) for v in node["v"]]
        return seq if t == "l" else tuple(seq)
    return leaves[node["i"]]


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
