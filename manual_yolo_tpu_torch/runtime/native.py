"""ctypes bindings of the port's host C++ library (``csrc/host.cpp``).

Counterpart of the CTC part of ``manual_yolo_tpu/runtime/native.py``, plus
the PNG row unfilter of ``runtime/png.py``. The library is compiled by
``g++ -O2 -shared -fPIC`` at first use into ``manual_yolo_tpu_torch/_build/``
(git-ignored), named by a hash of the source and the flags, as
``ops/nms_kernel.py`` does with ``nvcc``. A failed build raises: nothing
falls back to the Python loops, which stay as the tests' plain twins
(``ops/ctc.py``: ``score_candidates_plain``, ``prefix_beam_decode_plain``;
``runtime/png.py``: ``_unfilter``).

The JAX package's frame ring, JSON log and segment encoders belong to the
live and serving loops, which are not ported yet.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "csrc" / "host.cpp"
BUILD_DIR = PKG_DIR / "_build"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")


def build() -> Path:
    """Compile the library if this source and these flags were not built yet."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"host_{tag}.so"
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the port's host library (csrc/host.cpp) needs it")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    p, i32, f32 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_float
    lib.ctc_score_multi.argtypes = [p, i32, i32, p, p, i32, p]
    lib.ctc_score_multi.restype = None
    lib.ctc_beam.argtypes = [p, i32, i32, i32, i32, f32, p, p, p, i32]
    lib.ctc_beam.restype = i32
    lib.png_unfilter.argtypes = [p, i32, i32, i32, p]
    lib.png_unfilter.restype = i32
    return lib


def _logp(logp: np.ndarray) -> np.ndarray:
    lp = np.ascontiguousarray(logp, np.float32)
    if lp.ndim != 2 or lp.shape[0] < 1 or lp.shape[1] < 1:
        raise ValueError(f"logp must be a non-empty (T, C) array, got shape {lp.shape}")
    return lp


def ctc_beam(logp: np.ndarray, beam_width: int = 8, topk: int = 6,
             prune_lp: float = -9.0) -> List[Tuple[Tuple[int, ...], float]]:
    """CTC prefix beam search over a (T, C) log-posterior: [(ids, log P)] best first."""
    lp = _logp(logp)
    t, c = lp.shape
    out_ids = np.empty((beam_width, t), np.int32)
    out_lens = np.empty((beam_width,), np.int32)
    out_scores = np.empty((beam_width,), np.float32)
    n = library().ctc_beam(lp.ctypes.data, t, c, beam_width, topk, prune_lp,
                           out_ids.ctypes.data, out_lens.ctypes.data,
                           out_scores.ctypes.data, t)
    return [(tuple(int(v) for v in out_ids[i, :out_lens[i]]), float(out_scores[i]))
            for i in range(n)]


def ctc_score_multi(logp: np.ndarray, candidates: Sequence[Sequence[int]]) -> np.ndarray:
    """CTC forward log P of every candidate id sequence under one (T, C) posterior."""
    lp = _logp(logp)
    t, c = lp.shape
    lens = np.asarray([len(s) for s in candidates], np.int32)
    flat = np.ascontiguousarray(
        np.concatenate([np.asarray(s, np.int32) for s in candidates])
        if lens.sum() else np.zeros((0,), np.int32), np.int32)
    if flat.size and (flat.min() < 1 or flat.max() >= c):
        raise ValueError(f"candidate ids must lie in 1..{c - 1}")
    out = np.empty((len(candidates),), np.float32)
    library().ctc_score_multi(lp.ctypes.data, t, c, flat.ctypes.data, lens.ctypes.data,
                              len(candidates), out.ctypes.data)
    return out


def png_unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo PNG row filters: ``raw`` holds ``height`` rows of a filter byte and
    ``stride`` bytes; returns (height, stride) uint8."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"image data has {raw.size} bytes, expected {height * (stride + 1)}")
    out = np.empty((height, stride), np.uint8)
    bad = library().png_unfilter(raw.ctypes.data, height, stride, bpp, out.ctypes.data)
    if bad:
        raise ValueError(f"bad PNG filter type {raw[(bad - 1) * (stride + 1)]} in row {bad - 1}")
    return out
