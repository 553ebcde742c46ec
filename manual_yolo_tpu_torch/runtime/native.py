"""ctypes bindings of the port's host C++ library (``csrc/host.cpp``).

Counterpart of ``manual_yolo_tpu/runtime/native.py`` less its delta-codec
encoders (``nibble_encode``, ``tribit_encode``, ``seg_encode``): the CTC
beam and rescore, the serving path's frame ring, JSONL appender and pixel
loops (``bgra_to_bgr``, ``crop_u8``, ``decimate_u8_into``, ``resize_u8``)
and the libc ``memcmp`` compare, plus the PNG row unfilter of
``runtime/png.py`` and the detector trainer's ``hsv_jitter_u8`` and
``warp_affine_u8`` (their twins are in ``train/data.py``). The library is
compiled by ``g++ -O2 -ffp-contract=off -shared -fPIC`` at first use into ``manual_yolo_tpu_torch/_build/``
(git-ignored), named by a hash of the source and the flags, as
``ops/nms_kernel.py`` does with ``nvcc``. A failed build raises: nothing
falls back to the Python loops, which stay as the tests' plain twins
(``ops/ctc.py``: ``score_candidates_plain``, ``prefix_beam_decode_plain``;
``runtime/png.py``: ``_unfilter``; here: ``PlainFrameRing``,
``PlainJsonLog``, ``bgra_to_bgr_plain``, ``crop_u8_plain``,
``decimate_u8_plain``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from collections import deque
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "csrc" / "host.cpp"
BUILD_DIR = PKG_DIR / "_build"
# no FMA contraction: the f32 pixel loops repeat their numpy twins' roundings
GXX_FLAGS = ("-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC")


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
    i64 = ctypes.c_int64
    lib.fr_create.argtypes = [i32, i64]
    lib.fr_create.restype = p
    lib.fr_destroy.argtypes = [p]
    lib.fr_destroy.restype = None
    lib.fr_push.argtypes = [p, p]
    lib.fr_push.restype = i64
    lib.fr_pop.argtypes = [p, p, i32]
    lib.fr_pop.restype = i64
    lib.fr_dropped.argtypes = [p]
    lib.fr_dropped.restype = i64
    lib.fr_available.argtypes = [p]
    lib.fr_available.restype = i64
    lib.jl_open.argtypes = [ctypes.c_char_p]
    lib.jl_open.restype = p
    lib.jl_append.argtypes = [p, ctypes.c_char_p, i64]
    lib.jl_append.restype = i64
    lib.jl_lines.argtypes = [p]
    lib.jl_lines.restype = i64
    lib.jl_close.argtypes = [p]
    lib.jl_close.restype = None
    lib.bgra_to_bgr.argtypes = [p, p, i64]
    lib.bgra_to_bgr.restype = None
    lib.crop_u8.argtypes = [p, i32, i32, i32, i32, i32, i32, p]
    lib.crop_u8.restype = i32
    lib.decimate_u8.argtypes = [p, i32, i32, i32, p, i32, i32]
    lib.decimate_u8.restype = None
    lib.resize_u8.argtypes = [p, i32, i32] + [p] * 8 + [p, i32, i32]
    lib.resize_u8.restype = None
    lib.hsv_jitter_u8.argtypes = [p, i64, p, p]
    lib.hsv_jitter_u8.restype = None
    lib.warp_affine_u8.argtypes = [p, i32, i32, p, i32, i32, p]
    lib.warp_affine_u8.restype = None
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


# ---------------------------------------------------------------------------
# Serving helpers


class FrameRing:
    """Single-producer single-consumer ring of fixed-shape frames; when full,
    a push overwrites the oldest (live-feed policy)."""

    def __init__(self, slots: int, frame_shape, dtype=np.uint8):
        self.shape = tuple(frame_shape)
        self.dtype = np.dtype(dtype)
        self.slot_bytes = int(np.prod(self.shape)) * self.dtype.itemsize
        self._lib = library()
        self._h = self._lib.fr_create(slots, self.slot_bytes)
        if not self._h:
            raise MemoryError(f"fr_create could not allocate {slots} x {self.slot_bytes} bytes")

    def _handle(self):
        if not self._h:
            raise ValueError("FrameRing is closed")
        return self._h

    def push(self, frame: np.ndarray) -> int:
        """Copy ``frame`` in; returns its sequence number."""
        frame = np.ascontiguousarray(frame, self.dtype)
        if frame.shape != self.shape:
            raise ValueError(f"frame shape {frame.shape} != ring shape {self.shape}")
        return int(self._lib.fr_push(self._handle(), frame.ctypes.data))

    def pop(self, latest: bool = True) -> Optional[np.ndarray]:
        """The newest frame (dropping older ones) or, with ``latest=False``,
        the oldest; None when empty."""
        out = np.empty(self.shape, self.dtype)
        seq = self._lib.fr_pop(self._handle(), out.ctypes.data, 1 if latest else 0)
        return out if seq >= 0 else None

    @property
    def dropped(self) -> int:
        return int(self._lib.fr_dropped(self._handle()))

    @property
    def available(self) -> int:
        return int(self._lib.fr_available(self._handle()))

    def close(self) -> None:
        if self._h:
            self._lib.fr_destroy(self._h)
            self._h = None


class PlainFrameRing:
    """Plain twin of :class:`FrameRing` (a bounded deque), for the tests."""

    def __init__(self, slots: int, frame_shape, dtype=np.uint8):
        self.shape = tuple(frame_shape)
        self.dtype = np.dtype(dtype)
        self._q = deque(maxlen=slots)
        self.dropped = 0

    def push(self, frame: np.ndarray) -> int:
        if len(self._q) == self._q.maxlen:
            self.dropped += 1
        self._q.append(np.array(frame, self.dtype))
        return len(self._q)

    def pop(self, latest: bool = True) -> Optional[np.ndarray]:
        if not self._q:
            return None
        if latest:
            self.dropped += len(self._q) - 1
            item = self._q[-1]
            self._q.clear()
            return item
        return self._q.popleft()

    @property
    def available(self) -> int:
        return len(self._q)


class JsonLog:
    """Append-only JSONL file: each line goes out in one ``write``."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._lib = library()
        self._h = self._lib.jl_open(path.encode())
        if not self._h:
            raise OSError(f"jl_open could not open {path} for appending")

    def append(self, line: str) -> int:
        """Append ``line`` and a newline; returns the bytes written."""
        if not self._h:
            raise ValueError(f"JsonLog {self.path} is closed")
        raw = line.encode()
        n = int(self._lib.jl_append(self._h, raw, len(raw)))
        if n != len(raw) + 1:
            raise OSError(f"jl_append wrote {n} of {len(raw) + 1} bytes to {self.path}")
        return n

    @property
    def lines(self) -> int:
        return int(self._lib.jl_lines(self._h))

    def close(self) -> None:
        if self._h:
            self._lib.jl_close(self._h)
            self._h = None


class PlainJsonLog:
    """Plain twin of :class:`JsonLog` (a text file in append mode), for the tests."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a", encoding="utf-8")
        self.lines = 0

    def append(self, line: str) -> int:
        self._f.write(line + "\n")
        self._f.flush()
        self.lines += 1
        return len(line.encode()) + 1

    def close(self) -> None:
        self._f.close()


def _u8_image(img: np.ndarray, channels: int, name: str) -> np.ndarray:
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != channels:
        raise ValueError(f"{name} takes (H, W, {channels}) uint8, got {img.dtype} {img.shape}")
    return img


def bgra_to_bgr(frame_bgra: np.ndarray) -> np.ndarray:
    """(H, W, 4) uint8 BGRA -> (H, W, 3) BGR."""
    src = _u8_image(frame_bgra, 4, "bgra_to_bgr")
    h, w = src.shape[:2]
    dst = np.empty((h, w, 3), np.uint8)
    library().bgra_to_bgr(src.ctypes.data, dst.ctypes.data, h * w)
    return dst


def bgra_to_bgr_plain(frame_bgra: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(frame_bgra[..., :3])


def crop_u8(img: np.ndarray, y1: int, x1: int, y2: int, x2: int) -> np.ndarray:
    """Rows [y1, y2) and columns [x1, x2) of an (H, W, 3) uint8 image, clamped
    to it, as a new contiguous array; (0, 0, 3) when nothing is left."""
    src = _u8_image(img, 3, "crop_u8")
    h, w = src.shape[:2]
    y1c, x1c, y2c, x2c = max(0, y1), max(0, x1), min(h, y2), min(w, x2)
    if y2c <= y1c or x2c <= x1c:
        return np.zeros((0, 0, 3), np.uint8)
    dst = np.empty((y2c - y1c, x2c - x1c, 3), np.uint8)
    library().crop_u8(src.ctypes.data, h, w, y1c, x1c, y2c, x2c, dst.ctypes.data)
    return dst


def crop_u8_plain(img: np.ndarray, y1: int, x1: int, y2: int, x2: int) -> np.ndarray:
    h, w = img.shape[:2]
    y1c, x1c, y2c, x2c = max(0, y1), max(0, x1), min(h, y2), min(w, x2)
    if y2c <= y1c or x2c <= x1c:
        return np.zeros((0, 0, 3), np.uint8)
    return np.ascontiguousarray(img[y1c:y2c, x1c:x2c])


def decimate_u8_into(frame: np.ndarray, dst: np.ndarray, s: int) -> bool:
    """``dst[y, x] = frame[s*y + (s-1)//2, s*x + (s-1)//2]``: cv2's
    INTER_LINEAR resize of an (H, W, 3) uint8 frame by an odd integer factor
    s >= 3, byte for byte (the sample positions are integral). Returns False,
    writing nothing, when the inputs do not qualify (even or small ``s``,
    sizes that are not exactly s:1, non-contiguous arrays)."""
    if s % 2 == 0 or s < 3 or frame.dtype != np.uint8 or dst.dtype != np.uint8:
        return False
    if frame.ndim != 3 or dst.ndim != 3 or frame.shape[2] != 3 or dst.shape[2] != 3:
        return False
    oh, ow = dst.shape[:2]
    h, w = frame.shape[:2]
    if oh < 1 or ow < 1 or h != oh * s or w != ow * s:
        return False
    if not (frame.flags.c_contiguous and dst.flags.c_contiguous):
        return False
    library().decimate_u8(frame.ctypes.data, w, s, (s - 1) // 2, dst.ctypes.data, oh, ow)
    return True


def decimate_u8_plain(frame: np.ndarray, s: int) -> np.ndarray:
    off = (s - 1) // 2
    oh, ow = frame.shape[0] // s, frame.shape[1] // s
    return np.ascontiguousarray(frame[off:off + s * oh:s, off:off + s * ow:s])


def resize_u8(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """cv2's uint8 INTER_LINEAR resize of an (H, W) or (H, W, C) image to
    ``out_hw``, byte for byte; ``ops/image.py::cv_resize_u8`` is its plain
    twin and computes the same fixed-point tables."""
    x = np.ascontiguousarray(img)
    if x.dtype != np.uint8 or x.ndim not in (2, 3) or 0 in x.shape:
        raise ValueError(f"resize_u8 takes a non-empty (H, W[, C]) uint8 image, got {x.dtype} {x.shape}")
    h, w = x.shape[:2]
    out_h, out_w = out_hw
    if out_h < 1 or out_w < 1:
        raise ValueError(f"resize_u8 needs a positive output size, got {out_hw}")
    if (out_h, out_w) == (h, w):
        return x.copy()
    c = 1 if x.ndim == 2 else x.shape[2]
    out = np.empty((out_h, out_w) + x.shape[2:], np.uint8)
    # the tables stay referenced here until the call returns, whatever the cache evicts
    tables, addresses = _resize_tables(h, w, out_h, out_w)
    library().resize_u8(x.ctypes.data, w, c, *addresses, out.ctypes.data, out_h, out_w)
    return out


def hsv_jitter_u8(img: np.ndarray, luts: np.ndarray) -> np.ndarray:
    """cv2's uint8 BGR -> HSV, each channel through its row of ``luts``
    ((3, 256) uint8), HSV -> BGR; ``train/data.py::hsv_jitter_u8_plain`` is
    its twin."""
    x = _u8_image(img, 3, "hsv_jitter_u8")
    t = np.ascontiguousarray(luts, np.uint8)
    if t.shape != (3, 256):
        raise ValueError(f"hsv_jitter_u8 needs (3, 256) tables, got {t.shape}")
    out = np.empty_like(x)
    library().hsv_jitter_u8(x.ctypes.data, x.shape[0] * x.shape[1], t.ctypes.data, out.ctypes.data)
    return out


def warp_affine_u8(img: np.ndarray, inverse: np.ndarray, size: int, border: int) -> np.ndarray:
    """Bilinear warp of an (H, W, 3) uint8 image to (size, size, 3) through the
    inverted 2x3 matrix ``inverse`` (f32); ``train/data.py::warp_affine_u8_plain``
    is its twin."""
    x = _u8_image(img, 3, "warp_affine_u8")
    a = np.ascontiguousarray(inverse, np.float32)
    if a.shape != (2, 3) or size < 1:
        raise ValueError(f"warp_affine_u8 needs a 2x3 matrix and a positive size, got {a.shape}, {size}")
    out = np.empty((size, size, 3), np.uint8)
    library().warp_affine_u8(x.ctypes.data, x.shape[0], x.shape[1], a.ctypes.data, size,
                             int(border), out.ctypes.data)
    return out


@functools.lru_cache(maxsize=4096)
def _resize_tables(h: int, w: int, out_h: int, out_w: int):
    """The int32 tables of one resize geometry and their addresses, cached:
    crop sizes repeat from tick to tick. The cache entry keeps the arrays
    alive for as long as their addresses are handed out."""
    from manual_yolo_tpu_torch.ops.image import cv_linear_tables

    tables = tuple(np.ascontiguousarray(t, np.int32) for t in cv_linear_tables(h, w, out_h, out_w))
    return tables, tuple(t.ctypes.data for t in tables)


@functools.lru_cache(maxsize=None)
def _memcmp():
    libc = ctypes.CDLL(None)
    libc.memcmp.restype = ctypes.c_int
    libc.memcmp.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
    return libc.memcmp


def arrays_equal(a: np.ndarray, b: np.ndarray) -> bool:
    """Byte equality by libc ``memcmp``, which stops at the first differing
    byte (``np.array_equal`` always builds a full comparison array). Arrays
    of another shape or dtype are unequal; non-contiguous ones go through
    ``np.array_equal``."""
    if a is b:
        return True
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not (a.flags.c_contiguous and b.flags.c_contiguous):
        return bool(np.array_equal(a, b))
    return _memcmp()(a.ctypes.data, b.ctypes.data, a.nbytes) == 0
