"""Greedy-NMS keep mask: the CUDA kernel ``csrc/nms_keep.cu`` and its plain twin.

Counterpart of ``manual_yolo_tpu/ops/pallas_nms.py`` (``pallas_nms_keep``).

The kernel is compiled by ``nvcc`` at first use into a shared library with a
plain C interface and bound with ``ctypes``. The library goes into
``manual_yolo_tpu_torch/_build/`` (git-ignored), named by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one is
not.

``nms_keep`` launches the kernel for CUDA tensors and counts each launch in
``nms_keep.launches``. For CPU tensors it runs ``nms_keep_plain``, the JAX
package's jnp scan (``manual_yolo_tpu/ops/nms.py:79-89``) written in torch.
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
from typing import Tuple

import torch

from manual_yolo_tpu_torch.ops.boxes import pairwise_iou

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "csrc" / "nms_keep.cu"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # bit-exactness with the jnp scan: no FMA contraction, IEEE division
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
MAX_K = 2048  # 21 shared bytes per candidate must fit the default 48 KB


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the NMS kernel is built on a host with the CUDA toolkit")


def build() -> Tuple[Path, str]:
    """Compile the kernel if this source and these flags were not built yet.

    Returns (library path, the compiler's ``-Xptxas -v`` report)."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"nms_keep_{tag}.so"
    log = lib.with_suffix(".log")
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
            log.write_text(proc.stderr)
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return lib, log.read_text()


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.nms_keep_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    lib.nms_keep_launch.restype = ctypes.c_int
    return lib


def _check(boxes: torch.Tensor, valid: torch.Tensor) -> None:
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, K, 4), got {tuple(boxes.shape)}")
    if tuple(valid.shape) != tuple(boxes.shape[:2]):
        raise ValueError(f"valid must be (B, K) = {tuple(boxes.shape[:2])}, got {tuple(valid.shape)}")
    if boxes.dtype != torch.float32:
        raise TypeError(f"boxes must be float32, got {boxes.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if boxes.device != valid.device:
        raise ValueError(f"boxes on {boxes.device} but valid on {valid.device}")


def nms_keep_plain(boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """(B, K, 4) f32 score-descending boxes, (B, K) bool -> (B, K) bool keep.

    Box i is kept iff valid and no earlier kept box overlaps it above
    ``iou_thres``. The IoU matrix is computed up front, then scanned."""
    _check(boxes, valid)
    thr = torch.tensor(iou_thres, dtype=torch.float32, device=boxes.device)
    over = pairwise_iou(boxes, boxes) > thr  # [b, j, i]
    kept = torch.zeros(valid.shape, dtype=torch.bool, device=boxes.device)
    for i in range(valid.shape[1]):
        suppressed = (kept & over[:, :, i]).any(dim=1)
        kept[:, i] = valid[:, i] & ~suppressed
    return kept


def nms_keep(boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Greedy-NMS keep mask (B, K) bool over (B, K, 4) f32 boxes.

    Boxes are score-descending with class offsets applied; ``valid`` is a
    prefix of each row. CUDA tensors go through the kernel, CPU tensors
    through ``nms_keep_plain``."""
    _check(boxes, valid)
    if boxes.device.type == "cpu":
        return nms_keep_plain(boxes, valid, iou_thres)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_keep runs on cuda or cpu, not {boxes.device}")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("nms_keep needs contiguous boxes and valid")
    if boxes.data_ptr() % 16:
        raise ValueError("nms_keep reads boxes as float4: they must be 16-byte aligned")
    b, k = valid.shape
    if k > MAX_K:
        raise ValueError(f"nms_keep takes at most {MAX_K} candidates per frame, got {k}")
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0 or k == 0:
        return keep
    lib = _library()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.nms_keep_launch(
            boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), b, k, float(iou_thres), stream
        )
    if err != 0:
        raise RuntimeError(f"nms_keep kernel launch failed with CUDA error {err}")
    nms_keep.launches += 1
    return keep


nms_keep.launches = 0
