"""Frame sources: screen capture (gated), PNG, JPEG and BMP files, synthetic.

Counterpart of ``manual_yolo_tpu/runtime/capture.py``. Sources share one
iterator protocol so every pipeline can run off a screen, a directory of
screenshots, or a synthetic generator (tests, bench).

Files are read by ``runtime/png.py::imread_bgr`` (PNG, JPEG through
``runtime/jpeg.py`` or BMP through ``runtime/bmp.py``; BGR, as ``cv2.imread``
gives), chosen by the file's first bytes. Any other file or a video raises
``ValueError`` naming it: a file the port cannot read is never skipped.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from manual_yolo_tpu_torch.runtime.png import image_format, imread_bgr

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")  # what the JAX package lists in a directory
VIDEO_EXTS = (".mp4", ".avi", ".mkv", ".mov")  # what the JAX package opens as a video


def screen_source(
    region: Optional[Dict[str, int]] = None, fps: Optional[float] = None
) -> Iterator[np.ndarray]:
    """mss-based capture -> BGR frames (reference detect.py:527-536).

    Raises RuntimeError if no capture backend is installed.
    """
    try:
        import mss  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            "screen capture requires 'mss' (not installed in this environment); "
            "use file_source()/synthetic_source() instead"
        ) from e
    interval = 1.0 / fps if fps else 0.0
    last = 0.0
    with mss.mss() as sct:
        mon = region or sct.monitors[1]
        while True:
            now = time.time()
            if interval and now - last < interval:
                time.sleep(interval - (now - last))
            last = time.time()
            shot = np.asarray(sct.grab(mon))
            yield np.ascontiguousarray(shot[..., :3])  # BGRA -> BGR


def _check_readable(path: str) -> None:
    """``ValueError`` naming the file unless it is a PNG, a JPEG or a BMP."""
    if path.lower().endswith(VIDEO_EXTS):
        raise ValueError(f"{path}: a video file; the port's frame sources read PNG, "
                         "JPEG and BMP files only")
    image_format(path)


def file_source(path: str, loop: bool = False) -> Iterator[np.ndarray]:
    """Single PNG, JPEG or BMP image, or directory of them -> BGR frames.

    A directory's image files are read in sorted order, as the JAX package
    lists them; any of them that the readers do not take raises before the
    first frame. A video file raises too."""
    if os.path.isdir(path):
        files = sorted(
            os.path.join(path, f)
            for f in os.listdir(path)
            if f.lower().endswith(IMAGE_EXTS)
        )
        for f in files:
            _check_readable(f)
        it = itertools.cycle(files) if loop else iter(files)
        for f in it:
            yield imread_bgr(f)
    else:
        _check_readable(path)
        img = imread_bgr(path)
        while True:
            yield img.copy()
            if not loop:
                break


def synthetic_source(
    hw: Tuple[int, int] = (1200, 1920), seed: int = 0
) -> Iterator[np.ndarray]:
    """Deterministic noise frames (bench/tests)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, hw + (3,), np.uint8)
    while True:
        jitter = rng.integers(0, 16, hw + (3,), np.uint8)
        yield ((base.astype(np.int16) + jitter) % 256).astype(np.uint8)


def make_source(spec: str, **kwargs) -> Iterator[np.ndarray]:
    """'screen' | 'synthetic' | a PNG, JPEG or BMP file or directory path."""
    if spec == "screen":
        return screen_source(**kwargs)
    if spec == "synthetic":
        return synthetic_source(**{k: v for k, v in kwargs.items() if k in ("hw", "seed")})
    return file_source(spec, loop=kwargs.get("loop", False))
