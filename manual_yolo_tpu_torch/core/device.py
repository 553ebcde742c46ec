"""Device choice and f32 precision for the port's entry points.

Entry points default to ``cuda``. A request for ``cuda`` on a host without
a card raises: the CPU is used only when the caller asks for it.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


# The TF32 switches are process-wide, so the count of threads inside
# full_f32 is too: the first to enter turns TF32 off, the last to leave
# restores it. Without the count, a thread leaving while another is inside
# would turn TF32 back on under the other's forward.
_f32_lock = threading.Lock()
_f32_depth = 0
_f32_saved = None


@contextlib.contextmanager
def full_f32():
    """Turn TF32 off inside (restored after): cuDNN convs and RNNs, and matmuls.

    cuDNN's TF32 default keeps about 3 decimal digits, which flips
    borderline rank reads and OCR characters; every f32 forward of the
    port runs under this. Safe to enter from several threads at once:
    TF32 stays off until the last of them leaves."""
    global _f32_depth, _f32_saved
    with _f32_lock:
        if _f32_depth == 0:
            _f32_saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        _f32_depth += 1
    try:
        yield
    finally:
        with _f32_lock:
            _f32_depth -= 1
            if _f32_depth == 0:
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = _f32_saved


def precision_for(dtype: torch.dtype):
    """``full_f32()`` for an f32 computation, else a context that does nothing."""
    return full_f32() if dtype == torch.float32 else contextlib.nullcontext()


@contextlib.contextmanager
def cudnn_enabled(enabled: bool):
    """Set ``torch.backends.cudnn.enabled`` inside (restored after), leaving
    its other flags (TF32, benchmark) as they are."""
    saved = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = saved
