"""Device choice and f32 precision for the port's entry points.

Entry points default to ``cuda``. A request for ``cuda`` on a host without
a card raises: the CPU is used only when the caller asks for it.
"""

from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def full_f32():
    """Turn TF32 off inside (restored after): cuDNN convs and RNNs, and matmuls.

    cuDNN's TF32 default keeps about 3 decimal digits, which flips
    borderline rank reads and OCR characters; every f32 forward of the
    port runs under this."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm
