"""Exponential moving average of a model's weights (ultralytics' ramped decay).

Counterpart of ``manual_yolo_tpu/train/ema.py``: ``decay(t) = d * (1 -
exp(-t / tau))``, so at the first update (``step`` 0) the average equals the
weights. As the JAX EMA maps over the whole params tree, it covers the BN
running statistics as well as the parameters.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
from torch import nn


def ema_tensors(model: nn.Module) -> List[torch.Tensor]:
    """The tensors the EMA averages: parameters, then BN running statistics."""
    return [p for p in model.parameters()] + [
        b for n, b in model.named_buffers() if not n.endswith("num_batches_tracked")
    ]


@torch.no_grad()
def ema_update(ema: List[torch.Tensor], current: List[torch.Tensor], step: int,
               decay: float = 0.9999, tau: float = 2000.0) -> None:
    """``ema = ema * d + current * (1 - d)`` in place, ``d`` in f32 as JAX has it."""
    d = np.float32(decay) * (np.float32(1.0) - np.exp(-np.float32(step) / np.float32(tau)))
    torch._foreach_mul_(ema, float(d))
    torch._foreach_add_(ema, current, alpha=float(np.float32(1.0) - d))
