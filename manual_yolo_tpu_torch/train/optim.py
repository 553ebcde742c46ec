"""The trainers' optimizer: optax's AdamW, warmup-cosine schedule and
global-norm clipping, in PyTorch.

  * ``warmup_cosine(init, peak, warmup, total, end)(k)`` is
    ``optax.warmup_cosine_decay_schedule`` evaluated in f32, as JAX does,
    at the update count ``k`` before it is incremented;
  * ``adamw`` is ``torch.optim.AdamW`` with optax's defaults (b1 0.9,
    b2 0.999, eps 1e-8; decoupled decay scaled by the learning rate), which
    equals ``optax.adamw`` algebraically. ``set_lr`` gives every group the
    schedule's value before a step;
  * ``clip_by_global_norm`` is optax's: ``g / ||g|| * max`` when
    ``||g|| >= max`` (not ``clip_grad_norm_``'s ``max / (||g|| + 1e-6)``).
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

f32 = np.float32


def warmup_cosine(init: float, peak: float, warmup: int, total: int,
                  end: float) -> Callable[[int], float]:
    alpha = 0.0 if peak == 0.0 else end / peak
    decay_steps = total - warmup
    if decay_steps <= 0:
        raise ValueError(f"the cosine decay needs total > warmup, got {total} <= {warmup}")

    def linear(count: int) -> np.float32:
        if warmup <= 0:
            return f32(init)
        frac = f32(1) - f32(min(max(count, 0), warmup)) / f32(warmup)
        return f32(init - peak) * frac + f32(peak)

    def cosine(count: int) -> np.float32:
        c = min(f32(count), f32(decay_steps))
        cos = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay_steps)))
        return f32(peak) * (f32(1 - alpha) * cos + f32(alpha))

    def schedule(count: int) -> float:
        return float(linear(count) if count < warmup else cosine(count - warmup))

    return schedule


def adamw(groups, weight_decay: float) -> torch.optim.AdamW:
    """``groups``: parameter lists or ``torch.optim`` group dicts; a group's
    own ``weight_decay`` wins over the default."""
    return torch.optim.AdamW(groups, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for g in opt.param_groups:
        g["lr"] = lr


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place as ``optax.clip_by_global_norm``; returns the norm."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    value = float(norm)
    if value >= max_norm:
        torch._foreach_div_(grads, value)
        torch._foreach_mul_(grads, max_norm)
    return norm
