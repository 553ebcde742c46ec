"""Per-stage wall-time statistics, device traces and device memory.

Counterpart of ``manual_yolo_tpu/utils/profiling.py``: ``StageTimer`` is
copied; ``trace`` takes a ``torch.profiler`` trace (CPU and, with a card,
CUDA activities) and writes it as a Chrome trace into ``logdir``, where the
JAX package writes a TensorBoard/XProf trace; ``device_memory_stats``
reads the CUDA caching allocator's counters under the JAX package's keys.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict, deque
from typing import Dict, Iterator

import torch


class StageTimer:
    """Rolling mean/max wall times per named stage."""

    def __init__(self, window: int = 120):
        self._samples: Dict[str, deque] = defaultdict(lambda: deque(maxlen=window))
        self._starts: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._samples[name].append(time.perf_counter() - t0)

    def start(self, name: str):
        self._starts[name] = time.perf_counter()

    def stop(self, name: str):
        if name in self._starts:
            self._samples[name].append(time.perf_counter() - self._starts.pop(name))

    def stats(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self._samples.items():
            if not xs:
                continue
            s = sorted(xs)
            out[name] = {
                "mean_ms": 1000 * sum(xs) / len(xs),
                "p50_ms": 1000 * s[len(s) // 2],
                "max_ms": 1000 * s[-1],
                "n": len(xs),
            }
        return out

    def report(self) -> str:
        return json.dumps(self.stats(), indent=2)


@contextlib.contextmanager
def trace(logdir: str = "runs_cuda/traces") -> Iterator[torch.profiler.profile]:
    """Profile the block with ``torch.profiler`` and write its Chrome trace
    to ``logdir/trace_<pid>_<ms>.json``; the profiler is yielded, and its
    ``trace_path`` names the file after the block."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(logdir, f"trace_{os.getpid()}_{int(time.time() * 1000)}.json")
        prof.export_chrome_trace(path)
        prof.trace_path = path


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per card (``cuda:<i>``): bytes held by live tensors, their peak, and
    the card's memory; empty without a card."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        ms = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(i).total_memory),
        }
    return out
