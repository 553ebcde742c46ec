"""Per-stage wall-time statistics for the runtime loops.

Counterpart of ``manual_yolo_tpu/utils/profiling.py:21-60`` (``StageTimer``,
copied). The JAX package's ``trace`` and ``device_memory_stats`` are not
ported: a device trace of the port is taken with ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict, deque
from typing import Dict, Iterator


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
