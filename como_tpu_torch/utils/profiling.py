"""Per-stage timing + torch profiler hook (port of como_tpu/utils/profiling.py).

`StageTimer` records host-clock time per named stage (track / linearize /
solve / net / io) with exponential moving averages; `trace` wraps a block
in a torch.profiler trace and writes a Chrome trace file.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict


class StageTimer:
    def __init__(self, ema: float = 0.1):
        self.ema = ema
        self.avg: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)
        self.last: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.last[name] = dt
            self.count[name] += 1
            a = self.avg[name]
            self.avg[name] = dt if self.count[name] == 1 else \
                (1 - self.ema) * a + self.ema * dt

    def report(self) -> str:
        return "  ".join(f"{k}={1000 * v:.1f}ms" for k, v in
                         sorted(self.avg.items()))


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace (CPU, and CUDA when there is a device) around a
    block; writes <log_dir>/trace.json, viewable in chrome://tracing or
    Perfetto.  Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
