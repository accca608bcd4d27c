"""Tracing: a ``torch.profiler`` trace and lightweight stage timers.

Port of ``handwritten_math_ocr_api_tpu/utils/profiling.py``:

- ``trace(log_dir)``: a context manager that records the enclosed block
  with ``torch.profiler`` (the host's operators and, on a CUDA build with
  a card, the device's kernels) and writes a Chrome trace
  (``trace.json``, loadable in Perfetto or ``chrome://tracing``) into
  ``log_dir``, in place of JAX's TensorBoard trace;
- ``StageTimer``: named wall-clock stages with count, total and EWMA, as
  the serving engines read them.

JAX's ``start_profiler_server`` (a live profiling endpoint) has no
``torch.profiler`` counterpart; it waits for the serving app.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Record the enclosed block; write ``log_dir/trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StageTimer:
    """Named stage timers with count, total and EWMA, cheap enough for the
    request path. Increments are single statements under the interpreter
    lock, as in JAX."""

    def __init__(self, ewma_alpha: float = 0.1):
        self.alpha = ewma_alpha
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.ewma: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            prev = self.ewma.get(name)
            self.ewma[name] = dt if prev is None else \
                (1 - self.alpha) * prev + self.alpha * dt

    def reset(self) -> None:
        """Drop every recorded stage (after a warmup, so that steady-state
        summaries leave out the first requests' kernel builds)."""
        self.totals.clear()
        self.counts.clear()
        self.ewma.clear()

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "count": self.counts[name],
                "total_sec": self.totals[name],
                "mean_sec": self.totals[name] / self.counts[name],
                "ewma_sec": self.ewma.get(
                    name, self.totals[name] / self.counts[name]),
            }
            for name in self.counts
        }
