"""The traced window of a ``--trace 1`` run.

The benchmark opens and closes the window from the thread that launches the
program's kernels, between two units of its work (two decodes, or two
scheduler ticks), through ``Tracer.boundary``: it waits for the device
there (``torch.cuda.synchronize``), so that the device runs nothing of one
side while the other's launches start, and reads the kernel wrappers' launch
counters. A profiler session warms up for one unit before the window (a
session can miss a kernel's first launches). The trace is read from the
profiler's own event list, not its summary tables; a device operation is in
the window when its launch is (``read_trace``). The port's kernels in the
trace are counted against the counters over the same window; where they
disagree the profiler missed launches, and the kernel and idle metrics are
left out of the run.
"""

from __future__ import annotations

import dataclasses
import importlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from .stats import merged

# the port's kernels as the profiler names them (chip_smoke.py's list at
# commit e13765f3a37352e31b622845f2ae26a6960b06e8)
PORT_KERNELS = tuple(f"{k}_kernel" for k in (
    "window_attention", "window_attention_mma", "patch_merging",
    "patch_merging_mma", "cache_append_attention",
    "fused_step_cluster", "swin_block", "swin_block_mma",
    "ragged_step_cluster", "beam_gather",
    "dequant_mma", "dequant_f32", "whole_step_cluster",
    "whole_decode_cluster", "admission_pull"))

# (module, wrapper, counter) of every kernel wrapper's launch count
COUNTERS = (
    ("ops.window_attention", "window_attention_core", "launches"),
    ("ops.patch_merging", "fused_patch_merging", "launches"),
    ("ops.cache_attention", "cache_append_attention", "launches"),
    ("ops.cache_attention", "decode_attention", "launches"),
    ("ops.fused_step", "fused_decoder_layers_step_v2", "launches"),
    ("ops.swin_block", "fused_swin_block", "launches"),
    ("ops.fused_step", "fused_ragged_step", "launches"),
    ("ops.beam_reorder", "beam_cache_gather", "launches"),
    ("ops.quant", "dequant_matmul", "launches"),
    ("ops.fused_step", "fused_decoder_layers_step_v2", "int8_launches"),
    ("ops.fused_step", "fused_ragged_step", "int8_launches"),
    ("ops.fused_step", "fused_decoder_layers_step", "launches"),
    ("ops.fused_step", "fused_whole_step", "launches"),
    ("ops.whole_decode", "fused_whole_decode", "launches"),
    ("ops.whole_decode", "fused_whole_decode", "int8_launches"),
    ("ops.fused_step", "fused_decoder_layers_step_v2", "mqa_launches"),
    ("ops.fused_step", "fused_decoder_layers_step_v2", "mqa_int8_launches"),
    ("ops.fused_step", "fused_ragged_step", "mqa_launches"),
    ("ops.fused_step", "fused_ragged_step", "mqa_int8_launches"),
    ("ops.fused_step", "fused_ragged_step", "ring_launches"),
    ("ops.fused_step", "fused_ragged_step", "ring_int8_launches"),
    ("ops.fused_step", "fused_ragged_step", "ring_mqa_launches"),
    ("ops.fused_step", "fused_ragged_step", "ring_mqa_int8_launches"),
    ("ops.admission", "admission_pull", "launches"),
)
PACKAGE = "handwritten_math_ocr_api_torch"
OPEN_MARK, CLOSE_MARK = "port_bench.trace_open", "port_bench.trace_close"


def read_counters() -> Dict[Tuple[str, str], int]:
    out: Dict[Tuple[str, str], int] = {}
    for mod, fn, attr in COUNTERS:
        wrapper = getattr(importlib.import_module(f"{PACKAGE}.{mod}"), fn)
        out[(fn, attr)] = out.get((fn, attr), 0) + int(getattr(wrapper,
                                                               attr, 0))
    return out


@dataclasses.dataclass
class Traced:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]          # device seconds by kernel name
    kernel_n: Dict[str, int]            # launches by kernel name
    launches: Dict[Tuple[str, str], int]   # counters over the window
    port_seen: int                      # the port's kernels in the trace
    complete: bool                      # port_seen == sum(launches)
    device_ops: List[List]              # [name, seconds], top 10
    idle_gaps: List[List]               # [host op, seconds], top 10
    unlaunched: int = 0                 # device ops placed without a launch

    def kernel_seconds(self, *names: str) -> float:
        return sum(s for k, s in self.kernel_s.items()
                   if any(n in k for n in names))

    def kernel_count(self, *names: str) -> int:
        return sum(c for k, c in self.kernel_n.items()
                   if any(n in k for n in names))


class Tracer:
    """Opens the traced window at the first boundary at or after
    ``start_at`` (host clock), after one unit of profiler warm-up, and
    closes it at the first boundary ``duration`` seconds later.

    The profiler's state belongs to the thread that starts it, and it
    records that thread's host operators: so in a traced run the program's
    launching calls run on one thread of the tracer's own (``call``), and
    the profiler starts, steps and stops there. Reading the events back
    (seconds) happens after the window's traffic (``finish``)."""

    def __init__(self, enabled: bool, duration: float):
        self.enabled = enabled
        self._thread = None
        if enabled:
            from concurrent.futures import ThreadPoolExecutor

            self._thread = ThreadPoolExecutor(
                1, thread_name_prefix="port-bench-trace")
        self.duration = duration
        self.start_at = float("inf")
        self.state = "idle"          # idle, warming, active, done
        self.prof = None
        self._results = []
        self.t_open = self.t_close = 0.0
        self.c_open: Dict = {}
        self.c_close: Dict = {}
        self.stop_s = 0.0

    @property
    def active(self) -> bool:
        return self.state == "active"

    def call(self, fn, *args):
        """``fn(*args)`` after a boundary; on the tracer's thread in a
        traced run, in the caller's thread otherwise."""
        if self._thread is None:
            return fn(*args)

        def unit():
            self.boundary()
            return fn(*args)

        return self._thread.submit(unit).result()

    def warm(self) -> None:
        """One short profiler session in set-up (the first session of a
        process initialises CUPTI)."""
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(1024, device="cuda").sum().item()

    def boundary(self) -> None:
        """Called between two units of the program's work, from the thread
        that launches them."""
        if not self.enabled or self.state in ("closed", "done"):
            return
        now = time.perf_counter()
        if self.state == "idle" and now >= self.start_at:
            import torch
            from torch.profiler import ProfilerActivity, profile, schedule

            self.prof = profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                on_trace_ready=lambda p: self._results.append(
                    p.profiler.kineto_results))
            torch.cuda.synchronize()
            self.prof.start()
            self.state = "warming"
        elif self.state == "warming":
            import torch

            torch.cuda.synchronize()
            self.prof.step()
            self.c_open = read_counters()
            with torch.profiler.record_function(OPEN_MARK):
                self.t_open = time.perf_counter()
            self.state = "active"
        elif self.state == "active" and now >= self.t_open + self.duration:
            import torch

            torch.cuda.synchronize()
            with torch.profiler.record_function(CLOSE_MARK):
                self.t_close = time.perf_counter()
            self.c_close = read_counters()
            self.state = "closed"

    def _stop(self) -> None:
        if self.prof is not None:
            self.prof.step()
            self.prof.stop()
            self.prof = None
        if self.state == "closed":
            self.state = "done"

    def finish(self) -> None:
        """Stop the profiler on its thread once the window's traffic is
        over; the events between the window's marks are its trace."""
        if self._thread is None:
            return
        t0 = time.perf_counter()
        self._thread.submit(self._stop).result()
        self.stop_s = time.perf_counter() - t0
        self._thread.shutdown()
        self._thread = None

    def result(self) -> Optional[Traced]:
        if self.state != "done" or not self._results:
            return None
        return read_trace(self._results[0], self.t_close - self.t_open,
                          {k: self.c_close[k] - self.c_open.get(k, 0)
                           for k in self.c_close})


def _is_device(ev) -> bool:
    return "CUDA" in str(ev.device_type())


def _marks(events) -> Tuple[int, int]:
    opened = [e.start_ns() for e in events if e.name() == OPEN_MARK
              and not _is_device(e)]
    closed = [e.start_ns() for e in events if e.name() == CLOSE_MARK
              and not _is_device(e)]
    if not opened or not closed:
        raise ValueError("the trace lacks the window's marks")
    return opened[0], closed[0]


def _launches(events) -> Dict[int, int]:
    """Correlation id -> host time of the CUDA runtime or driver call
    (``cudaLaunchKernel``, ``cuLaunchKernelEx``, ``cudaMemcpyAsync``, ...)
    that put a device operation in its stream."""
    out: Dict[int, int] = {}
    for ev in events:
        if (not _is_device(ev) and ev.name().startswith("cu")
                and ev.correlation_id()):
            out.setdefault(ev.correlation_id(), ev.start_ns())
    return out


def read_trace(kineto, window_s: float, launches: Dict) -> Traced:
    """The window between the marks: the device's kernels and copies (the
    profiler's own annotations on the device's timeline left out), and the
    host's events that ran there.

    A device operation is in the window when the host call that launched
    it ran between the marks. Its device timestamps are not held against
    the marks: on the H100 machine the profiler's device clock drifts from
    its host clock within a run (device time fell behind by 52 ms over a
    1.1 s window, 5% in rate; on other runs by nothing), so a window cut by
    device time took in the next decode's launches or lost its own. An
    operation whose launch the trace lacks takes the offset (device start
    minus launch) of the launched operation before it on the device. An
    idle gap is placed on the host's clock by the launch of the operation
    that ends it, which started as soon as it was launched, the device
    having nothing queued."""
    events = kineto.events()
    lo, hi = _marks(events)
    launched_at = _launches(events)
    ops = sorted((ev.start_ns(), ev.duration_ns(), ev.correlation_id(),
                  ev.name()) for ev in events
                 if _is_device(ev) and ev.duration_ns() > 0
                 and not ev.is_user_annotation()
                 and not ev.name().startswith(("ProfilerStep",
                                               "port_bench.")))
    dev: List[Tuple[int, int, int]] = []
    kernel_s: Dict[str, float] = defaultdict(float)
    kernel_n: Dict[str, int] = defaultdict(int)
    offset, unlaunched = 0, 0
    for s, d, corr, name in ops:
        at = launched_at.get(corr)
        if at is None:
            at = s - offset
        else:
            offset = s - at
        if not lo <= at < hi:
            continue
        unlaunched += corr not in launched_at
        dev.append((s, s + d, at))
        kernel_s[name] += d * 1e-9
        kernel_n[name] += 1
    host = sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                   ev.name()) for ev in events
                  if not _is_device(ev) and ev.duration_ns() > 0
                  and lo <= ev.start_ns() < hi
                  and not ev.name().startswith("ProfilerStep"))
    busy = merged(dev)
    busy_s = sum(e - s for s, e, _ in busy) * 1e-9
    port_seen = sum(n for k, n in kernel_n.items()
                    if any(p in k for p in PORT_KERNELS))
    top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
    gaps: Dict[str, float] = defaultdict(float)
    for (_, e0, _), (s1, _, at1) in zip(busy, busy[1:]):
        # each gap by what the host ran at its middle
        gaps[_host_at(host, at1 - (s1 - e0) // 2)] += (s1 - e0) * 1e-9
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return Traced(window_s, busy_s, dict(kernel_s), dict(kernel_n), launches,
                  port_seen, port_seen == sum(launches.values()),
                  [[k[:120], v] for k, v in top],
                  [[k[:120], v] for k, v in idle], unlaunched)


def _host_at(host: List[Tuple[int, int, str]], t: int) -> str:
    """The host event running at ``t`` that started last (on one thread,
    the innermost of a nest), among the 64 that start last before it; or
    "no host event"."""
    import bisect

    i = bisect.bisect_right(host, (t, float("inf"), ""))
    for s, e, name in reversed(host[max(0, i - 64):i]):
        if e >= t:
            return name
    return "no host event"
