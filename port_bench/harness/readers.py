"""What the metric readers share: the window's decodes, its answers'
token counts, and the traced window's checks."""

from __future__ import annotations

from typing import List, Optional

from . import roofline
from .run_state import Decode, Run


def window_decodes(run: Run) -> List[Decode]:
    return [d for d in run.decodes if run.t0 < d.end <= run.t1]


def traced_decodes(run: Run) -> List[Decode]:
    return [d for d in run.decodes if d.traced]


def answer_tokens(run: Run, text: str) -> int:
    """Tokens an answer was decoded through, its EOS included (an answer
    that is no token sequence counts none)."""
    ids = run.notes["vocab"].ids_of(text)
    if ids is None:
        return 0
    return min(len(ids) + 1, run.model["max_seq_len"])


def useful_flops(run: Run) -> float:
    """Model FLOPs of the images answered in the window: each encode and
    each image's own tokens through EOS; no padding rows or steps."""
    return sum(roofline.image_flops(run.model, answer_tokens(run, t))
               for r in run.done_in_window() for t in r.texts)


def complete_trace(run: Run):
    """The traced window where the profiler saw every launch the
    counters counted; None otherwise (its metrics are left out)."""
    t = run.traced
    return t if t is not None and t.complete else None


def idle_share(run: Run) -> Optional[float]:
    t = complete_trace(run)
    if t is None or t.window_s <= 0:
        return None
    return 1.0 - t.busy_s / t.window_s


def delta(run: Run, key: str) -> float:
    return run.stats1[key] - run.stats0[key]
