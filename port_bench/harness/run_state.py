"""What one run records, handed to the metric readers."""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class Request:
    """One request: its images (indices into the test split), when it was
    due, sent and done on the host's clock, and its answers and their
    served confidences (None until it has them; ``error`` where it
    failed)."""

    images: List[int]
    due: float
    sent: float = math.nan
    done: float = math.nan
    texts: Optional[List[str]] = None
    confs: Optional[List[float]] = None
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.texts is not None and self.error is None


@dataclasses.dataclass
class Decode:
    """One decode of the program's engine, seen by the benchmark's wrapper
    around its public ``decode_tokens``: the bucket, the true rows, the
    steps run, the tokens each true row emitted through its EOS, and
    whether it ran inside the traced window."""

    bucket: int
    rows: int
    steps: int
    tokens: int
    traced: bool = False
    end: float = math.nan               # host clock when it returned


@dataclasses.dataclass
class Run:
    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    setup_s: float = math.nan
    t0: float = math.nan                # the window's start (host clock)
    requests: List[Request] = dataclasses.field(default_factory=list)
    decodes: List[Decode] = dataclasses.field(default_factory=list)
    # engine statistics at the window's start and end (entry-defined)
    stats0: Dict[str, Any] = dataclasses.field(default_factory=dict)
    stats1: Dict[str, Any] = dataclasses.field(default_factory=dict)
    traced: Optional[Any] = None        # tracing.Traced of the --trace run
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def t1(self) -> float:
        return self.t0 + self.seconds

    def due_in_window(self) -> List[Request]:
        return [r for r in self.requests if self.t0 <= r.due < self.t1]

    def done_in_window(self) -> List[Request]:
        return [r for r in self.requests
                if r.ok and self.t0 <= r.done <= self.t1]
