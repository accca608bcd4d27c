"""The union of intervals."""

from __future__ import annotations

from typing import Iterable, List, Tuple


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by the intervals (start, end)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals: Iterable[Tuple]) -> List[Tuple]:
    """The intervals ``(start, end, *tag)`` merged where they overlap, in
    order; a merged interval keeps the tag of the one that starts it."""
    out: List[list] = []
    for iv in sorted(intervals):
        if out and iv[0] <= out[-1][1]:
            out[-1][1] = max(out[-1][1], iv[1])
        else:
            out.append(list(iv))
    return [tuple(x) for x in out]
