"""The arithmetic of the end-to-end metrics and of the profiler's busy
time, kept with the benchmark so that a change to the program cannot move
it.

``busy_intervals`` is the merge of ``profile_frames`` in the port's
``chip_smoke.py`` at commit 1521963 (frozen): the union of the intervals
of every device activity."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the least
    value with at least q % of the values at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    k = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[k - 1]


def rate(count: int, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError("a rate over no time")
    return count / seconds


def spread(values) -> float:
    """(third quartile - first quartile) / median, the quartiles as
    ``statistics.quantiles(values, n=4)`` gives them."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def busy_intervals(spans) -> tuple[float, list]:
    """(busy length, merged intervals) of ``spans`` [(start, end)]: the
    union of the intervals."""
    spans = sorted(spans)
    if not spans:
        return 0.0, []
    busy, merged = 0.0, []
    cur_a, cur_b = spans[0]
    end = spans[0][0]
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        if a > cur_b:
            merged.append((cur_a, cur_b))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    merged.append((cur_a, cur_b))
    return busy, merged


def idle_gaps(merged, start: float, end: float) -> list:
    """[(gap start, gap end)] of ``[start, end]`` outside ``merged``."""
    gaps, t = [], start
    for a, b in merged:
        if a > t:
            gaps.append((t, min(a, end)))
        t = max(t, b)
    if end > t:
        gaps.append((t, end))
    return [(a, b) for a, b in gaps if b > a]
