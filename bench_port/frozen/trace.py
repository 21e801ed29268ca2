"""Device busy time, idle gaps and kernel sums from profiler intervals.

The idea of tools_torch/time_cell_search.py::profile_run at commit
7ac09dbc9b43 (device-busy seconds from torch.profiler), taken as the
union of device-operation intervals so that overlapping streams are
not counted twice.  Plain Python over (start, end, name) tuples in
microseconds; the harness turns the profiler's events into them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

Interval = Tuple[float, float, str]


def union(intervals: Sequence[Interval]) -> List[Tuple[float, float]]:
    """Merged (start, end) spans of the intervals, in order."""
    spans: List[List[float]] = []
    for s, e, _ in sorted(intervals):
        if spans and s <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], e)
        else:
            spans.append([s, e])
    return [(s, e) for s, e in spans]


def busy_us(intervals: Sequence[Interval], lo: float, hi: float) -> float:
    """Microseconds inside [lo, hi] in which some device operation ran."""
    return sum(max(0.0, min(e, hi) - max(s, lo))
               for s, e in union(intervals))


def gaps(intervals: Sequence[Interval], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The idle (start, end) stretches of [lo, hi], longest first."""
    out, t = [], lo
    for s, e in union(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return sorted((g for g in out if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])


def by_name(intervals: Sequence[Interval]) -> Dict[str, Tuple[int, float]]:
    """name -> (count, total microseconds)."""
    out: Dict[str, Tuple[int, float]] = {}
    for s, e, name in intervals:
        n, t = out.get(name, (0, 0.0))
        out[name] = (n + 1, t + (e - s))
    return out


def host_label(host: Sequence[Interval], t: float) -> str:
    """The innermost host operation running at time t: the shortest
    host interval that contains it, or "python" when none does."""
    best = None
    for s, e, name in host:
        if s <= t <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else "python"
