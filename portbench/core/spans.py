"""The port's own spans and counters in a traced window.

The port records spans while a profiler session records in its process
(``dvt_circuits_tpu_torch/utils/spans.py``): ``prove`` and ``verify`` roots,
one per call, and the phases under them, each with its counters, stamped on
the profiler's clock.  This is the one module besides ``core/program.py``
that reaches into the port, and it only reads: the finished spans that
start and end inside the traced window, after the window.  A port without
that module, or a window in which it recorded nothing, reads as no spans,
and every reader built on this module then returns None.
"""

from __future__ import annotations

import bisect
from collections import defaultdict


def window_records(run) -> list:
    """The port's finished spans inside the traced window of ``run``."""
    if run.trace is None:
        return []
    try:
        from dvt_circuits_tpu_torch.utils.spans import records
    except ImportError:
        return []
    w0, w1 = run.trace.window  # microseconds
    return [r for r in records() if w0 <= r.start_ns / 1e3 and r.end_ns / 1e3 <= w1]


def by_root(records: list, root: str) -> list:
    """The spans of each root named ``root``, one list per root, the root
    among them, in the roots' order."""
    groups = defaultdict(list)
    for r in records:
        groups[r.root_id].append(r)
    roots = sorted((r for r in records if r.parent_id is None and r.name == root),
                   key=lambda r: r.start_ns)
    return [groups[r.id] for r in roots]


def span_ms(run, root: str, name: str):
    """The time of the spans named ``name`` summed over each ``root`` root,
    in ms, a mean over the roots; None without such spans."""
    groups = by_root(window_records(run), root)
    sums = [sum(r.end_ns - r.start_ns for r in g if r.name == name) for g in groups]
    if not any(r.name == name for g in groups for r in g):
        return None
    return sum(sums) / len(sums) / 1e6


def counter(run, root: str, name: str):
    """Counter ``name`` summed over every span of each ``root`` root, a
    mean over the roots; None without such roots."""
    groups = by_root(window_records(run), root)
    if not groups:
        return None
    return sum(r.counters.get(name, 0) for g in groups for r in g) / len(groups)


def intervals(run, name: str) -> list:
    """The (start, end) of every span named ``name``, in microseconds."""
    return sorted((r.start_ns / 1e3, r.end_ns / 1e3) for r in window_records(run)
                  if r.name == name)


def busy_us_inside(trace, spans_us: list) -> float:
    """The device's busy time (``Trace.busy``) inside the disjoint
    intervals ``spans_us``, in microseconds."""
    busy = trace.busy()
    ends = [e for _, e in busy]
    total = 0.0
    for a, b in spans_us:
        i = bisect.bisect_right(ends, a)
        while i < len(busy) and busy[i][0] < b:
            s, e = busy[i]
            total += max(0.0, min(e, b) - max(s, a))
            i += 1
    return total
