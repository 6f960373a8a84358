"""The traced run's reading: the profiler's device operations and the
benchmark's own spans, on one clock.

``Tracer`` wraps the window in ``torch.profiler`` (CPU and CUDA activity)
and opens a ``record_function`` span around each call into the port:
``parse_<i>``, ``prove_<i>`` and ``verify_<i>`` for iteration i.  After the
window, ``Trace`` holds the spans and the device operations (kernels,
copies and sets) as plain tuples in microseconds, and answers the
questions the per-layer readers ask: the device time and launches inside
each proof's interval, the busy time and the idle gaps of the window.
"""

from __future__ import annotations

import bisect
import contextlib
import re
from dataclasses import dataclass, field

#: the device operations that are copies from device to host
D2H = ("Memcpy DtoH", "Memcpy_DtoH")
#: the benchmark's own spans
SPAN = re.compile(r"^(?:(?:parse|prove|verify)_\d+|window)$")


def _start_us(e) -> float:
    return e.start_ns() / 1e3 if hasattr(e, "start_ns") else float(e.start_us())


def _dur_us(e) -> float:
    return e.duration_ns() / 1e3 if hasattr(e, "duration_ns") else float(e.duration_us())


def short_name(name: str, limit: int = 96) -> str:
    """A device operation's name cut to ``limit`` characters: the kernel
    and its first template arguments, without the rest of its signature."""
    return name if len(name) <= limit else name[: limit - 3] + "..."


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


@dataclass
class Trace:
    """Spans (name, start, end) and device operations (name, start, end),
    all in microseconds on the profiler's clock, and the window's bounds."""

    spans: list
    ops: list
    window: tuple
    proofs: int = 0
    _busy: list = field(default=None, repr=False)

    @classmethod
    def from_profiler(cls, prof, window_span: str) -> "Trace":
        from torch.autograd import DeviceType

        spans, ops = [], []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            on_cpu = e.device_type() == DeviceType.CPU
            if SPAN.match(name):
                if on_cpu:  # the device-side copy of a span is no operation
                    s = _start_us(e)
                    spans.append((name, s, s + _dur_us(e)))
            elif not on_cpu:
                s = _start_us(e)
                ops.append((name, s, s + _dur_us(e)))
        spans.sort(key=lambda s: s[1])
        ops.sort(key=lambda o: o[1])
        win = [s for s in spans if s[0] == window_span]
        if not win:
            raise RuntimeError(f"the trace holds no {window_span!r} span")
        return cls(spans=[s for s in spans if s[0] != window_span], ops=ops,
                   window=(win[0][1], win[0][2]))

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def proof_intervals(self) -> list:
        """[start of parse_i, start of verify_i) for every finished proof."""
        starts = {s[0]: s[1] for s in self.spans}
        return [(t, starts["verify_" + name[6:]]) for name, t in starts.items()
                if name.startswith("parse_") and "verify_" + name[6:] in starts]

    def ops_in(self, intervals) -> list:
        """Device operations that start inside any of ``intervals``."""
        starts = [o[1] for o in self.ops]
        out = []
        for a, b in intervals:
            out += self.ops[bisect.bisect_left(starts, a):bisect.bisect_left(starts, b)]
        return out

    def busy(self) -> list:
        """The union of the device operations' intervals, clipped to the
        window, as sorted disjoint (start, end) pairs."""
        if self._busy is None:
            w0, w1 = self.window
            merged = []
            for _, s, e in self.ops:
                s, e = max(s, w0), min(e, w1)
                if e <= s:
                    continue
                if merged and s <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], e)
                else:
                    merged.append([s, e])
            self._busy = [tuple(m) for m in merged]
        return self._busy

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e6

    def span_at(self, t: float) -> str:
        """The benchmark span open at ``t``, or where between spans it lies."""
        last = None
        for name, s, e in self.spans:
            if s <= t < e:
                return name
            if s <= t:
                last = name
        return f"after_{last}" if last else "before_the_first_call"

    def idle_gaps(self, count: int = 10) -> list:
        """The longest idle gaps of the window, each named by the span open
        in its middle: [[name, seconds], ...]."""
        edges = [self.window[0]]
        for s, e in self.busy():
            edges += [s, e]
        edges.append(self.window[1])
        gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
                for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        return [[self.span_at((a + b) / 2), g / 1e6] for g, a, b in gaps[:count]]

    def top_ops(self, count: int = 10) -> list:
        """The device operations that took most time: [[name, seconds], ...]."""
        total: dict = {}
        for name, s, e in self.ops:
            total[name] = total.get(name, 0.0) + (e - s)
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:count]
        return [[short_name(name), us / 1e6] for name, us in ranked]


class Tracer:
    """The profiler around a window, or nothing when tracing is off."""

    def __init__(self, enabled: bool, device: str) -> None:
        self.enabled = enabled
        self.device = device
        self.prof = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts, record_shapes=False, with_stack=False,
                                profile_memory=False)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)
