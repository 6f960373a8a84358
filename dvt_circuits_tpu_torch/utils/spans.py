"""Spans and counters inside the port's prove and verify.

Tracing is on exactly while a ``torch.profiler`` session records: ``span``
asks the profiler's own flag (the check ``torch.profiler.record_function``
makes, true in the thread that started the session), and there is no
switch, option or environment variable of its own.  Off, ``span(name)``
returns one shared no-op context and ``count`` returns at once.

On, a span records ``(name, id, parent_id, root_id, thread, start_ns,
end_ns, counters)`` when it exits, an exception included.  Its times are
``time.time_ns()``, the clock the profiler stamps its CPU events with, so a
span lines up with the profiler's device operations.  Its parent is the
innermost span open on the same thread (the stack is per thread: the HTTP
node serves each request on its own thread); a span without one is a root,
and every span under it carries the root's id as ``root_id``: one root per
``prove_circuit`` or ``verify_proof`` call.  ``count(name, n)`` adds ``n``
to a counter of the innermost open span; ``host_read`` counts one blocking
device-to-host read beside the read itself.  Spans are no profiler ranges:
the profiler's own trace holds nothing of them.

There is no exporter and no logging.  The one reader is in the process:
after its profiler session, it calls ``records()`` (the finished spans, the
oldest dropped past ``MAX_RECORDS``, counted by ``dropped()``) and
``clear()``.  The benchmark reads them after its window; an operator reads
them the same way under a profiler session of their own.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import NamedTuple, Optional

import torch

#: the finished spans kept; past it the oldest are dropped
MAX_RECORDS = 1 << 16

#: the profiler's flag: True while a ``torch.profiler`` session records
_profiling = torch._C._autograd._profiler_enabled


class Record(NamedTuple):
    """One finished span; times on ``time.time_ns()``'s clock."""

    name: str
    id: int
    parent_id: Optional[int]
    root_id: int
    thread: int
    start_ns: int
    end_ns: int
    counters: dict


_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    """A block's interval; recorded when tracing was on at its entry."""

    __slots__ = ("name", "on", "id", "parent_id", "root_id", "counters", "start_ns", "end_ns")

    def __init__(self, name: str, on: bool) -> None:
        self.name = name
        self.on = on

    def __enter__(self) -> "_Span":
        if self.on:
            stack = _stack()
            parent = stack[-1] if stack else None
            self.id = next(_ids)
            self.parent_id = parent.id if parent else None
            self.root_id = parent.root_id if parent else self.id
            self.counters = {}
            stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        if self.on:
            global _dropped
            _local.stack.pop()
            rec = Record(self.name, self.id, self.parent_id, self.root_id,
                         threading.get_ident(), self.start_ns, self.end_ns, self.counters)
            with _lock:
                if len(_records) == MAX_RECORDS:
                    _dropped += 1
                _records.append(rec)
        return False

    @property
    def ms(self) -> int:
        """The interval in whole milliseconds."""
        return (self.end_ns - self.start_ns) // 1_000_000


class _Off:
    """The shared no-op context of ``span`` when tracing is off."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str, timed: bool = False):
    """A context manager that records the block as span ``name`` while a
    profiler session records.  ``timed`` reads the clock at both ends
    whether or not it records: the returned span's ``ms`` holds the
    interval (the container's ``timing`` is read so)."""
    on = _profiling()
    if on or timed:
        return _Span(name, on)
    return _OFF


def _top():
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to counter ``name`` of the innermost open span."""
    if not _profiling():
        return
    top = _top()
    if top is not None:
        top.counters[name] = top.counters.get(name, 0) + n


def host_read(what) -> None:
    """Counts one blocking device-to-host read, called beside it:
    ``host_syncs`` += 1 and ``d2h_bytes`` += the bytes of ``what`` (the
    tensor read, or a count of bytes).  It reads nothing itself."""
    if not _profiling():
        return
    top = _top()
    if top is None:
        return
    nbytes = what if isinstance(what, int) else what.numel() * what.element_size()
    c = top.counters
    c["host_syncs"] = c.get("host_syncs", 0) + 1
    c["d2h_bytes"] = c.get("d2h_bytes", 0) + nbytes


def records() -> list:
    """The finished spans, oldest first."""
    with _lock:
        return list(_records)


def dropped() -> int:
    """Spans dropped past ``MAX_RECORDS`` since the last ``clear``."""
    return _dropped


def clear() -> None:
    """Forgets the finished spans and the count of those dropped."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0
