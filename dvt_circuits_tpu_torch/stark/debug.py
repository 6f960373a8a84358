"""Row-wise AIR constraint checker (development/debug utility).

Port of ``dvt_circuits_tpu/stark/debug.py``.  Evaluates an ``Air``'s
scalar ``eval`` over every row pair of a concrete trace with exact Python
integers mod BabyBear, asserting each constraint is zero where its row
selector is active.  O(rows · constraints): for unit tests and AIR
development only; the prover evaluates constraints over the LDE domain
(``stark/prover.py``) and never calls this.  A host utility by nature: the
trace may be a numpy array or a tensor on any device, and is read on the
host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field.babybear import P
from .air import Air, AirBuilder


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.uint64)


class _RowBuilder(AirBuilder):
    """Integer value algebra over one (local, next) row pair."""

    P = P

    def __init__(self, local, nxt, pre_local, pre_next, publics, is_first, is_last):
        self._l = [int(v) % P for v in local]
        self._n = [int(v) % P for v in nxt]
        self._pl = [int(v) % P for v in pre_local]
        self._pn = [int(v) % P for v in pre_next]
        self._pub = [int(v) % P for v in publics]
        self._is_first = int(is_first)
        self._is_last = int(is_last)
        self.failures = []
        self._idx = 0

    def _local(self, j):
        return self._l[j]

    def _next(self, j):
        return self._n[j]

    def _pre(self, j):
        return self._pl[j]

    def _pre_next(self, j):
        return self._pn[j]

    def _public(self, i):
        return self._pub[i]

    def _const(self, c):
        return int(c) % P

    def _add(self, a, b):
        return (a + b) % P

    def _sub(self, a, b):
        return (a - b) % P

    def _mul(self, *xs):
        acc = 1
        for x in xs:
            acc = (acc * x) % P
        return acc

    def _sel_first(self):
        return self._is_first

    def _sel_last(self):
        return self._is_last

    def _sel_transition(self):
        return 0 if self._is_last else 1

    def _accumulate(self, expr):
        if expr % P != 0:
            self.failures.append(self._idx)
        self._idx += 1


def check_trace(air: Air, trace, publics, max_rows: int | None = None) -> None:
    """Raise AssertionError naming (row, constraint index) for every violated
    constraint of ``air`` on ``trace`` (numpy array or tensor)."""
    tr = _host(trace)
    n = tr.shape[0]
    pre = air.preprocessed_trace(n)
    pre = np.zeros((n, 0), dtype=np.uint64) if pre is None else _host(pre)
    publics = [int(v) for v in (publics.tolist() if isinstance(publics, torch.Tensor)
                                else publics)]
    bad = []
    rows = n if max_rows is None else min(n, max_rows)
    for r in range(rows):
        rn = (r + 1) % n
        b = _RowBuilder(
            tr[r], tr[rn], pre[r], pre[rn], publics, r == 0, r == n - 1
        )
        air.eval(b)
        bad += [(r, ci) for ci in b.failures]
    assert not bad, f"constraint violations (row, constraint): {bad[:20]}" + (
        f" … +{len(bad)-20} more" if len(bad) > 20 else ""
    )
