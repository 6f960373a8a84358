"""AIR (Algebraic Intermediate Representation) abstraction.

An ``Air`` describes a computation as constraints over adjacent rows of a
trace matrix.  The same ``eval`` runs in two value algebras:

  * prover: values are full LDE columns (BabyBear uint32 arrays) — the
    constraint evaluation is one fused batched pass over the LDE domain;
  * verifier: values are BB4 scalars (openings at the DEEP point ζ).

Constraints are folded into a single accumulator with powers of the
challenge α; the fold order is the assertion order, which both sides share
because they run the same ``eval`` body.

Degree rule: with blowup 2^b, the total degree of any asserted expression
(trace values count 1, selector multipliers included) must be ≤ 2^b + 1.
"""

from __future__ import annotations

from typing import List, Sequence


class Air:
    """Subclass and define ``width``, optional ``num_public_values``, and
    ``eval(builder)``.  Cite the computation the trace encodes in the
    docstring."""

    width: int = 0
    num_public_values: int = 0
    preprocessed_width: int = 0

    def eval(self, builder: "AirBuilder") -> None:
        raise NotImplementedError

    def preprocessed_trace(self, n: int):
        """Optional fixed columns (selectors, round constants): (n, pw) array
        of standard-form uint32, deterministic in n.  Both sides commit it;
        the verifier recomputes the commitment as part of the verifying key."""
        return None

    def cache_key(self):
        """Hashable identity for jit-phase caching: class + instance params."""
        items = tuple(sorted((k, v) for k, v in self.__dict__.items()))
        return (type(self).__module__, type(self).__qualname__, items)


class AirBuilder:
    """Value-algebra-agnostic constraint builder."""

    # subclasses provide: _local(j), _next(j), _public(i), _const(int),
    # _add/_sub/_mul, selector values, and _accumulate(expr_with_selector)

    def local(self, j: int):
        return self._local(j)

    def next(self, j: int):
        return self._next(j)

    def preprocessed(self, j: int):
        """Fixed (circuit-defined) column value on the local row."""
        return self._pre(j)

    def preprocessed_next(self, j: int):
        return self._pre_next(j)

    def public(self, i: int):
        return self._public(i)

    def constant(self, c: int):
        return self._const(c % self.P)

    def add(self, *xs):
        acc = xs[0]
        for x in xs[1:]:
            acc = self._add(acc, x)
        return acc

    def sub(self, a, b):
        return self._sub(a, b)

    def mul(self, *xs):
        acc = xs[0]
        for x in xs[1:]:
            acc = self._mul(acc, x)
        return acc

    # -- assertions --------------------------------------------------------

    def assert_zero_all(self, expr) -> None:
        """Must hold on every row."""
        self._accumulate(expr)

    def assert_zero_first(self, expr) -> None:
        """Must hold on the first row."""
        self._accumulate(self._mul(self._sel_first(), expr))

    def assert_zero_last(self, expr) -> None:
        """Must hold on the last row."""
        self._accumulate(self._mul(self._sel_last(), expr))

    def assert_zero_transition(self, expr) -> None:
        """Must hold on every row but the last (links row i to row i+1)."""
        self._accumulate(self._mul(self._sel_transition(), expr))

    def assert_eq_transition(self, a, b) -> None:
        self.assert_zero_transition(self._sub(a, b))

    def assert_eq_first(self, a, b) -> None:
        self.assert_zero_first(self._sub(a, b))

    def assert_eq_last(self, a, b) -> None:
        self.assert_zero_last(self._sub(a, b))

    def assert_eq_all(self, a, b) -> None:
        self.assert_zero_all(self._sub(a, b))
