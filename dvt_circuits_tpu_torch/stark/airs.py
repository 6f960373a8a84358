"""Example / built-in AIRs."""

from __future__ import annotations

import numpy as np

from ..field import babybear as bb
from .air import Air


class FibonacciAir(Air):
    """Fibonacci chain: columns (a, b); transition (a,b) → (b, a+b).

    Public values: [a0, b0, b_last].  The classic uni-stark smoke AIR.
    """

    width = 2
    num_public_values = 3

    def eval(self, b):
        a, bc = b.local(0), b.local(1)
        b.assert_eq_first(a, b.public(0))
        b.assert_eq_first(bc, b.public(1))
        b.assert_eq_transition(b.next(0), bc)
        b.assert_eq_transition(b.next(1), b.add(a, bc))
        b.assert_eq_last(bc, b.public(2))

    @staticmethod
    def generate_trace(n: int, a0: int = 0, b0: int = 1) -> np.ndarray:
        trace = np.zeros((n, 2), dtype=np.uint32)
        a, b_ = a0 % bb.P, b0 % bb.P
        for i in range(n):
            trace[i] = (a, b_)
            a, b_ = b_, (a + b_) % bb.P
        return trace

    @staticmethod
    def public_values(trace: np.ndarray):
        return [int(trace[0, 0]), int(trace[0, 1]), int(trace[-1, 1])]


class MulChainAir(Air):
    """Cubing chain: x_{i+1} = x_i³ (degree-3 transition — exercises the
    quotient chunking at the maximum default constraint degree)."""

    width = 1
    num_public_values = 2

    def eval(self, b):
        x = b.local(0)
        b.assert_eq_first(x, b.public(0))
        b.assert_eq_transition(b.next(0), b.mul(x, x, x))
        b.assert_eq_last(x, b.public(1))

    @staticmethod
    def generate_trace(n: int, x0: int = 5) -> np.ndarray:
        trace = np.zeros((n, 1), dtype=np.uint32)
        x = x0 % bb.P
        for i in range(n):
            trace[i, 0] = x
            x = pow(x, 3, bb.P)
        return trace

    @staticmethod
    def public_values(trace: np.ndarray):
        return [int(trace[0, 0]), int(trace[-1, 0])]
