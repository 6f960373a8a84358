"""Quartic extension field BB4 = BabyBear[x]/(x⁴ − 11) on int64 tensors.

Port of ``dvt_circuits_tpu/field/ext.py``: tensors of shape (..., 4) in
standard form; every product is reduced before it is summed, so no
intermediate leaves int64 (three reduced products plus 11·p stay far below
2⁶³).  The scalar mirror (tuples of standard-form ints) is copied from the
JAX package and backs the tests.
"""

from __future__ import annotations

import torch

from . import babybear as bb

P = bb.P
W = 11  # binomial non-residue: x^4 = 11
D = 4  # extension degree


def from_base(a):
    """Embed a BabyBear tensor (...,) into BB4 (..., 4)."""
    z = torch.zeros_like(a)
    return torch.stack([a, z, z, z], dim=-1)


def add(a, b):
    return (a + b) % P


def sub(a, b):
    return (a - b) % P


def mul(a, b):
    """BB4 product of (..., 4) tensors (broadcasting)."""
    a0, a1, a2, a3 = a.unbind(-1)
    b0, b1, b2, b3 = b.unbind(-1)

    def m(x, y):
        return x * y % P

    c0 = (m(a0, b0) + W * ((m(a1, b3) + m(a2, b2) + m(a3, b1)) % P)) % P
    c1 = (m(a0, b1) + m(a1, b0) + W * ((m(a2, b3) + m(a3, b2)) % P)) % P
    c2 = (m(a0, b2) + m(a1, b1) + m(a2, b0) + W * m(a3, b3)) % P
    c3 = (m(a0, b3) + m(a1, b2) + m(a2, b1) + m(a3, b0)) % P
    return torch.stack([c0, c1, c2, c3], dim=-1)


def mul_base(a, s):
    """BB4 (..., 4) times BabyBear (...,) broadcast over the last axis."""
    return a * s.unsqueeze(-1) % P


def inv(a):
    """Batched inverse via the even/odd conjugate: a* = (a0, −a1, a2, −a3);
    a·a* lies in BB[x²], whose norm down to BB is inverted in the base
    field.  Zero maps to zero (callers guard)."""
    a0, a1, a2, a3 = a.unbind(-1)

    def m(x, y):
        return x * y % P

    t0 = (m(a0, a0) - W * m(2 * a1, a3) % P + W * m(a2, a2)) % P
    t1 = (m(2 * a0, a2) - m(a1, a1) - W * m(a3, a3) % P) % P
    norm = (m(t0, t0) - W * m(t1, t1)) % P
    ninv = bb.inv(norm)
    u0 = m(t0, ninv)
    u2 = (-m(t1, ninv)) % P
    s0 = (m(a0, u0) + W * m(a2, u2)) % P
    s1 = (-(m(a1, u0) + W * m(a3, u2))) % P
    s2 = (m(a2, u0) + m(a0, u2)) % P
    s3 = (-(m(a3, u0) + m(a1, u2))) % P
    return torch.stack([s0, s1, s2, s3], dim=-1)


def tensor(value, device) -> torch.Tensor:
    """A scalar BB4 tuple as a (4,) int64 tensor."""
    return torch.tensor([int(v) % P for v in value], dtype=torch.int64, device=device)


def powers(x, k: int, device) -> torch.Tensor:
    """[x⁰, x¹, …, x^{k-1}] as a (k, 4) tensor (log-doubling)."""
    out = tensor(S_ONE, device)[None, :]
    z = tensor(x, device)[None, :]
    while out.shape[0] < k:
        out = torch.cat([out, mul(out, z)])
        z = mul(z, z)
    return out[:k]


# ---------------------------------------------------------------------------
# Scalar mirror (tuples of standard-form ints)
# ---------------------------------------------------------------------------

S_ZERO = (0, 0, 0, 0)
S_ONE = (1, 0, 0, 0)


def s_from_base(a: int):
    return (a % P, 0, 0, 0)


def s_add(a, b):
    return tuple((x + y) % P for x, y in zip(a, b))


def s_sub(a, b):
    return tuple((x - y) % P for x, y in zip(a, b))


def s_neg(a):
    return tuple((-x) % P for x in a)


def s_mul(a, b):
    a0, a1, a2, a3 = a
    b0, b1, b2, b3 = b
    c0 = (a0 * b0 + W * (a1 * b3 + a2 * b2 + a3 * b1)) % P
    c1 = (a0 * b1 + a1 * b0 + W * (a2 * b3 + a3 * b2)) % P
    c2 = (a0 * b2 + a1 * b1 + a2 * b0 + W * (a3 * b3)) % P
    c3 = (a0 * b3 + a1 * b2 + a2 * b1 + a3 * b0) % P
    return (c0, c1, c2, c3)


def s_mul_base(a, s: int):
    return tuple(x * s % P for x in a)


def s_pow(a, e: int):
    result = S_ONE
    base = a
    while e > 0:
        if e & 1:
            result = s_mul(result, base)
        base = s_mul(base, base)
        e >>= 1
    return result


def s_inv(a):
    a0, a1, a2, a3 = a
    t0 = (a0 * a0 - W * 2 * a1 * a3 + W * a2 * a2) % P
    t1 = (2 * a0 * a2 - a1 * a1 - W * a3 * a3) % P
    norm = (t0 * t0 - W * t1 * t1) % P
    if norm == 0:
        raise ZeroDivisionError("inverse of zero in BB4")
    ninv = pow(norm, P - 2, P)
    u0 = t0 * ninv % P
    u2 = -t1 * ninv % P
    s0 = (a0 * u0 + W * a2 * u2) % P
    s1 = (-(a1 * u0 + W * a3 * u2)) % P
    s2 = (a2 * u0 + a0 * u2) % P
    s3 = (-(a3 * u0 + a1 * u2)) % P
    return (s0, s1, s2, s3)


def s_is_zero(a) -> bool:
    return all(x % P == 0 for x in a)
