"""Shamir/Feldman polynomial-commitment math (host path).

Re-creates crates/dkg/src/dkg_math.rs:144-248.  In Shamir's secret sharing a
secret is F(0) of a degree-(k-1) polynomial; Feldman commitments publish the
coefficients as group points so that anyone can evaluate the "verification
vector" at a share id and compare against the claimed share's public key.

These are the host-side O(n·k) reference routines.  The batched TPU MSM path
(bucketed multi-scalar multiplication over limb arrays) lives in
``dvt_circuits_tpu.curve``; both agree bit-exactly on compressed outputs.
"""

from __future__ import annotations

from typing import List, Sequence


def evaluate_polynomial(cfs: Sequence, x, point_cls=None):
    """Horner evaluation of a polynomial with group-point coefficients
    (dkg_math.rs:160-174).  ``cfs[0]`` is the constant term.  An empty
    coefficient list evaluates to the identity (requires ``point_cls``)."""
    count = len(cfs)
    if count == 0:
        if point_cls is None:
            raise ValueError("empty polynomial needs an explicit point class")
        return point_cls.identity()
    if count == 1:
        return cfs[0]
    y = cfs[-1]
    for i in range(count - 2, -1, -1):
        y = y.mul_scalar(x)
        y = y.add(cfs[i])
    return y


def lagrange_interpolation(y_vec: Sequence, x_vec: Sequence):
    """Interpolate the polynomial through (x_i, Y_i) and return its value at 0
    (dkg_math.rs:178-227).  Raises ValueError on invalid inputs, duplicate or
    zero share ids — the reference's generic (non-slashable) errors."""
    k = len(x_vec)
    if k == 0 or k != len(y_vec):
        raise ValueError("invalid inputs")
    if k == 1:
        return y_vec[0]

    a = x_vec[0]
    for i in range(1, k):
        a = a.mul(x_vec[i])
    if a.is_zero():
        raise ValueError("zero secret share id")

    r = type(y_vec[0]).identity()
    for i in range(k):
        b = x_vec[i]
        for j in range(k):
            if j != i:
                v = x_vec[j].sub(x_vec[i])
                if v.is_zero():
                    raise ValueError("duplicate secret share id")
                b = b.mul(v)
        li0 = a.mul(b.invert())
        r = r.add(y_vec[i].mul_scalar(li0))
    return r


def agg_coefficients(
    verification_vectors: Sequence[Sequence], ids: Sequence, point_cls=None
) -> List:
    """Column-sum all participants' verification vectors, then evaluate the
    aggregate polynomial at each id (dkg_math.rs:230-248).

    Like the reference, indexes every vector by the first vector's length —
    shorter vectors are an index error (guest panic)."""
    width = len(verification_vectors[0])
    final_cfs = []
    for i in range(width):
        acc = verification_vectors[0][i]
        for v in verification_vectors[1:]:
            acc = acc.add(v[i])
        final_cfs.append(acc)
    return [evaluate_polynomial(final_cfs, x, point_cls) for x in ids]
