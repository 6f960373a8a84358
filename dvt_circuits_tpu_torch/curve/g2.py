"""Batched BLS12-381 G2 group operations (Fp² towers over ``curve.fp``).

Port of ``dvt_circuits_tpu/curve/g2.py``.  Points are Jacobian triples of
Fp² elements, each a pair (c0, c1) of ``fp`` limb tensors (c0 + c1·u,
u² = −1), with the JAX package's branchless formulas and flag selects, so
``add`` and ``double`` give its Jacobian limbs.  They take the Fp product
as ``mul`` (``fp.mont_mul``, kernel C1 on a CUDA tensor, by default).

``scalar_mul`` is the wrapper of kernel C4 (``csrc/curve.cu:g2_scalar_mul``,
a warp per point, 256 double-and-add rounds over Fp², each point operation
spread over the warp's lanes, ``csrc/bls12_381_lanes.cuh``): a CUDA tensor
launches it, a CPU tensor takes ``scalar_mul_plain`` (the JAX
``scalar_mul``, every product through ``fp.mont_mul_plain``).  The kernel
runs the same formulas and picks what the JAX selects pick, so the two
agree limb for limb.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from .. import kernels
from ..hostcrypto import bls12_381 as host
from . import fp

SCALAR_BITS = 256


# -- Fp² arithmetic: (c0, c1) pairs of (…, 32) limb tensors ------------------


def f2_add(a, b):
    return (fp.add(a[0], b[0]), fp.add(a[1], b[1]))


def f2_sub(a, b):
    return (fp.sub(a[0], b[0]), fp.sub(a[1], b[1]))


def f2_neg(a):
    return (fp.neg(a[0]), fp.neg(a[1]))


def f2_mul(a, b, mul=fp.mont_mul):
    """Karatsuba: 3 base products."""
    t0 = mul(a[0], b[0])
    t1 = mul(a[1], b[1])
    t2 = mul(fp.add(a[0], a[1]), fp.add(b[0], b[1]))
    return (fp.sub(t0, t1), fp.sub(fp.sub(t2, t0), t1))


def f2_sq(a, mul=fp.mont_mul):
    """(c0+c1u)² = (c0+c1)(c0−c1) + 2c0c1·u — 2 base products."""
    t0 = mul(fp.add(a[0], a[1]), fp.sub(a[0], a[1]))
    t1 = mul(a[0], a[1])
    return (t0, fp.add(t1, t1))


def f2_is_zero(a):
    return fp.is_zero(a[0]) & fp.is_zero(a[1])


def f2_select(c, a, b):
    return (fp.select(c, a[0], b[0]), fp.select(c, a[1], b[1]))


def f2_zeros(shape=(), device="cuda"):
    return (fp.zeros(shape, device), fp.zeros(shape, device))


def f2_ones(shape=(), device="cuda"):
    return (fp.ones_mont(shape, device), fp.zeros(shape, device))


# -- Jacobian G2 -------------------------------------------------------------


def from_host_points(points, device="cuda") -> tuple:
    """Host affine G2 points (((x0,x1),(y0,y1)) or None) → Jacobian tensors."""
    x0, x1, y0, y1, z0 = [], [], [], [], []
    for pt in points:
        if pt is None:
            x0.append(0); x1.append(0); y0.append(1); y1.append(0); z0.append(0)  # noqa: E702
        else:
            (a0, a1), (b0, b1) = pt
            x0.append(a0); x1.append(a1); y0.append(b0); y1.append(b1); z0.append(1)  # noqa: E702
    X = (fp.from_ints(x0, device), fp.from_ints(x1, device))
    Y = (fp.from_ints(y0, device), fp.from_ints(y1, device))
    Z = (fp.from_ints(z0, device), fp.zeros((len(points),), X[0].device))
    return (X, Y, Z)


def to_host_points(p) -> list:
    """Jacobian tensors → host affine G2 points (None for identity)."""
    (X0, X1), (Y0, Y1), (Z0, Z1) = p
    xs0, xs1 = fp.to_ints(X0), fp.to_ints(X1)
    ys0, ys1 = fp.to_ints(Y0), fp.to_ints(Y1)
    zs0, zs1 = fp.to_ints(Z0), fp.to_ints(Z1)
    out = []
    for a0, a1, b0, b1, c0, c1 in zip(xs0, xs1, ys0, ys1, zs0, zs1):
        if c0 == 0 and c1 == 0:
            out.append(None)
            continue
        zinv = host.fp2_inv((c0, c1))
        zi2 = host.fp2_sq(zinv)
        zi3 = host.fp2_mul(zi2, zinv)
        out.append((host.fp2_mul((a0, a1), zi2), host.fp2_mul((b0, b1), zi3)))
    return out


def identity(shape=(), device="cuda") -> tuple:
    return (f2_zeros(shape, device), f2_ones(shape, device), f2_zeros(shape, device))


def double(p, mul=fp.mont_mul):
    """Jacobian doubling (a = 0); identity-safe (Z=0 → Z3=0)."""
    X, Y, Z = p
    A = f2_sq(X, mul)
    B = f2_sq(Y, mul)
    C = f2_sq(B, mul)
    t = f2_sq(f2_add(X, B), mul)
    D = f2_add(f2_sub(f2_sub(t, A), C), f2_sub(t, f2_add(A, C)))
    E = f2_add(f2_add(A, A), A)
    F = f2_sq(E, mul)
    X3 = f2_sub(F, f2_add(D, D))
    C8 = f2_add(C, C)
    C8 = f2_add(C8, C8)
    C8 = f2_add(C8, C8)
    Y3 = f2_sub(f2_mul(E, f2_sub(D, X3), mul), C8)
    YZ = f2_mul(Y, Z, mul)
    Z3 = f2_add(YZ, YZ)
    return (X3, Y3, Z3)


def add(p, q, mul=fp.mont_mul):
    """Branchless unified Jacobian addition (mirrors ``g1.add``)."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = f2_sq(Z1, mul)
    Z2Z2 = f2_sq(Z2, mul)
    U1 = f2_mul(X1, Z2Z2, mul)
    U2 = f2_mul(X2, Z1Z1, mul)
    S1 = f2_mul(f2_mul(Y1, Z2, mul), Z2Z2, mul)
    S2 = f2_mul(f2_mul(Y2, Z1, mul), Z1Z1, mul)
    H = f2_sub(U2, U1)
    rr = f2_sub(S2, S1)
    rr = f2_add(rr, rr)
    I = f2_sq(f2_add(H, H), mul)
    J = f2_mul(H, I, mul)
    V = f2_mul(U1, I, mul)
    X3 = f2_sub(f2_sub(f2_sq(rr, mul), J), f2_add(V, V))
    SJ = f2_mul(S1, J, mul)
    Y3 = f2_sub(f2_mul(rr, f2_sub(V, X3), mul), f2_add(SJ, SJ))
    ZZ = f2_sub(f2_sub(f2_sq(f2_add(Z1, Z2), mul), Z1Z1), Z2Z2)
    Z3 = f2_mul(ZZ, H, mul)

    p_inf = f2_is_zero(Z1)
    q_inf = f2_is_zero(Z2)
    same_x = f2_is_zero(H)
    same_y = f2_is_zero(rr)
    dbl = double(p, mul)

    def sel(c, a, b):
        return tuple(f2_select(c, ca, cb) for ca, cb in zip(a, b))

    inf = identity(Z1[0].shape[:-1], Z1[0].device)
    res = sel(same_x & same_y, dbl, (X3, Y3, Z3))
    res = sel(same_x & ~same_y & ~p_inf & ~q_inf, inf, res)
    res = sel(q_inf, p, res)
    res = sel(p_inf, q, res)
    return res


def scalar_mul_plain(p, bits):
    """Batched double-and-add over a (n, 256) little-endian bit tensor, in
    plain PyTorch ops (the JAX ``scalar_mul``)."""
    mul = fp.mont_mul_plain
    acc = identity(bits.shape[:-1], bits.device)
    for i in range(SCALAR_BITS):
        b = SCALAR_BITS - 1 - i
        acc = double(acc, mul)
        added = add(acc, p, mul)
        bit = bits[:, b].bool()
        acc = tuple(f2_select(bit, a, c) for a, c in zip(added, acc))
    return acc


@lru_cache(maxsize=None)
def _library():
    lib = kernels.load("curve")
    vp = ctypes.c_void_p
    lib.g2_scalar_mul.argtypes = [vp, vp, vp, vp, vp, ctypes.c_longlong, vp]
    lib.g2_scalar_mul.restype = ctypes.c_int
    return lib


def scalar_mul(p, bits):
    """b·P for every point of ``p`` (a batched Jacobian G2 triple of Fp²
    pairs, (n, 32) int64 each) and its row of ``bits`` ((n, 256) int32,
    little-endian); a batched Jacobian triple.

    A CPU tensor takes ``scalar_mul_plain``; a CUDA tensor launches kernel
    C4 (``csrc/curve.cu:g2_scalar_mul``, a warp per point) or raises.
    C4 replaces the XLA ``dvt_circuits_tpu/curve/g2.py:scalar_mul``."""
    if bits.dim() != 2 or bits.shape[1] != SCALAR_BITS:
        raise ValueError(f"expected (n, {SCALAR_BITS}) bits, got {tuple(bits.shape)}")
    if bits.device.type == "cpu":
        return scalar_mul_plain(p, bits)
    if bits.device.type != "cuda" or bits.dtype != torch.int32:
        raise ValueError(f"expected int32 bits on a CUDA device, got {bits.dtype} on "
                         f"{bits.device}")
    n = bits.shape[0]
    coords = []
    for pair in p:
        for c in pair:
            if c.dtype != torch.int64 or c.device != bits.device or \
                    tuple(c.shape) != (n, fp.NLIMBS):
                raise ValueError(f"expected ({n}, {fp.NLIMBS}) int64 limbs on {bits.device}")
        # (n, 2, 32): c0 and c1 of each point side by side
        coords.append(torch.stack(pair, 1).contiguous())
    bits = bits.contiguous()
    out = torch.empty((3, n, 2, fp.NLIMBS), dtype=torch.int64, device=bits.device)
    if n:
        kernels.check(
            _library().g2_scalar_mul(coords[0].data_ptr(), coords[1].data_ptr(),
                                     coords[2].data_ptr(), bits.data_ptr(), out.data_ptr(), n,
                                     kernels.stream_handle(bits)),
            "g2_scalar_mul kernel launch",
        )
        scalar_mul.launches += 1
    return tuple((c[:, 0], c[:, 1]) for c in out)


scalar_mul.launches = 0
