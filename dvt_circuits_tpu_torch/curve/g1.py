"""Batched BLS12-381 G1 group operations and multi-scalar multiplication.

Port of ``dvt_circuits_tpu/curve/g1.py``.  Points are Jacobian triples
(X, Y, Z) of ``curve.fp`` limb tensors; the identity is Z = 0.  ``add`` and
``double`` keep the JAX package's branchless formulas and flag selects, so
their Jacobian limbs equal the JAX package's; they take the Fp product as
``mul`` (``fp.mont_mul``, kernel C1 on a CUDA tensor, by default).

Two MSM routes, each a wrapper of a hand kernel beside its plain version:

  * ``msm_jacobian`` — kernel C2 (``csrc/curve.cu:g1_msm_windowed``), the
    4-bit fixed-window scalar multiplication of every point and a tree
    reduction; plain version ``msm_plain`` (the JAX ``_msm_jit``);
  * ``msm_bucket_jacobian`` — kernel C3 (``csrc/curve.cu:g1_msm_bucket``),
    Pippenger buckets over GLV halves; plain version ``msm_bucket_plain``
    (the JAX ``_msm_bucket_jit``: sort by digit, Blelloch scan, prefix
    differences, the binary-weight trick, Horner).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  ``msm`` and ``msm_bucket`` are the host-in, host-out entry points.
The plain versions compute every Fp product with ``fp.mont_mul_plain``, so
on the card they share no code with the kernels they check.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from .. import kernels
from ..hostcrypto import bls12_381 as host
from . import fp

SCALAR_BITS = 256
WINDOW_BITS = 4
NUM_WINDOWS = SCALAR_BITS // WINDOW_BITS  # 64


def from_affine_points(points, device="cuda") -> tuple:
    """Host affine points ((x, y) ints or None) → Jacobian limb tensors."""
    xs, ys, zs = [], [], []
    for pt in points:
        if pt is None:
            xs.append(0)
            ys.append(1)
            zs.append(0)
        else:
            xs.append(pt[0])
            ys.append(pt[1])
            zs.append(1)
    return (fp.from_ints(xs, device), fp.from_ints(ys, device), fp.from_ints(zs, device))


def to_affine_points(p) -> list:
    """Jacobian limb tensors → host affine points (None for identity)."""
    X, Y, Z = (fp.to_ints(c) for c in p)
    out = []
    for x, y, z in zip(X, Y, Z):
        if z == 0:
            out.append(None)
        else:
            zinv = pow(z, host.P - 2, host.P)
            out.append((x * zinv * zinv % host.P, y * zinv * zinv % host.P * zinv % host.P))
    return out


def identity(shape=(), device="cuda") -> tuple:
    return (fp.zeros(shape, device), fp.ones_mont(shape, device), fp.zeros(shape, device))


def double(p, mul=fp.mont_mul):
    """Jacobian doubling (a = 0 curve); identity-safe (Z=0 → Z3=0)."""
    X, Y, Z = p
    A = mul(X, X)
    B = mul(Y, Y)
    C = mul(B, B)
    XB = fp.add(X, B)
    t = mul(XB, XB)
    D = fp.add(fp.sub(fp.sub(t, A), C), fp.sub(t, fp.add(A, C)))  # 2((X+B)²−A−C)
    E = fp.add(fp.add(A, A), A)
    F = mul(E, E)
    X3 = fp.sub(F, fp.add(D, D))
    C8 = fp.add(C, C)
    C8 = fp.add(C8, C8)
    C8 = fp.add(C8, C8)
    Y3 = fp.sub(mul(E, fp.sub(D, X3)), C8)
    YZ = mul(Y, Z)
    Z3 = fp.add(YZ, YZ)
    return (X3, Y3, Z3)


def add(p, q, mul=fp.mont_mul):
    """Branchless unified Jacobian addition."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = mul(Z1, Z1)
    Z2Z2 = mul(Z2, Z2)
    U1 = mul(X1, Z2Z2)
    U2 = mul(X2, Z1Z1)
    S1 = mul(mul(Y1, Z2), Z2Z2)
    S2 = mul(mul(Y2, Z1), Z1Z1)
    H = fp.sub(U2, U1)
    rr = fp.sub(S2, S1)
    rr = fp.add(rr, rr)  # r = 2(S2−S1)
    H2 = fp.add(H, H)
    I = mul(H2, H2)
    J = mul(H, I)
    V = mul(U1, I)
    X3 = fp.sub(fp.sub(mul(rr, rr), J), fp.add(V, V))
    SJ = mul(S1, J)
    Y3 = fp.sub(mul(rr, fp.sub(V, X3)), fp.add(SJ, SJ))
    Z12 = fp.add(Z1, Z2)
    ZZ = fp.sub(fp.sub(mul(Z12, Z12), Z1Z1), Z2Z2)
    Z3 = mul(ZZ, H)

    p_inf = fp.is_zero(Z1)
    q_inf = fp.is_zero(Z2)
    same_x = fp.is_zero(H)
    same_y = fp.is_zero(rr)
    dbl = double(p, mul)

    def sel(c, a, b):
        return tuple(fp.select(c, ca, cb) for ca, cb in zip(a, b))

    inf = identity(X1.shape[:-1], X1.device)
    res = sel(same_x & same_y, dbl, (X3, Y3, Z3))  # P == Q → double
    res = sel(same_x & ~same_y & ~p_inf & ~q_inf, inf, res)  # P == −Q → ∞
    res = sel(q_inf, p, res)
    res = sel(p_inf, q, res)
    return res


def scalars_to_bits(scalars, device="cuda") -> torch.Tensor:
    """Host ints → (n, 256) int32 bit tensor, little-endian bit order."""
    out = np.zeros((len(scalars), SCALAR_BITS), dtype=np.int32)
    for i, s in enumerate(scalars):
        s = int(s) % host.R
        for b in range(SCALAR_BITS):
            out[i, b] = (s >> b) & 1
    return torch.as_tensor(out, device=kernels.resolve_device(device))


def scalars_to_digits(scalars, device="cuda") -> torch.Tensor:
    """Host ints → (n, 64) int32 base-16 digits, most-significant first."""
    out = np.zeros((len(scalars), NUM_WINDOWS), dtype=np.int32)
    for i, s in enumerate(scalars):
        s = int(s) % host.R
        for w in range(NUM_WINDOWS):
            out[i, NUM_WINDOWS - 1 - w] = (s >> (WINDOW_BITS * w)) & 0xF
    return torch.as_tensor(out, device=kernels.resolve_device(device))


def scalar_mul_windowed(p, digits, mul=fp.mont_mul):
    """Batched fixed-window scalar multiplication: the 16-entry table
    T[j] = j·P per point (14 batched adds), then the 64 base-16 digits
    MSB-first, 4 doublings and one table add each."""
    batch = digits.shape[:-1]
    dev = digits.device
    table = [identity(batch, dev), p]
    for _ in range(14):
        table.append(add(table[-1], p, mul))
    T = tuple(torch.stack([t[c] for t in table]) for c in range(3))  # (16, n, 32)
    rows = torch.arange(batch[0], device=dev)
    acc = identity(batch, dev)
    for i in range(NUM_WINDOWS):
        for _ in range(WINDOW_BITS):
            acc = double(acc, mul)
        d = digits[:, i].long()
        acc = add(acc, tuple(c[d, rows] for c in T), mul)
    return acc


def scalar_mul(p, bits, mul=fp.mont_mul):
    """Batched double-and-add: p batched Jacobian, bits (n, 256).  A plain
    composition; on a CUDA tensor its products run through kernel C1."""
    acc = identity(bits.shape[:-1], bits.device)
    for i in range(SCALAR_BITS):
        b = SCALAR_BITS - 1 - i
        acc = double(acc, mul)
        added = add(acc, p, mul)
        bit = bits[:, b].bool()
        acc = tuple(fp.select(bit, a, c) for a, c in zip(added, acc))
    return acc


def _tree_reduce(p, mul=fp.mont_mul):
    """Reduce a batch of points ((n, 32) coords) to one with log n adds."""
    n = p[0].shape[0]
    while n > 1:
        half = n // 2
        a = tuple(c[:half] for c in p)
        b = tuple(c[half: 2 * half] for c in p)
        rest = tuple(c[2 * half:] for c in p)
        s = add(a, b, mul)
        p = tuple(torch.cat([cs, cr]) for cs, cr in zip(s, rest))
        n = p[0].shape[0]
    return tuple(c[0] for c in p)


def msm_plain(points, digits) -> tuple:
    """Σ dᵢ·Pᵢ as one Jacobian point ((32,) per coordinate), in plain
    PyTorch ops: the JAX ``_msm_jit`` (windowed scalar mul, tree reduce)."""
    per_point = scalar_mul_windowed(points, digits, fp.mont_mul_plain)
    return _tree_reduce(per_point, fp.mont_mul_plain)


def _check_points(points, n: int, device) -> tuple:
    if len(points) != 3:
        raise ValueError("expected a Jacobian (X, Y, Z) triple")
    for c in points:
        if c.dtype != torch.int64 or c.device != device or tuple(c.shape) != (n, fp.NLIMBS):
            raise ValueError(f"expected ({n}, {fp.NLIMBS}) int64 limbs on {device}, got "
                             f"{tuple(c.shape)} {c.dtype} on {c.device}")
    return tuple(c.contiguous() for c in points)


@lru_cache(maxsize=None)
def _library():
    lib = kernels.load("curve")
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.g1_msm_windowed.argtypes = [vp, vp, vp, vp, vp, vp, ll, vp]
    lib.g1_msm_windowed.restype = ctypes.c_int
    lib.g1_msm_bucket.argtypes = [vp, vp, vp, vp, ctypes.c_int, ll, ctypes.c_int, vp, vp, vp,
                                  vp]
    lib.g1_msm_bucket.restype = ctypes.c_int
    return lib


#: 32-bit words of one Jacobian point in the kernels' scratch: 3 × 12
_POINT_WORDS = 36


def msm_jacobian(points, digits) -> tuple:
    """Σ dᵢ·Pᵢ for ``points`` a batched Jacobian triple ((n, 32) int64 each)
    and ``digits`` (n, 64) int32 base-16 digits MSB-first; one Jacobian
    point ((32,) per coordinate).

    A CPU tensor takes ``msm_plain``; a CUDA tensor launches kernel C2
    (``csrc/curve.cu:g1_msm_windowed``: one thread per point, then a
    one-block tree reduction) or raises.  C2 replaces the XLA
    ``dvt_circuits_tpu/curve/g1.py:_msm_jit``."""
    if digits.dim() != 2 or digits.shape[1] != NUM_WINDOWS:
        raise ValueError(f"expected (n, {NUM_WINDOWS}) digits, got {tuple(digits.shape)}")
    if digits.device.type == "cpu":
        return msm_plain(points, digits)
    if digits.device.type != "cuda" or digits.dtype != torch.int32:
        raise ValueError(f"expected int32 digits on a CUDA device, got {digits.dtype} on "
                         f"{digits.device}")
    n = digits.shape[0]
    X, Y, Z = _check_points(points, n, digits.device)
    digits = digits.contiguous()
    out = torch.empty((3, fp.NLIMBS), dtype=torch.int64, device=digits.device)
    scratch = torch.empty((max(n, 1), _POINT_WORDS), dtype=torch.int32, device=digits.device)
    kernels.check(
        _library().g1_msm_windowed(X.data_ptr(), Y.data_ptr(), Z.data_ptr(), digits.data_ptr(),
                                   out.data_ptr(), scratch.data_ptr(), n,
                                   kernels.stream_handle(digits)),
        "g1_msm_windowed kernel launch",
    )
    msm_jacobian.launches += 1
    return tuple(out)


msm_jacobian.launches = 0


def msm(points_affine, scalars, device="cuda"):
    """Σ scalarᵢ·Pᵢ: batched windowed scalar-mul and tree reduction (C2 on
    the card).  points_affine: host affine tuples; scalars: host ints.
    Returns the host affine result."""
    p = from_affine_points(points_affine, device)
    digits = scalars_to_digits(scalars, device)
    out = msm_jacobian(p, digits)
    return to_affine_points(tuple(c[None] for c in out))[0]


# ---------------------------------------------------------------------------
# Pippenger bucket MSM with GLV decomposition.
#
# GLV: the BLS12-381 cube-root endomorphism φ(x, y) = (β·x, y) satisfies
# φ(P) = λ·P with λ = z²−1 (z the BLS parameter), so every 256-bit scalar
# splits into two ~128-bit halves over the lattice basis {(λ, −1), (1, z²)}.
# Signs fold into point negation (y → −y), doubling the point set and
# halving the window count.
# ---------------------------------------------------------------------------

_BLS_Z = -0xD201000000010000
GLV_LAMBDA = (_BLS_Z * _BLS_Z - 1) % host.R


def _find_beta() -> int:
    """The Fp cube root of unity matching GLV_LAMBDA (checked on G)."""
    for beta in (
        pow(2, (host.P - 1) // 3, host.P),
        pow(pow(2, (host.P - 1) // 3, host.P), 2, host.P),
    ):
        gx, gy = host.G1_GEN
        if host.g1_mul(host.G1_GEN, GLV_LAMBDA) == (gx * beta % host.P, gy):
            return beta
    raise AssertionError("no matching cube root for the GLV eigenvalue")


GLV_BETA = _find_beta()


def glv_decompose(k: int):
    """k ≡ k1 + k2·λ (mod r) with |k1|, |k2| ≈ √r — Babai rounding on the
    basis {(λ, −1), (1, z²)}.  Returns ((sign1, |k1|), (sign2, |k2|))."""
    k = int(k) % host.R
    z2 = _BLS_Z * _BLS_Z
    c1 = (k * z2 + host.R // 2) // host.R
    c2 = (k + host.R // 2) // host.R
    k1 = k - c1 * GLV_LAMBDA - c2 * 1
    k2 = c1 * 1 - c2 * z2
    if (k1 + k2 * GLV_LAMBDA) % host.R != k:
        raise AssertionError("GLV decomposition does not recompose")
    return (
        (1 if k1 >= 0 else -1, abs(k1)),
        (1 if k2 >= 0 else -1, abs(k2)),
    )


GLV_BITS = 130  # |k_i| < √r·(1+ε); 130 bits is a safe static bound


def _bucket_digits(values, window_bits: int) -> np.ndarray:
    """(m,) host ints → (m, nwin) digits, most-significant window first."""
    nwin = -(-GLV_BITS // window_bits)
    out = np.zeros((len(values), nwin), dtype=np.int32)
    mask = (1 << window_bits) - 1
    for i, v in enumerate(values):
        v = int(v)
        for w in range(nwin):
            out[i, nwin - 1 - w] = (v >> (window_bits * w)) & mask
    return out


def _neg_point(p):
    return (p[0], fp.neg(p[1]), p[2])


def default_window_bits(n: int) -> int:
    """The bucket width ``msm_bucket`` picks for n points (2n GLV halves)."""
    return max(2, min(8, (2 * n).bit_length() - 1))


def bucket_inputs(points_affine, scalars, window_bits: int, device="cuda"):
    """The GLV split and padding of ``msm_bucket``: (Jacobian points, (m, nwin)
    int32 digits) with m = 2n padded to a power of two by identity points at
    digit 0."""
    pts = []
    subscalars = []
    for pt, s in zip(points_affine, scalars):
        (s1, a1), (s2, a2) = glv_decompose(s)
        if pt is None:
            pts += [None, None]
        else:
            x, y = pt
            pts.append((x, y if s1 > 0 else (host.P - y) % host.P))
            bx = x * GLV_BETA % host.P
            pts.append((bx, y if s2 > 0 else (host.P - y) % host.P))
        subscalars += [a1, a2]
    m = len(pts)
    m2 = 1 << max(m - 1, 1).bit_length()
    pts += [None] * (m2 - m)
    subscalars += [0] * (m2 - m)
    p = from_affine_points(pts, device)
    digits = torch.as_tensor(_bucket_digits(subscalars, window_bits), device=p[0].device)
    return p, digits


def msm_bucket_plain(p, digits, window_bits: int) -> tuple:
    """The JAX ``_msm_bucket_jit`` in plain PyTorch ops.  p: (m,)-batched
    Jacobian, m a power of two; digits: (m, nwin) int32 MSB-first."""
    mul = fp.mont_mul_plain
    m, nwin = digits.shape
    nbuckets = (1 << window_bits) - 1
    dev = digits.device
    nl = fp.NLIMBS

    # sort each window's points by digit: (nwin, m) gather indices
    order = torch.argsort(digits, dim=0, stable=True).T  # (nwin, m)
    sorted_digits = torch.gather(digits, 0, order.T).T.contiguous()  # (nwin, m)
    v = tuple(c[order] for c in p)  # (nwin, m, 32)

    # group-law EXCLUSIVE prefix scan along the point axis (Blelloch)
    step = 2
    while step <= m:
        vr = tuple(c.reshape(nwin, m // step, step, nl).clone() for c in v)
        left = tuple(c[:, :, step // 2 - 1] for c in vr)
        right = tuple(c[:, :, step - 1] for c in vr)
        s = add(right, left, mul)
        for c, sc in zip(vr, s):
            c[:, :, step - 1] = sc
        v = tuple(c.reshape(nwin, m, nl) for c in vr)
        step *= 2
    total = tuple(c[:, m - 1] for c in v)  # (nwin, 32): Σ of the window
    v = tuple(c.clone() for c in v)
    for c, i in zip(v, identity((nwin,), dev)):
        c[:, m - 1] = i
    step = m
    while step >= 2:
        vr = tuple(c.reshape(nwin, m // step, step, nl).clone() for c in v)
        left = tuple(c[:, :, step // 2 - 1] for c in vr)
        right = tuple(c[:, :, step - 1].clone() for c in vr)
        s = add(left, right, mul)
        for c, r, sc in zip(vr, right, s):
            c[:, :, step // 2 - 1] = r
            c[:, :, step - 1] = sc
        v = tuple(c.reshape(nwin, m, nl) for c in vr)
        step //= 2
    # E[i] = Σ_{j<i} P_j; V(m) = Σ all
    prefix_ext = tuple(torch.cat([c, t[:, None]], 1) for c, t in zip(v, total))

    # bucket sums via exclusive-prefix differences at digit-run boundaries:
    # Σ_{digit=b} = V(last(b)+1) − V(last(b−1)+1)
    buckets = torch.arange(1, nbuckets + 1, dtype=torch.int32, device=dev)
    bk = buckets.expand(nwin, nbuckets).contiguous()
    li = torch.searchsorted(sorted_digits, bk, right=True) - 1  # (nwin, nb)
    li_prev = torch.searchsorted(sorted_digits, bk - 1, right=True) - 1

    def pick(idx_plus1):
        return tuple(torch.gather(c, 1, idx_plus1[:, :, None].expand(-1, -1, nl))
                     for c in prefix_ext)  # (nwin, nb, 32)

    bucket_sums = add(pick(li + 1), _neg_point(pick(li_prev + 1)), mul)

    # Σ b·S_b per window via the binary-weight trick, all (bit, window)
    # pairs through one tree reduction over the bucket axis
    bit_masks = torch.stack([((buckets >> j) & 1).bool() for j in range(window_bits)])
    mask_b = bit_masks[:, None, :].expand(window_bits, nwin, nbuckets).reshape(
        window_bits * nwin, nbuckets)
    ident = identity((window_bits * nwin, nbuckets), dev)
    t = tuple(
        fp.select(mask_b,
                  c[None].expand(window_bits, *c.shape).reshape(window_bits * nwin, nbuckets, nl),
                  ident[ci])
        for ci, c in enumerate(bucket_sums)
    )
    nb = nbuckets
    while nb > 1:
        half = nb // 2
        a = tuple(c[:, :half] for c in t)
        b2 = tuple(c[:, half: 2 * half] for c in t)
        rest = tuple(c[:, 2 * half:] for c in t)
        s = add(a, b2, mul)
        t = tuple(torch.cat([cs, cr], 1) for cs, cr in zip(s, rest))
        nb = t[0].shape[1]
    T = tuple(c[:, 0].reshape(window_bits, nwin, nl) for c in t)

    # per-window Horner over bits, batched over windows
    win_sums = tuple(c[window_bits - 1] for c in T)
    for j in range(window_bits - 2, -1, -1):
        win_sums = add(double(win_sums, mul), tuple(c[j] for c in T), mul)

    # cross-window Horner, MSB window first
    acc = tuple(c[0] for c in win_sums)
    for w in range(1, nwin):
        for _ in range(window_bits):
            acc = double(acc, mul)
        acc = add(acc, tuple(c[w] for c in win_sums), mul)
    return acc


def msm_bucket_jacobian(points, digits, window_bits: int) -> tuple:
    """Σ dᵢ·Pᵢ over ``window_bits``-bit windows for ``points`` a batched
    Jacobian triple ((m, 32) int64 each, m a power of two) and ``digits``
    (m, nwin) int32 MSB-first; one Jacobian point.

    A CPU tensor takes ``msm_bucket_plain``; a CUDA tensor launches kernel
    C3 (``csrc/curve.cu:g1_msm_bucket``: one thread per (window, bucket),
    one per window for Σ b·S_b, one for the cross-window Horner) or raises.
    C3 replaces the XLA ``dvt_circuits_tpu/curve/g1.py:_msm_bucket_jit``.
    The two agree on the affine point, not on the Jacobian limbs: their
    additions run in different orders."""
    if not 2 <= window_bits <= 8:
        raise ValueError(f"window_bits {window_bits} outside [2, 8]")
    if digits.dim() != 2:
        raise ValueError(f"expected (m, nwin) digits, got {tuple(digits.shape)}")
    if digits.device.type == "cpu":
        return msm_bucket_plain(points, digits, window_bits)
    if digits.device.type != "cuda" or digits.dtype != torch.int32:
        raise ValueError(f"expected int32 digits on a CUDA device, got {digits.dtype} on "
                         f"{digits.device}")
    m, nwin = digits.shape
    X, Y, Z = _check_points(points, m, digits.device)
    digits = digits.contiguous()
    nbuckets = (1 << window_bits) - 1
    dev = digits.device
    out = torch.empty((3, fp.NLIMBS), dtype=torch.int64, device=dev)
    bucket_scratch = torch.empty((nwin * nbuckets, _POINT_WORDS), dtype=torch.int32, device=dev)
    window_scratch = torch.empty((nwin, _POINT_WORDS), dtype=torch.int32, device=dev)
    kernels.check(
        _library().g1_msm_bucket(X.data_ptr(), Y.data_ptr(), Z.data_ptr(), digits.data_ptr(),
                                 window_bits, m, nwin, out.data_ptr(), bucket_scratch.data_ptr(),
                                 window_scratch.data_ptr(), kernels.stream_handle(digits)),
        "g1_msm_bucket kernel launch",
    )
    msm_bucket_jacobian.launches += 1
    return tuple(out)


msm_bucket_jacobian.launches = 0


def msm_bucket(points_affine, scalars, window_bits: int | None = None, device="cuda"):
    """Σ scalarᵢ·Pᵢ via GLV + bucket accumulation (C3 on the card); host
    affine points and ints in, the host affine point out."""
    if window_bits is None:
        window_bits = default_window_bits(len(points_affine))
    p, digits = bucket_inputs(points_affine, scalars, window_bits, device)
    out = msm_bucket_jacobian(p, digits, window_bits)
    return to_affine_points(tuple(c[None] for c in out))[0]
