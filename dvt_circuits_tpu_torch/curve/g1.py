"""Batched BLS12-381 G1 group operations and multi-scalar multiplication.

Port of ``dvt_circuits_tpu/curve/g1.py``.  Points are Jacobian triples
(X, Y, Z) of ``curve.fp`` limb tensors; the identity is Z = 0.  ``add`` and
``double`` keep the JAX package's branchless formulas and flag selects, so
their Jacobian limbs equal the JAX package's; they take the Fp product as
``mul`` (``fp.mont_mul``, kernel C1 on a CUDA tensor, by default).

Two MSM routes, each a wrapper of a hand kernel beside its plain version:

  * ``msm_jacobian`` — kernel C2 (``csrc/curve.cu:g1_msm_windowed``), the
    4-bit fixed-window scalar multiplication of every point and a tree
    reduction, each point operation spread over 4 lanes
    (``csrc/bls12_381_lanes.cuh``); plain version ``msm_plain`` (the JAX
    ``_msm_jit``);
  * ``msm_bucket_jacobian`` — kernel C3 (``csrc/curve.cu``, four launches:
    C3a a stable counting sort by digit, C3b chunked bucket sums, C3c
    grouped window sums, C3d the Horner), Pippenger buckets over GLV
    halves; plain version ``msm_bucket_plain``, the same stages in plain
    PyTorch ops, adding in the kernel's order (the JAX ``_msm_bucket_jit``
    sorts, scans and takes prefix differences instead, and agrees on the
    affine point).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  ``msm`` and ``msm_bucket`` are the host-in, host-out entry points.
The plain versions compute every Fp product with ``fp.mont_mul_plain``, so
on the card they share no code with the kernels they check.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from types import SimpleNamespace

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
    i = ctypes.c_int
    lib.g1_bucket_sort.argtypes = [vp, i, i, i, vp, vp, vp, vp]
    lib.g1_bucket_sums.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, vp, vp, vp, vp]
    lib.g1_window_sums.argtypes = [vp, i, i, vp, vp]
    lib.g1_horner.argtypes = [vp, i, i, vp, vp]
    for fn in (lib.g1_bucket_sort, lib.g1_bucket_sums, lib.g1_window_sums, lib.g1_horner):
        fn.restype = ctypes.c_int
    return lib


#: 32-bit words of one Jacobian point in the kernels' scratch: 3 × 12
_POINT_WORDS = 36


def msm_jacobian(points, digits) -> tuple:
    """Σ dᵢ·Pᵢ for ``points`` a batched Jacobian triple ((n, 32) int64 each)
    and ``digits`` (n, 64) int32 base-16 digits MSB-first; one Jacobian
    point ((32,) per coordinate).

    A CPU tensor takes ``msm_plain``; a CUDA tensor launches kernel C2
    (``csrc/curve.cu:g1_msm_windowed``: 4 lanes a point, then the tree
    reduction one launch a level) or raises.  C2 replaces the XLA
    ``dvt_circuits_tpu/curve/g1.py:_msm_jit``.  ``launches`` counts one a
    call; the call makes 1 + ceil(log2 n) device launches for n ≥ 2."""
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
    # the per-point results, then the tree's other buffer (ceil(n / 2) points)
    scratch = torch.empty((max(n + (n + 1) // 2, 1), _POINT_WORDS), dtype=torch.int32,
                          device=digits.device)
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


def dist_msm(points_affine, scalars, mesh, axis_name: str = "sp"):
    """``msm`` with the points in contiguous blocks over the ranks of
    ``axis_name`` (``dvt_circuits_tpu/curve/g1.py:dist_msm``): the batch is
    padded to a multiple of d with identity points, each rank sums its block
    through ``msm_jacobian`` (C2 on the card), and the d Jacobian partials
    are all-gathered and folded by ``_tree_reduce`` (products through C1).
    Every rank calls it with the same arguments and gets the host affine
    result."""
    from ..parallel.comm import all_gather

    ax = mesh.axis(axis_name)
    pad = -len(points_affine) % ax.size
    points = list(points_affine) + [None] * pad
    scalars = list(scalars) + [0] * pad
    per = len(points) // ax.size
    mine = slice(ax.index * per, (ax.index + 1) * per)
    part = msm_jacobian(from_affine_points(points[mine], ax.device),
                        scalars_to_digits(scalars[mine], ax.device))
    parts = all_gather(torch.stack(part), ax)  # (d, 3, 32)
    out = _tree_reduce(tuple(c.contiguous() for c in parts.unbind(1)))
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


#: kernel C3's constants (``csrc/curve.cu``: ``kChunk``, ``kGroups``): the
#: sorted entries one thread of C3b adds, and the groups of consecutive
#: buckets C3c cuts a window into
BUCKET_CHUNK = 8
WINDOW_GROUPS = 64
#: C3's stages, in launch order, each with the count of its launches
stage_counts = {name: SimpleNamespace(launches=0)
                for name in ("g1_bucket_sort", "g1_bucket_sums", "g1_window_sums", "g1_horner")}


def _select_points(cond, a, b):
    return tuple(fp.select(cond, ca, cb) for ca, cb in zip(a, b))


def bucket_sort_plain(digits, window_bits: int):
    """C3a: for each window a stable sort of the points by digit.  Returns
    ``idx`` (nwin, m) int32, the point indices in digit order (index order
    inside a bucket, as ``torch.argsort(stable=True)`` gives), and
    ``offsets`` (nwin, 2^w + 1) int32, where bucket b starts."""
    d = digits.T.long()
    nwin = d.shape[0]
    counts = torch.zeros((nwin, 1 << window_bits), dtype=torch.int64, device=d.device)
    counts.scatter_add_(1, d, torch.ones_like(d))
    offsets = torch.zeros((nwin, (1 << window_bits) + 1), dtype=torch.int64, device=d.device)
    offsets[:, 1:] = counts.cumsum(1)
    return (torch.argsort(d, dim=1, stable=True).to(torch.int32), offsets.to(torch.int32))


def _bucket_slots(offsets, chunk: int):
    """C3b's layout of the partial sums, from the offsets (host numpy):
    bucket b's partials sit in the slots from (offsets[b] - offsets[1]) //
    chunk + b - 1, one per chunk its entries touch.  Returns (first slot,
    count of partials), each (nwin, 2^w - 1), the count 0 for an empty
    bucket."""
    off = offsets.cpu().numpy().astype(np.int64)
    o1 = off[:, 1:2]
    lo, hi = off[:, 1:-1], off[:, 2:]  # bucket b = 1 .. 2^w - 1: [lo, hi)
    nb = lo.shape[1]
    first = (lo - o1) // chunk + np.arange(nb)
    count = np.where(hi > lo, (hi - 1 - o1) // chunk - (lo - o1) // chunk + 1, 0)
    return first, count


def bucket_sums_plain(p, digits, idx, offsets, window_bits: int, chunk: int = BUCKET_CHUNK):
    """C3b: S_{v,b} for every window v and bucket b = 1 .. 2^w - 1, as
    (nwin, 2^w - 1, 32) per coordinate (the identity for an empty bucket).

    Each window's sorted nonzero entries are cut into chunks of ``chunk``;
    a chunk adds its runs of equal digit in order (acc = add(acc, P)), one
    partial per (chunk, bucket); then each bucket's partials are joined by a
    tree (j and j + s at level s = 1, 2, 4, ..., j a multiple of 2s): the
    additions of the kernel, in its order."""
    mul = fp.mont_mul_plain
    m, nwin = digits.shape
    nb = (1 << window_bits) - 1
    dev = digits.device
    nchunks = -(-m // chunk)
    nslots = nchunks + nb
    idx_l = idx.long()
    sorted_digits = torch.gather(digits.T.long(), 1, idx_l)  # (nwin, m)
    o1 = offsets[:, 1:2].long()
    cidx = torch.arange(nchunks, device=dev)
    rows = torch.arange(nwin, device=dev)[:, None].expand(nwin, nchunks)
    partial = tuple(c.clone() for c in identity((nwin, nslots), dev))

    def close(mask, d, acc):
        slot = (cidx + d - 1).clamp(0, nslots - 1)
        for c, a in zip(partial, acc):
            c[rows[mask], slot[mask]] = a[mask]

    acc, prev = None, None
    for k in range(min(chunk, m)):  # a chunk holds at most m entries
        s = o1 + cidx * chunk + k  # (nwin, nchunks) sorted positions
        active = s < m
        s = s.clamp(max=m - 1)
        d = torch.gather(sorted_digits, 1, s)
        point_idx = torch.gather(idx_l, 1, s)
        pt = tuple(c[point_idx] for c in p)
        if k == 0:
            acc, prev, has = pt, d, active
            continue
        new_run = d != prev
        close(active & new_run, prev, acc)
        nxt = _select_points(new_run, pt, add(acc, pt, mul))
        acc = _select_points(active, nxt, acc)
        prev = torch.where(active, d, prev)
    close(has, prev, acc)

    first, count = _bucket_slots(offsets, chunk)
    kmax = int(count.max(initial=0))
    s = 1
    while s < kmax:
        j = np.arange(0, kmax, 2 * s)
        take = j[None, None, :] + s < count[:, :, None]  # (nwin, nb, pairs)
        v = np.broadcast_to(np.arange(nwin)[:, None, None], take.shape)[take]
        t = (first[:, :, None] + j[None, None, :])[take]
        v, t = torch.as_tensor(v, device=dev), torch.as_tensor(t, device=dev)
        summed = add(tuple(c[v, t] for c in partial), tuple(c[v, t + s] for c in partial), mul)
        for c, a in zip(partial, summed):
            c[v, t] = a
        s *= 2
    nonempty = torch.as_tensor(count > 0, device=dev)
    slots = torch.as_tensor(np.where(count > 0, first, 0), device=dev)
    picked = tuple(torch.gather(c, 1, slots[:, :, None].expand(-1, -1, fp.NLIMBS))
                   for c in partial)
    return _select_points(nonempty, picked, identity((nwin, nb), dev))


def window_sums_plain(buckets, window_bits: int, groups: int = WINDOW_GROUPS):
    """C3c: W_v = sum_b b * S_{v,b} for every window, (nwin, 32) per
    coordinate, from ``buckets`` (nwin, 2^w - 1, 32) per coordinate.

    The buckets are cut into groups of L = ceil((2^w - 1) / groups)
    consecutive buckets [b_lo, b_hi]; each group runs R = sum S_b and
    U = sum (b - b_lo + 1) S_b as running sums from b_hi down, then
    W_g = U + (b_lo - 1) R by w bits of double-and-add from the top; a tree
    over the groups (g and g + s at level s) gives W_v."""
    mul = fp.mont_mul_plain
    nwin, nb = buckets[0].shape[:2]
    dev = buckets[0].device
    length = -(-nb // groups)
    ng = -(-nb // length)
    b_lo = torch.arange(ng, device=dev) * length + 1
    b_hi = (b_lo + length - 1).clamp(max=nb)
    r = tuple(c[:, b_hi - 1] for c in buckets)  # (nwin, ng, 32)
    u = r
    for step in range(1, length):
        b = b_hi - step
        active = (b >= b_lo).expand(nwin, ng)
        r2 = add(r, tuple(c[:, (b - 1).clamp(min=0)] for c in buckets), mul)
        u2 = add(u, r2, mul)
        r, u = _select_points(active, r2, r), _select_points(active, u2, u)
    q = identity((nwin, ng), dev)
    for j in range(window_bits - 1, -1, -1):
        q = double(q, mul)
        bit = (((b_lo - 1) >> j) & 1).bool().expand(nwin, ng)
        q = _select_points(bit, add(q, r, mul), q)
    w = tuple(c.clone() for c in add(u, q, mul))
    s = 1
    while s < ng:
        g = torch.arange(0, ng - s, 2 * s, device=dev)
        summed = add(tuple(c[:, g] for c in w), tuple(c[:, g + s] for c in w), mul)
        for c, a in zip(w, summed):
            c[:, g] = a
        s *= 2
    return tuple(c[:, 0] for c in w)


def horner_plain(windows, window_bits: int):
    """C3d: the windows ((nwin, 32) per coordinate), most significant first,
    joined by ``window_bits`` doublings each."""
    mul = fp.mont_mul_plain
    acc = tuple(c[0] for c in windows)
    for v in range(1, windows[0].shape[0]):
        for _ in range(window_bits):
            acc = double(acc, mul)
        acc = add(acc, tuple(c[v] for c in windows), mul)
    return acc


def msm_bucket_plain(p, digits, window_bits: int, *, chunk: int = BUCKET_CHUNK,
                     groups: int = WINDOW_GROUPS) -> tuple:
    """Kernel C3's staged algorithm in plain PyTorch ops, every addition in
    its order, so the two give the same Jacobian limbs: the stable sort by
    digit (C3a), the chunked bucket sums and their trees (C3b), the grouped
    window sums (C3c) and the cross-window Horner (C3d).  p: (m,)-batched
    Jacobian; digits: (m, nwin) int32 MSB-first.  Every Fp product goes
    through ``fp.mont_mul_plain``."""
    idx, offsets = bucket_sort_plain(digits, window_bits)
    buckets = bucket_sums_plain(p, digits, idx, offsets, window_bits, chunk)
    return horner_plain(window_sums_plain(buckets, window_bits, groups), window_bits)


def _bucket_launches(points, digits, window_bits: int):
    """C3's four launches over fresh scratch, for ``msm_bucket_jacobian`` and
    for timing and checking each stage: ({stage: launch}, buffers), where
    calling the launches in order fills ``buffers``: "idx" and "offsets"
    (C3a), "buckets" (C3b, (nwin, 2^w - 1, 36) int32 words, x, y, z by 12),
    "windows" (C3c, (nwin, 36)) and "out" (C3d, Σ dᵢ·Pᵢ as (3, 32) int64
    Jacobian limbs).  Each launch adds one to its stage's count."""
    m, nwin = digits.shape
    X, Y, Z = _check_points(points, m, digits.device)
    digits = digits.contiguous()
    nb = (1 << window_bits) - 1
    nslots = -(-m // BUCKET_CHUNK) + nb
    dev = digits.device

    def scratch(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    idx, offsets, arrive = scratch(nwin, m), scratch(nwin, nb + 2), scratch(nwin, nslots)
    partial = scratch(nwin, nslots, _POINT_WORDS)
    buckets, windows = scratch(nwin, nb, _POINT_WORDS), scratch(nwin, _POINT_WORDS)
    out = torch.empty((3, fp.NLIMBS), dtype=torch.int64, device=dev)
    lib = _library()
    stream = kernels.stream_handle(digits)
    calls = {
        "g1_bucket_sort": lambda: lib.g1_bucket_sort(
            digits.data_ptr(), window_bits, m, nwin, idx.data_ptr(), offsets.data_ptr(),
            arrive.data_ptr(), stream),
        "g1_bucket_sums": lambda: lib.g1_bucket_sums(
            X.data_ptr(), Y.data_ptr(), Z.data_ptr(), digits.data_ptr(), idx.data_ptr(),
            offsets.data_ptr(), window_bits, m, nwin, partial.data_ptr(), arrive.data_ptr(),
            buckets.data_ptr(), stream),
        "g1_window_sums": lambda: lib.g1_window_sums(
            buckets.data_ptr(), window_bits, nwin, windows.data_ptr(), stream),
        "g1_horner": lambda: lib.g1_horner(
            windows.data_ptr(), window_bits, nwin, out.data_ptr(), stream),
    }

    def launch(name, call):
        def run():
            kernels.check(call(), f"C3 {name} kernel launch")
            stage_counts[name].launches += 1
        return run

    buffers = {"idx": idx, "offsets": offsets, "buckets": buckets, "windows": windows,
               "out": out}
    return {name: launch(name, call) for name, call in calls.items()}, buffers


def msm_bucket_jacobian(points, digits, window_bits: int) -> tuple:
    """Σ dᵢ·Pᵢ over ``window_bits``-bit windows for ``points`` a batched
    Jacobian triple ((m, 32) int64 each, m a power of two) and ``digits``
    (m, nwin) int32 MSB-first, each in [0, 2^w); one Jacobian point.

    A CPU tensor takes ``msm_bucket_plain``; a CUDA tensor launches kernel
    C3 (``csrc/curve.cu``: C3a the counting sort, C3b the chunked bucket
    sums, C3c the grouped window sums, C3d the Horner) or raises.  C3
    replaces the XLA ``dvt_circuits_tpu/curve/g1.py:_msm_bucket_jit``.  The
    kernel and ``msm_bucket_plain`` add in the same order, so they give the
    same Jacobian limbs; the JAX algorithm agrees on the affine point."""
    if not 2 <= window_bits <= 8:
        raise ValueError(f"window_bits {window_bits} outside [2, 8]")
    if digits.dim() != 2 or digits.shape[0] < 1:
        raise ValueError(f"expected (m, nwin) digits, got {tuple(digits.shape)}")
    lo, hi = (int(v) for v in torch.stack(torch.aminmax(digits)).tolist())
    if lo < 0 or hi >= 1 << window_bits:  # C3a indexes its buckets by digit
        raise ValueError(f"digits in [{lo}, {hi}], outside [0, 2^{window_bits})")
    if digits.device.type == "cpu":
        return msm_bucket_plain(points, digits, window_bits)
    if digits.device.type != "cuda" or digits.dtype != torch.int32:
        raise ValueError(f"expected int32 digits on a CUDA device, got {digits.dtype} on "
                         f"{digits.device}")
    if digits.shape[0] >= 1 << 30:
        raise ValueError(f"kernel C3 takes m < 2^30, got {digits.shape[0]}")
    launches, buffers = _bucket_launches(points, digits, window_bits)
    for launch in launches.values():
        launch()
    msm_bucket_jacobian.launches += 1
    return tuple(buffers["out"])


msm_bucket_jacobian.launches = 0


def msm_bucket(points_affine, scalars, window_bits: int | None = None, device="cuda"):
    """Σ scalarᵢ·Pᵢ via GLV + bucket accumulation (C3 on the card); host
    affine points and ints in, the host affine point out."""
    if window_bits is None:
        window_bits = default_window_bits(len(points_affine))
    p, digits = bucket_inputs(points_affine, scalars, window_bits, device)
    out = msm_bucket_jacobian(p, digits, window_bits)
    return to_affine_points(tuple(c[None] for c in out))[0]
