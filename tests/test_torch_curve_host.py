"""The lane core of kernels C2 and C4 (``csrc/bls12_381_lanes.cuh`` and the
programs ``curve/lanes.py`` writes into ``csrc/bls12_381_progs.cuh``), built
for the host with g++ (``tests/curve_host_lanes.cpp``: a thread a lane,
``__syncwarp`` a barrier; the library also runs C1's tile loop, which
``test_torch_fp_tile.py`` tests) and held limb for limb to the port's plain
versions on the CPU: the product and sums to ``fp``, the point operations
to ``g1``/``g2``'s ``add`` and ``double`` (P = Q, P = −Q and the identity
included), the windowed pass to ``g1.scalar_mul_windowed``, the tree to
``g1._tree_reduce``'s pairing, and the G2 scalar multiplication to the host
oracle.  Inputs come from numpy seeds; everything is integer arithmetic,
so every comparison is exact."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from dvt_circuits_tpu_torch.curve import fp, g1, g2, lanes
from dvt_circuits_tpu_torch.hostcrypto import bls12_381 as host

HERE = Path(__file__).resolve().parent
CSRC = HERE.parent / "dvt_circuits_tpu_torch" / "csrc"
NW = 12


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ for the host build of the lane core")
    out = tmp_path_factory.mktemp("curve_host") / "libcurve_host.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC", "-w",
                    "-I", str(CSRC), "-o", str(out), str(HERE / "curve_host_lanes.cpp")],
                   check=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.host_mont_mul.argtypes = [vp, vp, vp, i]
    lib.host_lin.argtypes = [vp, vp, vp, i, i]
    lib.host_g1_op.argtypes = [i, vp, vp, vp, i]
    lib.host_g2_op.argtypes = [i, vp, vp, vp, i]
    lib.host_g1_windowed.argtypes = [vp, vp, vp, i]
    lib.host_g1_tree.argtypes = [vp, vp, i]
    lib.host_g2_scalar_mul.argtypes = [vp, vp, vp, i]
    lib.host_fp_tile_mul.argtypes = [vp, vp, vp, ctypes.c_longlong, i]
    return lib


def _words(limbs: torch.Tensor) -> np.ndarray:
    """(..., 32) Montgomery limbs → (..., 12) uint32 words of the same integer."""
    rows = limbs.reshape(-1, fp.NLIMBS).numpy()
    out = np.zeros((len(rows), NW), dtype=np.uint32)
    for r, row in enumerate(rows):
        v = fp.limbs_to_int(row)
        out[r] = [(v >> (32 * k)) & 0xFFFFFFFF for k in range(NW)]
    return out.reshape(tuple(limbs.shape[:-1]) + (NW,))


def _limbs(words: np.ndarray) -> torch.Tensor:
    rows = words.reshape(-1, NW)
    ints = [sum(int(w) << (32 * k) for k, w in enumerate(row)) for row in rows]
    arr = np.stack([fp.int_to_limbs(v) for v in ints]).reshape(words.shape[:-1] + (fp.NLIMBS,))
    return torch.as_tensor(arr)


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _elements(values) -> torch.Tensor:
    return fp.from_ints(values, "cpu")


# -- G1 and G2 points as the port's Jacobian limb tensors ------------------------


def _g1_jacobian(points, zs) -> tuple:
    """Host affine points (None: the identity) in Jacobian form (x z², y z³, z)."""
    X, Y, Z = [], [], []
    for pt, z in zip(points, zs):
        if pt is None:
            X.append(0), Y.append(1), Z.append(0)
        else:
            X.append(pt[0] * z * z % host.P)
            Y.append(pt[1] * z * z * z % host.P)
            Z.append(z)
    return (_elements(X), _elements(Y), _elements(Z))


def _g2_jacobian(points, zs) -> tuple:
    X, Y, Z = ([], []), ([], []), ([], [])
    for pt, z in zip(points, zs):
        if pt is None:
            x, y, zz = (0, 0), (1, 0), (0, 0)
        else:
            z2 = host.fp2_sq(z)
            x, y, zz = host.fp2_mul(pt[0], z2), host.fp2_mul(pt[1], host.fp2_mul(z2, z)), z
        for c, v in zip((X, Y, Z), (x, y, zz)):
            c[0].append(v[0]), c[1].append(v[1])
    return tuple((_elements(c[0]), _elements(c[1])) for c in (X, Y, Z))


def _g1_words(p) -> np.ndarray:
    return np.ascontiguousarray(np.concatenate([_words(c) for c in p], -1))


def _g1_from_words(w: np.ndarray) -> tuple:
    return tuple(_limbs(w[..., NW * c:NW * (c + 1)]) for c in range(3))


def _g2_words(p) -> np.ndarray:
    return np.ascontiguousarray(np.concatenate([_words(e) for c in p for e in c], -1))


def _g2_from_words(w: np.ndarray) -> tuple:
    return tuple((_limbs(w[..., NW * 2 * c:NW * (2 * c + 1)]),
                  _limbs(w[..., NW * (2 * c + 1):NW * (2 * c + 2)])) for c in range(3))


def _equal(a, b) -> bool:
    if isinstance(a, tuple):
        return all(_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def _zs(rng, n: int) -> list:
    return [int.from_bytes(rng.bytes(48), "big") % (host.P - 1) + 1 for _ in range(n)]


# -- the product and the sums ---------------------------------------------------------


def test_product_and_sums_equal_plain(lib):
    rng = np.random.default_rng(1)
    edges = [0, 1, host.P - 1, fp.R_MOD_P, host.P - 2]
    rand = [int.from_bytes(rng.bytes(48), "big") % host.P for _ in range(40)]
    a_int = [x for x in edges for _ in edges] + rand
    b_int = [y for _ in edges for y in edges] + rand[::-1]
    # the limbs hold these integers as they are: Montgomery-form words
    a = torch.as_tensor(np.stack([fp.int_to_limbs(v) for v in a_int]))
    b = torch.as_tensor(np.stack([fp.int_to_limbs(v) for v in b_int]))
    wa, wb = _words(a), _words(b)
    out = np.zeros_like(wa)
    lib.host_mont_mul(_ptr(wa), _ptr(wb), _ptr(out), len(a_int))
    assert torch.equal(_limbs(out), fp.mont_mul_plain(a, b))
    for subtract, want in ((0, fp.add(a, b)), (1, fp.sub(a, b))):
        lib.host_lin(_ptr(wa), _ptr(wb), _ptr(out), len(a_int), subtract)
        assert torch.equal(_limbs(out), want)


# -- G1 and G2 point operations ----------------------------------------------------------

_CASES = ["generic", "p-equals-q", "p-minus-q", "p-identity", "q-identity", "both-identity"]


def _pairs(neg, pts):
    """(p, q) host points for each case of ``_CASES``."""
    a, b = pts
    return {"generic": (a, b), "p-equals-q": (a, a), "p-minus-q": (a, neg(a)),
            "p-identity": (None, b), "q-identity": (a, None), "both-identity": (None, None)}


def test_g1_add_and_double_equal_plain(lib):
    rng = np.random.default_rng(2)
    pts = [host.g1_mul(host.G1_GEN, int(k)) for k in rng.integers(2, 1 << 40, 2)]
    pairs = _pairs(host.g1_neg, pts)
    ps = [pairs[c][0] for c in _CASES]
    qs = [pairs[c][1] for c in _CASES]
    n = len(_CASES)
    p, q = _g1_jacobian(ps, _zs(rng, n)), _g1_jacobian(qs, _zs(rng, n))
    wp, wq = _g1_words(p), _g1_words(q)
    out = np.zeros_like(wp)
    lib.host_g1_op(1, _ptr(wp), _ptr(wq), _ptr(out), n)
    want = g1.add(p, q, fp.mont_mul_plain)
    for k, case in enumerate(_CASES):
        got = _g1_from_words(out[k:k + 1])
        assert _equal(got, tuple(c[k:k + 1] for c in want)), case
    lib.host_g1_op(0, _ptr(wp), _ptr(wq), _ptr(out), n)
    assert _equal(_g1_from_words(out), g1.double(p, fp.mont_mul_plain))


def test_g2_add_and_double_equal_plain(lib):
    rng = np.random.default_rng(3)
    pts = [host.g2_mul(host.G2_GEN, int(k)) for k in rng.integers(2, 1 << 40, 2)]
    pairs = _pairs(host.g2_neg, pts)
    ps = [pairs[c][0] for c in _CASES]
    qs = [pairs[c][1] for c in _CASES]
    n = len(_CASES)

    def zs():
        return list(zip(_zs(rng, n), _zs(rng, n)))

    p, q = _g2_jacobian(ps, zs()), _g2_jacobian(qs, zs())
    wp, wq = _g2_words(p), _g2_words(q)
    out = np.zeros_like(wp)
    lib.host_g2_op(1, _ptr(wp), _ptr(wq), _ptr(out), n)
    want = g2.add(p, q, fp.mont_mul_plain)
    for k, case in enumerate(_CASES):
        got = _g2_from_words(out[k:k + 1])
        assert _equal(got, tuple((c[0][k:k + 1], c[1][k:k + 1]) for c in want)), case
    lib.host_g2_op(0, _ptr(wp), _ptr(wq), _ptr(out), n)
    assert _equal(_g2_from_words(out), g2.double(p, fp.mont_mul_plain))


# -- C2: the windowed pass and the tree; C4: the scalar multiplication ----------------


def test_windowed_pass_equals_plain(lib):
    """Five points (an identity among them; 4 a warp, so two warps, the
    second with three groups past n) and their digits (one row all zero)."""
    rng = np.random.default_rng(4)
    pts = [host.g1_mul(host.G1_GEN, int(k)) for k in rng.integers(2, 1 << 40, 5)]
    pts[1] = None
    p = _g1_jacobian(pts, _zs(rng, 5))
    digits = torch.as_tensor(rng.integers(0, 16, (5, g1.NUM_WINDOWS), dtype=np.int32))
    digits[2] = 0
    digits[0, :3] = 15
    out = np.zeros((5, 3 * NW), dtype=np.uint32)
    d = np.ascontiguousarray(digits.numpy())
    wp = _g1_words(p)  # held: the call reads it through a raw pointer
    lib.host_g1_windowed(_ptr(wp), _ptr(d), _ptr(out), 5)
    assert _equal(_g1_from_words(out), g1.scalar_mul_windowed(p, digits, fp.mont_mul_plain))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_tree_pairs_as_tree_reduce(lib, n):
    """Random points, with a repeated point that meets its copy at the first
    level (n = 8: 0 and 4), a point beside its negation (n = 5: 0 and 2)
    and an identity (n = 3)."""
    rng = np.random.default_rng(10 + n)
    pts = [host.g1_mul(host.G1_GEN, int(k)) for k in rng.integers(2, 1 << 40, n)]
    if n == 8:
        pts[4] = pts[0]
    if n == 5:
        pts[2] = host.g1_neg(pts[0])
    if n == 3:
        pts[1] = None
    p = _g1_jacobian(pts, _zs(rng, n))
    out = np.zeros(3 * NW, dtype=np.uint32)
    wp = _g1_words(p)
    lib.host_g1_tree(_ptr(wp), _ptr(out), n)
    want = g1._tree_reduce(p, fp.mont_mul_plain)
    assert _equal(_g1_from_words(out[None]), tuple(c[None] for c in want))


def test_g2_scalar_mul_equals_host(lib):
    """Three points: random bits, the identity, all-zero bits."""
    rng = np.random.default_rng(5)
    pts = [host.g2_mul(host.G2_GEN, 3), None, host.g2_mul(host.G2_GEN, 7)]
    scalars = [int.from_bytes(rng.bytes(32), "big") % host.R, 12345, 0]
    p = g2.from_host_points(pts, "cpu")
    bits = np.ascontiguousarray(g1.scalars_to_bits(scalars, "cpu").numpy())
    out = np.zeros((3, 6 * NW), dtype=np.uint32)
    wp = _g2_words(p)
    lib.host_g2_scalar_mul(_ptr(wp), _ptr(bits), _ptr(out), 3)
    got = g2.to_host_points(_g2_from_words(out))
    assert got == [host.g2_mul(q, k) if q else None for q, k in zip(pts, scalars)]


def test_program_header_is_generated():
    """``csrc/bls12_381_progs.cuh`` is what ``curve/lanes.py`` writes now."""
    assert lanes.HEADER.read_text() == lanes.header()


@pytest.mark.parametrize("name", sorted(lanes.PROGRAMS))
def test_programs_compute_the_formulas(name):
    """Each program, run on Python ints, against the port's plain point
    operation on the same Jacobian inputs (the generic sum for g2_add)."""
    rng = np.random.default_rng(6)
    n_lanes, steps, n_slots, outs = lanes.compiled()[name]
    assert max(len(row) for row in steps) <= n_lanes
    is_g2 = name.startswith("g2")
    pts = [(host.g2_mul if is_g2 else host.g1_mul)(host.G2_GEN if is_g2 else host.G1_GEN, k)
           for k in (5, 11)]
    if is_g2:
        p = _g2_jacobian(pts, [(z, z + 1) for z in _zs(rng, 2)])
        elems = [c[k] for c in p for k in range(2)]
        a, b = (tuple((c[0][i:i + 1], c[1][i:i + 1]) for c in p) for i in range(2))
        op = g2
    else:
        p = _g1_jacobian(pts, _zs(rng, 2))
        elems = list(p)
        a, b = (tuple(c[i:i + 1] for c in p) for i in range(2))
        op = g1
    inputs = [fp.limbs_to_int(e[i].numpy()) for i in range(2) for e in elems]
    if name.endswith("dbl"):
        inputs = inputs[:len(inputs) // 2]
        want = op.double(a, fp.mont_mul_plain)
    else:
        want = op.add(a, b, fp.mont_mul_plain)  # generic: no special case here
    slots = lanes.simulate(steps, n_slots, inputs)
    flat = [e for c in want for e in (c if is_g2 else (c,))]
    assert [slots[s] for s in outs[:len(flat)]] == [fp.limbs_to_int(e[0].numpy()) for e in flat]
