"""Loader/dispatch for the native BLS12-381 host backend (native/bls381.cpp).

The pure-Python implementation in ``bls12_381`` stays the semantic source of
truth (and the property-test oracle); this module accelerates the hot group
operations (~170 ms → ~5 ms per pairing).  All field constants are computed
here from the Python source of truth and injected at init — the C++ holds no
magic numbers.  Falls back silently (returns None) when unavailable or when
``DVT_DISABLE_NATIVE=1``.

The library is built into the git-ignored ``build/native/``, named by a hash
of its source, through a temporary file that ``os.replace`` moves into
place: processes that build it at once each write their own file, and none
loads a half-written one (the JAX package's copy builds in place into
``native/``).  A process that finds no compiler gives up for its lifetime.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
_SRC = _REPO_ROOT / "native" / "bls381.cpp"
_BUILD_DIR = _REPO_ROOT / "build" / "native"

_lib = None
_tried = False
_lock = threading.Lock()


def _library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"bls381-{digest}.so"


def _build(out: Path) -> bool:
    """Compile the library into ``out`` through a private temporary file."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out.parent, prefix=out.stem + ".", suffix=".tmp")
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, str(_SRC)],
            check=True,
            capture_output=True,
            timeout=180,
        )
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _fp_be(x: int) -> bytes:
    return int(x).to_bytes(48, "big")


def _fp2_be(v) -> bytes:
    return _fp_be(v[0]) + _fp_be(v[1])


def load():
    with _lock:
        return _load_locked()


def _load_locked():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("DVT_DISABLE_NATIVE") == "1" or not _SRC.exists():
        return None
    so = _library_path()
    if not so.exists() and not _build(so):
        return None
    try:
        from . import bls12_381 as b

        lib = ctypes.CDLL(str(so))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.bls_init.argtypes = [u8p, u8p, u8p, u8p, u8p, ctypes.c_uint64, u8p, ctypes.c_int]
        lib.bls_g1_mul.argtypes = [u8p, ctypes.c_int, u8p, ctypes.c_int, u8p]
        lib.bls_g2_mul.argtypes = [u8p, ctypes.c_int, u8p, ctypes.c_int, u8p]
        lib.bls_g1_msm.argtypes = [u8p, u8p, u8p, ctypes.c_int, u8p]
        lib.bls_pairings_equal.argtypes = [
            u8p, ctypes.c_int, u8p, ctypes.c_int, u8p, ctypes.c_int, u8p, ctypes.c_int,
        ]

        R = 1 << 384
        p_be = _fp_be(b.P)
        r2_be = _fp_be(R * R % b.P)
        pm2_be = _fp_be(b.P - 2)
        gammas = b"".join(_fp2_be(g) for g in (b._G1F, b._G2F, b._G3F, b._G4F, b._G5F))
        xi_inv = _fp2_be(b.fp2_inv(b.XI))
        inv = (-pow(b.P, -1, 1 << 64)) % (1 << 64)
        hard = b._HARD_EXP
        hard_be = hard.to_bytes((hard.bit_length() + 7) // 8, "big")

        def buf(data: bytes):
            return (ctypes.c_uint8 * len(data)).from_buffer_copy(data)

        lib.bls_init(
            buf(p_be), buf(r2_be), buf(pm2_be), buf(gammas), buf(xi_inv),
            ctypes.c_uint64(inv), buf(hard_be), len(hard_be),
        )
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def _pt_g1(pt) -> tuple:
    if pt is None:
        return (ctypes.c_uint8 * 96)(), 1
    data = _fp_be(pt[0]) + _fp_be(pt[1])
    return (ctypes.c_uint8 * 96).from_buffer_copy(data), 0


def _pt_g2(pt) -> tuple:
    if pt is None:
        return (ctypes.c_uint8 * 192)(), 1
    (xa, xb), (ya, yb) = pt
    data = _fp_be(xa) + _fp_be(xb) + _fp_be(ya) + _fp_be(yb)
    return (ctypes.c_uint8 * 192).from_buffer_copy(data), 0


def _scalar_be(k: int) -> bytes:
    return k.to_bytes(max(1, (k.bit_length() + 7) // 8), "big")


def g1_mul(pt, k: int):
    """k·pt for k ≥ 0; None result = infinity; None return-sentinel ...

    Returns ``(point_or_None,)`` on success, None when native is unavailable
    (so callers can distinguish 'computed infinity' from 'no backend')."""
    lib = load()
    if lib is None:
        return None
    p, inf = _pt_g1(pt)
    kb = _scalar_be(k)
    out = (ctypes.c_uint8 * 96)()
    ok = lib.bls_g1_mul(p, inf, (ctypes.c_uint8 * len(kb)).from_buffer_copy(kb), len(kb), out)
    if not ok:
        return (None,)
    data = bytes(out)
    return ((int.from_bytes(data[:48], "big"), int.from_bytes(data[48:], "big")),)


def g2_mul(pt, k: int):
    lib = load()
    if lib is None:
        return None
    p, inf = _pt_g2(pt)
    kb = _scalar_be(k)
    out = (ctypes.c_uint8 * 192)()
    ok = lib.bls_g2_mul(p, inf, (ctypes.c_uint8 * len(kb)).from_buffer_copy(kb), len(kb), out)
    if not ok:
        return (None,)
    d = bytes(out)
    f = lambda i: int.from_bytes(d[48 * i : 48 * (i + 1)], "big")
    return (((f(0), f(1)), (f(2), f(3))),)


def pairings_equal(p1, q1, p2, q2):
    """e(P1,Q1) == e(P2,Q2); None when the native backend is unavailable."""
    lib = load()
    if lib is None:
        return None
    a1, i1 = _pt_g1(p1)
    b1, j1 = _pt_g2(q1)
    a2, i2 = _pt_g1(p2)
    b2, j2 = _pt_g2(q2)
    return bool(lib.bls_pairings_equal(a1, i1, b1, j1, a2, i2, b2, j2))


def g1_msm(points, scalars):
    """Σ kᵢ·Pᵢ (points affine-or-None, scalars ints ≥ 0, < 2^256);
    returns (point_or_None,) or None if unavailable."""
    lib = load()
    if lib is None:
        return None
    n = len(points)
    pts = bytearray(96 * n)
    infs = bytearray(n)
    ks = bytearray(32 * n)
    for i, (pt, k) in enumerate(zip(points, scalars)):
        if pt is None:
            infs[i] = 1
        else:
            pts[96 * i : 96 * i + 96] = _fp_be(pt[0]) + _fp_be(pt[1])
        ks[32 * i : 32 * i + 32] = int(k).to_bytes(32, "big")
    out = (ctypes.c_uint8 * 96)()
    ok = lib.bls_g1_msm(
        (ctypes.c_uint8 * len(pts)).from_buffer_copy(bytes(pts)),
        (ctypes.c_uint8 * n).from_buffer_copy(bytes(infs)),
        (ctypes.c_uint8 * len(ks)).from_buffer_copy(bytes(ks)),
        n,
        out,
    )
    if not ok:
        return (None,)
    data = bytes(out)
    return ((int.from_bytes(data[:48], "big"), int.from_bytes(data[48:], "big")),)
