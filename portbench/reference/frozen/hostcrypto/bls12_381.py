"""BLS12-381 host-side implementation (pure Python, arbitrary-precision ints).

Re-creates the capability surface the reference gets from the (patched)
``bls12_381`` Rust crate (the reference's crates/dkg/src/crypto/bls_common.rs,
bls_keys.rs, dkg_math.rs):

  * Fp / Fp2 / Fp6 / Fp12 tower arithmetic
  * G1/G2 affine points, zcash-format compressed/uncompressed (de)serialization
    with full validity + subgroup checks (``from_compressed`` semantics)
  * scalar field Fr with the reference's canonical-LE decode semantics
  * optimal ate pairing (Miller loop + final exponentiation)
  * hash-to-curve G2 per the ciphersuite BLS12381G2_XMD:SHA-256_SSWU_RO_
    (expand_message_xmd, SSWU on the 3-isogenous curve, iso_map, cofactor
    clearing) — validated bit-exactly against the reference's golden BLS
    signature vectors (dkg_math.rs:259-278).

Frozen copy of the port's ``hostcrypto/bls12_381.py``, pure Python
throughout: the scalar multiplications run in Jacobian coordinates where the
port calls its native backend.

Conventions: field elements are plain ints; Fp2 elements are ``(c0, c1)``
tuples meaning ``c0 + c1·u`` with ``u² = −1``; Fp6 = (a0, a1, a2) over Fp2 with
``v³ = ξ = 1+u``; Fp12 = (b0, b1) over Fp6 with ``w² = v``.  Affine points are
``(x, y)`` tuples, the point at infinity is ``None``.
"""

from __future__ import annotations

import hashlib

from ..utils.errors import InvalidPoint

# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001  # group order
B_G1 = 4
X_BLS = -0xD201000000010000  # BLS parameter (negative)

G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)

# ---------------------------------------------------------------------------
# Fp2 arithmetic: (c0, c1) == c0 + c1*u, u^2 = -1
# ---------------------------------------------------------------------------

FP2_ZERO = (0, 0)
FP2_ONE = (1, 0)
XI = (1, 1)  # ξ = 1 + u, the sextic-twist non-residue


def fp2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fp2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fp2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def fp2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = a0 * b0
    t1 = a1 * b1
    # (a0+a1)(b0+b1) - t0 - t1 = a0*b1 + a1*b0
    return ((t0 - t1) % P, ((a0 + a1) * (b0 + b1) - t0 - t1) % P)


def fp2_sq(a):
    a0, a1 = a
    # (a0 + a1 u)^2 = (a0-a1)(a0+a1) + 2 a0 a1 u
    return ((a0 - a1) * (a0 + a1) % P, 2 * a0 * a1 % P)


def fp2_scalar(a, k):
    return (a[0] * k % P, a[1] * k % P)


def fp2_conj(a):
    return (a[0], (-a[1]) % P)


def fp2_inv(a):
    a0, a1 = a
    norm = (a0 * a0 + a1 * a1) % P
    if norm == 0:
        raise ZeroDivisionError("inverse of zero in Fp2")
    inv = pow(norm, P - 2, P)
    return (a0 * inv % P, (-a1) * inv % P)


def fp2_pow(a, e):
    result = FP2_ONE
    base = a
    while e > 0:
        if e & 1:
            result = fp2_mul(result, base)
        base = fp2_sq(base)
        e >>= 1
    return result


def fp2_is_zero(a):
    return a[0] == 0 and a[1] == 0


def fp2_legendre_norm(a):
    """1 if a is a nonzero square in Fp2, 0 if zero, -1 otherwise."""
    if fp2_is_zero(a):
        return 0
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    return 1 if pow(norm, (P - 1) // 2, P) == 1 else -1


def fp2_sqrt(a):
    """Square root in Fp2 for p ≡ 3 (mod 4); returns None if no root exists."""
    if fp2_is_zero(a):
        return FP2_ZERO
    a1 = fp2_pow(a, (P - 3) // 4)
    x0 = fp2_mul(a1, a)
    alpha = fp2_mul(a1, x0)  # = a^((p-1)/2)
    if alpha == (P - 1, 0):  # alpha == -1
        x = fp2_mul((0, 1), x0)
    else:
        b = fp2_pow(fp2_add(FP2_ONE, alpha), (P - 1) // 2)
        x = fp2_mul(b, x0)
    if fp2_sq(x) != a:
        return None
    return x


def fp2_sgn0(a):
    """RFC 9380 sgn0 for m=2 extension field."""
    sign_0 = a[0] & 1
    zero_0 = a[0] == 0
    sign_1 = a[1] & 1
    return sign_0 | (int(zero_0) & sign_1)


# ---------------------------------------------------------------------------
# Fp6 = Fp2[v]/(v^3 - ξ);  elements (a0, a1, a2)
# ---------------------------------------------------------------------------

FP6_ZERO = (FP2_ZERO, FP2_ZERO, FP2_ZERO)
FP6_ONE = (FP2_ONE, FP2_ZERO, FP2_ZERO)


def _mul_xi(a):
    # (c0 + c1 u)(1 + u) = (c0 - c1) + (c0 + c1) u
    return ((a[0] - a[1]) % P, (a[0] + a[1]) % P)


def fp6_add(a, b):
    return (fp2_add(a[0], b[0]), fp2_add(a[1], b[1]), fp2_add(a[2], b[2]))


def fp6_sub(a, b):
    return (fp2_sub(a[0], b[0]), fp2_sub(a[1], b[1]), fp2_sub(a[2], b[2]))


def fp6_neg(a):
    return (fp2_neg(a[0]), fp2_neg(a[1]), fp2_neg(a[2]))


def fp6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fp2_mul(a0, b0)
    t1 = fp2_mul(a1, b1)
    t2 = fp2_mul(a2, b2)
    c0 = fp2_add(t0, _mul_xi(fp2_sub(fp2_mul(fp2_add(a1, a2), fp2_add(b1, b2)), fp2_add(t1, t2))))
    c1 = fp2_add(
        fp2_sub(fp2_mul(fp2_add(a0, a1), fp2_add(b0, b1)), fp2_add(t0, t1)), _mul_xi(t2)
    )
    c2 = fp2_add(fp2_sub(fp2_mul(fp2_add(a0, a2), fp2_add(b0, b2)), fp2_add(t0, t2)), t1)
    return (c0, c1, c2)


def fp6_sq(a):
    return fp6_mul(a, a)


def fp6_mul_by_v(a):
    # v * (a0 + a1 v + a2 v^2) = ξ a2 + a0 v + a1 v^2
    return (_mul_xi(a[2]), a[0], a[1])


def fp6_inv(a):
    a0, a1, a2 = a
    c0 = fp2_sub(fp2_sq(a0), _mul_xi(fp2_mul(a1, a2)))
    c1 = fp2_sub(_mul_xi(fp2_sq(a2)), fp2_mul(a0, a1))
    c2 = fp2_sub(fp2_sq(a1), fp2_mul(a0, a2))
    t = fp2_add(
        fp2_mul(a0, c0), _mul_xi(fp2_add(fp2_mul(a2, c1), fp2_mul(a1, c2)))
    )
    t_inv = fp2_inv(t)
    return (fp2_mul(c0, t_inv), fp2_mul(c1, t_inv), fp2_mul(c2, t_inv))


# ---------------------------------------------------------------------------
# Fp12 = Fp6[w]/(w^2 - v);  elements (b0, b1)
# ---------------------------------------------------------------------------

FP12_ONE = (FP6_ONE, FP6_ZERO)


def fp12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = fp6_mul(a0, b0)
    t1 = fp6_mul(a1, b1)
    c0 = fp6_add(t0, fp6_mul_by_v(t1))
    c1 = fp6_sub(fp6_sub(fp6_mul(fp6_add(a0, a1), fp6_add(b0, b1)), t0), t1)
    return (c0, c1)


def fp12_sq(a):
    return fp12_mul(a, a)


def fp12_conj(a):
    """Conjugation over Fp6 (== Frobenius^6, inverse in cyclotomic subgroup)."""
    return (a[0], fp6_neg(a[1]))


def fp12_inv(a):
    a0, a1 = a
    t = fp6_inv(fp6_sub(fp6_sq(a0), fp6_mul_by_v(fp6_sq(a1))))
    return (fp6_mul(a0, t), fp6_neg(fp6_mul(a1, t)))


def fp12_pow(a, e):
    if e < 0:
        a = fp12_conj(a)  # valid only in the cyclotomic subgroup
        e = -e
    result = FP12_ONE
    base = a
    while e > 0:
        if e & 1:
            result = fp12_mul(result, base)
        base = fp12_sq(base)
        e >>= 1
    return result


# Frobenius constants: γ1 = ξ^((p-1)/6), γ2 = γ1², ...
_G1F = fp2_pow(XI, (P - 1) // 6)
_G2F = fp2_mul(_G1F, _G1F)
_G3F = fp2_mul(_G2F, _G1F)
_G4F = fp2_mul(_G3F, _G1F)
_G5F = fp2_mul(_G4F, _G1F)


def fp12_frobenius(a):
    (a0, a1, a2), (b0, b1, b2) = a
    return (
        (fp2_conj(a0), fp2_mul(fp2_conj(a1), _G2F), fp2_mul(fp2_conj(a2), _G4F)),
        (
            fp2_mul(fp2_conj(b0), _G1F),
            fp2_mul(fp2_conj(b1), _G3F),
            fp2_mul(fp2_conj(b2), _G5F),
        ),
    )


# ---------------------------------------------------------------------------
# G1: y^2 = x^3 + 4 over Fp.  Affine points, None = infinity.
# ---------------------------------------------------------------------------


def g1_is_on_curve(pt):
    if pt is None:
        return True
    x, y = pt
    return (y * y - (x * x * x + B_G1)) % P == 0


def g1_neg(pt):
    if pt is None:
        return None
    return (pt[0], (-pt[1]) % P)


def g1_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        # doubling
        lam = (3 * x1 * x1) * pow(2 * y1, P - 2, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, P - 2, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def g1_mul(pt, k):
    return g1_mul_raw(pt, k % R)


def g1_mul_raw(pt, k):
    """Scalar mult without reducing mod R (for subgroup/cofactor work):
    left-to-right double-and-add in Jacobian coordinates, one inversion at
    the end (this frozen copy's replacement for the port's native backend;
    ``g1_mul_affine`` is the affine ladder it must equal)."""
    if k < 0:
        return g1_mul_raw(g1_neg(pt), -k)
    if pt is None or k == 0:
        return None
    if pt == G1_GEN and k < 1 << (4 * _FIXED_WINDOWS):
        acc = None
        table = _g1_gen_table()
        for i in range(_FIXED_WINDOWS):
            digit = (k >> (4 * i)) & 15
            if digit:
                acc = _g1_jac_add_affine(acc, *table[i][digit - 1])
        return _g1_jac_to_affine(acc)
    x2, y2 = pt
    acc = None  # (X, Y, Z), None the identity
    for bit in bin(k)[2:]:
        if acc is not None:
            acc = _g1_jac_double(acc)
        if bit == "1":
            acc = (x2, y2, 1) if acc is None else _g1_jac_add_affine(acc, x2, y2)
    return _g1_jac_to_affine(acc)


#: 4-bit windows of the generator's fixed-base table (scalars below 2^256)
_FIXED_WINDOWS = 64
_G1_GEN_TABLE: list = []


def _g1_gen_table() -> list:
    """table[i][j - 1] = j·16^i·G1_GEN in affine form, j = 1..15."""
    if not _G1_GEN_TABLE:
        base = G1_GEN
        for _ in range(_FIXED_WINDOWS):
            row = [base]
            for _ in range(14):
                row.append(g1_add(row[-1], base))
            _G1_GEN_TABLE.append(row)
            base = g1_add(row[-1], base)
    return _G1_GEN_TABLE


def _g1_jac_double(p):
    X, Y, Z = p
    if Y == 0:
        return None
    A = X * X % P
    B = Y * Y % P
    C = B * B % P
    D = 2 * ((X + B) * (X + B) - A - C) % P
    E = 3 * A % P
    X3 = (E * E - 2 * D) % P
    return (X3, (E * (D - X3) - 8 * C) % P, 2 * Y * Z % P)


def _g1_jac_add_affine(p, x2, y2):
    if p is None:
        return (x2, y2, 1)
    X1, Y1, Z1 = p
    Z1Z1 = Z1 * Z1 % P
    H = (x2 * Z1Z1 - X1) % P
    r = (y2 * Z1 * Z1Z1 - Y1) % P
    if H == 0:
        return _g1_jac_double(p) if r == 0 else None
    HH = H * H % P
    HHH = H * HH % P
    V = X1 * HH % P
    X3 = (r * r - HHH - 2 * V) % P
    return (X3, (r * (V - X3) - Y1 * HHH) % P, Z1 * H % P)


def _g1_jac_to_affine(p):
    if p is None:
        return None
    X, Y, Z = p
    zi = pow(Z, -1, P)
    zi2 = zi * zi % P
    return (X * zi2 % P, Y * zi2 * zi % P)


def g1_mul_affine(pt, k):
    """The affine double-and-add ladder (the oracle ``g1_mul_raw`` equals)."""
    if k < 0:
        return g1_mul_affine(g1_neg(pt), -k)
    result = None
    add = pt
    while k > 0:
        if k & 1:
            result = g1_add(result, add)
        add = g1_add(add, add)
        k >>= 1
    return result


def g1_in_subgroup(pt):
    return g1_is_on_curve(pt) and g1_mul_raw(pt, R) is None


# ---------------------------------------------------------------------------
# G2: y^2 = x^3 + 4(1+u) over Fp2.
# ---------------------------------------------------------------------------

B_G2 = (4, 4)


def g2_is_on_curve(pt):
    if pt is None:
        return True
    x, y = pt
    return fp2_sq(y) == fp2_add(fp2_mul(fp2_sq(x), x), B_G2)


def g2_neg(pt):
    if pt is None:
        return None
    return (pt[0], fp2_neg(pt[1]))


def g2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if fp2_is_zero(fp2_add(y1, y2)):
            return None
        lam = fp2_mul(fp2_scalar(fp2_sq(x1), 3), fp2_inv(fp2_scalar(y1, 2)))
    else:
        lam = fp2_mul(fp2_sub(y2, y1), fp2_inv(fp2_sub(x2, x1)))
    x3 = fp2_sub(fp2_sub(fp2_sq(lam), x1), x2)
    y3 = fp2_sub(fp2_mul(lam, fp2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_mul_raw(pt, k):
    """Scalar mult over Fp2 in Jacobian coordinates, as ``g1_mul_raw``
    (``g2_mul_affine`` is the affine ladder it must equal)."""
    if k < 0:
        return g2_mul_raw(g2_neg(pt), -k)
    if pt is None or k == 0:
        return None
    x2, y2 = pt
    acc = None
    for bit in bin(k)[2:]:
        if acc is not None:
            acc = _g2_jac_double(acc)
        if bit == "1":
            acc = (x2, y2, (1, 0)) if acc is None else _g2_jac_add_affine(acc, x2, y2)
    if acc is None:
        return None
    X, Y, Z = acc
    zi = fp2_inv(Z)
    zi2 = fp2_sq(zi)
    return (fp2_mul(X, zi2), fp2_mul(Y, fp2_mul(zi2, zi)))


def _g2_jac_double(p):
    X, Y, Z = p
    if fp2_is_zero(Y):
        return None
    A = fp2_sq(X)
    B = fp2_sq(Y)
    C = fp2_sq(B)
    D = fp2_scalar(fp2_sub(fp2_sub(fp2_sq(fp2_add(X, B)), A), C), 2)
    E = fp2_scalar(A, 3)
    X3 = fp2_sub(fp2_sq(E), fp2_scalar(D, 2))
    Y3 = fp2_sub(fp2_mul(E, fp2_sub(D, X3)), fp2_scalar(C, 8))
    return (X3, Y3, fp2_scalar(fp2_mul(Y, Z), 2))


def _g2_jac_add_affine(p, x2, y2):
    X1, Y1, Z1 = p
    Z1Z1 = fp2_sq(Z1)
    H = fp2_sub(fp2_mul(x2, Z1Z1), X1)
    r = fp2_sub(fp2_mul(y2, fp2_mul(Z1, Z1Z1)), Y1)
    if fp2_is_zero(H):
        return _g2_jac_double(p) if fp2_is_zero(r) else None
    HH = fp2_sq(H)
    HHH = fp2_mul(H, HH)
    V = fp2_mul(X1, HH)
    X3 = fp2_sub(fp2_sub(fp2_sq(r), HHH), fp2_scalar(V, 2))
    Y3 = fp2_sub(fp2_mul(r, fp2_sub(V, X3)), fp2_mul(Y1, HHH))
    return (X3, Y3, fp2_mul(Z1, H))


def g2_mul_affine(pt, k):
    """The affine double-and-add ladder (the oracle ``g2_mul_raw`` equals)."""
    if k < 0:
        return g2_mul_affine(g2_neg(pt), -k)
    result = None
    add = pt
    while k > 0:
        if k & 1:
            result = g2_add(result, add)
        add = g2_add(add, add)
        k >>= 1
    return result


def g2_mul(pt, k):
    return g2_mul_raw(pt, k % R)


def g2_in_subgroup(pt):
    return g2_is_on_curve(pt) and g2_mul_raw(pt, R) is None


# ---------------------------------------------------------------------------
# Serialization (zcash format, matches bls12_381 crate to_compressed /
# from_compressed semantics: crates/dkg/src/crypto/bls_common.rs:49-116)
# ---------------------------------------------------------------------------


def _fp_to_bytes(x):
    return x.to_bytes(48, "big")


def g1_to_compressed(pt) -> bytes:
    if pt is None:
        return bytes([0xC0]) + bytes(47)
    x, y = pt
    flags = 0x80
    if y > (P - y) % P:  # lexicographically largest
        flags |= 0x20
    out = bytearray(_fp_to_bytes(x))
    out[0] |= flags
    return bytes(out)


def g1_from_compressed(data: bytes, subgroup_check: bool = True):
    """Decode 48-byte compressed G1; raises InvalidPoint on any failure."""
    if len(data) != 48:
        raise InvalidPoint("G1 compressed encoding must be 48 bytes")
    flags = data[0]
    compressed = bool(flags & 0x80)
    infinity = bool(flags & 0x40)
    sort = bool(flags & 0x20)
    if not compressed:
        raise InvalidPoint("compression flag not set")
    body = bytes([data[0] & 0x1F]) + data[1:]
    x = int.from_bytes(body, "big")
    if infinity:
        if sort or x != 0:
            raise InvalidPoint("malformed infinity encoding")
        return None
    if x >= P:
        raise InvalidPoint("x not in field")
    y2 = (x * x * x + B_G1) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        raise InvalidPoint("x not on curve")
    if (y > (P - y) % P) != sort:
        y = (P - y) % P
    pt = (x, y)
    if subgroup_check and not g1_in_subgroup(pt):
        raise InvalidPoint("point not in the prime-order subgroup")
    return pt


def g1_to_uncompressed(pt) -> bytes:
    if pt is None:
        return bytes([0x40]) + bytes(95)
    x, y = pt
    return _fp_to_bytes(x) + _fp_to_bytes(y)


def g1_from_uncompressed(data: bytes, subgroup_check: bool = True):
    if len(data) != 96:
        raise InvalidPoint("G1 uncompressed encoding must be 96 bytes")
    flags = data[0]
    if flags & 0x80:
        raise InvalidPoint("compression flag set on uncompressed encoding")
    infinity = bool(flags & 0x40)
    body = bytes([data[0] & 0x1F]) + data[1:]
    if infinity:
        if any(body) or (flags & 0x20):
            raise InvalidPoint("malformed infinity encoding")
        return None
    x = int.from_bytes(body[:48], "big")
    y = int.from_bytes(body[48:], "big")
    if x >= P or y >= P:
        raise InvalidPoint("coordinate not in field")
    pt = (x, y)
    if not g1_is_on_curve(pt):
        raise InvalidPoint("point not on curve")
    if subgroup_check and not g1_in_subgroup(pt):
        raise InvalidPoint("point not in the prime-order subgroup")
    return pt


def _fp2_lex_gt(a, b):
    """Lexicographic compare of Fp2 (c1 first, then c0) as in zcash encoding."""
    if a[1] != b[1]:
        return a[1] > b[1]
    return a[0] > b[0]


def g2_to_compressed(pt) -> bytes:
    if pt is None:
        return bytes([0xC0]) + bytes(95)
    x, y = pt
    flags = 0x80
    if _fp2_lex_gt(y, fp2_neg(y)):
        flags |= 0x20
    out = bytearray(_fp_to_bytes(x[1]) + _fp_to_bytes(x[0]))
    out[0] |= flags
    return bytes(out)


def g2_from_compressed(data: bytes, subgroup_check: bool = True):
    if len(data) != 96:
        raise InvalidPoint("G2 compressed encoding must be 96 bytes")
    flags = data[0]
    compressed = bool(flags & 0x80)
    infinity = bool(flags & 0x40)
    sort = bool(flags & 0x20)
    if not compressed:
        raise InvalidPoint("compression flag not set")
    body = bytes([data[0] & 0x1F]) + data[1:]
    xc1 = int.from_bytes(body[:48], "big")
    xc0 = int.from_bytes(body[48:], "big")
    if infinity:
        if sort or xc1 != 0 or xc0 != 0:
            raise InvalidPoint("malformed infinity encoding")
        return None
    if xc0 >= P or xc1 >= P:
        raise InvalidPoint("x not in field")
    x = (xc0, xc1)
    y2 = fp2_add(fp2_mul(fp2_sq(x), x), B_G2)
    y = fp2_sqrt(y2)
    if y is None:
        raise InvalidPoint("x not on curve")
    if _fp2_lex_gt(y, fp2_neg(y)) != sort:
        y = fp2_neg(y)
    pt = (x, y)
    if subgroup_check and not g2_in_subgroup(pt):
        raise InvalidPoint("point not in the prime-order subgroup")
    return pt


def g2_to_uncompressed(pt) -> bytes:
    if pt is None:
        return bytes([0x40]) + bytes(191)
    x, y = pt
    return _fp_to_bytes(x[1]) + _fp_to_bytes(x[0]) + _fp_to_bytes(y[1]) + _fp_to_bytes(y[0])


def g2_from_uncompressed(data: bytes, subgroup_check: bool = True):
    if len(data) != 192:
        raise InvalidPoint("G2 uncompressed encoding must be 192 bytes")
    flags = data[0]
    if flags & 0x80:
        raise InvalidPoint("compression flag set on uncompressed encoding")
    infinity = bool(flags & 0x40)
    body = bytes([data[0] & 0x1F]) + data[1:]
    if infinity:
        if any(body) or (flags & 0x20):
            raise InvalidPoint("malformed infinity encoding")
        return None
    xc1 = int.from_bytes(body[0:48], "big")
    xc0 = int.from_bytes(body[48:96], "big")
    yc1 = int.from_bytes(body[96:144], "big")
    yc0 = int.from_bytes(body[144:192], "big")
    for v in (xc0, xc1, yc0, yc1):
        if v >= P:
            raise InvalidPoint("coordinate not in field")
    pt = ((xc0, xc1), (yc0, yc1))
    if not g2_is_on_curve(pt):
        raise InvalidPoint("point not on curve")
    if subgroup_check and not g2_in_subgroup(pt):
        raise InvalidPoint("point not in the prime-order subgroup")
    return pt


# ---------------------------------------------------------------------------
# Scalar field Fr — the reference exposes big-endian external encodings
# (bls_keys.rs:98-128) over the crate's canonical little-endian Scalar.
# ---------------------------------------------------------------------------


def scalar_from_le_bytes(data: bytes) -> int:
    """Canonical little-endian decode; rejects values >= R (Scalar::from_bytes)."""
    if len(data) != 32:
        raise InvalidPoint("scalar encoding must be 32 bytes")
    v = int.from_bytes(data, "little")
    if v >= R:
        raise InvalidPoint("non-canonical scalar")
    return v


def scalar_from_be_bytes(data: bytes) -> int:
    """The reference's external big-endian convention (bls_keys.rs:102-113)."""
    return scalar_from_le_bytes(bytes(reversed(data)))


def scalar_to_be_bytes(v: int) -> bytes:
    return (v % R).to_bytes(32, "big")


def scalar_id_from_u32(v: int) -> int:
    """bls_id_from_u32 (bls_common.rs:42-47): LE u32 embedded in a scalar."""
    return v % R


# ---------------------------------------------------------------------------
# Pairing: optimal ate.  e(P, Q) with P ∈ G1, Q ∈ G2 (on the M-twist).
# Untwist (x, y) -> (x/v, y/(v·w)) lands E''(Fp2) on E(Fp12).
# ---------------------------------------------------------------------------


def _fp12_from_fp2_coeffs(c_v0, c_v1, c_v2, c_wv0, c_wv1, c_wv2):
    return ((c_v0, c_v1, c_v2), (c_wv0, c_wv1, c_wv2))


def _untwist(q):
    """Map a point on the twist E''(Fp2) to E(Fp12)."""
    x, y = q
    # 1/v = v²/ξ and 1/(v·w) = v·w/ξ, so X = x·ξ⁻¹·v² and Y = y·ξ⁻¹·v·w.
    xi_inv = fp2_inv(XI)
    X = _fp12_from_fp2_coeffs(FP2_ZERO, FP2_ZERO, fp2_mul(x, xi_inv), FP2_ZERO, FP2_ZERO, FP2_ZERO)
    Y = _fp12_from_fp2_coeffs(
        FP2_ZERO, FP2_ZERO, FP2_ZERO, FP2_ZERO, fp2_mul(y, xi_inv), FP2_ZERO
    )
    return X, Y


def _line_eval(t, q, p):
    """Evaluate the line through t,q (or tangent at t if t==q) at P ∈ G1.

    t, q are affine points on E(Fp12) (untwisted); p = (px, py) with ints.
    Returns an Fp12 element.
    """
    (x1, y1), (x2, y2) = t, q
    px, py = p
    px_fp12 = _fp12_from_fp2_coeffs((px, 0), FP2_ZERO, FP2_ZERO, FP2_ZERO, FP2_ZERO, FP2_ZERO)
    py_fp12 = _fp12_from_fp2_coeffs((py, 0), FP2_ZERO, FP2_ZERO, FP2_ZERO, FP2_ZERO, FP2_ZERO)
    if x1 == x2 and y1 == y2:
        # tangent: λ = 3x²/2y
        num = _fp12_scalar_int(fp12_mul(x1, x1), 3)
        den = _fp12_scalar_int(y1, 2)
        lam = fp12_mul(num, fp12_inv(den))
    elif x1 == x2:
        # vertical line: l(P) = px - x1
        return _fp12_sub(px_fp12, x1)
    else:
        lam = fp12_mul(_fp12_sub(y2, y1), fp12_inv(_fp12_sub(x2, x1)))
    # l(P) = (py - y1) - λ(px - x1)
    return _fp12_sub(_fp12_sub(py_fp12, y1), fp12_mul(lam, _fp12_sub(px_fp12, x1)))


def _fp12_sub(a, b):
    return (fp6_sub(a[0], b[0]), fp6_sub(a[1], b[1]))


def _fp12_scalar_int(a, k):
    def s6(x):
        return tuple(fp2_scalar(c, k) for c in x)

    return (s6(a[0]), s6(a[1]))


def _e_fp12_add(p1, p2):
    """Affine addition on E(Fp12) (b irrelevant for add formulas)."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    (x1, y1), (x2, y2) = p1, p2
    if x1 == x2:
        if _fp12_is_zero(_fp12_addf(y1, y2)):
            return None
        lam = fp12_mul(_fp12_scalar_int(fp12_mul(x1, x1), 3), fp12_inv(_fp12_scalar_int(y1, 2)))
    else:
        lam = fp12_mul(_fp12_sub(y2, y1), fp12_inv(_fp12_sub(x2, x1)))
    x3 = _fp12_sub(_fp12_sub(fp12_mul(lam, lam), x1), x2)
    y3 = _fp12_sub(fp12_mul(lam, _fp12_sub(x1, x3)), y1)
    return (x3, y3)


def _fp12_addf(a, b):
    return (fp6_add(a[0], b[0]), fp6_add(a[1], b[1]))


def _fp12_is_zero(a):
    return all(fp2_is_zero(c) for c in a[0]) and all(fp2_is_zero(c) for c in a[1])


def miller_loop(p, q):
    """f_{|x|,Q}(P), conjugated for x < 0.  p ∈ G1 affine, q ∈ G2 affine."""
    if p is None or q is None:
        return FP12_ONE
    Q = _untwist(q)
    T = Q
    f = FP12_ONE
    n = abs(X_BLS)
    for bit in bin(n)[3:]:
        f = fp12_mul(fp12_sq(f), _line_eval(T, T, p))
        T = _e_fp12_add(T, T)
        if bit == "1":
            f = fp12_mul(f, _line_eval(T, Q, p))
            T = _e_fp12_add(T, Q)
    if X_BLS < 0:
        f = fp12_conj(f)
    return f


_HARD_EXP = (P**4 - P**2 + 1) // R


def final_exponentiation(f):
    # easy part: f^((p^6-1)(p^2+1))
    f1 = fp12_mul(fp12_conj(f), fp12_inv(f))
    f2 = fp12_mul(fp12_frobenius(fp12_frobenius(f1)), f1)
    # hard part: generic pow (conjugation == inversion is valid now)
    return fp12_pow(f2, _HARD_EXP)


def pairing(p, q):
    """Full pairing e(P, Q) with P ∈ G1, Q ∈ G2."""
    return final_exponentiation(miller_loop(p, q))


def pairings_equal(p1, q1, p2, q2):
    """e(P1, Q1) == e(P2, Q2) with a single final exponentiation."""
    f = fp12_mul(miller_loop(p1, q1), miller_loop(g1_neg(p2), q2))
    return final_exponentiation(f) == FP12_ONE


def bls_verify_precomputed_hash(pubkey, signature, hashed_msg) -> bool:
    """e(pk, H(m)) == e(g1, sig)  (bls_common.rs:26-35)."""
    return pairings_equal(pubkey, hashed_msg, G1_GEN, signature)


def bls_verify(pubkey, signature, message: bytes) -> bool:
    return bls_verify_precomputed_hash(pubkey, signature, hash_to_g2(message))


def bls_batch_verify_precomputed_hash(pubkeys, signatures, hashed_msg) -> bool:
    """Batch-verify n signatures over the SAME message hash with ONE
    pairing-equality check (random-linear-combination batching):

        e(Σ rᵢ·pkᵢ, H) · e(−g1, Σ rᵢ·sigᵢ) = 1   with fresh 128-bit rᵢ

    Bilinearity over the shared H collapses the n checks; a forgery
    passes with probability ≤ 2⁻¹²⁸.  Cost: n G1 + n G2 scalar-muls
    (native, ~1 ms each) + one pairing pair (~34 ms) vs n pairing pairs.
    Callers needing per-signature attribution fall back to
    ``bls_verify_precomputed_hash`` on failure."""
    import secrets

    assert len(pubkeys) == len(signatures)
    if not pubkeys:
        return True
    if len(pubkeys) == 1:
        return bls_verify_precomputed_hash(pubkeys[0], signatures[0], hashed_msg)
    agg_pk = None
    agg_sig = None
    for pk, sig in zip(pubkeys, signatures):
        r = secrets.randbits(128) | (1 << 127)
        agg_pk = g1_add(agg_pk, g1_mul(pk, r) if pk is not None else None)
        agg_sig = g2_add(agg_sig, g2_mul(sig, r) if sig is not None else None)
    return pairings_equal(agg_pk, hashed_msg, G1_GEN, agg_sig)


# ---------------------------------------------------------------------------
# Hash-to-curve: BLS12381G2_XMD:SHA-256_SSWU_RO_ (RFC 9380)
# DST fixed by the reference: bls_common.rs:12.
# ---------------------------------------------------------------------------

DST_G2 = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"

# SSWU curve E': y^2 = x^3 + A'x + B'  (3-isogenous to E)
_A_PRIME = (0, 240)
_B_PRIME = (1012, 1012)
_Z_SSWU = ((-2) % P, (-1) % P)  # Z = -(2 + u)

# 3-isogeny map constants (RFC 9380 Appendix E.3); standard public parameters.
_K1 = [
    (
        0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6,
        0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6,
    ),
    (
        0,
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71A,
    ),
    (
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71E,
        0x8AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38D,
    ),
    (
        0x171D6541FA38CCFAED6DEA691F5FB614CB14B4E7F4E810AA22D6108F142B85757098E38D0F671C7188E2AAAAAAAA5ED1,
        0,
    ),
]
_K2 = [
    (
        0,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA63,
    ),
    (
        0xC,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA9F,
    ),
]
_K3 = [
    (
        0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706,
        0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706,
    ),
    (
        0,
        0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97BE,
    ),
    (
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71C,
        0x8AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38F,
    ),
    (
        0x124C9AD43B6CF79BFBF7043DE3811AD0761B0F37A1E26286B0E977C69AA274524E79097A56DC4BD9E1B371C71C718B10,
        0,
    ),
]
_K4 = [
    (
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA8FB,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA8FB,
    ),
    (
        0,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA9D3,
    ),
    (
        0x12,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA99,
    ),
]

# Effective cofactor for G2 cofactor clearing (RFC 9380 §8.8.2).
H_EFF_G2 = 0xBC69F08F2EE75B3584C6A0EA91B352888E2A8E9145AD7689986FF031508FFE1329C2F178731DB956D82BF015D1212B02EC0EC69D7477C1AE954CBC06689F6A359894C0ADEBBF6B4E8020005AAA95551


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    """RFC 9380 §5.3.1 with SHA-256."""
    b_in_bytes = 32
    s_in_bytes = 64
    ell = -(-len_in_bytes // b_in_bytes)
    if ell > 255 or len_in_bytes > 65535 or len(dst) > 255:
        raise ValueError("expand_message_xmd bounds exceeded")
    dst_prime = dst + bytes([len(dst)])
    z_pad = bytes(s_in_bytes)
    l_i_b_str = len_in_bytes.to_bytes(2, "big")
    b0 = hashlib.sha256(z_pad + msg + l_i_b_str + b"\x00" + dst_prime).digest()
    b1 = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    blocks = [b1]
    for i in range(2, ell + 1):
        prev = blocks[-1]
        xored = bytes(a ^ b for a, b in zip(b0, prev))
        blocks.append(hashlib.sha256(xored + bytes([i]) + dst_prime).digest())
    return b"".join(blocks)[:len_in_bytes]


def hash_to_field_fp2(msg: bytes, count: int, dst: bytes = DST_G2):
    """RFC 9380 §5.2: hash to `count` elements of Fp2 (m=2, L=64)."""
    L = 64
    m = 2
    uniform = expand_message_xmd(msg, dst, count * m * L)
    out = []
    for i in range(count):
        coords = []
        for j in range(m):
            off = L * (j + i * m)
            coords.append(int.from_bytes(uniform[off : off + L], "big") % P)
        out.append(tuple(coords))
    return out


def _inv0_fp2(a):
    return FP2_ZERO if fp2_is_zero(a) else fp2_inv(a)


def map_to_curve_sswu_g2(u):
    """Simplified SWU on E' (RFC 9380 §6.6.2), returns a point on E'."""
    A, B, Z = _A_PRIME, _B_PRIME, _Z_SSWU
    u2 = fp2_sq(u)
    zu2 = fp2_mul(Z, u2)
    tv1 = _inv0_fp2(fp2_add(fp2_sq(zu2), zu2))
    neg_b_over_a = fp2_mul(fp2_neg(B), fp2_inv(A))
    if fp2_is_zero(tv1):
        x1 = fp2_mul(B, fp2_inv(fp2_mul(Z, A)))
    else:
        x1 = fp2_mul(neg_b_over_a, fp2_add(FP2_ONE, tv1))
    gx1 = fp2_add(fp2_add(fp2_mul(fp2_sq(x1), x1), fp2_mul(A, x1)), B)
    x2 = fp2_mul(zu2, x1)
    gx2 = fp2_add(fp2_add(fp2_mul(fp2_sq(x2), x2), fp2_mul(A, x2)), B)
    if fp2_legendre_norm(gx1) >= 0:
        x, y = x1, fp2_sqrt(gx1)
    else:
        x, y = x2, fp2_sqrt(gx2)
    if y is None:  # pragma: no cover - cannot happen for valid SSWU
        raise ArithmeticError("SSWU: no square root found")
    if fp2_sgn0(u) != fp2_sgn0(y):
        y = fp2_neg(y)
    return (x, y)


def iso_map_g2(pt):
    """3-isogeny E' -> E (RFC 9380 Appendix E.3)."""
    if pt is None:
        return None
    x, y = pt
    x2 = fp2_sq(x)
    x3 = fp2_mul(x2, x)
    x_num = fp2_add(
        fp2_add(fp2_mul(_K1[3], x3), fp2_mul(_K1[2], x2)), fp2_add(fp2_mul(_K1[1], x), _K1[0])
    )
    x_den = fp2_add(fp2_add(x2, fp2_mul(_K2[1], x)), _K2[0])
    y_num = fp2_add(
        fp2_add(fp2_mul(_K3[3], x3), fp2_mul(_K3[2], x2)), fp2_add(fp2_mul(_K3[1], x), _K3[0])
    )
    y_den = fp2_add(fp2_add(x3, fp2_mul(_K4[2], x2)), fp2_add(fp2_mul(_K4[1], x), _K4[0]))
    if fp2_is_zero(x_den) or fp2_is_zero(y_den):
        return None  # exceptional case: maps to infinity
    X = fp2_mul(x_num, fp2_inv(x_den))
    Y = fp2_mul(y, fp2_mul(y_num, fp2_inv(y_den)))
    return (X, Y)


def clear_cofactor_g2(pt):
    return g2_mul_raw(pt, H_EFF_G2)


def _hash_to_g2_uncached(msg: bytes, dst: bytes = DST_G2):
    u0, u1 = hash_to_field_fp2(msg, 2, dst)
    q0 = iso_map_g2(map_to_curve_sswu_g2(u0))
    q1 = iso_map_g2(map_to_curve_sswu_g2(u1))
    return clear_cofactor_g2(g2_add(q0, q1))


_H2G2_CACHE: dict = {}


def hash_to_g2(msg: bytes, dst: bytes = DST_G2):
    """hash_to_curve for the RO suite: two field elements, map, add, clear.

    Memoized: the verification flows hash the same cleartext once per
    generation (bls_keys.rs:215-217 precomputes for the same reason).
    """
    key = (bytes(msg), bytes(dst))
    hit = _H2G2_CACHE.get(key)
    if hit is None:
        if len(_H2G2_CACHE) > 4096:
            _H2G2_CACHE.clear()
        hit = _H2G2_CACHE[key] = _hash_to_g2_uncached(key[0], key[1])
    return hit
