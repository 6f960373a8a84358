"""secp256k1 ECDSA (verification + RFC 6979 signing), pure Python.

Mirrors the semantics the reference gets from the (patched) ``secp256k1``
crate (crates/dkg/src/crypto/secp256k1_keys.rs):

  * 33-byte compressed public keys (``PublicKey::from_slice``)
  * 64-byte compact signatures ``r || s`` big-endian
    (``Signature::from_compact`` — rejects overflow / zero)
  * ``verify_ecdsa`` — rejects high-S signatures (libsecp256k1 requires
    normalized signatures) and non-32-byte digests
  * deterministic RFC 6979 signing with low-S normalization (used by tests)
"""

from __future__ import annotations

import hashlib
import hmac

from ..utils.errors import InvalidPoint

P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
G = (
    0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
)


def _add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, P - 2, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, P - 2, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def _mul(pt, k):
    """k·pt by left-to-right double-and-add in Jacobian coordinates, one
    inversion at the end (this frozen copy's faster ladder; ``_mul_affine``
    is the port's, which it must equal)."""
    if pt is None or k <= 0:
        return None
    x2, y2 = pt
    acc = None  # (X, Y, Z), None the identity
    for bit in bin(k)[2:]:
        if acc is not None:
            acc = _jac_double(acc)
        if bit == "1":
            acc = (x2, y2, 1) if acc is None else _jac_add_affine(acc, x2, y2)
    if acc is None:
        return None
    X, Y, Z = acc
    zi = pow(Z, -1, P)
    zi2 = zi * zi % P
    return (X * zi2 % P, Y * zi2 * zi % P)


def _jac_double(p):
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


def _jac_add_affine(p, x2, y2):
    X1, Y1, Z1 = p
    Z1Z1 = Z1 * Z1 % P
    H = (x2 * Z1Z1 - X1) % P
    r = (y2 * Z1 * Z1Z1 - Y1) % P
    if H == 0:
        return _jac_double(p) if r == 0 else None
    HH = H * H % P
    HHH = H * HH % P
    V = X1 * HH % P
    X3 = (r * r - HHH - 2 * V) % P
    return (X3, (r * (V - X3) - Y1 * HHH) % P, Z1 * H % P)


def _mul_affine(pt, k):
    result = None
    add = pt
    while k > 0:
        if k & 1:
            result = _add(result, add)
        add = _add(add, add)
        k >>= 1
    return result


def _on_curve(pt):
    if pt is None:
        return False
    x, y = pt
    return (y * y - (x * x * x + 7)) % P == 0


def pubkey_from_bytes(data: bytes):
    """Parse a 33-byte compressed (or 65-byte uncompressed) public key."""
    if len(data) == 33 and data[0] in (2, 3):
        x = int.from_bytes(data[1:], "big")
        if x >= P:
            raise InvalidPoint("x not in field")
        y2 = (x * x * x + 7) % P
        y = pow(y2, (P + 1) // 4, P)
        if y * y % P != y2:
            raise InvalidPoint("x not on curve")
        if (y & 1) != (data[0] & 1):
            y = P - y
        return (x, y)
    if len(data) == 65 and data[0] == 4:
        x = int.from_bytes(data[1:33], "big")
        y = int.from_bytes(data[33:], "big")
        pt = (x, y)
        if x >= P or y >= P or not _on_curve(pt):
            raise InvalidPoint("invalid uncompressed point")
        return pt
    raise InvalidPoint("invalid public key encoding")


def pubkey_to_bytes(pt) -> bytes:
    x, y = pt
    return bytes([2 | (y & 1)]) + x.to_bytes(32, "big")


def seckey_from_bytes(data: bytes) -> int:
    if len(data) != 32:
        raise InvalidPoint("secret key must be 32 bytes")
    k = int.from_bytes(data, "big")
    if not (0 < k < N):
        raise InvalidPoint("secret key out of range")
    return k


def seckey_to_pubkey(k: int):
    return _mul(G, k)


def sig_from_compact(data: bytes):
    """Parse r||s (64 bytes, big-endian).  Rejects overflow like libsecp."""
    if len(data) != 64:
        raise InvalidPoint("compact signature must be 64 bytes")
    r = int.from_bytes(data[:32], "big")
    s = int.from_bytes(data[32:], "big")
    if r >= N or s >= N:
        raise InvalidPoint("signature component overflow")
    return (r, s)


def sig_to_compact(sig) -> bytes:
    r, s = sig
    return r.to_bytes(32, "big") + s.to_bytes(32, "big")


def verify(pubkey, digest: bytes, sig) -> bool:
    """ECDSA verify over a 32-byte digest; high-S signatures are rejected
    (matching libsecp256k1's normalization requirement)."""
    if len(digest) != 32:
        return False
    r, s = sig
    if not (0 < r < N and 0 < s < N):
        return False
    if s > N // 2:
        return False  # non-normalized (high-S) signatures fail verification
    z = int.from_bytes(digest, "big")
    w = pow(s, N - 2, N)
    u1 = z * w % N
    u2 = r * w % N
    pt = _add(_mul(G, u1), _mul(pubkey, u2))
    if pt is None:
        return False
    return pt[0] % N == r


def _rfc6979_nonce(seckey: int, digest: bytes) -> int:
    """RFC 6979 deterministic nonce with SHA-256."""
    x = seckey.to_bytes(32, "big")
    h1 = digest
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 0 < cand < N:
            return cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


def sign(seckey: int, digest: bytes):
    """Deterministic low-S ECDSA signature over a 32-byte digest."""
    if len(digest) != 32:
        raise ValueError("digest must be 32 bytes")
    z = int.from_bytes(digest, "big")
    while True:
        k = _rfc6979_nonce(seckey, digest)
        pt = _mul(G, k)
        r = pt[0] % N
        if r == 0:
            digest = hashlib.sha256(digest).digest()
            continue
        s = pow(k, N - 2, N) * (z + r * seckey) % N
        if s == 0:
            digest = hashlib.sha256(digest).digest()
            continue
        if s > N // 2:
            s = N - s
        return (r, s)
