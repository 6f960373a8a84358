"""Crypto key wrappers + DKG setup bundles.

Re-creates the reference's trait lattice (crates/dkg/src/crypto/traits.rs,
bls_keys.rs, secp256k1_keys.rs) as plain classes.  The reference distinguishes
``from_bytes`` (SP1-patched fast path that *crashes* on invalid points) from
``from_bytes_safe`` (validating path returning errors, bls_common.rs:49-106).
Here both paths fully validate and raise ``InvalidPoint``; call sites choose
whether that becomes a guest panic or a Slashable/Unslashable error, matching
the reference's call-site behavior.
"""

from __future__ import annotations

from ..hostcrypto import bls12_381 as bls
from ..hostcrypto import secp256k1 as secp
from ..utils.errors import InvalidPoint
from .types import (
    BLS_BLS_LAYOUT,
    BLS_SECP_LAYOUT,
    BLSPubkeyRaw,
    BLSSecretRaw,
    BLSSignatureRaw,
    SECP256K1PubkeyRaw,
    SECP256K1SecretRaw,
    SECP256K1SignatureRaw,
)


class BlsPublicKey:
    """G1 public key (bls_keys.rs:7-87)."""

    __slots__ = ("point",)

    def __init__(self, point):
        self.point = point

    @classmethod
    def from_bytes(cls, raw: bytes) -> "BlsPublicKey":
        return cls(bls.g1_from_compressed(bytes(raw)))

    from_bytes_safe = from_bytes

    def to_bytes(self) -> BLSPubkeyRaw:
        return BLSPubkeyRaw(bls.g1_to_compressed(self.point))

    def verify_signature(self, message: bytes, signature: "BlsSignature") -> bool:
        return bls.bls_verify(self.point, signature.point, message)

    def verify_signature_from_precomputed_mapping(self, mapping, signature) -> bool:
        return bls.bls_verify_precomputed_hash(self.point, signature.point, mapping)

    def __eq__(self, other):
        return isinstance(other, BlsPublicKey) and self.point == other.point

    def __repr__(self):
        return f"PublicKey({self.to_bytes().hex()})"


class BlsSecretKey:
    """Fr secret key; external encoding is big-endian (bls_keys.rs:98-128)."""

    __slots__ = ("scalar",)

    def __init__(self, scalar: int):
        self.scalar = scalar % bls.R

    @classmethod
    def from_bytes(cls, raw: bytes) -> "BlsSecretKey":
        return cls(bls.scalar_from_be_bytes(bytes(raw)))

    from_bytes_safe = from_bytes

    def to_bytes(self) -> BLSSecretRaw:
        return BLSSecretRaw(bls.scalar_to_be_bytes(self.scalar))

    def to_public_key(self) -> BlsPublicKey:
        return BlsPublicKey(bls.g1_mul(bls.G1_GEN, self.scalar))


class BlsSignature:
    """G2 signature (bls_keys.rs:154-202)."""

    __slots__ = ("point",)

    def __init__(self, point):
        self.point = point

    @classmethod
    def from_bytes(cls, raw: bytes) -> "BlsSignature":
        return cls(bls.g2_from_compressed(bytes(raw)))

    from_bytes_safe = from_bytes

    def to_bytes(self) -> BLSSignatureRaw:
        return BLSSignatureRaw(bls.g2_to_compressed(self.point))

    def __repr__(self):
        return f"Signature({self.to_bytes().hex()})"


class BlsCrypto:
    """CryptoKeys impl for BLS (bls_keys.rs:204-218)."""

    Pubkey = BlsPublicKey
    SecretKey = BlsSecretKey
    Signature = BlsSignature

    @staticmethod
    def precompute_message_mapping(msg: bytes):
        return bls.hash_to_g2(msg)


class Secp256k1PublicKey:
    __slots__ = ("point",)

    def __init__(self, point):
        self.point = point

    @classmethod
    def from_bytes(cls, raw: bytes) -> "Secp256k1PublicKey":
        return cls(secp.pubkey_from_bytes(bytes(raw)))

    from_bytes_safe = from_bytes

    def to_bytes(self) -> SECP256K1PubkeyRaw:
        return SECP256K1PubkeyRaw(secp.pubkey_to_bytes(self.point))

    def verify_signature(self, message: bytes, signature: "Secp256k1Signature") -> bool:
        # secp256k1_keys.rs:51-64 — non-32-byte digests fail verification
        return secp.verify(self.point, bytes(message), signature.sig)

    def verify_signature_from_precomputed_mapping(self, mapping, signature) -> bool:
        return self.verify_signature(mapping, signature)

    def __eq__(self, other):
        return isinstance(other, Secp256k1PublicKey) and self.point == other.point


class Secp256k1SecretKey:
    __slots__ = ("scalar",)

    def __init__(self, scalar: int):
        self.scalar = scalar

    @classmethod
    def from_bytes(cls, raw: bytes) -> "Secp256k1SecretKey":
        return cls(secp.seckey_from_bytes(bytes(raw)))

    from_bytes_safe = from_bytes

    def to_bytes(self) -> SECP256K1SecretRaw:
        return SECP256K1SecretRaw(self.scalar.to_bytes(32, "big"))

    def to_public_key(self) -> Secp256k1PublicKey:
        return Secp256k1PublicKey(secp.seckey_to_pubkey(self.scalar))

    def sign(self, digest: bytes) -> "Secp256k1Signature":
        return Secp256k1Signature(secp.sign(self.scalar, digest))


class Secp256k1Signature:
    __slots__ = ("sig",)

    def __init__(self, sig):
        self.sig = sig

    @classmethod
    def from_bytes(cls, raw: bytes) -> "Secp256k1Signature":
        return cls(secp.sig_from_compact(bytes(raw)))

    from_bytes_safe = from_bytes

    def to_bytes(self) -> SECP256K1SignatureRaw:
        return SECP256K1SignatureRaw(secp.sig_to_compact(self.sig))


class Secp256k1Crypto:
    Pubkey = Secp256k1PublicKey
    SecretKey = Secp256k1SecretKey
    Signature = Secp256k1Signature

    @staticmethod
    def precompute_message_mapping(msg: bytes):
        return bytes(msg)


# ---------------------------------------------------------------------------
# Curve-math wrappers used by dkg_math (dkg_math.rs:10-142)
# ---------------------------------------------------------------------------


class BlsScalar:
    __slots__ = ("value",)

    def __init__(self, value: int):
        self.value = value % bls.R

    @classmethod
    def from_u32(cls, x: int) -> "BlsScalar":
        return cls(bls.scalar_id_from_u32(x))

    @classmethod
    def from_bytes(cls, raw: bytes) -> "BlsScalar":
        return cls(bls.scalar_from_be_bytes(bytes(raw)))

    from_bytes_safe = from_bytes

    def to_bytes(self) -> BLSSecretRaw:
        return BLSSecretRaw(bls.scalar_to_be_bytes(self.value))

    def mul(self, other: "BlsScalar") -> "BlsScalar":
        return BlsScalar(self.value * other.value % bls.R)

    def sub(self, other: "BlsScalar") -> "BlsScalar":
        return BlsScalar((self.value - other.value) % bls.R)

    def is_zero(self) -> bool:
        return self.value == 0

    def invert(self) -> "BlsScalar":
        if self.value == 0:
            raise ZeroDivisionError("invalid scalar")
        return BlsScalar(pow(self.value, bls.R - 2, bls.R))


class BlsG1:
    """G1 point wrapper implementing the TPoint surface (dkg_math.rs:106-128)."""

    __slots__ = ("point",)

    def __init__(self, point):
        self.point = point

    @classmethod
    def identity(cls) -> "BlsG1":
        return cls(None)

    @classmethod
    def from_bytes(cls, raw: bytes) -> "BlsG1":
        return cls(bls.g1_from_compressed(bytes(raw)))

    from_bytes_safe = from_bytes

    def to_bytes(self) -> BLSPubkeyRaw:
        return BLSPubkeyRaw(bls.g1_to_compressed(self.point))

    def add(self, other: "BlsG1") -> "BlsG1":
        return BlsG1(bls.g1_add(self.point, other.point))

    def mul_scalar(self, scalar: BlsScalar) -> "BlsG1":
        return BlsG1(bls.g1_mul(self.point, scalar.value))

    def __eq__(self, other):
        return isinstance(other, BlsG1) and self.point == other.point


class BlsG1Curve:
    Point = BlsG1
    Scalar = BlsScalar


# ---------------------------------------------------------------------------
# Setup bundles (types.rs:9-25): bind layouts + crypto + curve math.
# ---------------------------------------------------------------------------


class BlsDkgWithSecp256kCommitment:
    """TargetCryptography=BLS, IdentityCryptography=secp256k1 — the setup
    instantiated by the host for all four circuits (src/main.rs:421)."""

    layout = BLS_SECP_LAYOUT
    TargetCryptography = BlsCrypto
    IdentityCryptography = Secp256k1Crypto
    Curve = BlsG1Curve
    Point = BlsG1
    Scalar = BlsScalar
    DkgPubkey = BlsPublicKey
    DkgSecretKey = BlsSecretKey
    DkgSignature = BlsSignature
    CommitmentPubkey = Secp256k1PublicKey
    CommitmentSignature = Secp256k1Signature


class BlsDkgWithBlsCommitment:
    """TargetCryptography=IdentityCryptography=BLS — used by the
    finalization guest (crates/finalization_prove/src/main.rs:9-10)."""

    layout = BLS_BLS_LAYOUT
    TargetCryptography = BlsCrypto
    IdentityCryptography = BlsCrypto
    Curve = BlsG1Curve
    Point = BlsG1
    Scalar = BlsScalar
    DkgPubkey = BlsPublicKey
    DkgSecretKey = BlsSecretKey
    DkgSignature = BlsSignature
    CommitmentPubkey = BlsPublicKey
    CommitmentSignature = BlsSignature
