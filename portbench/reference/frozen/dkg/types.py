"""DKG wire/data types.

Re-creates the reference's type layer (crates/dkg/src/types.rs): fixed-size
hex-serialized byte newtypes plus the structs for the four circuits, with the
exact serde field renames.  The reference's ``auth_commitment`` cargo feature
(types.rs:71-78) becomes a runtime flag: ``Commitment`` carries optional
``hash``/``signature`` fields and (de)serialization is driven by ``auth=``.

JSON deserialization semantics match serde's: missing required fields and
wrong-length hex are errors; unknown fields are ignored.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


class DeserializeError(ValueError):
    """JSON → typed-data decode failure (host-level error, exit code 1)."""


# ---------------------------------------------------------------------------
# Raw fixed-size byte newtypes (types.rs:247-441)
# ---------------------------------------------------------------------------


class RawBytes(bytes):
    SIZE: int = 0

    def __new__(cls, data):
        if isinstance(data, str):
            try:
                data = bytes.fromhex(data)
            except ValueError as e:
                raise DeserializeError(f"{cls.__name__}: invalid hex: {e}") from None
        data = bytes(data)
        if len(data) != cls.SIZE:
            raise DeserializeError(
                f"{cls.__name__}: expected {cls.SIZE} bytes, got {len(data)}"
            )
        return super().__new__(cls, data)

    @classmethod
    def from_hex(cls, h: str) -> "RawBytes":
        return cls(h)

    def to_hex(self) -> str:
        return self.hex()

    def __repr__(self) -> str:  # matches the reference's hex Debug impl
        return self.hex()

    @classmethod
    def json_schema(cls) -> dict:
        n = cls.SIZE * 2
        return {
            "description": "Hex encoded byte array",
            "type": "string",
            "maxLength": n,
            "minLength": n,
            "pattern": f"^[0-9a-fA-F]{{{n}}}$",
        }


class BLSPubkeyRaw(RawBytes):
    SIZE = 48


class BLSSignatureRaw(RawBytes):
    SIZE = 96


class BLSUncompressedPubkeyRaw(RawBytes):
    SIZE = 96


class BLSUncompressedSignatureRaw(RawBytes):
    SIZE = 192


class BLSSecretRaw(RawBytes):
    SIZE = 32


class BLSIdRaw(RawBytes):
    SIZE = 32


class SECP256K1PubkeyRaw(RawBytes):
    SIZE = 33


class SECP256K1SignatureRaw(RawBytes):
    SIZE = 64


class SECP256K1SecretRaw(RawBytes):
    SIZE = 32


class DkgGenId(RawBytes):
    SIZE = 16


class SHA256Raw(RawBytes):
    SIZE = 32


# ---------------------------------------------------------------------------
# JSON helpers
# ---------------------------------------------------------------------------


def _get(obj: dict, key: str, ctx: str):
    if not isinstance(obj, dict):
        raise DeserializeError(f"{ctx}: expected object")
    if key not in obj:
        raise DeserializeError(f"{ctx}: missing field `{key}`")
    return obj[key]


def _u8(v, ctx: str) -> int:
    if isinstance(v, bool) or not isinstance(v, int):
        raise DeserializeError(f"{ctx}: expected u8")
    if not (0 <= v <= 255):
        raise DeserializeError(f"{ctx}: u8 out of range: {v}")
    return v


def _raw(cls, v, ctx: str):
    if not isinstance(v, str):
        raise DeserializeError(f"{ctx}: expected hex string")
    try:
        return cls(v)
    except DeserializeError as e:
        raise DeserializeError(f"{ctx}: {e}") from None


def _raw_list(cls, v, ctx: str):
    if not isinstance(v, list):
        raise DeserializeError(f"{ctx}: expected array")
    return [_raw(cls, item, f"{ctx}[{i}]") for i, item in enumerate(v)]


# ---------------------------------------------------------------------------
# Setup descriptors — bind the abstract type slots to concrete raw types.
# (The crypto implementations live in dkg/keys.py; these constants only fix
# the byte-level layout, needed for (de)serialization.)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SetupLayout:
    name: str
    point_raw: type  # Setup::Point raw bytes (polynomial commitment points)
    dkg_pubkey_raw: type
    dkg_secret_raw: type
    dkg_signature_raw: type
    commitment_pubkey_raw: type
    commitment_signature_raw: type


BLS_SECP_LAYOUT = SetupLayout(
    name="BlsDkgWithSecp256kCommitment",
    point_raw=BLSPubkeyRaw,
    dkg_pubkey_raw=BLSPubkeyRaw,
    dkg_secret_raw=BLSSecretRaw,
    dkg_signature_raw=BLSSignatureRaw,
    commitment_pubkey_raw=SECP256K1PubkeyRaw,
    commitment_signature_raw=SECP256K1SignatureRaw,
)

BLS_BLS_LAYOUT = SetupLayout(
    name="BlsDkgWithBlsCommitment",
    point_raw=BLSPubkeyRaw,
    dkg_pubkey_raw=BLSPubkeyRaw,
    dkg_secret_raw=BLSSecretRaw,
    dkg_signature_raw=BLSSignatureRaw,
    commitment_pubkey_raw=BLSPubkeyRaw,
    commitment_signature_raw=BLSSignatureRaw,
)


# ---------------------------------------------------------------------------
# Data model (types.rs:27-203).  JSON field names follow the serde renames.
# ---------------------------------------------------------------------------


@dataclass
class GenerateSettings:
    n: int
    k: int
    gen_id: DkgGenId

    @classmethod
    def from_json(cls, obj, ctx="settings"):
        return cls(
            n=_u8(_get(obj, "n", ctx), f"{ctx}.n"),
            k=_u8(_get(obj, "k", ctx), f"{ctx}.k"),
            gen_id=_raw(DkgGenId, _get(obj, "gen_id", ctx), f"{ctx}.gen_id"),
        )

    def to_json(self):
        return {"n": self.n, "k": self.k, "gen_id": self.gen_id.hex()}


@dataclass
class InitialCommitment:
    hash: SHA256Raw
    settings: GenerateSettings
    base_pubkeys: List[RawBytes]

    @classmethod
    def from_json(cls, obj, layout: SetupLayout, ctx="initial_commitment"):
        return cls(
            hash=_raw(SHA256Raw, _get(obj, "hash", ctx), f"{ctx}.hash"),
            settings=GenerateSettings.from_json(
                _get(obj, "settings", ctx), f"{ctx}.settings"
            ),
            base_pubkeys=_raw_list(
                layout.point_raw, _get(obj, "base_pubkeys", ctx), f"{ctx}.base_pubkeys"
            ),
        )

    def to_json(self):
        return {
            "hash": self.hash.hex(),
            "settings": self.settings.to_json(),
            "base_pubkeys": [p.hex() for p in self.base_pubkeys],
        }


@dataclass
class ExchangedSecret:
    dst_base_hash: SHA256Raw
    secret: RawBytes  # JSON name: "shared_secret"

    @classmethod
    def from_json(cls, obj, layout: SetupLayout, ctx="ssecret"):
        return cls(
            dst_base_hash=_raw(
                SHA256Raw, _get(obj, "dst_base_hash", ctx), f"{ctx}.dst_base_hash"
            ),
            secret=_raw(
                layout.dkg_secret_raw, _get(obj, "shared_secret", ctx), f"{ctx}.shared_secret"
            ),
        )

    def to_json(self):
        return {"dst_base_hash": self.dst_base_hash.hex(), "shared_secret": self.secret.hex()}


@dataclass
class Commitment:
    pubkey: RawBytes
    hash: Optional[SHA256Raw] = None  # auth_commitment only
    signature: Optional[RawBytes] = None  # auth_commitment only

    @classmethod
    def from_json(cls, obj, layout: SetupLayout, auth: bool, ctx="commitment"):
        out = cls(
            pubkey=_raw(
                layout.commitment_pubkey_raw, _get(obj, "pubkey", ctx), f"{ctx}.pubkey"
            )
        )
        if auth:
            out.hash = _raw(SHA256Raw, _get(obj, "hash", ctx), f"{ctx}.hash")
            out.signature = _raw(
                layout.commitment_signature_raw,
                _get(obj, "signature", ctx),
                f"{ctx}.signature",
            )
        return out

    def to_json(self, auth: bool):
        out = {}
        if auth:
            out["hash"] = self.hash.hex() if self.hash is not None else None
        out["pubkey"] = self.pubkey.hex()
        if auth:
            out["signature"] = self.signature.hex() if self.signature is not None else None
        return out


@dataclass
class SeedExchangeCommitment:
    initial_commitment_hash: SHA256Raw
    shared_secret: ExchangedSecret  # JSON name: "ssecret"
    commitment: Commitment

    @classmethod
    def from_json(cls, obj, layout, auth, ctx="seeds_exchange_commitment"):
        return cls(
            initial_commitment_hash=_raw(
                SHA256Raw,
                _get(obj, "initial_commitment_hash", ctx),
                f"{ctx}.initial_commitment_hash",
            ),
            shared_secret=ExchangedSecret.from_json(
                _get(obj, "ssecret", ctx), layout, f"{ctx}.ssecret"
            ),
            commitment=Commitment.from_json(
                _get(obj, "commitment", ctx), layout, auth, f"{ctx}.commitment"
            ),
        )

    def to_json(self, auth: bool):
        return {
            "initial_commitment_hash": self.initial_commitment_hash.hex(),
            "ssecret": self.shared_secret.to_json(),
            "commitment": self.commitment.to_json(auth),
        }


@dataclass
class SharedData:
    verification_hashes: List[SHA256Raw]  # JSON name: "base_hashes"
    initial_commitment: InitialCommitment
    seeds_exchange_commitment: SeedExchangeCommitment

    @classmethod
    def from_json(cls, obj, layout: SetupLayout, auth: bool, ctx="SharedData"):
        return cls(
            verification_hashes=_raw_list(
                SHA256Raw, _get(obj, "base_hashes", ctx), f"{ctx}.base_hashes"
            ),
            initial_commitment=InitialCommitment.from_json(
                _get(obj, "initial_commitment", ctx), layout, f"{ctx}.initial_commitment"
            ),
            seeds_exchange_commitment=SeedExchangeCommitment.from_json(
                _get(obj, "seeds_exchange_commitment", ctx),
                layout,
                auth,
                f"{ctx}.seeds_exchange_commitment",
            ),
        )

    def to_json(self, auth: bool):
        return {
            "base_hashes": [h.hex() for h in self.verification_hashes],
            "initial_commitment": self.initial_commitment.to_json(),
            "seeds_exchange_commitment": self.seeds_exchange_commitment.to_json(auth),
        }


@dataclass
class Generation:
    verification_vector: List[RawBytes]  # JSON name: "base_pubkeys"
    base_hash: SHA256Raw
    partial_pubkey: RawBytes
    message_cleartext: str
    message_signature: RawBytes

    @classmethod
    def from_json(cls, obj, layout: SetupLayout, ctx="generation"):
        cleartext = _get(obj, "message_cleartext", ctx)
        if not isinstance(cleartext, str):
            raise DeserializeError(f"{ctx}.message_cleartext: expected string")
        return cls(
            verification_vector=_raw_list(
                layout.point_raw, _get(obj, "base_pubkeys", ctx), f"{ctx}.base_pubkeys"
            ),
            base_hash=_raw(SHA256Raw, _get(obj, "base_hash", ctx), f"{ctx}.base_hash"),
            partial_pubkey=_raw(
                layout.dkg_pubkey_raw, _get(obj, "partial_pubkey", ctx), f"{ctx}.partial_pubkey"
            ),
            message_cleartext=cleartext,
            message_signature=_raw(
                layout.dkg_signature_raw,
                _get(obj, "message_signature", ctx),
                f"{ctx}.message_signature",
            ),
        )

    def to_json(self):
        return {
            "base_pubkeys": [p.hex() for p in self.verification_vector],
            "base_hash": self.base_hash.hex(),
            "partial_pubkey": self.partial_pubkey.hex(),
            "message_cleartext": self.message_cleartext,
            "message_signature": self.message_signature.hex(),
        }


@dataclass
class FinalizationData:
    settings: GenerateSettings
    generations: List[Generation]
    aggregate_pubkey: RawBytes

    @classmethod
    def from_json(cls, obj, layout: SetupLayout, auth: bool = False, ctx="FinalizationData"):
        gens = _get(obj, "generations", ctx)
        if not isinstance(gens, list):
            raise DeserializeError(f"{ctx}.generations: expected array")
        return cls(
            settings=GenerateSettings.from_json(_get(obj, "settings", ctx), f"{ctx}.settings"),
            generations=[
                Generation.from_json(g, layout, f"{ctx}.generations[{i}]")
                for i, g in enumerate(gens)
            ],
            aggregate_pubkey=_raw(
                layout.dkg_pubkey_raw,
                _get(obj, "aggregate_pubkey", ctx),
                f"{ctx}.aggregate_pubkey",
            ),
        )

    def to_json(self, auth: bool = False):
        return {
            "settings": self.settings.to_json(),
            "generations": [g.to_json() for g in self.generations],
            "aggregate_pubkey": self.aggregate_pubkey.hex(),
        }


@dataclass
class BadPartialShareGeneration:
    verification_vector: List[RawBytes]  # JSON name: "base_pubkeys"
    base_hash: SHA256Raw

    @classmethod
    def from_json(cls, obj, layout: SetupLayout, ctx="generation"):
        return cls(
            verification_vector=_raw_list(
                layout.point_raw, _get(obj, "base_pubkeys", ctx), f"{ctx}.base_pubkeys"
            ),
            base_hash=_raw(SHA256Raw, _get(obj, "base_hash", ctx), f"{ctx}.base_hash"),
        )

    def to_json(self):
        return {
            "base_pubkeys": [p.hex() for p in self.verification_vector],
            "base_hash": self.base_hash.hex(),
        }


@dataclass
class BadPartialShare:
    settings: GenerateSettings
    data: Generation
    commitment: Commitment

    @classmethod
    def from_json(cls, obj, layout: SetupLayout, auth: bool, ctx="bad_partial"):
        return cls(
            settings=GenerateSettings.from_json(_get(obj, "settings", ctx), f"{ctx}.settings"),
            data=Generation.from_json(_get(obj, "data", ctx), layout, f"{ctx}.data"),
            commitment=Commitment.from_json(
                _get(obj, "commitment", ctx), layout, auth, f"{ctx}.commitment"
            ),
        )

    def to_json(self, auth: bool):
        return {
            "settings": self.settings.to_json(),
            "data": self.data.to_json(),
            "commitment": self.commitment.to_json(auth),
        }


@dataclass
class BadPartialShareData:
    settings: GenerateSettings
    generations: List[BadPartialShareGeneration]
    bad_partial: BadPartialShare

    @classmethod
    def from_json(cls, obj, layout: SetupLayout, auth: bool, ctx="BadPartialShareData"):
        gens = _get(obj, "generations", ctx)
        if not isinstance(gens, list):
            raise DeserializeError(f"{ctx}.generations: expected array")
        return cls(
            settings=GenerateSettings.from_json(_get(obj, "settings", ctx), f"{ctx}.settings"),
            generations=[
                BadPartialShareGeneration.from_json(g, layout, f"{ctx}.generations[{i}]")
                for i, g in enumerate(gens)
            ],
            bad_partial=BadPartialShare.from_json(
                _get(obj, "bad_partial", ctx), layout, auth, f"{ctx}.bad_partial"
            ),
        )

    def to_json(self, auth: bool):
        return {
            "settings": self.settings.to_json(),
            "generations": [g.to_json() for g in self.generations],
            "bad_partial": self.bad_partial.to_json(auth),
        }


@dataclass
class BadEncryptedShare:
    sender_pubkey: RawBytes
    sender_encr_pubkey: RawBytes
    receiver_encr_seckey: RawBytes
    encrypted_message: str  # JSON name: "encrypted_data" (hex payload)
    settings: GenerateSettings
    base_hashes: List[SHA256Raw]
    sender_base_pubkeys: List[RawBytes]
    receiver_base_pubkeys: List[RawBytes]

    @classmethod
    def from_json(cls, obj, layout: SetupLayout, auth: bool = False, ctx="BadEncryptedShare"):
        enc = _get(obj, "encrypted_data", ctx)
        if not isinstance(enc, str):
            raise DeserializeError(f"{ctx}.encrypted_data: expected string")
        return cls(
            sender_pubkey=_raw(
                layout.commitment_pubkey_raw, _get(obj, "sender_pubkey", ctx), f"{ctx}.sender_pubkey"
            ),
            sender_encr_pubkey=_raw(
                layout.point_raw, _get(obj, "sender_encr_pubkey", ctx), f"{ctx}.sender_encr_pubkey"
            ),
            receiver_encr_seckey=_raw(
                layout.dkg_secret_raw,
                _get(obj, "receiver_encr_seckey", ctx),
                f"{ctx}.receiver_encr_seckey",
            ),
            encrypted_message=enc,
            settings=GenerateSettings.from_json(_get(obj, "settings", ctx), f"{ctx}.settings"),
            base_hashes=_raw_list(SHA256Raw, _get(obj, "base_hashes", ctx), f"{ctx}.base_hashes"),
            sender_base_pubkeys=_raw_list(
                layout.dkg_pubkey_raw,
                _get(obj, "sender_base_pubkeys", ctx),
                f"{ctx}.sender_base_pubkeys",
            ),
            receiver_base_pubkeys=_raw_list(
                layout.dkg_pubkey_raw,
                _get(obj, "receiver_base_pubkeys", ctx),
                f"{ctx}.receiver_base_pubkeys",
            ),
        )

    def to_json(self, auth: bool = False):
        return {
            "sender_pubkey": self.sender_pubkey.hex(),
            "sender_encr_pubkey": self.sender_encr_pubkey.hex(),
            "receiver_encr_seckey": self.receiver_encr_seckey.hex(),
            "encrypted_data": self.encrypted_message,
            "settings": self.settings.to_json(),
            "base_hashes": [h.hex() for h in self.base_hashes],
            "sender_base_pubkeys": [p.hex() for p in self.sender_base_pubkeys],
            "receiver_base_pubkeys": [p.hex() for p in self.receiver_base_pubkeys],
        }
