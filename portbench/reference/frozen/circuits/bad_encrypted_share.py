"""Circuit 3: malicious share-exchange encryption (bad_encrypted_share_prove).

Re-creates crates/bad_encrypted_share_prove/src/main.rs:277-405, including the
two behavioral quirks that the golden vectors pin down:

  * only a *decrypt/parse failure* commits public values and exits 0
    (main.rs:358-370); both the valid-share path and the verification-failure
    path fall through to the final ``panic!`` (main.rs:404)
  * the binary parser errors (→ exit 0) when the decrypted payload is too
    short, but ``finalize()`` *asserts* (→ panic, exit 1) when trailing bytes
    remain (main.rs:129-137)

Deterministic-ECDH convention (doc/dkg_verification.md): each party's base
pubkeys are sorted bytewise and the LAST one is the encryption key
(main.rs:314-329).  ChaCha20 key/nonce are SHA256(compressed ECDH point) and
its first 12 bytes (main.rs:16-30).
"""

from __future__ import annotations

import hashlib

from ..dkg import hash_recorder

from ..dkg.keys import BlsDkgWithSecp256kCommitment
from ..dkg.types import (
    BadEncryptedShare,
    Commitment,
    ExchangedSecret,
    InitialCommitment,
    SHA256Raw,
    SeedExchangeCommitment,
    SharedData,
)
from ..dkg.verification import (
    compute_initial_commitment_hash,
    verify_initial_commitment_hash,
    verify_seed_exchange_commitment,
)
from ..hostcrypto.chacha20 import chacha20_xor
from ..utils import cbor
from ..utils.errors import GuestPanic, VerificationError
from .guest_api import GuestContext


class ParseError(Exception):
    """Binary-payload parse failure — the only exit-0 path of this circuit."""


class BinaryStream:
    """main.rs:81-137: sequential reader; short reads are ParseErrors, but
    ``finalize`` *panics* if any bytes remain unconsumed."""

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def bytes_left(self) -> int:
        return max(0, len(self.data) - self.pos)

    def read(self, n: int, what: str) -> bytes:
        if self.bytes_left() < n:
            raise ParseError(
                f"Invalid {what}: Not enough bytes at position {self.pos}, "
                f"needed {n}, but only {self.bytes_left()} remain."
            )
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def finalize(self) -> None:
        print(f"Read {self.pos} bytes, {len(self.data) - self.pos} remain")
        if self.pos != len(self.data):
            raise GuestPanic("BinaryStream.finalize: unconsumed bytes")


def _parse_message(
    setup,
    msg: bytes,
    settings,
    base_pubkeys,
    commitment_hashes,
    receiver_commitment_hash: SHA256Raw,
    sender_commitment_hash: SHA256Raw,
    auth: bool,
) -> SharedData:
    """main.rs:139-275 (auth and no_auth payload layouts)."""
    layout = setup.layout
    stream = BinaryStream(msg)

    gen_id = stream.read(16, "gen_id")
    msg_type = stream.read(1, "msg_type")[0]
    secret = layout.dkg_secret_raw(stream.read(layout.dkg_secret_raw.SIZE, "secret"))
    if auth:
        commitment_hash = SHA256Raw(stream.read(32, "commitment_hash"))
        commitment_pubkey = layout.commitment_pubkey_raw(
            stream.read(layout.commitment_pubkey_raw.SIZE, "commitment_pubkey")
        )
        commitment_signature = layout.commitment_signature_raw(
            stream.read(layout.commitment_signature_raw.SIZE, "commitment_signature")
        )
    else:
        commitment_hash = None
        commitment_pubkey = layout.commitment_pubkey_raw(
            stream.read(layout.commitment_pubkey_raw.SIZE, "commitment_pubkey")
        )
        commitment_signature = None

    stream.finalize()  # trailing bytes PANIC (exit 1), not ParseError

    if bytes(settings.gen_id) != gen_id:
        raise ParseError("Invalid gen_id")
    if msg_type != 3:
        raise ParseError("Invalid msg_type")

    initial_commitment = InitialCommitment(
        hash=sender_commitment_hash, settings=settings, base_pubkeys=list(base_pubkeys)
    )
    return SharedData(
        verification_hashes=list(commitment_hashes),
        initial_commitment=initial_commitment,
        seeds_exchange_commitment=SeedExchangeCommitment(
            initial_commitment_hash=sender_commitment_hash,
            shared_secret=ExchangedSecret(dst_base_hash=receiver_commitment_hash, secret=secret),
            commitment=Commitment(
                pubkey=commitment_pubkey, hash=commitment_hash, signature=commitment_signature
            ),
        ),
    )


def main(ctx: GuestContext, input_bytes: bytes, auth: bool) -> None:
    run(BlsDkgWithSecp256kCommitment, ctx, input_bytes, auth)


def run(setup, ctx: GuestContext, input_bytes: bytes, auth: bool) -> None:
    try:
        obj = cbor.decode(input_bytes)
        data = BadEncryptedShare.from_json(obj, setup.layout, auth)
    except Exception as e:
        raise GuestPanic(f"Failed to deserialize share data: {e}") from None

    sender_commitment_hash = compute_initial_commitment_hash(
        data.settings, data.sender_base_pubkeys
    )
    if not any(h == sender_commitment_hash for h in data.base_hashes):
        raise GuestPanic(f"Invalid sender_commitment_hash {sender_commitment_hash.hex()}")

    receiver_commitment_hash = compute_initial_commitment_hash(
        data.settings, data.receiver_base_pubkeys
    )
    if not any(h == receiver_commitment_hash for h in data.base_hashes):
        raise GuestPanic(f"Invalid receiver_commitment_hash {receiver_commitment_hash.hex()}")

    ordered_receiver = sorted(data.receiver_base_pubkeys)
    receiver_sk = setup.DkgSecretKey.from_bytes(data.receiver_encr_seckey)  # panic on invalid
    receiver_pk_bytes = receiver_sk.to_public_key().to_bytes()
    if bytes(receiver_pk_bytes) != bytes(ordered_receiver[-1]):
        raise GuestPanic("Invalid encryption key")

    ordered_sender = sorted(data.sender_base_pubkeys)
    if bytes(data.sender_encr_pubkey) != bytes(ordered_sender[-1]):
        raise GuestPanic("Invalid encryption key")

    if len(data.base_hashes) != data.settings.n:
        raise GuestPanic("The number of verification hashes does not match the number of keys")
    if data.settings.n < data.settings.k:
        raise GuestPanic("N should be greater than or equal to k")

    our = setup.Scalar.from_bytes(data.receiver_encr_seckey)
    their = setup.Point.from_bytes(data.sender_encr_pubkey)
    p = their.mul_scalar(our)

    # ChaCha20 key/nonce derived from the compressed ECDH point (main.rs:16-30)
    base = bytes(p.to_bytes())
    key = hashlib.sha256(base).digest()
    hash_recorder.record(base, key)
    nonce = key[:12]

    try:
        encrypted_bytes = bytes.fromhex(data.encrypted_message)
    except ValueError:
        raise GuestPanic("invalid hex in encrypted_message") from None
    hash_recorder.record_chacha(key, nonce, 0, encrypted_bytes)
    decrypted = chacha20_xor(key, nonce, encrypted_bytes)

    try:
        shared_data = _parse_message(
            setup,
            decrypted,
            data.settings,
            data.sender_base_pubkeys,
            data.base_hashes,
            receiver_commitment_hash,
            sender_commitment_hash,
            auth,
        )
    except ParseError as e:
        print(f"Error: {e}")
        for h in data.base_hashes:
            print(f"Verification hash: {h.hex()}, {e}")
            ctx.commit(h)
        ctx.commit(receiver_pk_bytes)
        ctx.commit(data.sender_encr_pubkey)
        ctx.commit(data.encrypted_message)
        return  # exit 0: undecryptable/malformed payload is the provable fault

    if not verify_initial_commitment_hash(shared_data.initial_commitment):
        raise GuestPanic("Unsalshable error while verifying commitment hash")

    try:
        verify_seed_exchange_commitment(
            setup,
            shared_data.verification_hashes,
            shared_data.seeds_exchange_commitment,
            shared_data.initial_commitment,
            auth,
        )
    except VerificationError as e:
        # main.rs:385-402: commits happen here, but control STILL falls
        # through to the final panic — exit code remains 1.
        print(f"Slashable error seed exchange commitment: {e}")
        for h in data.base_hashes:
            print(f"Verification hash: {h.hex()}, {e}")
            ctx.commit(h)
        ctx.commit(receiver_pk_bytes)
        ctx.commit(data.sender_encr_pubkey)
        ctx.commit(data.encrypted_message)
    else:
        print("The share is valid. We can't prove participant share is corrupted.")

    raise GuestPanic("The seed exchange commitment is valid")
