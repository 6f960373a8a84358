"""DKG scenario generator — valid and faulty inputs at arbitrary t-of-n.

Frozen copy of the port's ``dkg/scenario_gen.py``, on the reference's
frozen host crypto: the benchmark's traffic, deterministic from the
committee's seed bytes, and out of reach of later changes to the port.
The generator follows the protocol spec (doc/dkg_verification.md) at any
committee size.

Implements the PDKG data flow: per-participant Shamir polynomials, Feldman
verification vectors, base-hash-sorted id assignment, aggregate-key
derivation, BLS partial signatures, and (auth mode) secp256k1-signed seed
exchange commitments.
"""

from __future__ import annotations

import hashlib

from ..reference.frozen.hostcrypto import bls12_381 as bls
from ..reference.frozen.dkg.keys import BlsSecretKey, Secp256k1SecretKey
from ..reference.frozen.dkg.types import (
    BLSPubkeyRaw,
    BLSSecretRaw,
    BLSSignatureRaw,
    Commitment,
    DkgGenId,
    ExchangedSecret,
    FinalizationData,
    GenerateSettings,
    Generation,
    InitialCommitment,
    SECP256K1SecretRaw,
    SeedExchangeCommitment,
    SHA256Raw,
    SharedData,
)
from ..reference.frozen.dkg.verification import compute_initial_commitment_hash, compute_seed_exchange_hash


def _rand_scalar(seed: bytes, tag: bytes) -> int:
    return int.from_bytes(hashlib.sha256(seed + tag).digest(), "big") % bls.R


def _g1_compress(pt) -> BLSPubkeyRaw:
    return BLSPubkeyRaw(bls.g1_to_compressed(pt))


def _bls_sign(sk: int, message: bytes) -> BLSSignatureRaw:
    sig = bls.g2_mul(bls.hash_to_g2(message), sk)
    return BLSSignatureRaw(bls.g2_to_compressed(sig))


class DkgCommittee:
    """An n-participant, threshold-k DKG ceremony (deterministic from seed)."""

    def __init__(self, n: int, k: int, seed: bytes = b"dvt-tpu-committee"):
        assert 1 <= k <= n <= 255
        self.n = n
        self.k = k
        self.seed = seed
        self.gen_id = DkgGenId(hashlib.sha256(seed + b"/gen_id").digest()[:16])
        self.settings = GenerateSettings(n=n, k=k, gen_id=self.gen_id)
        # per-participant Shamir polynomials (degree k-1)
        self.polys = [
            [_rand_scalar(seed, b"c%d/%d" % (i, j)) for j in range(k)] for i in range(n)
        ]
        # Feldman verification vectors: g·c_{i,j}
        self.vvs = [
            [_g1_compress(bls.g1_mul(bls.G1_GEN, c)) for c in poly] for poly in self.polys
        ]
        self.base_hashes = [
            compute_initial_commitment_hash(self.settings, vv) for vv in self.vvs
        ]
        # ids are assigned by base-hash sort order (verification.rs:279-297)
        self.sorted_order = sorted(range(n), key=lambda i: bytes(self.base_hashes[i]))
        self.id_of = {p: rank + 1 for rank, p in enumerate(self.sorted_order)}
        # identity (secp256k1) keys for commitment auth
        self.secp_keys = [
            Secp256k1SecretKey.from_bytes(
                SECP256K1SecretRaw(hashlib.sha256(seed + b"/secp%d" % i).digest())
            )
            for i in range(n)
        ]

    # -- protocol quantities -------------------------------------------------

    def poly_eval(self, participant: int, x: int) -> int:
        acc = 0
        for c in reversed(self.polys[participant]):
            acc = (acc * x + c) % bls.R
        return acc

    def aggregate_share(self, x: int) -> int:
        """F(x) with F = Σᵢ fᵢ."""
        return sum(self.poly_eval(i, x) for i in range(self.n)) % bls.R

    @property
    def aggregate_pubkey(self) -> BLSPubkeyRaw:
        return _g1_compress(bls.g1_mul(bls.G1_GEN, self.aggregate_share(0)))

    # -- finalization scenario ----------------------------------------------

    def finalization_data(self, message: str = "dvt finalization") -> FinalizationData:
        gens = []
        for i in range(self.n):
            share = self.aggregate_share(self.id_of[i])
            gens.append(
                Generation(
                    verification_vector=list(self.vvs[i]),
                    base_hash=self.base_hashes[i],
                    partial_pubkey=_g1_compress(bls.g1_mul(bls.G1_GEN, share)),
                    message_cleartext=message,
                    message_signature=_bls_sign(share, message.encode()),
                )
            )
        return FinalizationData(
            settings=self.settings,
            generations=gens,
            aggregate_pubkey=self.aggregate_pubkey,
        )

    # -- share-exchange scenario ---------------------------------------------

    def shared_data(self, sender: int, receiver: int, auth: bool) -> SharedData:
        """A (valid) seed exchange from `sender` to `receiver`."""
        ic = InitialCommitment(
            hash=self.base_hashes[sender],
            settings=self.settings,
            base_pubkeys=list(self.vvs[sender]),
        )
        dest_id = self.sorted_hash_index(self.base_hashes[receiver]) + 1
        secret_scalar = self.poly_eval(sender, dest_id)
        secret = BlsSecretKey(secret_scalar).to_bytes()
        exchanged = ExchangedSecret(
            dst_base_hash=self.base_hashes[receiver], secret=BLSSecretRaw(secret)
        )
        sec = SeedExchangeCommitment(
            initial_commitment_hash=self.base_hashes[sender],
            shared_secret=exchanged,
            commitment=Commitment(
                pubkey=self.secp_keys[sender].to_public_key().to_bytes()
            ),
        )
        if auth:
            from ..reference.frozen.dkg.keys import BlsDkgWithSecp256kCommitment as Setup

            h = compute_seed_exchange_hash(Setup, sec)
            sec.commitment.hash = h
            sec.commitment.signature = self.secp_keys[sender].sign(bytes(h)).to_bytes()
        return SharedData(
            verification_hashes=list(self.base_hashes),
            initial_commitment=ic,
            seeds_exchange_commitment=sec,
        )

    def sorted_hash_index(self, h: SHA256Raw) -> int:
        return sorted(self.base_hashes).index(h)

    # -- fault injection ------------------------------------------------------

    def shared_data_bad_secret(self, sender: int, receiver: int, auth: bool) -> SharedData:
        """Slashable fault: the exchanged share does not lie on the sender's
        committed polynomial (readme.md fault class 1)."""
        data = self.shared_data(sender, receiver, auth)
        wrong = BlsSecretKey(
            (self.poly_eval(sender, self.id_of[receiver]) + 12345) % bls.R
        ).to_bytes()
        data.seeds_exchange_commitment.shared_secret.secret = BLSSecretRaw(wrong)
        if auth:
            from ..reference.frozen.dkg.keys import BlsDkgWithSecp256kCommitment as Setup

            sec = data.seeds_exchange_commitment
            h = compute_seed_exchange_hash(Setup, sec)
            sec.commitment.hash = h
            sec.commitment.signature = self.secp_keys[sender].sign(bytes(h)).to_bytes()
        return data

    def bad_partial_key_data(
        self, perp: int = 0, auth: bool = True, message: str = "dvt finalization"
    ):
        """Slashable fault for the bad-partial-key circuit: the perpetrator's
        partial keypair is SELF-CONSISTENT (the signature verifies under the
        claimed partial pubkey) but does not match the evaluation of the
        aggregated verification vectors at their id — so the guest reaches
        the expected-key mismatch (verification.rs:422-466) instead of
        slashing earlier at the signature check.  None of the reference's
        golden vectors exercises this path (they all break the signature),
        which is exactly the relation the G1 chip proves in-circuit."""
        from ..reference.frozen.dkg.types import BadPartialShare, BadPartialShareData, BadPartialShareGeneration

        wrong_share = (self.aggregate_share(self.id_of[perp]) + 777) % bls.R
        gens = [
            BadPartialShareGeneration(
                verification_vector=list(self.vvs[i]), base_hash=self.base_hashes[i]
            )
            for i in range(self.n)
        ]
        bad = BadPartialShare(
            settings=self.settings,
            data=Generation(
                verification_vector=list(self.vvs[perp]),
                base_hash=self.base_hashes[perp],
                partial_pubkey=_g1_compress(bls.g1_mul(bls.G1_GEN, wrong_share)),
                message_cleartext=message,
                message_signature=_bls_sign(wrong_share, message.encode()),
            ),
            commitment=Commitment(
                pubkey=self.secp_keys[perp].to_public_key().to_bytes()
            ),
        )
        data = BadPartialShareData(
            settings=self.settings, generations=gens, bad_partial=bad
        )
        if auth:
            from ..reference.frozen.dkg.verification import compute_partial_share_hash

            h = SHA256Raw(compute_partial_share_hash(self.settings, bad))
            bad.commitment.hash = h
            bad.commitment.signature = self.secp_keys[perp].sign(bytes(h)).to_bytes()
        return data

    def finalization_bad_aggregate(self, message: str = "dvt finalization") -> FinalizationData:
        data = self.finalization_data(message)
        data.aggregate_pubkey = _g1_compress(
            bls.g1_mul(bls.G1_GEN, (self.aggregate_share(0) + 1) % bls.R)
        )
        return data
