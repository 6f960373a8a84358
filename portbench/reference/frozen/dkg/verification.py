"""DKG fault-verification logic.

Re-creates crates/dkg/src/verification.rs with the exact error taxonomy and
behavioral conventions:

  * share ids are ``sorted-hash index + 1`` (verification.rs:50-66, :129)
  * generations are canonicalized by sorting on ``base_hash`` (:279-280)
  * ``SlashableError`` vs ``UnslashableError`` vs generic ``VerificationError``
    (the reference's plain ``io::Error``) — guests map these to exit semantics
  * undecodable points at ``expect`` call sites raise ``GuestPanic`` when run
    inside a guest (the witness runner converts any unexpected exception)

The ``auth_commitment`` cargo feature becomes the ``auth`` parameter.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

from ..utils.errors import InvalidPoint, SlashableError, UnslashableError, VerificationError
from . import hash_recorder
from .dkg_math import agg_coefficients, evaluate_polynomial, lagrange_interpolation
from .types import (
    BadPartialShare,
    BadPartialShareData,
    GenerateSettings,
    InitialCommitment,
    SHA256Raw,
    SeedExchangeCommitment,
    SharedData,
)


def _sha256(*parts: bytes) -> bytes:
    preimage = b"".join(parts)
    digest = hashlib.sha256(preimage).digest()
    hash_recorder.record(preimage, digest)
    return digest


def compute_seed_exchange_hash(setup, seed_exchange: SeedExchangeCommitment) -> SHA256Raw:
    """auth mode: SHA256(initial_commitment_hash ‖ secret_BE ‖ dst_base_hash)
    (verification.rs:30-48).  The secret is re-encoded through the scalar type
    so non-canonical encodings cannot alias."""
    shared_secret = seed_exchange.shared_secret
    sk = setup.DkgSecretKey.from_bytes(shared_secret.secret)
    return SHA256Raw(
        _sha256(
            bytes(seed_exchange.initial_commitment_hash),
            bytes(sk.to_bytes()),
            bytes(shared_secret.dst_base_hash),
        )
    )


def get_index_in_commitments(commitments: Sequence[SHA256Raw], destination_id: SHA256Raw) -> int:
    """Index of a hash in the *sorted* commitment list (verification.rs:50-66)."""
    for i, h in enumerate(sorted(commitments)):
        if h == destination_id:
            return i
    raise VerificationError("Could not find destination in commitments")


def verify_seed_exchange_commitment(
    setup,
    verification_hashes: Sequence[SHA256Raw],
    seed_exchange: SeedExchangeCommitment,
    initial_commitment: InitialCommitment,
    auth: bool,
) -> None:
    """verification.rs:68-149.  Raises Slashable/Unslashable on faults."""
    if auth:
        commitment = seed_exchange.commitment
        if not verify_commitment(setup, commitment):
            raise UnslashableError(
                "Invalid field seeds_exchange_commitment.commitment.signature "
                f"{commitment.signature.hex()}, message: {commitment.hash.hex()} "
                f"pubkey: {commitment.pubkey.hex()}"
            )

    shared_secret = seed_exchange.shared_secret
    try:
        sk = setup.DkgSecretKey.from_bytes(shared_secret.secret)
    except InvalidPoint as e:
        raise SlashableError(
            f"Invalid field seeds_exchange_commitment.shared_secret.secret: {e}"
        ) from None

    if auth:
        computed = compute_seed_exchange_hash(setup, seed_exchange)
        if computed != seed_exchange.commitment.hash:
            raise SlashableError(
                "Invalid field seeds_exchange_commitment.commitment.hash. "
                f"Expected: {seed_exchange.commitment.hash.hex()}, got hash: {computed.hex()}"
            )

    try:
        dest_index = get_index_in_commitments(
            verification_hashes, seed_exchange.shared_secret.dst_base_hash
        )
    except VerificationError as e:
        raise SlashableError(
            f"Invalid field seeds_exchange_commitment.shared_secret.dst_base_hash: {e}"
        ) from None

    # F(0) is reserved for the aggregated key, so ids start at 1 (verification.rs:128-130)
    dest_id = setup.Scalar.from_u32(dest_index + 1)

    # undecodable base pubkeys panic the guest (verification.rs:132-137 `expect`)
    cfst = [setup.Point.from_bytes(pk) for pk in initial_commitment.base_pubkeys]

    # the curve relation the G1 program chip proves in-circuit (g1_air.py);
    # auth mode also commits the ECDSA credentials so the proof verifier
    # re-runs verify_commitment from public data
    hash_recorder.record_g1_poly_check(
        bytes(shared_secret.secret),
        dest_index + 1,
        [getattr(c, "point", None) for c in cfst],
        commit_pubkey=bytes(seed_exchange.commitment.pubkey) if auth else None,
        commit_sig=bytes(seed_exchange.commitment.signature) if auth else None,
    )

    eval_result = evaluate_polynomial(cfst, dest_id, setup.Point)
    if bytes(sk.to_public_key().to_bytes()) != bytes(eval_result.to_bytes()):
        raise SlashableError(
            f"Bad secret field : Expected secret with public key: {eval_result.to_bytes().hex()},"
            f" got public key: {sk.to_public_key().to_bytes().hex()}"
        )


def compute_initial_commitment_hash(
    settings: GenerateSettings, base_pubkeys: Sequence[bytes]
) -> SHA256Raw:
    """SHA256(gen_id ‖ n ‖ k ‖ len ‖ pubkeys…) (verification.rs:151-175)."""
    return SHA256Raw(
        _sha256(
            bytes(settings.gen_id),
            bytes([settings.n]),
            bytes([settings.k]),
            bytes([len(base_pubkeys) & 0xFF]),
            *[bytes(pk) for pk in base_pubkeys],
        )
    )


def verify_initial_commitment_hash(commitment: InitialCommitment) -> bool:
    return (
        compute_initial_commitment_hash(commitment.settings, commitment.base_pubkeys)
        == commitment.hash
    )


def _compute_agg_key_from_dkg(setup, verification_vectors, ids):
    coefficients = agg_coefficients(verification_vectors, ids, setup.Point)
    return lagrange_interpolation(coefficients, ids)


def _batch_verify_mapping(setup, parsed, mapping) -> bool:
    """One pairing pair for all n (pk, sig) over the shared mapping when the
    target cryptography exposes raw curve points (BLS); False forces the
    caller's per-signature path (also the attribution fallback)."""
    from ..hostcrypto import bls12_381 as _b

    try:
        pks = [p.point for p, _ in parsed]
        sigs = [s.point for _, s in parsed]
        if not (isinstance(mapping, tuple) and len(mapping) == 2):
            return False
    except AttributeError:
        return False
    return _b.bls_batch_verify_precomputed_hash(pks, sigs, mapping)


def verify_generation_hashes(setup, generations: Sequence, settings: GenerateSettings) -> None:
    """verification.rs:211-260."""
    if len(generations) == 0:
        raise VerificationError("Invalid number of generations")
    for g in generations[1:]:
        if g.message_cleartext != generations[0].message_cleartext:
            raise VerificationError("Invalid message cleartext")

    # ONE hash-to-curve, reused for every generation (bls_keys.rs:215-217)
    mapping = setup.TargetCryptography.precompute_message_mapping(
        generations[0].message_cleartext.encode("utf-8")
    )

    # one batched pairing check for all n signatures (bilinearity over the
    # shared H — hostcrypto.bls_batch_verify_precomputed_hash); on failure,
    # fall back per-signature so the error names the offending generation
    # exactly as the reference does (verification.rs:236-243)
    parsed = []
    for generation in generations:
        parsed.append(
            (
                setup.DkgPubkey.from_bytes(generation.partial_pubkey),
                setup.DkgSignature.from_bytes(generation.message_signature),
            )
        )
    batched_ok = _batch_verify_mapping(setup, parsed, mapping)

    for generation, (key, signature) in zip(generations, parsed):
        if not batched_ok and not key.verify_signature_from_precomputed_mapping(
            mapping, signature
        ):
            raise UnslashableError(
                f"Invalid signature {generation.message_signature.hex()}"
            )

        initial_commitment = InitialCommitment(
            hash=generation.base_hash,
            settings=settings,
            base_pubkeys=list(generation.verification_vector),
        )
        if not verify_initial_commitment_hash(initial_commitment):
            raise UnslashableError(
                f"Invalid initial commitment hash {initial_commitment.hash.hex()}"
            )


def verify_generations(setup, generations: Sequence, settings: GenerateSettings, agg_key) -> None:
    """verification.rs:262-331.  Checks the aggregate key two independent
    ways: Lagrange over aggregated coefficients AND over partial pubkeys."""
    if len(generations) != settings.n:
        raise VerificationError("Invalid number of generations")

    verify_generation_hashes(setup, generations, settings)

    sorted_gens = sorted(generations, key=lambda g: bytes(g.base_hash))

    verification_vectors = [
        [setup.Point.from_bytes(pt) for pt in g.verification_vector] for g in sorted_gens
    ]
    ids = [setup.Scalar.from_u32(i + 1) for i in range(len(sorted_gens))]

    # the aggregation relations the G1 chip proves in-circuit (g1mul_air.py):
    # Horner over column-summed verification vectors at each id, plus the two
    # Lagrange-at-0 reconstructions (verification.rs:262-331)
    hash_recorder.record_g1_agg_check(
        [[getattr(p, "point", None) for p in vv] for vv in verification_vectors],
        [getattr(setup.Point.from_bytes(g.partial_pubkey), "point", None)
         for g in sorted_gens],
        getattr(agg_key, "point", None),
        sigs=[bytes(g.message_signature) for g in sorted_gens],
        cleartext=sorted_gens[0].message_cleartext.encode("utf-8"),
    )

    computed_key = _compute_agg_key_from_dkg(setup, verification_vectors, ids)
    if bytes(agg_key.to_bytes()) != bytes(computed_key.to_bytes()):
        raise VerificationError(
            f"Computed key {computed_key.to_bytes().hex()} does not match aggregate "
            f"public key {agg_key.to_bytes().hex()}"
        )

    partial_keys = [setup.Point.from_bytes(g.partial_pubkey) for g in sorted_gens]
    computed_key = lagrange_interpolation(partial_keys, ids)
    if bytes(computed_key.to_bytes()) != bytes(agg_key.to_bytes()):
        raise VerificationError(
            f"Computed key {computed_key.to_bytes().hex()} does not match aggregate "
            f"public key {agg_key.to_bytes().hex()}"
        )


def compute_partial_share_hash(settings: GenerateSettings, partial_share: BadPartialShare) -> bytes:
    """auth mode commitment preimage for a partial share (verification.rs:334-362)."""
    cleartext = partial_share.data.message_cleartext.encode("utf-8")
    return _sha256(
        bytes(settings.gen_id),
        bytes([settings.n]),
        bytes([settings.k]),
        bytes([len(partial_share.data.verification_vector) & 0xFF]),
        *[bytes(pk) for pk in partial_share.data.verification_vector],
        bytes(partial_share.data.base_hash),
        bytes(partial_share.data.partial_pubkey),
        bytes([len(cleartext) & 0xFF]),
        cleartext,
        bytes(partial_share.data.message_signature),
    )


def verify_commitment(setup, commitment) -> bool:
    """ECDSA/BLS check of the commitment signature over its hash
    (verification.rs:365-374).  Undecodable keys/signatures propagate as
    exceptions (reference panics), matching the `expect` call sites."""
    key = setup.CommitmentPubkey.from_bytes_safe(commitment.pubkey)
    signature = setup.CommitmentSignature.from_bytes(commitment.signature)
    return key.verify_signature(bytes(commitment.hash), signature)


def _verify_generation_base_hashes(setup, data: BadPartialShareData) -> None:
    for generation in data.generations:
        ic = InitialCommitment(
            hash=generation.base_hash,
            settings=data.settings,
            base_pubkeys=list(generation.verification_vector),
        )
        if not verify_initial_commitment_hash(ic):
            raise UnslashableError(
                f"Invalid generation base hash {generation.base_hash.hex()}"
            )


def _find_perpetrator_index(perpetrator_hash: SHA256Raw, sorted_generation: Sequence) -> int:
    """Last matching index wins (verification.rs:498-521)."""
    idx = None
    for i, generation in enumerate(sorted_generation):
        if generation.base_hash == perpetrator_hash:
            idx = i
    if idx is None:
        raise UnslashableError(
            f"Could not find perpetrator generation {perpetrator_hash.hex()}"
        )
    return idx


def _compute_pubkey_share(setup, sorted_gens: Sequence, perpetrator_id):
    verification_vectors = [
        [setup.Point.from_bytes(pt) for pt in g.verification_vector] for g in sorted_gens
    ]
    ids = [setup.Scalar.from_u32(i + 1) for i in range(len(sorted_gens))]
    computed_keys = agg_coefficients(verification_vectors, ids, setup.Point)
    expected_key = evaluate_polynomial(computed_keys, perpetrator_id, setup.Point)
    return setup.Point.from_bytes(expected_key.to_bytes())


def _verify_expected_key(
    setup, sorted_gens, perpetrator_index: int, key, sig_binding=None
) -> None:
    perpetrator_id = setup.Scalar.from_u32(perpetrator_index + 1)
    expected_key = _compute_pubkey_share(setup, sorted_gens, perpetrator_id)
    try:
        actual_key_point = setup.Point.from_bytes(key.to_bytes())
    except InvalidPoint:
        raise SlashableError("Invalid point") from None

    # the expected-key curve relation for the G1 chip (verification.rs:422-466);
    # sig_binding commits the already-witness-checked BLS/ECDSA credentials so
    # the proof verifier re-runs them from public data
    hash_recorder.record_g1_partial_check(
        [
            [
                getattr(setup.Point.from_bytes(pt), "point", None)
                for pt in g.verification_vector
            ]
            for g in sorted_gens
        ],
        perpetrator_index + 1,
        getattr(actual_key_point, "point", None),
        **(sig_binding or {}),
    )
    if expected_key != actual_key_point:
        raise SlashableError(
            f"Computed key {expected_key.to_bytes().hex()} does not match expected key "
            f"{key.to_bytes().hex()}"
        )


def _verify_commitment_signature(setup, data: BadPartialShareData) -> None:
    """auth mode (verification.rs:468-496)."""
    computed_hash = compute_partial_share_hash(data.settings, data.bad_partial)
    if computed_hash != bytes(data.bad_partial.commitment.hash):
        raise UnslashableError(
            f"Invalid commitment hash expect {data.bad_partial.commitment.hash.hex()}, "
            f"got {computed_hash.hex()}"
        )
    key = setup.CommitmentPubkey.from_bytes(data.bad_partial.commitment.pubkey)
    sig = setup.CommitmentSignature.from_bytes(data.bad_partial.commitment.signature)
    if not key.verify_signature(bytes(data.bad_partial.commitment.hash), sig):
        raise UnslashableError("Invalid commitment signature")


def prove_wrong_final_key_generation(setup, data: BadPartialShareData, auth: bool) -> None:
    """verification.rs:422-466.  Returning without raising means "cannot prove
    wrongdoing"; SlashableError carries the provable fault."""
    if auth:
        _verify_commitment_signature(setup, data)
    _verify_generation_base_hashes(setup, data)

    sorted_gens = sorted(data.generations, key=lambda g: bytes(g.base_hash))

    perpetrator_index = _find_perpetrator_index(data.bad_partial.data.base_hash, sorted_gens)

    try:
        key = setup.DkgPubkey.from_bytes_safe(data.bad_partial.data.partial_pubkey)
    except InvalidPoint as e:
        raise SlashableError(
            f"While uncompressing data.bad_partial.data.partial_pubkey {e}"
        ) from None

    try:
        sig = setup.DkgSignature.from_bytes_safe(data.bad_partial.data.message_signature)
    except InvalidPoint as e:
        raise SlashableError(
            f"While uncompressing data.bad_partial.data.message_signature {e}"
        ) from None

    if not key.verify_signature(data.bad_partial.data.message_cleartext.encode("utf-8"), sig):
        raise SlashableError("Invalid partial signature")

    sig_binding = {
        "msg_sig": bytes(data.bad_partial.data.message_signature),
        "cleartext": data.bad_partial.data.message_cleartext.encode("utf-8"),
    }
    if auth:
        sig_binding["commit_pubkey"] = bytes(data.bad_partial.commitment.pubkey)
        sig_binding["commit_sig"] = bytes(data.bad_partial.commitment.signature)
    _verify_expected_key(setup, sorted_gens, perpetrator_index, key, sig_binding)
