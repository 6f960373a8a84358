"""Recording of SHA-256 invocations performed by witness programs.

The reference proves every commitment hash inside SP1 via its sha2
precompile chip (SURVEY.md §2.2); the TPU framework's equivalent is the
SHA-256 gadget AIR (stark/sha256_air.py).  This module is the seam between
the two: while a witness program runs under ``recording()``, every SHA-256
the DKG verification layer computes is captured as a (preimage, digest)
pair, and the prover pipeline turns the captured set into gadget STARK
proofs whose digests are bound to the committed public-value stream.

Recording is thread-local (witness programs are single-threaded by
construction, like the reference's zkVM guests; ``prove_batch`` shards
independent proofs over dp worker threads) and zero-cost when off.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import List, Optional, Tuple

import threading

#: recording state is THREAD-LOCAL: witness programs are single-threaded
#: (zkVM-style), but ``prove_batch`` runs independent proofs on dp worker
#: threads, each with its own recording context
_TLS = threading.local()


def _get(name):
    return getattr(_TLS, name, None)


def _set(name, value):
    setattr(_TLS, name, value)


def record(preimage: bytes, digest: bytes) -> None:
    """Called by the verification layer for every SHA-256 it computes."""
    records = _get("records")
    if records is not None:
        records.append((bytes(preimage), bytes(digest)))


def record_chacha(key: bytes, nonce: bytes, counter: int, data: bytes) -> None:
    """Called by the encrypted-share witness for every ChaCha20 decrypt
    (key, nonce, start counter, ciphertext) — the seam feeding the ChaCha20
    gadget AIR (stark/chacha20_air.py), like ``record`` feeds the SHA table."""
    chacha = _get("chacha")
    if chacha is not None:
        chacha.append((bytes(key), bytes(nonce), int(counter), bytes(data)))


def record_g1_poly_check(
    secret: bytes,
    dest_id: int,
    points: List[Optional[Tuple[int, int]]],
    commit_pubkey: Optional[bytes] = None,
    commit_sig: Optional[bytes] = None,
) -> None:
    """Called by ``verify_seed_exchange_commitment`` for the Feldman share
    check (verification.rs:107-118): pk(secret) ?= poly(dest_id) over the
    verification vector.  ``commit_pubkey``/``commit_sig`` (auth mode) are
    the ECDSA commitment credentials, committed so the verifier re-runs
    ``verify_commitment`` (verification.rs:365-374) on public data.  Feeds
    the G1 program chip (stark/g1_air.py) — the curve-relation analogue of
    ``record``/``record_chacha``."""
    g1 = _get("g1")
    if g1 is not None:
        g1.append(
            {
                "kind": "poly",
                "secret": bytes(secret),
                "dest_id": int(dest_id),
                "points": [None if p is None else (int(p[0]), int(p[1])) for p in points],
                "commit_pubkey": None if commit_pubkey is None else bytes(commit_pubkey),
                "commit_sig": None if commit_sig is None else bytes(commit_sig),
            }
        )


def record_g1_agg_check(
    vv_points: List[List[Optional[Tuple[int, int]]]],
    partial_points: List[Optional[Tuple[int, int]]],
    agg_point: Optional[Tuple[int, int]],
    sigs: Optional[List[bytes]] = None,
    cleartext: Optional[bytes] = None,
) -> None:
    """Called by ``verify_generations`` for the aggregation relations
    (verification.rs:262-331): ``vv_points`` are the SORTED generations'
    verification vectors (affine or None for identity/undecodable),
    ``partial_points`` the sorted partial pubkeys, ``agg_point`` the claimed
    aggregate key.  ``sigs``/``cleartext`` are the sorted generations' BLS
    message signatures and the (shared) cleartext — committed into the
    container so the VERIFIER re-runs every per-generation BLS verification
    from public data (zero witness trust).
    Feeds the tall G1 chip (stark/g1mul_air.py): Horner per id over the
    column sums + two Lagrange-at-0 reconstructions."""
    g1 = _get("g1")
    if g1 is not None:
        g1.append(
            {
                "kind": "agg",
                "vvs": [
                    [None if p is None else (int(p[0]), int(p[1])) for p in vv]
                    for vv in vv_points
                ],
                "partials": [
                    None if p is None else (int(p[0]), int(p[1]))
                    for p in partial_points
                ],
                "agg": None if agg_point is None else (int(agg_point[0]), int(agg_point[1])),
                "sigs": None if sigs is None else [bytes(s) for s in sigs],
                "cleartext": None if cleartext is None else bytes(cleartext),
            }
        )


def record_g1_partial_check(
    vv_points: List[List[Optional[Tuple[int, int]]]],
    perp_id: int,
    actual_key: Optional[Tuple[int, int]],
    msg_sig: Optional[bytes] = None,
    cleartext: Optional[bytes] = None,
    commit_pubkey: Optional[bytes] = None,
    commit_sig: Optional[bytes] = None,
) -> None:
    """Called by ``_verify_expected_key`` (verification.rs:422-466): the
    expected-key relation Horner(Σ_i C_i·, perp_id) vs the accused partial
    pubkey, over the SORTED generations' verification vectors.
    ``msg_sig``/``cleartext``: the perpetrator's BLS message signature and
    cleartext (the sig check at verification.rs:447 the witness performed);
    ``commit_pubkey``/``commit_sig``: the auth-mode ECDSA commitment
    credentials (verification.rs:468-496) — all committed so the verifier
    re-runs those checks from public data."""
    g1 = _get("g1")
    if g1 is not None:
        g1.append(
            {
                "kind": "partial",
                "vvs": [
                    [None if p is None else (int(p[0]), int(p[1])) for p in vv]
                    for vv in vv_points
                ],
                "perp_id": int(perp_id),
                "actual": None
                if actual_key is None
                else (int(actual_key[0]), int(actual_key[1])),
                "msg_sig": None if msg_sig is None else bytes(msg_sig),
                "cleartext": None if cleartext is None else bytes(cleartext),
                "commit_pubkey": None if commit_pubkey is None else bytes(commit_pubkey),
                "commit_sig": None if commit_sig is None else bytes(commit_sig),
            }
        )


@contextmanager
def g1_recording():
    """Capture G1 curve relations performed by the witness."""
    prev = _get("g1")
    cur = [] if prev is None else prev
    _set("g1", cur)
    try:
        yield cur
    finally:
        _set("g1", prev)


@contextmanager
def recording():
    """Capture all SHA-256 (preimage, digest) pairs computed in the block.

    Yields the live list; duplicates are preserved in call order (the
    pipeline dedupes).  Nested use shares the innermost list.
    """
    prev = _get("records")
    cur = [] if prev is None else prev
    _set("records", cur)
    try:
        yield cur
    finally:
        _set("records", prev)


@contextmanager
def chacha_recording():
    """Capture all ChaCha20 (key, nonce, counter, ciphertext) invocations."""
    prev = _get("chacha")
    cur = [] if prev is None else prev
    _set("chacha", cur)
    try:
        yield cur
    finally:
        _set("chacha", prev)
