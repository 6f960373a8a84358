"""Proof pipeline: witness execution → public-values binding STARK.

Port of ``dvt_circuits_tpu/prover/pipeline.py`` (the prover side):
``execute_circuit`` runs the witness program on the host; ``prove_circuit``
assembles the tables exactly as the JAX package does (stream AIR header and
words, SHA-256 relation dedup, cap, sort and power-of-two padding) and
proves them on one transcript with the port's ``prove_tables``.  The
container format is the JAX package's (``PROOF_FORMAT`` v7), so the JAX
verifier reads the port's containers.

This slice carries the Poseidon2 stream table and the SHA-256 table.  The
G1 curve table and the ChaCha20 table are not ported yet: a witness that
records a G1 relation (unless ``DVT_G1=0`` opts out, counting the
relations in ``g1_omitted`` as the JAX package does) or a ChaCha20 decrypt
raises ``ProveError`` rather than emit a container that differs from the
JAX one.
"""

from __future__ import annotations

import hashlib
import os
import time

from ..circuits.guest_api import GuestResult, run_guest
from ..circuits.registry import CIRCUITS, get_circuit
from ..dkg.hash_recorder import chacha_recording, g1_recording, recording
from ..stark.config import DEFAULT_CONFIG, StarkConfig
from ..stark.fused import prove_tables
from ..stark.poseidon2_air import Poseidon2StreamAir, stream_to_words
from ..stark.sha256_air import Sha256Air, pad_message
from ..utils import cbor

PROOF_FORMAT = "dvt-circuits-tpu/stark-proof/v7"

#: gadget kind ids as absorbed into the stream-AIR header (_stream_words)
_GADGET_KIND_IDS = {"sha256": 1, "chacha20": 2, "g1": 3, "g1mul": 4}

#: cap on per-proof SHA-256 gadget tables (the count omitted is recorded
#: in the container, so the cap is never silent)
MAX_SHA_GADGETS = 64
MAX_SHA_BLOCKS = 512

#: ids over the sorted names of ALL circuits: the id is absorbed into the
#: transcript, so the registry must list the same four circuits
_CIRCUIT_IDS = {name: i + 1 for i, name in enumerate(sorted(CIRCUITS))}


class ProveError(RuntimeError):
    pass


def execute_circuit(
    circuit_name: str, data, auth: bool, setup: str = "secp-commitment"
) -> GuestResult:
    """CBOR-encode typed data and run the witness program (execute mode)."""
    spec = get_circuit(circuit_name, setup)
    payload = cbor.encode(data.to_json(auth))
    return run_guest(spec.guest, payload, auth)


def _stream_words(
    circuit_name: str,
    auth: bool,
    setup: str,
    stream: bytes,
    gadgets: list,
    omitted: tuple = (0, 0, 0),
) -> list:
    """Absorption stream: circuit-identity header + gadget-structure
    descriptor + byte stream as words (the descriptor commits the gadget
    set, so stripping a gadget table desynchronizes the stream digest)."""
    header = [
        _CIRCUIT_IDS[circuit_name],
        int(auth),
        int(setup == "bls-commitment"),
        len(stream),
        len(gadgets),
        int(omitted[0]),
        int(omitted[1]),
        int(omitted[2]) if len(omitted) > 2 else 0,
    ]
    for g in gadgets:
        bcs = [int(b) for b in g["block_counts"]]
        offs = [0 if o is None else int(o) + 1 for o in g["stream_offsets"]]
        extras = [int(x) for x in g.get("extras", [])]
        header += (
            [_GADGET_KIND_IDS[g["kind"]], len(bcs)]
            + bcs
            + offs
            + [len(extras)]
            + extras
        )
    return header + stream_to_words(stream)


def prove_circuit(
    circuit_name: str,
    data,
    auth: bool,
    config: StarkConfig = DEFAULT_CONFIG,
    setup: str = "secp-commitment",
    device="cuda",
) -> dict:
    """Execute the witness and produce the binding proof container."""
    t0 = time.time()
    with recording() as recorded_hashes, chacha_recording() as recorded_chacha, \
            g1_recording() as recorded_g1:
        result = execute_circuit(circuit_name, data, auth, setup)
    if result.exit_code != 0:
        raise ProveError(
            f"witness execution failed (guest panic): {result.panic_message}"
        )
    g1_omitted = 0
    if recorded_g1:
        if os.environ.get("DVT_G1", "1") != "0":
            raise ProveError(
                f"the witness recorded {len(recorded_g1)} G1 curve relation(s); the "
                "G1 scalar-mul table is not ported to the PyTorch prover yet "
                "(set DVT_G1=0 to omit the relations, counted in g1_omitted)"
            )
        g1_omitted = len(recorded_g1)
    if recorded_chacha:
        raise ProveError(
            "the witness recorded a ChaCha20 decrypt; the ChaCha20 table is not "
            "ported to the PyTorch prover yet"
        )

    # distinct SHA-256 relations the witness relied on, in first-use order
    seen: set = set()
    sha_relations = []
    for preimage, digest in recorded_hashes:
        if digest not in seen:
            seen.add(digest)
            sha_relations.append((preimage, digest))
    kept = []
    blocks_used = 0
    omitted = 0
    for preimage, digest in sha_relations:
        nb = len(pad_message(preimage)) // 64
        if len(kept) >= MAX_SHA_GADGETS or blocks_used + nb > MAX_SHA_BLOCKS:
            omitted += 1
        else:
            kept.append((preimage, digest))
            blocks_used += nb
    sha_relations = kept

    # ONE SHA-256 table carrying every recorded relation: messages sorted by
    # block count (stable), padded with 1-block dummies to a power of two
    gadgets = []
    gadget_entry = None
    if sha_relations:
        padded_msgs = []
        offsets = []
        for preimage, digest in sha_relations:
            padded_msgs.append(pad_message(preimage))
            # guests commit digests as hex text; bind where the digest appears
            off = result.public_values.find(digest.hex().encode("ascii"))
            offsets.append(off if off >= 0 else None)
        order = sorted(range(len(padded_msgs)), key=lambda i: -len(padded_msgs[i]))
        padded_msgs = [padded_msgs[i] for i in order]
        offsets = [offsets[i] for i in order]
        target = 1 << (len(padded_msgs) - 1).bit_length()
        while len(padded_msgs) < target:
            padded_msgs.append(pad_message(b""))
            offsets.append(None)
        block_counts = tuple(len(p) // 64 for p in padded_msgs)
        gadgets.append(
            {
                "kind": "sha256",
                "block_counts": list(block_counts),
                "stream_offsets": offsets,
                "proof": None,  # filled below
            }
        )
        g_air = Sha256Air(block_counts)
        gadget_entry = (g_air, *g_air.generate_trace(padded_msgs))

    # the absorbed words commit to the gadget structure (see _stream_words)
    words = _stream_words(
        circuit_name, auth, setup, result.public_values, gadgets, (omitted, 0, g1_omitted)
    )
    # pad the chunk count to a power of two, as the JAX package does
    num_chunks = max(1, -(-len(words) // 8))
    num_chunks = 1 << (num_chunks - 1).bit_length()
    air = Poseidon2StreamAir(num_chunks)
    trace, publics = air.generate_trace(words)
    witness_time = time.time() - t0

    t0 = time.time()
    entries = [(air, trace, publics)]
    if gadget_entry is not None:
        entries.append(gadget_entry)
    proofs = prove_tables(entries, config, device)
    for g, p in zip(gadgets, proofs[1:]):
        g["proof"] = p
    prove_time = time.time() - t0

    return {
        "format": PROOF_FORMAT,
        "circuit": circuit_name,
        "setup": setup,
        "auth": auth,
        "public_values": result.public_values.hex(),
        "commit_count": result.commit_count,
        "stark": proofs[0],
        "gadgets": gadgets,
        "gadgets_omitted": omitted,
        "chacha_omitted": 0,
        "g1_omitted": g1_omitted,
        "config": {
            "log_blowup": config.log_blowup,
            "num_queries": config.num_queries,
            "proof_of_work_bits": config.proof_of_work_bits,
            "log_final_poly_len": config.log_final_poly_len,
            "shift": config.shift,
        },
        "timing": {"witness_ms": int(witness_time * 1000), "prove_ms": int(prove_time * 1000)},
    }


def save_proof(container: dict, path: str) -> None:
    with open(path, "wb") as f:
        f.write(cbor.encode(container))


def load_proof(path: str) -> dict:
    with open(path, "rb") as f:
        return cbor.decode(f.read())


def container_digest(container: dict) -> str:
    """SHA-256 of a container's CBOR bytes without ``timing`` — equal for
    two provers that emit the same proof."""
    body = {k: v for k, v in container.items() if k != "timing"}
    return hashlib.sha256(cbor.encode(body)).hexdigest()
