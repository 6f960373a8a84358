"""Proof pipeline: witness execution → public-values binding STARK, and
its verifier.

Port of ``dvt_circuits_tpu/prover/pipeline.py``.  ``execute_circuit`` runs
the witness program on the host; ``prove_circuit`` assembles the tables
exactly as the JAX package does (stream AIR header and words, SHA-256
relation dedup, cap, sort and power-of-two padding, one G1 scalar-mul
table per distinct curve relation through ``curve_glue.build_gadget``, one
ChaCha20 keystream table for the recorded decrypts) and proves them on one
transcript with the port's ``prove_tables``.  ``verify_proof`` replays that
transcript, verifies every table and re-runs the SHA-256, curve and
ChaCha20 bindings.  The container format is the JAX package's
(``PROOF_FORMAT`` v7): each package verifies the other's containers.

The sharded path (``parallel/``, one process a card over
``torch.distributed``) is wired in where the JAX package wires its mesh in:
``prove_circuit`` shards every table over the world's ranks when a process
group with more than one rank is up (``DVT_DIST=auto``, the default;
``DVT_DIST=1`` shards over any initialized group and ``DVT_DIST=0`` proves
on one device; ``DVT_EP=1`` proves the tables on separate ranges of ranks),
and ``prove_batch(mesh=...)`` spreads a batch over the mesh's ``dp`` groups,
each container sharded over its ``sp`` ranks.  Every rank returns the same
container, equal to the single-device one.  The verifier also takes the
legacy wide ``g1`` gadget kind (``stark/g1_air.py:G1PolyAir``), which no v7
prover of either package emits.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

from ..circuits.guest_api import GuestResult, run_guest
from ..circuits.registry import CIRCUITS, get_circuit
from ..dkg.hash_recorder import chacha_recording, g1_recording, recording
from ..hostcrypto import bls12_381 as _bls
from ..pcs.challenger import DuplexChallenger
from ..stark.bigfield import NLIMBS, limbs_to_int
from ..stark.chacha20_air import ChaCha20Air, init_from_publics
from ..stark.config import DEFAULT_CONFIG, StarkConfig
from ..stark.fused import prove_tables
from ..stark.g1_air import G1PolyAir
from ..stark.g1mul_air import G1MulAir
from ..stark.poseidon2_air import Poseidon2StreamAir, hash_stream_words, stream_to_words
from ..stark.prover import prove as stark_prove
from ..stark.sha256_air import (Sha256Air, digest_from_publics, message_from_publics,
                                pad_message)
from ..stark.verifier import StarkError
from ..stark.verifier import verify as stark_verify
from ..utils import cbor, spans
from . import curve_glue

PROOF_FORMAT = "dvt-circuits-tpu/stark-proof/v7"

#: gadget kind ids as absorbed into the stream-AIR header (_stream_words)
_GADGET_KIND_IDS = {"sha256": 1, "chacha20": 2, "g1": 3, "g1mul": 4}

#: production G1 chip scalar widths (the reference's 256-bit secrets and
#: 32-bit ``bls_id_from_u32`` ids); pinned so a verifier reconstructs the
#: exact AIR from the container
_G1_SK_BITS, _G1_ID_BITS = 256, 32
_G1_MAX_K = 32

#: cap on per-proof SHA-256 gadget tables (the count omitted is recorded
#: in the container, so the cap is never silent)
MAX_SHA_GADGETS = 64
MAX_SHA_BLOCKS = 512

#: ids over the sorted names of ALL circuits: the id is absorbed into the
#: transcript, so the registry must list the same four circuits
_CIRCUIT_IDS = {name: i + 1 for i, name in enumerate(sorted(CIRCUITS))}


class ProveError(RuntimeError):
    pass


class VerifyError(RuntimeError):
    pass


class VerifyResult:
    """Outcome of ``verify_proof``: truthy on success, with the proof's
    binding level (``dvt_circuits_tpu/prover/pipeline.py:VerifyResult``):
    ``"curve-bound"`` (auth) or ``"curve-bound-noauth"`` when every recorded
    curve relation is proven in-circuit and anchored, ``"hash-bound"`` when
    none is carried; a ``+sig`` suffix when the verifier re-ran BLS/ECDSA
    signature checks itself (``sig_checks`` counts them)."""

    def __init__(
        self,
        circuit: str,
        binding: str,
        g1_relations: int,
        g1_omitted: int,
        sig_checks: int = 0,
    ):
        self.circuit = circuit
        self.binding = binding
        self.g1_relations = g1_relations
        self.g1_omitted = g1_omitted
        self.sig_checks = sig_checks

    def __bool__(self) -> bool:
        return True

    def __repr__(self) -> str:
        return (
            f"VerifyResult(circuit={self.circuit!r}, binding={self.binding!r}, "
            f"g1_relations={self.g1_relations}, g1_omitted={self.g1_omitted}, "
            f"sig_checks={self.sig_checks})"
        )


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


def _dist_prove_entries(entries, config: StarkConfig, mesh) -> list:
    """Prove a container's tables sharded over the mesh's ``sp`` ranks
    (``dvt_circuits_tpu/prover/pipeline.py:_dist_prove_entries``): a table
    whose LDE rows split over them with a block of at least ``blowup`` rows
    goes through ``dist_prove``; a smaller one through the single-device
    prover on the same challenger, on every rank.  ``DVT_EP=1`` proves the
    tables on separate ranges of ranks (``ep_prove_tables``).  The
    container's bytes are the single-device prover's either way."""
    from ..parallel.dist_stark import dist_prove, ep_prove_tables

    if os.environ.get("DVT_EP") == "1":
        return ep_prove_tables(entries, config, mesh)
    d = mesh.axis("sp").size
    challenger = DuplexChallenger(mesh.device)
    proofs = []
    for e_air, e_trace, e_publics in entries:
        n_lde = len(e_trace) << config.log_blowup
        if n_lde % d == 0 and n_lde // d >= config.blowup:
            proofs.append(dist_prove(e_air, e_trace, e_publics, config, mesh, "sp", challenger))
        else:
            proofs.append(stark_prove(e_air, e_trace, e_publics, config, challenger))
    return proofs


def _sharding_mesh(device):
    """The world mesh ``prove_circuit`` shards over, or None for one device
    (``DVT_DIST``: ``auto`` shards when a process group of more than one
    rank is up, ``1`` over any initialized group, ``0`` never)."""
    flag = os.environ.get("DVT_DIST", "auto")
    if flag not in ("1", "auto"):
        return None
    import torch.distributed as dist

    up = dist.is_available() and dist.is_initialized()
    if flag == "1" and not up:
        raise ProveError("DVT_DIST=1 needs an initialized torch.distributed process group")
    if not up or (flag == "auto" and dist.get_world_size() == 1):
        return None
    from ..parallel.mesh import world_mesh

    return world_mesh(device)


def prove_circuit(
    circuit_name: str,
    data,
    auth: bool,
    config: StarkConfig = DEFAULT_CONFIG,
    setup: str = "secp-commitment",
    device="cuda",
    mesh=None,
) -> dict:
    """Execute the witness and produce the binding proof container.

    With a ``mesh`` (``parallel.mesh.Mesh``), the tables are sharded over
    its ``sp`` ranks, which all call this with the same arguments; without
    one, ``DVT_DIST`` decides (``_sharding_mesh``).  The sharded container
    equals the single-device one on every rank (checked by its digest).
    ``timing`` holds the ``witness`` and ``tables`` spans' intervals in
    whole ms."""
    with spans.span("prove"):
        return _prove_circuit(circuit_name, data, auth, config, setup, device, mesh)


def _prove_circuit(circuit_name, data, auth, config, setup, device, mesh) -> dict:
    with spans.span("witness", timed=True) as witness:
        result, gadgets, entries, omitted, chacha_omitted, g1_omitted = _witness(
            circuit_name, data, auth, setup, device)
    with spans.span("tables", timed=True) as tables:
        if mesh is None:
            mesh = _sharding_mesh(device)
        if mesh is None:
            proofs = prove_tables(entries, config, device)
        else:
            proofs = _dist_prove_entries(entries, config, mesh)
        for g, p in zip(gadgets, proofs[1:]):
            g["proof"] = p

    container = {
        "format": PROOF_FORMAT,
        "circuit": circuit_name,
        "setup": setup,
        "auth": auth,
        "public_values": result.public_values.hex(),
        "commit_count": result.commit_count,
        "stark": proofs[0],
        "gadgets": gadgets,
        "gadgets_omitted": omitted,
        "chacha_omitted": chacha_omitted,
        "g1_omitted": g1_omitted,
        "config": {
            "log_blowup": config.log_blowup,
            "num_queries": config.num_queries,
            "proof_of_work_bits": config.proof_of_work_bits,
            "log_final_poly_len": config.log_final_poly_len,
            "shift": config.shift,
        },
        "timing": {"witness_ms": witness.ms, "prove_ms": tables.ms},
    }
    if mesh is not None:
        from ..parallel.comm import all_gather_object

        digests = all_gather_object(container_digest(container), mesh.axis("sp"))
        if len(set(digests)) != 1:
            raise ProveError(f"the ranks' sharded containers differ: {digests}")
    return container


def _witness(circuit_name: str, data, auth: bool, setup: str, device) -> tuple:
    """The witness program's run and the tables it asks for: (result,
    gadgets, table entries in proving order, SHA, ChaCha20 and G1 counts
    omitted).  The G1 tables' traces are assembled on ``device``."""
    with recording() as recorded_hashes, chacha_recording() as recorded_chacha, \
            g1_recording() as recorded_g1:
        with spans.span("witness.execute"):
            result = execute_circuit(circuit_name, data, auth, setup)
    if result.exit_code != 0:
        raise ProveError(
            f"witness execution failed (guest panic): {result.panic_message}"
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
    # block count (stable), padded with 1-block dummies to a power of two.
    # The originals and digests follow the same order: the G1 gadgets name
    # table entries by index (curve_glue.build_gadget).
    gadgets = []
    gadget_entry = None
    sha_digests: list = []
    sha_originals: list = []
    if sha_relations:
        padded_msgs = []
        offsets = []
        for preimage, digest in sha_relations:
            padded_msgs.append(pad_message(preimage))
            sha_originals.append(preimage)
            sha_digests.append(digest)
            # guests commit digests as hex text; bind where the digest appears
            off = result.public_values.find(digest.hex().encode("ascii"))
            offsets.append(off if off >= 0 else None)
        order = sorted(range(len(padded_msgs)), key=lambda i: -len(padded_msgs[i]))
        padded_msgs = [padded_msgs[i] for i in order]
        offsets = [offsets[i] for i in order]
        sha_digests = [sha_digests[i] for i in order]
        sha_originals = [sha_originals[i] for i in order]
        target = 1 << (len(padded_msgs) - 1).bit_length()
        while len(padded_msgs) < target:
            padded_msgs.append(pad_message(b""))
            offsets.append(None)
            sha_digests.append(hashlib.sha256(b"").digest())
            sha_originals.append(b"")
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

    # G1 scalar-mul tables, one per distinct recorded curve relation.  A
    # relation the chip cannot carry is counted in the absorbed
    # ``g1_omitted``, never dropped silently; DVT_G1=0 omits them all.
    g1_entries: list = []
    g1_omitted = 0
    if recorded_g1 and os.environ.get("DVT_G1", "1") == "0":
        g1_omitted = len(recorded_g1)
        recorded_g1 = []
    seen_g1: set = set()
    with spans.span("witness.g1"):
        for rel in recorded_g1:
            key = repr(sorted(rel.items(), key=lambda kv: kv[0]))
            if key in seen_g1:
                continue
            seen_g1.add(key)
            try:
                gadget, entry = curve_glue.build_gadget(
                    rel, sha_originals, sha_digests, result.public_values, auth, device
                )
            except (curve_glue.Unprovable, curve_glue.GlueError):
                g1_omitted += 1
                continue
            gadgets.append(gadget)
            g1_entries.append(entry)

    chacha_entry, chacha_omitted = _chacha_table(recorded_chacha, sha_digests,
                                                 result.public_values, gadgets)

    # the absorbed words commit to the gadget structure (see _stream_words)
    words = _stream_words(
        circuit_name, auth, setup, result.public_values, gadgets,
        (omitted, chacha_omitted, g1_omitted),
    )
    # pad the chunk count to a power of two, as the JAX package does
    num_chunks = max(1, -(-len(words) // 8))
    num_chunks = 1 << (num_chunks - 1).bit_length()
    air = Poseidon2StreamAir(num_chunks)
    trace, publics = air.generate_trace(words)

    entries = [(air, trace, publics)]
    if gadget_entry is not None:
        entries.append(gadget_entry)
    entries.extend(g1_entries)
    if chacha_entry is not None:
        entries.append(chacha_entry)
    return result, gadgets, entries, omitted, chacha_omitted, g1_omitted


#: most keystream blocks one ChaCha20 table carries (padded count included)
MAX_CHACHA_BLOCKS = 64


def _chacha_table(recorded: list, sha_digests: list, stream: bytes, gadgets: list):
    """The ChaCha20 keystream table of the recorded decrypts, as
    ``dvt_circuits_tpu/prover/pipeline.py`` builds it: one 21-row block
    group per 64-byte keystream block of each distinct invocation, padded to
    a power of two with zero-key blocks.  An invocation outside the
    verifier's derivation convention (empty ciphertext, counter not 0, nonce
    not key[:12], key not a digest of the SHA-256 table, or more than
    ``MAX_CHACHA_BLOCKS`` blocks in all) is counted, never dropped silently.
    Appends the gadget to ``gadgets``; returns (table entry or None, count
    omitted)."""
    invs = list(dict.fromkeys(recorded))  # distinct, in first-use order
    blocks: list = []
    inv_bcs: list = []
    inv_offs: list = []
    inv_extras: list = []
    omitted = 0
    for key, nonce, counter0, ct in invs:
        nb = max(1, -(-len(ct) // 64))
        if (not ct or counter0 != 0 or nonce != key[:12] or key not in sha_digests
                or len(blocks) + nb > MAX_CHACHA_BLOCKS):
            omitted += 1
            continue
        # guests commit the ciphertext as hex text, in either case
        off = stream.find(ct.hex().encode("ascii"))
        if off < 0:
            off = stream.find(ct.hex().upper().encode("ascii"))
        blocks += [(key, j, nonce) for j in range(nb)]
        inv_bcs.append(nb)
        inv_offs.append(off if off >= 0 else None)
        inv_extras += [len(ct), sha_digests.index(key)]
    if not blocks:
        return None, omitted
    blocks += [(bytes(32), 0, bytes(12))] * ((1 << (len(blocks) - 1).bit_length()) - len(blocks))
    gadgets.append({
        "kind": "chacha20",
        "block_counts": inv_bcs,
        "stream_offsets": inv_offs,
        "extras": [len(blocks)] + inv_extras,
        "proof": None,  # filled by prove_circuit
    })
    air = ChaCha20Air(len(blocks))
    return (air, *air.generate_trace(blocks)), omitted


def verify_proof(
    container: dict,
    circuit_name: Optional[str] = None,
    strict: bool = False,
    device="cuda",
) -> VerifyResult:
    """Verify a proof container on ``device``; raises VerifyError on failure.

    Returns a truthy ``VerifyResult`` with the proof's binding level.  With
    ``strict=True``, a container whose curve relations were omitted
    (``g1_omitted != 0``), or a share-circuit container without any curve
    table, is rejected instead of flagged."""
    with spans.span("verify"):
        return _verify_proof(container, circuit_name, strict, device)


def _verify_proof(container: dict, circuit_name: Optional[str], strict: bool,
                  device) -> VerifyResult:
    if container.get("format") != PROOF_FORMAT:
        raise VerifyError(f"unknown proof format {container.get('format')!r}")
    name = container.get("circuit")
    if name not in CIRCUITS:
        raise VerifyError(f"unknown circuit {name!r}")
    if circuit_name is not None and name != circuit_name:
        raise VerifyError(f"proof is for circuit {name!r}, expected {circuit_name!r}")
    auth = bool(container.get("auth"))
    setup = container.get("setup", "secp-commitment")
    if setup not in ("secp-commitment", "bls-commitment"):
        raise VerifyError(f"unknown setup {setup!r}")
    try:
        stream = bytes.fromhex(container["public_values"])
    except (KeyError, ValueError) as e:
        raise VerifyError(f"malformed public values: {e}") from None

    cfg = container.get("config", {})
    config = StarkConfig(
        log_blowup=int(cfg.get("log_blowup", DEFAULT_CONFIG.log_blowup)),
        num_queries=int(cfg.get("num_queries", DEFAULT_CONFIG.num_queries)),
        proof_of_work_bits=int(cfg.get("proof_of_work_bits", DEFAULT_CONFIG.proof_of_work_bits)),
        log_final_poly_len=int(cfg.get("log_final_poly_len", DEFAULT_CONFIG.log_final_poly_len)),
        shift=int(cfg.get("shift", DEFAULT_CONFIG.shift)),
    )
    if config.num_queries < 12 or config.log_blowup < 1:
        raise VerifyError("proof config below minimum security floor")

    gadgets_list = container.get("gadgets", [])
    try:
        # the absorbed words commit to the gadget structure, so a stripped
        # or altered gadget set desynchronizes the stream digest below
        words = _stream_words(
            name,
            auth,
            setup,
            stream,
            gadgets_list,
            (
                int(container.get("gadgets_omitted", 0)),
                int(container.get("chacha_omitted", 0)),
                int(container.get("g1_omitted", 0)),
            ),
        )
    except (KeyError, TypeError, ValueError) as e:
        raise VerifyError(f"malformed gadget descriptor: {e}") from None
    num_chunks = max(1, -(-len(words) // 8))
    num_chunks = 1 << (num_chunks - 1).bit_length()
    air = Poseidon2StreamAir(num_chunks)
    padded = [w % 2013265921 for w in words] + [0] * (8 * num_chunks - len(words))
    publics = padded + hash_stream_words(padded)

    challenger = DuplexChallenger(device)
    g1_relations = 0
    sig_checks = 0
    try:
        _stark_verify(air, container["stark"], publics, config, challenger)
        sha_ctx = None
        for entry in gadgets_list:
            kind = entry.get("kind")
            if kind == "sha256":
                sha_ctx = _verify_sha_gadget(entry, stream, config, challenger)
            elif kind == "g1mul":
                sig_checks += _verify_g1mul_gadget(
                    entry, stream, sha_ctx, config, challenger, auth, name
                )
                g1_relations += 1
            elif kind == "chacha20":
                _verify_chacha_gadget(entry, stream, sha_ctx, config, challenger)
            elif kind == "g1":
                _verify_g1_gadget(entry, stream, sha_ctx, config, challenger, auth)
                g1_relations += 1
            else:
                raise VerifyError(f"unknown gadget kind {kind!r}")
    except StarkError as e:
        raise VerifyError(f"STARK verification failed: {e}") from None
    except (KeyError, TypeError, ValueError) as e:
        raise VerifyError(f"malformed proof: {e}") from None

    g1_omitted = int(container.get("g1_omitted", 0))
    if g1_relations and g1_omitted == 0:
        binding = "curve-bound" if auth else "curve-bound-noauth"
        if sig_checks:
            binding += "+sig"
    else:
        binding = "hash-bound"
    if strict:
        if g1_omitted:
            raise VerifyError(f"strict: {g1_omitted} curve relation(s) omitted from the proof")
        if name in ("bad-share", "finalization", "bad-partial-key") and g1_relations == 0:
            # every accepting run of these circuits reaches its curve check;
            # strict callers asked for in-circuit curve evidence
            raise VerifyError("strict: proof carries no curve-relation table")
    return VerifyResult(name, binding, g1_relations, g1_omitted, sig_checks)


def _stark_verify(air, proof: dict, publics, config: StarkConfig,
                  challenger: DuplexChallenger) -> None:
    """One table's STARK on the chained transcript, as span ``verify.stark``."""
    with spans.span("verify.stark"):
        stark_verify(air, proof, publics, config, challenger)


def _verify_sha_gadget(entry: dict, stream: bytes, config: StarkConfig,
                       challenger: DuplexChallenger):
    """Verify the multi-message SHA-256 table and its stream bindings
    (each digest with a stream offset must appear there as hex text).
    Returns (air, publics) for the gadgets that bind to its digests."""
    block_counts = [int(v) for v in entry["block_counts"]]
    offsets = entry.get("stream_offsets", [])
    if not 1 <= len(block_counts) <= MAX_SHA_GADGETS or len(offsets) != len(block_counts):
        raise VerifyError("gadget message count out of range")
    if any(not 1 <= b <= 64 for b in block_counts) or sum(block_counts) > MAX_SHA_BLOCKS:
        raise VerifyError("gadget block count out of range")
    g_air = Sha256Air(tuple(block_counts))
    g_publics = [int(v) for v in entry["proof"]["public_values"]]
    try:
        g_air.check_publics(g_publics)
    except ValueError as e:
        raise VerifyError(f"gadget publics: {e}") from None
    _stark_verify(g_air, entry["proof"], g_publics, config, challenger)
    for mi, off in enumerate(offsets):
        if off is None:
            continue
        off = int(off)
        digest_hex = digest_from_publics(g_air, g_publics, mi).hex().encode("ascii")
        if not 0 <= off <= len(stream) - 64 or stream[off : off + 64] != digest_hex:
            raise VerifyError("gadget digest not bound to the committed stream")
    return g_air, g_publics


def _g1_air(k: int) -> G1PolyAir:
    return G1PolyAir(k, sk_bits=_G1_SK_BITS, id_bits=_G1_ID_BITS)


def _parse_init_commitment(msg: bytes, pts) -> Optional[list]:
    """Parse an initial-commitment SHA preimage (gen_id(16) ‖ n(1) ‖ k(1) ‖
    len(1) ‖ len × compressed pubkeys) and return the decompressed affine
    points iff they exactly match ``pts``."""
    k = len(pts)
    if len(msg) != 19 + 48 * k or msg[18] != k:
        return None
    out = []
    for j in range(k):
        try:
            pt = _bls.g1_from_compressed(msg[19 + 48 * j : 19 + 48 * (j + 1)])
        except _bls.InvalidPoint:
            return None
        if pt is None or (int(pt[0]), int(pt[1])) != (int(pts[j][0]), int(pts[j][1])):
            return None
        out.append(pt)
    return out


def _stream_frames(stream: bytes) -> list:
    """Split a committed public-values stream into its length-prefixed
    frames (``guest_api.GuestContext.commit`` framing)."""
    frames = []
    off = 0
    while off < len(stream):
        if off + 8 > len(stream):
            raise ValueError("truncated stream frame header")
        ln = int.from_bytes(stream[off : off + 8], "little")
        off += 8
        if off + ln > len(stream):
            raise ValueError("truncated stream frame")
        frames.append(stream[off : off + ln])
        off += ln
    return frames


def _verify_g1_gadget(entry: dict, stream: bytes, sha_ctx, config: StarkConfig,
                      challenger: DuplexChallenger, auth: bool) -> None:
    """Verify the legacy wide G1 curve-relation table (``G1PolyAir``) and
    its bindings (``dvt_circuits_tpu/prover/pipeline.py:_verify_g1_gadget``,
    check for check, with its messages): the extras, widths and ``k``;
    ``check_publics``, then the STARK; the C_j bound to the SHA-proven
    initial-commitment preimage, whose digest must be among the stream's
    committed hashes; in auth mode the secret bound to the seed-exchange
    preimage [32:64], the hash chain (its [0:32] is the initial-commitment
    digest) and id = the sorted index of its [64:96] among the committed
    hashes + 1; in no-auth mode the id inside the committee; and the two
    results must differ (a proof exists only for the slashable mismatch)."""
    extras = [int(v) for v in entry.get("extras", [])]
    if len(extras) != 5:
        raise VerifyError("g1 extras malformed")
    k, sk_bits, id_bits, seed_ref, init_ref = extras
    if sk_bits != _G1_SK_BITS or id_bits != _G1_ID_BITS:
        raise VerifyError("g1 chip scalar widths not the production widths")
    if not 2 <= k <= _G1_MAX_K:
        raise VerifyError("g1 chip k out of range")
    if [int(v) for v in entry.get("block_counts", [])] != [k]:
        raise VerifyError("g1 descriptor inconsistent")
    air = _g1_air(k)
    publics = [int(v) for v in entry["proof"]["public_values"]]
    try:
        air.check_publics(publics)
    except ValueError as e:
        raise VerifyError(f"g1 publics: {e}") from None
    _stark_verify(air, entry["proof"], publics, config, challenger)

    if sha_ctx is None:
        raise VerifyError("g1 gadget requires the SHA-256 table")
    sha_air, sha_publics = sha_ctx
    sk = bytes(publics[: air.sk_bytes])
    id_int = int.from_bytes(bytes(publics[air.sk_bytes : air.c_base]), "big")
    c_pts = []
    for j in range(k):
        base = air.c_base + 2 * NLIMBS * j
        c_pts.append((limbs_to_int(publics[base : base + NLIMBS]),
                      limbs_to_int(publics[base + NLIMBS : base + 2 * NLIMBS])))

    # C_j binding via the initial-commitment preimage
    if not 1 <= init_ref <= sha_air.num_messages:
        raise VerifyError("g1 gadget lacks an initial-commitment binding")
    try:
        init_msg = message_from_publics(sha_air, sha_publics, init_ref - 1)
    except ValueError as e:
        raise VerifyError(f"g1 init preimage: {e}") from None
    if _parse_init_commitment(init_msg, c_pts) is None:
        raise VerifyError("g1 C_j not bound to the committed initial-commitment preimage")

    # the initial-commitment digest must itself be anchored in the committed
    # stream (the guest asserts it is among the verification hashes before
    # any curve math), or init_ref could name an unanchored table entry
    try:
        frames = _stream_frames(stream)
    except ValueError as e:
        raise VerifyError(f"malformed stream: {e}") from None
    hashes = []
    for fr in frames[:-1]:  # last frame = perpetrator pubkey
        try:
            hashes.append(bytes.fromhex(fr.decode("ascii")))
        except (UnicodeDecodeError, ValueError):
            raise VerifyError("malformed verification-hash frame") from None
    init_digest = hashlib.sha256(init_msg).digest()
    if init_digest not in hashes:
        raise VerifyError("g1 initial-commitment digest not among the committed hashes")

    if auth:
        if not 1 <= seed_ref <= sha_air.num_messages:
            raise VerifyError("g1 gadget lacks a seed-exchange binding (auth)")
        try:
            seed_msg = message_from_publics(sha_air, sha_publics, seed_ref - 1)
        except ValueError as e:
            raise VerifyError(f"g1 seed preimage: {e}") from None
        if len(seed_msg) != 96:
            raise VerifyError("g1 seed preimage has the wrong shape")
        if seed_msg[32:64] != sk:
            raise VerifyError("g1 secret not bound to the seed-exchange preimage")
        if init_digest != seed_msg[0:32]:
            raise VerifyError("g1 hash chain broken (init digest vs seed preimage)")
        # id = sorted-index+1 of dst_base_hash among the committed hashes
        try:
            idx = sorted(hashes).index(seed_msg[64:96])
        except ValueError:
            raise VerifyError("dst_base_hash not among committed hashes") from None
        if id_int != idx + 1:
            raise VerifyError("g1 id not bound to the sorted-hash index")
    elif not 1 <= id_int <= len(hashes):
        # no_auth: the secret has no hash anchor in the reference's data
        # flow; the id must still be a sorted-index + 1 into the committee
        raise VerifyError("g1 id outside the committed committee range")

    out_a, out_b = air.out_points(publics)
    if out_a == out_b:
        raise VerifyError("g1 relation shows a VALID share — no slashable fault to prove")


def _verify_g1mul_gadget(entry: dict, stream: bytes, sha_ctx, config: StarkConfig,
                         challenger: DuplexChallenger, auth: bool, circuit_name: str) -> int:
    """Verify a G1 scalar-mul table: its STARK, then ``curve_glue``
    re-derives the DKG statement on the host and checks every chip public
    against it.  Returns the signature checks re-run from committed data."""
    chain_bits = tuple(int(v) for v in entry.get("block_counts", []))
    # the table-height cap below bounds the count (a chain is at least 58
    # rows); the reference's cap of 64 chains rejects the finalization of
    # committees with n·(k + 1) > 64, e.g. 7-of-10 (80 chains), that its
    # prover proves
    if not chain_bits:
        raise VerifyError("g1mul chain count out of range")
    if any(not 8 <= b <= 256 or b % 8 for b in chain_bits):
        raise VerifyError("g1mul chain width out of range")
    if sum(b * 7 + 2 for b in chain_bits) > curve_glue.MAX_CHAIN_ROWS:
        raise VerifyError("g1mul table too tall")
    air = G1MulAir(chain_bits)
    publics = [int(v) for v in entry["proof"]["public_values"]]
    try:
        air.check_publics(publics)
    except ValueError as e:
        raise VerifyError(f"g1mul publics: {e}") from None
    _stark_verify(air, entry["proof"], publics, config, challenger)
    try:
        _, sig_checks = curve_glue.verify_gadget_glue(
            air, publics, [int(v) for v in entry.get("extras", [])], stream, sha_ctx, auth,
            circuit_name,
        )
    except curve_glue.GlueError as e:
        raise VerifyError(f"g1mul binding: {e}") from None
    return sig_checks


def _verify_chacha_gadget(entry: dict, stream: bytes, sha_ctx, config: StarkConfig,
                          challenger: DuplexChallenger) -> None:
    """Verify the ChaCha20 keystream table and its bindings.  Per invocation:
    counters run 0..nb-1 under one key and nonce; the key is the SHA-256
    table's digest of the compressed ECDH point and the nonce its first 12
    bytes (the reference guest's derivation); the ciphertext at the
    descriptor's stream offset is hex text of the claimed length, so
    plaintext = ciphertext XOR keystream is recomputable."""
    bcs = [int(v) for v in entry["block_counts"]]
    offsets = entry.get("stream_offsets", [])
    extras = [int(v) for v in entry.get("extras", [])]
    if not 1 <= len(bcs) <= 16 or len(offsets) != len(bcs):
        raise VerifyError("chacha invocation count out of range")
    if any(not 1 <= b <= 16 for b in bcs):
        raise VerifyError("chacha block count out of range")
    if len(extras) != 1 + 2 * len(bcs):
        raise VerifyError("chacha extras malformed")
    total_blocks = extras[0]
    if not sum(bcs) <= total_blocks <= MAX_CHACHA_BLOCKS:
        raise VerifyError("chacha total block count out of range")
    c_air = ChaCha20Air(total_blocks)
    c_publics = [int(v) for v in entry["proof"]["public_values"]]
    try:
        c_air.check_publics(c_publics)
    except ValueError as e:
        raise VerifyError(f"chacha publics: {e}") from None
    _stark_verify(c_air, entry["proof"], c_publics, config, challenger)
    gb = 0
    for i, nb in enumerate(bcs):
        ct_len, key_msg = extras[1 + 2 * i], extras[2 + 2 * i]
        key0, ctr0, nonce0 = init_from_publics(c_publics, gb)
        if ctr0 != 0 or nonce0 != key0[:12]:
            raise VerifyError("chacha init violates the key-derivation convention")
        for j in range(1, nb):
            if init_from_publics(c_publics, gb + j) != (key0, j, nonce0):
                raise VerifyError("chacha keystream blocks are not consecutive")
        if sha_ctx is None:
            raise VerifyError("chacha gadget requires the SHA-256 table")
        sha_air, sha_publics = sha_ctx
        if not 0 <= key_msg < sha_air.num_messages:
            raise VerifyError("chacha key message index out of range")
        if digest_from_publics(sha_air, sha_publics, key_msg) != key0:
            raise VerifyError("chacha key not bound to the ECDH digest")
        if not 1 <= ct_len <= 64 * nb or -(-ct_len // 64) != nb:
            raise VerifyError("chacha ciphertext length inconsistent with blocks")
        off = offsets[i]
        if off is not None:
            off = int(off)
            if not 0 <= off <= len(stream) - 2 * ct_len:
                raise VerifyError("chacha ciphertext offset out of range")
            try:
                bytes.fromhex(stream[off : off + 2 * ct_len].decode("ascii"))
            except (UnicodeDecodeError, ValueError):
                raise VerifyError("chacha ciphertext not bound to the committed stream") from None
        gb += nb


def prove_batch(
    circuit_name: str,
    datas,
    auth: bool,
    config: StarkConfig = DEFAULT_CONFIG,
    setup: str = "secp-commitment",
    device="cuda",
    mesh=None,
) -> list:
    """Prove a batch of independent scenarios, one container each, equal to
    ``prove_circuit``'s one by one.

    Without a ``mesh``, on one device.  With one (every rank calls this
    with the same arguments), the batch is spread over the mesh's ``dp``
    groups: group i proves ``datas[i::dp]``, each container sharded over
    the group's ``sp`` ranks; the containers are then all-gathered, so every
    rank returns the whole list in input order
    (``dvt_circuits_tpu/prover/pipeline.py:prove_batch``)."""
    datas = list(datas)
    if mesh is None:
        return [prove_circuit(circuit_name, d, auth, config, setup, device) for d in datas]
    from ..parallel.comm import all_gather_object

    dp = mesh.axis("dp")
    mine = [prove_circuit(circuit_name, d, auth, config, setup, mesh.device, mesh=mesh)
            for d in datas[dp.index :: dp.size]]
    groups = all_gather_object(mine, dp)
    return [groups[i % dp.size][i // dp.size] for i in range(len(datas))]


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
