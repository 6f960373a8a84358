"""The proof container's verifier and the witness program's entry.

Frozen copy of the port's ``prover/pipeline.py`` with its prover taken
out: ``execute_circuit`` runs the witness program on the host and
``verify_proof`` replays the container's transcript, verifies every table
and re-runs the SHA-256, curve and ChaCha20 bindings.  The legacy wide
``g1`` gadget kind, which no prover of the port emits, is refused as an
unknown kind.
"""

from __future__ import annotations

from typing import Optional

from ..circuits.guest_api import GuestResult, run_guest
from ..circuits.registry import CIRCUITS, get_circuit
from ..pcs.challenger import DuplexChallenger
from ..stark.chacha20_air import ChaCha20Air, init_from_publics
from ..stark.config import DEFAULT_CONFIG, StarkConfig
from ..stark.g1mul_air import G1MulAir
from ..stark.poseidon2_air import Poseidon2StreamAir, hash_stream_words, stream_to_words
from ..stark.sha256_air import Sha256Air, digest_from_publics
from ..stark.verifier import StarkError
from ..stark.verifier import verify as stark_verify
from ..utils import cbor
from . import curve_glue


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


#: most keystream blocks one ChaCha20 table carries (padded count included)
MAX_CHACHA_BLOCKS = 64


def verify_proof(
    container: dict,
    circuit_name: Optional[str] = None,
    strict: bool = False,
    device="cpu",
) -> VerifyResult:
    """Verify a proof container on ``device``; raises VerifyError on failure.

    Returns a truthy ``VerifyResult`` with the proof's binding level.  With
    ``strict=True``, a container whose curve relations were omitted
    (``g1_omitted != 0``), or a share-circuit container without any curve
    table, is rejected instead of flagged."""
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
        stark_verify(air, container["stark"], publics, config, challenger)
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
    stark_verify(g_air, entry["proof"], g_publics, config, challenger)
    for mi, off in enumerate(offsets):
        if off is None:
            continue
        off = int(off)
        digest_hex = digest_from_publics(g_air, g_publics, mi).hex().encode("ascii")
        if not 0 <= off <= len(stream) - 64 or stream[off : off + 64] != digest_hex:
            raise VerifyError("gadget digest not bound to the committed stream")
    return g_air, g_publics


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
    stark_verify(air, entry["proof"], publics, config, challenger)
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
    stark_verify(c_air, entry["proof"], c_publics, config, challenger)
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
