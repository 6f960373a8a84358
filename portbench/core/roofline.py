"""K1's least time, reckoned from a container's tables and its STARK
configuration, whatever implements the permutation.

The rates and the Poseidon2 work per permutation are the port's
``chip_smoke.py`` arithmetic (``_bound_ms``, ``k1_bound_ms``), copied here
so that later changes to the port cannot move the yardstick.  The count of
permutations follows the prover's algorithm: for each table, the leaf
sponge over every committed matrix (preprocessed, trace, quotient chunks,
the opened values' digest, each FRI layer), the tree's compressions, the
proof-of-work batches searched, and the transcript's duplexes.  Nothing is
read from kernel launches or kernel internals.
"""

from __future__ import annotations

#: H100 SXM device-memory rate (NVIDIA data sheet)
BYTES_PER_S = 3.35e12
#: 32-bit integer instruction rate: the data sheet's 67 TFLOP/s fp32 FMA
#: rate (an FMA counts 2) is 33.5e12 instructions per second
INT32_OPS_PER_S = 67e12 / 2
#: IMAD alone runs on the FMA pipe, at half that rate
IMAD_PER_S = INT32_OPS_PER_S / 2

#: Poseidon2 work per permutation as the algorithm defines it: 564 S-box
#: products (8 full rounds x 16 words x 4, 13 partial rounds x 4), each a
#: Montgomery product at 3 IMAD; 208 products by the internal diagonal
#: (13 rounds x 16), one instruction each; 1,084 additions: 9 external
#: layers x 60, 13 internal layers x 31 and 141 round constants
P2_SBOX_PRODUCTS = 8 * 16 * 4 + 13 * 4
P2_DIAG_PRODUCTS = 13 * 16
P2_ADDS = 9 * (4 * 8 + 12 + 16) + 13 * (15 + 16) + 8 * 16 + 13
P2_IMAD = 3 * P2_SBOX_PRODUCTS
P2_INSTR = P2_IMAD + P2_DIAG_PRODUCTS + P2_ADDS

RATE = 8  # words absorbed per leaf-sponge permutation
WIDTH = 16  # permutation state words
DIGEST = 8  # digest words
WORD = 8  # bytes of one int64 word on the card
EXT_D = 4  # degree of the extension field


def bound_ms(n: int, work, bytes_moved: int):
    """Least time for ``n`` items of ``work`` = (all integer instructions,
    IMAD) each that must move ``bytes_moved`` bytes: the larger of the
    bytes over the memory rate and the instructions over their issue
    rates.  Returns (ms, "operations" or "bytes")."""
    total, imad = work
    t_ops = n * max(total / INT32_OPS_PER_S, imad / IMAD_PER_S)
    t_bytes = bytes_moved / BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def k1_bound_ms(perms: int, bytes_moved: int):
    """K1's bound: ``perms`` permutations of the algorithm's own work."""
    return bound_ms(perms, (P2_INSTR, P2_IMAD), bytes_moved)


class _Transcript:
    """The duplex challenger's buffer logic, counting permutations."""

    def __init__(self) -> None:
        self.inputs = 0
        self.outputs = 0
        self.duplexes = 0

    def observe(self, count: int = 1) -> None:
        for _ in range(count):
            self.outputs = 0
            self.inputs += 1
            if self.inputs == RATE:
                self._duplex()

    def _duplex(self) -> None:
        self.inputs = 0
        self.outputs = RATE
        self.duplexes += 1

    def sample(self, count: int = 1) -> None:
        for _ in range(count):
            if self.inputs or not self.outputs:
                self._duplex()
            self.outputs -= 1


def _tree(rows: int, width: int):
    """(permutations, bytes) of one Merkle tree over a rows x width matrix."""
    blocks = -(-width // RATE)
    perms = rows * blocks + (rows - 1)
    moved = rows * width * WORD + (2 * rows - 1) * DIGEST * WORD + (rows - 1) * 2 * DIGEST * WORD
    return perms, moved


def _packed_words(blob) -> int:
    return len(blob) // 4 if isinstance(blob, (bytes, bytearray)) else len(blob)


def prove_work(container: dict) -> tuple:
    """(permutations, bytes) of K1's work in the prove of ``container``,
    from its tables' shapes and its STARK configuration."""
    cfg = container["config"]
    log_blowup = int(cfg["log_blowup"])
    blowup = 1 << log_blowup
    final_len = (1 << int(cfg["log_final_poly_len"])) * blowup
    bits = int(cfg["proof_of_work_bits"])
    queries = int(cfg["num_queries"])
    proofs = [container["stark"]] + [g["proof"] for g in container.get("gadgets", [])]
    transcript = _Transcript()
    perms = moved = 0
    for proof in proofs:
        log_n, width = int(proof["log_n"]), int(proof["width"])
        n_lde = 1 << (log_n + log_blowup)
        pre_width = _packed_words(proof.get("opened_p_zeta", b"")) // EXT_D
        q_width = EXT_D * blowup
        transcript.observe(2 + len(proof["public_values"]))
        widths = ([pre_width] if pre_width else []) + [width, q_width]
        for i, w in enumerate(widths):
            p, b = _tree(n_lde, w)
            perms, moved = perms + p, moved + b
            transcript.observe(DIGEST)
            if i >= len(widths) - 2:  # α after the trace, ζ after the quotient
                transcript.sample(EXT_D)
        opened = 2 * pre_width + 2 * width + q_width
        p, b = _tree(1 << max(0, opened - 1).bit_length(), EXT_D)
        perms, moved = perms + p, moved + b
        transcript.observe(DIGEST)
        transcript.sample(EXT_D)  # γ
        size = n_lde
        while size > final_len:
            p, b = _tree(size // 2, 2 * EXT_D)
            perms, moved = perms + p, moved + b
            transcript.observe(DIGEST)
            transcript.sample(EXT_D)  # β
            size //= 2
        transcript.observe(EXT_D * len(proof["fri"]["final_coeffs"]))
        batch = 1 << min(bits + 2, 16)
        candidates = (int(proof["fri"]["pow_witness"]) // batch + 1) * batch
        perms += candidates
        moved += candidates * WORD
        # the witness checked on a clone, then absorbed: two duplexes
        transcript.observe(1)
        transcript.sample(1)
        transcript.duplexes += 1
        transcript.sample(queries)
    perms += transcript.duplexes
    moved += transcript.duplexes * 2 * WIDTH * WORD
    return perms, moved
