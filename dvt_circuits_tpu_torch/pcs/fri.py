"""FRI low-degree proof over BB4 codewords.

Port of ``dvt_circuits_tpu/pcs/fri.py`` (``fri_prove`` with the inline fold
of ``stark/fused.py``, and ``fri_verify``).  The codeword lives on a coset s·K in natural order;
each round commits leaf pairs (v[i], v[i+N/2]) as an (N/2, 8) Merkle
matrix, then folds with a BB4 challenge β:

    v'(x²) = (v(x) + v(−x))/2 + β · (v(x) − v(−x))/(2x)

The final codeword is sent as coefficients (coset iNTT, unscale,
truncate); then the proof-of-work grind and the query openings.
``fri_prove`` states the protocol once; a layout (``OneCardFri``, or the
sharded prover's row blocks) builds each round's tree and hands it the
rows to fold.  The verifier walks every query's fold chain at once, as
(nq, 4) tensors on the challenger's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..field import babybear as bb
from ..field import ext
from ..ntt import intt
from ..utils import spans
from ..utils.packing import pack_u32, unpack_rows
from .challenger import DuplexChallenger
from .merkle import MerkleTree, verify_openings_batch

P = bb.P
_HALF = (P + 1) // 2  # 1/2


@dataclass(frozen=True)
class FriConfig:
    log_blowup: int = 2
    num_queries: int = 50
    proof_of_work_bits: int = 16
    log_final_poly_len: int = 3

    @property
    def blowup(self) -> int:
        return 1 << self.log_blowup


@lru_cache(maxsize=None)
def _inv2x_table(shift: int, log_n: int, device: torch.device) -> torch.Tensor:
    """1/(2x_j) for x_j = shift·ω^j, j < N/2."""
    half = 1 << (log_n - 1)
    two_x = bb.powers(bb.two_adic_generator(log_n), half, device, start=2 * shift)
    return bb.inv(two_x)


def fold(v0: torch.Tensor, v1: torch.Tensor, beta, inv2x: torch.Tensor) -> torch.Tensor:
    """One fold round on (rows, 4) values v(x), v(−x) and 1/(2x) at the same
    rows → v'(x²)."""
    even = ext.add(v0, v1) * _HALF % P
    odd = ext.mul_base(ext.sub(v0, v1), inv2x)
    return ext.add(even, ext.mul(ext.tensor(beta, v0.device), odd))


class OneCardFri:
    """``fri_prove``'s layout of the codeword: whole on one device.  A
    layout says where the codeword's rows live: ``blocks`` (how many row
    blocks make the codeword), ``fri_round`` (round r's pair-leaf tree, the
    v(x) and v(−x) rows this rank folds, and the first of their rows in the
    round's half) and ``fri_last`` (the whole codeword after the rounds)."""

    blocks = 1

    def fri_round(self, codeword: torch.Tensor, r: int):
        """The (N/2, 8) leaf matrix [v[i] ‖ v[i+N/2]] committed."""
        half = codeword.shape[0] // 2
        v0, v1 = codeword[:half], codeword[half:]
        return MerkleTree(torch.cat([v0, v1], dim=1)), v0, v1, 0

    def fri_last(self, codeword: torch.Tensor, size: int, r: int) -> torch.Tensor:
        return codeword


def final_coefficients(codeword: torch.Tensor, shift: int, log_blowup: int) -> list:
    """Coset iNTT of the last codeword, unscaled by shift⁻ⁱ and truncated
    to len/blowup coefficients (the rest must be zero)."""
    n = codeword.shape[0]
    coeffs = intt(codeword)
    unscale = bb.powers(bb.s_inv(shift), n, codeword.device)
    coeffs = ext.mul_base(coeffs, unscale)
    spans.host_read(coeffs)
    coeffs = coeffs.cpu().numpy()
    keep = n >> log_blowup
    if np.any(coeffs[keep:]):
        raise AssertionError("final codeword exceeds degree bound — prover bug")
    return [tuple(int(x) for x in c) for c in coeffs[:keep]]


def fri_prove(codeword: torch.Tensor, shift: int, config: FriConfig,
              challenger: DuplexChallenger, layout=None) -> dict:
    """Commit-fold an (N, 4) BB4 codeword; returns the proof dict in the
    JAX package's format.  ``shift`` is the coset shift of its domain;
    ``layout`` (default ``OneCardFri``) where its rows live: a sharded one
    passes this rank's row block."""
    layout = layout or OneCardFri()
    n = codeword.shape[0] * layout.blocks
    log_n = n.bit_length() - 1
    assert 1 << log_n == n
    final_len = (1 << config.log_final_poly_len) * config.blowup

    rounds = []  # (tree, leaves) a round
    roots = []
    shift_r = shift % P
    size = n
    while size > final_len:
        tree, v0, v1, lo = layout.fri_round(codeword, len(rounds))
        rounds.append((tree, size // 2))
        roots.append(tree.root)
        challenger.observe_many(tree.root)
        beta = challenger.sample_ext()
        inv2x = _inv2x_table(shift_r, size.bit_length() - 1, codeword.device)
        codeword = fold(v0, v1, beta, inv2x[lo : lo + v0.shape[0]])
        del v0, v1
        shift_r = shift_r * shift_r % P
        size //= 2

    codeword = layout.fri_last(codeword, size, len(rounds))
    final_coeffs = final_coefficients(codeword, shift_r, config.log_blowup)
    for c in final_coeffs:
        challenger.observe_ext(c)

    pow_witness = challenger.grind(config.proof_of_work_bits)

    # every query index first (opening draws nothing from the transcript),
    # then one batched opening a round tree
    leaf_indices = [challenger.sample_bits(log_n - 1) for _ in range(config.num_queries)]
    idx = leaf_indices
    opened = []
    for tree, leaves in rounds:
        idx = [i % leaves for i in idx]  # i_{r+1} = i_r mod N_r/2
        rows, paths = tree.open_many(idx)
        opened.append([{"leaf": pack_u32(r), "path": pack_u32(p)} for r, p in zip(rows, paths)])
    queries = [{"index": li, "rounds": [rnd[k] for rnd in opened]}
               for k, li in enumerate(leaf_indices)]

    return {
        "roots": roots,
        "final_coeffs": [list(c) for c in final_coeffs],
        "pow_witness": pow_witness,
        "queries": queries,
        "log_n": log_n,
    }


# ---------------------------------------------------------------------------
# Verifier
# ---------------------------------------------------------------------------


class FriError(ValueError):
    pass


def field_rows(values, shape, err: str, device) -> torch.Tensor:
    """Packed blobs or int lists → an int64 tensor of ``shape`` on
    ``device``; raises FriError unless every value is in [0, p)."""
    try:
        arr = unpack_rows(values, shape, err)
    except ValueError:
        raise FriError(err) from None
    if arr.shape != shape or np.any(arr >= np.uint64(P)):
        raise FriError(err)
    return torch.as_tensor(arr.astype(np.int64), device=device)


def coset_points(shift: int, log_n: int, indices, device) -> torch.Tensor:
    """shift·ω^i for each index i, ω the order-2^log_n generator."""
    w = bb.two_adic_generator(log_n)
    return torch.tensor([shift * pow(w, int(i), P) % P for i in indices],
                        dtype=torch.int64, device=device)


def fri_verify(proof: dict, shift: int, log_n: int, config: FriConfig,
               challenger: DuplexChallenger, open_input_batch) -> bool:
    """Verify a FRI proof, all queries at once.

    ``open_input_batch(indices, v0s, v1s)`` is called once with the opened
    round-0 pairs of every query (a list of nq indices and two (nq, 4)
    tensors); the caller (the STARK verifier) raises unless they match its
    outer openings, which binds the codeword to the committed columns."""
    dev = challenger.device
    if proof.get("log_n") != log_n:
        raise FriError("wrong codeword size")
    final_len = (1 << config.log_final_poly_len) * config.blowup
    n_rounds = 0
    betas = []
    shifts = [shift % P]
    size = 1 << log_n
    while size > final_len:
        n_rounds += 1
        size //= 2
        shifts.append(shifts[-1] * shifts[-1] % P)
    if len(proof["roots"]) != n_rounds:
        raise FriError("wrong number of FRI rounds")
    for root in proof["roots"]:
        if len(root) != 8:
            raise FriError("malformed root")
        challenger.observe_many(root)
        betas.append(challenger.sample_ext())

    final_coeffs = [tuple(int(x) % P for x in c) for c in proof["final_coeffs"]]
    if len(final_coeffs) != (final_len >> config.log_blowup):
        raise FriError("wrong final polynomial length")
    for c in final_coeffs:
        challenger.observe_ext(c)

    if not challenger.check_witness(config.proof_of_work_bits, int(proof["pow_witness"])):
        raise FriError("proof-of-work check failed")

    nq = config.num_queries
    queries = proof["queries"]
    if len(queries) != nq:
        raise FriError("wrong query count")

    # transcript: every query index first, in the prover's order
    indices = []
    for q in queries:
        leaf_index = challenger.sample_bits(log_n - 1)
        if int(q["index"]) != leaf_index:
            raise FriError("query index mismatch")
        if len(q["rounds"]) != n_rounds:
            raise FriError("wrong per-query round count")
        indices.append(leaf_index)

    idx = list(indices)
    expected = None  # (nq, 4) value the current round must hold at idx
    v0_r0 = v1_r0 = None
    for r in range(n_rounds):
        cur_log = log_n - r
        n_half = 1 << (cur_log - 1)
        j = [i % n_half for i in idx]
        leaves = field_rows([q["rounds"][r]["leaf"] for q in queries], (nq, 8),
                            "malformed FRI leaf", dev)
        paths = field_rows([q["rounds"][r]["path"] for q in queries], (nq, cur_log - 1, 8),
                           "malformed FRI path", dev)
        if not verify_openings_batch(proof["roots"][r], j, leaves, paths):
            raise FriError(f"bad Merkle opening in round {r}")
        v0, v1 = leaves[:, 0:4], leaves[:, 4:8]
        if r == 0:
            v0_r0, v1_r0 = v0, v1
        else:
            low = torch.tensor([i < n_half for i in idx], device=dev)[:, None]
            spans.host_read(1)  # torch.equal's one boolean
            if not torch.equal(torch.where(low, v0, v1), expected):
                raise FriError(f"fold mismatch entering round {r}")
        # fold to the next round's value at j
        half_x_inv = bb.inv(coset_points(shifts[r], cur_log, j, dev)) * _HALF % P
        even = ext.add(v0, v1) * _HALF % P
        odd = ext.mul_base(ext.sub(v0, v1), half_x_inv)
        expected = ext.add(even, ext.mul(ext.tensor(betas[r], dev), odd))
        idx = j

    # the final polynomial at the tracked points (Horner)
    x = coset_points(shifts[n_rounds], final_len.bit_length() - 1, idx, dev)
    value = torch.zeros((nq, ext.D), dtype=torch.int64, device=dev)
    for c in reversed(final_coeffs):
        value = ext.add(ext.mul_base(value, x), ext.tensor(c, dev))
    spans.host_read(1)  # torch.equal's one boolean
    if not torch.equal(value, expected):
        raise FriError("final polynomial mismatch")

    open_input_batch(indices, v0_r0, v1_r0)
    return True
