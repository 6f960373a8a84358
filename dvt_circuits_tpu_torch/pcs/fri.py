"""FRI low-degree proof over BB4 codewords (prover side).

Port of ``dvt_circuits_tpu/pcs/fri.py:fri_prove`` with the inline fold of
``stark/fused.py``.  The codeword lives on a coset s·K in natural order;
each round commits leaf pairs (v[i], v[i+N/2]) as an (N/2, 8) Merkle
matrix, then folds with a BB4 challenge β:

    v'(x²) = (v(x) + v(−x))/2 + β · (v(x) − v(−x))/(2x)

The final codeword is sent as coefficients (coset iNTT, unscale,
truncate); then the proof-of-work grind and the query openings.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..field import babybear as bb
from ..field import ext
from ..ntt import intt
from ..utils.packing import pack_u32
from .challenger import DuplexChallenger
from .merkle import MerkleTree

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


def _pair_matrix(codeword: torch.Tensor) -> torch.Tensor:
    """(N, 4) BB4 codeword → (N/2, 8) leaf matrix [v[i] ‖ v[i+N/2]]."""
    n = codeword.shape[0]
    return torch.cat([codeword[: n // 2], codeword[n // 2 :]], dim=1)


@lru_cache(maxsize=None)
def _inv2x_table(shift: int, log_n: int, device: torch.device) -> torch.Tensor:
    """1/(2x_j) for x_j = shift·ω^j, j < N/2."""
    half = 1 << (log_n - 1)
    two_x = bb.powers(bb.two_adic_generator(log_n), half, device, start=2 * shift)
    return bb.inv(two_x)


def fold(codeword: torch.Tensor, beta, shift: int) -> torch.Tensor:
    """One fold round: (N, 4) codeword over shift·K → (N/2, 4)."""
    n = codeword.shape[0]
    v0, v1 = codeword[: n // 2], codeword[n // 2 :]
    inv2x = _inv2x_table(shift, n.bit_length() - 1, codeword.device)
    even = ext.add(v0, v1) * _HALF % P
    odd = ext.mul_base(ext.sub(v0, v1), inv2x)
    return ext.add(even, ext.mul(ext.tensor(beta, codeword.device), odd))


def final_coefficients(codeword: torch.Tensor, shift: int, log_blowup: int) -> list:
    """Coset iNTT of the last codeword, unscaled by shift⁻ⁱ and truncated
    to len/blowup coefficients (the rest must be zero)."""
    n = codeword.shape[0]
    coeffs = intt(codeword)
    unscale = bb.powers(bb.s_inv(shift), n, codeword.device)
    coeffs = ext.mul_base(coeffs, unscale).cpu().numpy()
    keep = n >> log_blowup
    if np.any(coeffs[keep:]):
        raise AssertionError("final codeword exceeds degree bound — prover bug")
    return [tuple(int(x) for x in c) for c in coeffs[:keep]]


def fri_prove(codeword: torch.Tensor, shift: int, config: FriConfig,
              challenger: DuplexChallenger) -> dict:
    """Commit-fold an (N, 4) BB4 codeword; returns the proof dict in the
    JAX package's format.  ``shift`` is the coset shift of its domain."""
    n = codeword.shape[0]
    log_n = n.bit_length() - 1
    assert 1 << log_n == n
    final_len = (1 << config.log_final_poly_len) * config.blowup

    trees = []
    roots = []
    shift_r = shift % P
    while codeword.shape[0] > final_len:
        tree = MerkleTree(_pair_matrix(codeword))
        trees.append(tree)
        roots.append(tree.root)
        challenger.observe_many(tree.root)
        beta = challenger.sample_ext()
        codeword = fold(codeword, beta, shift_r)
        shift_r = shift_r * shift_r % P

    final_coeffs = final_coefficients(codeword, shift_r, config.log_blowup)
    for c in final_coeffs:
        challenger.observe_ext(c)

    pow_witness = challenger.grind(config.proof_of_work_bits)

    queries = []
    for _ in range(config.num_queries):
        leaf_index = challenger.sample_bits(log_n - 1)
        rounds = []
        idx = leaf_index
        for tree in trees:
            j = idx % tree.matrix.shape[0]
            row, path = tree.open(j)
            rounds.append({"leaf": pack_u32(row), "path": pack_u32(path)})
            idx = j  # i_{r+1} = i_r mod N_r/2
        queries.append({"index": leaf_index, "rounds": rounds})

    return {
        "roots": roots,
        "final_coeffs": [list(c) for c in final_coeffs],
        "pow_witness": pow_witness,
        "queries": queries,
        "log_n": log_n,
    }
