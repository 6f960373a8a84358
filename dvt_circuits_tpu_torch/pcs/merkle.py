"""Poseidon2 Merkle commitments over BabyBear matrices.

Port of ``dvt_circuits_tpu/pcs/merkle.py``.  Every permutation goes
through ``poseidon2_permute`` — kernel K1 on the card:

  * leaves: a rate-8 overwrite-mode sponge over each row —
    ``state[:8] = chunk``, permute, digest ``state[:8]`` (one batched
    permutation per 8 columns);
  * interior nodes: ``left ‖ right`` fills the 16-word state, permute,
    keep ``[:8]`` (one batched permutation per level).

Openings read host mirrors fetched in one transfer per level, as the JAX
tree does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..hash.poseidon2 import DIGEST_WIDTH, RATE, WIDTH, poseidon2_permute


def hash_rows(matrix: torch.Tensor) -> torch.Tensor:
    """Sponge-hash each row of an (n, w) int64 matrix → (n, 8) digests."""
    n, w = matrix.shape
    pad = (-w) % RATE
    if pad:
        matrix = torch.cat([matrix, matrix.new_zeros((n, pad))], dim=1)
    state = matrix.new_zeros((n, WIDTH))
    for off in range(0, matrix.shape[1], RATE):
        state = poseidon2_permute(torch.cat([matrix[:, off : off + RATE], state[:, RATE:]], dim=1))
    return state[:, :DIGEST_WIDTH]


def compress_pairs(digests: torch.Tensor) -> torch.Tensor:
    """(n, 2, 8) digest pairs → (n, 8) parent digests."""
    n = digests.shape[0]
    state = digests.reshape(n, 2 * DIGEST_WIDTH)  # 2·8 == WIDTH: no zero tail
    return poseidon2_permute(state)[:, :DIGEST_WIDTH]


def build_levels(matrix: torch.Tensor) -> list:
    """Leaf digests then every compress level up to the (1, 8) root."""
    levels = [hash_rows(matrix)]
    while levels[-1].shape[0] > 1:
        cur = levels[-1]
        levels.append(compress_pairs(cur.view(cur.shape[0] // 2, 2, DIGEST_WIDTH)))
    return levels


def merkle_root(matrix: torch.Tensor) -> list:
    """Root digest of an (n, w) matrix as 8 ints."""
    return [int(v) for v in build_levels(matrix)[-1][0].tolist()]


class MerkleTree:
    """Commitment to an (n_leaves, row_width) matrix; n_leaves a power of two."""

    def __init__(self, matrix: torch.Tensor):
        n = matrix.shape[0]
        if n & (n - 1):
            raise ValueError("leaf count must be a power of two")
        self.matrix = matrix
        self.levels = build_levels(matrix)
        self._host = None  # standard-form numpy mirrors for opening

    def _materialize(self) -> list:
        if self._host is None:
            self._host = [a.cpu().numpy().astype(np.uint32) for a in [self.matrix, *self.levels]]
        return self._host

    @property
    def root(self) -> list:
        """Root digest as 8 ints."""
        return [int(v) for v in self._materialize()[-1][0]]

    def open(self, index: int):
        """(row, sibling path) of a leaf as uint32 numpy arrays."""
        host = self._materialize()
        row = host[0][index]
        path = []
        idx = index
        for level in host[1:-1]:
            path.append(level[idx ^ 1])
            idx >>= 1
        return row, np.asarray(path, dtype=np.uint32).reshape(-1, DIGEST_WIDTH)
