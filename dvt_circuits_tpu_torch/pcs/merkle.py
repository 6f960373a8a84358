"""Poseidon2 Merkle commitments over BabyBear matrices.

Port of ``dvt_circuits_tpu/pcs/merkle.py``.  Every permutation goes
through ``poseidon2_permute`` — kernel K1 on the card:

  * leaves: a rate-8 overwrite-mode sponge over each row —
    ``state[:8] = chunk``, permute, digest ``state[:8]`` (one batched
    permutation per 8 columns);
  * interior nodes: ``left ‖ right`` fills the 16-word state, permute,
    keep ``[:8]`` (one batched permutation per level).

Openings read host mirrors fetched in one transfer per level, as the JAX
tree does.  Verification: ``verify_opening`` walks one opening with the
scalar permutation; ``verify_openings_batch`` walks every query's opening
of one tree at once through ``poseidon2_permute`` on the verifier's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..hash.poseidon2 import DIGEST_WIDTH, RATE, WIDTH, poseidon2_permute, s_permute


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


# ---------------------------------------------------------------------------
# Verification
# ---------------------------------------------------------------------------


def _s_hash_row(row) -> list:
    """Scalar leaf sponge of one row of standard-form ints."""
    state = [0] * WIDTH
    for off in range(0, len(row), RATE):
        chunk = [int(v) for v in row[off : off + RATE]]
        state[:RATE] = chunk + [0] * (RATE - len(chunk))
        state = s_permute(state)
    return state[:DIGEST_WIDTH]


def verify_opening(root, index: int, row, path) -> bool:
    """Scalar check that ``row`` is leaf ``index`` under ``root``."""
    digest = _s_hash_row(row)
    idx = index
    for sib in path:
        sib = [int(v) for v in sib]
        pair = sib + digest if idx & 1 else digest + sib
        digest = s_permute(pair)[:DIGEST_WIDTH]
        idx >>= 1
    return digest == [int(v) for v in root]


def verify_openings_batch(root, indices, rows: torch.Tensor, paths: torch.Tensor) -> bool:
    """Batched check of openings of one tree: ``rows`` (nq, w) and
    ``paths`` (nq, depth, 8) int64 tensors, ``indices`` nq leaf indices.
    Hashes every row and climbs every path level by level on the tensors'
    device."""
    digests = hash_rows(rows)
    idx = torch.as_tensor(list(indices), dtype=torch.int64, device=rows.device)
    for level in range(paths.shape[1]):
        sib = paths[:, level]
        odd = (idx & 1).bool()[:, None]
        pair = torch.stack([torch.where(odd, sib, digests), torch.where(odd, digests, sib)], dim=1)
        digests = compress_pairs(pair)
        idx = idx >> 1
    want = torch.as_tensor([int(v) for v in root], dtype=torch.int64, device=rows.device)
    return want.shape == (DIGEST_WIDTH,) and bool((digests == want).all())
