"""Poseidon2 Merkle commitments over BabyBear matrices.

Port of ``dvt_circuits_tpu/pcs/merkle.py``.  Every permutation goes through
kernel K1 on the card (``hash/poseidon2.py``):

  * leaves: a rate-8 overwrite-mode sponge over each row —
    ``state[:8] = chunk``, permute, digest ``state[:8]`` — in one launch per
    tree (K1b, ``poseidon2_hash_rows``);
  * interior nodes: ``left ‖ right`` fills the 16-word state, permute, keep
    ``[:8]`` — written level by level into one (2n − 1, 8) buffer whose
    views are the tree's levels (K1c, ``poseidon2_merkle_levels``).

Nothing committed is mirrored on the host: the root is read alone (8
words), and ``open_many`` gathers a batch of opened rows and sibling paths
on the tree's device, then copies that small array back in one transfer.
Verification: ``verify_opening`` walks one opening with the
scalar permutation; ``verify_openings_batch`` walks every query's opening
of one tree at once on the verifier's device: its rows through K1b, each
level of the climb through K1a.
"""

from __future__ import annotations

import numpy as np
import torch

from ..hash.poseidon2 import (
    DIGEST_WIDTH,
    RATE,
    WIDTH,
    poseidon2_hash_rows,
    poseidon2_merkle_levels,
    poseidon2_permute,
    s_permute,
)
from ..utils import spans


#: sponge-hash each row of an (n, w) int64 matrix → (n, 8) digests
hash_rows = poseidon2_hash_rows


def build_tree(matrix: torch.Tensor) -> torch.Tensor:
    """The (2n − 1, 8) buffer of an n-row matrix's tree: the n leaf digests,
    then each compress level, the root last."""
    n = matrix.shape[0]
    buf = matrix.new_empty((2 * n - 1, DIGEST_WIDTH))
    hash_rows(matrix, out=buf[:n])
    poseidon2_merkle_levels(buf, n)
    return buf


def tree_levels(buf: torch.Tensor) -> list:
    """The levels of a tree buffer as views, leaves first, (1, 8) root last."""
    levels, off, n = [], 0, (buf.shape[0] + 1) // 2
    while n:
        levels.append(buf[off : off + n])
        off += n
        n //= 2
    return levels


def build_levels(matrix: torch.Tensor) -> list:
    """Leaf digests then every compress level up to the (1, 8) root."""
    return tree_levels(build_tree(matrix))


def merkle_root(matrix: torch.Tensor) -> list:
    """Root digest of an (n, w) matrix as 8 ints."""
    root = build_tree(matrix)[-1]
    spans.host_read(root)
    return [int(v) for v in root.tolist()]


class MerkleTree:
    """Commitment to an (n_leaves, row_width) matrix; n_leaves a power of two."""

    def __init__(self, matrix: torch.Tensor):
        n = matrix.shape[0]
        if n & (n - 1):
            raise ValueError("leaf count must be a power of two")
        self.matrix = matrix
        self._buf = build_tree(matrix)
        self.levels = tree_levels(self._buf)
        self._root = None

    def _root_words(self) -> torch.Tensor:
        return self._buf[-1]

    @property
    def root(self) -> list:
        """Root digest as 8 ints, read from the device the first time."""
        if self._root is None:
            root = self._root_words()
            spans.host_read(root)
            self._root = [int(v) for v in root.tolist()]
        return list(self._root)

    def _gather(self, idx: torch.Tensor) -> torch.Tensor:
        """Each leaf's row and its sibling path, side by side: (m, w +
        8·depth) on the tree's device, an ``index_select`` a level."""
        parts, cur = [self.matrix.index_select(0, idx)], idx
        for level in self.levels[:-1]:
            parts.append(level.index_select(0, cur ^ 1))
            cur = cur >> 1
        return torch.cat(parts, dim=1)

    def open_many(self, indices):
        """(rows, sibling paths) of the leaves ``indices``, in their order,
        as uint32 numpy arrays (m, w) and (m, depth, 8): gathered on the
        tree's device (``_gather``), then copied to the host in one read."""
        idx = torch.as_tensor(np.asarray(indices, dtype=np.int64).reshape(-1),
                              device=self.matrix.device)
        opened = self._gather(idx)
        m, w = opened.shape[0], self.matrix.shape[1]
        spans.host_read(opened)
        spans.count("opened_rows", m)
        host = opened.cpu().numpy().astype(np.uint32)
        return host[:, :w], host[:, w:].reshape(m, (host.shape[1] - w) // DIGEST_WIDTH,
                                                DIGEST_WIDTH)

    def open(self, index: int):
        """(row, sibling path) of one leaf as uint32 numpy arrays."""
        rows, paths = self.open_many([index])
        return rows[0], paths[0]


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
        digests = poseidon2_permute(pair.reshape(-1, WIDTH))[:, :DIGEST_WIDTH]
        idx = idx >> 1
    want = torch.as_tensor([int(v) for v in root], dtype=torch.int64, device=rows.device)
    if want.shape != (DIGEST_WIDTH,):
        return False
    ok = (digests == want).all()
    spans.host_read(ok)
    return bool(ok)
