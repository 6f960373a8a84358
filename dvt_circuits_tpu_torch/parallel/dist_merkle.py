"""Sharded Merkle commitment: local subtrees and a gathered cap.

Counterpart of ``dvt_circuits_tpu/parallel/dist_merkle.py``.  Each rank
hashes its contiguous leaf block into a subtree (one leaf-sponge launch, K1b,
and the level launches, K1c), the d subtree caps are all-gathered, and every
rank folds the cap levels.  The subtree boundaries align with the
single-device tree's, so the root equals ``pcs.merkle.merkle_root`` of the
whole matrix.  ``ShardedTree`` is the sharded prover's committed matrix: a
``MerkleTree`` over this rank's block whose openings add the owner mask,
one ``psum`` and the cap levels to ``MerkleTree``'s own gather.
"""

from __future__ import annotations

import torch

from ..hash.poseidon2 import DIGEST_WIDTH, poseidon2_merkle_levels
from ..pcs.merkle import MerkleTree, tree_levels
from .comm import all_gather, psum
from .mesh import Axis, Mesh


def _cap_root(levels: list, ax: Axis, groups: int) -> list:
    """The levels above the subtrees: the caps of the first ``groups`` ranks
    (ranks are group-replicated past them), then each compress level up to
    the (1, 8) root, replicated.  ``levels[-1]`` is this rank's (1, 8)
    subtree cap."""
    if groups == 1:  # every rank holds the same (whole) tree
        return [levels[-1]]
    caps = all_gather(levels[-1][0], ax)[:groups]  # (groups, 8)
    buf = caps.new_empty((2 * groups - 1, DIGEST_WIDTH))
    buf[:groups] = caps
    poseidon2_merkle_levels(buf, groups)
    return tree_levels(buf)


class ShardedTree(MerkleTree):
    """The tree over a matrix whose contiguous row blocks lie on the ranks
    of ``ax`` in order (``matrix``: this rank's block, ``levels`` its
    subtree), its root the cap over the first ``groups`` blocks' subtrees
    (``_cap_root``).  ``open_many`` takes global leaf indices and returns
    ``MerkleTree.open_many``'s arrays for the whole matrix, on every rank."""

    def __init__(self, rows: torch.Tensor, ax: Axis, groups: int):
        super().__init__(rows)
        self.ax = ax
        self.caps = _cap_root(self.levels, ax, groups)

    def _root_words(self) -> torch.Tensor:
        return self.caps[-1][0]

    def _gather(self, idx: torch.Tensor) -> torch.Tensor:
        """The owner of each leaf (axis index == block index, below the
        group count) gathers its row and subtree path, the others zeros, one
        ``psum`` combines them; the replicated cap levels give the rest of
        the path."""
        s = self.matrix.shape[0]
        block = idx // s
        owned = (block == self.ax.index)[:, None]
        parts = [psum(super()._gather(idx % s) * owned, self.ax)]
        for level in self.caps[:-1]:
            parts.append(level.index_select(0, block ^ 1))
            block = block >> 1
        return torch.cat(parts, dim=1)


def dist_merkle_root(local: torch.Tensor, mesh: Mesh, axis_name: str = "sp") -> list:
    """Root (8 ints) of the Merkle tree over the rows of a matrix whose
    contiguous row blocks lie on the ranks of ``axis_name`` in rank order;
    ``local`` is this rank's (n/d, w) block, n/d a power of two."""
    n = local.shape[0]
    if n < 1 or n & (n - 1):
        raise ValueError("leaf block per rank must be a power of two")
    ax = mesh.axis(axis_name)
    return ShardedTree(local, ax, ax.size).root
