"""Sharded Merkle commitment: local subtrees and a gathered cap.

Counterpart of ``dvt_circuits_tpu/parallel/dist_merkle.py``.  Each rank
hashes its contiguous leaf block into a subtree (one leaf-sponge launch, K1b,
and the level launches, K1c), the d subtree caps are all-gathered, and every
rank folds the cap levels.  The subtree boundaries align with the
single-device tree's, so the root equals ``pcs.merkle.merkle_root`` of the
whole matrix.
"""

from __future__ import annotations

import torch

from ..hash.poseidon2 import DIGEST_WIDTH, poseidon2_merkle_levels
from ..pcs.merkle import build_levels, tree_levels
from .comm import all_gather
from .mesh import Axis, Mesh


def _cap_root(levels: list, ax: Axis, groups: int) -> list:
    """The levels above the subtrees (``dist_fri.py:_cap_root``): the caps of
    the first ``groups`` ranks (ranks are group-replicated past them), then
    each compress level up to the (1, 8) root, replicated.  ``levels[-1]``
    is this rank's (1, 8) subtree cap."""
    if groups == 1:  # every rank holds the same (whole) tree
        return [levels[-1]]
    caps = all_gather(levels[-1][0], ax)[:groups]  # (groups, 8)
    buf = caps.new_empty((2 * groups - 1, DIGEST_WIDTH))
    buf[:groups] = caps
    poseidon2_merkle_levels(buf, groups)
    return tree_levels(buf)


def dist_merkle_root(local: torch.Tensor, mesh: Mesh, axis_name: str = "sp") -> list:
    """Root (8 ints) of the Merkle tree over the rows of a matrix whose
    contiguous row blocks lie on the ranks of ``axis_name`` in rank order;
    ``local`` is this rank's (n/d, w) block, n/d a power of two."""
    n = local.shape[0]
    if n < 1 or n & (n - 1):
        raise ValueError("leaf block per rank must be a power of two")
    ax = mesh.axis(axis_name)
    top = _cap_root(build_levels(local), ax, ax.size)
    return [int(v) for v in top[-1][0].tolist()]
