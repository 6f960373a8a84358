"""Sharded FRI: the row-block layout of ``pcs/fri.py:fri_prove``.

Counterpart of ``dvt_circuits_tpu/parallel/dist_fri.py``.  Layout (group
replication): at round r the size-M_r codeword is sharded over
g_r = d/2^r groups of ranks, each rank holding one contiguous block of
s = M_0/d rows (the block size does not change); ranks p and p' with
p ≡ p' (mod g_r) hold identical blocks.  One round (``ShardedFri.fri_round``):

  1. one ``ppermute`` over the involution p → p ⊕ g_{r+1}: the two partners
     hold the v(x) and v(−x) blocks of each other's fold targets (pair
     (i, i + M/2) ⇔ block indices differing in the top bit);
  2. locally, the round's (s, 8) pair-leaf rows [v0 ‖ v1] and their
     subtree, a ``dist_merkle.ShardedTree`` whose root folds the g_{r+1}
     group caps; ``fri_prove`` then folds the block with ``pcs/fri.py:fold``
     and this block's rows of 1/(2x): both partners fold the same block,
     which doubles the replication.

After log2 d rounds every rank holds the whole codeword and folds locally;
``fri_last`` gathers it when the rounds end first.  Openings are
``ShardedTree.open_many``'s: only the opened rows and paths leave the card.
"""

from __future__ import annotations

import torch

from .comm import all_gather, ppermute
from .dist_merkle import ShardedTree
from .mesh import Axis


class ShardedFri:
    """``fri_prove``'s layout of a codeword in row blocks over the ranks of
    ``ax`` (``pcs/fri.py:OneCardFri`` says what each hook returns)."""

    def __init__(self, ax: Axis):
        self.ax = ax
        self.blocks = ax.size

    def fri_round(self, codeword: torch.Tensor, r: int):
        """At entry g = max(1, d >> r) groups hold the codeword; once g is 1
        every rank holds all of it and splits it locally."""
        ax = self.ax
        g_next = max(1, ax.size >> r) // 2
        if g_next:
            partner = ppermute(codeword, ax, [(p, p ^ g_next) for p in range(ax.size)])
            # rank p holds block p mod g; the lower (v0) block has bit g_next clear
            v0, v1 = (partner, codeword) if ax.index & g_next else (codeword, partner)
            lo = (ax.index % g_next) * codeword.shape[0]
        else:
            half = codeword.shape[0] // 2
            v0, v1, lo = codeword[:half], codeword[half:], 0
        tree = ShardedTree(torch.cat([v0, v1], dim=1), ax, max(1, g_next))
        return tree, v0, v1, lo

    def fri_last(self, codeword: torch.Tensor, size: int, r: int) -> torch.Tensor:
        """Blocks 0..g − 1 of the ranks' copies make the last codeword."""
        if max(1, self.ax.size >> r) > 1:
            return all_gather(codeword, self.ax, axis=0, tiled=True)[:size]
        return codeword
