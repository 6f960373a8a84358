"""Sharded FRI: blockwise commit and fold over a row-sharded codeword.

Counterpart of ``dvt_circuits_tpu/parallel/dist_fri.py``.  Layout (group
replication): at round r the size-M_r codeword is sharded over
g_r = d/2^r groups of ranks, each rank holding one contiguous block of
s = M_0/d rows (the block size does not change); ranks p and p' with
p ≡ p' (mod g_r) hold identical blocks.  One fold round:

  1. one ``ppermute`` over the involution p → p ⊕ g_{r+1}: the two partners
     hold the v(x) and v(−x) blocks of each other's fold targets (pair
     (i, i + M/2) ⇔ block indices differing in the top bit);
  2. locally, the round's (s, 8) pair-leaf rows [v0 ‖ v1], their Merkle
     subtree and the folded block: both partners fold the same block, which
     doubles the replication;
  3. the round root folds the g_{r+1} group caps (``dist_merkle._cap_root``).

After log2 d rounds every rank holds the whole codeword and folds locally.
Openings are masked sums (``gather_sharded_opening``): only the rank that
owns an index contributes its row and its subtree path, the replicated cap
levels give the top of the path, and the bytes equal ``MerkleTree.open``'s
because subtree boundaries align.  Only the opened rows and paths leave the
card: one gather and one collective per tree and index batch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import babybear as bb
from ..field import ext
from ..pcs.fri import _inv2x_table
from ..pcs.merkle import build_levels
from .comm import ppermute, psum
from .dist_merkle import _cap_root
from .mesh import Axis

P = bb.P
_HALF = (P + 1) // 2  # 1/2


def _fold_block(v0, v1, beta, inv2x_local):
    """(s, 4) blocks of v(x) and v(−x) → the folded (s, 4) block (``pcs/fri.py:fold``)."""
    even = ext.add(v0, v1) * _HALF % P
    odd = ext.mul_base(ext.sub(v0, v1), inv2x_local)
    return ext.add(even, ext.mul(ext.tensor(beta, v0.device), odd))


def dist_fri_round(codeword_local: torch.Tensor, r: int, ax: Axis):
    """Round r's commit half: exchange partner blocks and build the pair-leaf
    subtree.  Returns (v0, v1, pairs, levels, top levels); the root is
    ``top[-1][0]``.  At entry g = max(1, d >> r) groups hold the codeword;
    once g is 1 every rank holds all of it and splits it locally."""
    d = ax.size
    g_next = max(1, d >> r) // 2
    if g_next >= 1:
        partner = ppermute(codeword_local, ax, [(p, p ^ g_next) for p in range(d)])
        # rank p holds block p mod g; the lower (v0) block has bit g_next clear
        if ax.index & g_next:
            v0, v1 = partner, codeword_local
        else:
            v0, v1 = codeword_local, partner
    else:
        half = codeword_local.shape[0] // 2
        v0, v1 = codeword_local[:half], codeword_local[half:]
    pairs = torch.cat([v0, v1], dim=1)  # (s or M/2, 8)
    levels = build_levels(pairs)
    return v0, v1, pairs, levels, _cap_root(levels, ax, max(1, g_next))


def dist_fri_fold_half(v0, v1, r: int, ax: Axis, shift_r: int, cur_log: int, beta):
    """Round r's fold half: β-fold the exchanged blocks into the next block.
    The 1/(2x) slice is this rank's pair-block index (p mod g_{r+1}), so
    both partners fold the same block."""
    g_next = max(1, (ax.size >> r) // 2)
    s = v0.shape[0]
    inv2x = _inv2x_table(shift_r, cur_log, v0.device)  # (M_r / 2,)
    if inv2x.shape[0] > s:
        block = ax.index % g_next
        inv2x = inv2x[block * s : (block + 1) * s]
    return _fold_block(v0, v1, beta, inv2x)


def gather_sharded_opening(rows: torch.Tensor, levels: list, top_levels: list, indices,
                           ax: Axis):
    """Openings of a row-sharded Merkle tree at global leaf ``indices``, by a
    masked sum: every rank gathers its candidate row and subtree path, only
    the owner (axis index == global block index) keeps them, and one
    ``psum`` combines them; the replicated cap levels give the top of each
    path.  ``rows``: this rank's (s, w) leaf block, ``levels`` its subtree
    levels, ``top_levels`` the cap levels.  Returns uint32 numpy arrays
    (m, w) and (m, depth, 8) equal to ``MerkleTree.open``'s; works for
    group-replicated layouts too (the owner index is below the group count)."""
    s, w = rows.shape
    idx = torch.as_tensor(np.asarray(indices, dtype=np.int64), device=rows.device)
    m = idx.shape[0]
    block, cur = idx // s, idx % s
    parts = [rows.index_select(0, cur)]
    for level in levels[:-1]:
        parts.append(level.index_select(0, cur ^ 1))
        cur = cur >> 1
    local = torch.cat([p.reshape(m, -1) for p in parts], dim=1)
    local = psum(local * (block == ax.index)[:, None], ax)
    cur = block
    for level in top_levels[:-1]:
        local = torch.cat([local, level.index_select(0, cur ^ 1)], dim=1)
        cur = cur >> 1
    host = local.cpu().numpy().astype(np.uint32)  # the one copy to the host
    return host[:, :w], host[:, w:].reshape(m, -1, 8)
