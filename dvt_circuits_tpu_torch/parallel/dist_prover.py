"""Sharded commit step over a (dp, sp, tp) mesh.

Counterpart of ``dvt_circuits_tpu/parallel/dist_prover.py``:

  * dp — independent traces of a batch (the batch axis),
  * sp — the trace row dimension (the four-step NTT's all-to-alls),
  * tp — trace columns (per-column transforms local; leaf hashing gathers
    whole rows over tp).

``dist_commit_step`` is the sharded analogue of the prover's commit phase:
each trace's per-column NTT over sharded rows, row hashes, and Merkle caps
folded over sp.  The JAX package's multichip dryrun runs it as its stage 2.
"""

from __future__ import annotations

import torch

from ..pcs.merkle import build_tree
from .comm import all_gather
from .dist_merkle import _cap_root
from .dist_ntt import sharded_four_step
from .mesh import Mesh


def dist_commit_step(traces: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block (B/dp, N/sp, W/tp) of a standard-form batch of
    traces (B, N, W) sharded over (dp, sp, tp) → (B/dp, 8) Merkle roots of
    the digit-ordered NTT of each trace's columns, replicated over sp and
    tp."""
    sp, tp = mesh.axis("sp"), mesh.axis("tp")
    bs, n_loc, w_loc = traces.shape
    n = n_loc * sp.size
    log_n = n.bit_length() - 1
    # the four-step NTT of every column over the sharded rows
    m = traces.movedim(1, -1)  # (B/dp, W/tp, N/sp)
    evals = sharded_four_step(m, sp, log_n).movedim(-1, 1)  # (B/dp, N/sp, W/tp)
    full = all_gather(evals, tp, axis=2, tiled=True)  # (B/dp, N/sp, W): whole rows
    roots = []
    for mat in full:  # each trace's subtree cap, then the caps folded over sp
        cap = build_tree(mat)[-1:]
        roots.append(_cap_root([cap], sp, sp.size)[-1][0])
    return torch.stack(roots) if roots else full.new_empty((0, 8))
