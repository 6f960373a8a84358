"""Expert-parallel (EP) table commitment: different AIR tables on different
ranks.

Counterpart of ``dvt_circuits_tpu/parallel/ep_tables.py``.  The table axis
is split over an ``ep`` mesh axis: each rank runs the coset LDE and the
Merkle commit of its K/ep tables (one leaf-sponge launch a table, K1b, then
the level launches to the root, K1c), and the (K, 8) roots are
all-gathered, so every rank returns all of them.  A demo of the mapping: no
prove path calls it (``prove_circuit``'s table parallelism is
``dist_stark.ep_prove_tables``).

Tables are padded to a common (rows, width), as the reference pads them.
The roots are standard form; they equal the single-device ``merkle_root``
of each padded table's coset LDE and ``from_mont`` of the reference's
Montgomery roots.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import babybear as bb
from ..ntt.ntt import coset_lde
from ..pcs.merkle import build_levels
from .comm import all_gather
from .mesh import Mesh


def _as_int64(x, device) -> torch.Tensor:
    """Standard-form words (numpy array or tensor) as int64 on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)


def _commit_one(mat: torch.Tensor, log_blowup: int, shift: int) -> torch.Tensor:
    """Standard-form (n, w) table → the (8,) root of its coset LDE."""
    return build_levels(coset_lde(mat, log_blowup, shift))[-1][0]


def pad_tables(tables) -> np.ndarray:
    """Stack ragged standard-form tables into one (K, n_max, w_max) array.

    Rows are padded to the max power-of-two row count, columns with zeros;
    the padding is part of the committed matrix (deterministic both sides).
    """
    n_max = max(t.shape[0] for t in tables)
    n_max = 1 << (n_max - 1).bit_length()
    w_max = max(t.shape[1] for t in tables)
    out = np.zeros((len(tables), n_max, w_max), dtype=np.uint32)
    for k, t in enumerate(tables):
        out[k, : t.shape[0], : t.shape[1]] = t
    return out


def ep_commit_tables(tables, mesh: Mesh, log_blowup: int = 1, shift: int = bb.GENERATOR,
                     axis_name: str = "ep") -> torch.Tensor:
    """Commit K padded tables with the table axis split over ``axis_name``;
    every rank of the axis calls this with the same tables.

    tables: (K, n, w) standard-form words (see ``pad_tables``); K must be a
    multiple of the axis size.  Rank i commits tables [i·K/ep, (i+1)·K/ep).
    Returns the (K, 8) standard-form roots on every rank."""
    k = tables.shape[0]
    ax = mesh.axis(axis_name)
    ep = ax.size
    if k % ep:
        raise ValueError(f"table count {k} not divisible by ep={ep}")
    per = k // ep
    local = _as_int64(tables[ax.index * per : (ax.index + 1) * per], mesh.device)
    roots = torch.stack([_commit_one(m, log_blowup, shift) for m in local])
    return all_gather(roots, ax, axis=0, tiled=True)
