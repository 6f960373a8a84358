"""Sharded STARK prover: ``stark.prover.prove`` over one mesh axis.

Counterpart of ``dvt_circuits_tpu/parallel/dist_stark.py``.  The protocol
(the checks, the transcript's order, the phases with their spans, the proof
dict) is ``stark.prover.prove``'s, written once; this module supplies its
layout over the d ranks of an axis, ``RowBlocks``, and the proof dict
equals the single-device prover's byte for byte (the proof bytes do not
depend on the sharding).  The sharding plan is the JAX one:

  * LDE: trace columns sharded (padded to a multiple of d), per-column
    transforms local; one all-to-all re-shards to contiguous row blocks,
    cut back to the true width;
  * commit: local subtrees and the gathered cap give the root
    (``dist_merkle.ShardedTree``);
  * quotient: row-sharded; the next-row access needs the first ``blowup``
    rows of the cyclic successor block, one ``ppermute``; the folded
    quotient is 4 columns wide, so it is all-gathered and its chunk
    transforms run replicated, each rank committing its own row block;
  * openings: ζ-dots on the column shards, then all-gathered;
  * DEEP codeword and FRI: row-sharded (``dist_fri.ShardedFri``); the final
    polynomial and the grind replicated;
  * query openings: ``ShardedTree.open_many`` (an owner mask, one ``psum``).

JAX runs one host program; here each rank runs the same program on its own
card (SPMD): every rank keeps the whole Fiat–Shamir transcript on its own
``DuplexChallenger`` and observes the same replicated roots, openings and
final coefficients, so the ranks draw the same challenges, record the same
phase spans and return the same proof dict.  Values are int64 standard
form, as in the rest of the port.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..field import ext
from ..pcs.challenger import DuplexChallenger
from ..stark.air import Air
from ..stark.config import StarkConfig
from ..stark.prover import (
    _domain_tables,
    _eval_cols_at,
    coeffs_head,
    cols_at,
    commit_columns,
    constraint_fold,
    lde_body,
    prove,
    quotient_chunks,
)
from ..utils import spans
from .comm import all_gather, all_to_all, broadcast_object, ppermute
from .dist_fri import ShardedFri
from .dist_merkle import ShardedTree
from .mesh import Mesh


class RowBlocks(ShardedFri):
    """``stark.prover.prove``'s layout over the d ranks of ``ax``: LDEs in
    column blocks for the openings; every committed matrix, the quotient
    and the DEEP codeword in contiguous row blocks of s = n_lde/d rows, at
    least ``blowup`` (``stark.prover.OneCard`` says what each hook
    returns)."""

    def lde(self, cols, config: StarkConfig):
        """This rank's column block's LDE (the columns zero-padded to a
        multiple of d; only they are copied on the host) and, after one
        all-to-all, its (s, w) row block."""
        ax = self.ax
        cols = np.asarray(cols)
        n, w = cols.shape
        n_lde = n << config.log_blowup
        if n_lde % ax.size or n_lde // ax.size < config.blowup:
            raise ValueError(f"{n_lde} LDE rows do not split over {ax.size} ranks with a block "
                             f"of at least the blowup halo ({config.blowup} rows)")
        k = -(-w // ax.size)
        part = cols[:, ax.index * k : (ax.index + 1) * k]
        block = np.zeros((n, k), dtype=np.int64)
        block[:, : part.shape[1]] = part
        lde = lde_body(torch.as_tensor(block, device=ax.device), config)
        return lde, all_to_all(lde, ax, split_axis=0, concat_axis=1)[:, :w]

    def tree(self, rows: torch.Tensor) -> ShardedTree:
        return ShardedTree(rows, self.ax, self.ax.size)

    def domain(self, log_n: int, config: StarkConfig) -> dict:
        s = (1 << (log_n + config.log_blowup)) // self.ax.size
        i = self.ax.index
        tables = _domain_tables(log_n, config.log_blowup, config.shift, self.ax.device)
        return {k: v[i * s : (i + 1) * s] for k, v in tables.items()}

    def quotient(self, air: Air, t_rows, p_rows, alpha, publics, tables, log_n: int,
                 config: StarkConfig):
        """The fold on the row blocks (halo: the successor block's first
        rows), then the 4-wide quotient gathered and its chunks transformed
        replicated; this rank's row block of them."""
        ax, d, blowup = self.ax, self.ax.size, config.blowup
        to_prev = [(p, (p - 1) % d) for p in range(d)]
        halos = (ppermute(t_rows[:blowup], ax, to_prev),
                 ppermute(p_rows[:blowup], ax, to_prev) if air.preprocessed_width else None)
        folded, count = constraint_fold(air, t_rows, p_rows, alpha, publics, tables, blowup,
                                        halos)
        quotient = all_gather(ext.mul_base(folded, tables["zh_inv"]), ax, axis=0, tiled=True)
        q_matrix, q_col_coeffs = quotient_chunks(quotient, log_n, config)
        s = t_rows.shape[0]
        return q_matrix[ax.index * s : (ax.index + 1) * s].clone(), q_col_coeffs, count

    def openings(self, air: Air, t_lde, p_lde, q_col_coeffs, zeta, gzeta, log_n: int,
                 config: StarkConfig) -> dict:
        """ζ-dots on the column shards, all-gathered and cut to the true
        widths (``_eval_cols_at``'s uint32 (w, 4) arrays)."""

        def at_both(lde, width):
            c = coeffs_head(lde, config.shift, 1 << log_n)
            vals = torch.cat([cols_at(c, zeta), cols_at(c, gzeta)], dim=1)  # (wp/d, 8)
            full = all_gather(vals, self.ax, axis=0, tiled=True)[:width]
            spans.host_read(full)
            full = full.cpu().numpy().astype(np.uint32)
            return full[:, : ext.D], full[:, ext.D :]

        out = {}
        out["t_zeta"], out["t_gzeta"] = at_both(t_lde, air.width)
        out["q_zeta"] = _eval_cols_at(q_col_coeffs, zeta)
        if air.preprocessed_width:
            out["p_zeta"], out["p_gzeta"] = at_both(p_lde, air.preprocessed_width)
        return out


def dist_precommit(air: Air, trace, config: StarkConfig, mesh: Mesh,
                   axis_name: str = "sp") -> dict:
    """The transcript-independent phases of ``dist_prove`` (preprocessed and
    trace LDE and commit), for ``dist_prove(..., precommit=...)``."""
    return commit_columns(air, trace, config, RowBlocks(mesh.axis(axis_name)))


def dist_prove(
    air: Air,
    trace,
    public_values: Sequence[int],
    config: StarkConfig,
    mesh: Mesh,
    axis_name: str = "sp",
    challenger: DuplexChallenger | None = None,
    precommit: dict | None = None,
) -> dict:
    """Prove one AIR instance sharded over ``axis_name``; every rank of the
    axis calls it with the same arguments and gets the proof dict of
    ``stark.prover.prove``.  Chain a ``challenger`` (on ``mesh.device``) for
    multi-table proofs, as with the single-device prover.  The LDE rows
    must split over the axis with a block of at least ``blowup`` rows."""
    if challenger is None:
        challenger = DuplexChallenger(mesh.device)
    return prove(air, trace, public_values, config, challenger,
                 RowBlocks(mesh.axis(axis_name)), precommit)


def dist_prove_tables(entries, config: StarkConfig, mesh: Mesh, axis_name: str = "sp") -> list:
    """(air, trace, publics) tables proven in order on one chained
    transcript, each sharded over ``axis_name`` (``prove_tables``'s
    semantics)."""
    challenger = DuplexChallenger(mesh.device)
    return [dist_prove(air, trace, publics, config, mesh, axis_name, challenger)
            for air, trace, publics in entries]


def ep_groups(entries, config: StarkConfig, mesh: Mesh, axis_name: str = "sp") -> list:
    """Each table's range of ranks: tables take the axis's g = min(tables,
    d) blocks of d // g ranks in turn, and a range shrinks until the LDE
    rows split over it with a block of at least ``blowup`` rows."""
    size = mesh.axis(axis_name).size
    g = min(len(entries), size)
    per = size // g if g else 0
    subs = []
    for i, (_, trace, _) in enumerate(entries):
        n_lde = np.asarray(trace).shape[0] << config.log_blowup
        nd = per
        while nd > 1 and (n_lde % nd or n_lde // nd < config.blowup):
            nd -= 1
        subs.append(mesh.sub_axis(axis_name, (i % g) * per, nd))
    return subs


def ep_prove_tables(entries, config: StarkConfig, mesh: Mesh, axis_name: str = "sp") -> list:
    """Table-parallel proving: each table on its own range of the axis's
    ranks (``ep_groups``), every table's commit made up front by its range,
    so the ranges commit at once.  The transcript, and every proof byte, is
    ``dist_prove_tables``'s: the ranks of table k's range prove it on their
    chained challengers, then its first rank broadcasts the proof and the
    challenger's state to the whole axis, so every rank has absorbed table
    k before table k + 1 starts."""
    ax = mesh.axis(axis_name)
    subs = ep_groups(entries, config, mesh, axis_name)
    entries = [(air, np.asarray(trace), publics) for air, trace, publics in entries]
    pres = [commit_columns(air, trace, config, RowBlocks(sub)) if sub.index >= 0 else None
            for (air, trace, _), sub in zip(entries, subs)]
    challenger = DuplexChallenger(ax.device)
    proofs = []
    for i, ((air, trace, publics), sub) in enumerate(zip(entries, subs)):
        sent = None
        if sub.index >= 0:
            proof = prove(air, trace, publics, config, challenger, RowBlocks(sub), pres[i])
            sent = (proof, challenger.state, challenger.input_buffer, challenger.output_buffer)
        pres[i] = None
        proof, challenger.state, challenger.input_buffer, challenger.output_buffer = (
            broadcast_object(sent, ax, ax.ranks.index(sub.ranks[0])))
        proofs.append(proof)
    return proofs
