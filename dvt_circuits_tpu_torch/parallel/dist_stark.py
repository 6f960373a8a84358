"""Sharded STARK prover: the whole DEEP-ALI pipeline over one mesh axis.

Counterpart of ``dvt_circuits_tpu/parallel/dist_stark.py``.  Every phase of
``stark.prover.prove`` runs sharded over the d ranks of an axis, and the
proof dict equals the single-device prover's byte for byte (the proof bytes
do not depend on the sharding).  The sharding plan is the JAX one:

  * LDE: trace columns sharded (padded to a multiple of d), per-column
    transforms local;
  * commit: one all-to-all re-shards to contiguous row blocks, cut back to
    the true width; local subtrees and the gathered cap give the root;
  * quotient: row-sharded; the next-row access needs the first ``blowup``
    rows of the cyclic successor block, one ``ppermute``; the folded
    quotient is 4 columns wide, so it is all-gathered and its chunk
    transforms run replicated, each rank committing its own row block;
  * openings: ζ-dots on the column shards, then all-gathered;
  * DEEP codeword and FRI: row-sharded (``dist_fri``); the final polynomial
    and the grind replicated;
  * query openings: masked sums (``dist_fri.gather_sharded_opening``).

JAX runs one host program; here each rank runs the same program on its own
card (SPMD): every rank keeps the whole Fiat–Shamir transcript on its own
``DuplexChallenger`` and observes the same replicated roots, openings and
final coefficients, so the ranks draw the same challenges and return the
same proof dict.  Values are int64 standard form, as in the rest of the
port.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..field import babybear as bb
from ..field import ext
from ..pcs.challenger import DuplexChallenger
from ..pcs.fri import final_coefficients
from ..pcs.merkle import build_levels
from ..stark.air import Air
from ..stark.config import StarkConfig
from ..stark.prover import (
    _domain_tables,
    coeffs_head,
    cols_at,
    constraint_fold,
    deep_body,
    lde_body,
    opened_digest_std,
    quotient_chunks,
)
from ..utils.packing import pack_u32
from .comm import all_gather, all_to_all, broadcast_object, ppermute
from .dist_fri import dist_fri_fold_half, dist_fri_round, gather_sharded_opening
from .dist_merkle import _cap_root
from .mesh import Axis, Mesh

P = bb.P


def _commit(mat: np.ndarray, config: StarkConfig, ax: Axis):
    """LDE of this rank's column block (the columns padded with zeros to a
    multiple of d), re-sharded to row blocks and committed.  Returns
    (column-sharded LDE (n_lde, wp/d), row block (s, w), subtree levels,
    cap levels).  Only this rank's columns are copied on the host."""
    n, w = mat.shape
    k = -(-w // ax.size)
    cols = mat[:, ax.index * k : min((ax.index + 1) * k, w)]
    block = np.zeros((n, k), dtype=np.int64)
    block[:, : cols.shape[1]] = cols
    lde_l = lde_body(torch.as_tensor(block, device=ax.device), config)
    rows = all_to_all(lde_l, ax, split_axis=0, concat_axis=1)[:, :w]
    levels = build_levels(rows)
    return lde_l, rows, levels, _cap_root(levels, ax, ax.size)


def _check_axis(n_lde: int, config: StarkConfig, ax: Axis) -> None:
    if n_lde % ax.size or n_lde // ax.size < config.blowup:
        raise ValueError(f"{n_lde} LDE rows do not split over {ax.size} ranks with a block "
                         f"of at least the blowup halo ({config.blowup} rows)")


def _precommit(air: Air, trace: np.ndarray, config: StarkConfig, ax: Axis) -> dict:
    n = trace.shape[0]
    _check_axis(n << config.log_blowup, config, ax)
    out = {"p": None}
    if air.preprocessed_width:
        out["p"] = _commit(np.asarray(air.preprocessed_trace(n)), config, ax)
    out["t"] = _commit(trace, config, ax)
    return out


def dist_precommit(air: Air, trace, config: StarkConfig, mesh: Mesh,
                   axis_name: str = "sp") -> dict:
    """The transcript-independent phases of ``dist_prove`` (preprocessed and
    trace LDE and commit), for ``dist_prove(..., precommit=...)``."""
    return _precommit(air, np.asarray(trace), config, mesh.axis(axis_name))


def _root(top: list) -> list:
    return [int(v) for v in top[-1][0].tolist()]


def _openings(air: Air, pre, t_lde_l, q_col_coeffs, zeta, gzeta, n: int, config: StarkConfig,
              ax: Axis) -> dict:
    """ζ-dots on the column shards, all-gathered and cut to the true widths
    (``_eval_cols_at``'s uint32 (w, 4) arrays)."""

    def at_both(lde_l, width):
        c = coeffs_head(lde_l, config.shift, n)
        vals = torch.cat([cols_at(c, zeta), cols_at(c, gzeta)], dim=1)  # (wp/d, 8)
        full = all_gather(vals, ax, axis=0, tiled=True)[:width].cpu().numpy()
        return full[:, : ext.D].astype(np.uint32), full[:, ext.D :].astype(np.uint32)

    out = {}
    out["t_zeta"], out["t_gzeta"] = at_both(t_lde_l, air.width)
    out["q_zeta"] = cols_at(q_col_coeffs, zeta).cpu().numpy().astype(np.uint32)
    if pre is not None:
        out["p_zeta"], out["p_gzeta"] = at_both(pre[0], air.preprocessed_width)
    return out


def _fri(codeword_l: torch.Tensor, n_lde: int, config: StarkConfig,
         challenger: DuplexChallenger, ax: Axis):
    """Commit and fold the row-sharded (s, 4) codeword; the final polynomial
    and the grind replicated.  Returns (roots, final coefficients, witness,
    [(pairs, levels, top, rows per round)])."""
    d = ax.size
    final_len = (1 << config.log_final_poly_len) * config.blowup
    shift_r = config.shift % P
    size, r = n_lde, 0
    roots, rounds = [], []
    cw = codeword_l
    while size > final_len:
        cur_log = size.bit_length() - 1
        v0, v1, pairs, levels, top = dist_fri_round(cw, r, ax)
        root = _root(top)
        roots.append(root)
        challenger.observe_many(root)
        beta = challenger.sample_ext()
        cw = dist_fri_fold_half(v0, v1, r, ax, shift_r, cur_log, beta)
        rounds.append((pairs, levels, top, size // 2))
        shift_r = shift_r * shift_r % P
        size //= 2
        r += 1
    g_r = max(1, d >> r)
    if g_r > 1:  # blocks 0..g_r − 1 of the ranks' copies make the codeword
        cw = all_gather(cw, ax, axis=0, tiled=True)[:size]
    final = final_coefficients(cw, shift_r, config.log_blowup)
    for c in final:
        challenger.observe_ext(c)
    return roots, final, challenger.grind(config.proof_of_work_bits), rounds


def _prove(air: Air, trace, public_values: Sequence[int], config: StarkConfig, ax: Axis,
           challenger: DuplexChallenger, precommit: dict | None) -> dict:
    trace = np.asarray(trace)
    n, width = trace.shape
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError("trace height must be a power of two")
    if width != air.width:
        raise ValueError("trace width does not match the AIR")
    publics = [int(v) % P for v in public_values]
    if len(publics) != air.num_public_values:
        raise ValueError("wrong number of public values")
    n_lde = n << config.log_blowup
    blowup = config.blowup
    d, dev = ax.size, ax.device
    s = n_lde // d
    if precommit is None:
        precommit = _precommit(air, trace, config, ax)
    pre, (t_lde_l, t_rows, t_levels, t_top) = precommit["p"], precommit["t"]

    challenger.observe(log_n)
    challenger.observe(width)
    challenger.observe_many(publics)
    if pre is not None:
        challenger.observe_many(_root(pre[3]))
    root_t = _root(t_top)
    challenger.observe_many(root_t)
    alpha = challenger.sample_ext()

    # 2.-3. quotient on row blocks (halo: the successor block's first rows),
    # then the 4-wide quotient gathered and its chunks committed replicated
    tables = _domain_tables(log_n, config.log_blowup, config.shift, dev)
    tl = {k: v[ax.index * s : (ax.index + 1) * s] for k, v in tables.items()}
    to_prev = [(p, (p - 1) % d) for p in range(d)]
    p_rows = pre[1] if pre is not None else t_rows.new_zeros((s, 0))
    halos = (ppermute(t_rows[:blowup], ax, to_prev),
             ppermute(p_rows[:blowup], ax, to_prev) if pre is not None else None)
    folded, count = constraint_fold(air, t_rows, p_rows, alpha, publics, tl, blowup, halos)
    quotient = all_gather(ext.mul_base(folded, tl["zh_inv"]), ax, axis=0, tiled=True)
    q_matrix, q_col_coeffs = quotient_chunks(quotient, log_n, config)
    q_rows = q_matrix[ax.index * s : (ax.index + 1) * s].clone()
    del quotient, q_matrix
    q_levels = build_levels(q_rows)
    q_top = _cap_root(q_levels, ax, d)
    root_q = _root(q_top)
    challenger.observe_many(root_q)
    zeta = challenger.sample_ext()
    gzeta = ext.s_mul_base(zeta, bb.two_adic_generator(log_n))

    # 4. openings at ζ and g·ζ; the transcript absorbs their Merkle digest
    opened = _openings(air, pre, t_lde_l, q_col_coeffs, zeta, gzeta, n, config, ax)
    challenger.observe_many(opened_digest_std(opened, dev))
    gamma = challenger.sample_ext()

    # 5. DEEP codeword on row blocks, 6. FRI
    G = deep_body(air, t_rows, p_rows, q_rows, opened, zeta, gzeta, gamma, tl, config)
    fri_roots, final, pow_witness, rounds = _fri(G, n_lde, config, challenger, ax)
    del G

    # 7. queries: the transcript's indices, openings by masked sums
    log_n0 = n_lde.bit_length() - 1
    indices = [challenger.sample_bits(log_n0 - 1) for _ in range(config.num_queries)]
    nq, half = len(indices), n_lde // 2
    trees = [("t", t_rows, t_levels, t_top), ("q", q_rows, q_levels, q_top)]
    if pre is not None:
        trees.insert(0, ("p", pre[1], pre[2], pre[3]))
    outer = {name: gather_sharded_opening(rows, levels, top, indices + [i + half for i in indices],
                                          ax)
             for name, rows, levels, top in trees}
    queries = [{"index": i, "rounds": []} for i in indices]
    idx = np.array(indices, dtype=np.int64)
    for pairs, levels, top, n_half in rounds:
        idx = idx % n_half
        row, path = gather_sharded_opening(pairs, levels, top, idx, ax)
        for qi in range(nq):
            queries[qi]["rounds"].append({"leaf": pack_u32(row[qi]), "path": pack_u32(path[qi])})

    openings = []
    for qi in range(nq):
        entry = {}
        for name, *_ in trees:
            row, path = outer[name]
            entry[name] = {
                "lo": {"row": pack_u32(row[qi]), "path": pack_u32(path[qi])},
                "hi": {"row": pack_u32(row[nq + qi]), "path": pack_u32(path[nq + qi])},
            }
        openings.append(entry)

    proof = {
        "version": 1,
        "log_n": log_n,
        "width": width,
        "public_values": publics,
        "root_t": root_t,
        "root_q": root_q,
        "opened_t_zeta": pack_u32(opened["t_zeta"]),
        "opened_t_gzeta": pack_u32(opened["t_gzeta"]),
        "opened_q_zeta": pack_u32(opened["q_zeta"]),
        "fri": {
            "roots": fri_roots,
            "final_coeffs": [list(c) for c in final],
            "pow_witness": pow_witness,
            "queries": queries,
            "log_n": log_n0,
        },
        "query_openings": openings,
        "constraint_count": count,
    }
    if pre is not None:
        proof["root_p"] = _root(pre[3])
        proof["opened_p_zeta"] = pack_u32(opened["p_zeta"])
        proof["opened_p_gzeta"] = pack_u32(opened["p_gzeta"])
    return proof


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
    return _prove(air, trace, public_values, config, mesh.axis(axis_name), challenger,
                  precommit)


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
    pres = [_precommit(air, trace, config, sub) if sub.index >= 0 else None
            for (air, trace, _), sub in zip(entries, subs)]
    challenger = DuplexChallenger(ax.device)
    proofs = []
    for i, ((air, trace, publics), sub) in enumerate(zip(entries, subs)):
        sent = None
        if sub.index >= 0:
            proof = _prove(air, trace, publics, config, sub, challenger, pres[i])
            sent = (proof, challenger.state, challenger.input_buffer, challenger.output_buffer)
        pres[i] = None
        proof, challenger.state, challenger.input_buffer, challenger.output_buffer = (
            broadcast_object(sent, ax, ax.ranks.index(sub.ranks[0])))
        proofs.append(proof)
    return proofs
