"""Uni-STARK verifier.

Port of ``dvt_circuits_tpu/stark/verifier.py``: replays the prover's
transcript, checks the DEEP-ALI identity C(ζ) = Q(ζ)·Z_H(ζ) with the AIR's
scalar ``eval`` over BB4, and verifies the batched FRI proof, binding the
FRI round-0 codeword to the committed trace, quotient and preprocessed
columns through the outer Merkle openings.

The transcript runs on the challenger's device (its permutations through
``poseidon2_permute``, kernel K1 on the card), and so do the batched
per-query parts: the Merkle walks of every opened row and the DEEP
codeword at the query points, as int64 tensors.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..field import babybear as bb
from ..field import ext
from ..pcs.challenger import DuplexChallenger
from ..pcs.fri import FriError, coset_points, field_rows, fri_verify
from ..pcs.merkle import verify_openings_batch
from ..utils import spans
from ..utils.packing import unpack_u32
from .air import Air, AirBuilder
from .config import StarkConfig
from .prover import opened_digest_std, preprocessed_commitment

P = bb.P


class StarkError(ValueError):
    pass


class VerifierBuilder(AirBuilder):
    """Constraint evaluation at the DEEP point ζ over BB4 scalars."""

    P = P

    def __init__(self, t_zeta, t_gzeta, publics, sels, alpha, p_zeta=(), p_gzeta=()):
        self._t_zeta = t_zeta
        self._t_gzeta = t_gzeta
        self._p_zeta = p_zeta
        self._p_gzeta = p_gzeta
        self._publics = publics
        self._sels = sels
        self._alpha = alpha
        self._alpha_pow = ext.S_ONE
        self._acc = ext.S_ZERO
        self.count = 0

    def _local(self, j):
        return self._t_zeta[j]

    def _next(self, j):
        return self._t_gzeta[j]

    def _pre(self, j):
        return self._p_zeta[j]

    def _pre_next(self, j):
        return self._p_gzeta[j]

    def _public(self, i):
        return ext.s_from_base(self._publics[i])

    def _const(self, c):
        return ext.s_from_base(c)

    def _add(self, a, b):
        return ext.s_add(a, b)

    def _sub(self, a, b):
        return ext.s_sub(a, b)

    def _mul(self, a, b):
        return ext.s_mul(a, b)

    def _sel_first(self):
        return self._sels["first"]

    def _sel_last(self):
        return self._sels["last"]

    def _sel_transition(self):
        return self._sels["transition"]

    def _accumulate(self, expr):
        # Σ αⁱ·cᵢ in assertion order (the prover's fold order)
        self._acc = ext.s_add(self._acc, ext.s_mul(self._alpha_pow, expr))
        self._alpha_pow = ext.s_mul(self._alpha_pow, self._alpha)
        self.count += 1


def _ext_rows(v) -> list:
    """Opened-value block: packed blob or nested list → BB4 tuples."""
    if isinstance(v, (bytes, bytearray)):
        v = unpack_u32(v).reshape(-1, 4)
    return [tuple(int(x) % P for x in row) for row in v]


def verify(
    air: Air,
    proof: dict,
    public_values: Sequence[int],
    config: StarkConfig,
    challenger: DuplexChallenger | None = None,
    device="cuda",
) -> bool:
    """Raises StarkError on any failure; returns True on success.

    ``challenger`` chains the replayed transcript of a multi-table proof
    (tables in the prover's order) and fixes the device; without one, a
    fresh challenger on ``device`` starts the transcript."""
    try:
        log_n = int(proof["log_n"])
        width = int(proof["width"])
        root_t = [int(v) for v in proof["root_t"]]
        root_q = [int(v) for v in proof["root_q"]]
        opened_t_zeta = _ext_rows(proof["opened_t_zeta"])
        opened_t_gzeta = _ext_rows(proof["opened_t_gzeta"])
        opened_q_zeta = _ext_rows(proof["opened_q_zeta"])
        fri_proof = proof["fri"]
        query_openings = proof["query_openings"]
    except (KeyError, TypeError, ValueError) as e:
        raise StarkError(f"malformed proof: {e}") from None

    if challenger is None:
        challenger = DuplexChallenger(device)
    dev = challenger.device
    publics = [int(v) % P for v in public_values]
    if len(publics) != air.num_public_values:
        raise StarkError("wrong number of public values")
    if width != air.width:
        raise StarkError("proof width does not match the AIR")
    if len(opened_t_zeta) != width or len(opened_t_gzeta) != width:
        raise StarkError("wrong number of trace openings")
    if len(opened_q_zeta) != 4 * config.blowup:
        raise StarkError("wrong number of quotient openings")

    n = 1 << log_n
    shift = config.shift
    log_blowup = config.log_blowup
    n_lde = n << log_blowup

    pre_width = air.preprocessed_width
    if pre_width:
        root_p = preprocessed_commitment(air, log_n, config, dev)
        if [int(v) for v in proof.get("root_p", [])] != root_p:
            raise StarkError("preprocessed commitment mismatch")
        opened_p_zeta = _ext_rows(proof["opened_p_zeta"])
        opened_p_gzeta = _ext_rows(proof["opened_p_gzeta"])
        if len(opened_p_zeta) != pre_width or len(opened_p_gzeta) != pre_width:
            raise StarkError("wrong number of preprocessed openings")
    else:
        root_p = None
        opened_p_zeta = []
        opened_p_gzeta = []

    challenger.observe(log_n)
    challenger.observe(width)
    challenger.observe_many(publics)
    if root_p is not None:
        challenger.observe_many(root_p)
    challenger.observe_many(root_t)
    alpha = challenger.sample_ext()
    challenger.observe_many(root_q)
    zeta = challenger.sample_ext()
    opened = {"t_zeta": opened_t_zeta, "t_gzeta": opened_t_gzeta, "q_zeta": opened_q_zeta}
    if pre_width:
        opened.update(p_zeta=opened_p_zeta, p_gzeta=opened_p_gzeta)
    challenger.observe_many(opened_digest_std(
        {k: np.asarray(v, dtype=np.int64).reshape(-1, ext.D) for k, v in opened.items()}, dev
    ))
    gamma = challenger.sample_ext()

    # --- DEEP-ALI identity at ζ -------------------------------------------
    zeta_n = ext.s_pow(zeta, n)
    z_h = ext.s_sub(zeta_n, ext.S_ONE)
    if ext.s_is_zero(z_h):
        raise StarkError("ζ landed in the trace domain")
    g = bb.two_adic_generator(log_n)
    g_last = pow(g, n - 1, P)
    denom_first = ext.s_sub(zeta, ext.S_ONE)
    denom_last = ext.s_sub(zeta, ext.s_from_base(g_last))
    sels = {
        "first": ext.s_mul(z_h, ext.s_inv(denom_first)),
        "last": ext.s_mul(z_h, ext.s_inv(denom_last)),
        "transition": denom_last,
    }
    builder = VerifierBuilder(
        opened_t_zeta, opened_t_gzeta, publics, sels, alpha, opened_p_zeta, opened_p_gzeta
    )
    air.eval(builder)
    if proof.get("constraint_count") not in (None, builder.count):
        raise StarkError("constraint count mismatch")

    # Q(ζ) = Σ_k ζ^{kN} · Q_k(ζ); Q_k = Σ_c e_c · coord_{k,c}
    q_zeta = ext.S_ZERO
    zeta_kn = ext.S_ONE
    for k in range(config.blowup):
        chunk_val = ext.S_ZERO
        for c in range(4):
            basis = tuple(1 if i == c else 0 for i in range(4))
            chunk_val = ext.s_add(chunk_val, ext.s_mul(basis, opened_q_zeta[4 * k + c]))
        q_zeta = ext.s_add(q_zeta, ext.s_mul(zeta_kn, chunk_val))
        zeta_kn = ext.s_mul(zeta_kn, zeta_n)

    if builder._acc != ext.s_mul(q_zeta, z_h):
        raise StarkError("constraint quotient identity failed at ζ")

    # --- FRI + outer-opening binding (batched across queries) --------------
    gzeta = ext.s_mul_base(zeta, g)
    half = n_lde // 2
    nq = config.num_queries
    total = 2 * pre_width + 2 * width + 4 * config.blowup
    gp = ext.powers(gamma, total, dev)  # (total, 4)

    if len(query_openings) != nq:
        raise StarkError("wrong number of outer openings")

    # γ-power index groups (the prover's DEEP order): p@ζ, p@gζ, t@ζ,
    # t@gζ, q@ζ
    z_idx = (
        list(range(0, pre_width))
        + list(range(2 * pre_width, 2 * pre_width + width))
        + list(range(2 * pre_width + 2 * width, total))
    )
    gz_idx = list(range(pre_width, 2 * pre_width)) + list(
        range(2 * pre_width + width, 2 * pre_width + 2 * width)
    )

    def fold_opened(idx_list, opened_list):
        """Σ γ^i·oᵢ over BB4 opened values — query-independent, done once."""
        if not idx_list:
            return torch.zeros(ext.D, dtype=torch.int64, device=dev)
        o = torch.tensor(opened_list, dtype=torch.int64, device=dev).reshape(-1, ext.D)
        return ext.mul(gp[idx_list], o).sum(dim=0) % P

    fold_o_z = fold_opened(z_idx, list(opened_p_zeta) + opened_t_zeta + opened_q_zeta)
    fold_o_gz = fold_opened(gz_idx, list(opened_p_gzeta) + opened_t_gzeta)

    def fold_cols(rows_list, idx_list):
        """Σ γ^i·colᵢ per query: base-field rows (nq, m) → (nq, 4)."""
        rows = torch.cat(rows_list, dim=1)
        coeff = gp[idx_list]  # (m, 4)
        return torch.stack(
            [(rows * coeff[:, c] % P).sum(dim=1) % P for c in range(ext.D)], dim=1
        )

    def open_input_batch(indices, v0s, v1s):
        matrices = [("t", root_t, width), ("q", root_q, 4 * config.blowup)]
        if pre_width:
            matrices.insert(0, ("p", root_p, pre_width))
        rows_of = {}
        for name, root, wid in matrices:
            for part, idxs in (("lo", indices), ("hi", [i + half for i in indices])):
                rows = field_rows([qo[name][part]["row"] for qo in query_openings], (nq, wid),
                                  "malformed outer opening row", dev)
                paths = field_rows([qo[name][part]["path"] for qo in query_openings],
                                   (nq, log_n + log_blowup, 8), "malformed outer opening path", dev)
                if not verify_openings_batch(root, idxs, rows, paths):
                    raise FriError(f"bad outer Merkle opening ({name}/{part})")
                rows_of[(name, part)] = rows

        empty = torch.zeros((nq, 0), dtype=torch.int64, device=dev)
        for part, idxs, vals in (("lo", indices, v0s), ("hi", [i + half for i in indices], v1s)):
            p_rows = rows_of.get(("p", part), empty)
            t_rows, q_rows = rows_of[("t", part)], rows_of[("q", part)]
            x4 = ext.from_base(coset_points(shift, log_n + log_blowup, idxs, dev))
            inv_z = ext.inv(ext.sub(x4, ext.tensor(zeta, dev)))
            num_z = ext.sub(fold_cols([p_rows, t_rows, q_rows], z_idx), fold_o_z)
            G = ext.mul(num_z, inv_z)
            if gz_idx:
                inv_gz = ext.inv(ext.sub(x4, ext.tensor(gzeta, dev)))
                num_gz = ext.sub(fold_cols([p_rows, t_rows], gz_idx), fold_o_gz)
                G = ext.add(G, ext.mul(num_gz, inv_gz))
            spans.host_read(1)  # torch.equal's one boolean
            if not torch.equal(G, vals):
                raise FriError(f"DEEP codeword mismatch ({part})")

    try:
        fri_verify(fri_proof, shift, log_n + log_blowup, config.fri, challenger, open_input_batch)
    except FriError as e:
        raise StarkError(f"FRI verification failed: {e}") from None

    return True
