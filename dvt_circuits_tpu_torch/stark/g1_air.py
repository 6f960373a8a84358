"""BLS12-381 G1 program chip: the DKG share check in-circuit.

Proves, inside one BabyBear STARK table, the curve relation at the heart of
the bad-share circuit (reference verification.rs:107-118 / SURVEY.md §3.1):

    pk     = sk·G                      (fixed-base scalar multiplication)
    poly   = Σ_j id^j·C_j              (Feldman verification-vector Horner
                                        evaluation, dkg_math.rs:160-174)

and exposes both results (affine, plus point-at-infinity flags) as public
values, together with the sk bytes, id bytes and C_j coordinates they were
computed from.  The verifier compares the two results to decide the
valid/slashable outcome and binds the exposed inputs to the SHA-256 gadget
table's preimages (prover/pipeline.py), closing the "curve relations are
not in-circuit" trust gap of proof v4.

Design (one wide row per curve operation — built on stark/bigfield.py):

  * row types: LADDER (Jacobian double + conditional mixed-add, one scalar
    bit), ADD (mixed-add with forced bit 1), NORM (normalize the Horner
    accumulator to affine so it can become the next ladder operand), FINAL
    (normalize both results and bind them to public values);
  * 19 MUL gadgets + 7 RED gadgets per row, with row-type-selected input
    wiring (Σ flag_t·form_t — degree 2 inputs, degree-4 identities);
  * two accumulator registers: `acc` (the active chain) and `saved` (the
    finished sk·G result, copied through the Horner phase) — wiring stays
    uniform because only one chain is ever active;
  * the scalar enters as committed per-row bits with a per-byte running
    accumulator bound to the public sk/id bytes at byte boundaries (the
    cross-row binding pattern; arbitrary-row access would need a lookup
    argument, which the single-phase prover deliberately avoids);
  * exceptional madd cases: identity handled branchlessly via `inf` flags;
    an x-collision (adding P to ±P) is made UNPROVABLE by the H·H⁻¹ = 1
    guard rather than silently wrong — a conscious divergence from the
    reference's complete (branching) Rust formulas, possible only for
    adversarially crafted scenarios (documented in README).

Schedule for k coefficients (Horner: res = id·res + C_j):
  sk_bits × LADDER (operand = G, result → saved)
  ADD C_{k−1}
  for j = k−2 .. 0:  NORM, id_bits × LADDER (operand = affine(res)), ADD C_j
  FINAL

Constraint emission order (the contract between ``eval`` — verifier — and
``eval_tensor`` — prover; groups A..N, see _emit docstrings).

Copied from ``dvt_circuits_tpu/stark/g1_air.py``; ``eval_tensor``, the
prover's path, is ported to int64 PyTorch ops in standard form (the
verifier replays the scalar ``eval`` at ζ).  No prove path of either
package emits this table; the verifier's legacy ``g1`` gadget kind reads it
(``prover/pipeline.py:_verify_g1_gadget``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..field.babybear import P as P_BB
from ..hostcrypto.bls12_381 import G1_GEN, P as P_INT
from .air import Air
from . import bigfield as bf
from .g1mul_air import _KMUL, _KRED  # the bigfield identities' carry-offset constants
from .bigfield import (
    Form,
    MUL_CARRIES,
    MUL_CARRY_CRUMBS,
    MUL_CARRY_OFFSET,
    MUL_OUT,
    NLIMBS,
    RED_CARRIES,
    RED_CARRY_CRUMBS,
    RED_CARRY_OFFSET,
    RED_OUT,
    RED_Q_CRUMBS,
    VALUE_CRUMBS,
)

# -- value slots -------------------------------------------------------------
ACCX, ACCY, ACCZ = 0, 1, 2
SAVX, SAVY, SAVZ = 3, 4, 5
OPX, OPY = 6, 7
HINV, ZINVA, ZINVB = 8, 9, 10
NUM_MULS = 19
NUM_REDS = 7
MR0 = 11  # 19 mul r slots
MQ0 = MR0 + NUM_MULS  # 19 mul q slots
RR0 = MQ0 + NUM_MULS  # 7 red r slots
NV = RR0 + NUM_REDS  # 56

# -- column regions ----------------------------------------------------------
MC0 = NV * VALUE_CRUMBS  # mul carry crumbs
RQ0 = MC0 + NUM_MULS * MUL_CARRIES * MUL_CARRY_CRUMBS
RC0 = RQ0 + NUM_REDS * RED_Q_CRUMBS
B_COL = RC0 + NUM_REDS * RED_CARRIES * RED_CARRY_CRUMBS
S_COL = B_COL + 1
INF_COL = B_COL + 2
INFS_COL = B_COL + 3
WIDTH = B_COL + 4

NUM_CRUMB_COLS = B_COL  # every column below B_COL is a 2-bit crumb


def MR(i: int) -> int:
    return MR0 + i


def RR(i: int) -> int:
    return RR0 + i


def F(*terms, const: int = 0) -> Form:
    return Form(tuple(terms), const)


_P = P_INT
_HF_LAD = F((MR(8), 1), (RR(0), -1), const=_P)  # H = U2 − X1(=dX3), +p
_HF_ADD = F((MR(8), 1), (ACCX, -1), const=_P)

#: mul wiring: gadget index → row type → (form_a, form_b).
#: LADDER doubles acc (muls 0-6 / reds 0-2, dbl-2009-l with (X+B)² folded to
#: 4XB) then mixed-adds the operand to the doubled point D (muls 7-18 / reds
#: 3-6, madd-2007-bl); ADD mixed-adds the operand to acc directly; NORM and
#: FINAL are the 5-mul Jacobian→affine normalization per point.
MUL_FORMS: List[Dict[str, Tuple[Form, Form]]] = [dict() for _ in range(NUM_MULS)]
RED_FORMS: List[Dict[str, Form]] = [dict() for _ in range(NUM_REDS)]


def _set(g: int, t: str, fa: Form, fb: Form) -> None:
    MUL_FORMS[g][t] = (fa, fb)


def _setr(g: int, t: str, f: Form) -> None:
    RED_FORMS[g][t] = f


# LADDER: A=X², B=Y², C=B², M=X·B, A2=A², P1=A·(4M−dX3+p), YZ=Y·Z
_set(0, "ladder", F((ACCX, 1)), F((ACCX, 1)))
_set(1, "ladder", F((ACCY, 1)), F((ACCY, 1)))
_set(2, "ladder", F((MR(1), 1)), F((MR(1), 1)))
_set(3, "ladder", F((ACCX, 1)), F((MR(1), 1)))
_set(4, "ladder", F((MR(0), 1)), F((MR(0), 1)))
_set(5, "ladder", F((MR(0), 1)), F((MR(3), 4), (RR(0), -1), const=_P))
_set(6, "ladder", F((ACCY, 1)), F((ACCZ, 1)))
# LADDER madd on D=(dX3,dY3,dZ3): Z1Z1=dZ3², U2=Px·Z1Z1, T1=Py·dZ3,
# S2=T1·Z1Z1, HH=H², JH=H·HH, R2=rr², V=X1·4HH, P2=rr·(V−mX3+p), P3=Y1·JH,
# ZH=Z1·H, HI=H·H⁻¹ (the x-collision guard)
_set(7, "ladder", F((RR(2), 1)), F((RR(2), 1)))
_set(8, "ladder", F((OPX, 1)), F((MR(7), 1)))
_set(9, "ladder", F((OPY, 1)), F((RR(2), 1)))
_set(10, "ladder", F((MR(9), 1)), F((MR(7), 1)))
_set(11, "ladder", _HF_LAD, _HF_LAD)
_set(12, "ladder", _HF_LAD, F((MR(11), 1)))
_set(13, "ladder", F((RR(3), 1)), F((RR(3), 1)))
_set(14, "ladder", F((RR(0), 1)), F((MR(11), 4)))
_set(15, "ladder", F((RR(3), 1)), F((MR(14), 1), (RR(4), -1), const=_P))
_set(16, "ladder", F((RR(1), 1)), F((MR(12), 1)))
_set(17, "ladder", F((RR(2), 1)), _HF_LAD)
_set(18, "ladder", _HF_LAD, F((HINV, 1)))
_setr(0, "ladder", F((MR(4), 9), (MR(3), -8), const=8 * _P))  # dX3 = 9A2−8M
_setr(1, "ladder", F((MR(5), 3), (MR(2), -8), const=8 * _P))  # dY3 = 3P1−8C
_setr(2, "ladder", F((MR(6), 2)))  # dZ3 = 2YZ
_setr(3, "ladder", F((MR(10), 2), (RR(1), -2), const=2 * _P))  # rr = 2(S2−Y1)
_setr(4, "ladder", F((MR(13), 1), (MR(12), -4), (MR(14), -2), const=6 * _P))
_setr(5, "ladder", F((MR(15), 1), (MR(16), -8), const=8 * _P))  # mY3 = P2−8P3
_setr(6, "ladder", F((MR(17), 2)))  # mZ3 = 2ZH

# ADD: madd acts on acc itself (dbl half idle)
_set(7, "add", F((ACCZ, 1)), F((ACCZ, 1)))
_set(8, "add", F((OPX, 1)), F((MR(7), 1)))
_set(9, "add", F((OPY, 1)), F((ACCZ, 1)))
_set(10, "add", F((MR(9), 1)), F((MR(7), 1)))
_set(11, "add", _HF_ADD, _HF_ADD)
_set(12, "add", _HF_ADD, F((MR(11), 1)))
_set(13, "add", F((RR(3), 1)), F((RR(3), 1)))
_set(14, "add", F((ACCX, 1)), F((MR(11), 4)))
_set(15, "add", F((RR(3), 1)), F((MR(14), 1), (RR(4), -1), const=_P))
_set(16, "add", F((ACCY, 1)), F((MR(12), 1)))
_set(17, "add", F((ACCZ, 1)), _HF_ADD)
_set(18, "add", _HF_ADD, F((HINV, 1)))
_setr(3, "add", F((MR(10), 2), (ACCY, -2), const=2 * _P))
_setr(4, "add", RED_FORMS[4]["ladder"])
_setr(5, "add", RED_FORMS[5]["ladder"])
_setr(6, "add", RED_FORMS[6]["ladder"])

# NORM: ZI=Z·zinv (=1), Z2=zinv², OX=X·Z2, Z3=Z2·zinv, OY=Y·Z3
_set(0, "norm", F((ACCZ, 1)), F((ZINVA, 1)))
_set(1, "norm", F((ZINVA, 1)), F((ZINVA, 1)))
_set(2, "norm", F((ACCX, 1)), F((MR(1), 1)))
_set(3, "norm", F((MR(1), 1)), F((ZINVA, 1)))
_set(4, "norm", F((ACCY, 1)), F((MR(3), 1)))

# FINAL: normalize saved (muls 0-4, zinvA) and acc (muls 5-9, zinvB)
_set(0, "final", F((SAVZ, 1)), F((ZINVA, 1)))
_set(1, "final", F((ZINVA, 1)), F((ZINVA, 1)))
_set(2, "final", F((SAVX, 1)), F((MR(1), 1)))
_set(3, "final", F((MR(1), 1)), F((ZINVA, 1)))
_set(4, "final", F((SAVY, 1)), F((MR(3), 1)))
_set(5, "final", F((ACCZ, 1)), F((ZINVB, 1)))
_set(6, "final", F((ZINVB, 1)), F((ZINVB, 1)))
_set(7, "final", F((ACCX, 1)), F((MR(6), 1)))
_set(8, "final", F((MR(6), 1)), F((ZINVB, 1)))
_set(9, "final", F((ACCY, 1)), F((MR(8), 1)))

for _g in range(NUM_MULS):
    bf.MulSpec(_g, MUL_FORMS[_g]).check_budget()
for _g in range(NUM_REDS):
    bf.RedSpec(_g, RED_FORMS[_g]).check_budget()

#: per-row-type gadget execution order for witness generation (topological)
EXEC_ORDER: Dict[str, List[Tuple[str, int]]] = {
    "ladder": [
        ("m", 0), ("m", 1), ("m", 2), ("m", 3), ("m", 4), ("m", 6),
        ("r", 0), ("m", 5), ("r", 1), ("r", 2),
        ("m", 7), ("m", 8), ("m", 9), ("m", 10),
        ("hinv", 0), ("m", 11), ("m", 12), ("r", 3), ("m", 13), ("m", 14),
        ("r", 4), ("m", 15), ("m", 16), ("m", 17), ("m", 18), ("r", 5), ("r", 6),
    ],
    "add": [
        ("m", 7), ("m", 8), ("m", 9), ("m", 10),
        ("hinv", 0), ("m", 11), ("m", 12), ("r", 3), ("m", 13), ("m", 14),
        ("r", 4), ("m", 15), ("m", 16), ("m", 17), ("m", 18), ("r", 5), ("r", 6),
    ],
    "norm": [("zinva", 0), ("m", 0), ("m", 1), ("m", 2), ("m", 3), ("m", 4)],
    "final": [
        ("zinva", 0), ("m", 0), ("m", 1), ("m", 2), ("m", 3), ("m", 4),
        ("zinvb", 0), ("m", 5), ("m", 6), ("m", 7), ("m", 8), ("m", 9),
    ],
    "pad": [],
}

# -- preprocessed column indices --------------------------------------------
(
    PF_LADDER, PF_ADD, PF_NORM, PF_FINAL, PF_SWITCH, PF_CONT,
    PF_SCOPY, PF_BYTESTART, PF_SCONT, PF_OPG, PF_OPCOPY,
) = range(11)
PF_FIXED = 11

ONE_LIMBS = tuple([1] + [0] * (NLIMBS - 1))
GX_LIMBS = tuple(bf.int_to_limbs(G1_GEN[0]))
GY_LIMBS = tuple(bf.int_to_limbs(G1_GEN[1]))

TYPES = ("ladder", "add", "norm", "final")
TYPE_FLAG = {"ladder": PF_LADDER, "add": PF_ADD, "norm": PF_NORM, "final": PF_FINAL}

#: crumb columns checked per ``assert_group`` of group A (one temporary of
#: (rows, _CRUMB_BLOCK) int64 at a time)
_CRUMB_BLOCK = 4096


class G1PolyAir(Air):
    """G1 scalar-mul + Feldman-Horner chip (see module docstring).

    Parameters: ``k`` polynomial coefficients (committee threshold), and the
    scalar widths — production uses sk_bits=256 / id_bits=32 (the reference's
    secret width and ``bls_id_from_u32`` id width, bls_keys.rs:244-273);
    tests shrink them for cheap CPU traces.
    """

    width = WIDTH

    def __init__(self, k: int, sk_bits: int = 256, id_bits: int = 32):
        assert k >= 2 and sk_bits % 8 == 0 and id_bits % 8 == 0
        self.k = k
        self.sk_bits = sk_bits
        self.id_bits = id_bits
        self.sk_bytes = sk_bits // 8
        self.id_bytes = id_bits // 8
        self.preprocessed_width = PF_FIXED + k + self.sk_bytes + self.id_bytes
        # publics: sk bytes ‖ id bytes ‖ k×(x,y) limbs ‖ (inf,x,y) ×2 results
        self.c_base = self.sk_bytes + self.id_bytes
        self.oa_base = self.c_base + 2 * NLIMBS * k
        self.ob_base = self.oa_base + 1 + 2 * NLIMBS
        self.num_public_values = self.ob_base + 1 + 2 * NLIMBS
        self.rows = self._schedule()
        self.min_rows = len(self.rows)
        self.log_rows = (self.min_rows - 1).bit_length()

    def cache_key(self):
        return (type(self).__module__, type(self).__qualname__, self.k,
                self.sk_bits, self.id_bits)

    # -- schedule -----------------------------------------------------------

    def _schedule(self) -> List[dict]:
        """Row plan: list of {t: type, ...per-type metadata}."""
        rows: List[dict] = []
        for i in range(self.sk_bits):
            rows.append({"t": "ladder", "seg": "A", "i": i})
        rows.append({"t": "add", "cj": self.k - 1})
        for j in range(self.k - 2, -1, -1):
            rows.append({"t": "norm"})
            for i in range(self.id_bits):
                rows.append({"t": "ladder", "seg": "B", "i": i})
            rows.append({"t": "add", "cj": j})
        rows.append({"t": "final"})
        return rows

    def preprocessed_trace(self, n: int):
        assert n >= self.min_rows
        pre = np.zeros((n, self.preprocessed_width), dtype=np.uint32)
        switch_row = self.sk_bits - 1
        final_row = self.min_rows - 1
        for r, row in enumerate(self.rows):
            t = row["t"]
            pre[r, TYPE_FLAG[t]] = 1
            if t in ("ladder", "add"):
                if r == switch_row:
                    pre[r, PF_SWITCH] = 1
                else:
                    pre[r, PF_CONT] = 1
            if r != switch_row and r < final_row:
                pre[r, PF_SCOPY] = 1
            if t == "ladder":
                i = row["i"]
                if i % 8 == 0:
                    pre[r, PF_BYTESTART] = 1
                if i % 8 != 7:
                    pre[r, PF_SCONT] = 1
                if row["seg"] == "A":
                    pre[r, PF_OPG] = 1
                    if i % 8 == 7:
                        pre[r, PF_FIXED + self.k + i // 8] = 1
                else:
                    # operand written by the preceding NORM, copied along
                    if i < self.id_bits - 1:
                        pre[r, PF_OPCOPY] = 1
                    if i % 8 == 7:
                        pre[r, PF_FIXED + self.k + self.sk_bytes + i // 8] = 1
            elif t == "add":
                pre[r, PF_FIXED + row["cj"]] = 1
        return pre

    # -- witness generation -------------------------------------------------

    def generate_trace(
        self, sk_bytes: bytes, id_val: int, c_points: Sequence[Tuple[int, int]]
    ):
        """Build (trace, publics) from the scenario inputs.

        ``sk_bytes``: big-endian scalar (sk_bits/8 bytes); ``id_val``: the
        share id (index+1, < 2^id_bits); ``c_points``: k affine verification-
        vector points (x, y) ints (order C_0..C_{k−1}, dkg_math.rs Horner
        order).  Raises ValueError on the documented unprovable pathologies
        (x-collision, Horner accumulator at infinity mid-chain).
        """
        assert len(sk_bytes) == self.sk_bytes and len(c_points) == self.k
        assert 0 <= id_val < (1 << self.id_bits)
        sk_int = int.from_bytes(sk_bytes, "big")
        n = 1 << self.log_rows
        slots = np.zeros((n, NV), dtype=object)
        for r in range(n):
            for s in range(NV):
                slots[r, s] = 0
        bits = np.zeros(n, dtype=np.uint32)
        s_acc = np.zeros(n, dtype=np.uint32)
        infc = np.zeros(n, dtype=np.uint32)
        infsc = np.zeros(n, dtype=np.uint32)

        acc = (0, 1, 0)
        inf = 1
        saved = (0, 0, 0)
        infs = 0
        operand = G1_GEN
        s_run = 0
        switch_row = self.sk_bits - 1

        for r, row in enumerate(self.rows):
            t = row["t"]
            env = slots[r]
            env[ACCX], env[ACCY], env[ACCZ] = acc
            env[SAVX], env[SAVY], env[SAVZ] = saved
            infc[r] = inf
            infsc[r] = infs
            if t == "ladder":
                seg = row["seg"]
                i = row["i"]
                if seg == "A":
                    operand = G1_GEN
                    b = (sk_int >> (self.sk_bits - 1 - i)) & 1
                else:
                    b = (id_val >> (self.id_bits - 1 - i)) & 1
                bits[r] = b
                s_run = b if i % 8 == 0 else 2 * s_run + b
                s_acc[r] = s_run
            elif t == "add":
                operand = c_points[row["cj"]]
                b = 1
                bits[r] = 1
            env[OPX], env[OPY] = operand

            self._exec_row(t, env, bits[r], inf)

            # state transition (host mirror of the selection constraints)
            if t in ("ladder", "add"):
                b = bits[r]
                if b:
                    if inf:
                        nxt, ninf = (operand[0], operand[1], 1), 0
                    else:
                        nxt = (env[RR(4)], env[RR(5)], env[RR(6)])
                        ninf = 0
                else:
                    nxt = (env[RR(0)], env[RR(1)], env[RR(2)])
                    ninf = inf
                if r == switch_row:
                    saved, infs = nxt, ninf
                    acc, inf = (0, 1, 0), 1
                else:
                    acc, inf = nxt, ninf
            elif t == "norm":
                operand = (env[MR(2)], env[MR(4)])
                acc, inf = (0, 1, 0), 1

        # batch the (q, r, carry) witnesses per gadget.  Carries must be
        # computed against the RAW form limb columns the constraints see
        # (linear combinations of committed limbs + constants, uncarried),
        # not the canonical limbs of the integer values.
        trace = np.zeros((n, WIDTH), dtype=np.uint32)
        type_of = [row["t"] for row in self.rows] + ["pad"] * (n - self.min_rows)
        L = np.zeros((n, NV, NLIMBS), dtype=np.int64)
        for s in range(NV):
            L[:, s] = bf.ints_to_limb_rows([slots[r][s] for r in range(n)])
        type_rows = {
            t: np.array([i for i, tt in enumerate(type_of) if tt == t], dtype=int)
            for t in TYPES
        }

        def raw_limbs(by_type, which, nl):
            out = np.zeros((n, nl), dtype=np.int64)
            for t, f in by_type.items():
                form = f[which] if which is not None else f
                rows = type_rows[t]
                if len(rows) == 0:
                    continue
                acc = np.zeros((len(rows), nl), dtype=np.int64)
                for slot, coeff in form.terms:
                    acc[:, :NLIMBS] += coeff * L[rows, slot]
                if form.const:
                    acc += np.asarray(form.const_limbs(nl), dtype=np.int64)[None]
                out[rows] = acc
            return out

        for g in range(NUM_MULS):
            a_ints, b_ints = [], []
            for r in range(n):
                forms = MUL_FORMS[g].get(type_of[r])
                if forms is None:
                    a_ints.append(0)
                    b_ints.append(0)
                else:
                    a_ints.append(forms[0].eval_int(slots[r]))
                    b_ints.append(forms[1].eval_int(slots[r]))
            q_ints, r_ints, carries = bf.mul_witness_rows(
                a_ints,
                b_ints,
                raw_limbs(MUL_FORMS[g], 0, NLIMBS),
                raw_limbs(MUL_FORMS[g], 1, NLIMBS),
            )
            for r in range(n):
                assert r_ints[r] == slots[r][MR(g)], (g, r)
                slots[r][MQ0 + g] = q_ints[r]
            L[:, MQ0 + g] = bf.ints_to_limb_rows(q_ints)
            base = MC0 + g * MUL_CARRIES * MUL_CARRY_CRUMBS
            trace[:, base : base + MUL_CARRIES * MUL_CARRY_CRUMBS] = (
                bf.small_to_crumbs(carries, MUL_CARRY_CRUMBS).reshape(n, -1)
            )
        for g in range(NUM_REDS):
            f_ints = []
            for r in range(n):
                form = RED_FORMS[g].get(type_of[r])
                f_ints.append(0 if form is None else form.eval_int(slots[r]))
            q_small, r_ints, carries = bf.red_witness_rows(
                f_ints, raw_limbs(RED_FORMS[g], None, RED_OUT)
            )
            for r in range(n):
                assert r_ints[r] == slots[r][RR(g)], (g, r)
            qb = RQ0 + g * RED_Q_CRUMBS
            trace[:, qb : qb + RED_Q_CRUMBS] = bf.small_to_crumbs(
                q_small, RED_Q_CRUMBS
            )
            cb = RC0 + g * RED_CARRIES * RED_CARRY_CRUMBS
            trace[:, cb : cb + RED_CARRIES * RED_CARRY_CRUMBS] = (
                bf.small_to_crumbs(carries, RED_CARRY_CRUMBS).reshape(n, -1)
            )

        # value-slot crumbs straight from the (already updated) limb matrix
        trace[:, : NV * VALUE_CRUMBS] = bf.limbs_to_crumbs(L).reshape(n, -1)
        trace[:, B_COL] = bits
        trace[:, S_COL] = s_acc
        trace[:, INF_COL] = infc
        trace[:, INFS_COL] = infsc

        publics = self._publics(sk_bytes, id_val, c_points, slots, infc, infsc)
        return trace, publics

    def _publics(self, sk_bytes, id_val, c_points, slots, infc, infsc):
        pub = list(sk_bytes)
        pub += list(int(id_val).to_bytes(self.id_bytes, "big"))
        for (x, y) in c_points:
            pub += bf.int_to_limbs(x) + bf.int_to_limbs(y)
        fr = self.min_rows - 1  # FINAL row
        env = slots[fr]
        pub += [int(infsc[fr])] + bf.int_to_limbs(env[MR(2)]) + bf.int_to_limbs(
            env[MR(4)]
        )
        pub += [int(infc[fr])] + bf.int_to_limbs(env[MR(7)]) + bf.int_to_limbs(
            env[MR(9)]
        )
        assert len(pub) == self.num_public_values
        return pub

    def _exec_row(self, t: str, env, b: int, inf: int) -> None:
        """Run the row's gadget program on Python ints (mod p outputs)."""
        for kind, g in EXEC_ORDER[t]:
            if kind == "m":
                fa, fb = MUL_FORMS[g][t]
                a, bb_ = fa.eval_int(env), fb.eval_int(env)
                assert a >= 0 and bb_ >= 0, (t, g)
                env[MR(g)] = a * bb_ % P_INT
            elif kind == "r":
                fv = RED_FORMS[g][t].eval_int(env)
                assert fv >= 0, (t, g)
                env[RR(g)] = fv % P_INT
            elif kind == "hinv":
                hv = _hf_value(t, env)
                if b and not inf and hv % P_INT == 0:
                    raise ValueError(
                        "G1 chip: x-collision in mixed addition (adding ±P to "
                        "itself) — pathological input is unprovable by design"
                    )
                env[HINV] = pow(hv % P_INT, P_INT - 2, P_INT) if hv % P_INT else 0
            elif kind == "zinva":
                z = env[SAVZ] if t == "final" else env[ACCZ]
                if t == "norm" and (z % P_INT == 0 or inf):
                    raise ValueError(
                        "G1 chip: Horner accumulator at infinity mid-chain — "
                        "pathological input is unprovable by design"
                    )
                env[ZINVA] = pow(z % P_INT, P_INT - 2, P_INT) if z % P_INT else 0
            elif kind == "zinvb":
                z = env[ACCZ]
                env[ZINVB] = pow(z % P_INT, P_INT - 2, P_INT) if z % P_INT else 0

    # -- constraint evaluation ----------------------------------------------
    #
    # Emission order contract (both paths, checked by the prove/verify
    # round-trip and the constraint_count cross-check):
    #   A crumb checks (cols 0..B_COL, column order)     — degree 4
    #   B bit checks [b, inf, inf_saved]                 — degree 2
    #   C mul identities (gadget-major, k = 0..76)       — degree 4
    #   D red identities (gadget-major, k = 0..39)       — degree 3
    #   E x-collision guard (HI = 1, 39 limbs)           — degree 4
    #   F cont selection [next_acc − sel (117), next_inf − inf(1−b)] — deg 5
    #   G switch [next_sav − sel, next_acc − id, next_inf − 1, next_infs]
    #   H saved copy [next_sav − sav (117), next_infs − infs]
    #   I norm [inf=0, ZI=1, next_op, next_acc − id, next_inf − 1]
    #   J add rows force b = 1
    #   K operand binding [G const, copy, C_j publics (j ascending)]
    #   L scalar accumulator [bytestart, cont, boundary→public bytes]
    #   M first row [acc = identity (117), inf = 1]
    #   N final publics [infs, inf, ZIa, XAa, YAa, ZIb, XAb, YAb]

    def eval_tensor(self, tb):
        """Tensor path of the prover (``stark/prover.py:TensorBuilder``):
        groups A–N of the contract above in ``eval``'s α-power order, as
        int64 tensor ops over a block of LDE rows
        (``dvt_circuits_tpu/stark/g1_air.py:eval_tensor`` works the same
        groups in Montgomery uint32).  A group that the reference
        concatenates is asserted here in consecutive parts: the α powers run
        on.  Every constraint value is reduced to [0, p); a product of two
        values in (−p, p) stays below 2^62.  The crumb checks go in column
        blocks of ``_CRUMB_BLOCK``; each mul identity takes its gadget's
        39 × 39 limb products at once, each reduced, and sums them along the
        anti-diagonals k = i + j (at most 39 reduced terms, below 2^37)."""
        import torch

        P = P_BB
        X, NXT, PRE = tb.local, tb.next, tb.pre
        n = X.shape[0]
        dev = X.device
        pub = tb.publics
        pad = torch.nn.functional.pad

        def cvec(vals):
            return torch.tensor([int(v) % P for v in vals], dtype=torch.int64, device=dev)

        def gate(flag, v):
            """flag (rows,) times v (rows, k) with |v| < p, reduced."""
            return flag[:, None] * v % P

        ONE_L = cvec(ONE_LIMBS)
        PL = cvec(bf.P_LIMBS)
        PL40 = cvec(list(bf.P_LIMBS) + [0])
        limb_bits = 1 << bf.LIMB_BITS

        # A: crumbs ∈ {0,1,2,3}
        for c0 in range(0, B_COL, _CRUMB_BLOCK):
            cr = X[:, c0 : min(B_COL, c0 + _CRUMB_BLOCK)]
            tb.assert_group(cr * (cr - 1) % P * ((cr - 2) * (cr - 3) % P) % P)
        # B: bits
        bits3 = X[:, [B_COL, INF_COL, INFS_COL]]
        tb.assert_group(bits3 * (bits3 - 1) % P)

        def recomb(cols, shape, ncr):
            """Base-4 crumbs, lowest first → values: at most 10 products
            below 2^49, summed, then reduced."""
            pw = torch.tensor([1 << (2 * i) for i in range(ncr)], dtype=torch.int64, device=dev)
            return ((cols.reshape(n, -1, ncr) * pw).sum(dim=-1) % P).reshape((n,) + shape)

        vals = recomb(X[:, :MC0], (NV, NLIMBS), 5)
        # the next row's slots ACCX..OPY (0..7) are the only ones read
        vals_n = recomb(NXT[:, : (OPY + 1) * VALUE_CRUMBS], (OPY + 1, NLIMBS), 5)
        cm = recomb(X[:, MC0:RQ0], (NUM_MULS, MUL_CARRIES), MUL_CARRY_CRUMBS)
        qsm = recomb(X[:, RQ0:RC0], (NUM_REDS,), RED_Q_CRUMBS)
        rcm = recomb(X[:, RC0:B_COL], (NUM_REDS, RED_CARRIES), RED_CARRY_CRUMBS)

        flags = {t: PRE[:, TYPE_FLAG[t]] for t in TYPES}
        form_cache = {}

        def form_limbs(form: Form, nl: int):
            """Σ coeff·slot limbs + the constant's limbs, (rows, nl),
            reduced (cached per form)."""
            key = (form, nl)
            if key not in form_cache:
                acc = X.new_zeros((n, NLIMBS))
                for slot, coeff in form.terms:
                    acc = acc + vals[:, slot] * (coeff % P) % P
                if nl > NLIMBS:
                    acc = pad(acc, (0, nl - NLIMBS))
                if form.const:
                    acc = acc + cvec(form.const_limbs(nl))
                form_cache[key] = acc % P
            return form_cache[key]

        def effective(by_type, which, nl):
            """Σ_t flag_t·form_t of one gadget → (rows, nl), reduced."""
            acc = X.new_zeros((n, nl))
            for t, forms in by_type.items():
                acc += gate(flags[t], form_limbs(forms[which] if which is not None else forms, nl))
            return acc % P

        # C: mul identities, one gadget at a time (gadget-major)
        kmul, kred = cvec(_KMUL), cvec(_KRED)
        for g in range(NUM_MULS):
            a_eff = effective(MUL_FORMS[g], 0, NLIMBS)
            b_eff = effective(MUL_FORMS[g], 1, NLIMBS)
            prods = (a_eff[:, :, None] * b_eff[:, None, :] % P
                     - vals[:, MQ0 + g, :, None] * PL % P)  # (rows, i, j)
            # row i shifted right by i (padding to 2·39 columns and re-cutting
            # the flat rows at 77), then summed over i: t[k] = Σ_i prods[i, k − i]
            skew = pad(prods, (0, NLIMBS)).reshape(n, -1)
            t = skew[:, : NLIMBS * MUL_OUT].reshape(n, NLIMBS, MUL_OUT).sum(dim=1)
            t[:, :NLIMBS] -= vals[:, MR0 + g]
            t[:, 1:] += cm[:, g]
            t[:, :-1] -= cm[:, g] * limb_bits
            tb.assert_group((t + kmul) % P)

        # D: red identities
        for g in range(NUM_REDS):
            t = effective(RED_FORMS[g], None, RED_OUT) - qsm[:, g, None] * PL40 % P
            t[:, :NLIMBS] -= vals[:, RR0 + g]
            t[:, 1:] += rcm[:, g]
            t[:, :-1] -= rcm[:, g] * limb_bits
            tb.assert_group((t + kred) % P)

        b_, inf_, infs_ = X[:, B_COL], X[:, INF_COL], X[:, INFS_COL]
        trans = tb.sel_transition

        # E: guard
        bni = b_ * (1 - inf_) % P
        tb.assert_group(gate((flags["ladder"] + flags["add"]) * bni % P, vals[:, MR(18)] - ONE_L))

        # selection values
        bi = b_ * inf_ % P
        nb = (1 - b_) % P
        inf_nb = inf_ * nb % P
        sel = []
        for op_slot, madd_slot, dbl_slot in (
            (OPX, RR(4), RR(0)),
            (OPY, RR(5), RR(1)),
            (None, RR(6), RR(2)),
        ):
            opv = ONE_L[None, :] if op_slot is None else vals[:, op_slot]
            sel.append((gate(bi, opv) + gate(bni, vals[:, madd_slot])
                        + gate(nb, vals[:, dbl_slot])) % P)

        # F: cont selection → acc (+ inf transition)
        g_f = trans * PRE[:, PF_CONT] % P
        for ci, s in enumerate((ACCX, ACCY, ACCZ)):
            tb.assert_group(gate(g_f, vals_n[:, s] - sel[ci]))
        tb.assert_group(g_f * (NXT[:, INF_COL] - inf_nb) % P)

        # G: switch → saved
        g_g = trans * PRE[:, PF_SWITCH] % P
        for ci, s in enumerate((SAVX, SAVY, SAVZ)):
            tb.assert_group(gate(g_g, vals_n[:, s] - sel[ci]))
        tb.assert_group(gate(g_g, vals_n[:, ACCX]))
        tb.assert_group(gate(g_g, vals_n[:, ACCY] - ONE_L))
        tb.assert_group(gate(g_g, vals_n[:, ACCZ]))
        tb.assert_group(torch.stack([g_g * (NXT[:, INF_COL] - 1) % P,
                                     g_g * (NXT[:, INFS_COL] - inf_nb) % P], dim=1))

        # H: saved copy
        g_h = trans * PRE[:, PF_SCOPY] % P
        for s in (SAVX, SAVY, SAVZ):
            tb.assert_group(gate(g_h, vals_n[:, s] - vals[:, s]))
        tb.assert_group(g_h * (NXT[:, INFS_COL] - infs_) % P)

        # I: norm
        f_norm = flags["norm"]
        g_i = trans * f_norm % P
        tb.assert_group(f_norm * inf_ % P)
        tb.assert_group(gate(f_norm, vals[:, MR(0)] - ONE_L))
        tb.assert_group(gate(g_i, vals_n[:, OPX] - vals[:, MR(2)]))
        tb.assert_group(gate(g_i, vals_n[:, OPY] - vals[:, MR(4)]))
        tb.assert_group(gate(g_i, vals_n[:, ACCX]))
        tb.assert_group(gate(g_i, vals_n[:, ACCY] - ONE_L))
        tb.assert_group(gate(g_i, vals_n[:, ACCZ]))
        tb.assert_group(g_i * (NXT[:, INF_COL] - 1) % P)

        # J: add rows force b = 1
        tb.assert_group(flags["add"] * (b_ - 1) % P)

        # K: operand binding [G const, copy, C_j publics (j ascending)]
        op78 = torch.cat([vals[:, OPX], vals[:, OPY]], dim=1)
        op78n = torch.cat([vals_n[:, OPX], vals_n[:, OPY]], dim=1)
        tb.assert_group(gate(PRE[:, PF_OPG], op78 - cvec(GX_LIMBS + GY_LIMBS)))
        tb.assert_group(gate(trans * PRE[:, PF_OPCOPY] % P, op78n - op78))
        c_pub = pub[self.c_base : self.c_base + 2 * NLIMBS * self.k].reshape(self.k, 2 * NLIMBS)
        c_flags = PRE[:, PF_FIXED : PF_FIXED + self.k]
        tb.assert_group((c_flags[:, :, None] * (op78[:, None, :] - c_pub) % P).reshape(n, -1))

        # L: scalar accumulator [bytestart, cont, boundary → public bytes]
        s_ = X[:, S_COL]
        nbytes = self.sk_bytes + self.id_bytes
        tb.assert_group(torch.stack([
            PRE[:, PF_BYTESTART] * (s_ - b_) % P,
            trans * PRE[:, PF_SCONT] % P * ((NXT[:, S_COL] - 2 * s_ - NXT[:, B_COL]) % P) % P,
        ], dim=1))
        byte_flags = PRE[:, PF_FIXED + self.k : PF_FIXED + self.k + nbytes]
        tb.assert_group(byte_flags * (s_[:, None] - pub[:nbytes]) % P)

        # M: first row
        first = tb.sel_first
        tb.assert_group(gate(first, vals[:, ACCX]))
        tb.assert_group(gate(first, vals[:, ACCY] - ONE_L))
        tb.assert_group(gate(first, vals[:, ACCZ]))
        tb.assert_group(first * (inf_ - 1) % P)

        # N: final publics
        f_final = flags["final"]
        oa, ob = self.oa_base, self.ob_base
        ga = f_final * (1 - infs_) % P
        gb = f_final * (1 - inf_) % P
        tb.assert_group(torch.stack([f_final * (infs_ - pub[oa]) % P,
                                     f_final * (inf_ - pub[ob]) % P], dim=1))
        for gt, src, base in (
            (ga, MR(0), None),
            (ga, MR(2), oa + 1),
            (ga, MR(4), oa + 1 + NLIMBS),
            (gb, MR(5), None),
            (gb, MR(7), ob + 1),
            (gb, MR(9), ob + 1 + NLIMBS),
        ):
            tgt = ONE_L if base is None else pub[base : base + NLIMBS]
            tb.assert_group(gate(gt, vals[:, src] - tgt))

    def eval(self, b):
        """Scalar path (verifier at ζ / row debugger) — same order as
        ``eval_tensor``; Python loops over the identical wiring tables."""
        ONE = b.constant(1)

        # A: crumbs
        for col in range(B_COL):
            v = b.local(col)
            b.assert_zero_all(
                b.mul(
                    b.mul(v, b.sub(v, ONE)),
                    b.mul(b.sub(v, b.constant(2)), b.sub(v, b.constant(3))),
                )
            )
        # B: bits
        for col in (B_COL, INF_COL, INFS_COL):
            v = b.local(col)
            b.assert_zero_all(b.mul(v, b.sub(v, ONE)))

        pow4 = [b.constant(1 << (2 * i)) for i in range(MUL_CARRY_CRUMBS)]

        def combine(base, ncr):
            e = b.local(base)
            for cc in range(1, ncr):
                e = b.add(e, b.mul(pow4[cc], b.local(base + cc)))
            return e

        def combine_next(base, ncr):
            e = b.next(base)
            for cc in range(1, ncr):
                e = b.add(e, b.mul(pow4[cc], b.next(base + cc)))
            return e

        limbs = [
            [combine(s * VALUE_CRUMBS + i * 5, 5) for i in range(NLIMBS)]
            for s in range(NV)
        ]
        limbs_next = {
            s: [combine_next(s * VALUE_CRUMBS + i * 5, 5) for i in range(NLIMBS)]
            for s in (ACCX, ACCY, ACCZ, SAVX, SAVY, SAVZ, OPX, OPY)
        }
        flags = {t: b.preprocessed(TYPE_FLAG[t]) for t in TYPES}
        ZERO = b.constant(0)

        def form_limbs(form: Form, nl: int):
            cl = form.const_limbs(nl) if form.const else [0] * nl
            out = []
            for i in range(nl):
                e = b.constant(cl[i])
                for slot, coeff in form.terms:
                    if i < NLIMBS:
                        e = b.add(e, b.mul(b.constant(coeff), limbs[slot][i]))
                out.append(e)
            return out

        def effective(by_type, which, nl):
            out = [ZERO] * nl
            for t, forms in by_type.items():
                fl = form_limbs(forms[which] if which is not None else forms, nl)
                for i in range(nl):
                    out[i] = b.add(out[i], b.mul(flags[t], fl[i]))
            return out

        # C: mul identities
        two10 = b.constant(1 << bf.LIMB_BITS)
        for g in range(NUM_MULS):
            aeff = effective(MUL_FORMS[g], 0, NLIMBS)
            beff = effective(MUL_FORMS[g], 1, NLIMBS)
            qc = limbs[MQ0 + g]
            rc = limbs[MR0 + g]
            cmv = [
                combine(
                    MC0 + (g * MUL_CARRIES + kk) * MUL_CARRY_CRUMBS,
                    MUL_CARRY_CRUMBS,
                )
                for kk in range(MUL_CARRIES)
            ]
            for kk in range(MUL_OUT):
                e = ZERO
                kv = 0
                for i in range(max(0, kk - NLIMBS + 1), min(NLIMBS, kk + 1)):
                    e = b.add(e, b.mul(aeff[i], beff[kk - i]))
                    e = b.sub(e, b.mul(qc[i], b.constant(bf.P_LIMBS[kk - i])))
                if kk < NLIMBS:
                    e = b.sub(e, rc[kk])
                if kk >= 1:
                    e = b.add(e, cmv[kk - 1])
                    kv -= MUL_CARRY_OFFSET
                if kk <= MUL_OUT - 2:
                    e = b.sub(e, b.mul(two10, cmv[kk]))
                    kv += (1 << bf.LIMB_BITS) * MUL_CARRY_OFFSET
                b.assert_zero_all(b.add(e, b.constant(kv % P_BB)))

        # D: red identities
        for g in range(NUM_REDS):
            feff = effective(RED_FORMS[g], None, RED_OUT)
            qv = combine(RQ0 + g * RED_Q_CRUMBS, RED_Q_CRUMBS)
            rc = limbs[RR0 + g]
            rcv = [
                combine(
                    RC0 + (g * RED_CARRIES + kk) * RED_CARRY_CRUMBS,
                    RED_CARRY_CRUMBS,
                )
                for kk in range(RED_CARRIES)
            ]
            pl40 = list(bf.P_LIMBS) + [0]
            for kk in range(RED_OUT):
                e = b.sub(feff[kk], b.mul(qv, b.constant(pl40[kk])))
                kv = 0
                if kk < NLIMBS:
                    e = b.sub(e, rc[kk])
                if kk >= 1:
                    e = b.add(e, rcv[kk - 1])
                    kv -= RED_CARRY_OFFSET
                if kk <= RED_OUT - 2:
                    e = b.sub(e, b.mul(two10, rcv[kk]))
                    kv += (1 << bf.LIMB_BITS) * RED_CARRY_OFFSET
                b.assert_zero_all(b.add(e, b.constant(kv % P_BB)))

        bcol = b.local(B_COL)
        infcol = b.local(INF_COL)
        infscol = b.local(INFS_COL)

        # E: guard
        f_guard = b.add(flags["ladder"], flags["add"])
        gate = b.mul(f_guard, b.mul(bcol, b.sub(ONE, infcol)))
        one_l = list(ONE_LIMBS)
        for i in range(NLIMBS):
            b.assert_zero_all(
                b.mul(gate, b.sub(limbs[MR(18)][i], b.constant(one_l[i])))
            )

        # selection values
        bi = b.mul(bcol, infcol)
        bni = b.mul(bcol, b.sub(ONE, infcol))
        nb = b.sub(ONE, bcol)
        sel = []
        for op_slot, madd_slot, dbl_slot in (
            (OPX, RR(4), RR(0)),
            (OPY, RR(5), RR(1)),
            (None, RR(6), RR(2)),
        ):
            coord = []
            for i in range(NLIMBS):
                opv = b.constant(one_l[i]) if op_slot is None else limbs[op_slot][i]
                coord.append(
                    b.add(
                        b.add(b.mul(bi, opv), b.mul(bni, limbs[madd_slot][i])),
                        b.mul(nb, limbs[dbl_slot][i]),
                    )
                )
            sel.append(coord)

        # F: cont selection → acc (+ inf transition)
        f_cont = b.preprocessed(PF_CONT)
        for ci, s in enumerate((ACCX, ACCY, ACCZ)):
            for i in range(NLIMBS):
                b.assert_zero_transition(
                    b.mul(f_cont, b.sub(limbs_next[s][i], sel[ci][i]))
                )
        b.assert_zero_transition(
            b.mul(f_cont, b.sub(b.next(INF_COL), b.mul(infcol, nb)))
        )

        # G: switch
        f_sw = b.preprocessed(PF_SWITCH)
        for ci, s in enumerate((SAVX, SAVY, SAVZ)):
            for i in range(NLIMBS):
                b.assert_zero_transition(
                    b.mul(f_sw, b.sub(limbs_next[s][i], sel[ci][i]))
                )
        for s, tgt in ((ACCX, [0] * NLIMBS), (ACCY, one_l), (ACCZ, [0] * NLIMBS)):
            for i in range(NLIMBS):
                b.assert_zero_transition(
                    b.mul(f_sw, b.sub(limbs_next[s][i], b.constant(tgt[i])))
                )
        b.assert_zero_transition(b.mul(f_sw, b.sub(b.next(INF_COL), ONE)))
        b.assert_zero_transition(
            b.mul(f_sw, b.sub(b.next(INFS_COL), b.mul(infcol, nb)))
        )

        # H: saved copy
        f_sc = b.preprocessed(PF_SCOPY)
        for s in (SAVX, SAVY, SAVZ):
            for i in range(NLIMBS):
                b.assert_zero_transition(
                    b.mul(f_sc, b.sub(limbs_next[s][i], limbs[s][i]))
                )
        b.assert_zero_transition(b.mul(f_sc, b.sub(b.next(INFS_COL), infscol)))

        # I: norm
        f_norm = flags["norm"]
        b.assert_zero_all(b.mul(f_norm, infcol))
        for i in range(NLIMBS):
            b.assert_zero_all(
                b.mul(f_norm, b.sub(limbs[MR(0)][i], b.constant(one_l[i])))
            )
        for src, s in ((MR(2), OPX), (MR(4), OPY)):
            for i in range(NLIMBS):
                b.assert_zero_transition(
                    b.mul(f_norm, b.sub(limbs_next[s][i], limbs[src][i]))
                )
        for s, tgt in ((ACCX, [0] * NLIMBS), (ACCY, one_l), (ACCZ, [0] * NLIMBS)):
            for i in range(NLIMBS):
                b.assert_zero_transition(
                    b.mul(f_norm, b.sub(limbs_next[s][i], b.constant(tgt[i])))
                )
        b.assert_zero_transition(b.mul(f_norm, b.sub(b.next(INF_COL), ONE)))

        # J
        b.assert_zero_all(b.mul(flags["add"], b.sub(bcol, ONE)))

        # K: operand binding
        f_opg = b.preprocessed(PF_OPG)
        gl = list(GX_LIMBS) + list(GY_LIMBS)
        for idx in range(2 * NLIMBS):
            s, i = (OPX, idx) if idx < NLIMBS else (OPY, idx - NLIMBS)
            b.assert_zero_all(
                b.mul(f_opg, b.sub(limbs[s][i], b.constant(gl[idx])))
            )
        f_opc = b.preprocessed(PF_OPCOPY)
        for s in (OPX, OPY):
            for i in range(NLIMBS):
                b.assert_zero_transition(
                    b.mul(f_opc, b.sub(limbs_next[s][i], limbs[s][i]))
                )
        for j in range(self.k):
            f_j = b.preprocessed(PF_FIXED + j)
            cb = self.c_base + 2 * NLIMBS * j
            for idx in range(2 * NLIMBS):
                s, i = (OPX, idx) if idx < NLIMBS else (OPY, idx - NLIMBS)
                b.assert_zero_all(
                    b.mul(f_j, b.sub(limbs[s][i], b.public(cb + idx)))
                )

        # L: scalar accumulator
        scol = b.local(S_COL)
        b.assert_zero_all(
            b.mul(b.preprocessed(PF_BYTESTART), b.sub(scol, bcol))
        )
        b.assert_zero_transition(
            b.mul(
                b.preprocessed(PF_SCONT),
                b.sub(b.next(S_COL), b.add(b.add(scol, scol), b.next(B_COL))),
            )
        )
        for t in range(self.sk_bytes + self.id_bytes):
            b.assert_zero_all(
                b.mul(b.preprocessed(PF_FIXED + self.k + t), b.sub(scol, b.public(t)))
            )

        # M: first row
        for s, tgt in ((ACCX, [0] * NLIMBS), (ACCY, one_l), (ACCZ, [0] * NLIMBS)):
            for i in range(NLIMBS):
                b.assert_zero_first(b.sub(limbs[s][i], b.constant(tgt[i])))
        b.assert_zero_first(b.sub(infcol, ONE))

        # N: final publics
        f_final = flags["final"]
        oa, ob_ = self.oa_base, self.ob_base
        b.assert_zero_all(b.mul(f_final, b.sub(infscol, b.public(oa))))
        b.assert_zero_all(b.mul(f_final, b.sub(infcol, b.public(ob_))))
        ga = b.mul(f_final, b.sub(ONE, infscol))
        gb_ = b.mul(f_final, b.sub(ONE, infcol))
        for gate, src, pub_base in (
            (ga, MR(0), None),
            (ga, MR(2), oa + 1),
            (ga, MR(4), oa + 1 + NLIMBS),
            (gb_, MR(5), None),
            (gb_, MR(7), ob_ + 1),
            (gb_, MR(9), ob_ + 1 + NLIMBS),
        ):
            for i in range(NLIMBS):
                tgt = (
                    b.constant(one_l[i])
                    if pub_base is None
                    else b.public(pub_base + i)
                )
                b.assert_zero_all(b.mul(gate, b.sub(limbs[src][i], tgt)))

    # result helpers --------------------------------------------------------

    def out_points(self, publics: Sequence[int]):
        """((infA, xA, yA), (infB, xB, yB)) from a publics vector."""
        oa, ob = self.oa_base, self.ob_base
        return (
            (
                int(publics[oa]),
                bf.limbs_to_int(publics[oa + 1 : oa + 1 + NLIMBS]),
                bf.limbs_to_int(publics[oa + 1 + NLIMBS : oa + 1 + 2 * NLIMBS]),
            ),
            (
                int(publics[ob]),
                bf.limbs_to_int(publics[ob + 1 : ob + 1 + NLIMBS]),
                bf.limbs_to_int(publics[ob + 1 + NLIMBS : ob + 1 + 2 * NLIMBS]),
            ),
        )

    def check_publics(self, publics: Sequence[int]) -> None:
        """Host-side range/canonicity checks that make limb equality in the
        constraints equivalent to integer equality (cf. Sha256Air's 16-bit
        limb rule).  Curve/subgroup membership of the C_j inputs is the
        pipeline's responsibility (bound to SHA-proven compressed bytes)."""
        if len(publics) != self.num_public_values:
            raise ValueError("wrong number of public values")
        for i in range(self.c_base):
            if not 0 <= int(publics[i]) < 256:
                raise ValueError("public byte out of range")
        for i in range(self.c_base, len(publics)):
            if i in (self.oa_base, self.ob_base):
                if int(publics[i]) not in (0, 1):
                    raise ValueError("infinity flag not boolean")
            elif not 0 <= int(publics[i]) < (1 << bf.LIMB_BITS):
                raise ValueError("public limb out of range")
        for j in range(self.k):
            base = self.c_base + 2 * NLIMBS * j
            x = bf.limbs_to_int(publics[base : base + NLIMBS])
            y = bf.limbs_to_int(publics[base + NLIMBS : base + 2 * NLIMBS])
            if x >= P_INT or y >= P_INT:
                raise ValueError("C point coordinate not canonical")
        for base in (self.oa_base, self.ob_base):
            x = bf.limbs_to_int(publics[base + 1 : base + 1 + NLIMBS])
            y = bf.limbs_to_int(publics[base + 1 + NLIMBS : base + 1 + 2 * NLIMBS])
            if x >= P_INT or y >= P_INT:
                raise ValueError("result coordinate not canonical")


def _hf_value(t: str, env) -> int:
    return (_HF_LAD if t == "ladder" else _HF_ADD).eval_int(env)
