"""Non-native BLS12-381 base-field gadgets for BabyBear AIRs.

The reference proves its G1 curve math inside SP1 via the sp1-patched
``bls12_381`` crate's precompile chips (SURVEY.md §2.2, crates/dkg/
Cargo.toml:25); those chips arithmetize 381-bit modular arithmetic over
small limbs with byte-lookup range checks.  This module is the TPU
framework's equivalent, designed for the existing SINGLE-PHASE prover: no
lookup argument is required because range checks are 2-bit "crumb"
decompositions (x(x-1)(x-2)(x-3) = 0, degree 4 — inside the blowup-4
degree budget of 5, stark/air.py).

Representation
  * one Fp element = 39 little-endian limbs of 10 bits (390 bits ≥ 381),
    each limb committed as 5 crumb columns (limb = Σ crumb_c·4^c);
  * a MUL gadget proves r ≡ a·b (mod p) via the schoolbook column
    identity  Σ_{i+j=k} a_i·b_j − Σ_{i+j=k} q_i·p_j − r_k + c_{k−1}
    − 2^10·c_k = 0  with witnessed quotient q (39 limbs) and signed
    carries c (committed with offset 2^19, 10 crumbs each);
  * a RED gadget proves r ≡ F (mod p) for a small linear form F
    (scalar quotient q < 64, 4-crumb carries with offset 128).

Soundness: every committed value is crumb-range-checked, so each
constraint's integer magnitude is statically bounded; the builder asserts
the bound is < p_BabyBear, which turns the mod-p_BB identity into an
integer identity (the standard non-native-arithmetic argument).  Inputs
are *linear forms* over committed values plus a constant multiple of p
(to keep honest integer values non-negative); the form magnitude budget
is asserted at build time (MAX_MAMB / RED_MAX_M).

Witness generation is vectorized numpy over all rows of a trace
(``mul_witness_rows`` / ``red_witness_rows``): Python-int math only for
per-row divmods, limb work in uint64 arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..field.babybear import P as P_BB
from ..hostcrypto.bls12_381 import P as P_INT

LIMB_BITS = 10
NLIMBS = 39
LIMB_MASK = (1 << LIMB_BITS) - 1
CRUMBS_PER_LIMB = 5
VALUE_CRUMBS = NLIMBS * CRUMBS_PER_LIMB  # 195

MUL_OUT = 2 * NLIMBS - 1  # 77 product columns (k = 0..76)
MUL_CARRIES = MUL_OUT - 1  # 76 carry witnesses (final carry must be 0)
MUL_CARRY_CRUMBS = 10  # carry + 2^19 committed in [0, 2^20)
MUL_CARRY_OFFSET = 1 << 19
MAX_MAMB = 12  # product of the two input-form magnitude budgets

RED_OUT = NLIMBS + 1  # 40 identity columns (form constants < 2^400)
RED_CARRIES = RED_OUT - 1  # 39 carry witnesses
RED_CARRY_CRUMBS = 4  # carry + 128 committed in [0, 256)
RED_CARRY_OFFSET = 128
RED_Q_CRUMBS = 3  # scalar quotient in [0, 64)
RED_MAX_M = 41  # form magnitude budget (Σ|coeff| incl. p-multiple)

P_LIMBS = tuple((P_INT >> (LIMB_BITS * i)) & LIMB_MASK for i in range(NLIMBS))


def int_to_limbs(x: int, n: int = NLIMBS) -> List[int]:
    return [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n)]


def limbs_to_int(limbs) -> int:
    x = 0
    for i in reversed(range(len(limbs))):
        x = (x << LIMB_BITS) | int(limbs[i])
    return x


_LIMB_BYTE_IDX = (LIMB_BITS * np.arange(NLIMBS)) // 8
_LIMB_BIT_SHIFT = ((LIMB_BITS * np.arange(NLIMBS)) % 8).astype(np.uint64)


def ints_to_limb_rows(vals: Sequence[int]) -> np.ndarray:
    """(n,) Python ints → (n, 39) uint64 limb matrix (vectorized via a
    byte dump — the witness generator calls this for every value slot)."""
    raw = b"".join(int(v).to_bytes(50, "little") for v in vals)
    b8 = np.frombuffer(raw, dtype=np.uint8).reshape(len(vals), 50).astype(np.uint64)
    word = (
        b8[:, _LIMB_BYTE_IDX]
        | (b8[:, _LIMB_BYTE_IDX + 1] << np.uint64(8))
        | (b8[:, _LIMB_BYTE_IDX + 2] << np.uint64(16))
    )
    return (word >> _LIMB_BIT_SHIFT[None, :]) & np.uint64(LIMB_MASK)


def limbs_to_crumbs(limbs: np.ndarray) -> np.ndarray:
    """(..., L) limb array → (..., L·5) crumb array (limb-major, LSB first)."""
    limbs = np.asarray(limbs, dtype=np.uint64)
    crumbs = np.empty(limbs.shape + (CRUMBS_PER_LIMB,), dtype=np.uint32)
    for c in range(CRUMBS_PER_LIMB):
        crumbs[..., c] = (limbs >> np.uint64(2 * c)) & np.uint64(3)
    return crumbs.reshape(*limbs.shape[:-1], limbs.shape[-1] * CRUMBS_PER_LIMB)


def value_to_crumbs(vals: Sequence[int]) -> np.ndarray:
    """(n,) ints → (n, 195) crumb matrix."""
    return limbs_to_crumbs(ints_to_limb_rows(vals))


def small_to_crumbs(vals: np.ndarray, num_crumbs: int) -> np.ndarray:
    """(n,) or (n, m) small non-negative ints → crumb expansion on last axis."""
    vals = np.asarray(vals, dtype=np.uint64)
    out = np.empty(vals.shape + (num_crumbs,), dtype=np.uint32)
    for c in range(num_crumbs):
        out[..., c] = (vals >> np.uint64(2 * c)) & np.uint64(3)
    return out


# ---------------------------------------------------------------------------
# Linear forms over value slots
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Form:
    """Σ coeff·slot + const, evaluated limb-wise.

    ``terms``: tuple of (slot_index, signed_coeff); ``const``: a non-negative
    integer added limb-wise (typically t·p so honest values stay ≥ 0).
    ``magnitude`` (Σ|coeff| + max const limb weight) feeds the static bound
    assertions.
    """

    terms: Tuple[Tuple[int, int], ...] = ()
    const: int = 0

    @property
    def magnitude(self) -> int:
        m = sum(abs(c) for _, c in self.terms)
        if self.const:
            m += 1  # const limbs are < 2^LIMB_BITS per position
        return m

    def const_limbs(self, n: int) -> List[int]:
        return int_to_limbs(self.const, n)

    def eval_int(self, slot_vals: Sequence[int]) -> int:
        v = self.const
        for s, c in self.terms:
            v += c * int(slot_vals[s])
        return v

    def is_zero(self) -> bool:
        return not self.terms and self.const == 0


ZERO_FORM = Form()


def form_of(slot: int) -> Form:
    return Form(((slot, 1),))


# ---------------------------------------------------------------------------
# Gadget specs (wiring is data: witness gen + both eval paths consume it)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MulSpec:
    """r_slot ≡ form_a·form_b (mod p).  Forms are per-row-type: dict
    row_type → (Form, Form); inactive row types multiply 0·0 with zero
    witnesses.  q_slot holds the 39-limb quotient."""

    idx: int
    forms: Dict[str, Tuple[Form, Form]] = field(default_factory=dict)
    # filled by the layout:
    r_slot: int = -1
    q_slot: int = -1
    carry_base: int = -1  # first trace column of 76·10 carry crumbs

    def check_budget(self) -> None:
        for t, (fa, fb) in self.forms.items():
            m = fa.magnitude * fb.magnitude
            assert m <= MAX_MAMB, f"mul {self.idx} type {t}: mAmB {m} > {MAX_MAMB}"


@dataclass(frozen=True)
class RedSpec:
    """r_slot ≡ form (mod p) with scalar quotient — cheap reduction of a
    linear combination into a fresh committed value."""

    idx: int
    forms: Dict[str, Form] = field(default_factory=dict)
    r_slot: int = -1
    q_base: int = -1  # 3 crumb columns for the scalar quotient
    carry_base: int = -1  # 39·4 carry crumbs

    def check_budget(self) -> None:
        for t, f in self.forms.items():
            assert f.magnitude <= RED_MAX_M, (
                f"red {self.idx} type {t}: magnitude {f.magnitude} > {RED_MAX_M}"
            )
            assert f.const % P_INT == 0, "form const must be a multiple of p"


def assert_static_bounds() -> None:
    """The integer-identity bound argument, checked once at import.

    MUL identity column magnitude:
      forms: MAX_MAMB · 39 · (2^10−1)² (products)  + 39·1023² (q·p)
      + 1023 (r) + 2^19 (c_{k−1}) + 2^10·2^19 (2^10·c_k)
    must be < p_BB so `≡ 0 mod p_BB` ⇒ `= 0 over ℤ`.
    """
    conv = NLIMBS * LIMB_MASK * LIMB_MASK
    mul_bound = (
        MAX_MAMB * conv + conv + LIMB_MASK + MUL_CARRY_OFFSET
        + (1 << LIMB_BITS) * MUL_CARRY_OFFSET
    )
    assert mul_bound < P_BB, mul_bound
    # carry range: |c| ≤ ((MAX_MAMB+1)·conv)/2^10 must fit the offset window
    assert (MAX_MAMB + 1) * conv // (1 << LIMB_BITS) + 2 <= MUL_CARRY_OFFSET
    red_bound = (
        RED_MAX_M * LIMB_MASK + 63 * LIMB_MASK + LIMB_MASK + RED_CARRY_OFFSET
        + (1 << LIMB_BITS) * RED_CARRY_OFFSET
    )
    assert red_bound < P_BB, red_bound
    assert (RED_MAX_M + 65) * LIMB_MASK // (1 << LIMB_BITS) + 2 <= RED_CARRY_OFFSET


assert_static_bounds()


# ---------------------------------------------------------------------------
# Vectorized witness generation
# ---------------------------------------------------------------------------


def mul_witness_rows(
    a_ints: Sequence[int],
    b_ints: Sequence[int],
    a_limbs: Optional[np.ndarray] = None,
    b_limbs: Optional[np.ndarray] = None,
):
    """Per-row (q, r, carry) witnesses for t = a·b, a,b ≥ 0.

    ``a_limbs``/``b_limbs`` are the RAW (uncarried) limb columns the
    constraint actually evaluates — the linear combination of committed
    limbs plus form constants, which may exceed 10 bits per position.  The
    carry chain must be computed against those, not against the canonical
    limbs of the integer values (defaulted only when the inputs are plain
    committed values).  Returns (q_ints, r_ints, carries) with carries a
    (n, 76) int64 array of OFFSET-shifted committed values in [0, 2^20).
    """
    n = len(a_ints)
    q_ints, r_ints = [], []
    for a, b in zip(a_ints, b_ints):
        assert a >= 0 and b >= 0
        t = int(a) * int(b)
        q, r = divmod(t, P_INT)
        q_ints.append(q)
        r_ints.append(r)
    al = (
        ints_to_limb_rows(a_ints).astype(np.int64)
        if a_limbs is None
        else np.asarray(a_limbs, dtype=np.int64)
    )
    bl = (
        ints_to_limb_rows(b_ints).astype(np.int64)
        if b_limbs is None
        else np.asarray(b_limbs, dtype=np.int64)
    )
    ql = ints_to_limb_rows(q_ints).astype(np.int64)
    rl = ints_to_limb_rows(r_ints).astype(np.int64)
    pl = np.asarray(P_LIMBS, dtype=np.int64)
    t_cols = np.zeros((n, MUL_OUT), dtype=np.int64)
    for i in range(NLIMBS):
        t_cols[:, i : i + NLIMBS] += al[:, i : i + 1] * bl - ql[:, i : i + 1] * pl
    t_cols[:, :NLIMBS] -= rl
    carries = np.zeros((n, MUL_CARRIES), dtype=np.int64)
    c = np.zeros(n, dtype=np.int64)
    for k in range(MUL_OUT):
        tot = t_cols[:, k] + c
        if k < MUL_CARRIES:
            # ab − qp − r = 0 over ℤ ⇒ every partial sum divides by 2^10
            assert np.all(tot % (1 << LIMB_BITS) == 0), "mul witness: ragged carry"
            c = tot >> LIMB_BITS
            carries[:, k] = c
        else:
            assert np.all(tot == 0), "mul witness: nonzero final carry"
    shifted = carries + MUL_CARRY_OFFSET
    assert np.all((shifted >= 0) & (shifted < 1 << 20)), "mul carry out of range"
    return q_ints, r_ints, shifted


def red_witness_rows(f_ints: Sequence[int], f_limbs: Optional[np.ndarray] = None):
    """Per-row (q, r, carry) witnesses for r = F mod p, F ≥ 0, F < 64p.

    ``f_limbs``: the raw (uncarried) form limb columns the constraint
    evaluates — see ``mul_witness_rows``.  Returns (q_small (n,), r_ints,
    carries (n, 39) offset-shifted)."""
    n = len(f_ints)
    q_small = np.empty(n, dtype=np.int64)
    r_ints = []
    for i, fv in enumerate(f_ints):
        assert 0 <= fv < 64 * P_INT, "reduction form out of quotient range"
        q, r = divmod(int(fv), P_INT)
        q_small[i] = q
        r_ints.append(r)
    if f_limbs is not None:
        fl = np.asarray(f_limbs, dtype=np.int64)
        assert fl.shape == (n, RED_OUT)
    else:
        fl = np.zeros((n, RED_OUT), dtype=np.int64)
        for i, fv in enumerate(f_ints):
            v = int(fv)
            for k in range(RED_OUT):
                fl[i, k] = v & LIMB_MASK
                v >>= LIMB_BITS
            assert v == 0
    pl = np.asarray(list(P_LIMBS) + [0], dtype=np.int64)
    rl = np.concatenate(
        [ints_to_limb_rows(r_ints).astype(np.int64), np.zeros((n, 1), np.int64)],
        axis=1,
    )
    t_cols = fl - q_small[:, None] * pl[None, :] - rl
    carries = np.zeros((n, RED_CARRIES), dtype=np.int64)
    c = np.zeros(n, dtype=np.int64)
    for k in range(RED_OUT):
        tot = t_cols[:, k] + c
        if k < RED_CARRIES:
            assert np.all(tot % (1 << LIMB_BITS) == 0), "red witness: ragged carry"
            c = tot >> LIMB_BITS
            carries[:, k] = c
        else:
            assert np.all(tot == 0), "red witness: nonzero final carry"
    shifted = carries + RED_CARRY_OFFSET
    assert np.all((shifted >= 0) & (shifted < 256)), "red carry out of range"
    return q_small, r_ints, shifted
