"""Poseidon2 sponge AIR — the flagship arithmetized circuit.

Proves knowledge of a Poseidon2 sponge absorption chain: the trace walks the
permutation round-by-round over a stream of rate-8 chunks and exposes the
stream words and the resulting digest as public values.  This is the
public-values binding circuit of the proof pipeline (prover/pipeline.py): a
witness program's committed output stream is absorbed and the digest is what
the STARK certifies.

Layout (width 32 = 16 state + 16 S-box aux):
  * each permutation occupies 32 rows: 1 initial-linear row, 8 external
    rounds, 13 internal rounds, 10 copy rows (padding to a power-of-2 block)
  * preprocessed columns: one-hot row-type selectors (init/ext/int/copy),
    the 16 per-row round constants, a digest-row flag, and one absorb
    selector per later chunk
  * S-box x⁷ is split via the aux column s3 = (x+rc)³ so every constraint
    has algebraic degree ≤ 3 (fits the default blowup-4 quotient)

The digest matches ``pcs.merkle._s_hash_row`` on the same words (tested),
i.e. the sponge in the AIR is exactly the framework's leaf-hash sponge.

Copied from ``dvt_circuits_tpu/stark/poseidon2_air.py``; ``eval_tensor``,
the prover's path, is ported to int64 PyTorch ops (the verifier replays the
scalar ``eval`` at ζ).
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import babybear as bb
from ..hash import poseidon2 as p2
from .air import Air

ROWS_PER_PERM = 32
ACTIVE_ROWS = 1 + p2.ROUNDS_F + p2.ROUNDS_P  # 22


def _b_m4(b, x):
    """Poseidon2 M4 block as a builder add/double chain (shared subexprs)."""
    t0 = b.add(x[0], x[1])
    t1 = b.add(x[2], x[3])
    t2 = b.add(x[1], x[1], t1)
    t3 = b.add(x[3], x[3], t0)
    t4 = b.add(t1, t1)
    t4 = b.add(t4, t4, t3)
    t5 = b.add(t0, t0)
    t5 = b.add(t5, t5, t2)
    t6 = b.add(t3, t5)
    t7 = b.add(t2, t4)
    return [t6, t5, t7, t4]


def _b_external_linear(b, vec):
    groups = [_b_m4(b, vec[i : i + 4]) for i in range(0, 16, 4)]
    sums = [b.add(groups[0][j], groups[1][j], groups[2][j], groups[3][j]) for j in range(4)]
    return [b.add(groups[i // 4][i % 4], sums[i % 4]) for i in range(16)]


def _b_internal_linear(b, vec):
    total = b.add(*vec)
    return [
        b.add(b.mul(b.constant(p2.INTERNAL_DIAG[i]), vec[i]), total) for i in range(16)
    ]

# per-active-row metadata: (row_type, round_constants[16])
_ROW_TYPES = []
_ROW_RCS = []
_ROW_TYPES.append("init")
_ROW_RCS.append([0] * 16)
for r in range(p2.ROUNDS_F // 2):
    _ROW_TYPES.append("ext")
    _ROW_RCS.append(list(p2.EXTERNAL_CONSTANTS[r]))
for r in range(p2.ROUNDS_P):
    _ROW_TYPES.append("int")
    _ROW_RCS.append([p2.INTERNAL_CONSTANTS[r]] + [0] * 15)
for r in range(p2.ROUNDS_F // 2, p2.ROUNDS_F):
    _ROW_TYPES.append("ext")
    _ROW_RCS.append(list(p2.EXTERNAL_CONSTANTS[r]))
assert len(_ROW_TYPES) == ACTIVE_ROWS


class Poseidon2StreamAir(Air):
    """Parameterized by the number of rate-8 chunks absorbed."""

    width = 32  # 16 state + 16 sbox aux

    # preprocessed: sel_init, sel_ext, sel_int, sel_copy, sel_digest,
    #               rc[16], absorb selectors (num_chunks - 1)
    _FIXED_PRE = 5 + 16

    def __init__(self, num_chunks: int):
        assert num_chunks >= 1
        self.num_chunks = num_chunks
        self.num_public_values = 8 * num_chunks + p2.DIGEST_WIDTH
        self.preprocessed_width = self._FIXED_PRE + (num_chunks - 1)

    # -- trace sizes --------------------------------------------------------

    @property
    def min_rows(self) -> int:
        return self.num_chunks * ROWS_PER_PERM

    @property
    def log_rows(self) -> int:
        return (self.min_rows - 1).bit_length()

    # -- preprocessed columns ----------------------------------------------

    def preprocessed_trace(self, n: int):
        assert n >= self.min_rows
        pre = np.zeros((n, self.preprocessed_width), dtype=np.uint32)
        type_idx = {"init": 0, "ext": 1, "int": 2}
        for c in range(self.num_chunks):
            base = c * ROWS_PER_PERM
            for r in range(ACTIVE_ROWS):
                pre[base + r, type_idx[_ROW_TYPES[r]]] = 1
                pre[base + r, 5 : 5 + 16] = _ROW_RCS[r]
            for r in range(ACTIVE_ROWS, ROWS_PER_PERM):
                pre[base + r, 3] = 1  # copy
        # rows beyond the chunks are copy rows
        pre[self.num_chunks * ROWS_PER_PERM :, 3] = 1
        # digest flag: first copy row of the last block
        pre[(self.num_chunks - 1) * ROWS_PER_PERM + ACTIVE_ROWS, 4] = 1
        # absorb selectors: last row of block c-1 hands chunk c to the next row
        for c in range(1, self.num_chunks):
            row = c * ROWS_PER_PERM - 1
            pre[row, 3] = 0  # absorb replaces the plain copy type
            pre[row, self._FIXED_PRE + (c - 1)] = 1
        return pre

    # -- witness ------------------------------------------------------------

    def generate_trace(self, words):
        """Trace + public values for absorbing `words` (list of ints < p)."""
        words = [int(w) % bb.P for w in words]
        padded = words + [0] * (8 * self.num_chunks - len(words))
        assert len(padded) == 8 * self.num_chunks
        n = 1 << self.log_rows
        trace = np.zeros((n, self.width), dtype=np.uint32)
        state = [0] * 16
        row = 0
        for c in range(self.num_chunks):
            state = list(state)
            state[:8] = padded[8 * c : 8 * c + 8]
            for r in range(ACTIVE_ROWS):
                aux = [0] * 16
                typ = _ROW_TYPES[r]
                rc = _ROW_RCS[r]
                trace[row, :16] = state
                if typ == "init":
                    nxt = p2._s_external_linear(state)
                elif typ == "ext":
                    xp = [(state[i] + rc[i]) % bb.P for i in range(16)]
                    aux = [pow(x, 3, bb.P) for x in xp]
                    y = [aux[i] * aux[i] % bb.P * xp[i] % bb.P for i in range(16)]
                    nxt = p2._s_external_linear(y)
                else:  # int
                    x0 = (state[0] + rc[0]) % bb.P
                    aux[0] = pow(x0, 3, bb.P)
                    y = list(state)
                    y[0] = aux[0] * aux[0] % bb.P * x0 % bb.P
                    nxt = p2._s_internal_linear(y)
                trace[row, 16:] = aux
                state = nxt
                row += 1
            for r in range(ACTIVE_ROWS, ROWS_PER_PERM):
                trace[row, :16] = state
                row += 1
        digest = list(state[: p2.DIGEST_WIDTH])
        while row < n:
            trace[row, :16] = state
            row += 1
        publics = padded + digest
        return trace, publics

    # -- constraints ---------------------------------------------------------

    def eval(self, b):
        x = [b.local(i) for i in range(16)]
        s3 = [b.local(16 + i) for i in range(16)]
        nxt = [b.next(i) for i in range(16)]
        sel_init = b.preprocessed(0)
        sel_ext = b.preprocessed(1)
        sel_int = b.preprocessed(2)
        sel_copy = b.preprocessed(3)
        sel_digest = b.preprocessed(4)
        rc = [b.preprocessed(5 + i) for i in range(16)]

        # initial linear layer rows: next = M_E · x
        me_x = _b_external_linear(b, x)
        for j in range(16):
            b.assert_zero_transition(b.mul(sel_init, b.sub(nxt[j], me_x[j])))

        # external rounds: s3_i = (x_i + rc_i)³, y_i = s3_i²·(x_i+rc_i),
        # next = M_E · y   (y is substituted to keep degree ≤ 3)
        xp = [b.add(x[i], rc[i]) for i in range(16)]
        y_ext = [b.mul(s3[i], s3[i], xp[i]) for i in range(16)]
        me_y = _b_external_linear(b, y_ext)
        for i in range(16):
            b.assert_zero_all(b.mul(sel_ext, b.sub(s3[i], b.mul(xp[i], xp[i], xp[i]))))
        for j in range(16):
            b.assert_zero_transition(b.mul(sel_ext, b.sub(nxt[j], me_y[j])))

        # internal rounds: only lane 0 is S-boxed
        y_int = [b.mul(s3[0], s3[0], xp[0])] + x[1:]
        mi_y = _b_internal_linear(b, y_int)
        b.assert_zero_all(b.mul(sel_int, b.sub(s3[0], b.mul(xp[0], xp[0], xp[0]))))
        for j in range(16):
            b.assert_zero_transition(b.mul(sel_int, b.sub(nxt[j], mi_y[j])))

        # copy rows: next = x
        for j in range(16):
            b.assert_zero_transition(b.mul(sel_copy, b.sub(nxt[j], x[j])))

        # absorb boundaries: next[0..8) = chunk words, next[8..16) = x
        for c in range(1, self.num_chunks):
            sel_abs = b.preprocessed(self._FIXED_PRE + (c - 1))
            for i in range(8):
                b.assert_zero_transition(b.mul(sel_abs, b.sub(nxt[i], b.public(8 * c + i))))
            for i in range(8, 16):
                b.assert_zero_transition(b.mul(sel_abs, b.sub(nxt[i], x[i])))

        # first row: state = [chunk0 || 0⁸], aux matches the init row (aux=0)
        for i in range(8):
            b.assert_eq_first(x[i], b.public(i))
        for i in range(8, 16):
            b.assert_zero_first(x[i])

        # digest row: state[0..8) equals the public digest
        for i in range(p2.DIGEST_WIDTH):
            b.assert_zero_all(
                b.mul(sel_digest, b.sub(x[i], b.public(8 * self.num_chunks + i)))
            )

    def eval_tensor(self, tb):
        """Tensor path of the prover (``stark/prover.py:TensorBuilder``): the
        constraints of ``eval`` in its α-power order, each 16-lane group one
        chain of int64 tensor ops (``dvt_circuits_tpu/stark/poseidon2_air.py:
        eval_tensor``).  The linear layers are column algebra here, not
        permutations: plain PyTorch, not kernel K1."""
        from .. import params

        P = bb.P

        def m(a, b):
            return a * b % P

        def sub(a, b):
            return (a - b) % P

        X = tb.local[:, :16]
        S3 = tb.local[:, 16:32]
        NXT = tb.next[:, :16]
        sel_init, sel_ext, sel_int = tb.pre[:, 0:1], tb.pre[:, 1:2], tb.pre[:, 2:3]
        sel_copy, sel_digest = tb.pre[:, 3:4], tb.pre[:, 4:5]
        RC = tb.pre[:, 5:21]
        trans = tb.sel_transition[:, None]
        first = tb.sel_first[:, None]
        diag = params.constants(X.device)["poseidon2_diag"]

        # init rows: next = M_E·x
        tb.assert_group(m(m(sel_init, trans), sub(NXT, p2._external_linear(X))))

        # external rounds
        XP = (X + RC) % P
        XP3 = m(m(XP, XP), XP)
        Y = m(m(S3, S3), XP)
        tb.assert_group(m(sel_ext, sub(S3, XP3)))
        tb.assert_group(m(m(sel_ext, trans), sub(NXT, p2._external_linear(Y))))

        # internal rounds: lane 0 S-boxed
        y0 = m(m(S3[:, 0:1], S3[:, 0:1]), XP[:, 0:1])
        Y_INT = torch.cat([y0, X[:, 1:]], dim=1)
        tb.assert_group(m(sel_int, sub(S3[:, 0:1], XP3[:, 0:1])))
        tb.assert_group(m(m(sel_int, trans), sub(NXT, p2._internal_linear(Y_INT, diag))))

        # copy rows
        tb.assert_group(m(m(sel_copy, trans), sub(NXT, X)))

        # absorb boundaries
        for c in range(1, self.num_chunks):
            sel_abs = m(tb.pre[:, self._FIXED_PRE + (c - 1)][:, None], trans)
            tb.assert_group(m(sel_abs, sub(NXT[:, :8], tb.publics[8 * c : 8 * c + 8][None, :])))
            tb.assert_group(m(sel_abs, sub(NXT[:, 8:], X[:, 8:])))

        # first row
        tb.assert_group(m(first, sub(X[:, :8], tb.publics[0:8][None, :])))
        tb.assert_group(m(first, X[:, 8:]))

        # digest row
        dig = tb.publics[8 * self.num_chunks : 8 * self.num_chunks + 8][None, :]
        tb.assert_group(m(sel_digest, sub(X[:, :8], dig)))


def stream_to_words(data: bytes) -> list:
    """Bytes → BabyBear words, 2 bytes per word big-endian (always < p)."""
    return [int.from_bytes(data[i : i + 2], "big") for i in range(0, len(data), 2)]


def hash_stream_words(words) -> list:
    """Host mirror of the AIR's sponge: absorb rate-8 chunks, return digest."""
    from ..pcs.merkle import _s_hash_row

    return _s_hash_row([int(w) % bb.P for w in words])
