"""SHA-256 compression AIR — the first DKG-check gadget arithmetization.

Every commitment hash in the DKG protocol is SHA-256 (initial-commitment,
seed-exchange, partial-share, base hashes — reference verification.rs:30-48,
151-175, 334-362), and the reference proves those hashes inside SP1 via its
sha2 precompile chip (SURVEY.md §2.2).  This AIR is the TPU framework's
native equivalent: it proves `digest = SHA-256-compress(msg)` for a padded
message of `num_blocks` 64-byte blocks, with the message and digest exposed
as 16-bit-limb public values.

Layout — one row per compression round (64 rows per block, +1 digest row,
padded to a power of two):

  * registers a,b,c,e,f,g as 32 bit-columns each (LSB first) — the Σ/Ch/Maj
    mixers are bit expressions (XOR3 is degree 3); d,h as two 16-bit limbs
    (they are only ever added);
  * the 16-word schedule window as limbs, shifted one word per row, with bit
    decompositions of w[1] and w[14] (the σ0/σ1 inputs) re-derived per row;
  * all 32-bit additions are two 16-bit-limb field constraints with small
    bit-decomposed carries (BabyBear is 31 bits — a 32-bit sum must never
    materialize as one field element);
  * the block IV rides every row (16 limb columns) so the Davies-Meyer
    feed-forward at a block boundary is a 2-row constraint: the boundary row
    folds round 63 AND the `iv + state` addition into one transition;
  * the digest row's iv columns equal the final digest; public digest limbs
    are checked there.

Max constraint degree: selector · XOR3/Maj = 4 (fits the default blowup-4
budget of 5).  The verifier must range-check public limbs < 2^16 (done in
``check_publics``): limb equalities are canonical only for in-range publics.

Copied from ``dvt_circuits_tpu/stark/sha256_air.py``; ``eval_tensor``, the
prover's path, is ported to int64 PyTorch ops (the verifier replays the
scalar ``eval`` at ζ).
"""

from __future__ import annotations

import numpy as np

from ..hash.sha256 import _H0, _K
from .air import Air

ROWS_PER_BLOCK = 64

# -- column layout -----------------------------------------------------------
A, B, C, E, F, G = 0, 32, 64, 96, 128, 160  # bit blocks
D_LO, D_HI, H_LO, H_HI = 192, 193, 194, 195
IV = 196  # 16 limbs: a_lo, a_hi, b_lo, ..., h_lo, h_hi
WIN = 212  # 16 words × 2 limbs: w0_lo, w0_hi, w1_lo, ...
W1B = 244  # 32 bits of window word 1
W14B = 276  # 32 bits of window word 14
CE = 308  # 3+3 carry bits for the new-e addition (lo, hi)
CA = 314  # 3+3 carry bits for the new-a addition
CW = 320  # 2+2 carry bits for the schedule addition
CF = 324  # 12 one-bit carries for boundary copies: b,c,d,f,g,h × (lo, hi)
WIDTH = 336

_REG_ORDER = "abcdefgh"


def _u32_limbs(v: int) -> tuple:
    return v & 0xFFFF, (v >> 16) & 0xFFFF


class Sha256Air(Air):
    """Proves SHA-256 of one or more independently-padded messages in ONE
    table — the TPU analogue of SP1's SHA chip accumulating every hash
    invocation of a shard into a single AIR (SURVEY.md §2.2).

    Rows: for each message, 64 rows per block then one digest row; the state
    resets to H0 at every message start (a preprocessed `sel_start` flag).
    Public values per message: 32·blocks message limbs then 16 digest limbs
    (a..h order, lo then hi), messages concatenated in order."""

    width = WIDTH

    # preprocessed: sel_round, sel_boundary, sel_digest(any), k_lo, k_hi,
    #               sel_start(any), then one window selector per global block
    #               (on the block's first row) and one digest selector per
    #               message (on its digest row)
    _FIXED_PRE = 6

    def __init__(self, block_counts):
        if isinstance(block_counts, int):
            block_counts = (block_counts,)
        block_counts = tuple(int(b) for b in block_counts)
        assert block_counts and all(b >= 1 for b in block_counts)
        self.block_counts = block_counts
        self.total_blocks = sum(block_counts)
        self.num_messages = len(block_counts)
        self.num_public_values = 32 * self.total_blocks + 16 * self.num_messages
        self.preprocessed_width = (
            self._FIXED_PRE + self.total_blocks + self.num_messages
        )

    # back-compat alias (single-message call sites / proof containers)
    @property
    def num_blocks(self) -> int:
        return self.total_blocks

    def public_offset(self, m: int) -> int:
        """Offset of message m's first public limb."""
        return sum(32 * b + 16 for b in self.block_counts[:m])

    def digest_offset(self, m: int) -> int:
        return self.public_offset(m) + 32 * self.block_counts[m]

    def _row_layout(self):
        """Yield (message, block, start_row) for every global block, plus a
        parallel list of per-message digest rows."""
        blocks = []
        digests = []
        row = 0
        for m, b_m in enumerate(self.block_counts):
            for blk in range(b_m):
                blocks.append((m, blk, row))
                row += ROWS_PER_BLOCK
            digests.append(row)
            row += 1
        return blocks, digests

    @property
    def min_rows(self) -> int:
        return self.total_blocks * ROWS_PER_BLOCK + self.num_messages

    @property
    def log_rows(self) -> int:
        return (self.min_rows - 1).bit_length()

    # -- preprocessed ---------------------------------------------------------

    def preprocessed_trace(self, n: int):
        assert n >= self.min_rows
        pre = np.zeros((n, self.preprocessed_width), dtype=np.uint32)
        blocks, digests = self._row_layout()
        for gb, (m, blk, base) in enumerate(blocks):
            for t in range(ROWS_PER_BLOCK):
                row = base + t
                pre[row, 0 if t < 63 else 1] = 1  # sel_round / sel_boundary
                pre[row, 3], pre[row, 4] = _u32_limbs(int(_K[t]))
            pre[base, self._FIXED_PRE + gb] = 1  # window ← block words
            if blk == 0:
                pre[base, 5] = 1  # sel_start: state resets to H0
        for m, drow in enumerate(digests):
            pre[drow, 2] = 1  # sel_digest (shared)
            pre[drow, self._FIXED_PRE + self.total_blocks + m] = 1
        return pre

    # -- trace ----------------------------------------------------------------

    def generate_trace(self, padded):
        """Trace + publics.  ``padded``: one pre-padded message (bytes) or a
        list of them, lengths 64·block_counts[m]."""
        if isinstance(padded, (bytes, bytearray)):
            padded = [bytes(padded)]
        assert len(padded) == self.num_messages
        for msg, b_m in zip(padded, self.block_counts):
            assert len(msg) == 64 * b_m, "message padding does not match block count"
        n = 1 << self.log_rows
        tr = np.zeros((n, WIDTH), dtype=np.uint32)
        publics: list = []

        M32 = 0xFFFFFFFF
        row = 0
        for msg, b_m in zip(padded, self.block_counts):
            state = [int(x) for x in _H0]
            for blk in range(b_m):
                block = msg[64 * blk : 64 * blk + 64]
                w = [int.from_bytes(block[4 * i : 4 * i + 4], "big") for i in range(16)]
                for word in w:
                    publics.extend(_u32_limbs(word))
                iv = list(state)
                win = list(w)
                for t in range(ROWS_PER_BLOCK):
                    a, b_, c, d, e, f, g, h = state
                    r = tr[row]
                    for i in range(32):
                        r[A + i] = (a >> i) & 1
                        r[B + i] = (b_ >> i) & 1
                        r[C + i] = (c >> i) & 1
                        r[E + i] = (e >> i) & 1
                        r[F + i] = (f >> i) & 1
                        r[G + i] = (g >> i) & 1
                        r[W1B + i] = (win[1] >> i) & 1
                        r[W14B + i] = (win[14] >> i) & 1
                    r[D_LO], r[D_HI] = _u32_limbs(d)
                    r[H_LO], r[H_HI] = _u32_limbs(h)
                    for ri, reg in enumerate(iv):
                        r[IV + 2 * ri], r[IV + 2 * ri + 1] = _u32_limbs(reg)
                    for j in range(16):
                        r[WIN + 2 * j], r[WIN + 2 * j + 1] = _u32_limbs(win[j])

                    # round computation (integer mirror of the constraints)
                    rotr = lambda x, k: ((x >> k) | (x << (32 - k))) & M32
                    s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)
                    ch = (e & f) ^ (~e & g) & M32
                    t1 = h + s1 + ch + int(_K[t]) + win[0]
                    s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)
                    maj = (a & b_) ^ (a & c) ^ (b_ & c)
                    t2 = s0 + maj
                    boundary = t == 63
                    iv_e = iv[4] if boundary else 0
                    iv_a = iv[0] if boundary else 0

                    # limb sums and carries exactly as the constraints see them
                    def limb_sums(parts_lo, parts_hi):
                        lo = sum(parts_lo)
                        c_lo = lo >> 16
                        hi = sum(parts_hi) + c_lo
                        c_hi = hi >> 16
                        return lo & 0xFFFF, c_lo, hi & 0xFFFF, c_hi

                    s1ch_lo = sum((((s1 >> i) & 1) + ((ch >> i) & 1)) << i for i in range(16))
                    s1ch_hi = sum(
                        (((s1 >> i) & 1) + ((ch >> i) & 1)) << (i - 16) for i in range(16, 32)
                    )
                    s0mj_lo = sum((((s0 >> i) & 1) + ((maj >> i) & 1)) << i for i in range(16))
                    s0mj_hi = sum(
                        (((s0 >> i) & 1) + ((maj >> i) & 1)) << (i - 16) for i in range(16, 32)
                    )
                    k_lo, k_hi = _u32_limbs(int(_K[t]))
                    w_lo, w_hi = _u32_limbs(win[0])
                    h_lo, h_hi = _u32_limbs(h)
                    d_lo, d_hi = _u32_limbs(d)
                    ivE_lo, ivE_hi = _u32_limbs(iv_e)
                    ivA_lo, ivA_hi = _u32_limbs(iv_a)
                    _, ce_lo, _, ce_hi = limb_sums(
                        [d_lo, h_lo, s1ch_lo, k_lo, w_lo, ivE_lo],
                        [d_hi, h_hi, s1ch_hi, k_hi, w_hi, ivE_hi],
                    )
                    _, ca_lo, _, ca_hi = limb_sums(
                        [h_lo, s1ch_lo, k_lo, w_lo, s0mj_lo, ivA_lo],
                        [h_hi, s1ch_hi, k_hi, w_hi, s0mj_hi, ivA_hi],
                    )
                    for bit in range(3):
                        r[CE + bit] = (ce_lo >> bit) & 1
                        r[CE + 3 + bit] = (ce_hi >> bit) & 1
                        r[CA + bit] = (ca_lo >> bit) & 1
                        r[CA + 3 + bit] = (ca_hi >> bit) & 1

                    # schedule: w_new = σ1(w14) + w9 + σ0(w1) + w0
                    sig0 = rotr(win[1], 7) ^ rotr(win[1], 18) ^ (win[1] >> 3)
                    sig1 = rotr(win[14], 17) ^ rotr(win[14], 19) ^ (win[14] >> 10)
                    sg_lo = (win[0] & 0xFFFF) + (win[9] & 0xFFFF) + (sig0 & 0xFFFF) + (sig1 & 0xFFFF)
                    cw_lo = sg_lo >> 16
                    sg_hi = (win[0] >> 16) + (win[9] >> 16) + (sig0 >> 16) + (sig1 >> 16) + cw_lo
                    cw_hi = sg_hi >> 16
                    for bit in range(2):
                        r[CW + bit] = (cw_lo >> bit) & 1
                        r[CW + 2 + bit] = (cw_hi >> bit) & 1
                    w_new = (sig1 + win[9] + sig0 + win[0]) & M32

                    new_e = (d + t1) & M32
                    new_a = (t1 + t2) & M32
                    if boundary:
                        # Davies-Meyer feed-forward folded into the last round
                        nxt = [
                            (iv[0] + new_a) & M32,
                            (iv[1] + a) & M32,
                            (iv[2] + b_) & M32,
                            (iv[3] + c) & M32,
                            (iv[4] + new_e) & M32,
                            (iv[5] + e) & M32,
                            (iv[6] + f) & M32,
                            (iv[7] + g) & M32,
                        ]
                        # carries of the copy additions (b,c,d,f,g,h)
                        for ci, (ivv, sv) in enumerate(
                            [(iv[1], a), (iv[2], b_), (iv[3], c), (iv[5], e), (iv[6], f), (iv[7], g)]
                        ):
                            lo = (ivv & 0xFFFF) + (sv & 0xFFFF)
                            cf_lo = lo >> 16
                            hi = (ivv >> 16) + (sv >> 16) + cf_lo
                            r[CF + 2 * ci] = cf_lo
                            r[CF + 2 * ci + 1] = hi >> 16
                        state = nxt
                    else:
                        state = [new_a, a, b_, c, new_e, e, f, g]
                    win = win[1:] + [w_new]
                    row += 1
            # digest row: registers hold the final state; iv = digest
            r = tr[row]
            a, b_, c, d, e, f, g, h = state
            for i in range(32):
                r[A + i] = (a >> i) & 1
                r[B + i] = (b_ >> i) & 1
                r[C + i] = (c >> i) & 1
                r[E + i] = (e >> i) & 1
                r[F + i] = (f >> i) & 1
                r[G + i] = (g >> i) & 1
            r[D_LO], r[D_HI] = _u32_limbs(d)
            r[H_LO], r[H_HI] = _u32_limbs(h)
            for ri, reg in enumerate(state):
                r[IV + 2 * ri], r[IV + 2 * ri + 1] = _u32_limbs(reg)
            for reg in state:
                publics.extend(_u32_limbs(reg))
            row += 1
        return tr, publics

    # -- constraints -----------------------------------------------------------

    def eval(self, b):
        P = b.P
        one = b.constant(1)

        def bit(col):
            return b.local(col)

        def nbit(col):
            return b.next(col)

        def xor2(x, y):
            return b.sub(b.add(x, y), b.mul(b.constant(2), b.mul(x, y)))

        def xor3(x, y, z):
            # x+y+z − 2(xy+yz+zx) + 4xyz
            s = b.add(x, y, z)
            p2_ = b.add(b.mul(x, y), b.mul(y, z), b.mul(z, x))
            p3 = b.mul(x, y, z)
            return b.add(
                b.sub(s, b.mul(b.constant(2), p2_)), b.mul(b.constant(4), p3)
            )

        def limb(bits, lo: bool):
            rng = range(0, 16) if lo else range(16, 32)
            return b.add(*[b.mul(b.constant(1 << (i % 16)), bits[i]) for i in rng])

        sel_round = b.preprocessed(0)
        sel_bound = b.preprocessed(1)
        sel_digest = b.preprocessed(2)
        k_lo, k_hi = b.preprocessed(3), b.preprocessed(4)
        sel_rb = b.add(sel_round, sel_bound)
        sel_active = b.add(sel_rb, sel_digest)

        a_b = [bit(A + i) for i in range(32)]
        b_b = [bit(B + i) for i in range(32)]
        c_b = [bit(C + i) for i in range(32)]
        e_b = [bit(E + i) for i in range(32)]
        f_b = [bit(F + i) for i in range(32)]
        g_b = [bit(G + i) for i in range(32)]
        w1_b = [bit(W1B + i) for i in range(32)]
        w14_b = [bit(W14B + i) for i in range(32)]

        # 1. bitness (registers on all active rows; schedule/carries on
        #    round+boundary rows)
        for col_bits in (a_b, b_b, c_b, e_b, f_b, g_b):
            for x in col_bits:
                b.assert_zero_all(b.mul(sel_active, x, b.sub(x, one)))
        for x in w1_b + w14_b:
            b.assert_zero_all(b.mul(sel_rb, x, b.sub(x, one)))
        for col in list(range(CE, CE + 6)) + list(range(CA, CA + 6)) + list(
            range(CW, CW + 4)
        ):
            x = bit(col)
            b.assert_zero_all(b.mul(sel_rb, x, b.sub(x, one)))
        for col in range(CF, CF + 12):
            x = bit(col)
            b.assert_zero_all(b.mul(sel_bound, x, b.sub(x, one)))

        # 2. w1/w14 bit decompositions match the window limbs
        b.assert_zero_all(b.mul(sel_rb, b.sub(limb(w1_b, True), b.local(WIN + 2))))
        b.assert_zero_all(b.mul(sel_rb, b.sub(limb(w1_b, False), b.local(WIN + 3))))
        b.assert_zero_all(b.mul(sel_rb, b.sub(limb(w14_b, True), b.local(WIN + 28))))
        b.assert_zero_all(b.mul(sel_rb, b.sub(limb(w14_b, False), b.local(WIN + 29))))

        # 3. round mixers as limb-sum expressions
        s1_bits = [xor3(e_b[(i + 6) % 32], e_b[(i + 11) % 32], e_b[(i + 25) % 32]) for i in range(32)]
        ch_bits = [
            b.add(b.mul(e_b[i], f_b[i]), b.mul(b.sub(one, e_b[i]), g_b[i]))
            for i in range(32)
        ]
        s0_bits = [xor3(a_b[(i + 2) % 32], a_b[(i + 13) % 32], a_b[(i + 22) % 32]) for i in range(32)]
        maj_bits = [
            b.sub(
                b.add(b.mul(a_b[i], b_b[i]), b.mul(a_b[i], c_b[i]), b.mul(b_b[i], c_b[i])),
                b.mul(b.constant(2), b.mul(a_b[i], b_b[i], c_b[i])),
            )
            for i in range(32)
        ]

        def wsum(bits_list, lo: bool):
            rng = range(0, 16) if lo else range(16, 32)
            return b.add(*[b.mul(b.constant(1 << (i % 16)), bits_list[i]) for i in rng])

        s1ch_lo = b.add(wsum(s1_bits, True), wsum(ch_bits, True))
        s1ch_hi = b.add(wsum(s1_bits, False), wsum(ch_bits, False))
        s0mj_lo = b.add(wsum(s0_bits, True), wsum(maj_bits, True))
        s0mj_hi = b.add(wsum(s0_bits, False), wsum(maj_bits, False))

        t1_lo = b.add(b.local(H_LO), s1ch_lo, k_lo, b.local(WIN + 0))
        t1_hi = b.add(b.local(H_HI), s1ch_hi, k_hi, b.local(WIN + 1))

        def carry(base, lo: bool):
            off = 0 if lo else 3
            return b.add(
                *[b.mul(b.constant(1 << i), bit(base + off + i)) for i in range(3)]
            )

        next_a = [nbit(A + i) for i in range(32)]
        next_e = [nbit(E + i) for i in range(32)]
        n_a_lo, n_a_hi = limb(next_a, True), limb(next_a, False)
        n_e_lo, n_e_hi = limb(next_e, True), limb(next_e, False)
        a_lo, a_hi = limb(a_b, True), limb(a_b, False)
        b_lo, b_hi = limb(b_b, True), limb(b_b, False)
        c_lo, c_hi = limb(c_b, True), limb(c_b, False)
        e_lo, e_hi = limb(e_b, True), limb(e_b, False)
        f_lo, f_hi = limb(f_b, True), limb(f_b, False)
        g_lo, g_hi = limb(g_b, True), limb(g_b, False)
        two16 = b.constant(1 << 16)

        def add_eq(sel, out_lo, out_hi, c_lo_expr, c_hi_expr, parts_lo, parts_hi):
            """out + carry·2^16 = Σ parts, per limb (hi receives carry_lo)."""
            b.assert_zero_transition(
                b.mul(sel, b.sub(b.add(out_lo, b.mul(two16, c_lo_expr)), b.add(*parts_lo)))
            )
            b.assert_zero_transition(
                b.mul(
                    sel,
                    b.sub(
                        b.add(out_hi, b.mul(two16, c_hi_expr)),
                        b.add(*(list(parts_hi) + [c_lo_expr])),
                    ),
                )
            )

        iv_l = [b.local(IV + j) for j in range(16)]

        # new e / new a — round rows (no iv) and boundary rows (+iv)
        ce_l, ce_h = carry(CE, True), carry(CE, False)
        ca_l, ca_h = carry(CA, True), carry(CA, False)
        add_eq(sel_round, n_e_lo, n_e_hi, ce_l, ce_h,
               [b.local(D_LO), t1_lo], [b.local(D_HI), t1_hi])
        add_eq(sel_round, n_a_lo, n_a_hi, ca_l, ca_h,
               [t1_lo, s0mj_lo], [t1_hi, s0mj_hi])
        add_eq(sel_bound, n_e_lo, n_e_hi, ce_l, ce_h,
               [b.local(D_LO), t1_lo, iv_l[8]], [b.local(D_HI), t1_hi, iv_l[9]])
        add_eq(sel_bound, n_a_lo, n_a_hi, ca_l, ca_h,
               [t1_lo, s0mj_lo, iv_l[0]], [t1_hi, s0mj_hi, iv_l[1]])

        # register copies — round rows: plain; boundary rows: + iv with CF carries
        copies = [  # (next_lo, next_hi, src_lo, src_hi, iv_base, cf_idx)
            (limb([nbit(B + i) for i in range(32)], True), limb([nbit(B + i) for i in range(32)], False), a_lo, a_hi, 2, 0),
            (limb([nbit(C + i) for i in range(32)], True), limb([nbit(C + i) for i in range(32)], False), b_lo, b_hi, 4, 1),
            (b.next(D_LO), b.next(D_HI), c_lo, c_hi, 6, 2),
            (limb([nbit(F + i) for i in range(32)], True), limb([nbit(F + i) for i in range(32)], False), e_lo, e_hi, 10, 3),
            (limb([nbit(G + i) for i in range(32)], True), limb([nbit(G + i) for i in range(32)], False), f_lo, f_hi, 12, 4),
            (b.next(H_LO), b.next(H_HI), g_lo, g_hi, 14, 5),
        ]
        for n_lo, n_hi, s_lo, s_hi, iv_base, cfi in copies:
            b.assert_zero_transition(b.mul(sel_round, b.sub(n_lo, s_lo)))
            b.assert_zero_transition(b.mul(sel_round, b.sub(n_hi, s_hi)))
            cf_lo, cf_hi = bit(CF + 2 * cfi), bit(CF + 2 * cfi + 1)
            b.assert_zero_transition(
                b.mul(sel_bound, b.sub(b.add(n_lo, b.mul(two16, cf_lo)), b.add(s_lo, iv_l[iv_base])))
            )
            b.assert_zero_transition(
                b.mul(
                    sel_bound,
                    b.sub(b.add(n_hi, b.mul(two16, cf_hi)), b.add(s_hi, iv_l[iv_base + 1], cf_lo)),
                )
            )

        # iv: copied on round rows; set to the new state on boundary rows
        next_regs = [
            (n_a_lo, n_a_hi),
            (limb([nbit(B + i) for i in range(32)], True), limb([nbit(B + i) for i in range(32)], False)),
            (limb([nbit(C + i) for i in range(32)], True), limb([nbit(C + i) for i in range(32)], False)),
            (b.next(D_LO), b.next(D_HI)),
            (n_e_lo, n_e_hi),
            (limb([nbit(F + i) for i in range(32)], True), limb([nbit(F + i) for i in range(32)], False)),
            (limb([nbit(G + i) for i in range(32)], True), limb([nbit(G + i) for i in range(32)], False)),
            (b.next(H_LO), b.next(H_HI)),
        ]
        for j in range(16):
            b.assert_zero_transition(b.mul(sel_round, b.sub(b.next(IV + j), iv_l[j])))
            b.assert_zero_transition(
                b.mul(sel_bound, b.sub(b.next(IV + j), next_regs[j // 2][j % 2]))
            )

        # 4. schedule — round rows only
        sig0_bits = [
            (
                xor3(w1_b[(i + 7) % 32], w1_b[(i + 18) % 32], w1_b[i + 3])
                if i < 29
                else xor2(w1_b[(i + 7) % 32], w1_b[(i + 18) % 32])
            )
            for i in range(32)
        ]
        sig1_bits = [
            (
                xor3(w14_b[(i + 17) % 32], w14_b[(i + 19) % 32], w14_b[i + 10])
                if i < 22
                else xor2(w14_b[(i + 17) % 32], w14_b[(i + 19) % 32])
            )
            for i in range(32)
        ]
        cw_l = b.add(bit(CW), b.mul(b.constant(2), bit(CW + 1)))
        cw_h = b.add(bit(CW + 2), b.mul(b.constant(2), bit(CW + 3)))
        for j in range(15):
            b.assert_zero_transition(
                b.mul(sel_round, b.sub(b.next(WIN + 2 * j), b.local(WIN + 2 * j + 2)))
            )
            b.assert_zero_transition(
                b.mul(sel_round, b.sub(b.next(WIN + 2 * j + 1), b.local(WIN + 2 * j + 3)))
            )
        add_eq(
            sel_round,
            b.next(WIN + 30),
            b.next(WIN + 31),
            cw_l,
            cw_h,
            [b.local(WIN + 0), b.local(WIN + 18), wsum(sig0_bits, True), wsum(sig1_bits, True)],
            [b.local(WIN + 1), b.local(WIN + 19), wsum(sig0_bits, False), wsum(sig1_bits, False)],
        )

        # 5. window binding: on every block's first row the 16-word window
        # equals that block's public message words — one mechanism for both
        # message starts and interior block boundaries
        gb = 0
        for mi, b_m in enumerate(self.block_counts):
            base_pub = self.public_offset(mi)
            for blk in range(b_m):
                sel_blk = b.preprocessed(self._FIXED_PRE + gb)
                for j in range(32):
                    b.assert_zero_all(
                        b.mul(
                            sel_blk,
                            b.sub(b.local(WIN + j), b.public(base_pub + 32 * blk + j)),
                        )
                    )
                gb += 1

        # 6. message-start rows: state = H0, iv = H0
        sel_start = b.preprocessed(5)
        reg_limbs = [
            (a_lo, a_hi), (b_lo, b_hi), (c_lo, c_hi),
            (b.local(D_LO), b.local(D_HI)),
            (e_lo, e_hi), (f_lo, f_hi), (g_lo, g_hi),
            (b.local(H_LO), b.local(H_HI)),
        ]
        for ri in range(8):
            lo_c, hi_c = _u32_limbs(int(_H0[ri]))
            b.assert_zero_all(b.mul(sel_start, b.sub(reg_limbs[ri][0], b.constant(lo_c))))
            b.assert_zero_all(b.mul(sel_start, b.sub(reg_limbs[ri][1], b.constant(hi_c))))
            b.assert_zero_all(b.mul(sel_start, b.sub(iv_l[2 * ri], b.constant(lo_c))))
            b.assert_zero_all(b.mul(sel_start, b.sub(iv_l[2 * ri + 1], b.constant(hi_c))))

        # 7. digest rows: iv limbs equal the message's public digest limbs
        for mi in range(self.num_messages):
            sel_dig = b.preprocessed(self._FIXED_PRE + self.total_blocks + mi)
            doff = self.digest_offset(mi)
            for j in range(16):
                b.assert_zero_all(b.mul(sel_dig, b.sub(iv_l[j], b.public(doff + j))))

    def eval_tensor(self, tb):
        """Tensor path of the prover (``stark/prover.py:TensorBuilder``): the
        constraints of ``eval`` in its α-power order, with the bitwise register
        operations as whole-(rows, 32) int64 tensor ops (rotations are rolls
        along the bit axis), as ``dvt_circuits_tpu/stark/sha256_air.py:
        eval_tensor``.  The verifier replays the scalar ``eval`` at ζ."""
        import torch

        from ..field.babybear import P

        X, NXT, PRE = tb.local, tb.next, tb.pre
        n = X.shape[0]

        def m(a, b):
            return a * b % P

        def sub(a, b):
            return (a - b) % P

        def add(*xs):
            acc = xs[0]
            for x in xs[1:]:
                acc = acc + x
            return acc % P

        # limb weights 2^(i mod 16): a product is below 2^47, 16 of them 2^51
        weights = torch.tensor([1 << (i % 16) for i in range(32)], dtype=torch.int64,
                               device=X.device)

        def wsum_pair(bits32):
            prods = bits32 * weights
            return prods[:, :16].sum(dim=1) % P, prods[:, 16:].sum(dim=1) % P

        def xor3(x, y, z):
            xy = m(x, y)
            return (x + y + z - 2 * (xy + m(y, z) + m(z, x)) + 4 * m(xy, z)) % P

        sel_round, sel_bound, sel_digest = PRE[:, 0], PRE[:, 1], PRE[:, 2]
        k_lo, k_hi = PRE[:, 3], PRE[:, 4]
        sel_rb = add(sel_round, sel_bound)
        sel_active = add(sel_rb, sel_digest)
        trans = tb.sel_transition

        A_, B_, C_ = X[:, A : A + 32], X[:, B : B + 32], X[:, C : C + 32]
        E_, F_, G_ = X[:, E : E + 32], X[:, F : F + 32], X[:, G : G + 32]
        W1 = X[:, W1B : W1B + 32]
        W14 = X[:, W14B : W14B + 32]
        IV_T = X[:, IV : IV + 16]

        # 1. bitness (the scalar loops' column ranges and selectors; CE(6) ‖
        #    CA(6) ‖ CW(4) are contiguous)
        for col, width, sel in ((A, 192, sel_active), (W1B, 64, sel_rb), (CE, 16, sel_rb),
                                (CF, 12, sel_bound)):
            bits = X[:, col : col + width]
            tb.assert_group(m(sel[:, None], m(bits, bits - 1)))

        # 2. w1/w14 bit decompositions match the window limbs
        w1_lo, w1_hi = wsum_pair(W1)
        w14_lo, w14_hi = wsum_pair(W14)
        tb.assert_group(m(sel_rb[:, None], sub(torch.stack([w1_lo, w1_hi, w14_lo, w14_hi], dim=1),
                                               X[:, [WIN + 2, WIN + 3, WIN + 28, WIN + 29]])))

        # 3. round mixers: rotations are rolls along the bit axis
        def roll(t, k):
            return torch.roll(t, -k, dims=1)

        S1 = xor3(roll(E_, 6), roll(E_, 11), roll(E_, 25))
        CH = add(m(E_, F_), m(1 - E_, G_))
        S0 = xor3(roll(A_, 2), roll(A_, 13), roll(A_, 22))
        AB = m(A_, B_)
        MAJ = (AB + m(A_, C_) + m(B_, C_) - 2 * m(AB, C_)) % P
        s1_lo, s1_hi = wsum_pair(S1)
        ch_lo, ch_hi = wsum_pair(CH)
        s0_lo, s0_hi = wsum_pair(S0)
        mj_lo, mj_hi = wsum_pair(MAJ)
        s0mj_lo, s0mj_hi = add(s0_lo, mj_lo), add(s0_hi, mj_hi)
        t1_lo = add(X[:, H_LO], s1_lo, ch_lo, k_lo, X[:, WIN + 0])
        t1_hi = add(X[:, H_HI], s1_hi, ch_hi, k_hi, X[:, WIN + 1])

        def carry3(base):
            return (X[:, base] + 2 * X[:, base + 1] + 4 * X[:, base + 2]) % P

        ce_l, ce_h = carry3(CE), carry3(CE + 3)
        ca_l, ca_h = carry3(CA), carry3(CA + 3)

        n_a_lo, n_a_hi = wsum_pair(NXT[:, A : A + 32])
        n_e_lo, n_e_hi = wsum_pair(NXT[:, E : E + 32])
        a_lo, a_hi = wsum_pair(A_)
        b_lo, b_hi = wsum_pair(B_)
        c_lo, c_hi = wsum_pair(C_)
        e_lo, e_hi = wsum_pair(E_)
        f_lo, f_hi = wsum_pair(F_)
        g_lo, g_hi = wsum_pair(G_)
        sr_t = m(sel_round, trans)
        sb_t = m(sel_bound, trans)

        def add_eq_group(sel_t, out_lo, out_hi, cl, ch_, parts_lo, parts_hi):
            """out + carry·2^16 = Σ parts, per limb (hi receives carry_lo)."""
            lo = out_lo + (1 << 16) * cl - sum(parts_lo)
            hi = out_hi + (1 << 16) * ch_ - sum(parts_hi) - cl
            tb.assert_group(m(sel_t[:, None], torch.stack([lo, hi], dim=1) % P))

        add_eq_group(sr_t, n_e_lo, n_e_hi, ce_l, ce_h,
                     [X[:, D_LO], t1_lo], [X[:, D_HI], t1_hi])
        add_eq_group(sr_t, n_a_lo, n_a_hi, ca_l, ca_h,
                     [t1_lo, s0mj_lo], [t1_hi, s0mj_hi])
        add_eq_group(sb_t, n_e_lo, n_e_hi, ce_l, ce_h,
                     [X[:, D_LO], t1_lo, IV_T[:, 8]], [X[:, D_HI], t1_hi, IV_T[:, 9]])
        add_eq_group(sb_t, n_a_lo, n_a_hi, ca_l, ca_h,
                     [t1_lo, s0mj_lo, IV_T[:, 0]], [t1_hi, s0mj_hi, IV_T[:, 1]])

        # register copies (B,C,D,F,G,H), 4 constraints per copy in eval order
        nb_lo, nb_hi = wsum_pair(NXT[:, B : B + 32])
        nc_lo, nc_hi = wsum_pair(NXT[:, C : C + 32])
        nf_lo, nf_hi = wsum_pair(NXT[:, F : F + 32])
        ng_lo, ng_hi = wsum_pair(NXT[:, G : G + 32])
        copies = [
            (nb_lo, nb_hi, a_lo, a_hi, 2, 0),
            (nc_lo, nc_hi, b_lo, b_hi, 4, 1),
            (NXT[:, D_LO], NXT[:, D_HI], c_lo, c_hi, 6, 2),
            (nf_lo, nf_hi, e_lo, e_hi, 10, 3),
            (ng_lo, ng_hi, f_lo, f_hi, 12, 4),
            (NXT[:, H_LO], NXT[:, H_HI], g_lo, g_hi, 14, 5),
        ]
        for n_lo, n_hi, s_lo, s_hi, iv_base, cfi in copies:
            cf_lo, cf_hi = X[:, CF + 2 * cfi], X[:, CF + 2 * cfi + 1]
            tb.assert_group(torch.stack([
                m(sr_t, n_lo - s_lo),
                m(sr_t, n_hi - s_hi),
                m(sb_t, (n_lo + (1 << 16) * cf_lo - s_lo - IV_T[:, iv_base]) % P),
                m(sb_t, (n_hi + (1 << 16) * cf_hi - s_hi - IV_T[:, iv_base + 1] - cf_lo) % P),
            ], dim=1))

        # iv: copied on round rows / set to the new state on boundary rows,
        # interleaved per limb as the scalar loop's (round, bound) pairs
        next_limbs = torch.stack(
            [n_a_lo, n_a_hi, nb_lo, nb_hi, nc_lo, nc_hi, NXT[:, D_LO], NXT[:, D_HI],
             n_e_lo, n_e_hi, nf_lo, nf_hi, ng_lo, ng_hi, NXT[:, H_LO], NXT[:, H_HI]], dim=1)
        nxt_iv = NXT[:, IV : IV + 16]
        rg = m(sr_t[:, None], nxt_iv - IV_T)
        bg = m(sb_t[:, None], nxt_iv - next_limbs)
        tb.assert_group(torch.stack([rg, bg], dim=2).reshape(n, 32))

        # 4. schedule: the window shifts one word (15 words × 2 limbs)
        tb.assert_group(m(sr_t[:, None], NXT[:, WIN : WIN + 30] - X[:, WIN + 2 : WIN + 32]))
        SIG0 = xor3(roll(W1, 7), roll(W1, 18), torch.cat([W1[:, 3:], W1.new_zeros((n, 3))], dim=1))
        SIG1 = xor3(roll(W14, 17), roll(W14, 19),
                    torch.cat([W14[:, 10:], W14.new_zeros((n, 10))], dim=1))
        sg0_lo, sg0_hi = wsum_pair(SIG0)
        sg1_lo, sg1_hi = wsum_pair(SIG1)
        cw_l = (X[:, CW] + 2 * X[:, CW + 1]) % P
        cw_h = (X[:, CW + 2] + 2 * X[:, CW + 3]) % P
        add_eq_group(sr_t, NXT[:, WIN + 30], NXT[:, WIN + 31], cw_l, cw_h,
                     [X[:, WIN + 0], X[:, WIN + 18], sg0_lo, sg1_lo],
                     [X[:, WIN + 1], X[:, WIN + 19], sg0_hi, sg1_hi])

        # 5. window binding: each block's first row vs its public words
        gb = 0
        for mi, b_m in enumerate(self.block_counts):
            base_pub = self.public_offset(mi)
            for blk in range(b_m):
                sel_blk = PRE[:, self._FIXED_PRE + gb]
                pubs = tb.publics[base_pub + 32 * blk : base_pub + 32 * blk + 32][None, :]
                tb.assert_group(m(sel_blk[:, None], X[:, WIN : WIN + 32] - pubs))
                gb += 1

        # 6. message-start rows: state = H0, iv = H0 (reg_lo, reg_hi, iv_lo,
        #    iv_hi per register, the scalar loop's order)
        sel_start = PRE[:, 5]
        reg_limbs = [(a_lo, a_hi), (b_lo, b_hi), (c_lo, c_hi), (X[:, D_LO], X[:, D_HI]),
                     (e_lo, e_hi), (f_lo, f_hi), (g_lo, g_hi), (X[:, H_LO], X[:, H_HI])]
        for ri in range(8):
            lo_c, hi_c = _u32_limbs(int(_H0[ri]))
            vals = torch.stack([reg_limbs[ri][0], reg_limbs[ri][1], IV_T[:, 2 * ri],
                                IV_T[:, 2 * ri + 1]], dim=1)
            want = torch.tensor([lo_c, hi_c, lo_c, hi_c], dtype=torch.int64, device=X.device)
            tb.assert_group(m(sel_start[:, None], vals - want))

        # 7. digest rows, per message
        for mi in range(self.num_messages):
            sel_dig = PRE[:, self._FIXED_PRE + self.total_blocks + mi]
            doff = self.digest_offset(mi)
            tb.assert_group(m(sel_dig[:, None], IV_T - tb.publics[doff : doff + 16][None, :]))

    # -- helpers ---------------------------------------------------------------

    def check_publics(self, publics) -> None:
        """Limb equalities are canonical only for in-range publics."""
        if len(publics) != self.num_public_values:
            raise ValueError("bad public-value count")
        if any(not 0 <= int(v) < (1 << 16) for v in publics):
            raise ValueError("public limbs must be 16-bit")


def pad_message(data: bytes) -> bytes:
    """FIPS 180-4 padding (mirror of hash/sha256.pack_messages for one msg)."""
    ln = len(data)
    n_blocks = (ln + 9 + 63) // 64
    total = n_blocks * 64
    return data + b"\x80" + b"\x00" * (total - ln - 9) + (8 * ln).to_bytes(8, "big")


def digest_from_publics(air: Sha256Air, publics, message: int = 0) -> bytes:
    """Recompose a message's 32-byte digest from its 16 public limbs."""
    off = air.digest_offset(message)
    limbs = [int(v) for v in publics[off : off + 16]]
    out = b""
    for ri in range(8):
        word = limbs[2 * ri] | (limbs[2 * ri + 1] << 16)
        out += word.to_bytes(4, "big")
    return out


def padded_message_from_publics(air: Sha256Air, publics, message: int = 0) -> bytes:
    """Recompose a message's padded block bytes from its public limbs."""
    off = air.public_offset(message)
    nb = air.block_counts[message]
    limbs = [int(v) for v in publics[off : off + 32 * nb]]
    out = b""
    for wi in range(16 * nb):
        word = limbs[2 * wi] | (limbs[2 * wi + 1] << 16)
        out += word.to_bytes(4, "big")
    return out


def message_from_publics(air: Sha256Air, publics, message: int = 0) -> bytes:
    """Recover the UNPADDED message a table entry hashed, validating the
    FIPS 180-4 padding structure (0x80, zero fill, 64-bit bit length) —
    an adversarial table with malformed padding is rejected rather than
    silently reinterpreted.  Raises ValueError."""
    padded = padded_message_from_publics(air, publics, message)
    bitlen = int.from_bytes(padded[-8:], "big")
    if bitlen % 8:
        raise ValueError("message bit length not byte-aligned")
    ln = bitlen // 8
    if not 0 <= ln <= len(padded) - 9:
        raise ValueError("message length inconsistent with block count")
    if pad_message(padded[:ln]) != padded:
        raise ValueError("malformed SHA-256 padding")
    return padded[:ln]


def message_publics(padded: bytes) -> list:
    """Message limbs exactly as ``generate_trace`` exposes them."""
    out = []
    for off in range(0, len(padded), 4):
        word = int.from_bytes(padded[off : off + 4], "big")
        out.extend(_u32_limbs(word))
    return out
