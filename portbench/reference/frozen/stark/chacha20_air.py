"""ChaCha20 block-function AIR — arithmetizing the encrypted-share decrypt.

The reference's encrypted-share guest decrypts the exchanged payload with
ChaCha20 (key/nonce = SHA-256 of the compressed ECDH point, counter 0 —
crates/bad_encrypted_share_prove/src/main.rs:16-30) and SP1 proves that
execution as RISC-V; this AIR is the TPU framework's native equivalent:
it proves `keystream_block = ChaCha20Block(key, counter, nonce)` (RFC 8439)
for a set of independent 64-byte blocks in ONE table.  The prover pipeline
binds the per-block key to the SHA-256 gadget table's ECDH digest and the
ciphertext to the committed public-value stream, so the decryption
`plaintext = ciphertext XOR keystream` becomes verifier-recomputable.

Layout — 21 rows per block (20 round rows + 1 output row), blocks fully
independent (the counter is a public input, so multi-block keystreams are
just consecutive blocks; cross-block key/nonce/counter consistency is a
public-value check in the verifier):

  * the 16-word working state as 32 bit-columns per word (LSB first) — XORs
    are bit expressions, rotations are free bit re-indexings;
  * the 12 non-constant initial words (key, counter, nonce) ride every row
    as 16-bit limb pairs so the final `working + initial` feed-forward is a
    per-limb add on the output row (the 4 ChaCha constants are constraint
    constants);
  * per quarter-round, the four mod-2^32 *add* results (a1, c1, a2, c2) are
    materialized as bit columns; the interleaved XOR/rotate steps stay
    expressions: d1 = rotl16(d⊕a1) (deg 2), b1 = rotl12(b⊕c1) (deg 2),
    d2 = rotl8(d1⊕a2) (deg 3), b2 = rotl7(b1⊕c2) (deg 3);
  * 32-bit adds are two 16-bit-limb constraints with 1-bit carries
    (BabyBear is 31 bits); the 32 carry bits double as the output row's
    feed-forward carries (disjoint rows).

One row applies a full round: the 4 column-round quarter-rounds
QR(0,4,8,12)… on even rounds, the 4 diagonal QR(0,5,10,15)… on odd rounds,
selected by preprocessed flags.  Max constraint degree: selector ·
transition · b2/d2 = 5 (the blowup-4 budget, same as the SHA-256 table).
The verifier must range-check public limbs < 2^16 (``check_publics``).

Copied from ``dvt_circuits_tpu/stark/chacha20_air.py``; ``eval_tensor``, the
prover's path, is ported to int64 PyTorch ops (the verifier replays the
scalar ``eval`` at ζ).
"""

from __future__ import annotations

import numpy as np

from .air import Air

ROWS_PER_BLOCK = 21  # 20 round rows + 1 output row

CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
_M32 = 0xFFFFFFFF

# quarter-round wirings (RFC 8439 §2.3): column rounds then diagonal rounds
COL_QRS = ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15))
DIAG_QRS = ((0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14))

# -- column layout -----------------------------------------------------------
S = 0  # 16 words × 32 bits (word w bit i at S + 32·w + i, LSB first)
INIT = 512  # 12 ridden init words × 2 limbs: key0..7, counter, nonce0..2
MID = 536  # per QR q: a1 (+0), c1 (+32), a2 (+64), c2 (+96) bit columns
CR = 1048  # per QR q: 8 carry bits (a1,c1,a2,c2 × lo,hi); output row reuses
#            all 32 as per-word feed-forward carries (word w: lo 2w, hi 2w+1)
WIDTH = 1080

PUBLICS_PER_BLOCK = 56  # 24 init limbs (key‖counter‖nonce) + 32 output limbs


def _u32_limbs(v: int) -> tuple:
    return v & 0xFFFF, (v >> 16) & 0xFFFF


def _rotl(v: int, k: int) -> int:
    return ((v << k) | (v >> (32 - k))) & _M32


class ChaCha20Air(Air):
    """Proves ``num_blocks`` independent ChaCha20 block-function evaluations.

    Public values per block: 24 init limbs (key words 0..7, block counter,
    nonce words 0..2, each lo then hi, words little-endian per RFC 8439)
    followed by 32 keystream-output limbs."""

    width = WIDTH

    # preprocessed: sel_col, sel_diag, sel_start(any), sel_out(any),
    #               then per block: sel_start_b, sel_out_b
    _FIXED_PRE = 4

    def __init__(self, num_blocks: int):
        num_blocks = int(num_blocks)
        assert num_blocks >= 1
        self.num_blocks = num_blocks
        self.num_public_values = PUBLICS_PER_BLOCK * num_blocks
        self.preprocessed_width = self._FIXED_PRE + 2 * num_blocks

    def public_offset(self, blk: int) -> int:
        return PUBLICS_PER_BLOCK * blk

    @property
    def min_rows(self) -> int:
        return ROWS_PER_BLOCK * self.num_blocks

    @property
    def log_rows(self) -> int:
        return (self.min_rows - 1).bit_length()

    # -- preprocessed ---------------------------------------------------------

    def preprocessed_trace(self, n: int):
        assert n >= self.min_rows
        pre = np.zeros((n, self.preprocessed_width), dtype=np.uint32)
        for blk in range(self.num_blocks):
            base = ROWS_PER_BLOCK * blk
            for r in range(20):
                pre[base + r, 0 if r % 2 == 0 else 1] = 1  # sel_col / sel_diag
            pre[base, 2] = 1  # sel_start (any)
            pre[base + 20, 3] = 1  # sel_out (any)
            pre[base, self._FIXED_PRE + 2 * blk] = 1
            pre[base + 20, self._FIXED_PRE + 2 * blk + 1] = 1
        return pre

    # -- trace ----------------------------------------------------------------

    def generate_trace(self, inits):
        """``inits``: list of ``num_blocks`` (key32, counter, nonce12) tuples.

        Returns (trace, publics); publics hold init + output limbs per block
        exactly as the constraints bind them."""
        if isinstance(inits, tuple) and len(inits) == 3 and isinstance(inits[0], (bytes, bytearray)):
            inits = [inits]
        assert len(inits) == self.num_blocks
        n = 1 << self.log_rows
        tr = np.zeros((n, WIDTH), dtype=np.uint32)
        publics: list = []

        for blk, (key, counter, nonce) in enumerate(inits):
            assert len(key) == 32 and len(nonce) == 12
            init_words = [
                int.from_bytes(key[4 * i : 4 * i + 4], "little") for i in range(8)
            ]
            init_words.append(int(counter) & _M32)
            init_words += [
                int.from_bytes(nonce[4 * i : 4 * i + 4], "little") for i in range(3)
            ]
            for w in init_words:
                publics.extend(_u32_limbs(w))

            state = list(CONSTANTS) + init_words
            base = ROWS_PER_BLOCK * blk
            for r in range(20):
                row = tr[base + r]
                for w in range(16):
                    for i in range(32):
                        row[S + 32 * w + i] = (state[w] >> i) & 1
                for j in range(24):
                    row[INIT + j] = _u32_limbs(init_words[j // 2])[j % 2]
                wiring = COL_QRS if r % 2 == 0 else DIAG_QRS
                nxt = list(state)
                for q, (ai, bi, ci, di) in enumerate(wiring):
                    a, b_, c, d = nxt[ai], nxt[bi], nxt[ci], nxt[di]
                    qb = MID + 128 * q
                    cb = CR + 8 * q

                    def add32(x, y, slot, carry_off):
                        lo = (x & 0xFFFF) + (y & 0xFFFF)
                        c_lo = lo >> 16
                        hi = (x >> 16) + (y >> 16) + c_lo
                        c_hi = hi >> 16
                        row[cb + carry_off] = c_lo
                        row[cb + carry_off + 1] = c_hi
                        z = (x + y) & _M32
                        for i in range(32):
                            row[qb + slot + i] = (z >> i) & 1
                        return z

                    a1 = add32(a, b_, 0, 0)
                    d1 = _rotl(d ^ a1, 16)
                    c1 = add32(c, d1, 32, 2)
                    b1 = _rotl(b_ ^ c1, 12)
                    a2 = add32(a1, b1, 64, 4)
                    d2 = _rotl(d1 ^ a2, 8)
                    c2 = add32(c1, d2, 96, 6)
                    b2 = _rotl(b1 ^ c2, 7)
                    nxt[ai], nxt[bi], nxt[ci], nxt[di] = a2, b2, c2, d2
                state = nxt

            # output row: final working state bits + ridden init limbs +
            # feed-forward carries; publics get the keystream words
            row = tr[base + 20]
            for w in range(16):
                for i in range(32):
                    row[S + 32 * w + i] = (state[w] >> i) & 1
            for j in range(24):
                row[INIT + j] = _u32_limbs(init_words[j // 2])[j % 2]
            full_init = list(CONSTANTS) + init_words
            for w in range(16):
                iv = full_init[w]
                lo = (state[w] & 0xFFFF) + (iv & 0xFFFF)
                c_lo = lo >> 16
                hi = (state[w] >> 16) + (iv >> 16) + c_lo
                row[CR + 2 * w] = c_lo
                row[CR + 2 * w + 1] = hi >> 16
                publics.extend(_u32_limbs((state[w] + iv) & _M32))
        return tr, publics

    # -- constraints -----------------------------------------------------------

    def eval(self, b):
        one = b.constant(1)
        two16 = b.constant(1 << 16)

        sel_col = b.preprocessed(0)
        sel_diag = b.preprocessed(1)
        sel_start = b.preprocessed(2)
        sel_out = b.preprocessed(3)
        sel_round = b.add(sel_col, sel_diag)
        sel_active = b.add(sel_round, sel_out)

        def xor2(x, y):
            return b.sub(b.add(x, y), b.mul(b.constant(2), b.mul(x, y)))

        def limb(bits, lo: bool):
            rng = range(0, 16) if lo else range(16, 32)
            return b.add(*[b.mul(b.constant(1 << (i % 16)), bits[i]) for i in rng])

        state = [[b.local(S + 32 * w + i) for i in range(32)] for w in range(16)]
        nstate = [[b.next(S + 32 * w + i) for i in range(32)] for w in range(16)]

        # 1. bitness: state on all active rows; QR intermediates on round
        #    rows; carries on round + output rows (the columns are reused)
        for w in range(16):
            for x in state[w]:
                b.assert_zero_all(b.mul(sel_active, x, b.sub(x, one)))
        for col in range(MID, MID + 512):
            x = b.local(col)
            b.assert_zero_all(b.mul(sel_round, x, b.sub(x, one)))
        sel_rc = b.add(sel_round, sel_out)
        for col in range(CR, CR + 32):
            x = b.local(col)
            b.assert_zero_all(b.mul(sel_rc, x, b.sub(x, one)))

        # 2. block-start rows: constants words fixed, words 4..15 = INIT limbs
        for w in range(4):
            lo_c, hi_c = _u32_limbs(CONSTANTS[w])
            b.assert_zero_all(b.mul(sel_start, b.sub(limb(state[w], True), b.constant(lo_c))))
            b.assert_zero_all(b.mul(sel_start, b.sub(limb(state[w], False), b.constant(hi_c))))
        for w in range(4, 16):
            j = 2 * (w - 4)
            b.assert_zero_all(b.mul(sel_start, b.sub(limb(state[w], True), b.local(INIT + j))))
            b.assert_zero_all(b.mul(sel_start, b.sub(limb(state[w], False), b.local(INIT + j + 1))))

        # 3. INIT limbs ride unchanged across each block's rows
        for j in range(24):
            b.assert_zero_transition(
                b.mul(sel_round, b.sub(b.next(INIT + j), b.local(INIT + j)))
            )

        # 4. per-block publics binding of the init limbs (start rows)
        for blk in range(self.num_blocks):
            sel_b = b.preprocessed(self._FIXED_PRE + 2 * blk)
            off = self.public_offset(blk)
            for j in range(24):
                b.assert_zero_all(b.mul(sel_b, b.sub(b.local(INIT + j), b.public(off + j))))

        # 5. round transitions: 4 quarter-rounds per row, wiring by selector
        def rotl_bits(bits, k):
            return [bits[(i - k) % 32] for i in range(32)]

        def add_con(sel, out_bits, c_lo, c_hi, x_lo, x_hi, y_lo, y_hi):
            """out + carry·2^16 = x + y per limb (in-row definition)."""
            b.assert_zero_all(
                b.mul(sel, b.sub(b.add(limb(out_bits, True), b.mul(two16, c_lo)), b.add(x_lo, y_lo)))
            )
            b.assert_zero_all(
                b.mul(
                    sel,
                    b.sub(
                        b.add(limb(out_bits, False), b.mul(two16, c_hi)),
                        b.add(x_hi, y_hi, c_lo),
                    ),
                )
            )

        for sel, wiring in ((sel_col, COL_QRS), (sel_diag, DIAG_QRS)):
            for q, (ai, bi, ci, di) in enumerate(wiring):
                qb = MID + 128 * q
                cb = CR + 8 * q
                a1 = [b.local(qb + i) for i in range(32)]
                c1 = [b.local(qb + 32 + i) for i in range(32)]
                a2 = [b.local(qb + 64 + i) for i in range(32)]
                c2 = [b.local(qb + 96 + i) for i in range(32)]
                cr = [b.local(cb + i) for i in range(8)]
                a_b, b_b = state[ai], state[bi]
                c_b, d_b = state[ci], state[di]
                # a1 = a + b
                add_con(sel, a1, cr[0], cr[1],
                        limb(a_b, True), limb(a_b, False), limb(b_b, True), limb(b_b, False))
                # d1 = rotl16(d ⊕ a1); c1 = c + d1
                d1 = rotl_bits([xor2(d_b[i], a1[i]) for i in range(32)], 16)
                add_con(sel, c1, cr[2], cr[3],
                        limb(c_b, True), limb(c_b, False), limb(d1, True), limb(d1, False))
                # b1 = rotl12(b ⊕ c1); a2 = a1 + b1
                b1 = rotl_bits([xor2(b_b[i], c1[i]) for i in range(32)], 12)
                add_con(sel, a2, cr[4], cr[5],
                        limb(a1, True), limb(a1, False), limb(b1, True), limb(b1, False))
                # d2 = rotl8(d1 ⊕ a2); c2 = c1 + d2
                d2 = rotl_bits([xor2(d1[i], a2[i]) for i in range(32)], 8)
                add_con(sel, c2, cr[6], cr[7],
                        limb(c1, True), limb(c1, False), limb(d2, True), limb(d2, False))
                # b2 = rotl7(b1 ⊕ c2); next state: a←a2, b←b2, c←c2, d←d2
                b2 = rotl_bits([xor2(b1[i], c2[i]) for i in range(32)], 7)
                for out_bits, src in ((nstate[ai], a2), (nstate[bi], b2),
                                      (nstate[ci], c2), (nstate[di], d2)):
                    b.assert_zero_transition(
                        b.mul(sel, b.sub(limb(out_bits, True), limb(src, True)))
                    )
                    b.assert_zero_transition(
                        b.mul(sel, b.sub(limb(out_bits, False), limb(src, False)))
                    )

        # 6. output rows: publics = working + initial, per limb with carries
        for blk in range(self.num_blocks):
            sel_b = b.preprocessed(self._FIXED_PRE + 2 * blk + 1)
            off = self.public_offset(blk) + 24
            for w in range(16):
                if w < 4:
                    lo_c, hi_c = _u32_limbs(CONSTANTS[w])
                    iv_lo, iv_hi = b.constant(lo_c), b.constant(hi_c)
                else:
                    j = 2 * (w - 4)
                    iv_lo, iv_hi = b.local(INIT + j), b.local(INIT + j + 1)
                c_lo, c_hi = b.local(CR + 2 * w), b.local(CR + 2 * w + 1)
                b.assert_zero_all(
                    b.mul(
                        sel_b,
                        b.sub(
                            b.add(b.public(off + 2 * w), b.mul(two16, c_lo)),
                            b.add(limb(state[w], True), iv_lo),
                        ),
                    )
                )
                b.assert_zero_all(
                    b.mul(
                        sel_b,
                        b.sub(
                            b.add(b.public(off + 2 * w + 1), b.mul(two16, c_hi)),
                            b.add(limb(state[w], False), iv_hi, c_lo),
                        ),
                    )
                )

    def eval_tensor(self, tb):
        """Tensor path of the prover (``stark/prover.py:TensorBuilder``): the
        constraints of ``eval`` in its α-power order, with the bitwise word
        operations as whole-(rows, 32) int64 tensor ops (rotations are rolls
        along the bit axis of a word's slice), as
        ``dvt_circuits_tpu/stark/chacha20_air.py:eval_tensor``.  Groups that
        the reference asserts once per block are asserted as one group of
        consecutive blocks (the same α powers).  The verifier replays the
        scalar ``eval`` at ζ."""
        import torch

        from ..field.babybear import P

        X, NXT, PRE = tb.local, tb.next, tb.pre
        n = X.shape[0]
        nb = self.num_blocks

        def m(a, b):
            return a * b % P

        def add(a, b):
            return (a + b) % P

        def sub(a, b):
            return (a - b) % P

        weights = torch.tensor([1 << i for i in range(16)], dtype=torch.int64, device=X.device)
        const_limbs = torch.tensor([v for w in CONSTANTS for v in _u32_limbs(w)],
                                   dtype=torch.int64, device=X.device)

        def limbs(bits):
            """(rows, 32·k) bit columns → (rows, k, 2) lo/hi 16-bit limbs: the
            weighted bits summed as a tree, each level reduced."""
            t = m(bits.unflatten(1, (-1, 2, 16)), weights)
            while t.shape[-1] > 1:
                half = t.shape[-1] // 2
                t = add(t[..., :half], t[..., half:])
            return t[..., 0]

        def xor2(x, y):
            return sub(x + y, 2 * m(x, y))

        def roll(t, k):  # rotl k of an LSB-first (rows, 32) word
            return torch.roll(t, k, dims=1)

        sel_col, sel_diag, sel_start, sel_out = (PRE[:, i] for i in range(4))
        sel_round = add(sel_col, sel_diag)
        sel_active = add(sel_round, sel_out)
        trans = tb.sel_transition

        # 1. bitness (the scalar loops' column ranges and selectors)
        for col, width, sel in ((S, 512, sel_active), (MID, 512, sel_round),
                                (CR, 32, sel_active)):
            bits = X[:, col : col + width]
            tb.assert_group(m(sel[:, None], m(bits, bits - 1)))

        state = X[:, S : S + 512]
        s_limbs = limbs(state)  # (rows, 16, 2)
        n_limbs = limbs(NXT[:, S : S + 512])
        # the initial state's limbs: the constants, then the ridden INIT limbs
        init = X[:, INIT : INIT + 24]
        iv_limbs = torch.cat([const_limbs.expand(n, 8), init], dim=1)  # (rows, 32)

        # 2. block-start rows: words 0..3 the constants, 4..15 the INIT limbs
        tb.assert_group(m(sel_start[:, None], sub(s_limbs.flatten(1), iv_limbs)))

        # 3. INIT limbs ride unchanged across each block's rows
        tb.assert_group(m(m(sel_round, trans)[:, None], sub(NXT[:, INIT : INIT + 24], init)))

        # 4. per-block publics binding of the init limbs, block after block
        pubs = tb.publics[: PUBLICS_PER_BLOCK * nb].view(nb, PUBLICS_PER_BLOCK)
        sel_b = PRE[:, self._FIXED_PRE : self._FIXED_PRE + 2 * nb : 2]  # (rows, nb)
        tb.assert_group(m(sel_b[:, :, None], sub(init[:, None, :], pubs[None, :, :24])).flatten(1))

        # 5. round transitions: 4 quarter-rounds per row, wiring by selector
        for sel, wiring in ((sel_col, COL_QRS), (sel_diag, DIAG_QRS)):
            sel_t = m(sel, trans)
            for q, (ai, bi, ci, di) in enumerate(wiring):
                qb, cb = MID + 128 * q, CR + 8 * q
                a1, c1, a2, c2 = (X[:, qb + 32 * k : qb + 32 * k + 32] for k in range(4))
                a1l, c1l, a2l, c2l = limbs(X[:, qb : qb + 128]).unbind(1)
                d1 = roll(xor2(state[:, 32 * di : 32 * di + 32], a1), 16)
                b1 = roll(xor2(state[:, 32 * bi : 32 * bi + 32], c1), 12)
                d2 = roll(xor2(d1, a2), 8)
                b2 = roll(xor2(b1, c2), 7)
                d1l, b1l, d2l, b2l = limbs(torch.cat([d1, b1, d2, b2], dim=1)).unbind(1)
                # out + carry·2^16 = x + y per limb, the hi limb also takes the
                # lo carry: a1 = a + b, c1 = c + d1, a2 = a1 + b1, c2 = c1 + d2
                carries = X[:, cb : cb + 8].unflatten(1, (4, 2))
                g = (torch.stack([a1l, c1l, a2l, c2l], dim=1) + (1 << 16) * carries
                     - torch.stack([s_limbs[:, ai], s_limbs[:, ci], a1l, c1l], dim=1)
                     - torch.stack([s_limbs[:, bi], d1l, b1l, d2l], dim=1))
                g[:, :, 1] -= carries[:, :, 0]
                tb.assert_group(m(sel[:, None], g.flatten(1) % P))
                # next state: a <- a2, b <- b2, c <- c2, d <- d2
                tb.assert_group(m(sel_t[:, None], sub(
                    n_limbs[:, [ai, bi, ci, di]], torch.stack([a2l, b2l, c2l, d2l], dim=1)
                ).flatten(1)))

        # 6. output rows: publics = working + initial per limb with carries,
        #    block after block
        carries = X[:, CR : CR + 32]  # word w: lo 2w, hi 2w + 1
        rhs = (1 << 16) * carries - s_limbs.flatten(1) - iv_limbs
        rhs[:, 1::2] -= carries[:, 0::2]
        sel_b = PRE[:, self._FIXED_PRE + 1 : self._FIXED_PRE + 2 * nb : 2]
        tb.assert_group(m(sel_b[:, :, None], (rhs[:, None, :] + pubs[None, :, 24:]) % P).flatten(1))

    # -- helpers ---------------------------------------------------------------

    def check_publics(self, publics) -> None:
        """Limb equalities are canonical only for in-range publics."""
        if len(publics) != self.num_public_values:
            raise ValueError("bad public-value count")
        if any(not 0 <= int(v) < (1 << 16) for v in publics):
            raise ValueError("public limbs must be 16-bit")


def init_publics(key: bytes, counter: int, nonce: bytes) -> list:
    """The 24 init limbs exactly as ``generate_trace`` exposes them."""
    words = [int.from_bytes(key[4 * i : 4 * i + 4], "little") for i in range(8)]
    words.append(int(counter) & _M32)
    words += [int.from_bytes(nonce[4 * i : 4 * i + 4], "little") for i in range(3)]
    out = []
    for w in words:
        out.extend(_u32_limbs(w))
    return out


def init_from_publics(publics, blk: int) -> tuple:
    """Recompose (key, counter, nonce) from block ``blk``'s init limbs."""
    off = PUBLICS_PER_BLOCK * blk
    words = [
        int(publics[off + 2 * i]) | (int(publics[off + 2 * i + 1]) << 16)
        for i in range(12)
    ]
    key = b"".join(w.to_bytes(4, "little") for w in words[:8])
    nonce = b"".join(w.to_bytes(4, "little") for w in words[9:12])
    return key, words[8], nonce


def keystream_from_publics(publics, blk: int) -> bytes:
    """Recompose block ``blk``'s 64-byte keystream from its output limbs."""
    off = PUBLICS_PER_BLOCK * blk + 24
    words = [
        int(publics[off + 2 * i]) | (int(publics[off + 2 * i + 1]) << 16)
        for i in range(16)
    ]
    return b"".join(w.to_bytes(4, "little") for w in words)
