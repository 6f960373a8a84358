"""ChaCha20 stream cipher (RFC 8439), pure-Python host path.

Mirrors the ``chacha20`` 0.9.1 crate usage in the reference's encrypted-share
guest (crates/bad_encrypted_share_prove/src/main.rs:16-30): 32-byte key,
12-byte (IETF) nonce, keystream starting at block counter 0.

ChaCha20 is pure ARX on 32-bit words — the batched variant (one tensor row
per keystream block) lives in ``dvt_circuits_tpu_torch.hash.chacha20``; this
module is the scalar reference used by the witness programs (payloads are
~100 bytes).
"""

from __future__ import annotations

import struct

_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
_MASK = 0xFFFFFFFF


def _rotl(v, c):
    return ((v << c) | (v >> (32 - c))) & _MASK


def _quarter_round(state, a, b, c, d):
    state[a] = (state[a] + state[b]) & _MASK
    state[d] = _rotl(state[d] ^ state[a], 16)
    state[c] = (state[c] + state[d]) & _MASK
    state[b] = _rotl(state[b] ^ state[c], 12)
    state[a] = (state[a] + state[b]) & _MASK
    state[d] = _rotl(state[d] ^ state[a], 8)
    state[c] = (state[c] + state[d]) & _MASK
    state[b] = _rotl(state[b] ^ state[c], 7)


def chacha20_block(key: bytes, counter: int, nonce: bytes) -> bytes:
    state = list(_CONSTANTS)
    state += list(struct.unpack("<8I", key))
    state.append(counter & _MASK)
    state += list(struct.unpack("<3I", nonce))
    working = list(state)
    for _ in range(10):
        _quarter_round(working, 0, 4, 8, 12)
        _quarter_round(working, 1, 5, 9, 13)
        _quarter_round(working, 2, 6, 10, 14)
        _quarter_round(working, 3, 7, 11, 15)
        _quarter_round(working, 0, 5, 10, 15)
        _quarter_round(working, 1, 6, 11, 12)
        _quarter_round(working, 2, 7, 8, 13)
        _quarter_round(working, 3, 4, 9, 14)
    out = [(w + s) & _MASK for w, s in zip(working, state)]
    return struct.pack("<16I", *out)


def chacha20_keystream(key: bytes, nonce: bytes, length: int, counter: int = 0) -> bytes:
    if len(key) != 32 or len(nonce) != 12:
        raise ValueError("ChaCha20 needs a 32-byte key and 12-byte nonce")
    blocks = []
    produced = 0
    while produced < length:
        blocks.append(chacha20_block(key, counter, nonce))
        counter += 1
        produced += 64
    return b"".join(blocks)[:length]


def chacha20_xor(key: bytes, nonce: bytes, data: bytes, counter: int = 0) -> bytes:
    ks = chacha20_keystream(key, nonce, len(data), counter)
    return bytes(a ^ b for a, b in zip(data, ks))
