"""Batched ChaCha20 block function (RFC 8439) on int64 tensors.

Port of ``dvt_circuits_tpu/hash/chacha20_tpu.py``: one row per keystream
block, so many blocks (of one long payload, or of many payloads) are one
pass of plain PyTorch ops.  A word is an int64 holding its 32-bit value;
every addition and rotation masks back to 32 bits.  Off the prover's path,
as in the JAX package: the witness decrypts with the scalar
``hostcrypto/chacha20.py`` and the prover proves the blocks with
``stark/chacha20_air.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels

_M32 = 0xFFFFFFFF
_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
# quarter-round words: even rounds the columns, odd rounds the diagonals
_COLS = ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15))
_DIAGS = ((0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14))


def _rotl(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x << n) | (x >> (32 - n))) & _M32


def _quarter(w: list, a: int, b: int, c: int, d: int) -> None:
    w[a] = (w[a] + w[b]) & _M32
    w[d] = _rotl(w[d] ^ w[a], 16)
    w[c] = (w[c] + w[d]) & _M32
    w[b] = _rotl(w[b] ^ w[c], 12)
    w[a] = (w[a] + w[b]) & _M32
    w[d] = _rotl(w[d] ^ w[a], 8)
    w[c] = (w[c] + w[d]) & _M32
    w[b] = _rotl(w[b] ^ w[c], 7)


def chacha20_blocks(states: torch.Tensor) -> torch.Tensor:
    """(n, 16) initial states → (n, 16) keystream blocks (words, LE order)."""
    init = list(states.unbind(1))
    w = list(init)
    for _ in range(10):
        for group in _COLS + _DIAGS:
            _quarter(w, *group)
    return torch.stack([(x + s) & _M32 for x, s in zip(w, init)], dim=1)


def make_states(key: bytes, nonce: bytes, counters, device="cuda") -> torch.Tensor:
    """One (key, nonce) with many counters → (n, 16) initial states."""
    if len(key) != 32 or len(nonce) != 12:
        raise ValueError("ChaCha20 needs a 32-byte key and 12-byte nonce")
    counters = np.asarray(list(counters), dtype=np.int64)
    st = np.empty((len(counters), 16), dtype=np.int64)
    st[:, 0:4] = _CONSTANTS
    st[:, 4:12] = np.frombuffer(key, dtype="<u4")
    st[:, 12] = counters & _M32
    st[:, 13:16] = np.frombuffer(nonce, dtype="<u4")
    return torch.as_tensor(st, device=kernels.resolve_device(device))


def keystream(key: bytes, nonce: bytes, length: int, counter: int = 0, device="cuda") -> bytes:
    """``length`` keystream bytes from block ``counter`` on: all blocks in one
    batch."""
    n_blocks = (length + 63) // 64
    blocks = chacha20_blocks(make_states(key, nonce, range(counter, counter + n_blocks), device))
    return blocks.cpu().numpy().astype("<u4").tobytes()[:length]


def xor(key: bytes, nonce: bytes, data: bytes, counter: int = 0, device="cuda") -> bytes:
    ks = np.frombuffer(keystream(key, nonce, len(data), counter, device), dtype=np.uint8)
    return (np.frombuffer(data, dtype=np.uint8) ^ ks).tobytes()
