"""Batched SHA-256 (FIPS 180-4) over uint32 words held in int64.

Port of ``dvt_circuits_tpu/hash/sha256.py``: a batch of equal-length
messages is packed into (n_blocks, n, 16) big-endian words and compressed
with the batch on the last axes; the 64 rounds run with the rolling 16-word
schedule window of the reference's ``_compress_block``.  The JAX package
wrote this in XLA, not Pallas, so no hand kernel is due: it is plain PyTorch
on the card (``device``, default ``"cuda"``) or the CPU.  ``torch.uint32``
lacks ``+``, ``>>``, ``<<`` and ``~`` on the CPU, so every word is an int64
masked with ``& 0xFFFFFFFF`` after each sum, each left shift and each
complement.  The round constants and IV also serve ``stark/sha256_air.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels

_H0 = np.array(
    [
        0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
        0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
    ],
    dtype=np.uint32,
)
_K = np.array(
    [
        0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
        0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
        0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
        0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
        0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
        0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
        0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
        0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
        0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
        0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
        0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
    ],
    dtype=np.uint32,
)

_MASK = 0xFFFFFFFF


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x >> n) | ((x << (32 - n)) & _MASK)


def _compress_block(state: torch.Tensor, block: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """One SHA-256 compression: state (n, 8), block (n, 16) → (n, 8).

    The 64 rounds carry a rolling 16-word schedule window: round t consumes
    w[0] of the window and appends the word scheduled for round t + 16
    (computed, unused, past round 47), so the 64-word schedule is never
    materialized."""
    a, b, c, d, e, f, g, h = state.unbind(-1)
    w = block
    for t in range(64):
        wt = w[:, 0]
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((~e & _MASK) & g)
        t1 = (h + s1 + ch + k[t] + wt) & _MASK
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = s0 + maj
        sig0 = _rotr(w[:, 1], 7) ^ _rotr(w[:, 1], 18) ^ (w[:, 1] >> 3)
        sig1 = _rotr(w[:, 14], 17) ^ _rotr(w[:, 14], 19) ^ (w[:, 14] >> 10)
        w_new = (w[:, 0] + sig0 + w[:, 9] + sig1) & _MASK
        w = torch.cat([w[:, 1:], w_new[:, None]], dim=1)
        a, b, c, d, e, f, g, h = (t1 + t2) & _MASK, a, b, c, (d + t1) & _MASK, e, f, g
    return (torch.stack([a, b, c, d, e, f, g, h], dim=-1) + state) & _MASK


def sha256_words(blocks: torch.Tensor) -> torch.Tensor:
    """Digest a batch of padded messages: (n_blocks, n, 16) words in int64
    (each below 2^32) → (n, 8) int64 words, on the blocks' device.

    Blocks must already carry FIPS 180-4 padding (see ``pack_messages``)."""
    blocks = torch.as_tensor(blocks).to(torch.int64)
    n = blocks.shape[1]
    dev = blocks.device
    k = torch.as_tensor(_K.astype(np.int64), device=dev)
    state = torch.as_tensor(_H0.astype(np.int64), device=dev).expand(n, 8)
    for i in range(blocks.shape[0]):
        state = _compress_block(state, blocks[i], k)
    return state


def pack_messages(messages, device="cuda") -> torch.Tensor:
    """Pad and pack equal-length byte messages into (n_blocks, n, 16) int64
    words on ``device``."""
    if not messages:
        raise ValueError("empty batch")
    ln = len(messages[0])
    if any(len(m) != ln for m in messages):
        raise ValueError("messages must share one length (pad the batch)")
    n_blocks = (ln + 9 + 63) // 64
    total = n_blocks * 64
    tail = b"\x80" + b"\x00" * (total - ln - 9) + (8 * ln).to_bytes(8, "big")
    buf = np.frombuffer(b"".join(m + tail for m in messages), dtype=">u4").astype(np.int64)
    words = buf.reshape(len(messages), n_blocks, 16).transpose(1, 0, 2)
    return torch.as_tensor(np.ascontiguousarray(words), device=kernels.resolve_device(device))


def digests_to_bytes(digests) -> list:
    """(n, 8) word digests → list of 32-byte digests."""
    if isinstance(digests, torch.Tensor):
        digests = digests.cpu().numpy()
    host = np.asarray(digests).astype(">u4")
    return [row.tobytes() for row in host]


def sha256_batch(messages, device="cuda") -> list:
    """Batched SHA-256 of equal-length byte messages on ``device`` → list of
    32-byte digests."""
    return digests_to_bytes(sha256_words(pack_messages(messages, device)))
