"""Port parity: Keccak-256 / SHA3-256 vs the JAX package (its XLA path on
the CPU), the Ethereum Keccak-256 goldens and hashlib; the sponge
(``keccak_sponge``, K2b's plain path on the CPU) vs a loop of one
permutation per block."""

import hashlib

import numpy as np
import pytest
import torch

from dvt_circuits_tpu.hash import keccak as jkeccak
from dvt_circuits_tpu_torch.hash import keccak


@pytest.mark.parametrize("ln", [0, 1, 32, 135, 136, 137, 300])
def test_keccak256_matches_jax(ln):
    rng = np.random.default_rng(ln)
    msgs = [rng.integers(0, 256, size=ln, dtype=np.uint8).tobytes() for _ in range(3)]
    assert keccak.keccak256_batch(msgs, device="cpu") == jkeccak.keccak256_batch(msgs)


def test_keccak256_golden():
    assert keccak.keccak256_batch([b""], device="cpu")[0] == bytes.fromhex(
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
    )
    assert keccak.keccak256_batch([b"abc"], device="cpu")[0] == bytes.fromhex(
        "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"
    )


def test_sha3_256_matches_hashlib():
    rng = np.random.default_rng(7)
    for ln in (0, 135, 136, 200):
        msgs = [rng.integers(0, 256, size=ln, dtype=np.uint8).tobytes() for _ in range(4)]
        assert keccak.sha3_256_batch(msgs, device="cpu") == [
            hashlib.sha3_256(m).digest() for m in msgs
        ]


@pytest.mark.parametrize("n_blocks, n", [(1, 1), (1, 5), (3, 1), (3, 4)])
def test_sponge_equals_a_permutation_per_block(n_blocks, n):
    rng = np.random.default_rng(n_blocks * 10 + n)
    blocks = torch.as_tensor(rng.integers(-(1 << 63), (1 << 63) - 1, (n_blocks, n, 17)))
    state = torch.zeros((n, 25), dtype=torch.int64)
    for blk in blocks:
        state[:, :17] ^= blk
        state = keccak.keccak_f1600(state)
    assert torch.equal(keccak.keccak_sponge(blocks), state[:, :4])


@pytest.mark.parametrize("ln", [0, 135, 136, 300])
def test_sponge_of_packed_messages_equals_hashlib(ln):
    rng = np.random.default_rng(ln + 1)
    msgs = [rng.integers(0, 256, size=ln, dtype=np.uint8).tobytes() for _ in range(3)]
    blocks = torch.as_tensor(keccak._pack(msgs, 0x06))
    assert blocks.shape == (ln // 136 + 1, 3, 17)
    digests = keccak.keccak_sponge(blocks).numpy().astype("<i8")
    assert [row.tobytes() for row in digests] == [hashlib.sha3_256(m).digest() for m in msgs]
