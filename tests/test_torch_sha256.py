"""Port parity for the batched SHA-256 (``dvt_circuits_tpu_torch/hash/sha256.py``)
on the CPU: the digests of the JAX package's cases
(``tests/test_hash_kernels.py``) against ``hashlib`` and the JAX
``sha256_batch``, the packed words against the JAX ``pack_messages``, and
the same errors."""

import hashlib

import numpy as np
import pytest

from dvt_circuits_tpu.hash import sha256 as jax_sha256
from dvt_circuits_tpu_torch.hash import sha256


@pytest.mark.parametrize("msg_len", [0, 1, 3, 32, 55, 56, 64, 100, 129, 200])
def test_sha256_batch_matches_hashlib_and_jax(msg_len):
    rng = np.random.default_rng(msg_len)
    msgs = [rng.integers(0, 256, size=msg_len, dtype=np.uint8).tobytes() for _ in range(9)]
    got = sha256.sha256_batch(msgs, device="cpu")
    assert got == [hashlib.sha256(m).digest() for m in msgs]
    assert got == jax_sha256.sha256_batch(msgs)
    words = sha256.pack_messages(msgs, device="cpu")
    assert np.array_equal(words.numpy(), np.asarray(jax_sha256.pack_messages(msgs)))
    digests = sha256.sha256_words(words)
    assert digests.shape == (9, 8)
    assert np.array_equal(digests.numpy(),
                          np.asarray(jax_sha256.sha256_words(jax_sha256.pack_messages(msgs))))


def test_sha256_large_batch():
    msgs = [bytes([i % 256]) * 80 for i in range(257)]
    got = sha256.sha256_batch(msgs, device="cpu")
    assert got == [hashlib.sha256(m).digest() for m in msgs]
    assert got == jax_sha256.sha256_batch(msgs)


@pytest.mark.parametrize("msgs", [[], [b"a", b"bb"]], ids=["empty", "mixed-lengths"])
def test_pack_messages_errors_equal_jax(msgs):
    with pytest.raises(ValueError) as ours:
        sha256.pack_messages(msgs, device="cpu")
    with pytest.raises(ValueError) as theirs:
        jax_sha256.pack_messages(msgs)
    assert str(ours.value) == str(theirs.value)
