"""Kernel tests that need a CUDA card (marker ``cuda``; they skip without
one).  This file imports only the port, so on a machine without jax it
runs with ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``."""

import hashlib

import numpy as np
import pytest
import torch

from dvt_circuits_tpu_torch import probe_vpu
from dvt_circuits_tpu_torch.hash import keccak
from dvt_circuits_tpu_torch.hash import poseidon2 as p2
from dvt_circuits_tpu_torch.stark import TEST_CONFIG, prove_tables, verify
from dvt_circuits_tpu_torch.stark.airs import FibonacciAir

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 127, 129, 8192])
def test_poseidon2_kernel_matches_plain(card, n):
    x = np.random.default_rng(n).integers(0, p2.bb.P, (n, 16), dtype=np.int64)
    x[0] = p2.bb.P - 1
    t = torch.as_tensor(x, device=card)
    before = p2.poseidon2_permute.launches
    got = p2.poseidon2_permute(t)
    assert p2.poseidon2_permute.launches == before + 1
    assert torch.equal(got, p2.permute_plain(t))
    assert got[0].tolist() == p2.s_permute(x[0].tolist())


@pytest.mark.parametrize("n", [1, 300])
def test_keccak_kernel_matches_plain(card, n):
    y = torch.as_tensor(
        np.random.default_rng(n).integers(-(1 << 63), (1 << 63) - 1, (n, 25)), device=card
    )
    assert torch.equal(keccak.keccak_f1600(y), keccak.keccak_f1600_plain(y))
    for msgs in ([b""], [b"abc" * 50, b"xyz" * 50]):  # one length per batch
        assert keccak.sha3_256_batch(msgs) == [hashlib.sha3_256(m).digest() for m in msgs]


def test_proof_on_card_equals_cpu_proof(card):
    trace = FibonacciAir.generate_trace(64)
    entry = [(FibonacciAir(), trace, FibonacciAir.public_values(trace))]
    assert prove_tables(entry, TEST_CONFIG, device=card) == prove_tables(
        entry, TEST_CONFIG, device="cpu"
    )


@pytest.mark.parametrize("n", [1, 4096])
def test_mulchain_kernel_matches_plain(card, n):
    x = np.random.default_rng(n).integers(0, 1 << 32, (19, n), dtype=np.int64)
    x[0], x[1], x[2] = 0, 1, (1 << 32) - 1
    t = torch.as_tensor(x, device=card)
    before = probe_vpu.mulchain.launches
    got = probe_vpu.mulchain(t)
    assert probe_vpu.mulchain.launches == before + 1
    assert torch.equal(got, probe_vpu.mulchain_plain(t))


def test_verifier_on_card_accepts_card_proof(card):
    trace = FibonacciAir.generate_trace(64)
    publics = FibonacciAir.public_values(trace)
    proof, = prove_tables([(FibonacciAir(), trace, publics)], TEST_CONFIG, device=card)
    before = p2.poseidon2_permute.launches
    assert verify(FibonacciAir(), proof, publics, TEST_CONFIG, device=card)
    assert p2.poseidon2_permute.launches > before
    assert verify(FibonacciAir(), proof, publics, TEST_CONFIG, device="cpu")
