"""Port parity: the Fiat–Shamir grind, and multi-table STARK proofs vs the
JAX host prover (``host_prove_tables``) dict for dict, accepted by the JAX
verifier."""

import numpy as np
import pytest

from dvt_circuits_tpu.pcs.challenger import DuplexChallenger as JaxChallenger
from dvt_circuits_tpu.stark import verify as jax_verify
from dvt_circuits_tpu.stark.airs import FibonacciAir as JaxFib
from dvt_circuits_tpu.stark.config import TEST_CONFIG as JAX_TEST_CONFIG
from dvt_circuits_tpu.stark.host_prover import host_prove_tables
from dvt_circuits_tpu.stark.poseidon2_air import Poseidon2StreamAir as JaxStreamAir
from dvt_circuits_tpu.stark.sha256_air import Sha256Air as JaxShaAir
from dvt_circuits_tpu_torch.pcs.challenger import DuplexChallenger
from dvt_circuits_tpu_torch.stark import TEST_CONFIG, prove_tables
from dvt_circuits_tpu_torch.stark.airs import FibonacciAir
from dvt_circuits_tpu_torch.stark.poseidon2_air import Poseidon2StreamAir
from dvt_circuits_tpu_torch.stark.sha256_air import Sha256Air, pad_message


@pytest.mark.parametrize("bits, prefix", [(4, 0), (7, 3), (9, 8)])
def test_grind_finds_the_lowest_witness(bits, prefix):
    words = np.random.default_rng(bits).integers(0, 1 << 30, 13).tolist()
    ours, theirs = DuplexChallenger("cpu"), JaxChallenger()
    for ch in (ours, theirs):
        ch.observe_many(words[:prefix])
        if prefix:
            ch.sample()
        ch.observe_many(words[prefix:])
    w = ours.grind(bits)
    assert w == theirs.grind(bits)
    assert ours.state == theirs.state
    assert [ours.sample() for _ in range(10)] == [theirs.sample() for _ in range(10)]


def _tables():
    """(port entries, JAX entries): Fibonacci, the Poseidon2 stream AIR and
    a two-message SHA-256 table, with identical traces."""
    fib_trace = FibonacciAir.generate_trace(32)
    fib_pub = FibonacciAir.public_values(fib_trace)
    words = np.random.default_rng(3).integers(0, 1 << 16, 19).tolist()
    stream, jstream = Poseidon2StreamAir(4), JaxStreamAir(4)
    s_trace, s_pub = stream.generate_trace(words)
    msgs = [pad_message(b"dvt" * 30), pad_message(b"")]
    counts = tuple(len(m) // 64 for m in msgs)
    sha, jsha = Sha256Air(counts), JaxShaAir(counts)
    h_trace, h_pub = sha.generate_trace(msgs)
    jt, jp = jsha.generate_trace(msgs)
    assert np.array_equal(h_trace, jt) and h_pub == jp
    assert np.array_equal(s_trace, jstream.generate_trace(words)[0])
    ours = [(FibonacciAir(), fib_trace, fib_pub), (stream, s_trace, s_pub), (sha, h_trace, h_pub)]
    theirs = [(JaxFib(), fib_trace, fib_pub), (jstream, s_trace, s_pub), (jsha, h_trace, h_pub)]
    return ours, theirs


def test_prove_tables_matches_host_prover_and_verifies():
    ours, theirs = _tables()
    proofs = prove_tables(ours, TEST_CONFIG, device="cpu")
    want, _ = host_prove_tables(theirs, JAX_TEST_CONFIG)
    assert len(proofs) == len(want) == 3
    for got, exp in zip(proofs, want):
        assert got.keys() == exp.keys()
        for key in exp:
            assert got[key] == exp[key], key
    ch = JaxChallenger()
    for (air, _, pub), proof in zip(theirs, proofs):
        assert jax_verify(air, proof, pub, JAX_TEST_CONFIG, ch)
