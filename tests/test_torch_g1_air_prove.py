"""Port parity for a ``G1PolyAir`` proof (``stark/g1_air.py``): the port's
``prove`` on the CPU, whose constraint quotient goes through the ported
``eval_tensor``, equals the JAX package's ``host_prove`` byte for byte at
``TEST_CONFIG``, on the reduced-width table of ``tests/test_g1_air.py``'s
round trip (sk 16 bits, id 8 bits, k = 2: 32 × 26,477); both packages'
STARK verifiers, which replay the scalar ``eval`` at ζ, accept it and refuse
it under a tampered output public."""

import pytest

from dvt_circuits_tpu.stark import verify as jax_verify
from dvt_circuits_tpu.stark.config import TEST_CONFIG as JAX_TEST_CONFIG
from dvt_circuits_tpu.stark.host_prover import host_prove
from dvt_circuits_tpu.stark.verifier import StarkError as JaxStarkError
from dvt_circuits_tpu_torch.pcs.challenger import DuplexChallenger
from dvt_circuits_tpu_torch.stark import TEST_CONFIG, StarkError, prove, verify
from dvt_circuits_tpu_torch.stark import bigfield as bf
from dvt_circuits_tpu_torch.utils import cbor

from .test_torch_g1_air import g1_case
from .test_torch_native import jax_native_poseidon2  # noqa: F401  (autouse)


def test_prove_equals_host_prove_and_both_verify():
    air, jair, trace, publics, *_ = g1_case(6)
    proof = prove(air, trace, publics, TEST_CONFIG, DuplexChallenger("cpu"))
    assert proof["width"] == 26477 and proof["log_n"] == 5
    assert cbor.encode(proof) == cbor.encode(host_prove(jair, trace, publics, JAX_TEST_CONFIG))
    assert verify(air, proof, publics, TEST_CONFIG, device="cpu")
    assert jax_verify(jair, proof, publics, JAX_TEST_CONFIG)
    bad = list(publics)
    bad[air.oa_base + 3] = (bad[air.oa_base + 3] + 1) % (1 << bf.LIMB_BITS)
    with pytest.raises(StarkError, match="constraint quotient identity failed"):
        verify(air, proof, bad, TEST_CONFIG, device="cpu")
    with pytest.raises(JaxStarkError):
        jax_verify(jair, proof, bad, JAX_TEST_CONFIG)
