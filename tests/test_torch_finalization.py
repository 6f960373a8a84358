"""Port parity for finalization, the positive proof that a DKG completed,
at a 2-of-3 committee and ``TEST_CONFIG``:

* the container with its curve relation omitted (``DVT_G1=0``): the stream
  and SHA-256 tables; the port's container equals the JAX package's field
  by field except ``timing``, and each verifier gives the other's container
  the same result;
* the aggregation table's chain layout (chains of two widths, several
  chains): the tensor quotient equals the generic ``eval``'s, for any row
  chunk;
* the whole container, its aggregation table (chains 3 × 32 + 6 × 256 bits:
  2^14 × 4314 rows, LDE 2^16) included: equal to the JAX package's field by
  field except ``timing``, each verifier accepting the other's as
  ``curve-bound+sig``.  The JAX host prover alone takes about 10 minutes and
  16 GB of host memory for it, so this case carries the repository's
  ``heavy`` marker (run it with ``DVT_HEAVY_TESTS=1``), as the JAX
  package's own finalization container test does.  ``chip_smoke.py`` holds
  the port's GPU container to its CPU container on the card."""

import json
from functools import lru_cache

import numpy as np
import pytest
import torch

from dvt_circuits_tpu.prover import pipeline as jax_pipeline
from dvt_circuits_tpu.stark.config import TEST_CONFIG as JAX_TEST_CONFIG
from dvt_circuits_tpu_torch.dkg.scenario_gen import DkgCommittee
from dvt_circuits_tpu_torch.field import babybear as bb
from dvt_circuits_tpu_torch.field import ext
from dvt_circuits_tpu_torch.hostcrypto import bls12_381 as host
from dvt_circuits_tpu_torch.prover import pipeline
from dvt_circuits_tpu_torch.stark import prover
from dvt_circuits_tpu_torch.stark.config import TEST_CONFIG
from dvt_circuits_tpu_torch.stark.g1mul_air import G1MulAir

from .test_torch_native import jax_native_poseidon2  # noqa: F401  (autouse)
from .test_torch_quotient import _EvalOnly, chunk_budget


def _jax_data(data):
    """The same scenario as the JAX package's typed input (via its JSON)."""
    from dvt_circuits_tpu.circuits.registry import get_circuit

    spec = get_circuit("finalization")
    return spec.data_type.from_json(json.loads(json.dumps(data.to_json(True))),
                                    spec.setup.layout, True)


def _fields(res):
    return (res.circuit, res.binding, res.g1_relations, res.g1_omitted, res.sig_checks)


def _prove_both(monkeypatch):
    """(port CPU container, JAX host-prover container) of the 2-of-3
    finalization, torch on one thread."""
    monkeypatch.setenv("DVT_PROVER", "host")
    data = DkgCommittee(3, 2).finalization_data()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ours = pipeline.prove_circuit("finalization", data, True, TEST_CONFIG, device="cpu")
    finally:
        torch.set_num_threads(threads)
    theirs = jax_pipeline.prove_circuit("finalization", _jax_data(data), True, JAX_TEST_CONFIG)
    return ours, theirs


def _assert_equal_and_cross_verified(ours, theirs, strict, want):
    assert ours.keys() == theirs.keys()
    for key in theirs:
        if key != "timing":
            assert ours[key] == theirs[key], key
    assert pipeline.container_digest(ours) == pipeline.container_digest(theirs)
    results = [
        pipeline.verify_proof(ours, "finalization", strict=strict, device="cpu"),
        pipeline.verify_proof(theirs, "finalization", strict=strict, device="cpu"),
        jax_pipeline.verify_proof(ours, "finalization", strict=strict),
        jax_pipeline.verify_proof(theirs, "finalization", strict=strict),
    ]
    assert all(_fields(r) == want for r in results)


def test_finalization_without_curve_table_equals_jax(monkeypatch):
    monkeypatch.setenv("DVT_G1", "0")
    ours, theirs = _prove_both(monkeypatch)
    assert [g["kind"] for g in ours["gadgets"]] == ["sha256"]
    assert ours["g1_omitted"] == 1
    _assert_equal_and_cross_verified(ours, theirs, False, ("finalization", "hash-bound", 0, 1, 0))


@pytest.mark.heavy
def test_finalization_container_equals_jax(monkeypatch):
    monkeypatch.delenv("DVT_G1", raising=False)
    ours, theirs = _prove_both(monkeypatch)
    assert [g["kind"] for g in ours["gadgets"]] == ["sha256", "g1mul"]
    g1 = ours["gadgets"][1]
    assert g1["block_counts"] == [32] * 3 + [256] * 6
    assert (g1["proof"]["log_n"], g1["proof"]["width"]) == (14, 4314)
    _assert_equal_and_cross_verified(ours, theirs, True,
                                     ("finalization", "curve-bound+sig", 1, 0, 3))


#: the aggregation table's layout in small: two chain widths, three chains
_MULTICHAIN = (8, 8, 16)


@lru_cache(maxsize=None)
def _multichain():
    """The quotient's inputs for a table of ``_MULTICHAIN`` random chains,
    and the generic ``eval``'s quotient of them."""
    rng = np.random.default_rng(21)
    chains = [(bytes(rng.integers(0, 256, bits // 8, dtype=np.uint8)),
               host.g1_mul(host.G1_GEN, int(rng.integers(2, 1 << 40)))) for bits in _MULTICHAIN]
    air = G1MulAir(_MULTICHAIN)
    trace, publics = air.generate_trace(chains)
    n = trace.shape[0]
    log_n = n.bit_length() - 1
    t_lde = prover.lde_body(torch.as_tensor(np.asarray(trace, dtype=np.int64)), TEST_CONFIG)
    p_lde = prover.lde_body(torch.as_tensor(np.asarray(air.preprocessed_trace(n), dtype=np.int64)),
                            TEST_CONFIG)
    tables = prover._domain_tables(log_n, TEST_CONFIG.log_blowup, TEST_CONFIG.shift,
                                   torch.device("cpu"))
    alpha = tuple(int(v) for v in rng.integers(0, bb.P, ext.D))
    args = (t_lde, p_lde, alpha, publics, tables, log_n, TEST_CONFIG)
    return air, args, prover.quotient_body(_EvalOnly(air), *args)


@pytest.mark.parametrize("chunk_rows", [None, 64, 8], ids=["default", "64-rows", "8-rows"])
def test_multichain_tensor_quotient_equals_generic_eval(chunk_rows, monkeypatch):
    air, args, want = _multichain()
    chunk_budget(monkeypatch, chunk_rows, air.width)
    got = prover.quotient_body(air, *args)
    assert got[2] == want[2]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _g1mul_entry(chain_bits):
    return {"block_counts": list(chain_bits), "proof": {"public_values": [0]}}


def test_verifier_takes_finalization_chain_counts_above_64():
    """The 7-of-10 aggregation table has n·(k + 1) = 80 chains (49,440 rows):
    the JAX verifier's cap of 64 chains rejects it, though its prover proves
    it; the port's verifier bounds the table's height instead, so the entry
    reaches its publics check (here: wrong on purpose)."""
    entry = _g1mul_entry([32] * 60 + [256] * 20)
    args = (b"", None, TEST_CONFIG, None, True, "finalization")
    with pytest.raises(pipeline.VerifyError, match="g1mul publics"):
        pipeline._verify_g1mul_gadget(entry, *args)
    with pytest.raises(jax_pipeline.VerifyError, match="chain count out of range"):
        jax_pipeline._verify_g1mul_gadget(entry, b"", None, JAX_TEST_CONFIG, None, True,
                                          "finalization")
    for bad, why in (([], "chain count out of range"), ([256] * 74, "table too tall")):
        with pytest.raises(pipeline.VerifyError, match=why):
            pipeline._verify_g1mul_gadget(_g1mul_entry(bad), *args)
