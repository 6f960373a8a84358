"""Port parity for the G1 scalar-mul table: ``G1MulAir`` traces, a proof
of the table against the JAX host prover dict for dict, and
``curve_glue.build_gadget`` for the three relation kinds against the JAX
package.  Every comparison is bit-exact (the tolerance for a finite
field)."""

import json

import numpy as np
import pytest

from dvt_circuits_tpu.circuits.guest_api import run_guest as jax_run_guest
from dvt_circuits_tpu.circuits.registry import get_circuit as jax_get_circuit
from dvt_circuits_tpu.dkg import hash_recorder as jax_recorder
from dvt_circuits_tpu.pcs.challenger import DuplexChallenger as JaxChallenger
from dvt_circuits_tpu.prover import curve_glue as jax_glue
from dvt_circuits_tpu.stark import verify as jax_verify
from dvt_circuits_tpu.stark.airs import FibonacciAir as JaxFib
from dvt_circuits_tpu.stark.config import TEST_CONFIG as JAX_TEST_CONFIG
from dvt_circuits_tpu.stark.g1mul_air import G1MulAir as JaxG1MulAir
from dvt_circuits_tpu.stark.host_prover import host_prove_tables
from dvt_circuits_tpu.stark.sha256_air import Sha256Air as JaxSha256Air
from dvt_circuits_tpu.utils import cbor as jax_cbor
from dvt_circuits_tpu_torch.circuits.guest_api import run_guest
from dvt_circuits_tpu_torch.circuits.registry import get_circuit
from dvt_circuits_tpu_torch.dkg import hash_recorder
from dvt_circuits_tpu_torch.dkg.scenario_gen import DkgCommittee
from dvt_circuits_tpu_torch.hostcrypto import bls12_381 as host
from dvt_circuits_tpu_torch.pcs.challenger import DuplexChallenger
from dvt_circuits_tpu_torch.prover import curve_glue
from dvt_circuits_tpu_torch.stark import TEST_CONFIG, g1mul_air, prove_tables, verify
from dvt_circuits_tpu_torch.stark.airs import FibonacciAir
from dvt_circuits_tpu_torch.stark.g1mul_air import G1MulAir
from dvt_circuits_tpu_torch.stark.sha256_air import Sha256Air, pad_message
from dvt_circuits_tpu_torch.utils import cbor


def _chains(chain_bits, seed):
    """(scalar bytes, operand point) per chain, from a numpy seed."""
    rng = np.random.default_rng(seed)
    out = []
    for bits in chain_bits:
        scalar = bytes(rng.integers(0, 256, bits // 8, dtype=np.uint8))
        point = host.g1_mul(host.G1_GEN, int(rng.integers(2, 1 << 40)))
        out.append((scalar, point))
    return out


def test_g1mul_traces_equal_jax():
    chain_bits = (8, 16)
    chains = _chains(chain_bits, 11)
    ours, theirs = G1MulAir(chain_bits), JaxG1MulAir(chain_bits)
    trace, publics = ours.generate_trace(chains)
    j_trace, j_publics = theirs.generate_trace(chains)
    assert trace.shape == j_trace.shape and trace.shape[1] == G1MulAir.width == 4314
    assert np.array_equal(trace, j_trace)
    assert publics == j_publics
    n = trace.shape[0]
    assert np.array_equal(np.asarray(ours.preprocessed_trace(n)),
                          np.asarray(theirs.preprocessed_trace(n)))
    for c, (scalar, point) in enumerate(chains):
        assert ours.operand_of(publics, c) == point
        inf, *xy = ours.result_of(publics, c)
        assert (inf, tuple(xy)) == (0, host.g1_mul(point, int.from_bytes(scalar, "big")))


def _scalar_case(chains, scalars):
    """Chain 0's scalar made all zero (its result the point at infinity) or
    given two leading zero bytes; otherwise the chains as drawn."""
    (scalar, point), rest = chains[0], chains[1:]
    if scalars == "zero":
        scalar = bytes(len(scalar))
    elif scalars == "leading-zeros":
        scalar = bytes(2) + scalar[2:]
    return [(scalar, point)] + rest


@pytest.mark.parametrize("chain_bits, scalars, row_chunk", [
    ((8,), "random", None),
    ((8, 16), "random", None),
    ((256,), "random", None),
    ((16, 8, 24), "random", None),
    ((8, 16), "zero", None),
    ((24, 16), "leading-zeros", None),
    ((16, 8, 24), "random", 64),
    ((256,), "leading-zeros", 200),
], ids=lambda v: "-".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_g1mul_trace_assembly_equals_jax(monkeypatch, chain_bits, scalars, row_chunk):
    """The trace assembled by torch ops on the CPU equals the JAX package's
    numpy one, padding rows included; chunks of 64 and 200 rows put their
    borders inside ladder steps and inside chains (200 leaves a short last
    chunk)."""
    if row_chunk:
        monkeypatch.setattr(g1mul_air, "ROW_CHUNK", row_chunk)
    chains = _scalar_case(_chains(chain_bits, sum(chain_bits)), scalars)
    ours = G1MulAir(chain_bits)
    trace, publics = ours.generate_trace(chains, device="cpu")
    j_trace, j_publics = JaxG1MulAir(chain_bits).generate_trace(chains)
    assert trace.dtype == np.uint32 and trace.shape == j_trace.shape
    assert trace.shape[0] > ours.min_rows  # padding rows
    assert np.array_equal(trace, j_trace)
    assert publics == j_publics
    assert ours.result_of(publics, 0)[0] == (scalars == "zero")


@pytest.mark.parametrize("call, message", [(1, "mul witness"), (4, "red witness")],
                         ids=["mul-quotient", "red-quotient"])
def test_g1mul_trace_assembly_refuses_a_planted_quotient(monkeypatch, call, message):
    """A quotient off by one, its remainder kept, fails the device's carry
    checks: mul 0's is the first division, the RED gadget's the fourth."""
    divmod_p, calls = g1mul_air._divmod_p, []

    def planted(vals):
        q, r = divmod_p(vals)
        calls.append(1)
        if len(calls) == call:
            q = q.copy()
            q[1] += 1
        return q, r

    monkeypatch.setattr(g1mul_air, "_divmod_p", planted)
    with pytest.raises(AssertionError, match=message):
        G1MulAir((8,)).generate_trace(_chains((8,), 13), device="cpu")
    assert len(calls) == 4


def test_prove_tables_with_g1mul_matches_host_prover():
    chains = _chains((8,), 12)
    air = G1MulAir((8,))
    trace, publics = air.generate_trace(chains)
    fib_trace = FibonacciAir.generate_trace(16)
    fib_pub = FibonacciAir.public_values(fib_trace)
    proofs = prove_tables([(FibonacciAir(), fib_trace, fib_pub), (air, trace, publics)],
                          TEST_CONFIG, device="cpu")
    want, _ = host_prove_tables(
        [(JaxFib(), fib_trace, fib_pub), (JaxG1MulAir((8,)), trace, publics)], JAX_TEST_CONFIG
    )
    assert len(proofs) == len(want) == 2
    for got, exp in zip(proofs, want):
        assert got.keys() == exp.keys()
        for key in exp:
            assert got[key] == exp[key], key
    ch, jch = DuplexChallenger("cpu"), JaxChallenger()
    for a, j_a, pub, proof in ((FibonacciAir(), JaxFib(), fib_pub, proofs[0]),
                               (air, JaxG1MulAir((8,)), publics, proofs[1])):
        assert verify(a, proof, pub, TEST_CONFIG, ch)
        assert jax_verify(j_a, proof, pub, JAX_TEST_CONFIG, jch)


def _sorted_sha(recorded):
    """Distinct SHA relations in first-use order, re-sorted by block count
    as the pipeline sorts its table."""
    seen, rels = set(), []
    for pre, dig in recorded:
        if dig not in seen:
            seen.add(dig)
            rels.append((pre, dig))
    order = sorted(range(len(rels)), key=lambda i: -len(pad_message(rels[i][0])))
    return [rels[i][0] for i in order], [rels[i][1] for i in order]


def _gadgets(circuit, data, auth, port: bool):
    """Run the witness of one package and build every recorded relation's
    gadget with that package's glue."""
    get, run, rec, cb, glue, sha = (
        (get_circuit, run_guest, hash_recorder, cbor, curve_glue, Sha256Air) if port
        else (jax_get_circuit, jax_run_guest, jax_recorder, jax_cbor, jax_glue, JaxSha256Air)
    )
    spec = get(circuit)
    if not port:
        data = spec.data_type.from_json(json.loads(json.dumps(data.to_json(auth))),
                                        spec.setup.layout, auth)
    with rec.recording() as rh, rec.chacha_recording(), rec.g1_recording() as rg:
        res = run(spec.guest, cb.encode(data.to_json(auth)), auth)
    assert res.exit_code == 0, res.panic_message
    originals, digests = _sorted_sha(rh)
    out = []
    for rel in rg:
        gadget, (air, trace, publics) = glue.build_gadget(
            rel, originals, digests, res.public_values, auth
        )
        sha_air = sha(tuple(len(pad_message(m)) // 64 for m in originals))
        _, sha_pub = sha_air.generate_trace([pad_message(m) for m in originals])
        check = glue.verify_gadget_glue(air, publics, gadget["extras"], res.public_values,
                                        (sha_air, sha_pub), auth, circuit)
        out.append((gadget, air.chain_bits, trace, publics, check))
    return out


_DATA = {
    "bad-share": lambda auth: DkgCommittee(3, 2).shared_data_bad_secret(0, 1, auth),
    "bad-partial-key": lambda auth: DkgCommittee(3, 2).bad_partial_key_data(1, auth),
    "finalization": lambda auth: DkgCommittee(3, 2).finalization_data(),
}


@pytest.mark.parametrize("auth", [True, False], ids=["auth", "noauth"])
@pytest.mark.parametrize(
    "circuit, kind, chain_bits",
    [
        ("bad-share", "poly", (256, 32)),
        ("bad-partial-key", "partial", (32,)),
        ("finalization", "agg", (32,) * 3 + (256,) * 6),
    ],
    ids=["poly", "partial", "agg"],
)
def test_build_gadget_equals_jax(circuit, kind, chain_bits, auth):
    data = _DATA[circuit](auth)
    ours = _gadgets(circuit, data, auth, port=True)
    theirs = _gadgets(circuit, data, auth, port=False)
    assert len(ours) == len(theirs) == 1
    (gadget, bits, trace, publics, check), = ours
    (j_gadget, j_bits, j_trace, j_publics, j_check), = theirs
    assert bits == j_bits == chain_bits
    assert {k: v for k, v in gadget.items() if k != "proof"} == {
        k: v for k, v in j_gadget.items() if k != "proof"
    }
    assert np.array_equal(trace, j_trace)
    assert publics == j_publics
    assert check == j_check and check[0] == kind
