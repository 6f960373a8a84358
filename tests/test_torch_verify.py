"""Port parity for the verifier on inputs that prove in seconds: a
container whose curve relations were omitted (``DVT_G1=0``), a
Fibonacci STARK with each part of its proof tampered in turn, a gadget
renamed to another kind, and the CLI ``verify`` against the JAX CLI.  The
curve containers' acceptance and rejection tests live in
``test_torch_pipeline.py``, beside the fixture that proves them once."""

import copy
import re

import pytest

from dvt_circuits_tpu import cli as jax_cli
from dvt_circuits_tpu.prover import pipeline as jax_pipeline
from dvt_circuits_tpu.stark import verify as jax_stark_verify
from dvt_circuits_tpu.stark.airs import FibonacciAir as JaxFib
from dvt_circuits_tpu.stark.config import TEST_CONFIG as JAX_TEST_CONFIG
from dvt_circuits_tpu.stark.verifier import StarkError as JaxStarkError
from dvt_circuits_tpu_torch import cli
from dvt_circuits_tpu_torch.dkg.scenario_gen import DkgCommittee
from dvt_circuits_tpu_torch.prover import pipeline
from dvt_circuits_tpu_torch.prover.pipeline import VerifyError, verify_proof
from dvt_circuits_tpu_torch.stark import TEST_CONFIG, StarkError, prove_tables, verify
from dvt_circuits_tpu_torch.stark.airs import FibonacciAir

from .test_torch_native import jax_native_poseidon2  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def g1_omitted():
    """The port's curve-fault container with the relation omitted
    (``DVT_G1=0``): the stream and SHA-256 tables only."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DVT_G1", "0")
        data = DkgCommittee(3, 2).shared_data_bad_secret(0, 1, True)
        return pipeline.prove_circuit("bad-share", data, True, TEST_CONFIG, device="cpu")


def _fields(res):
    return (res.circuit, res.binding, res.g1_relations, res.g1_omitted, res.sig_checks)


def test_strict_rejects_omitted_relations(g1_omitted):
    assert g1_omitted["g1_omitted"] == 1
    res = verify_proof(g1_omitted, "bad-share", device="cpu")  # flagged, not rejected
    assert _fields(res) == ("bad-share", "hash-bound", 0, 1, 0)
    assert _fields(res) == _fields(jax_pipeline.verify_proof(g1_omitted, "bad-share"))
    with pytest.raises(VerifyError, match="strict: 1 curve relation"):
        verify_proof(g1_omitted, strict=True, device="cpu")
    with pytest.raises(jax_pipeline.VerifyError):
        jax_pipeline.verify_proof(g1_omitted, strict=True)


def test_wrong_circuit_name_rejected(g1_omitted):
    with pytest.raises(VerifyError, match="expected 'finalization'"):
        verify_proof(g1_omitted, "finalization", device="cpu")
    with pytest.raises(jax_pipeline.VerifyError):
        jax_pipeline.verify_proof(g1_omitted, "finalization")


#: what both verifiers say of a SHA-256 gadget renamed to each kind: each
#: kind's own checks refuse a SHA-256 descriptor, which carries no extras
#: (the ChaCha20 gadget's, and the legacy wide-G1 gadget's)
_RENAMED_GADGET_ERRORS = {"chacha20": "chacha extras malformed",
                          "g1": "g1 extras malformed"}


@pytest.mark.parametrize("kind", ["chacha20", "g1"])
def test_renamed_gadget_kinds_rejected(g1_omitted, kind, monkeypatch):
    """A gadget renamed to another kind is rejected, never skipped, by that
    kind's own checks, with the JAX verifier's message.  The tables' STARKs
    are stubbed out in both packages so that the renamed gadget reaches the
    dispatch (its new kind id no longer matches the stream digest)."""
    monkeypatch.setattr(pipeline, "stark_verify", lambda *args: True)
    monkeypatch.setattr(jax_pipeline, "stark_verify", lambda *args: True)
    bad = copy.deepcopy(g1_omitted)
    bad["gadgets"][0]["kind"] = kind
    with pytest.raises(VerifyError) as ours:
        verify_proof(bad, device="cpu")
    with pytest.raises(jax_pipeline.VerifyError) as theirs:
        jax_pipeline.verify_proof(bad)
    assert str(ours.value) == str(theirs.value) == _RENAMED_GADGET_ERRORS[kind]


@pytest.fixture(scope="module")
def fib_proof():
    trace = FibonacciAir.generate_trace(32)
    publics = FibonacciAir.public_values(trace)
    proof, = prove_tables([(FibonacciAir(), trace, publics)], TEST_CONFIG, device="cpu")
    return proof, publics


def _flip_last_byte(blob):
    b = bytearray(blob)
    b[-1] ^= 1
    return bytes(b)


def _tamper_opening(p):
    p["query_openings"][3]["t"]["lo"]["row"] = _flip_last_byte(p["query_openings"][3]["t"]["lo"]["row"])


def _tamper_fri_leaf(p):
    leaf = p["fri"]["queries"][5]["rounds"][1]["leaf"]
    p["fri"]["queries"][5]["rounds"][1]["leaf"] = _flip_last_byte(leaf)


def _tamper_final_coeff(p):
    p["fri"]["final_coeffs"][0][0] = (p["fri"]["final_coeffs"][0][0] + 1) % 2013265921


def _tamper_pow_witness(p):
    p["fri"]["pow_witness"] += 1


def _tamper_opened_value(p):
    p["opened_t_zeta"] = _flip_last_byte(p["opened_t_zeta"])


@pytest.mark.parametrize(
    "tamper, message",
    [
        (_tamper_opening, "outer Merkle opening"),
        (_tamper_fri_leaf, "Merkle opening in round 1"),
        (_tamper_final_coeff, "FRI verification failed"),
        (_tamper_pow_witness, "proof-of-work"),
        (_tamper_opened_value, "quotient identity"),
    ],
    ids=["outer-opening", "fri-leaf", "final-coeff", "pow-witness", "opened-value"],
)
def test_stark_verify_agrees_with_jax_on_tampered_proof(fib_proof, tamper, message):
    proof, publics = fib_proof
    assert verify(FibonacciAir(), proof, publics, TEST_CONFIG, device="cpu")
    assert jax_stark_verify(JaxFib(), proof, publics, JAX_TEST_CONFIG)
    bad = copy.deepcopy(proof)
    tamper(bad)
    with pytest.raises(StarkError, match=message):
        verify(FibonacciAir(), bad, publics, TEST_CONFIG, device="cpu")
    with pytest.raises(JaxStarkError, match=message):
        jax_stark_verify(JaxFib(), bad, publics, JAX_TEST_CONFIG)


def test_cli_verify_matches_jax_cli(g1_omitted, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("DVT_NO_BANNER", "1")
    path = tmp_path / "proof.bin"
    pipeline.save_proof(g1_omitted, str(path))
    args = ["verify", "--type=bad-share", "-i", str(path), "--show-report"]
    assert cli.run(args + ["--device", "cpu"]) == 0
    ours = capsys.readouterr().out
    assert jax_cli.run(args) == 0
    theirs = capsys.readouterr().out
    report = re.compile(r"circuit: .*|artifact keccak256: [0-9a-f]{64}")
    assert report.findall(ours) == report.findall(theirs)
    assert len(report.findall(ours)) == 2 and "binding: hash-bound" in ours

    # strict callers reject the omission, as the JAX CLI does
    assert cli.run(args + ["--require-curve-binding", "--device", "cpu"]) == 1
    assert jax_cli.run(args + ["--require-curve-binding"]) == 1
    capsys.readouterr()
    flipped = bytearray(path.read_bytes())
    flipped[len(flipped) // 2] ^= 1
    path.write_bytes(bytes(flipped))
    assert cli.run(args + ["--device", "cpu"]) == 1
