"""Port parity for the whole slice: ``prove_circuit`` on the CPU equals the
JAX package's container (numpy host prover) field by field except
``timing``, for the pre-curve bad-share fault, the curve-fault bad-share
(its G1 scalar-mul table) and bad-partial-key, and the JAX verifier
accepts each; the port's verifier accepts the JAX containers and its own
with the same result and rejects the tampered ones that the JAX verifier
rejects; the CLI ``prove`` matches the JAX CLI; the port imports no jax
and nothing of the JAX package.

The curve containers are proven once per module (a fixture): each takes
about a minute on one CPU thread."""

import copy
import hashlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dvt_circuits_tpu import cli as jax_cli
from dvt_circuits_tpu.prover import pipeline as jax_pipeline
from dvt_circuits_tpu.stark.config import TEST_CONFIG as JAX_TEST_CONFIG
from dvt_circuits_tpu_torch import cli
from dvt_circuits_tpu_torch.dkg import hash_recorder
from dvt_circuits_tpu_torch.dkg.keys import BlsDkgWithSecp256kCommitment
from dvt_circuits_tpu_torch.dkg.scenario_gen import DkgCommittee
from dvt_circuits_tpu_torch.dkg.types import SHA256Raw
from dvt_circuits_tpu_torch.dkg.verification import compute_seed_exchange_hash
from dvt_circuits_tpu_torch.prover import pipeline
from dvt_circuits_tpu_torch.stark.config import TEST_CONFIG

from .test_torch_native import jax_native_poseidon2  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent


def _pre_curve_fault():
    """Auth seed exchange 0 → 1 whose dst_base_hash lies outside the
    committee, re-hashed and re-signed: the guest slashes before the curve
    check (dkg/verification.py:98-105)."""
    com = DkgCommittee(3, 2)
    data = com.shared_data(0, 1, True)
    sec = data.seeds_exchange_commitment
    sec.shared_secret.dst_base_hash = SHA256Raw(hashlib.sha256(b"outsider").digest())
    h = compute_seed_exchange_hash(BlsDkgWithSecp256kCommitment, sec)
    sec.commitment.hash = h
    sec.commitment.signature = com.secp_keys[0].sign(bytes(h)).to_bytes()
    return data


def _curve_fault():
    return DkgCommittee(3, 2).shared_data_bad_secret(0, 1, True)


def _bad_partial_key():
    return DkgCommittee(3, 2).bad_partial_key_data(1, True)


def _jax_data(data, circuit="bad-share"):
    """The same scenario as the JAX package's typed input (via its JSON)."""
    from dvt_circuits_tpu.circuits.registry import get_circuit

    spec = get_circuit(circuit)
    return spec.data_type.from_json(
        json.loads(json.dumps(data.to_json(True))), spec.setup.layout, True
    )


def _without_timing(container):
    return {k: v for k, v in container.items() if k != "timing"}


@pytest.mark.parametrize("scenario, g1_off", [(_pre_curve_fault, False), (_curve_fault, True)],
                         ids=["pre-curve-fault", "curve-fault-DVT_G1=0"])
def test_container_equals_jax_and_verifies(scenario, g1_off, monkeypatch):
    monkeypatch.setenv("DVT_PROVER", "host")
    if g1_off:
        monkeypatch.setenv("DVT_G1", "0")
    data = scenario()
    ours = pipeline.prove_circuit("bad-share", data, True, TEST_CONFIG, device="cpu")
    theirs = jax_pipeline.prove_circuit("bad-share", _jax_data(data), True, JAX_TEST_CONFIG)
    assert ours.keys() == theirs.keys()
    for key in theirs:
        if key != "timing":
            assert ours[key] == theirs[key], key
    assert [g["kind"] for g in ours["gadgets"]] == ["sha256"]
    assert (ours["g1_omitted"] > 0) == g1_off
    res = jax_pipeline.verify_proof(ours, "bad-share")
    assert res.binding == "hash-bound"
    assert pipeline.container_digest(ours) == pipeline.container_digest(theirs)


#: circuit, scenario, chain widths of its G1 table, signature checks re-run
_CURVE_CASES = {
    "curve-fault": ("bad-share", _curve_fault, [256, 32], 1),
    "bad-partial-key": ("bad-partial-key", _bad_partial_key, [32], 2),
}


@pytest.fixture(scope="module")
def curve_containers():
    """(port, JAX) containers of each curve case, each proven once.  Torch
    runs on one thread here: the suite runs several test processes at once,
    and torch's spinning worker threads slow every process on a shared CPU."""
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("DVT_PROVER", "host")
            mp.delenv("DVT_G1", raising=False)
            for case, (circuit, scenario, _, _) in _CURVE_CASES.items():
                data = scenario()
                out[case] = (
                    pipeline.prove_circuit(circuit, data, True, TEST_CONFIG, device="cpu"),
                    jax_pipeline.prove_circuit(circuit, _jax_data(data, circuit), True,
                                               JAX_TEST_CONFIG),
                )
        yield out
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("case", sorted(_CURVE_CASES))
def test_curve_container_equals_jax_and_verifies(curve_containers, case):
    circuit, _, chain_bits, sig_checks = _CURVE_CASES[case]
    ours, theirs = curve_containers[case]
    assert ours.keys() == theirs.keys()
    for key in theirs:
        if key != "timing":
            assert ours[key] == theirs[key], key
    assert [g["kind"] for g in ours["gadgets"]] == ["sha256", "g1mul"]
    assert ours["gadgets"][1]["block_counts"] == chain_bits
    assert ours["g1_omitted"] == 0
    res = jax_pipeline.verify_proof(ours, circuit, strict=True)
    assert (res.binding, res.g1_relations, res.sig_checks) == ("curve-bound+sig", 1, sig_checks)


def _fields(res):
    return (res.circuit, res.binding, res.g1_relations, res.g1_omitted, res.sig_checks)


@pytest.mark.parametrize("case", sorted(_CURVE_CASES))
def test_port_verifier_accepts_jax_and_own_containers(curve_containers, case):
    circuit, _, _, sig_checks = _CURVE_CASES[case]
    ours, theirs = curve_containers[case]
    own = pipeline.verify_proof(ours, circuit, strict=True, device="cpu")
    jax_made = pipeline.verify_proof(theirs, circuit, strict=True, device="cpu")
    reference = jax_pipeline.verify_proof(theirs, circuit, strict=True)
    assert _fields(own) == _fields(jax_made) == _fields(reference)
    assert _fields(own) == (circuit, "curve-bound+sig", 1, 0, sig_checks)


def _tamper_public(container):
    pv = next(g for g in container["gadgets"] if g["kind"] == "g1mul")["proof"]["public_values"]
    pv[0] = (pv[0] + 1) % 256  # first secret byte: the seed-preimage binding breaks


def _strip_g1mul(container):
    container["gadgets"] = [g for g in container["gadgets"] if g["kind"] != "g1mul"]


@pytest.mark.parametrize("tamper", [_tamper_public, _strip_g1mul],
                         ids=["tampered-g1mul-public", "stripped-g1mul-gadget"])
def test_tampered_curve_container_rejected_by_both(curve_containers, tamper):
    bad = copy.deepcopy(curve_containers["curve-fault"][0])
    tamper(bad)
    with pytest.raises(pipeline.VerifyError):
        pipeline.verify_proof(bad, device="cpu")
    with pytest.raises(jax_pipeline.VerifyError):
        jax_pipeline.verify_proof(bad)


def test_recorded_chacha_decrypt_raises(monkeypatch):
    """Despite its name (kept so that the suite's history lines up), a
    recorded ChaCha20 decrypt no longer raises ``ProveError``: one whose key
    is no digest of the SHA-256 table cannot be carried, so it is counted in
    the absorbed ``chacha_omitted`` and the container still verifies
    (``tests/test_torch_chacha.py`` proves the carried ones)."""
    execute = pipeline.execute_circuit

    def execute_with_decrypt(*args, **kwargs):
        result = execute(*args, **kwargs)
        hash_recorder.record_chacha(bytes(32), bytes(12), 0, b"ciphertext")
        return result

    monkeypatch.setattr(pipeline, "execute_circuit", execute_with_decrypt)
    container = pipeline.prove_circuit("bad-share", _pre_curve_fault(), True, TEST_CONFIG,
                                       device="cpu")
    assert container["chacha_omitted"] == 1
    assert [g["kind"] for g in container["gadgets"]] == ["sha256"]
    assert pipeline.verify_proof(container, "bad-share", device="cpu").binding == "hash-bound"


def test_cli_prove_matches_jax_cli(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("DVT_PROVER", "host")
    monkeypatch.setenv("DVT_NO_BANNER", "1")
    scenario = tmp_path / "scenario.json"
    scenario.write_text(json.dumps(_pre_curve_fault().to_json(True)))
    flags = ["--num-queries", "12", "--pow-bits", "6"]
    ours_path, theirs_path = tmp_path / "ours.bin", tmp_path / "theirs.bin"

    assert cli.run(["--auth-commitment", "prove", "--type=bad-share", "-i", str(scenario),
                    "-o", str(ours_path), "--device", "cpu", *flags]) == 0
    ours_out = capsys.readouterr().out
    assert jax_cli.run(["--auth-commitment", "prove", "--type=bad-share", "-i", str(scenario),
                        "-o", str(theirs_path), *flags]) == 0
    theirs_out = capsys.readouterr().out

    ours = pipeline.load_proof(str(ours_path))
    theirs = jax_pipeline.load_proof(str(theirs_path))
    assert _without_timing(ours) == _without_timing(theirs)
    line = re.compile(r"Artifact keccak256: ([0-9a-f]{64})", re.I)
    # each CLI fingerprints its own file; both implementations agree on both
    assert line.search(ours_out).group(1) == jax_cli._artifact_fingerprint(str(ours_path))
    assert line.search(theirs_out).group(1) == cli._artifact_fingerprint(
        str(theirs_path), device="cpu"
    )


def test_execute_cli(tmp_path, capsys):
    scenario = tmp_path / "scenario.json"
    scenario.write_text(json.dumps(_pre_curve_fault().to_json(True)))
    args = ["--auth-commitment", "execute", "--type=bad-share", "-i", str(scenario)]
    assert cli.run(args + ["--show-report"]) == 0
    assert "commits: 4" in capsys.readouterr().out
    valid = tmp_path / "valid.json"
    valid.write_text(json.dumps(DkgCommittee(3, 2).shared_data(0, 1, True).to_json(True)))
    assert cli.run(["--auth-commitment", "execute", "--type=bad-share", "-i", str(valid)]) == 1


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import dvt_circuits_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'dvt_circuits_tpu' or m.startswith('dvt_circuits_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_no_import_of_the_jax_package():
    pattern = re.compile(r"^\s*(from|import)\s+[^#\n]*\bdvt_circuits_tpu(?!_torch)\b", re.M)
    files = sorted((ROOT / "dvt_circuits_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 40
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders
