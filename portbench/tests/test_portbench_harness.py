"""The harness on the CPU: cells found by name, the generator, the
reference against the port, the result line, the run without a card and
the permutation count of the roofline."""

from __future__ import annotations

import json
import sys
import types

import pytest

from portbench import run as run_mod
from portbench.core import harness, traffic
from portbench.core.roofline import prove_work
from portbench.core.spec import ROOT, SpecError, load_cell
from portbench.tests.portbench_cells import CELL, cell, make_root, proven, run_cached  # noqa: F401

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_by_name(name):
    cell = load_cell(name)
    assert cell.config["name"] == name.split(".")[0]
    assert cell.mix_name == name.split(".", 1)[1]
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "prove_ms"}
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.reader(m["name"]))


def test_unknown_cell_is_refused():
    with pytest.raises(SpecError):
        load_cell("no-such-config.no-such-mix")


def test_a_cell_of_new_data_files_alone_is_found(tmp_path):
    root = make_root(tmp_path, pool=3)
    cell = load_cell(CELL, root=root)
    assert (cell.config["n"], cell.config["k"], int(cell.mix["pool"])) == (3, 2, 3)
    assert [m["name"] for m in cell.end_to_end] == [m["name"] for m in BENCH["end_to_end"]]
    raw = traffic.scenario(cell.config, cell.mix, cell.mix_name, 5, 0)
    assert len(json.loads(raw)["base_hashes"]) == 3


@pytest.mark.parametrize("name", CELLS)
def test_generator_is_deterministic_in_the_seed(name):
    cell = load_cell(name)
    big = 2**31 + 123456789
    a = traffic.scenario(cell.config, cell.mix, cell.mix_name, big, 0)
    assert a == traffic.scenario(cell.config, cell.mix, cell.mix_name, big, 0)
    assert a != traffic.scenario(cell.config, cell.mix, cell.mix_name, big + 1, 0)
    assert a != traffic.scenario(cell.config, cell.mix, cell.mix_name, big, 1)
    assert a != traffic.scenario(cell.config, cell.mix, cell.mix_name, big, traffic.WARM)


@pytest.mark.parametrize("builder,args", [("shared_data_bad_secret", (0, 1, True)),
                                          ("finalization_data", ())])
def test_frozen_generator_equals_the_port_generator(builder, args):
    from dvt_circuits_tpu_torch.dkg.scenario_gen import DkgCommittee as PortCommittee

    from portbench.traffic.generator import DkgCommittee

    seed = traffic.committee_seed({"name": "x"}, "mix", 7, 0)
    ours = getattr(DkgCommittee(4, 3, seed=seed), builder)(*args).to_json(True)
    port = getattr(PortCommittee(4, 3, seed=seed), builder)(*args).to_json(True)
    assert json.dumps(ours) == json.dumps(port)


@pytest.mark.parametrize("circuit,builder,args", [
    ("bad-share", "shared_data_bad_secret", (0, 1, True)),
    ("finalization", "finalization_data", ()),
])
def test_reference_public_values_equal_the_port(circuit, builder, args):
    from dvt_circuits_tpu_torch.circuits.registry import get_circuit as port_circuit
    from dvt_circuits_tpu_torch.prover.pipeline import execute_circuit as port_execute

    from portbench.reference.frozen.circuits.registry import get_circuit
    from portbench.reference.frozen.prover.pipeline import execute_circuit
    from portbench.traffic.generator import DkgCommittee

    raw = json.dumps(getattr(DkgCommittee(3, 2, seed=b"pv"), builder)(*args).to_json(True))
    spec, pspec = get_circuit(circuit), port_circuit(circuit)
    ours = execute_circuit(circuit, spec.data_type.from_json(json.loads(raw), spec.setup.layout,
                                                             True), True)
    port = port_execute(circuit, pspec.data_type.from_json(json.loads(raw), pspec.setup.layout,
                                                            True), True)
    assert ours.exit_code == port.exit_code == 0
    assert ours.public_values == port.public_values and ours.public_values
    assert ours.commit_count == port.commit_count


def test_frozen_ladders_equal_the_affine_ones():
    import random

    from portbench.reference.frozen.hostcrypto import bls12_381 as bls
    from portbench.reference.frozen.hostcrypto import secp256k1 as secp

    rng = random.Random(3)
    ks = [0, 1, 2, 15, 16, bls.R - 1, bls.R, bls.R + 1, (1 << 256) - 1, 1 << 256, -7]
    for k in ks + [rng.getrandbits(256) for _ in range(6)]:
        assert bls.g1_mul_raw(bls.G1_GEN, k) == bls.g1_mul_affine(bls.G1_GEN, k)
        p = bls.g1_mul_affine(bls.G1_GEN, 5)
        assert bls.g1_mul_raw(p, k) == bls.g1_mul_affine(p, k)
        assert bls.g2_mul_raw(bls.G2_GEN, k) == bls.g2_mul_affine(bls.G2_GEN, k)
        if k > 0:
            assert secp._mul(secp.G, k) == secp._mul_affine(secp.G, k)


def test_the_reference_accepts_the_port_containers(cell, proven):
    from portbench.reference import check

    for raw, container in proven["containers"].items():
        assert check.statement_differs(raw, container, cell.config, "bad-share") == ""
        assert check.rejection(container, cell.config, "bad-share") == ""


def test_result_line_keys_are_the_contract(cell, proven):
    out = run_cached(cell, proven)
    line = out.line
    assert list(line) == CONTRACT_KEYS + ["checks"]
    assert line["correct"] is True and line["attempted"] == 2 and line["failed"] == 0
    assert set(line["metrics"]) == {"prove_ms", "verify_ms", "setup_s"}  # no card: no peak
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    assert json.loads(json.dumps(line)) == line


def test_traced_line_has_breakdown_and_window(cell, proven):
    line = run_cached(cell, proven, trace=True).line
    assert list(line) == CONTRACT_KEYS + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(line["breakdown"]["idle_gaps"]) <= 10
    # the port's own timing splits are read; no device operation ran
    assert set(line["metrics"]) == {"witness_ms", "tables_ms"}


def test_no_card_exits_without_a_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run_mod.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_forbidden_modules_are_found_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "dvt_circuits_tpu_torch_x", types.ModuleType("x"))
    assert "dvt_circuits_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert "jax" in harness.forbidden_modules()


def test_roofline_counts_the_permutations_the_prover_ran(proven):
    first = next(iter(proven["containers"].values()))
    perms, moved = prove_work(first)
    assert perms == proven["first_perms"]
    assert moved > 0
