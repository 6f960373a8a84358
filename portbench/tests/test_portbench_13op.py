"""The ``g1_pad_share`` reader on handmade span records, and the frozen
reference's public values against the port's on a 13-operator ceremony,
the largest cluster SSV documents."""

from __future__ import annotations

import json
import sys

import pytest

from dvt_circuits_tpu_torch.utils import spans as port_spans

from portbench.core.harness import Run, reader
from portbench.core.trace import Trace

WINDOW = (1_000.0, 100_000.0)  # microseconds on the profiler's clock


def _rec(name, id_, parent, root, start_us, end_us, **counters):
    return port_spans.Record(name, id_, parent, root, 1, int(start_us * 1e3), int(end_us * 1e3),
                             counters)


#: two proves of two g1mul tables each (one span per table's counters in
#: the first, both tables' counts on one span in the second), a prove
#: before the window, and a verify
RECORDS = [
    _rec("prove", 90, None, 90, 0, 900, g1_chain_rows=1, g1_trace_rows=10**6),
    _rec("witness.g1", 3, 2, 1, 2_100, 2_500, g1_chain_rows=70_148, g1_trace_rows=131_072),
    _rec("witness.g1", 4, 2, 1, 2_500, 3_000, g1_chain_rows=3_000, g1_trace_rows=4_096),
    _rec("witness", 2, 1, 1, 2_000, 5_000),
    _rec("prove", 1, None, 1, 2_000, 12_000),
    _rec("verify", 10, None, 10, 12_000, 15_000),
    _rec("witness.g1", 15, 14, 13, 20_000, 21_000, g1_chain_rows=49_440 + 16_160,
         g1_trace_rows=65_536 + 16_384),
    _rec("witness", 14, 13, 13, 20_000, 22_000),
    _rec("prove", 13, None, 13, 20_000, 30_000),
]
EXPECTED = 1.0 - (70_148 + 3_000 + 49_440 + 16_160) / (131_072 + 4_096 + 65_536 + 16_384)


def _run(trace=True):
    tr = Trace(spans=[], ops=[], window=WINDOW) if trace else None
    return Run(cell=None, records=[], window_s=99.0, setup_s=1.0, peak_bytes=0, trace=tr)


def _drop(counter):
    return [r._replace(counters={k: v for k, v in r.counters.items() if k != counter})
            for r in RECORDS]


@pytest.mark.parametrize("records,expected", [
    (RECORDS, EXPECTED),
    # one table: the 9-of-13 finalization's 70,148 chain rows in 2^17
    (RECORDS[:2] + RECORDS[3:5], 1.0 - 70_148 / 131_072),
])
def test_pad_share_reads_the_exact_value(records, expected, monkeypatch):
    monkeypatch.setattr(port_spans, "records", lambda: list(records))
    assert reader("g1_pad_share")(_run()) == pytest.approx(expected, rel=1e-12)


@pytest.mark.parametrize("records", [
    [],
    _drop("g1_chain_rows"),  # a port without the chain counter (the parent's)
    _drop("g1_trace_rows"),  # the chain counter alone
    [r._replace(start_ns=r.start_ns + 10**12, end_ns=r.end_ns + 10**12) for r in RECORDS],
], ids=["no-records", "no-chain-rows", "no-trace-rows", "outside-the-window"])
def test_pad_share_is_none_when_a_counter_is_absent(records, monkeypatch):
    monkeypatch.setattr(port_spans, "records", lambda: list(records))
    assert reader("g1_pad_share")(_run()) is None


def test_pad_share_is_none_untraced_or_for_a_port_without_spans(monkeypatch):
    monkeypatch.setattr(port_spans, "records", lambda: list(RECORDS))
    assert reader("g1_pad_share")(_run(trace=False)) is None
    monkeypatch.setitem(sys.modules, "dvt_circuits_tpu_torch.utils.spans", None)
    assert reader("g1_pad_share")(_run()) is None


def test_reference_public_values_equal_the_port_at_13_operators():
    from dvt_circuits_tpu_torch.circuits.registry import get_circuit as port_circuit
    from dvt_circuits_tpu_torch.prover.pipeline import execute_circuit as port_execute

    from portbench.reference.frozen.circuits.registry import get_circuit
    from portbench.reference.frozen.prover.pipeline import execute_circuit
    from portbench.traffic.generator import DkgCommittee

    circuit = "finalization"
    raw = json.dumps(DkgCommittee(13, 9, seed=b"pv13").finalization_data().to_json(True))
    spec, pspec = get_circuit(circuit), port_circuit(circuit)
    ours = execute_circuit(circuit, spec.data_type.from_json(json.loads(raw), spec.setup.layout,
                                                             True), True)
    port = port_execute(circuit, pspec.data_type.from_json(json.loads(raw), pspec.setup.layout,
                                                            True), True)
    assert ours.exit_code == port.exit_code == 0
    assert ours.public_values == port.public_values and ours.public_values
    assert ours.commit_count == port.commit_count
