"""The readers of the port's own spans and counters (``core/spans.py``), on
a handmade window: span records as the port makes them, a handmade
``Trace`` with device operations that straddle the ``tables`` spans' edges,
and the exact value each of the ten readers must give."""

from __future__ import annotations

import sys

import pytest

from dvt_circuits_tpu_torch.utils import spans as port_spans

from portbench.core.harness import Run, reader
from portbench.core.trace import Trace

READERS = ("witness_execute_ms", "witness_g1_ms", "lde_ms", "commit_ms", "quotient_ms",
           "open_ms", "tables_idle_share", "host_syncs_per_proof", "d2h_mib_per_proof",
           "verify_stark_ms")
MIB = 1 << 20
#: the window, in microseconds on the profiler's clock
WINDOW = (1_000.0, 100_000.0)


def _rec(name, id_, parent, root, start_us, end_us, **counters):
    return port_spans.Record(name, id_, parent, root, 1, int(start_us * 1e3), int(end_us * 1e3),
                             counters)


#: two proves and a verify inside the window, and a prove before it
RECORDS = [
    _rec("prove", 90, None, 90, 0, 900, host_syncs=10**6, d2h_bytes=10**9),  # before the window
    _rec("witness.execute", 3, 2, 1, 2_100, 4_000),
    _rec("witness.g1", 4, 2, 1, 4_000, 4_800),
    _rec("witness", 2, 1, 1, 2_000, 5_000),
    _rec("lde", 6, 5, 1, 5_000, 6_000),
    _rec("commit", 7, 5, 1, 6_000, 8_000, host_syncs=2, d2h_bytes=3 * MIB),
    _rec("quotient", 8, 5, 1, 8_000, 9_000),
    _rec("open", 9, 5, 1, 9_000, 11_500, host_syncs=10, d2h_bytes=MIB),
    _rec("tables", 5, 1, 1, 5_000, 12_000, host_syncs=3, d2h_bytes=384),
    _rec("prove", 1, None, 1, 2_000, 12_000),
    _rec("verify.stark", 11, 10, 10, 12_100, 13_000, host_syncs=7, d2h_bytes=896),
    _rec("verify.stark", 12, 10, 10, 13_000, 14_500),
    _rec("verify", 10, None, 10, 12_000, 15_000),
    _rec("witness.execute", 15, 14, 13, 20_000, 21_000),
    _rec("witness.g1", 16, 14, 13, 21_000, 21_500),
    _rec("witness", 14, 13, 13, 20_000, 22_000),
    _rec("lde", 18, 17, 13, 22_000, 23_000),
    _rec("commit", 19, 17, 13, 23_000, 24_000, host_syncs=2, d2h_bytes=2 * MIB),
    _rec("lde", 20, 17, 13, 24_000, 25_500),
    _rec("commit", 21, 17, 13, 25_500, 26_000, host_syncs=2, d2h_bytes=2 * MIB),
    _rec("quotient", 22, 17, 13, 26_000, 27_000),
    _rec("open", 23, 17, 13, 27_000, 29_000, host_syncs=20, d2h_bytes=MIB // 2),
    _rec("tables", 17, 13, 13, 22_000, 30_000, host_syncs=1),
    _rec("prove", 13, None, 13, 20_000, 30_000),
]

#: device operations: across the first tables span's start, two that
#: overlap inside it, across its end, across the second one's start and end,
#: and one between the proves
OPS = [("k", 4_500.0, 5_500.0), ("k", 7_000.0, 8_000.0), ("Memcpy DtoH", 7_500.0, 9_000.0),
       ("k", 11_800.0, 12_500.0), ("k", 15_000.0, 18_000.0), ("k", 21_000.0, 23_000.0),
       ("k", 29_500.0, 31_000.0)]

EXPECTED = {
    "witness_execute_ms": (1.9 + 1.0) / 2,
    "witness_g1_ms": (0.8 + 0.5) / 2,
    "lde_ms": (1.0 + 2.5) / 2,
    "commit_ms": (2.0 + 1.0 + 0.5) / 2,
    "quotient_ms": (1.0 + 1.0) / 2,
    "open_ms": (2.5 + 2.0) / 2,
    # busy inside: 500 + (7,000 to 9,000) + 200, then 1,000 + 500, of 7,000 + 8,000
    "tables_idle_share": 1.0 - (500 + 2_000 + 200 + 1_000 + 500) / 15_000,
    "host_syncs_per_proof": (15 + 25) / 2,
    "d2h_mib_per_proof": ((4 * MIB + 384) + (4 * MIB + MIB // 2)) / 2 / MIB,
    "verify_stark_ms": 0.9 + 1.5,
}


def _run(trace=True):
    tr = Trace(spans=[], ops=list(OPS), window=WINDOW) if trace else None
    return Run(cell=None, records=[], window_s=99.0, setup_s=1.0, peak_bytes=0, trace=tr)


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_exact_value(name, monkeypatch):
    monkeypatch.setattr(port_spans, "records", lambda: list(RECORDS))
    assert reader(name)(_run()) == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_is_none_without_records(name, monkeypatch):
    monkeypatch.setattr(port_spans, "records", lambda: [])
    assert reader(name)(_run()) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_is_none_outside_a_traced_window(name, monkeypatch):
    monkeypatch.setattr(port_spans, "records", lambda: list(RECORDS))
    assert reader(name)(_run(trace=False)) is None
    outside = [r._replace(start_ns=r.start_ns + 10**12, end_ns=r.end_ns + 10**12)
               for r in RECORDS]
    monkeypatch.setattr(port_spans, "records", lambda: outside)
    assert reader(name)(_run()) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_is_none_for_a_port_without_spans(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "dvt_circuits_tpu_torch.utils.spans", None)
    assert reader(name)(_run()) is None
