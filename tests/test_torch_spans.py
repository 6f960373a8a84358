"""The port's spans and counters (``dvt_circuits_tpu_torch/utils/spans.py``)
on one small prove and verify on the CPU, at the port's test STARK
parameters: the pre-curve bad-share fault of a 2-of-3 committee (the stream
and SHA-256 tables, both with preprocessed columns).

Outside a profiler session nothing is recorded; under one, the spans nest
as the pipeline's calls do, stamped on the profiler's own clock, and the
counters equal the bytes and reads reckoned from the tables' shapes.  The
container is the same with tracing on and off."""

from __future__ import annotations

import functools
import hashlib
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from dvt_circuits_tpu_torch.dkg.keys import BlsDkgWithSecp256kCommitment
from dvt_circuits_tpu_torch.dkg.scenario_gen import DkgCommittee
from dvt_circuits_tpu_torch.dkg.types import SHA256Raw
from dvt_circuits_tpu_torch.dkg.verification import compute_seed_exchange_hash
from dvt_circuits_tpu_torch.pcs.challenger import DuplexChallenger
from dvt_circuits_tpu_torch.prover import pipeline
from dvt_circuits_tpu_torch.stark.config import TEST_CONFIG
from dvt_circuits_tpu_torch.stark.g1mul_air import G1MulAir
from dvt_circuits_tpu_torch.utils import spans
from dvt_circuits_tpu_torch.utils.packing import unpack_u32

CIRCUIT = "bad-share"
PHASES = ("lde", "commit", "quotient", "open")


def _pre_curve_fault():
    """Auth seed exchange 0 → 1 whose dst_base_hash lies outside the
    committee, re-hashed and re-signed: the guest slashes before the curve
    check, so the container holds the stream and SHA-256 tables alone."""
    com = DkgCommittee(3, 2)
    data = com.shared_data(0, 1, True)
    sec = data.seeds_exchange_commitment
    sec.shared_secret.dst_base_hash = SHA256Raw(hashlib.sha256(b"outsider").digest())
    h = compute_seed_exchange_hash(BlsDkgWithSecp256kCommitment, sec)
    sec.commitment.hash = h
    sec.commitment.signature = com.secp_keys[0].sign(bytes(h)).to_bytes()
    return data


def _profiler_range_ns(prof, name: str) -> tuple:
    """(start, end) of the profiler's CPU event ``name``, in ns."""
    for e in prof.profiler.kineto_results.events():
        if e.name() == name:
            return e.start_ns(), e.start_ns() + e.duration_ns()
    raise AssertionError(f"the profiler recorded no {name!r}")


@functools.cache
def _runs() -> dict:
    """One prove and verify untraced, then one of each under a CPU profiler
    session, the prove wrapped in a profiler range of the test's own; the
    traced prove counts the challenger's duplexes beside the port."""
    data = _pre_curve_fault()
    spans.clear()
    off = pipeline.prove_circuit(CIRCUIT, data, True, TEST_CONFIG, device="cpu")
    pipeline.verify_proof(off, CIRCUIT, device="cpu")
    recorded_off = spans.records()

    duplex, duplexes = DuplexChallenger._duplex, [0]

    def counting(self):
        duplexes[0] += 1
        return duplex(self)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm_range"):
            pass
        DuplexChallenger._duplex = counting
        try:
            with record_function("test_prove"):
                on = pipeline.prove_circuit(CIRCUIT, data, True, TEST_CONFIG, device="cpu")
        finally:
            DuplexChallenger._duplex = duplex
        pipeline.verify_proof(on, CIRCUIT, device="cpu")
    return {"off": off, "on": on, "recorded_off": recorded_off, "records": spans.records(),
            "wrapped": _profiler_range_ns(prof, "test_prove"), "duplexes": duplexes[0]}


@pytest.fixture(scope="module")
def runs():
    return _runs()


def _roots(records, name):
    return [r for r in records if r.parent_id is None and r.name == name]


def _tables(container) -> list:
    return [container["stark"]] + [g["proof"] for g in container["gadgets"]]


def test_nothing_is_recorded_outside_a_profiler(runs):
    assert runs["recorded_off"] == []
    assert spans.span("x") is spans.span("y")  # the shared no-op context


def test_one_prove_root_and_one_verify_root(runs):
    recs = runs["records"]
    assert len(_roots(recs, "prove")) == 1 and len(_roots(recs, "verify")) == 1
    assert [r for r in recs if r.parent_id is None] == _roots(recs, "prove") + _roots(recs, "verify")
    assert spans.dropped() == 0


def test_every_child_lies_inside_its_parent_with_its_root_id(runs):
    recs = runs["records"]
    by_id = {r.id: r for r in recs}
    assert len(by_id) == len(recs)
    for r in recs:
        assert r.start_ns <= r.end_ns
        if r.parent_id is None:
            assert r.root_id == r.id
            continue
        parent = by_id[r.parent_id]
        assert parent.start_ns <= r.start_ns and r.end_ns <= parent.end_ns, r
        assert r.root_id == parent.root_id
    parents = {r.name: by_id[r.parent_id].name for r in recs if r.parent_id is not None}
    assert parents == {"witness": "prove", "witness.execute": "witness", "witness.g1": "witness",
                       "tables": "prove", "lde": "tables", "commit": "tables",
                       "quotient": "tables", "open": "tables", "verify.stark": "verify"}


def test_each_table_has_its_phases_and_verify_has_a_stark_span_each(runs):
    recs = runs["records"]
    tables = _tables(runs["on"])
    with_pre = sum("root_p" in t for t in tables)
    names = [r.name for r in recs]
    assert names.count("quotient") == names.count("open") == len(tables)
    assert names.count("lde") == len(tables) + with_pre  # the preprocessed columns' LDE
    assert names.count("commit") == 2 * len(tables) + with_pre  # p, t and q trees
    assert names.count("verify.stark") == len(tables)
    assert with_pre == len(tables) == 2
    for n in ("prove", "witness", "witness.execute", "witness.g1", "tables", "verify"):
        assert names.count(n) == 1
    assert sum(r.counters.get("host_syncs", 0) for r in recs) > 0


def test_phases_cover_the_tables_span(runs):
    recs = runs["records"]
    tables = next(r for r in recs if r.name == "tables")
    phases = sum(r.end_ns - r.start_ns for r in recs if r.name in PHASES)
    assert phases <= tables.end_ns - tables.start_ns
    assert phases >= 0.75 * (tables.end_ns - tables.start_ns)


def test_timing_is_the_witness_and_tables_spans(runs):
    recs = {r.name: r for r in runs["records"]}
    timing = runs["on"]["timing"]
    for key, name in (("witness_ms", "witness"), ("prove_ms", "tables")):
        assert timing[key] == (recs[name].end_ns - recs[name].start_ns) // 1_000_000
    assert set(runs["off"]["timing"]) == {"witness_ms", "prove_ms"}
    assert all(isinstance(v, int) for v in runs["off"]["timing"].values())


def test_container_is_the_same_with_tracing_on_and_off(runs, tmp_path):
    off, on = runs["off"], runs["on"]
    assert pipeline.container_digest(off) == pipeline.container_digest(on)
    paths = []
    for tag, c in (("off", off), ("on", on)):
        paths.append(tmp_path / f"{tag}.bin")
        pipeline.save_proof(dict(c, timing={}), str(paths[-1]))
    assert paths[0].read_bytes() == paths[1].read_bytes()


def test_prove_root_lies_inside_the_profiler_range_around_it(runs):
    root = _roots(runs["records"], "prove")[0]
    start, end = runs["wrapped"]
    assert start <= root.start_ns and root.end_ns <= end
    assert root.start_ns - start < 1_000_000 and end - root.end_ns < 1_000_000


def _pre_width(table) -> int:
    return len(unpack_u32(table["opened_p_zeta"])) // 4 if "root_p" in table else 0


def _reckoned_reads(container, duplexes: int) -> tuple:
    """(reads, bytes) of a prove's blocking device-to-host reads, from its
    tables' shapes and STARK parameters: each committed tree's root and
    its one batch of opened rows and sibling paths at int64 (two rows a
    query of each p, t and q tree, one of each FRI layer's tree), the
    openings at ζ and g·ζ, the opened values' root, the final
    coefficients, the grind's 8-byte batches, and the 16-word duplexes."""
    cfg = TEST_CONFIG
    final_len = (1 << cfg.log_final_poly_len) * cfg.blowup
    reads = nbytes = 0

    def tree(rows, width, opened):
        nonlocal reads, nbytes
        reads += 2
        nbytes += 8 * 8 + opened * (width + 8 * (rows.bit_length() - 1)) * 8

    for t in _tables(container):
        n_lde = (1 << t["log_n"]) << cfg.log_blowup
        pre, width, q_width = _pre_width(t), t["width"], 4 * cfg.blowup
        for w in ([pre] if pre else []) + [width, q_width]:
            tree(n_lde, w, 2 * cfg.fri.num_queries)
        opened = [width, width, q_width] + ([pre, pre] if pre else [])
        reads += len(opened) + 1  # the openings, then their Merkle root
        nbytes += sum(w * 4 * 8 for w in opened) + 8 * 8
        n = n_lde
        while n > final_len:
            tree(n // 2, 8, cfg.fri.num_queries)
            n //= 2
        reads += 1
        nbytes += final_len * 4 * 8
        batches = t["fri"]["pow_witness"] // (1 << min(cfg.proof_of_work_bits + 2, 16)) + 1
        reads += batches
        nbytes += 8 * batches
    return reads + duplexes, nbytes + 16 * 8 * duplexes


def test_counters_equal_the_reads_reckoned_from_the_shapes(runs):
    recs = runs["records"]
    root = _roots(recs, "prove")[0]
    mine = [r for r in recs if r.root_id == root.id]
    counted = (sum(r.counters.get("host_syncs", 0) for r in mine),
               sum(r.counters.get("d2h_bytes", 0) for r in mine))
    assert runs["duplexes"] > 0
    assert counted == _reckoned_reads(runs["on"], runs["duplexes"])
    assert all(not r.counters for r in mine if r.name in ("lde", "quotient", "witness"))


def test_span_records_on_exception_and_keeps_threads_apart(monkeypatch):
    spans.clear()

    def work():
        with spans.span("other"):
            spans.host_read(torch.zeros(4, dtype=torch.int64))

    # a profiler session records in the thread that started it alone, so
    # the flag is held on here for both threads
    monkeypatch.setattr(spans, "_profiling", lambda: True)
    with pytest.raises(ValueError):
        with spans.span("outer"):
            spans.count("things", 2)
            worker = threading.Thread(target=work)
            worker.start()
            worker.join()
            raise ValueError("fails inside")
    monkeypatch.undo()
    recs = {r.name: r for r in spans.records()}
    assert recs["outer"].counters == {"things": 2} and recs["outer"].parent_id is None
    assert recs["other"].parent_id is None and recs["other"].thread != recs["outer"].thread
    assert recs["other"].counters == {"host_syncs": 1, "d2h_bytes": 32}
    spans.count("things")  # no profiler, no open span: nothing
    spans.host_read(8)
    assert len(spans.records()) == 2
    spans.clear()
    assert spans.records() == [] and spans.dropped() == 0


def test_buffer_is_bounded_and_counts_what_it_dropped():
    spans.clear()
    extra = 5
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(spans.MAX_RECORDS + extra):
            with spans.span("s"):
                pass
    assert len(spans.records()) == spans.MAX_RECORDS and spans.dropped() == extra
    spans.clear()


def test_timed_span_reads_the_clock_when_off():
    spans.clear()
    with spans.span("w", timed=True) as w:
        pass
    assert w.ms >= 0 and w.end_ns >= w.start_ns
    assert spans.records() == []


def test_chain_rows_are_counted_on_the_g1_span():
    """``g1_chain_rows`` and ``g1_trace_rows`` on ``witness.g1``: each g1mul
    table's rows before its padding, Σ bits·7 + 2 per chain, and its
    height, counted once the table is assembled, on any device."""
    data = DkgCommittee(3, 2).shared_data_bad_secret(0, 1, True)
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        _, gadgets, entries, *_ = pipeline._witness(CIRCUIT, data, True, "secp-commitment",
                                                    torch.device("cpu"))
    g1 = [g for g in gadgets if g["kind"] == "g1mul"]
    assert g1, "the curve fault records a curve relation"
    rows = sum(b * 7 + 2 for g in g1 for b in g["block_counts"])
    heights = [trace.shape[0] for air, trace, _ in entries if isinstance(air, G1MulAir)]
    assert len(heights) == len(g1) and rows < sum(heights)
    (span,) = [r for r in spans.records() if r.name == "witness.g1"]
    assert span.counters["g1_chain_rows"] == rows
    assert span.counters["g1_trace_rows"] == sum(heights)
    spans.clear()
