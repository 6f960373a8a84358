"""Port parity for the sharded prover (``parallel/dist_stark.py`` and its
wiring in ``prover/pipeline.py``) on the CPU: ranks spawned on one host over
Gloo, one torch thread each, a time limit on every spawn.

Every sharded proof is held byte for byte against the port's single-device
prover and the JAX package's host prover (``host_prove``, ``prove_circuit``
under ``DVT_PROVER=host``), on every rank:

  * the real stream table (``tests/test_dist_stark.py``'s) at d = 1, 2, 4, 8;
  * chained ``dist_prove_tables`` and ``ep_prove_tables`` on two tables of
    different heights (the stream table and a Fibonacci table, which takes
    the generic ``eval``), EP with ranges of four ranks and of one;
  * the 2-of-3 curve-fault container at ``TEST_CONFIG`` through
    ``prove_circuit`` with ``DVT_DIST=1`` over 4 ranks, accepted by both
    packages' verifiers;
  * ``prove_batch`` on {"dp": 2, "sp": 2} against proves one by one.

The sharded prover is the single-device ``prove`` on another layout, so the
ranks also hold what the two share: the sharded tree's ``open_many``
against ``MerkleTree.open_many`` of the whole matrix at d = 2, 4, 8, and the
phase spans of a d = 2 ``dist_prove`` (rank 0, under a profiler session)
against the single-device prove's.

The rank functions live here, so this module imports no jax at its top
level (a spawned rank imports it by name)."""

import functools
import os

import numpy as np
import pytest
import torch

SPAWN_TIMEOUT = 400
FIB_ROWS = 64
TREE_ROWS, TREE_WIDTH = 64, 9


def _tree_matrix() -> torch.Tensor:
    rng = np.random.default_rng(19)
    return torch.as_tensor(rng.integers(0, 2**31 - 2**27 + 1, (TREE_ROWS, TREE_WIDTH)))


def _tree_indices(d: int) -> list:
    """A leaf in every rank's block, the last leaf, and a repeated index."""
    s = TREE_ROWS // d
    return [b * s + (3 * b + 1) % s for b in range(d)] + [TREE_ROWS - 1, s + 1, s + 1]


def _phase_names(fn):
    """``fn()`` and the names of the spans it recorded under a profiler
    session, in the order they started."""
    from torch.profiler import ProfilerActivity, profile

    from dvt_circuits_tpu_torch.utils import spans

    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        value = fn()
    names = [r.name for r in sorted(spans.records(), key=lambda r: r.start_ns)]
    spans.clear()
    return value, names


def _stream_words():
    frames = [bytes.fromhex("ab" * 32).hex().encode()] * 3 + [b"99" * 48]
    return b"".join(len(f).to_bytes(8, "little") + f for f in frames)


def _entries(pkg):
    """(air, trace, publics) of the stream and Fibonacci tables, built by
    ``pkg`` (the port or the JAX package)."""
    import importlib

    stream_air = importlib.import_module(f"{pkg}.stark.poseidon2_air")
    airs = importlib.import_module(f"{pkg}.stark.airs")
    words = stream_air.stream_to_words(_stream_words())
    air = stream_air.Poseidon2StreamAir(max(1, -(-len(words) // 8)))
    trace, publics = air.generate_trace(words)
    fib = airs.FibonacciAir()
    fib_trace = fib.generate_trace(FIB_ROWS)
    return [(air, trace, publics), (fib, fib_trace, fib.public_values(fib_trace))]


def _batch_data():
    from dvt_circuits_tpu_torch.dkg.scenario_gen import DkgCommittee

    com = DkgCommittee(3, 2)
    return [com.shared_data_bad_secret(0, 1, True), com.shared_data_bad_secret(1, 2, True)]


def _rank_tables(rank: int, world: int) -> dict:
    from dvt_circuits_tpu_torch.parallel import dist_stark
    from dvt_circuits_tpu_torch.parallel.dist_merkle import ShardedTree
    from dvt_circuits_tpu_torch.parallel.mesh import Mesh
    from dvt_circuits_tpu_torch.stark.config import TEST_CONFIG

    entries = _entries("dvt_circuits_tpu_torch")
    air, trace, publics = entries[0]
    out = {"stream": {}, "open_many": {}}
    for d in (1, 2, 4, 8):
        mesh = Mesh({"dp": world // d, "sp": d}, "cpu")
        prove = functools.partial(dist_stark.dist_prove, air, trace, publics, TEST_CONFIG, mesh)
        if d == 2 and rank == 0:
            out["stream"][d], out["spans"] = _phase_names(prove)
        else:
            out["stream"][d] = prove()
        if d > 1:
            ax, s = mesh.axis("sp"), TREE_ROWS // d
            tree = ShardedTree(_tree_matrix()[ax.index * s : (ax.index + 1) * s], ax, d)
            out["open_many"][d] = (tree.root, tree.open_many(_tree_indices(d)))
    mesh = Mesh({"sp": world}, "cpu")
    out["chained"] = dist_stark.dist_prove_tables(entries, TEST_CONFIG, mesh)
    out["ep"] = dist_stark.ep_prove_tables(entries, TEST_CONFIG, mesh)
    out["ep_ranges"] = [sub.ranks for sub in dist_stark.ep_groups(entries, TEST_CONFIG, mesh)]
    narrow = Mesh({"dp": world // 2, "sp": 2}, "cpu")
    out["ep_one"] = dist_stark.ep_prove_tables(entries, TEST_CONFIG, narrow)
    out["ep_one_ranges"] = [sub.ranks
                            for sub in dist_stark.ep_groups(entries, TEST_CONFIG, narrow)]
    return out


def _rank_circuits(rank: int, world: int) -> dict:
    from dvt_circuits_tpu_torch.dkg.scenario_gen import DkgCommittee
    from dvt_circuits_tpu_torch.parallel.mesh import Mesh
    from dvt_circuits_tpu_torch.prover import pipeline
    from dvt_circuits_tpu_torch.stark.config import TEST_CONFIG

    os.environ["DVT_DIST"] = "1"  # the suite's conftest pins 0, and ranks inherit it
    os.environ.pop("DVT_G1", None)
    data = DkgCommittee(3, 2).shared_data_bad_secret(0, 1, True)
    curve = pipeline.prove_circuit("bad-share", data, True, TEST_CONFIG, device="cpu")
    os.environ["DVT_G1"] = "0"  # the batch carries the stream and SHA-256 tables
    mesh = Mesh({"dp": 2, "sp": 2}, "cpu")
    batch = pipeline.prove_batch("bad-share", _batch_data(), True, TEST_CONFIG, mesh=mesh)
    return {"curve": curve, "batch": batch}


@pytest.fixture(scope="module")
def tables():
    from dvt_circuits_tpu_torch.parallel.mesh import spawn

    return spawn(_rank_tables, 8, backend="gloo", device="cpu", timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def circuits():
    from dvt_circuits_tpu_torch.parallel.mesh import spawn

    return spawn(_rank_circuits, 4, backend="gloo", device="cpu", timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _without_timing(container):
    return {k: v for k, v in container.items() if k != "timing"}


@pytest.fixture(scope="module")
def single_proofs(one_thread):
    """The port's single-device proofs of the two tables, each alone and
    chained, and the JAX package's host proofs of the same."""
    from dvt_circuits_tpu.pcs.challenger import DuplexChallenger as JaxChallenger
    from dvt_circuits_tpu.stark.config import TEST_CONFIG as JAX_TEST_CONFIG
    from dvt_circuits_tpu.stark.host_prover import host_prove
    from dvt_circuits_tpu_torch.pcs.challenger import DuplexChallenger
    from dvt_circuits_tpu_torch.stark.config import TEST_CONFIG
    from dvt_circuits_tpu_torch.stark.prover import prove

    ours, theirs = _entries("dvt_circuits_tpu_torch"), _entries("dvt_circuits_tpu")
    for (_, t_ours, p_ours), (_, t_theirs, p_theirs) in zip(ours, theirs):
        assert np.array_equal(np.asarray(t_ours, np.int64), np.asarray(t_theirs, np.int64))
        assert [int(v) for v in p_ours] == [int(v) for v in p_theirs]
    air, trace, publics = ours[0]
    jair, jtrace, jpublics = theirs[0]
    ch, jch = DuplexChallenger("cpu"), JaxChallenger()
    stream, names = _phase_names(lambda: prove(air, trace, publics, TEST_CONFIG,
                                               DuplexChallenger("cpu")))
    return {
        "stream": stream,
        "stream_spans": names,
        "stream_jax": host_prove(jair, jtrace, jpublics, JAX_TEST_CONFIG),
        "chained": [prove(a, t, p, TEST_CONFIG, ch) for a, t, p in ours],
        "chained_jax": [host_prove(a, t, p, JAX_TEST_CONFIG, jch) for a, t, p in theirs],
    }


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_dist_prove_stream_table_equals_single_and_jax(tables, single_proofs, d):
    assert single_proofs["stream"] == single_proofs["stream_jax"]
    for out in tables:
        assert out["stream"][d] == single_proofs["stream"]


@pytest.mark.parametrize("d", [2, 4, 8])
def test_sharded_tree_open_many_equals_merkle_tree_on_the_whole_matrix(tables, d):
    from dvt_circuits_tpu_torch.pcs.merkle import MerkleTree

    whole = MerkleTree(_tree_matrix())
    want_rows, want_paths = whole.open_many(_tree_indices(d))
    assert want_paths.shape == (d + 3, TREE_ROWS.bit_length() - 1, 8)
    for out in tables:
        root, (rows, paths) = out["open_many"][d]
        assert root == whole.root
        assert np.array_equal(rows, want_rows) and np.array_equal(paths, want_paths)


def test_sharded_prove_records_the_single_device_phase_spans(tables, single_proofs):
    names = single_proofs["stream_spans"]
    assert {"lde", "commit", "quotient", "open"} <= set(names)
    assert tables[0]["spans"] == names


@pytest.mark.parametrize("how", ["chained", "ep", "ep_one"])
def test_chained_tables_equal_chained_host_prove(tables, single_proofs, how):
    assert single_proofs["chained"] == single_proofs["chained_jax"]
    for out in tables:
        assert out[how] == single_proofs["chained"]
    ranges = {"chained": None, "ep": [(0, 1, 2, 3), (4, 5, 6, 7)], "ep_one": None}[how]
    if how == "ep":
        assert tables[0]["ep_ranges"] == ranges
    if how == "ep_one":  # one rank a table: the ranks of each sp pair
        assert [out["ep_one_ranges"] for out in tables[:2]] == [[(0,), (1,)]] * 2


def test_dist_curve_fault_container_equals_jax_and_verifies(circuits, monkeypatch):
    from dvt_circuits_tpu.prover import pipeline as jax_pipeline
    from dvt_circuits_tpu.stark.config import TEST_CONFIG as JAX_TEST_CONFIG
    from dvt_circuits_tpu_torch.dkg.scenario_gen import DkgCommittee
    from dvt_circuits_tpu_torch.prover import pipeline

    from .test_torch_pipeline import _jax_data

    monkeypatch.setenv("DVT_PROVER", "host")
    monkeypatch.delenv("DVT_G1", raising=False)
    data = DkgCommittee(3, 2).shared_data_bad_secret(0, 1, True)
    theirs = jax_pipeline.prove_circuit("bad-share", _jax_data(data), True, JAX_TEST_CONFIG)
    ours = [out["curve"] for out in circuits]
    assert [g["kind"] for g in theirs["gadgets"]] == ["sha256", "g1mul"]
    for container in ours:
        assert _without_timing(container) == _without_timing(theirs)
    assert len({pipeline.container_digest(c) for c in ours}) == 1
    res = pipeline.verify_proof(ours[0], "bad-share", strict=True, device="cpu")
    assert (res.binding, res.g1_relations) == ("curve-bound+sig", 1)
    assert jax_pipeline.verify_proof(ours[0], "bad-share").binding == "curve-bound+sig"


def test_prove_batch_over_dp_equals_one_by_one(circuits, one_thread, monkeypatch):
    from dvt_circuits_tpu_torch.prover import pipeline
    from dvt_circuits_tpu_torch.stark.config import TEST_CONFIG

    monkeypatch.setenv("DVT_G1", "0")
    want = [_without_timing(pipeline.prove_circuit("bad-share", d, True, TEST_CONFIG,
                                                   device="cpu"))
            for d in _batch_data()]
    for out in circuits:
        assert [_without_timing(c) for c in out["batch"]] == want


def test_dvt_dist_1_without_a_process_group_raises(monkeypatch):
    from dvt_circuits_tpu_torch.dkg.scenario_gen import DkgCommittee
    from dvt_circuits_tpu_torch.prover import pipeline
    from dvt_circuits_tpu_torch.stark.config import TEST_CONFIG

    monkeypatch.setenv("DVT_DIST", "1")
    monkeypatch.setenv("DVT_G1", "0")
    with pytest.raises(pipeline.ProveError, match="DVT_DIST=1"):
        pipeline.prove_circuit("bad-share", DkgCommittee(3, 2).shared_data_bad_secret(0, 1, True),
                               True, TEST_CONFIG, device="cpu")
