"""A small cell for the benchmark's tests, proven once per process on the
CPU, and the port's entry points answered from its containers.

The cell ``test-3op-t2.bad-share`` is made of data files alone, in a
temporary root beside a copy of ``BENCHMARK.json``: a 2-of-3 committee at
the port's test STARK parameters (12 queries, 6 grind bits), so that the
port proves its containers on the CPU in about half a minute each.  The
fixture proves the pool's two scenarios once, counting every Poseidon2
permutation the port's plain path runs in the first prove."""

from __future__ import annotations

import copy
import functools
import json
import os
from pathlib import Path

import pytest
import torch

from portbench.core import harness
from portbench.core.program import Program

REPO = Path(__file__).resolve().parents[2]
CELL = "test-3op-t2.bad-share"
SEED = 2**31 + 977
TEST_STARK = {"log_blowup": 2, "num_queries": 12, "proof_of_work_bits": 6,
              "log_final_poly_len": 2, "shift": 31}


def make_root(tmp: Path, pool: int = 2, check_sample: int = 2) -> Path:
    """A root holding BENCHMARK.json with the test cell added, and the
    cell's configuration and mix as new data files."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "test-3op-t2", "source": "https://docs.obol.org",
                             "file": "portbench/configs/test-3op-t2.json",
                             "reduced": ["n", "k", "stark"], "why": "the tests' cell"})
    bench["workloads"].append({"name": CELL, "config": "test-3op-t2", "traffic": "test-bad-share",
                               "chips": 1, "why": "the tests' cell"})
    (tmp / "portbench" / "configs").mkdir(parents=True, exist_ok=True)
    (tmp / "portbench" / "traffic").mkdir(parents=True, exist_ok=True)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    config = json.loads((REPO / "portbench" / "configs" / "dvt-4op-t3.json").read_text())
    config.update(name="test-3op-t2", n=3, k=2, stark=TEST_STARK)
    (tmp / "portbench" / "configs" / "test-3op-t2.json").write_text(json.dumps(config))
    mix = json.loads((REPO / "portbench" / "traffic" / "bad-share.json").read_text())
    mix.update(pool=pool, check_sample=check_sample)
    (tmp / "portbench" / "traffic" / "test-bad-share.json").write_text(json.dumps(mix))
    return tmp


@functools.cache
def _cell_root() -> Path:
    import atexit
    import shutil
    import tempfile

    root = Path(tempfile.mkdtemp(prefix="portbench-cell-"))
    atexit.register(shutil.rmtree, root, ignore_errors=True)
    return make_root(root)


@functools.cache
def _proven() -> dict:
    """{scenario JSON: container} for the pool at SEED, and the count of
    permutations the port ran in the first prove."""
    from portbench.core import traffic
    from portbench.core.spec import load_cell

    from dvt_circuits_tpu_torch.hash import poseidon2 as p2

    cell = load_cell(CELL, root=_cell_root())
    saved_env = {k: os.environ.get(k) for k in ("DVT_DIST", "DVT_EP", "DVT_G1")}
    threads = torch.get_num_threads()
    torch.set_num_threads(min(4, threads))
    program = Program(cell.config, cell.mix["circuit"], "cpu")
    pool = traffic.pool(cell.config, cell.mix, cell.mix_name, SEED, int(cell.mix["pool"]))
    plain, counted = p2.permute_plain, [0]

    def counting(states, consts=None):
        counted[0] += states.shape[0]
        return plain(states, consts)

    containers = {}
    try:
        for i, raw in enumerate(pool):
            if i == 0:
                p2.permute_plain = counting
            try:
                containers[raw] = program.prove(program.parse(raw))
            finally:
                p2.permute_plain = plain
    finally:
        torch.set_num_threads(threads)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {"pool": pool, "containers": containers, "first_perms": counted[0]}


@pytest.fixture
def cell():
    from portbench.core.spec import load_cell

    return load_cell(CELL, root=_cell_root())


@pytest.fixture
def proven():
    return _proven()


class CachedProgram(Program):
    """The port's entry points with the port's prove answered from
    containers it made beforehand (any of them for a scenario it did not
    prove), and no verify: the reference alone judges."""

    containers: dict = {}

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._prove = self._cached
        self._verify = lambda *a, **k: None

    def _cached(self, circuit, data, auth, **kwargs):
        raw = json.dumps(data.to_json(auth))
        found = self.containers.get(raw) or next(iter(self.containers.values()))
        return copy.deepcopy(found)


def run_cached(cell, proven, program_cls=CachedProgram, trace=False, control=""):
    program_cls.containers = proven["containers"]
    return harness.run(cell, SEED, 1e6, trace, device="cpu", control=control,
                       program_cls=program_cls)
