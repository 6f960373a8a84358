"""Port parity for the EP and PP commit demos
(``dvt_circuits_tpu_torch/parallel/ep_tables.py``, ``pp_pipeline.py``) on the
CPU: ranks spawned on one host over Gloo (``parallel/mesh.py:spawn``, one
torch thread each, a time limit), inputs from ``np.random.default_rng``.

Each world size is spawned once per module; every rank runs that world's
cases and returns them.  The roots are held bit for bit against the port's
single-device ``merkle_root`` of each padded table's (or trace's) coset LDE
and against ``from_mont`` of the JAX ``MerkleTree`` root of
``coset_lde(to_mont(·), 1)``, which is what the JAX package's own (heavy)
tests of these demos check; the two errors against the JAX functions'
messages.  The JAX ``ep_commit_tables`` and ``pp_commit_pipeline`` are not
run: their XLA compile under ``shard_map`` is why the JAX package gates
their tests.  The rank functions live here, so this module imports no jax
at its top level."""

import numpy as np
import pytest
import torch

P = 2013265921
SEED = 12
SPAWN_TIMEOUT = 240
#: the worlds spawned: EP at ep = 2, 4 (and K = 3 at ep = 4); PP at S = 3,
#: 4, 8 (and S = 2)
WORLDS = (2, 3, 4, 8)
EP_WORLDS = (2, 4)
PP_WORLDS = (3, 4, 8)


def _inputs() -> dict:
    """The ragged "AIR chip" tables and the microbatch traces of
    ``tests/test_parallel.py``'s EP and PP tests."""
    rng = np.random.default_rng(SEED)
    ragged = [rng.integers(0, P, size=shape, dtype=np.uint32)
              for shape in ((96, 3), (128, 5), (64, 5), (128, 2))]
    return {"ragged": ragged, "traces": rng.integers(0, P, size=(5, 64, 4), dtype=np.uint32)}


def _rank_cases(rank: int, world: int) -> dict:
    from dvt_circuits_tpu_torch.parallel.ep_tables import ep_commit_tables, pad_tables
    from dvt_circuits_tpu_torch.parallel.mesh import Mesh
    from dvt_circuits_tpu_torch.parallel.pp_pipeline import pp_commit_pipeline

    data = _inputs()
    out = {}
    if world in EP_WORLDS:
        mesh = Mesh({"ep": world}, "cpu")
        out["ep"] = ep_commit_tables(pad_tables(data["ragged"]), mesh)
        if world == 4:
            try:
                ep_commit_tables(np.zeros((3, 8, 2), np.uint32), mesh)
            except ValueError as e:
                out["ep_error"] = str(e)
    mesh = Mesh({"pp": world}, "cpu")
    if world in PP_WORLDS:
        out["pp"] = pp_commit_pipeline(data["traces"], mesh)
    else:
        try:
            pp_commit_pipeline(np.zeros((2, 64, 4), np.uint32), mesh)
        except ValueError as e:
            out["pp_error"] = str(e)
    return out


@pytest.fixture(scope="module")
def runs():
    from dvt_circuits_tpu_torch.parallel.mesh import spawn

    return {d: spawn(_rank_cases, d, backend="gloo", device="cpu", timeout=SPAWN_TIMEOUT)
            for d in WORLDS}


def _jax_root(mat: np.ndarray) -> list:
    """``from_mont`` of the JAX package's Merkle root of the coset LDE
    (blowup 2) of a standard-form matrix."""
    import jax.numpy as jnp

    from dvt_circuits_tpu.field import babybear as jbb
    from dvt_circuits_tpu.ntt import coset_lde
    from dvt_circuits_tpu.pcs.merkle import MerkleTree

    lde = coset_lde(jbb.to_mont(jnp.asarray(mat)), 1, axis=0)
    return np.asarray(jbb.from_mont(MerkleTree(lde).levels[-1][0])).tolist()


def _port_root(mat: np.ndarray) -> list:
    from dvt_circuits_tpu_torch.ntt.ntt import coset_lde
    from dvt_circuits_tpu_torch.pcs.merkle import merkle_root

    return merkle_root(coset_lde(torch.as_tensor(mat.astype(np.int64)), 1))


def test_pad_tables_equal_jax():
    from dvt_circuits_tpu.parallel.ep_tables import pad_tables as jax_pad
    from dvt_circuits_tpu_torch.parallel.ep_tables import pad_tables

    ragged = _inputs()["ragged"]
    ours = pad_tables(ragged)
    assert ours.shape == (4, 128, 5) and ours.dtype == np.uint32
    assert np.array_equal(ours, jax_pad(ragged))
    # a row count that is no power of two pads up to the next one
    odd = [ragged[0][:80], ragged[2][:33]]
    assert np.array_equal(pad_tables(odd), jax_pad(odd))


@pytest.mark.parametrize("d", EP_WORLDS)
def test_ep_commit_tables_equal_single_and_jax(runs, d):
    from dvt_circuits_tpu_torch.parallel.ep_tables import pad_tables

    tables = pad_tables(_inputs()["ragged"])
    want = [_port_root(t) for t in tables]
    assert want == [_jax_root(t) for t in tables]
    for out in runs[d]:
        assert out["ep"].tolist() == want


@pytest.mark.parametrize("d", PP_WORLDS)
def test_pp_commit_pipeline_equal_single_and_jax(runs, d):
    traces = _inputs()["traces"]
    want = [_port_root(t) for t in traces]
    assert want == [_jax_root(t) for t in traces]
    for out in runs[d]:
        assert out["pp"].tolist() == want


def test_errors_equal_jax(runs):
    import jax

    from dvt_circuits_tpu.parallel.ep_tables import ep_commit_tables
    from dvt_circuits_tpu.parallel.mesh import make_mesh
    from dvt_circuits_tpu.parallel.pp_pipeline import pp_commit_pipeline

    with pytest.raises(ValueError) as ep_err:
        ep_commit_tables(np.zeros((3, 8, 2), np.uint32),
                         make_mesh({"ep": 4}, devices=jax.devices()[:4]))
    with pytest.raises(ValueError) as pp_err:
        pp_commit_pipeline(np.zeros((2, 64, 4), np.uint32),
                           make_mesh({"pp": 2}, devices=jax.devices()[:2]))
    assert [out["ep_error"] for out in runs[4]] == [str(ep_err.value)] * 4
    assert [out["pp_error"] for out in runs[2]] == [str(pp_err.value)] * 2
    assert str(ep_err.value) == "table count 3 not divisible by ep=4"
