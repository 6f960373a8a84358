"""Port parity for ``dvt_circuits_tpu_torch.parallel`` on the CPU: ranks
spawned on one host over Gloo (one torch thread each, a time limit on every
spawn, inputs from ``np.random.default_rng``).

Each world size is spawned once per module (a fixture); every rank
computes all of that world's cases and returns them, and the tests hold
them bit for bit against numpy (the tiled collectives), the JAX package's
functions on its 8-device CPU mesh (the four-step NTT, ``dist_ntt``,
``dist_commit_step``, the Merkle roots) and the port's single-device
functions (``merkle_root``, ``g1.msm``) with the host oracle.  The rank
functions live here, so this module imports no jax at its top level (a
spawned rank imports it by name); the JAX package is imported inside the
tests."""

import numpy as np
import pytest
import torch

P = 2013265921
SEED = 11
SPAWN_TIMEOUT = 240
#: the cases of each spawned world
WORLDS = (2, 4, 8)
NTT_LOG = 10
MERKLE_ROWS = 512
MSM_POINTS = 6


def _inputs() -> dict:
    rng = np.random.default_rng(SEED)
    return {
        "coll": rng.integers(0, P, size=(8, 16, 3)),
        "ntt": rng.integers(0, P, size=(2, 1 << NTT_LOG)),
        "merkle": rng.integers(0, P, size=(MERKLE_ROWS, 4)),
        "commit": rng.integers(0, P, size=(2, 256, 4)),
    }


def _msm_case():
    from dvt_circuits_tpu_torch.hostcrypto import bls12_381 as host

    rng = np.random.default_rng(SEED + 1)
    points = [host.g1_mul(host.G1_GEN, int(k)) for k in rng.integers(1, 1 << 30, MSM_POINTS)]
    points[2] = None  # an identity among them
    scalars = [int.from_bytes(rng.bytes(32), "big") % host.R for _ in range(MSM_POINTS)]
    return points, scalars


def _block(x, rank: int, world: int, axis: int = 0):
    return x.chunk(world, dim=axis)[rank]


def _rank_cases(rank: int, world: int) -> dict:
    from dvt_circuits_tpu_torch.parallel import comm, dist_merkle, dist_ntt, dist_prover
    from dvt_circuits_tpu_torch.parallel.mesh import Mesh

    data = {k: torch.as_tensor(v, dtype=torch.int64) for k, v in _inputs().items()}
    mesh = Mesh({"sp": world}, "cpu")
    ax = mesh.axis("sp")
    x = data["coll"][rank]  # (16, 3), this rank's own
    out = {
        "all_to_all": comm.all_to_all(x, ax, split_axis=0, concat_axis=1),
        "all_to_all_back": comm.all_to_all(x, ax, split_axis=0, concat_axis=0),
        "all_gather": comm.all_gather(x, ax),
        "all_gather_tiled": comm.all_gather(x, ax, axis=1, tiled=True),
        "ppermute": comm.ppermute(x, ax, [(p, (p + 1) % world) for p in range(world)]),
        "psum": comm.psum(x, ax),
        "objects": comm.all_gather_object({"rank": rank}, ax),
        "ntt": dist_ntt.dist_ntt(_block(data["ntt"], rank, world, 1), mesh),
        "intt": dist_ntt.dist_ntt(_block(data["ntt"], rank, world, 1), mesh, inverse=True),
    }
    if world in (2, 8):
        out["merkle"] = dist_merkle.dist_merkle_root(_block(data["merkle"], rank, world), mesh)
    if world == 8:
        grid = Mesh({"dp": 2, "sp": 2, "tp": 2}, "cpu")
        dp, sp, tp = (grid.axis_index(a) for a in ("dp", "sp", "tp"))
        local = data["commit"].chunk(2, 0)[dp].chunk(2, 1)[sp].chunk(2, 2)[tp]
        out["commit"] = (dp, dist_prover.dist_commit_step(local, grid))
    if world in (2, 4):
        from dvt_circuits_tpu_torch.curve import g1

        out["msm"] = g1.dist_msm(*_msm_case(), mesh)
    return out


@pytest.fixture(scope="module")
def runs():
    from dvt_circuits_tpu_torch.parallel.mesh import spawn

    return {d: spawn(_rank_cases, d, backend="gloo", device="cpu", timeout=SPAWN_TIMEOUT)
            for d in WORLDS}


@pytest.fixture(scope="module")
def jax_mesh():
    import jax

    from dvt_circuits_tpu.parallel.mesh import make_mesh

    return lambda axes: make_mesh(axes, devices=jax.devices()[: int(np.prod(list(axes.values())))])


@pytest.mark.parametrize("d", WORLDS)
def test_tiled_collectives_equal_numpy(runs, d):
    xs = _inputs()["coll"][:d]  # rank r's x is xs[r]
    for r, out in enumerate(runs[d]):
        chunks = np.split(xs, d, axis=1)  # chunks[i][s]: rank s's i-th row chunk
        assert np.array_equal(out["all_to_all"].numpy(),
                              np.concatenate([chunks[r][s] for s in range(d)], axis=1))
        assert np.array_equal(out["all_to_all_back"].numpy(),
                              np.concatenate([chunks[r][s] for s in range(d)], axis=0))
        assert np.array_equal(out["all_gather"].numpy(), xs)
        assert np.array_equal(out["all_gather_tiled"].numpy(), np.concatenate(list(xs), axis=1))
        assert np.array_equal(out["ppermute"].numpy(), xs[(r - 1) % d])
        assert np.array_equal(out["psum"].numpy(), xs.sum(axis=0))
        assert out["objects"] == [{"rank": s} for s in range(d)]


@pytest.fixture(scope="module")
def jax_four_step():
    """The JAX four-step NTT of the inputs, forward and inverse, and the
    inputs in Montgomery form.  (Its ``dist_ntt`` equals it at d = 2, 4, 8,
    ``tests/test_parallel.py``; one XLA compile of that takes ~40 s here,
    so it is held against the port's once, at d = 8.)"""
    import jax.numpy as jnp

    from dvt_circuits_tpu.field import babybear as jbb
    from dvt_circuits_tpu.parallel import dist_ntt as jdist

    xm = jbb.to_mont(jnp.asarray(_inputs()["ntt"].astype(np.uint32)))
    return xm, {inv: np.asarray(jbb.from_mont(jdist.four_step_ntt(xm, NTT_LOG // 2, inverse=inv)))
                for inv in (False, True)}


@pytest.mark.parametrize("d", WORLDS)
def test_dist_ntt_equals_jax(runs, jax_four_step, d):
    from dvt_circuits_tpu.field import babybear as jbb
    from dvt_circuits_tpu.ntt import ntt as jntt
    from dvt_circuits_tpu.parallel import dist_ntt as jdist
    from dvt_circuits_tpu_torch.parallel import dist_ntt

    x = torch.as_tensor(_inputs()["ntt"])
    xm, four = jax_four_step
    for inverse, key in ((False, "ntt"), (True, "intt")):
        ours = torch.cat([out[key] for out in runs[d]], dim=1).numpy()
        assert np.array_equal(ours, four[inverse])
        single = dist_ntt.four_step_ntt(x, NTT_LOG // 2, inverse=inverse).numpy()
        assert np.array_equal(single, four[inverse])
    natural = dist_ntt.undigit(four[False], NTT_LOG)
    assert np.array_equal(natural, jdist.undigit(four[False], NTT_LOG))
    assert np.array_equal(natural[0], np.asarray(jbb.from_mont(jntt(xm[0]))))


def test_dist_ntt_equals_jax_dist_ntt(runs, jax_mesh, jax_four_step):
    from dvt_circuits_tpu.field import babybear as jbb
    from dvt_circuits_tpu.parallel import dist_ntt as jdist

    xm, _ = jax_four_step
    theirs = np.asarray(jbb.from_mont(jdist.dist_ntt(xm, jax_mesh({"sp": 8}))))
    assert np.array_equal(torch.cat([out["ntt"] for out in runs[8]], dim=1).numpy(), theirs)


@pytest.mark.parametrize("d", [2, 8])
def test_dist_merkle_root_equals_single_and_jax(runs, d):
    import jax.numpy as jnp

    from dvt_circuits_tpu.field import babybear as jbb
    from dvt_circuits_tpu.pcs.merkle import MerkleTree
    from dvt_circuits_tpu_torch.pcs.merkle import merkle_root

    mat = _inputs()["merkle"]
    want = merkle_root(torch.as_tensor(mat))
    jroot = MerkleTree(jbb.to_mont(jnp.asarray(mat.astype(np.uint32)))).levels[-1][0]
    assert np.asarray(jbb.from_mont(jroot)).tolist() == want
    assert [out["merkle"] for out in runs[d]] == [want] * d


def test_dist_commit_step_equals_jax(runs, jax_mesh):
    import jax.numpy as jnp

    from dvt_circuits_tpu.field import babybear as jbb
    from dvt_circuits_tpu.parallel.dist_prover import dist_commit_step

    traces = _inputs()["commit"]
    want = np.asarray(jbb.from_mont(dist_commit_step(
        jnp.asarray(traces.astype(np.uint32)), jax_mesh({"dp": 2, "sp": 2, "tp": 2}))))
    for dp, roots in (out["commit"] for out in runs[8]):
        assert np.array_equal(roots.numpy(), want[dp : dp + 1])


@pytest.mark.parametrize("d", [2, 4])
def test_dist_msm_equals_msm_and_host(runs, d):
    from dvt_circuits_tpu_torch.curve import g1
    from dvt_circuits_tpu_torch.hostcrypto import bls12_381 as host

    points, scalars = _msm_case()
    want = None
    for pt, k in zip(points, scalars):
        if pt is not None:
            want = host.g1_add(want, host.g1_mul(pt, k)) if want else host.g1_mul(pt, k)
    assert g1.msm(points, scalars, device="cpu") == want
    assert [out["msm"] for out in runs[d]] == [want] * d


@pytest.mark.heavy  # minutes of XLA CPU compile of the JAX MSM
@pytest.mark.parametrize("d", [2, 4])
def test_dist_msm_equals_jax(runs, jax_mesh, d):
    from dvt_circuits_tpu.curve import g1 as jg1

    points, scalars = _msm_case()
    assert jg1.dist_msm(points, scalars, jax_mesh({"sp": d})) == runs[d][0]["msm"]
