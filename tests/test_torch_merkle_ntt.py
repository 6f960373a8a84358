"""Port parity: NTT / coset LDE vs ``np_ntt`` / ``np_coset_lde``, and
Poseidon2 Merkle trees vs ``host_merkle_root``, the JAX ``MerkleTree``
openings and ``verify_opening``; the plain leaf sponge (K1b's reference)
vs the JAX ``hash_rows`` and the plain levels (K1c's) vs ``build_levels``."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import jax.numpy as jnp

from dvt_circuits_tpu.field import babybear as jbb
from dvt_circuits_tpu.ntt.ntt import np_coset_lde, np_ntt
from dvt_circuits_tpu.pcs import merkle as jmerkle
from dvt_circuits_tpu_torch.hash import poseidon2 as p2
from dvt_circuits_tpu_torch.ntt.ntt import coset_evals_to_coeffs, coset_lde, intt, ntt
from dvt_circuits_tpu_torch.pcs import merkle
from dvt_circuits_tpu_torch.utils import spans

from .test_torch_native import jax_native_poseidon2  # noqa: F401  (autouse)

P = jbb.P


def _matrix(seed, shape):
    return np.random.default_rng(seed).integers(0, P, shape, dtype=np.int64)


@pytest.mark.parametrize("log_n, width", [(0, 3), (1, 1), (5, 4), (9, 2)])
def test_ntt_and_intt_match_np_ntt(log_n, width):
    x = _matrix(log_n, (1 << log_n, width))
    fwd = ntt(torch.as_tensor(x)).numpy()
    assert np.array_equal(fwd.astype(np.uint64), np_ntt(x.astype(np.uint64)))
    inv = intt(torch.as_tensor(x)).numpy()
    assert np.array_equal(inv.astype(np.uint64), np_ntt(x.astype(np.uint64), inverse=True))


@pytest.mark.parametrize("log_n, log_blowup, shift", [(3, 1, 31), (6, 2, 31), (4, 3, 7)])
def test_coset_lde_matches_np_coset_lde(log_n, log_blowup, shift):
    x = _matrix(log_n + 10, (1 << log_n, 5))
    got = coset_lde(torch.as_tensor(x), log_blowup, shift).numpy()
    assert np.array_equal(got.astype(np.uint64), np_coset_lde(x, log_blowup, shift))
    back = coset_evals_to_coeffs(torch.as_tensor(got), shift).numpy()
    assert not back[1 << log_n :].any()


@pytest.mark.parametrize("n, width", [(1, 5), (8, 8), (32, 13), (64, 30)])
def test_merkle_root_matches_host(n, width):
    m = _matrix(n * width, (n, width))
    tree = merkle.MerkleTree(torch.as_tensor(m))
    assert tree.root == jmerkle.host_merkle_root(m.astype(np.uint32))
    assert merkle.merkle_root(torch.as_tensor(m)) == tree.root


def test_merkle_openings_match_jax_tree_and_verify():
    m = _matrix(5, (16, 12))
    tree = merkle.MerkleTree(torch.as_tensor(m))
    jtree = jmerkle.MerkleTree(jbb.to_mont(jnp.asarray(m.astype(np.uint32))))
    assert tree.root == [int(v) for v in jtree.root]
    for idx in (0, 5, 15):
        row, path = tree.open(idx)
        jrow, jpath = jtree.open(idx)
        assert np.array_equal(row, jrow)
        assert np.array_equal(path, np.asarray(jpath))
        assert jmerkle.verify_opening(tree.root, idx, row, path)
        assert not jmerkle.verify_opening(tree.root, idx ^ 1, row, path)


def _query_indices(n, seed):
    """Leaf indices as the prover asks for them: unsorted lo/hi pairs
    (i, i + n/2), then a repeat of some."""
    lo = np.random.default_rng(seed).integers(0, max(n // 2, 1), 7).tolist()
    pairs = [i for li in lo for i in ((li, li + n // 2) if n > 1 else (li,))]
    return pairs + pairs[::3]


@pytest.mark.parametrize("n, width", [(1, 5), (16, 12), (64, 30), (1024, 33)])
def test_open_many_matches_jax_tree_and_verifies(n, width):
    m = _matrix(n + width, (n, width))
    tree = merkle.MerkleTree(torch.as_tensor(m))
    jtree = jmerkle.MerkleTree(jbb.to_mont(jnp.asarray(m.astype(np.uint32))))
    indices = _query_indices(n, n * width)
    rows, paths = tree.open_many(indices)
    depth = n.bit_length() - 1
    assert rows.dtype == paths.dtype == np.uint32
    assert rows.shape == (len(indices), width) and paths.shape == (len(indices), depth, 8)
    for idx, row, path in zip(indices, rows, paths):
        jrow, jpath = jtree.open(idx)
        assert np.array_equal(row, jrow)
        assert np.array_equal(path, np.asarray(jpath, dtype=np.uint32).reshape(depth, 8))
        assert jmerkle.verify_opening(tree.root, idx, row, path)
    one_row, one_path = tree.open(indices[0])
    assert np.array_equal(one_row, rows[0]) and np.array_equal(one_path, paths[0])


@pytest.mark.parametrize("n", [16, 1024])
def test_root_and_open_many_read_only_the_root_and_the_opened_rows(n):
    """Under a profiler session the reads of a commit, its root and one
    batch of m openings are 64 + m·(w + 8·depth)·8 bytes, whatever n: no
    whole matrix or tree goes to the host."""
    width, indices = 30, _query_indices(n, 3)
    mat = torch.as_tensor(_matrix(n, (n, width)))
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("reads"):
            tree = merkle.MerkleTree(mat)
            assert tree.root == tree.root  # read once
            tree.open_many(indices)
    (rec,) = spans.records()
    spans.clear()
    m, depth = len(indices), n.bit_length() - 1
    assert rec.counters == {"host_syncs": 2, "d2h_bytes": 64 + m * (width + 8 * depth) * 8,
                            "opened_rows": m}


def _jax_std(a):
    return np.asarray(jbb.from_mont(a)).astype(np.int64)


@pytest.mark.parametrize("rows", [1, 2, 1 << 10])
@pytest.mark.parametrize("width", [1, 7, 8, 9, 33, 4314])
def test_plain_sponge_and_root_match_jax(rows, width):
    m = _matrix(rows * 7 + width, (rows, width))
    got = p2.hash_rows_plain(torch.as_tensor(m))
    want = jmerkle.hash_rows(jbb.to_mont(jnp.asarray(m.astype(np.uint32))))
    assert np.array_equal(got.numpy(), _jax_std(want))
    assert merkle.merkle_root(torch.as_tensor(m)) == jmerkle.host_merkle_root(m.astype(np.uint32))


@pytest.mark.parametrize("rows", [1, 2, 1 << 10])
def test_plain_levels_match_jax_build_levels(rows):
    m = _matrix(rows + 1, (rows, 9))
    levels = merkle.build_levels(torch.as_tensor(m))
    jlevels = jmerkle.build_levels(jbb.to_mont(jnp.asarray(m.astype(np.uint32))))
    assert [lv.shape[0] for lv in levels] == [lv.shape[0] for lv in jlevels]
    for ours, theirs in zip(levels, jlevels):
        assert np.array_equal(ours.numpy(), _jax_std(theirs))
    # the levels are views into one (2n − 1, 8) buffer, root last
    buf = levels[0]._base if levels[0]._base is not None else levels[0]
    assert buf.shape == (2 * rows - 1, 8)
    assert all(lv.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr() for lv in levels)


def test_plain_sponge_takes_strided_rows():
    wide = torch.as_tensor(_matrix(9, (64, 40)))
    view = wide[::2, 3:36:3]  # (32, 11), both strides > 1
    assert torch.equal(p2.hash_rows_plain(view), p2.hash_rows_plain(view.contiguous()))
    assert torch.equal(merkle.hash_rows(view), p2.hash_rows_plain(view.contiguous()))
