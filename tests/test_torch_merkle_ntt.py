"""Port parity: NTT / coset LDE vs ``np_ntt`` / ``np_coset_lde``, and
Poseidon2 Merkle trees vs ``host_merkle_root``, the JAX ``MerkleTree``
openings and ``verify_opening``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dvt_circuits_tpu.field import babybear as jbb
from dvt_circuits_tpu.ntt.ntt import np_coset_lde, np_ntt
from dvt_circuits_tpu.pcs import merkle as jmerkle
from dvt_circuits_tpu_torch.ntt.ntt import coset_evals_to_coeffs, coset_lde, intt, ntt
from dvt_circuits_tpu_torch.pcs import merkle

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
