"""Kernel C1's tile path (``csrc/fp_tile.cuh``: the split into tiles, the
padded slots, the unpack into 12 words, ``bls::mul``, the repack into 32
limbs and the coalesced store) run on the CPU: ``tests/curve_host_lanes.cpp``
builds the loop that ``csrc/curve.cu:fp_mont_mul_kernel`` runs, with a
memcpy for its bulk copies and a thread a CUDA thread, and the products are
held limb for limb to ``fp.mont_mul_plain`` and to the JAX package's
``fp.mont_mul``, at sizes around a tile and over one and several blocks of
the persistent grid.  Also the wrapper's operands: broadcast, contiguous and
16-byte aligned, as the kernel's bulk copies take them.  Inputs come from
numpy seeds; every comparison is exact."""

import jax
import numpy as np
import pytest
import torch

from dvt_circuits_tpu.curve import fp as jfp
from dvt_circuits_tpu_torch.curve import fp

from .test_torch_curve_host import lib  # noqa: F401  (the host build, a fixture)

EDGES = (0, 1, fp.P_INT - 2, fp.P_INT - 1)


@pytest.fixture(scope="module")
def jax_mont_mul():
    return jax.jit(jfp.mont_mul)


def _operands(n: int) -> tuple:
    """n pairs of limb rows below p: first the edge rows against each other
    (p − 1 by p − 2 first), then random rows whose top limb lies under p's."""
    rng = np.random.default_rng(n)
    top = int(fp.P_INT >> (12 * 31))
    rows = rng.integers(0, 1 << 12, (2, n, fp.NLIMBS), dtype=np.int64)
    rows[..., -1] = rng.integers(0, top, (2, n))
    pairs = [(x, y) for x in EDGES[::-1] for y in EDGES[2:] + EDGES[:2]]
    for i, (x, y) in enumerate(pairs[:n]):
        rows[0, i], rows[1, i] = fp.int_to_limbs(x), fp.int_to_limbs(y)
    return rows[0], rows[1]


def _tile_mul(lib, a: np.ndarray, b: np.ndarray, grid: int) -> np.ndarray:
    out = np.full_like(a, -1)
    lib.host_fp_tile_mul(a.ctypes.data, b.ctypes.data, out.ctypes.data, len(a), grid)
    return out


@pytest.mark.parametrize("tiles, extra", [(0, 1), (1, -1), (1, 0), (1, 1), (3, 5)],
                         ids=["1", "T-1", "T", "T+1", "3T+5"])
def test_tile_loop_equals_plain_and_jax(lib, jax_mont_mul, tiles, extra):  # noqa: F811
    n = tiles * lib.host_fp_tile() + extra
    a, b = _operands(n)
    plain = fp.mont_mul_plain(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    theirs = np.asarray(jax_mont_mul(a.astype(np.uint32), b.astype(np.uint32))).astype(np.int64)
    assert np.array_equal(plain, theirs)
    # one block walks every tile; three blocks of the persistent grid share them
    for grid in (1, 3):
        assert np.array_equal(_tile_mul(lib, a, b, grid), plain), grid
    rinv = pow(fp.R_INT, -1, fp.P_INT)
    assert [fp.limbs_to_int(row) for row in plain[:16]] == [
        fp.limbs_to_int(x) * fp.limbs_to_int(y) * rinv % fp.P_INT for x, y in zip(a[:16], b[:16])]


def test_wrapper_operands_are_contiguous_and_aligned():
    a, b = (torch.as_tensor(x) for x in _operands(9))
    x, y, shape = fp._operands(a, b)
    assert x is a and y is b and shape == a.shape
    # a view whose rows start 8 bytes past a 16-byte boundary is copied
    flat = torch.empty(a.numel() + 1, dtype=torch.int64)
    view = flat[1:].view(a.shape)
    view.copy_(a)
    assert view.data_ptr() % 16 == 8
    x, y, shape = fp._operands(view, b)
    assert x.data_ptr() % 16 == 0 and x.is_contiguous() and torch.equal(x, a) and y is b
    # a broadcast row and a strided view become whole contiguous operands
    x, y, shape = fp._operands(a, b[:1])
    assert shape == a.shape and y.is_contiguous() and torch.equal(y, b[:1].expand_as(a))
    x, y, shape = fp._operands(a.t().contiguous().t(), b)
    assert x.is_contiguous() and torch.equal(x, a)
