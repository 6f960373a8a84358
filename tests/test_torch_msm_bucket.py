"""Kernel C3's staged plain version (``curve/g1.py:msm_bucket_plain``: the
stable sort, the chunked bucket sums, the grouped window sums, the Horner)
on the CPU, where ``msm_bucket`` takes it, against the JAX package's
``msm_bucket`` and the host oracle (``hostcrypto.bls12_381``).

Inputs come from numpy seeds; points are (7i + 3)·G, as ``chip_smoke.py``
makes bench's.  Everything is integer arithmetic, so every comparison is
exact: affine points against the JAX package and the oracle, orders and
offsets against ``torch.argsort``.  The kernel itself runs in
``tests/test_torch_cuda.py`` (marker ``cuda``) and ``chip_smoke.py``, where
its Jacobian limbs are held to this plain version's."""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvt_circuits_tpu.curve import fp as jfp
from dvt_circuits_tpu.curve import g1 as jg1
from dvt_circuits_tpu_torch.curve import fp, g1
from dvt_circuits_tpu_torch.hostcrypto import bls12_381 as host


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: the suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


#: the row counts the JAX field operations are compiled for; a larger batch
#: runs in blocks of the largest, whose time per row is already the least
_BLOCKS = (1, 4, 16, 64, 256, 1024)


def _blocked(fn):
    """``fn`` (a JAX field operation over (..., 32) limbs and (...,) flags)
    jitted on flat blocks of one of ``_BLOCKS`` rows: the bucket algorithm's
    many batch shapes then share a few compiles, and no call pads more than
    four rows for each it computes.  Rows are independent, so padding and
    blocking change no row.  Arguments and results are numpy arrays, so a
    chain of field operations (a point addition) makes no conversions from
    device arrays."""
    jitted = jax.jit(fn)

    def call(*args):
        arrays = [np.asarray(a) for a in args]
        shape = np.broadcast_shapes(*(a.shape[:-1] if a.dtype != np.bool_ else a.shape
                                      for a in arrays))
        n = int(np.prod(shape, dtype=np.int64))
        flat = []
        for a in arrays:
            tail = () if a.dtype == np.bool_ else a.shape[-1:]
            flat.append(np.broadcast_to(a, shape + tail).reshape((n,) + tail))
        outs = []
        for lo in range(0, n, _BLOCKS[-1]):
            part = [a[lo:lo + _BLOCKS[-1]] for a in flat]
            k = len(part[0])
            rows = next(b for b in _BLOCKS if b >= k)
            if rows > k:
                part = [np.pad(a, [(0, rows - k)] + [(0, 0)] * (a.ndim - 1)) for a in part]
            outs.append(np.asarray(jitted(*part))[:k])
        out = np.concatenate(outs) if len(outs) > 1 else outs[0]
        return out.reshape(shape + out.shape[1:])

    return call


def _python_fori_loop(lower, upper, body, init):
    return functools.reduce(lambda acc, i: body(i, acc), range(lower, upper), init)


@pytest.fixture(scope="module")
def jax_msm_bucket():
    """The JAX package's ``msm_bucket``, its algorithm (``_msm_bucket_jit``)
    run as written over compiled field operations, its cross-window
    ``fori_loop`` as a Python loop.  One XLA compile of the whole algorithm
    takes minutes on a CPU for each window width (the JAX package's own
    tests of it run only with ``DVT_HEAVY_TESTS=1``); integer XLA code gives
    the same limbs jitted whole or in parts."""
    patch = pytest.MonkeyPatch()
    for name in ("mont_mul", "add", "sub", "neg", "select", "is_zero"):
        patch.setattr(jfp, name, _blocked(getattr(jfp, name)))
    patch.setattr(jg1, "_msm_bucket_jit", jg1._msm_bucket_jit.__wrapped__)
    patch.setattr(jax.lax, "fori_loop", _python_fori_loop)
    yield jg1.msm_bucket
    patch.undo()


def _oracle(points, scalars):
    want = None
    for p, s in zip(points, scalars):
        want = host.g1_add(want, host.g1_mul(p, s) if p else None)
    return want


def _points(n: int) -> list:
    return [host.g1_mul(host.G1_GEN, 7 * i + 3) for i in range(n)]


def _scalars(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "big") % host.R for _ in range(n)]


def _skewed(batch: str):
    """The batches that skew the buckets, with the host oracle's sum."""
    pts = _points(4)
    if batch == "equal-scalars":
        points, scalars = pts, _scalars(21, 1) * 4
    elif batch == "small-scalars":  # below 2^16: the upper windows are empty
        points, scalars = pts, [int(v) for v in np.random.default_rng(22).integers(0, 1 << 16, 4)]
    elif batch == "equal-points":  # a bucket's sum goes through add's doubling case
        points, scalars = [pts[1]] * 4, _scalars(23, 1) * 2 + _scalars(24, 2)
    elif batch == "p-and-minus-p":
        points, scalars = [pts[2], host.g1_neg(pts[2]), pts[3], host.g1_neg(pts[3])], [9, 9, 5, 6]
    else:  # identity points and zero scalars
        points, scalars = [None, pts[0], pts[1], None], [3, 0, 11, 0]
    return points, scalars, _oracle(points, scalars)


def _affine(p) -> list:
    """Batched Jacobian limbs of any batch shape as host affine points."""
    return g1.to_affine_points(tuple(c.reshape(-1, fp.NLIMBS) for c in p))


# w = 5..8 run in test_torch_msm_bucket_widths.py, so that --dist loadfile
# puts the two halves of this file's JAX work on two workers
@pytest.mark.parametrize("window_bits", range(2, 5))
def test_msm_bucket_equals_jax_and_host(jax_msm_bucket, window_bits):
    points, scalars = _points(2), _scalars(20 + window_bits, 2)
    want = _oracle(points, scalars)
    assert g1.msm_bucket(points, scalars, window_bits, device="cpu") == want
    assert jax_msm_bucket(points, scalars, window_bits) == want


@pytest.mark.parametrize("batch", ["equal-scalars", "small-scalars", "equal-points",
                                   "p-and-minus-p", "identities-and-zeros"])
def test_msm_bucket_skewed_batches_equal_jax_and_host(jax_msm_bucket, batch):
    points, scalars, want = _skewed(batch)
    assert g1.msm_bucket(points, scalars, 4, device="cpu") == want
    assert jax_msm_bucket(points, scalars, 4) == want


def test_sort_is_stable_argsort():
    rng = np.random.default_rng(25)
    digits = torch.as_tensor(rng.integers(0, 8, (64, 5)), dtype=torch.int32)
    digits[:, 2] = 3  # one bucket holds the window
    idx, offsets = g1.bucket_sort_plain(digits, 3)
    assert torch.equal(idx.long(), torch.argsort(digits.T.long(), dim=1, stable=True))
    counts = torch.stack([torch.bincount(d, minlength=8) for d in digits.T.long()])
    assert torch.equal(offsets[:, 1:].long(), counts.cumsum(1)) and (offsets[:, 0] == 0).all()
    for v in range(5):  # inside a bucket the points keep their index order
        for b in range(8):
            run = idx[v, offsets[v, b]:offsets[v, b + 1]]
            assert (run[1:] > run[:-1]).all()
            assert (digits[run.long(), v] == b).all()


@pytest.mark.parametrize("batch", ["bench", "equal-scalars", "equal-points"])
@pytest.mark.parametrize("chunk", [1, 3, 16])
def test_bucket_sums_equal_host_sums(batch, chunk):
    points, scalars = ((_points(4), _scalars(26, 4)) if batch == "bench"
                       else _skewed(batch)[:2])
    p, digits = g1.bucket_inputs(points, scalars, 3, "cpu")
    idx, offsets = g1.bucket_sort_plain(digits, 3)
    sums = _affine(g1.bucket_sums_plain(p, digits, idx, offsets, 3, chunk))
    halves = g1.to_affine_points(p)
    nwin = digits.shape[1]
    for v in range(nwin):
        for b in range(1, 8):
            want = None
            for i in np.flatnonzero(digits[:, v].numpy() == b):
                want = host.g1_add(want, halves[i])
            assert sums[v * 7 + b - 1] == want


def _stage_inputs(window_bits: int):
    points, scalars = _points(6), _scalars(27, 6)
    scalars[1] = scalars[2] = scalars[0]  # runs of equal digits in every window
    p, digits = g1.bucket_inputs(points, scalars, window_bits, "cpu")
    idx, offsets = g1.bucket_sort_plain(digits, window_bits)
    return p, digits, idx, offsets


@pytest.mark.parametrize("chunk", [1, 3, 16, "m"])
def test_bucket_sums_do_not_depend_on_chunk(chunk):
    p, digits, idx, offsets = _stage_inputs(4)
    chunk = digits.shape[0] if chunk == "m" else chunk
    want = _affine(g1.bucket_sums_plain(p, digits, idx, offsets, 4, g1.BUCKET_CHUNK))
    assert _affine(g1.bucket_sums_plain(p, digits, idx, offsets, 4, chunk)) == want


@pytest.mark.parametrize("groups", [1, 4, 15])
def test_window_sums_do_not_depend_on_groups(groups):
    p, digits, idx, offsets = _stage_inputs(4)
    buckets = g1.bucket_sums_plain(p, digits, idx, offsets, 4)
    sums = _affine(buckets)
    want = []  # sum_b b S_b per window, on the host
    for v in range(digits.shape[1]):
        acc = None
        for b in range(1, 16):
            s = sums[v * 15 + b - 1]
            acc = host.g1_add(acc, host.g1_mul(s, b) if s else None)
        want.append(acc)
    assert _affine(g1.window_sums_plain(buckets, 4, groups)) == want


def test_msm_bucket_plain_takes_chunk_and_groups():
    points, scalars = _points(4), _scalars(28, 4)
    p, digits = g1.bucket_inputs(points, scalars, 3, "cpu")
    got = g1.msm_bucket_plain(p, digits, 3, chunk=digits.shape[0], groups=1)
    assert _affine(tuple(c[None] for c in got)) == [_oracle(points, scalars)]
    with pytest.raises(ValueError):
        g1.msm_bucket_jacobian(p, digits, 9)


@pytest.mark.parametrize("bad", [-1, 8])
def test_msm_bucket_rejects_digits_out_of_range(bad):
    """C3a indexes its buckets by digit: a digit outside [0, 2^w) is
    refused before any stage runs, on the CPU as on the card."""
    p, digits = g1.bucket_inputs(_points(2), _scalars(29, 2), 3, "cpu")
    digits[1, 4] = bad
    with pytest.raises(ValueError, match="outside"):
        g1.msm_bucket_jacobian(p, digits, 3)


def test_plain_defaults_are_the_kernel_constants():
    """The plain version's default chunk and groups are C3's compiled
    constants, so the card compares the two in one order of additions."""
    src = (Path(g1.__file__).parent.parent / "csrc" / "curve.cu").read_text()
    assert re.search(r"constexpr int kChunk = (\d+);", src).group(1) == str(g1.BUCKET_CHUNK)
    assert re.search(r"constexpr int kGroups = (\d+);", src).group(1) == str(g1.WINDOW_GROUPS)
