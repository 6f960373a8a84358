"""Port parity for the BLS12-381 curve package (``dvt_circuits_tpu_torch.curve``)
on the CPU, where each kernel wrapper takes its plain version.

The field and point operations are held against the JAX package limb for
limb (every result is normalized and below p, so the limbs are unique); the
host helpers (digits, bits, GLV) against the JAX package's; the MSMs and
scalar multiplications against ``hostcrypto.bls12_381``, the oracle that
pins the JAX package's own curve tests.  Those run 256-round loops of point
operations (seconds each on one CPU thread); the G2 scalar multiplication
(about three times as long) and the port-against-JAX runs of all four
(minutes of XLA CPU compile) take ``DVT_HEAVY_TESTS=1``, as the JAX
package's own do."""

import os

import jax
import numpy as np
import pytest
import torch

from dvt_circuits_tpu.curve import fp as jfp
from dvt_circuits_tpu.curve import g1 as jg1
from dvt_circuits_tpu.curve import g2 as jg2
from dvt_circuits_tpu_torch.curve import fp, g1, g2
from dvt_circuits_tpu_torch.hostcrypto import bls12_381 as host

HEAVY = os.environ.get("DVT_HEAVY_TESTS") == "1"
P = host.P


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: the suite runs several test processes at once, and
    torch's spinning worker threads slow every process on a shared CPU (the
    plain curve and prover paths are thousands of small ops)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_field():
    """The JAX package's field operations, each jitted on its own, for the
    module's tests: its point formulas then run as written over compiled
    field operations.  Integer XLA code gives the same limbs jitted whole or
    in parts; one compile of a whole G2 addition takes tens of seconds on a
    CPU."""
    patch = pytest.MonkeyPatch()
    for name in ("mont_mul", "add", "sub", "neg", "select", "is_zero"):
        patch.setattr(jfp, name, jax.jit(getattr(jfp, name)))
    yield
    patch.undo()


def _limbs(x) -> np.ndarray:
    """JAX uint32 limbs or port int64 limbs as one int64 array."""
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x).astype(np.int64)


def _same(ours, theirs) -> bool:
    """Nested tuples of limb arrays equal element for element."""
    if isinstance(ours, tuple):
        return len(ours) == len(theirs) and all(_same(a, b) for a, b in zip(ours, theirs))
    return np.array_equal(_limbs(ours), _limbs(theirs))


def _field_values(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(48), "big") % P for _ in range(n)] + [0, 1, P - 1, P - 2]


def test_fp_ops_equal_jax(jax_field):
    va, vb = _field_values(1, 60), _field_values(2, 60)
    vb[-4:] = [P - 1, 0, P - 1, 1]
    a, b = fp.from_ints(va, "cpu"), fp.from_ints(vb, "cpu")
    ja, jb = jfp.from_ints(va), jfp.from_ints(vb)
    assert fp.to_ints(a) == va and _same(a, ja)
    for ours, theirs in ((fp.mont_mul, jfp.mont_mul), (fp.add, jfp.add), (fp.sub, jfp.sub)):
        assert _same(ours(a, b), theirs(ja, jb))
    assert _same(fp.neg(a), jfp.neg(ja))
    assert fp.to_ints(fp.mont_mul(a, b)) == [x * y % P for x, y in zip(va, vb)]
    # the edge rows as raw limbs: 0, 1, p − 1 and p − 2 in Montgomery form
    raw = torch.as_tensor(np.stack([fp.int_to_limbs(v) for v in va[-4:]]))
    assert _same(fp.mont_mul_plain(raw, raw.flip(0)),
                 jfp.mont_mul(jfp.jnp.asarray(raw.numpy().astype(np.uint32)),
                              jfp.jnp.asarray(raw.flip(0).numpy().astype(np.uint32))))


def test_fp_inverse_equals_jax():
    vals = _field_values(3, 3)
    a = fp.from_ints(vals, "cpu")
    inv = fp.inv(a)
    assert _same(inv, jax.jit(jfp.inv)(jfp.from_ints(vals)))
    assert [x * y % P for x, y in zip(vals, fp.to_ints(inv))] == [1, 1, 1, 0, 1, 1, 1]


def test_mont_mul_wrapper_checks_its_operands():
    a = fp.from_ints([3, 5], "cpu")
    with pytest.raises(ValueError, match="int64"):
        fp.mont_mul(a.to(torch.int32), a)
    assert torch.equal(fp.mont_mul(a, a[:1]), fp.mont_mul_plain(a, a[:1].expand_as(a)))


def _g1_points(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [host.g1_mul(host.G1_GEN, int.from_bytes(rng.bytes(31), "big") % host.R)
            for _ in range(n)]


def test_g1_add_double_equal_jax(jax_field):
    pts = _g1_points(6, 4)
    ours_p, theirs_p = g1.from_affine_points(pts, "cpu"), jg1.from_affine_points(pts)
    # Jacobian operands with Z != 1: the doubles of the points
    ours_d, theirs_d = g1.double(ours_p), jg1.double(theirs_p)
    assert _same(ours_d, theirs_d)
    assert g1.to_affine_points(ours_d) == [host.g1_add(a, a) for a in pts]
    negs = [host.g1_neg(a) for a in pts]
    # P + Q, P + P, P + (−P), ∞ + Q, P + ∞, and Jacobian + affine
    cases = [
        (pts, pts[1:] + pts[:1]),
        (pts, pts),
        (pts, negs),
        ([None, pts[0], None, pts[2]], [pts[1], None, None, pts[3]]),
    ]
    for left, right in cases:
        ours = g1.add(g1.from_affine_points(left, "cpu"), g1.from_affine_points(right, "cpu"))
        theirs = jg1.add(jg1.from_affine_points(left), jg1.from_affine_points(right))
        assert _same(ours, theirs)
        assert g1.to_affine_points(ours) == [host.g1_add(a, b) for a, b in zip(left, right)]
    assert _same(g1.add(ours_d, ours_p), jg1.add(theirs_d, theirs_p))
    assert _same(g1.add(ours_d, ours_d), jg1.add(theirs_d, theirs_d))
    assert _same(g1.double(g1.identity((2,), "cpu")), jg1.double(jg1.identity((2,))))


def test_g2_add_double_equal_jax(jax_field):
    pts = [host.g2_mul(host.G2_GEN, k) for k in (1, 2, 5, 9)]
    negs = [(p[0], host.fp2_neg(p[1])) for p in pts]
    ours_p, theirs_p = g2.from_host_points(pts, "cpu"), jg2.from_host_points(pts)
    ours_d, theirs_d = g2.double(ours_p), jg2.double(theirs_p)
    assert _same(ours_d, theirs_d)
    assert g2.to_host_points(ours_d) == [host.g2_add(p, p) for p in pts]
    cases = [
        (pts, list(reversed(pts))),
        (pts, pts),
        ([None, pts[0], pts[1], pts[2]], [None, None, negs[1], pts[3]]),
    ]
    for left, right in cases:
        ours = g2.add(g2.from_host_points(left, "cpu"), g2.from_host_points(right, "cpu"))
        theirs = jg2.add(jg2.from_host_points(left), jg2.from_host_points(right))
        assert _same(ours, theirs)
        assert g2.to_host_points(ours) == [host.g2_add(a, b) for a, b in zip(left, right)]
    assert _same(g2.add(ours_d, ours_p), jg2.add(theirs_d, theirs_p))


def test_host_helpers_equal_jax():
    rng = np.random.default_rng(5)
    scalars = [int.from_bytes(rng.bytes(32), "big") for _ in range(40)] + [0, 1, host.R - 1]
    assert _same(g1.scalars_to_digits(scalars, "cpu"), jg1.scalars_to_digits(scalars))
    assert _same(g1.scalars_to_bits(scalars, "cpu"), jg1.scalars_to_bits(scalars))
    assert g1.GLV_BETA == jg1.GLV_BETA and g1.GLV_LAMBDA == jg1.GLV_LAMBDA
    halves = []
    for k in scalars:
        assert g1.glv_decompose(k) == jg1.glv_decompose(k)
        (s1, a1), (s2, a2) = g1.glv_decompose(k)
        assert (s1 * a1 + s2 * a2 * g1.GLV_LAMBDA) % host.R == k % host.R
        halves += [a1, a2]
    for w in (2, 5, 8):
        assert np.array_equal(g1._bucket_digits(halves, w), jg1._bucket_digits(halves, w))
    assert [g1.default_window_bits(n) for n in (1, 4, 16, 1024, 4096)] == [2, 3, 5, 8, 8]


def _edge_batch(seed: int):
    """The card phase's edge batch: zero scalars, an identity point, a
    repeated point and a P / −P pair; with the host oracle's sum."""
    rng = np.random.default_rng(seed)
    pts = [host.g1_mul(host.G1_GEN, 7 * i + 3) for i in range(4)]
    points = [None, pts[0], pts[1], pts[1], pts[2], host.g1_neg(pts[2]), pts[3], host.G1_GEN]
    scalars = [5, 0, 7, 7, 11, 11, int.from_bytes(rng.bytes(32), "big") % host.R, host.R - 1]
    want = None
    for p, s in zip(points, scalars):
        want = host.g1_add(want, host.g1_mul(p, s) if p else None)
    return points, scalars, want


def _bench_batch(seed: int, n: int):
    """bench.py's points (7i + 3)·G with random scalars; the oracle is one
    host scalar multiplication of G."""
    rng = np.random.default_rng(seed)
    points = [host.g1_mul(host.G1_GEN, 7 * i + 3) for i in range(n)]
    scalars = [int.from_bytes(rng.bytes(32), "big") % host.R for _ in range(n)]
    want = host.g1_mul(host.G1_GEN, sum(s * (7 * i + 3) for i, s in enumerate(scalars)) % host.R)
    return points, scalars, want


def test_msm_plain_equals_host():
    points, scalars, want = _edge_batch(7)
    assert g1.msm(points, scalars, device="cpu") == want


@pytest.mark.parametrize("batch", ["edge", "bench-16"])
def test_msm_bucket_plain_equals_host(batch):
    points, scalars, want = _edge_batch(8) if batch == "edge" else _bench_batch(8, 16)
    assert g1.msm_bucket(points, scalars, device="cpu") == want


def test_g1_scalar_mul_plain_equals_host():
    points, scalars, _ = _edge_batch(9)
    points, scalars = points[:4], scalars[:4]
    got = g1.scalar_mul(g1.from_affine_points(points, "cpu"), g1.scalars_to_bits(scalars, "cpu"))
    assert g1.to_affine_points(got) == [host.g1_mul(p, s) if p else None
                                        for p, s in zip(points, scalars)]


def _g2_batch(seed: int):
    rng = np.random.default_rng(seed)
    points = [host.g2_mul(host.G2_GEN, k) for k in (3, 7)] + [None]
    scalars = [int.from_bytes(rng.bytes(32), "big") % host.R for _ in range(2)] + [5]
    return points, scalars


@pytest.mark.skipif(not HEAVY, reason="256 rounds over Fp², ~3x a G1 scalar mul; DVT_HEAVY_TESTS=1")
def test_g2_scalar_mul_plain_equals_host():
    points, scalars = _g2_batch(10)
    got = g2.scalar_mul(g2.from_host_points(points, "cpu"), g1.scalars_to_bits(scalars, "cpu"))
    assert g2.to_host_points(got) == [host.g2_mul(p, s) if p else None
                                      for p, s in zip(points, scalars)]


@pytest.mark.skipif(not HEAVY, reason="minutes of XLA CPU compile; DVT_HEAVY_TESTS=1")
def test_msms_equal_jax():
    points, scalars, want = _edge_batch(11)
    ours = g1.msm_plain(g1.from_affine_points(points, "cpu"), g1.scalars_to_digits(scalars, "cpu"))
    theirs = jg1._msm_jit(jg1.from_affine_points(points), jg1.scalars_to_digits(scalars))
    assert _same(ours, theirs)
    assert jg1.msm(points, scalars) == g1.msm(points, scalars, device="cpu") == want
    points, scalars, want = _bench_batch(11, 16)
    assert jg1.msm_bucket(points, scalars) == g1.msm_bucket(points, scalars, device="cpu") == want


@pytest.mark.skipif(not HEAVY, reason="minutes of XLA CPU compile; DVT_HEAVY_TESTS=1")
def test_scalar_muls_equal_jax():
    points, scalars, _ = _edge_batch(12)
    points, scalars = points[:4], scalars[:4]
    bits = g1.scalars_to_bits(scalars, "cpu")
    ours = g1.scalar_mul(g1.from_affine_points(points, "cpu"), bits)
    theirs = jax.jit(jg1.scalar_mul)(jg1.from_affine_points(points), jg1.scalars_to_bits(scalars))
    assert _same(ours, theirs)
    points, scalars = _g2_batch(12)
    bits = g1.scalars_to_bits(scalars, "cpu")
    ours = g2.scalar_mul(g2.from_host_points(points, "cpu"), bits)
    theirs = jax.jit(jg2.scalar_mul)(jg2.from_host_points(points), jg1.scalars_to_bits(scalars))
    assert _same(ours, theirs)
