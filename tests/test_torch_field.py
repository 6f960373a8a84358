"""Port parity: BabyBear and BB4 arithmetic vs the JAX package's scalar
mirrors and its numpy BB4 (``field/ext_np.py``).  Finite-field results
must be bit-equal."""

import numpy as np
import pytest
import torch

from dvt_circuits_tpu.field import babybear as jbb
from dvt_circuits_tpu.field import ext as jext
from dvt_circuits_tpu.field import ext_np as jenp
from dvt_circuits_tpu_torch.field import babybear as bb
from dvt_circuits_tpu_torch.field import ext

P = jbb.P
N = 257


def _elems(seed, shape):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, P, shape, dtype=np.int64)
    a.reshape(-1)[:3] = [0, 1, P - 1]  # edge values
    return a


@pytest.mark.parametrize(
    "op, scalar",
    [
        (bb.add, jbb.s_add),
        (bb.sub, jbb.s_sub),
        (bb.mul, jbb.s_mul),
        (lambda a, b: bb.inv(a), lambda a, b: jbb.s_inv(a)),
        (lambda a, b: bb.power(a, 12345), lambda a, b: pow(a, 12345, P)),
    ],
    ids=["add", "sub", "mul", "inv", "power"],
)
def test_base_ops_match_scalar_mirror(op, scalar):
    a, b = _elems(1, N), _elems(2, N)
    got = op(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    want = [scalar(int(x), int(y)) for x, y in zip(a, b)]
    assert got.tolist() == want


def test_scalar_mirrors_and_generators_match():
    a, b = _elems(3, 64), _elems(4, 64)
    for x, y in zip(a.tolist(), b.tolist()):
        assert bb.s_add(x, y) == jbb.s_add(x, y)
        assert bb.s_sub(x, y) == jbb.s_sub(x, y)
        assert bb.s_mul(x, y) == jbb.s_mul(x, y)
        if x:
            assert bb.s_inv(x) == jbb.s_inv(x)
    for bits in range(bb.TWO_ADICITY + 1):
        assert bb.two_adic_generator(bits) == jbb.two_adic_generator(bits)


def test_powers_match_scalar():
    got = bb.powers(31, 100, "cpu", start=7).tolist()
    assert got == [7 * pow(31, i, P) % P for i in range(100)]


@pytest.mark.parametrize("name", ["add", "sub", "mul", "mul_base", "inv"])
def test_ext_ops_match_numpy_bb4(name):
    a, b = _elems(5, (N, 4)), _elems(6, (N, 4))
    s = _elems(7, N)
    ta, tb, ts = (torch.as_tensor(v) for v in (a, b, s))
    ua, ub = a.astype(np.uint64), b.astype(np.uint64)
    got, want = {
        "add": (lambda: ext.add(ta, tb), lambda: jenp.add(ua, ub)),
        "sub": (lambda: ext.sub(ta, tb), lambda: jenp.sub(ua, ub)),
        "mul": (lambda: ext.mul(ta, tb), lambda: jenp.mul(ua, ub)),
        "mul_base": (lambda: ext.mul_base(ta, ts), lambda: jenp.mul_base(ua, s.astype(np.uint64))),
        "inv": (lambda: ext.inv(ta), lambda: jenp.inv(ua)),
    }[name]
    assert np.array_equal(got().numpy().astype(np.uint64), want())


def test_ext_scalar_mirror_and_powers():
    a = [tuple(int(v) for v in r) for r in _elems(8, (32, 4))]
    b = [tuple(int(v) for v in r) for r in _elems(9, (32, 4))]
    for x, y in zip(a, b):
        assert ext.s_mul(x, y) == jext.s_mul(x, y)
        assert ext.s_add(x, y) == jext.s_add(x, y)
        assert ext.s_sub(x, y) == jext.s_sub(x, y)
        assert ext.s_mul_base(x, y[0]) == jext.s_mul_base(x, y[0])
        assert ext.s_pow(x, 77) == jext.s_pow(x, 77)
        if not jext.s_is_zero(x):
            assert ext.s_inv(x) == jext.s_inv(x)
    pw = ext.powers(a[5], 40, "cpu").tolist()
    assert [tuple(r) for r in pw] == [jext.s_pow(a[5], i) for i in range(40)]
