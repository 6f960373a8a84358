"""Port parity for the wide G1 chip (``stark/g1_air.py:G1PolyAir``) and the
row-wise constraint checker (``stark/debug.py:check_trace``), at the JAX
tests' reduced widths (sk 16 bits, id 8 bits; k = 2, and k = 3 for the NORM
rows, as ``tests/test_g1_air.py`` sets them up), inputs from numpy seeds.

Held exactly against the JAX package: the trace, the preprocessed trace
and the publics; both packages' ``check_trace`` on a tampered crumb and a
wrong public, with the same (row, constraint) list; ``check_publics``'s
errors.  The port's own checks: ``check_trace`` passes, ``out_points``
equals the host ``g1_mul`` and Horner, and the constraint quotient through
``eval_tensor`` equals the generic ``eval``'s bit for bit.  The proof
against ``host_prove`` is ``test_torch_g1_air_prove.py``."""

import numpy as np
import pytest
import torch

from dvt_circuits_tpu.stark.debug import check_trace as jax_check_trace
from dvt_circuits_tpu.stark.g1_air import G1PolyAir as JaxG1PolyAir
from dvt_circuits_tpu.stark.g1mul_air import G1MulAir as JaxG1MulAir
from dvt_circuits_tpu_torch.field import babybear as bb
from dvt_circuits_tpu_torch.hostcrypto import bls12_381 as host
from dvt_circuits_tpu_torch.stark import TEST_CONFIG
from dvt_circuits_tpu_torch.stark import bigfield as bf
from dvt_circuits_tpu_torch.stark import prover as pr
from dvt_circuits_tpu_torch.stark.debug import check_trace
from dvt_circuits_tpu_torch.stark.g1_air import G1PolyAir
from dvt_circuits_tpu_torch.stark.g1mul_air import G1MulAir

SK_BITS, ID_BITS = 16, 8


def _poly_eval(c_points, x):
    """Horner over affine points, mirroring dkg_math.evaluate_polynomial."""
    res = c_points[-1]
    for c in reversed(c_points[:-1]):
        res = host.g1_add(host.g1_mul(res, x), c)
    return res


def g1_case(seed: int, k: int = 2):
    """(port air, JAX air, trace, publics, sk, id, C_j) as
    ``tests/test_g1_air.py:_setup`` draws them."""
    rng = np.random.default_rng(seed)
    air = G1PolyAir(k, sk_bits=SK_BITS, id_bits=ID_BITS)
    sk = int(rng.integers(1, 1 << SK_BITS))
    idv = int(rng.integers(1, 1 << ID_BITS))
    cs = [host.g1_mul(host.G1_GEN, int(rng.integers(2, 1 << 60))) for _ in range(k)]
    trace, publics = air.generate_trace(sk.to_bytes(SK_BITS // 8, "big"), idv, cs)
    return air, JaxG1PolyAir(k, sk_bits=SK_BITS, id_bits=ID_BITS), trace, publics, sk, idv, cs


@pytest.fixture(scope="module", params=[2, 3], ids=["k2", "k3"])
def g1(request):
    return g1_case(request.param, k=request.param)


def _violations(fn, *args, **kwargs) -> str:
    with pytest.raises(AssertionError) as err:
        fn(*args, **kwargs)
    return str(err.value)


def test_trace_equals_jax(g1):
    air, jair, trace, publics, sk, idv, cs = g1
    jtrace, jpublics = jair.generate_trace(sk.to_bytes(SK_BITS // 8, "big"), idv, cs)
    assert trace.dtype == jtrace.dtype and np.array_equal(trace, jtrace)
    assert publics == jpublics
    n = trace.shape[0]
    assert np.array_equal(air.preprocessed_trace(n), jair.preprocessed_trace(n))
    for name in ("k", "sk_bits", "id_bits", "sk_bytes", "c_base", "oa_base", "ob_base",
                 "num_public_values", "rows", "min_rows", "log_rows", "width",
                 "preprocessed_width"):
        assert getattr(air, name) == getattr(jair, name), name
    assert air.cache_key()[2:] == jair.cache_key()[2:]


def test_check_trace_passes_and_matches_host(g1):
    air, _, trace, publics, sk, idv, cs = g1
    check_trace(air, torch.as_tensor(trace.astype(np.int64)), publics)
    (infa, xa, ya), (infb, xb, yb) = air.out_points(publics)
    assert (infa, (xa, ya)) == (0, host.g1_mul(host.G1_GEN, sk))
    assert (infb, (xb, yb)) == (0, _poly_eval(cs, idv))


def test_tampered_crumb_fails_both_alike():
    air, jair, trace, publics, *_ = g1_case(3)
    bad = trace.copy()
    # flip one crumb of the first mul output on an active row
    col = 11 * bf.VALUE_CRUMBS + 10
    bad[0, col] = (bad[0, col] + 1) % 4
    ours = _violations(check_trace, air, bad, publics, max_rows=4)
    assert ours == _violations(jax_check_trace, jair, bad, publics, max_rows=4)
    assert ours.startswith("constraint violations (row, constraint): [(0, ")


def test_wrong_public_result_fails_both_alike():
    air, jair, trace, publics, *_ = g1_case(4)
    bad = list(publics)
    bad[air.oa_base + 1] = (bad[air.oa_base + 1] + 1) % (1 << bf.LIMB_BITS)
    ours = _violations(check_trace, air, trace, bad)
    assert ours == _violations(jax_check_trace, jair, trace, bad)


def _check_publics_error(air, publics) -> str:
    with pytest.raises(ValueError) as err:
        air.check_publics(publics)
    return str(err.value)


def test_check_publics_errors_equal_jax():
    air, jair, trace, publics, *_ = g1_case(5)
    air.check_publics(publics)
    jair.check_publics(publics)
    p_limbs = bf.int_to_limbs(host.P)
    cases = {
        "wrong number of public values": publics[:-1],
        "public byte out of range": [300] + publics[1:],
        "infinity flag not boolean": publics[: air.oa_base] + [2] + publics[air.oa_base + 1 :],
        "public limb out of range": (publics[: air.c_base] + [1 << bf.LIMB_BITS]
                                     + publics[air.c_base + 1 :]),
        "C point coordinate not canonical": (publics[: air.c_base] + p_limbs
                                             + publics[air.c_base + bf.NLIMBS :]),
        "result coordinate not canonical": (publics[: air.ob_base + 1] + p_limbs
                                            + publics[air.ob_base + 1 + bf.NLIMBS :]),
    }
    for message, bad in cases.items():
        assert _check_publics_error(air, bad) == _check_publics_error(jair, bad) == message


class _EvalOnly:
    """An AIR seen through its generic ``eval`` alone (``ProverBuilder``)."""

    def __init__(self, air):
        self._air = air
        self.width = air.width
        self.preprocessed_width = air.preprocessed_width

    def eval(self, builder):
        self._air.eval(builder)


def test_eval_tensor_quotient_equals_generic_eval():
    air, _, trace, publics, *_ = g1_case(2)
    cfg = TEST_CONFIG
    n = trace.shape[0]
    log_n = n.bit_length() - 1
    t_lde = pr.lde_body(torch.as_tensor(trace.astype(np.int64)), cfg)
    p_lde = pr.lde_body(torch.as_tensor(air.preprocessed_trace(n).astype(np.int64)), cfg)
    tables = pr._domain_tables(log_n, cfg.log_blowup, cfg.shift, torch.device("cpu"))
    alpha = tuple(int(v) for v in np.random.default_rng(7).integers(0, bb.P, 4))
    args = (t_lde, p_lde, alpha, publics, tables, log_n, cfg)
    q_matrix, q_col_coeffs, count = pr.quotient_body(air, *args)
    g_matrix, g_col_coeffs, g_count = pr.quotient_body(_EvalOnly(air), *args)
    assert count == g_count and count > air.width
    assert torch.equal(q_matrix, g_matrix) and torch.equal(q_col_coeffs, g_col_coeffs)


def test_check_trace_on_g1mul_trace_passes_in_both():
    rng = np.random.default_rng(8)
    air = G1MulAir((8,))
    chains = [(bytes(rng.integers(1, 256, bits // 8, dtype=np.uint8)),
               host.g1_mul(host.G1_GEN, int(rng.integers(2, 1 << 40)))) for bits in air.chain_bits]
    trace, publics = air.generate_trace(chains)
    check_trace(air, trace, publics)
    jax_check_trace(JaxG1MulAir(air.chain_bits), trace, publics)
    bad = list(publics)
    bad[-1] = (bad[-1] + 1) % (1 << bf.LIMB_BITS)
    assert (_violations(check_trace, air, trace, bad)
            == _violations(jax_check_trace, JaxG1MulAir(air.chain_bits), trace, bad))
