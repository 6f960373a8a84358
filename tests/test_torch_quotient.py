"""The port's tensor constraint path: for the Poseidon2 stream, SHA-256, G1
scalar-mul and ChaCha20 AIRs, ``quotient_body`` through ``TensorBuilder`` (each AIR's
``eval_tensor``) equals the same quotient through ``ProverBuilder`` (the
generic ``eval``) and the JAX package's ``quotient_body`` (its own
``TensorBuilder`` path, its jitted quotient phase on the CPU, converted
from Montgomery form): ``q_matrix``, ``q_col_coeffs`` and the constraint count, bit for bit
(the tolerance for a finite field), whatever the row chunk.  Inputs come
from numpy seeds, at small sizes: the first three tables have 2^8 rows, the
two-block ChaCha20 table 2^6."""

from functools import lru_cache

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dvt_circuits_tpu.field import babybear as jbb
from dvt_circuits_tpu.field import ext as jext
from dvt_circuits_tpu.stark import prover as jprover
from dvt_circuits_tpu.stark.chacha20_air import ChaCha20Air as JaxChaCha20Air
from dvt_circuits_tpu.stark.config import TEST_CONFIG as JAX_TEST_CONFIG
from dvt_circuits_tpu.stark.g1mul_air import G1MulAir as JaxG1MulAir
from dvt_circuits_tpu.stark.poseidon2_air import Poseidon2StreamAir as JaxStreamAir
from dvt_circuits_tpu.stark.sha256_air import Sha256Air as JaxSha256Air
from dvt_circuits_tpu_torch.field import babybear as bb
from dvt_circuits_tpu_torch.field import ext
from dvt_circuits_tpu_torch.hostcrypto import bls12_381 as host
from dvt_circuits_tpu_torch.stark import prover
from dvt_circuits_tpu_torch.stark.air import Air
from dvt_circuits_tpu_torch.stark.chacha20_air import ChaCha20Air
from dvt_circuits_tpu_torch.stark.config import TEST_CONFIG
from dvt_circuits_tpu_torch.stark.g1mul_air import G1MulAir
from dvt_circuits_tpu_torch.stark.poseidon2_air import Poseidon2StreamAir
from dvt_circuits_tpu_torch.stark.sha256_air import Sha256Air, pad_message


def _stream():
    words = np.random.default_rng(3).integers(0, 1 << 16, 59).tolist()
    air = Poseidon2StreamAir(8)
    return air, JaxStreamAir(8), *air.generate_trace(words)


def _sha256():
    msgs = [pad_message(b"dvt" * 30), pad_message(b"")]
    counts = tuple(len(m) // 64 for m in msgs)
    air = Sha256Air(counts)
    return air, JaxSha256Air(counts), *air.generate_trace(msgs)


def _g1mul():
    """One 32-bit chain: a random scalar times a random multiple of G1."""
    rng = np.random.default_rng(12)
    chain = (bytes(rng.integers(0, 256, 4, dtype=np.uint8)),
             host.g1_mul(host.G1_GEN, int(rng.integers(2, 1 << 40))))
    air = G1MulAir((32,))
    return air, JaxG1MulAir((32,)), *air.generate_trace([chain])


def _chacha20():
    """Two keystream blocks of random keys and nonces, counters 0 and 1."""
    rng = np.random.default_rng(21)
    blocks = [(bytes(rng.integers(0, 256, 32, dtype=np.uint8)), ctr,
               bytes(rng.integers(0, 256, 12, dtype=np.uint8))) for ctr in (0, 1)]
    air = ChaCha20Air(2)
    return air, JaxChaCha20Air(2), *air.generate_trace(blocks)


_CASES = {"stream": _stream, "sha256": _sha256, "g1mul": _g1mul, "chacha20": _chacha20}


class _EvalOnly(Air):
    """An AIR seen through its generic ``eval`` alone: ``quotient_body``
    then takes the ``ProverBuilder`` route."""

    def __init__(self, air):
        self._air = air
        self.width = air.width
        self.preprocessed_width = air.preprocessed_width
        self.num_public_values = air.num_public_values

    def eval(self, builder):
        self._air.eval(builder)


@lru_cache(maxsize=None)
def _inputs(case):
    """The AIR pair, the trace's and preprocessed columns' LDEs (port, CPU),
    publics, α, and the port's domain tables."""
    air, jax_air, trace, publics = _CASES[case]()
    n = trace.shape[0]
    log_n = n.bit_length() - 1
    cfg = TEST_CONFIG
    t_lde = prover.lde_body(torch.as_tensor(np.asarray(trace, dtype=np.int64)), cfg)
    pre = np.asarray(air.preprocessed_trace(n), dtype=np.int64)
    p_lde = prover.lde_body(torch.as_tensor(pre), cfg)
    alpha = tuple(int(v) for v in np.random.default_rng(7).integers(0, bb.P, ext.D))
    tables = prover._domain_tables(log_n, cfg.log_blowup, cfg.shift, torch.device("cpu"))
    return air, jax_air, t_lde, p_lde, [int(v) for v in publics], alpha, tables, log_n


def chunk_budget(monkeypatch, rows, width):
    """Row chunks of ``rows`` rows for a table of ``width`` columns (None:
    the prover's own budget)."""
    if rows is not None:
        monkeypatch.setattr(prover, "_QUOTIENT_CHUNK_BYTES", 8 * width * rows)


def _port(case, generic=False):
    air, _, t_lde, p_lde, publics, alpha, tables, log_n = _inputs(case)
    if generic:
        air = _EvalOnly(air)
    q_matrix, q_col_coeffs, count = prover.quotient_body(
        air, t_lde, p_lde, alpha, publics, tables, log_n, TEST_CONFIG)
    return q_matrix.numpy(), q_col_coeffs.numpy(), count


@lru_cache(maxsize=None)
def _builder(case):
    return _port(case, generic=True)


@lru_cache(maxsize=None)
def _jax(case):
    """The JAX package's ``quotient_body`` on the same inputs in Montgomery
    form (it takes ``eval_tensor`` for these AIRs), back in standard form:
    through the JAX prover's own jitted quotient phase (``_phases``)."""
    _, jax_air, t_lde, p_lde, publics, alpha, _, log_n = _inputs(case)

    def mont(t):
        return jbb.to_mont(jnp.asarray(t.numpy().astype(np.uint32)))

    fns = jprover._phases(jax_air, log_n, JAX_TEST_CONFIG)
    q_matrix, q_col_coeffs = fns["quotient"](
        mont(t_lde), mont(p_lde), jext.to_array_mont([alpha])[0],
        jbb.to_mont(jnp.asarray(np.array(publics or [0], dtype=np.uint32))))
    std = [np.asarray(jbb.from_mont(a)).astype(np.int64) for a in (q_matrix, q_col_coeffs)]
    return std[0], std[1], fns["counter"]["constraints"]


def test_every_case_takes_the_tensor_path():
    for case in _CASES:
        air, jax_air = _inputs(case)[:2]
        assert callable(getattr(air, "eval_tensor", None)) and callable(jax_air.eval_tensor)


#: rows per chunk: the default (the whole LDE domain at these sizes), a
#: quarter of it, and 8 rows (many chunks; only the last one wraps)
_CHUNKS = {"default": None, "quarter": "quarter", "8-rows": 8}


@pytest.mark.parametrize("chunk", sorted(_CHUNKS))
@pytest.mark.parametrize("case", sorted(_CASES))
def test_tensor_quotient_equals_builder_and_jax(case, chunk, monkeypatch):
    air, _, t_lde = _inputs(case)[:3]
    rows = t_lde.shape[0] // 4 if _CHUNKS[chunk] == "quarter" else _CHUNKS[chunk]
    chunk_budget(monkeypatch, rows, air.width)
    if rows is not None:
        assert prover.quotient_chunk_rows(air.width, t_lde.shape[0]) == rows
    got = _port(case)
    for want in (_builder(case), _jax(case)):
        assert got[2] == want[2]
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])


def test_chunk_rows_power_of_two_within_budget():
    for width, n_lde in ((32, 1 << 13), (336, 1 << 12), (4314, 1 << 14), (4314, 1 << 18)):
        rows = prover.quotient_chunk_rows(width, n_lde)
        assert rows & (rows - 1) == 0 and rows <= n_lde
        assert rows == n_lde or 8 * width * 2 * rows > prover._QUOTIENT_CHUNK_BYTES
