"""Port parity: the Poseidon2 permutation and the shared constant tables.

The port's plain permutation (kernel K1's reference, and the CPU path of
``poseidon2_permute``) is held bit-exactly against the JAX package's XLA
``poseidon2_permute`` (Montgomery in and out), which is the plain
reference of its Pallas kernel; the Pallas kernel itself is not run here
(its interpret mode takes minutes on the CPU).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dvt_circuits_tpu.field import babybear as jbb
from dvt_circuits_tpu.hash import keccak as jkeccak
from dvt_circuits_tpu.hash import poseidon2 as jp2
from dvt_circuits_tpu.hash import sha256 as jsha
from dvt_circuits_tpu.stark import config as jconfig
from dvt_circuits_tpu_torch import kernels, params
from dvt_circuits_tpu_torch.hash import poseidon2 as p2
from dvt_circuits_tpu_torch.stark import config

P = jbb.P


def _jax_arrays() -> dict:
    return {
        "poseidon2_external": np.array(jp2.EXTERNAL_CONSTANTS, dtype=np.uint32),
        "poseidon2_internal": np.array(jp2.INTERNAL_CONSTANTS, dtype=np.uint32),
        "poseidon2_diag": np.array(jp2.INTERNAL_DIAG, dtype=np.uint32),
        "sha256_k": jsha._K,
        "sha256_h0": jsha._H0,
        "keccak_rc": np.array(jkeccak._RC, dtype=np.uint64),
        "keccak_rot": np.array(jkeccak._ROT, dtype=np.int64),
    }


def _states(seed, n):
    x = np.random.default_rng(seed).integers(0, P, (n, 16), dtype=np.int64)
    x[0] = 0
    x[-1] = P - 1
    return x


@pytest.mark.parametrize("n", [1, 37, 256])
def test_plain_permutation_matches_jax_xla(n):
    x = _states(n, n)
    want = np.asarray(jbb.from_mont(jp2.poseidon2_permute(jbb.to_mont(jnp.asarray(x.astype(np.uint32))))))
    got = p2.poseidon2_permute(torch.as_tensor(x))  # CPU tensor → plain version
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_scalar_permutation_matches_jax():
    for row in _states(11, 8):
        assert p2.s_permute(row.tolist()) == jp2._s_permute_py(row.tolist())


def test_constant_tables_equal_jax_and_interchangeable():
    from_jax = params.constants_from_numpy(_jax_arrays(), "cpu")
    own = params.constants("cpu")
    assert set(from_jax) == set(own) == set(params.KEYS)
    for key in params.KEYS:
        assert torch.equal(from_jax[key], own[key]), key
    x = torch.as_tensor(_states(3, 64))
    assert torch.equal(p2.permute_plain(x, from_jax), p2.permute_plain(x, own))
    y = torch.as_tensor(np.random.default_rng(4).integers(-(1 << 63), (1 << 63) - 1, (8, 25)))
    from dvt_circuits_tpu_torch.hash import keccak

    assert torch.equal(keccak.keccak_f1600_plain(y, from_jax), keccak.keccak_f1600_plain(y, own))


def test_stark_config_matches_jax():
    for mine, theirs in ((config.DEFAULT_CONFIG, jconfig.DEFAULT_CONFIG),
                         (config.TEST_CONFIG, jconfig.TEST_CONFIG)):
        assert vars(mine) == vars(theirs)
        assert vars(mine.fri) == vars(theirs.fri)


def test_cuda_path_raises_without_a_card(monkeypatch):
    from dvt_circuits_tpu_torch.hash import keccak
    from dvt_circuits_tpu_torch.pcs.challenger import DuplexChallenger

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        kernels.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        DuplexChallenger("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        keccak.keccak256_batch([b"abc"], device="cuda")
    with pytest.raises(ValueError):
        p2.poseidon2_permute(torch.zeros((4, 16), dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError):
        p2.poseidon2_permute(torch.zeros((4, 15), dtype=torch.int64))


@pytest.mark.parametrize("pos", [0, 3, 7])
def test_plain_grind_matches_jax_challenger(pos):
    from dvt_circuits_tpu.pcs.challenger import DuplexChallenger as JaxChallenger
    from dvt_circuits_tpu_torch.pcs.challenger import DuplexChallenger

    ours, theirs = DuplexChallenger("cpu"), JaxChallenger()
    for v in np.random.default_rng(pos).integers(0, P, 8 + pos).tolist():
        ours.observe(v)
        theirs.observe(v)
    assert len(ours.input_buffer) == pos
    bits = 10
    w = ours.grind(bits)
    assert w == theirs.grind(bits)
    assert ours.sample() == theirs.sample()


def test_plain_grind_batches():
    base = torch.as_tensor(_states(5, 1)[0])
    w = p2.grind_plain(base, 2, 9, 0, 4096)
    assert w is not None
    assert p2.grind_plain(base, 2, 9, 0, w) is None
    assert p2.grind_plain(base, 2, 9, w, 16) == w
    assert p2.poseidon2_grind(base, 2, 9, w - 3, 8) == w  # CPU tensor: the plain version
