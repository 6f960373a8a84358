"""Port parity for the multiply-add probe: ``mulchain_plain`` (the plain
version of kernel K3) equals the JAX probe's kernel body
``scripts/probe_vpu.py:_kernel_mul``, run eagerly on numpy refs, bit for
bit."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dvt_circuits_tpu_torch import probe_vpu

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
import probe_vpu as jax_probe  # noqa: E402


def _inputs(shape, seed):
    x = np.random.default_rng(seed).integers(0, 1 << 32, shape, dtype=np.uint32)
    x[0], x[1], x[2] = 0, 1, 0xFFFFFFFF
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_mulchain_plain_equals_jax_kernel_body(seed):
    x = _inputs((16, 64), seed)
    want = np.zeros_like(x)
    jax_probe._kernel_mul(x, want)
    assert (probe_vpu.CHAIN, probe_vpu.ADDEND) == (jax_probe.CHAIN, 12345)
    got = probe_vpu.mulchain_plain(torch.as_tensor(x.astype(np.int64)))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_mulchain_wrapper_takes_plain_on_cpu():
    x = torch.as_tensor(_inputs((3, 40), 2).astype(np.int64))
    before = probe_vpu.mulchain.launches
    assert torch.equal(probe_vpu.mulchain(x), probe_vpu.mulchain_plain(x))
    assert probe_vpu.mulchain.launches == before
    # the low 32 bits are the input: values above 2^32 behave as their residue
    assert torch.equal(probe_vpu.mulchain(x + (5 << 32)), probe_vpu.mulchain(x))
    with pytest.raises(ValueError):
        probe_vpu.mulchain(x.to(torch.int32))
