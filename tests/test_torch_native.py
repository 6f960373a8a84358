"""The JAX package's native host Poseidon2, as the port's parity tests use it.

The JAX verifier (``host_merkle_root``, the challenger) hashes through
``native/dvt_native.so``, which ``dvt_circuits_tpu/utils/native.py`` builds
in place on first use, with no lock.  Under ``pytest -n 6`` every worker
collects ``tests/test_native.py``, whose ``skipif`` calls ``native.load()``,
so in a fresh checkout six ``g++`` write the same file at once; a worker
that loads it while another is still writing it gets an error, and its
loader gives up for good.  The JAX package then takes its pure-Python
permutation, which is exact on Python ints but wraps around on the numpy
``uint32`` words that ``host_merkle_root`` hands to ``_s_compress``: that
worker's JAX verifier rejects valid proofs ("preprocessed commitment
mismatch", "proof-of-work check failed").

``repair_jax_native_loader`` gives such a worker its own copy of the
library, built into a private directory; it runs when this module is
imported, which every worker does while it collects, before any test runs.
The fixture ``jax_native_poseidon2`` (imported by the port's test modules
that call the JAX verifier) repeats it and checks the library against the
JAX package's pure-Python permutation.
"""

import atexit
import os
import shutil
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from dvt_circuits_tpu.hash import poseidon2 as jp2
from dvt_circuits_tpu.pcs import merkle as jmerkle
from dvt_circuits_tpu.utils import native
from dvt_circuits_tpu_torch.hash import poseidon2 as p2
from dvt_circuits_tpu_torch.pcs import merkle


def repair_jax_native_loader(build_dir=None) -> None:
    """If the JAX package's native loader has given up in this process,
    build and load a private copy of the library (never the shared file,
    which other processes may be writing or have mapped)."""
    if os.environ.get("DVT_DISABLE_NATIVE") == "1" or native.load() is not None:
        return
    if build_dir is None:
        build_dir = tempfile.mkdtemp(prefix="dvt_native_")
        atexit.register(shutil.rmtree, build_dir, True)
    native._SO = Path(build_dir) / "dvt_native.so"
    native._tried = False
    native.load()


repair_jax_native_loader()


def _states(seed, n=6):
    return np.random.default_rng(seed).integers(0, jp2.bb.P, (n, 16)).tolist()


@pytest.fixture(scope="module", autouse=True)
def jax_native_poseidon2():
    repair_jax_native_loader()
    for st in _states(1):
        assert jp2.s_permute(st) == jp2._s_permute_py(st), "native Poseidon2 disagrees"


def test_native_library_loaded_and_equal_to_port():
    if os.environ.get("DVT_DISABLE_NATIVE") != "1":
        assert native.load() is not None
    for st in _states(2):
        assert jp2.s_permute(st) == jp2._s_permute_py(st) == p2.s_permute(st)


def test_repair_builds_a_private_library(tmp_path, monkeypatch):
    if os.environ.get("DVT_DISABLE_NATIVE") == "1":
        pytest.skip("the native library is disabled by DVT_DISABLE_NATIVE=1")
    # the state a worker is left in when its load met a half-written file
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    monkeypatch.setattr(native, "_SO", native._SO)
    repair_jax_native_loader(tmp_path)
    assert native._lib is not None and native._SO == tmp_path / "dvt_native.so"
    m = np.random.default_rng(3).integers(0, jp2.bb.P, (16, 13), dtype=np.int64)
    assert jmerkle.host_merkle_root(m.astype(np.uint32)) == merkle.MerkleTree(torch.as_tensor(m)).root
