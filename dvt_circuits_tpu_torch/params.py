"""The fixed tables both packages must share bit for bit.

This system has no trained weights; what plays their part is its constant
tables: the Poseidon2 round constants and internal diagonal, SHA-256's
round constants and IV, and Keccak's round constants and rotation offsets
(``StarkConfig`` is the remaining shared parameter, ``stark/config.py``).
``numpy_constants`` gives the port's own tables, generated from the same
seeds and standards as the JAX package; ``constants_from_numpy`` turns any
such set (the port's, or the JAX package's arrays in the tests) into the
int64 tensors the port computes with.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

KEYS = (
    "poseidon2_external",  # (8, 16) full-round constants
    "poseidon2_internal",  # (13,) partial-round constants
    "poseidon2_diag",  # (16,) internal-matrix diagonal
    "sha256_k",  # (64,) round constants
    "sha256_h0",  # (8,) initial state
    "keccak_rc",  # (24,) 64-bit round constants
    "keccak_rot",  # (25,) rotation offsets, lane x + 5y
)


def numpy_constants() -> dict:
    """The port's own tables as numpy arrays."""
    from .hash import keccak, poseidon2, sha256

    out = dict(poseidon2.constant_arrays())
    out["sha256_k"] = sha256._K
    out["sha256_h0"] = sha256._H0
    out["keccak_rc"] = np.array(keccak._RC, dtype=np.uint64)
    out["keccak_rot"] = np.array(keccak._ROT, dtype=np.int64)
    return out


def constants_from_numpy(arrays: dict, device) -> dict:
    """int64 tensors on ``device`` from numpy arrays keyed as ``KEYS``.
    64-bit Keccak constants keep their bit pattern (uint64 viewed as
    int64), the form the Keccak code computes on."""
    out = {}
    for key in KEYS:
        a = np.asarray(arrays[key])
        if a.dtype == np.uint64:
            a = a.view(np.int64)
        out[key] = torch.as_tensor(a.astype(np.int64), device=device)
    return out


@lru_cache(maxsize=None)
def _constants(device: torch.device) -> dict:
    return constants_from_numpy(numpy_constants(), device)


def constants(device) -> dict:
    """The port's tables on ``device`` (built once per device)."""
    return _constants(torch.device(device))
