"""The Poseidon2 tables as int64 tensors (frozen copy of the port's
``params.py``, Poseidon2 keys only)."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def _constants(device: torch.device) -> dict:
    from .hash import poseidon2

    return {key: torch.as_tensor(np.asarray(a).astype(np.int64), device=device)
            for key, a in poseidon2.constant_arrays().items()}


def constants(device) -> dict:
    """The Poseidon2 round constants and diagonal on ``device``."""
    return _constants(torch.device(device))
