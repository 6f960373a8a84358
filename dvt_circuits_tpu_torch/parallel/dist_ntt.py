"""Sharded NTT: the four-step decomposition with all-to-all axis swaps.

Counterpart of ``dvt_circuits_tpu/parallel/dist_ntt.py``.  A size-N NTT is
decomposed over an A×B matrix (N = A·B, row-major, rows in contiguous blocks
over the ranks of the ``sp`` axis):

  1. a tiled all-to-all swaps the sharded axis: rows → columns, so each rank
     holds all A rows of a B/d-column block,
  2. A-point NTTs along the row axis, local,
  3. the twiddle product M[k1, i2] ·= ω_N^{i2·k1}, local,
  4. an all-to-all swaps back: columns → rows,
  5. B-point NTTs along the column axis, local.

The output is in digit order: local flat position k1_local·B + k2 holds
X[k1 + k2·A]; ``undigit`` restores natural order on the host.  The port's
``ntt/ntt.py`` transforms along axis 0 in natural order and standard form;
this layout is the JAX functions', and the tests hold it against them.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..field import babybear as bb
from ..ntt import intt, ntt
from .comm import all_to_all
from .mesh import Mesh

P = bb.P


@lru_cache(maxsize=None)
def _outer_twiddles(log_a: int, log_b: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """ω_N^{i2·k1} as an (A, B) int64 table (k1 rows, i2 columns)."""
    log_n = log_a + log_b
    w = bb.two_adic_generator(log_n)
    if inverse:
        w = bb.s_inv(w)
    pw = bb.powers(w, 1 << log_n, device)  # ω^e for e < N
    k1 = torch.arange(1 << log_a, device=device)[:, None]
    i2 = torch.arange(1 << log_b, device=device)[None, :]
    return pw[(k1 * i2) % (1 << log_n)]


def _ntt_along(x: torch.Tensor, axis: int, inverse: bool) -> torch.Tensor:
    fn = intt if inverse else ntt
    return fn(x.movedim(axis, 0)).movedim(0, axis)


def four_step_ntt(x: torch.Tensor, log_a: int, inverse: bool = False) -> torch.Tensor:
    """Single-device reference of the four-step NTT along the last axis of
    an (..., N) int64 tensor; digit-ordered output (position k1·B + k2 holds
    X[k1 + k2·A])."""
    n = x.shape[-1]
    log_b = n.bit_length() - 1 - log_a
    m = x.reshape(*x.shape[:-1], 1 << log_a, 1 << log_b)
    m = _ntt_along(m, -2, inverse)
    m = m * _outer_twiddles(log_a, log_b, inverse, x.device) % P
    m = _ntt_along(m, -1, inverse)
    return m.reshape(x.shape)


def undigit(y, log_n: int) -> np.ndarray:
    """Digit order (k1·B + k2 ↦ X[k1 + k2·A]) → natural order, on the host."""
    log_a = log_n // 2
    a, b_sz = 1 << log_a, 1 << (log_n - log_a)
    y = np.asarray(y)
    m = y.reshape(*y.shape[:-1], a, b_sz)
    return np.swapaxes(m, -1, -2).reshape(*y.shape[:-1], a * b_sz)


def sharded_four_step(x: torch.Tensor, ax, log_n: int, inverse: bool = False) -> torch.Tensor:
    """The four-step NTT of size 2^log_n along the last axis, this rank's
    contiguous (..., N/d) block in, its digit-ordered block out."""
    d = ax.size
    log_a = log_n // 2
    log_b = log_n - log_a
    a, b_sz = 1 << log_a, 1 << log_b
    if a % d or b_sz % d:
        raise ValueError(f"grid {a}x{b_sz} not divisible by {d} ranks")
    bs = x.shape[:-1]
    nb = len(bs)
    m = x.reshape(*bs, a // d, b_sz)  # local contiguous row block
    m = all_to_all(m, ax, split_axis=nb + 1, concat_axis=nb)  # (A, B/d): rows → columns
    m = _ntt_along(m, -2, inverse)  # A-point NTTs, local
    cols = slice(ax.index * (b_sz // d), (ax.index + 1) * (b_sz // d))
    m = m * _outer_twiddles(log_a, log_b, inverse, x.device)[:, cols] % P
    m = all_to_all(m, ax, split_axis=nb, concat_axis=nb + 1)  # (A/d, B): columns → rows
    m = _ntt_along(m, -1, inverse)  # B-point NTTs, local
    return m.reshape(*bs, (a // d) * b_sz)


def dist_ntt(x: torch.Tensor, mesh: Mesh, axis_name: str = "sp",
             inverse: bool = False) -> torch.Tensor:
    """Sharded four-step NTT (digit-ordered output).  ``x``: this rank's
    contiguous block (..., N/d) of a size-N last axis sharded over
    ``axis_name``; each block is a row block of the A×B matrix."""
    ax = mesh.axis(axis_name)
    n = x.shape[-1] * ax.size
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError("NTT size must be a power of two")
    return sharded_four_step(x, ax, log_n, inverse)
