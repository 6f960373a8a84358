"""Radix-2 NTT and coset LDE over BabyBear, along axis 0.

Port of ``dvt_circuits_tpu/ntt/ntt.py``.  The JAX package wrote this in
XLA (radix-4 with Shoup twiddles, four-step for large sizes), not Pallas;
this slice keeps it as plain PyTorch ops — an iterative decimation-in-time
radix-2 transform over int64 standard-form tensors of shape (n, ...) —
bit-equal to ``np_ntt`` / ``np_coset_lde``.  A hand kernel is later work.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..field import babybear as bb

P = bb.P


@lru_cache(maxsize=None)
def _bit_reverse_indices(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def _np_powers(base: int, n: int) -> np.ndarray:
    """[baseⁱ for i < n] as uint64 (log-doubling in numpy)."""
    out = np.ones(1, dtype=np.uint64)
    b = base % P
    while out.shape[0] < n:
        out = np.concatenate([out, out * np.uint64(b) % np.uint64(P)])
        b = b * b % P
    return out[:n]


@lru_cache(maxsize=None)
def _tables(log_n: int, inverse: bool, device: torch.device):
    """Bit-reversal permutation and per-stage twiddles w_m^j (j < m/2)."""
    rev = torch.as_tensor(_bit_reverse_indices(log_n), device=device)
    stages = []
    for s in range(1, log_n + 1):
        w = bb.two_adic_generator(s)
        if inverse:
            w = bb.s_inv(w)
        tw = _np_powers(w, 1 << (s - 1)).astype(np.int64)
        stages.append(torch.as_tensor(tw, device=device))
    return rev, tuple(stages)


def _ntt_core(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The transform into a new buffer: the bit-reversal gather, then each
    stage's butterflies in place (one half-size temporary at a time), so a
    transform of an n-row matrix holds its input, its output and half of
    one more."""
    n = x.shape[0]
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError(f"NTT size must be a power of two, got {n}")
    rest = x.shape[1:]
    rev, stages = _tables(log_n, inverse, x.device)
    x = x.index_select(0, rev).reshape(n, -1)
    for s in range(1, log_n + 1):
        m = 1 << s
        half = m // 2
        xs = x.view(n // m, m, -1)
        a, b = xs[:, :half], xs[:, half:]
        b.mul_(stages[s - 1].view(1, half, 1)).remainder_(P)
        diff = a - b
        a.add_(b).remainder_(P)
        b.copy_(diff.remainder_(P))
        del diff
    return x.view(n, *rest)


def ntt(x: torch.Tensor) -> torch.Tensor:
    """Forward NTT along axis 0: coefficients → evaluations at ω⁰..ω^{n-1}."""
    return _ntt_core(x, inverse=False)


def intt(x: torch.Tensor) -> torch.Tensor:
    """Inverse NTT along axis 0: evaluations → coefficients."""
    n = x.shape[0]
    return _ntt_core(x, inverse=True).mul_(bb.s_inv(n % P)).remainder_(P)


def _scale_rows_(x: torch.Tensor, base: int) -> torch.Tensor:
    """Multiply row i by baseⁱ, in place."""
    pw = bb.powers(base, x.shape[0], x.device)
    return x.mul_(pw.view(-1, *([1] * (x.dim() - 1)))).remainder_(P)


def coset_lde(evals: torch.Tensor, log_blowup: int, shift: int = bb.GENERATOR) -> torch.Tensor:
    """Low-degree extension along axis 0: evaluations over H (size n) →
    evaluations over the coset shift·K (size n·2^log_blowup)."""
    return coeffs_to_coset_evals(intt(evals), log_blowup, shift)


def coeffs_to_coset_evals(coeffs: torch.Tensor, log_blowup: int, shift: int) -> torch.Tensor:
    """Coefficients (n, ...) → evaluations over shift·K (n·2^log_blowup, ...)."""
    n = coeffs.shape[0]
    padded = coeffs.new_zeros((n << log_blowup, *coeffs.shape[1:]))
    padded[:n] = coeffs
    _scale_rows_(padded[:n], shift)
    return ntt(padded)


def coset_evals_to_coeffs(evals: torch.Tensor, shift: int) -> torch.Tensor:
    """Evaluations over shift·K → coefficients (same length)."""
    return _scale_rows_(intt(evals), bb.s_inv(shift))
