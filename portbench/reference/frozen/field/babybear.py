"""BabyBear prime field (p = 15·2²⁷ + 1 = 2013265921) on int64 tensors.

Port of ``dvt_circuits_tpu/field/babybear.py``.  The JAX package kept
elements in Montgomery form on uint32 lanes because the TPU has no wide
multiply.  PyTorch's uint32 lacks ``+ - >> <`` on the CPU, so here elements
are **int64 tensors in standard form**, in [0, p): a product of two
elements is below 2⁶² and needs one ``% P``; ``%`` on tensors follows
Python's sign rule, so ``(a - b) % P`` is already in [0, p).  Montgomery
form survives only inside the CUDA kernels (``csrc/babybear.cuh``), whose
inputs and outputs are standard form too.

The scalar (Python int) mirrors ``s_*`` are the oracles and host-side
precomputation, as in the JAX package.
"""

from __future__ import annotations

from functools import lru_cache

import torch

P = 2013265921  # 15 * 2**27 + 1
TWO_ADICITY = 27
GENERATOR = 31  # smallest multiplicative generator of F_p^*


def add(a, b):
    return (a + b) % P


def sub(a, b):
    return (a - b) % P


def mul(a, b):
    return a * b % P


def power(a, e: int):
    """a**e elementwise for a static exponent (square and multiply)."""
    result = torch.ones_like(a)
    base = a % P
    while e > 0:
        if e & 1:
            result = result * base % P
        base = base * base % P
        e >>= 1
    return result


def inv(a):
    """Inverse via Fermat (a^(p-2)); 0 maps to 0."""
    return power(a, P - 2)


def powers(base: int, n: int, device, start: int = 1) -> torch.Tensor:
    """[start·baseⁱ for i < n] as an int64 tensor (log-doubling)."""
    out = torch.tensor([start % P], dtype=torch.int64, device=device)
    b = base % P
    while out.shape[0] < n:
        out = torch.cat([out, out * b % P])
        b = b * b % P
    return out[:n]


# ---------------------------------------------------------------------------
# Scalar (Python int) mirror
# ---------------------------------------------------------------------------


def s_add(a: int, b: int) -> int:
    return (a + b) % P


def s_sub(a: int, b: int) -> int:
    return (a - b) % P


def s_mul(a: int, b: int) -> int:
    return a * b % P


def s_inv(a: int) -> int:
    return pow(a, P - 2, P)


@lru_cache(maxsize=None)
def two_adic_generator(bits: int) -> int:
    """Standard-form generator of the order-2^bits subgroup."""
    if not 0 <= bits <= TWO_ADICITY:
        raise ValueError(f"no 2^{bits} roots of unity in BabyBear")
    g = pow(GENERATOR, (P - 1) >> bits, P)
    assert pow(g, 1 << bits, P) == 1
    if bits > 0:
        assert pow(g, 1 << (bits - 1), P) != 1
    return g
