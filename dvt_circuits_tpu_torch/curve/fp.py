"""Batched BLS12-381 base-field arithmetic on int64 tensors.

Port of ``dvt_circuits_tpu/curve/fp.py``.  The layout is the JAX
package's: base 2^12, 32 limbs (384 bits) on the LAST axis, little-endian,
values in Montgomery form with R = 2^384.  Limbs are held in int64 (CPU
``uint32`` lacks ``+``, ``>>`` and ``<``); every result is normalized and
below p, so its limbs equal the JAX package's bit for bit.

``mont_mul`` is the wrapper of kernel C1 (``csrc/curve.cu:fp_mont_mul``):
a CUDA tensor launches it, a CPU tensor takes ``mont_mul_plain``, the JAX
algorithm in plain PyTorch ops (schoolbook column sums, carry passes, a
conditional subtraction of p).  The column sums are an outer product read
along its anti-diagonals (sliding windows, a view), not a matrix product
(PyTorch has no int64 ``matmul`` on CUDA), so the plain version runs on
the card too, where it is C1's reference.  The other operations
(``add``, ``sub``, ``neg``, ``select``, ``mont_pow``, ``inv``) are plain
PyTorch on every device.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from .. import kernels
from ..hostcrypto.bls12_381 import P as P_INT

LIMB_BITS = 12
NLIMBS = 32  # 384 bits
MASK = (1 << LIMB_BITS) - 1
R_INT = 1 << (LIMB_BITS * NLIMBS)  # Montgomery radix 2^384
R_MOD_P = R_INT % P_INT
R2_MOD_P = (R_INT * R_INT) % P_INT
PPRIME_INT = (-pow(P_INT, -1, R_INT)) % R_INT  # -p^{-1} mod R


def int_to_limbs(x: int) -> np.ndarray:
    out = np.empty(NLIMBS, dtype=np.int64)
    for i in range(NLIMBS):
        out[i] = x & MASK
        x >>= LIMB_BITS
    return out


def limbs_to_int(limbs) -> int:
    x = 0
    for i in reversed(range(len(limbs))):
        x = (x << LIMB_BITS) | int(limbs[i])
    return x


@lru_cache(maxsize=None)
def _consts(device: torch.device) -> dict:
    """The limb constants on ``device``."""
    return {name: torch.as_tensor(int_to_limbs(v), device=device)
            for name, v in (("p", P_INT), ("pprime", PPRIME_INT), ("one", R_MOD_P))}


def _c(device, name: str) -> torch.Tensor:
    return _consts(torch.device(device))[name]


def from_ints(values, device="cuda") -> torch.Tensor:
    """Host ints (standard form) → (n, 32) Montgomery limb tensor."""
    dev = kernels.resolve_device(device)
    arr = np.stack([int_to_limbs(v * R_INT % P_INT) for v in values])
    return torch.as_tensor(arr, device=dev)


def to_ints(arr) -> list:
    """(..., 32) Montgomery limb tensor → list of standard-form ints."""
    host = arr.reshape(-1, NLIMBS).cpu().numpy()
    rinv = pow(R_INT, -1, P_INT)
    return [limbs_to_int(row) * rinv % P_INT for row in host]


def _normalize(cols: torch.Tensor, passes: int) -> torch.Tensor:
    """Exact carry propagation over signed limbs: every limb but the top one
    ends in [0, 2^12), the top one takes all carries (its sign is the
    sign of the value).  ``passes`` carry passes (an arithmetic shift is a
    floor division), enough to bring the caller's column sums down to
    single-bit carries, then passes until no lower limb overflows: a test
    of the tensor per pass, which on a CUDA tensor waits for the card.
    The JAX package runs three passes and then resolves the last
    single-bit ripple with a Kogge–Stone prefix; both end at the same
    limbs."""
    for _ in range(passes):
        carry = cols[..., :-1] >> LIMB_BITS
        cols = cols.clone()
        cols[..., :-1] &= MASK
        cols[..., 1:] += carry
    carry = cols[..., :-1] >> LIMB_BITS
    while bool(carry.any()):
        cols = cols.clone()
        cols[..., :-1] &= MASK
        cols[..., 1:] += carry
        carry = cols[..., :-1] >> LIMB_BITS
    return cols


def _mul_columns(a: torch.Tensor, b: torch.Tensor, out_len: int) -> torch.Tensor:
    """Schoolbook columns out[k] = Σ_{i+j=k} a_i·b_j for k < out_len, in
    int64 (of 12-bit limbs, sums of 32 products below 2^29): b zero-padded
    by 32 limbs on each side, its sliding windows of 32 limbs (a view)
    against a reversed, so that window k + 1 meets a_i with b_{k−i}."""
    windows = torch.nn.functional.pad(b, (NLIMBS, NLIMBS)).unfold(-1, NLIMBS, 1)
    return (windows[..., 1:out_len + 1, :] * a.flip(-1)[..., None, :]).sum(-1)


def cond_sub_p(a: torch.Tensor) -> torch.Tensor:
    """Subtract p where a ≥ p (input normalized, a < 2p)."""
    d = _normalize(a - _c(a.device, "p"), 1)
    return torch.where((d[..., -1:] < 0), a, d)


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product of (..., 32) limb tensors in plain PyTorch ops (the
    JAX ``mont_mul``); result below p, normalized.

    The JAX package normalizes T = a·b, then U = T + m·p whole.  U's low
    384 bits are zero, so normalizing them is a carry that ripples through
    every low limb, one limb a carry pass.  Here the columns stay raw
    (below 2^30): m comes from T's low columns (T mod R is the same value),
    and U/R is U's high columns plus the carry N out of the low ones, which
    is an integer below 2^36.  The columns below 29 add less than 2^-17 to
    L/R = N, so N = ceil((u_29 + u_30·2^12 + u_31·2^24) / 2^36).  Same
    value, so the same limbs."""
    a, b = torch.broadcast_tensors(a, b)
    t = _mul_columns(a, b, 2 * NLIMBS)
    # m = (T mod R)·p' mod R: products below 2^41, column sums below 2^46;
    # the top limb's carries dropped
    m = _normalize(_mul_columns(t[..., :NLIMBS], _c(a.device, "pprime").expand_as(a), NLIMBS),
                   4)
    m[..., -1] &= MASK
    u = t + _mul_columns(m, _c(a.device, "p").expand_as(a), 2 * NLIMBS)
    top = u[..., NLIMBS - 3] + (u[..., NLIMBS - 2] << LIMB_BITS) + (u[..., NLIMBS - 1] << 24)
    hi = u[..., NLIMBS:].clone()
    hi[..., 0] += (top + (1 << 36) - 1) >> 36
    return cond_sub_p(_normalize(hi, 3))


@lru_cache(maxsize=None)
def _library():
    lib = kernels.load("curve")
    lib.fp_mont_mul.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_longlong, ctypes.c_void_p]
    lib.fp_mont_mul.restype = ctypes.c_int
    return lib


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product of (..., 32) int64 limb tensors (broadcast); result
    below p, normalized.

    A CPU tensor takes ``mont_mul_plain``; a CUDA tensor launches kernel C1
    (``csrc/curve.cu:fp_mont_mul``, one thread per product) or raises.  C1
    replaces the XLA ``dvt_circuits_tpu/curve/fp.py:mont_mul``."""
    if a.dtype != torch.int64 or b.dtype != torch.int64:
        raise ValueError(f"expected int64 limb tensors, got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.device.type == "cpu":
        return mont_mul_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if a.shape[-1] != NLIMBS or b.shape[-1] != NLIMBS:
        raise ValueError(f"expected {NLIMBS} limbs on the last axis")
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a = a.expand(shape).contiguous()
    b = b.expand(shape).contiguous()
    out = torch.empty(shape, dtype=torch.int64, device=a.device)
    n = out.numel() // NLIMBS
    if n:
        kernels.check(
            _library().fp_mont_mul(a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
                                   kernels.stream_handle(a)),
            "fp_mont_mul kernel launch",
        )
        mont_mul.launches += 1
    return out


mont_mul.launches = 0


def mont_sq(a):
    return mont_mul(a, a)


def add(a, b):
    return cond_sub_p(_normalize(a + b, 1))


def sub(a, b):
    """a − b mod p (normalized inputs)."""
    d = _normalize(a - b, 1)
    return torch.where(d[..., -1:] < 0, _normalize(d + _c(a.device, "p"), 1), d)


def neg(a):
    r = _normalize(_c(a.device, "p") - a, 1)
    return torch.where(is_zero(a)[..., None], a, r)


def zeros(shape, device="cuda"):
    return torch.zeros((*shape, NLIMBS), dtype=torch.int64, device=device)


def ones_mont(shape, device="cuda"):
    return _c(device, "one").expand(*shape, NLIMBS)


def select(cond, a, b):
    """Elementwise select: cond shape (...,), operands (..., 32)."""
    return torch.where(cond[..., None], a, b)


def is_zero(a):
    return (a == 0).all(-1)


def eq(a, b):
    return (a == b).all(-1)


def mont_pow(a, e: int):
    """a^e for a host exponent, left-to-right square-and-multiply."""
    nbits = max(1, e.bit_length())
    acc = ones_mont(a.shape[:-1], a.device)
    for i in range(nbits):
        acc = mont_sq(acc)
        if (e >> (nbits - 1 - i)) & 1:
            acc = mont_mul(acc, a)
    return acc


def inv(a):
    """Batched inverse via Fermat (a^{p−2}); 0 → 0."""
    return mont_pow(a, P_INT - 2)
