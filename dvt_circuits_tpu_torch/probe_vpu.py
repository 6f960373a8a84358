"""Microbenchmark: the card's measured uint32 multiply-add rate.

Port of ``scripts/probe_vpu.py``: a kernel that does nothing but a chain of
512 dependent ``y = y*x + 12345`` steps in uint32 per element (kernel K3,
``csrc/mulchain.cu``, one IMAD per step), so its achieved rate is the
ceiling for the integer multiply-add work of the hash kernels.  The second
measurement is the plain PyTorch chain on the card, 64 deep, the
counterpart of the JAX script's XLA chain.

    python -m dvt_circuits_tpu_torch.probe_vpu
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from . import kernels

CHAIN = 512  # dependent multiply-adds per element per kernel pass
ADDEND = 12345
_M32 = 0xFFFFFFFF
_M16 = 0xFFFF
#: the 32-bit integer instruction rate chip_smoke.py bounds the kernels
#: with: the H100 data sheet's 67 TFLOP/s fp32 (an FMA counts 2) is 33.5e12
#: lane-instructions per second, 128 lanes per SM per clock
INT32_OPS_PER_S = 67e12 / 2


def mulchain_plain(x: torch.Tensor, depth: int = CHAIN) -> torch.Tensor:
    """``depth`` steps of y = y*x + 12345 mod 2^32 on the low 32 bits of an
    int64 tensor, in plain PyTorch ops.  int64 cannot hold a product of two
    32-bit values, so x is split into 16-bit halves: y·x ≡ y·x_lo +
    ((y·x_hi) mod 2^16)·2^16 (mod 2^32), each partial product below 2^48."""
    x = x & _M32
    x_lo, x_hi = x & _M16, x >> 16
    y = x
    for _ in range(depth):
        y = (y * x_lo + (((y * x_hi) & _M16) << 16) + ADDEND) & _M32
    return y


@lru_cache(maxsize=None)
def _library():
    lib = kernels.load("mulchain")
    lib.mulchain.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_void_p]
    lib.mulchain.restype = ctypes.c_int
    return lib


def mulchain(x: torch.Tensor) -> torch.Tensor:
    """CHAIN steps of y = y*x + 12345 mod 2^32 on the low 32 bits of each
    element of an int64 tensor; the result is in [0, 2^32).

    A CPU tensor takes ``mulchain_plain``; a CUDA tensor launches kernel K3
    (``csrc/mulchain.cu``) or raises.  K3 replaces the Pallas kernel
    ``scripts/probe_vpu.py:_kernel_mul``."""
    if x.dtype != torch.int64:
        raise ValueError(f"expected an int64 tensor, got {x.dtype}")
    if x.device.type == "cpu":
        return mulchain_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel():
        kernels.check(
            _library().mulchain(x.data_ptr(), out.data_ptr(), x.numel(),
                                kernels.stream_handle(x)),
            "mulchain kernel launch",
        )
        mulchain.launches += 1
    return out


mulchain.launches = 0


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call over ``reps`` calls, CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(n: int = 1 << 18) -> dict:
    """Time K3 and the 64-deep plain chain at (16, n) on the card; print
    both rates and return them."""
    dev = kernels.resolve_device("cuda")
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.integers(0, 1 << 32, size=(16, n), dtype=np.int64), device=dev)
    elems = x.numel()
    ms = time_ms(lambda: mulchain(x), reps=20)
    imad_per_s = elems * CHAIN / ms * 1e3
    print(f"mul+add chain (K3, {CHAIN} deep) at (16, {n}): {ms:.6f} ms -> "
          f"{imad_per_s:.4e} IMAD/s, {2 * imad_per_s / 1e12:.3f} Tops/s (uint32 mul+add); "
          f"{imad_per_s / INT32_OPS_PER_S:.4f} of the {INT32_OPS_PER_S:.4e}/s int32 rate")
    plain_ms = time_ms(lambda: mulchain_plain(x, 64), reps=3, warmup=1)
    plain_rate = elems * 64 * 2 / plain_ms * 1e3
    print(f"plain torch mul+add chain (64 deep): {plain_ms:.6f} ms -> "
          f"{plain_rate / 1e12:.3f} Tops/s (uint32 mul+add)")
    return {"ms": ms, "imad_per_s": imad_per_s, "plain64_ms": plain_ms}


if __name__ == "__main__":
    main()
