"""Batched Keccak-f[1600] / Keccak-256 on int64 tensors.

Port of ``dvt_circuits_tpu/hash/keccak.py`` and of its Pallas kernel
``_pallas_kernel`` (K2).  The TPU has no 64-bit lanes and split each lane
into (lo, hi) uint32 halves; here a lane is one int64 holding the 64-bit
pattern.  ``>>`` on int64 is arithmetic, so every rotation masks after its
right shift.  ``keccak_f1600`` (K2) is the kernel's direct counterpart;
``keccak256_batch`` and ``sha3_256_batch`` (the CLI's artifact
fingerprint) absorb a whole batch in one launch of ``keccak_sponge`` (K2b).

State layout: (N, 25) int64, lane index x + 5y; sponge blocks (n_blocks, N,
17), the rate lanes of each padded block.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from .. import kernels

RATE_BYTES = 136  # 1088-bit rate for 256-bit digests
RATE_LANES = RATE_BYTES // 8
DIGEST_LANES = 4  # 256-bit digests

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
# rotation offsets r[x][y] indexed as lane x + 5y
_ROT = [
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14,
]
# π: dst lane (x, y) ← src lane (x + 3y mod 5, x), dst index = x + 5y
_PI_SRC = [((x + 3 * y) % 5) + 5 * x for y in range(5) for x in range(5)]


def _rotl(x, n: int):
    if n == 0:
        return x
    return (x << n) | ((x >> (64 - n)) & ((1 << n) - 1))


def keccak_f1600_plain(state: torch.Tensor, consts: dict | None = None) -> torch.Tensor:
    """Keccak-f[1600] in plain PyTorch ops on (N, 25) int64 lanes — the
    kernel's reference and the CPU path."""
    from .. import params

    c = params.constants(state.device) if consts is None else consts
    rc, rot = c["keccak_rc"], [int(r) for r in c["keccak_rot"].tolist()]
    a = list(state.unbind(1))
    for r in range(24):
        cols = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [cols[(x - 1) % 5] ^ _rotl(cols[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        b = [_rotl(a[_PI_SRC[i]], rot[_PI_SRC[i]]) for i in range(25)]
        a = [
            b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y])
            for y in range(5)
            for x in range(5)
        ]
        a[0] = a[0] ^ rc[r]
    return torch.stack(a, dim=1)


@lru_cache(maxsize=None)
def _entry_points():
    """K2's and K2b's C entry points, their prototypes set once."""
    lib = kernels.load("keccak")
    lib.keccak_f1600.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_longlong, ctypes.c_void_p]
    lib.keccak_sponge.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                                  ctypes.c_void_p, ctypes.c_void_p]
    lib.keccak_f1600.restype = lib.keccak_sponge.restype = ctypes.c_int
    return lib.keccak_f1600, lib.keccak_sponge


def keccak_f1600(state: torch.Tensor) -> torch.Tensor:
    """Keccak-f[1600] on a batch of (N, 25) int64 lane states.

    A CPU tensor takes ``keccak_f1600_plain``; a CUDA tensor launches kernel
    K2 (``csrc/keccak.cu``) or raises.  K2 replaces the Pallas kernel
    ``dvt_circuits_tpu/hash/keccak.py:_pallas_kernel``."""
    if state.dim() != 2 or state.shape[1] != 25 or state.dtype != torch.int64:
        raise ValueError(f"expected (N, 25) int64 lanes, got "
                         f"{tuple(state.shape)} {state.dtype}")
    if state.device.type == "cpu":
        return keccak_f1600_plain(state)
    if state.device.type != "cuda":
        raise ValueError(f"unsupported device {state.device}")
    if not state.is_contiguous():
        state = state.contiguous()
    out = torch.empty_like(state)
    n = state.shape[0]
    if n:
        kernels.check(_entry_points()[0](state.data_ptr(), out.data_ptr(), n,
                                         kernels.stream_handle(state)),
                      "keccak kernel launch")
        keccak_f1600.launches += 1
    return out


keccak_f1600.launches = 0


def keccak_sponge_plain(blocks: torch.Tensor) -> torch.Tensor:
    """The sponge in plain PyTorch ops: absorb (n_blocks, n, 17) int64 rate
    blocks (padded) into zero states → (n, 4) digest lanes."""
    state = blocks.new_zeros((blocks.shape[1], 25))
    for blk in blocks:
        state[:, :RATE_LANES] ^= blk
        state = keccak_f1600_plain(state)
    return state[:, :DIGEST_LANES].contiguous()


def keccak_sponge(blocks: torch.Tensor) -> torch.Tensor:
    """Absorb every rate block of a batch of equal-length messages: (n_blocks,
    n, 17) int64 lanes, padded (``_pack``) → (n, 4) int64 digest lanes.

    A CPU tensor takes ``keccak_sponge_plain``; a CUDA tensor launches kernel
    K2b (``csrc/keccak.cu``), one launch for the whole batch, or raises.  K2b
    is K2's redesign for the reference's one-dispatch sponge
    (``dvt_circuits_tpu/hash/keccak.py:_absorb_all``, whose permutations run
    in ``_pallas_kernel``)."""
    if (blocks.dim() != 3 or blocks.shape[0] < 1 or blocks.shape[2] != RATE_LANES
            or blocks.dtype != torch.int64):
        raise ValueError(f"expected (n_blocks >= 1, n, {RATE_LANES}) int64 rate lanes, got "
                         f"{tuple(blocks.shape)} {blocks.dtype}")
    if blocks.device.type == "cpu":
        return keccak_sponge_plain(blocks)
    if blocks.device.type != "cuda":
        raise ValueError(f"unsupported device {blocks.device}")
    if not blocks.is_contiguous():
        blocks = blocks.contiguous()
    n_blocks, n, _ = blocks.shape
    out = blocks.new_empty((n, DIGEST_LANES))
    if n:
        kernels.check(_entry_points()[1](blocks.data_ptr(), n_blocks, n, out.data_ptr(),
                                         kernels.stream_handle(blocks)),
                      "keccak sponge launch")
        keccak_sponge.launches += 1
    return out


keccak_sponge.launches = 0


def _pack(messages, domain_byte: int) -> np.ndarray:
    """Equal-length messages → (n_blocks, n, 17) int64 rate lanes, padded."""
    ln = len(messages[0])
    if any(len(m) != ln for m in messages):
        raise ValueError("messages must share one length (pad the batch)")
    n_blocks = ln // RATE_BYTES + 1
    total = n_blocks * RATE_BYTES
    pad = bytearray(total - ln)
    pad[0] ^= domain_byte
    pad[-1] ^= 0x80
    pad = bytes(pad)
    buf = np.frombuffer(bytearray(b"".join(m + pad for m in messages)), dtype="<i8")
    lanes = buf.reshape(len(messages), n_blocks, RATE_LANES).transpose(1, 0, 2)
    return np.ascontiguousarray(lanes, dtype=np.int64)


def _hash_batch(messages, domain_byte: int, device) -> list:
    """One copy to the device, one K2b launch, one copy back."""
    blocks = torch.as_tensor(_pack(messages, domain_byte), device=kernels.resolve_device(device))
    lanes = keccak_sponge(blocks).cpu().numpy().astype("<i8")
    return [row.tobytes() for row in lanes]


def keccak256_batch(messages, device="cuda") -> list:
    """Batched Ethereum Keccak-256 (0x01 domain padding) → 32-byte digests."""
    return _hash_batch(messages, 0x01, device)


def sha3_256_batch(messages, device="cuda") -> list:
    """Batched FIPS 202 SHA3-256 (0x06 domain padding) → 32-byte digests."""
    return _hash_batch(messages, 0x06, device)
