"""Poseidon2 permutation over BabyBear, width 16.

Port of ``dvt_circuits_tpu/hash/poseidon2.py`` (constants, scalar oracle,
batched permutation) and of its Pallas kernel
``dvt_circuits_tpu/hash/poseidon2_pallas.py:_kernel`` (K1).  K1 carries
every Poseidon2 call of the prover and the verifier through four entry
points, each with its plain PyTorch version here: the permutation
(K1a, the Fiat–Shamir duplex), the Merkle leaf sponge (K1b), the Merkle
levels (K1c) and the proof-of-work search (K1d).

Round structure: external layer; 4 full rounds (add constant, x⁷ on all 16
words, external layer); 13 partial rounds (x⁷ on word 0, internal layer
diag(1..16) plus the row sum); 4 full rounds.  Round constants come from
SHA-256 in counter mode over the same seed as the JAX package, so both
packages share them bit for bit.

Batched layout: (N, 16) int64 tensors in standard form.
"""

from __future__ import annotations

import ctypes
import hashlib
from functools import lru_cache

import numpy as np
import torch

from .. import kernels
from ..field import babybear as bb
from ..utils import spans

WIDTH = 16
RATE = 8  # sponge rate (words absorbed/squeezed per permutation)
DIGEST_WIDTH = 8  # 8 × 31-bit words ≈ 248-bit digests
ROUNDS_F = 8  # external (full) rounds: 4 + 4
ROUNDS_P = 13  # internal (partial) rounds
SBOX_DEGREE = 7

_SEED = b"dvt-circuits-tpu/poseidon2/babybear/w16/v1"


def _field_stream(label: bytes, count: int) -> list[int]:
    """Deterministic uniform field elements via SHA-256 counter mode with
    rejection sampling (no modulo bias)."""
    out = []
    counter = 0
    bound = (1 << 32) - ((1 << 32) % bb.P)
    while len(out) < count:
        block = hashlib.sha256(_SEED + b"/" + label + counter.to_bytes(4, "big")).digest()
        counter += 1
        for i in range(0, 32, 4):
            v = int.from_bytes(block[i : i + 4], "big")
            if v < bound:
                out.append(v % bb.P)
                if len(out) == count:
                    break
    return out


EXTERNAL_CONSTANTS = [
    _field_stream(b"ext", ROUNDS_F * WIDTH)[r * WIDTH : (r + 1) * WIDTH]
    for r in range(ROUNDS_F)
]
INTERNAL_CONSTANTS = _field_stream(b"int", ROUNDS_P)
#: internal-matrix diagonal μ = 1..16 (the JAX package's choice)
INTERNAL_DIAG = list(range(1, WIDTH + 1))


def constant_arrays() -> dict:
    """The round constants and diagonal as numpy arrays (``params``)."""
    return {
        "poseidon2_external": np.array(EXTERNAL_CONSTANTS, dtype=np.uint32),
        "poseidon2_internal": np.array(INTERNAL_CONSTANTS, dtype=np.uint32),
        "poseidon2_diag": np.array(INTERNAL_DIAG, dtype=np.uint32),
    }


# ---------------------------------------------------------------------------
# Scalar reference (standard-form ints)
# ---------------------------------------------------------------------------


def _s_sbox(x: int) -> int:
    x2 = x * x % bb.P
    x3 = x2 * x % bb.P
    x4 = x2 * x2 % bb.P
    return x4 * x3 % bb.P


def _s_m4(x):
    """Multiply a 4-vector by the Poseidon2 M4 block (add/double chain)."""
    p = bb.P
    t0 = (x[0] + x[1]) % p
    t1 = (x[2] + x[3]) % p
    t2 = (2 * x[1] + t1) % p
    t3 = (2 * x[3] + t0) % p
    t4 = (4 * t1 + t3) % p
    t5 = (4 * t0 + t2) % p
    t6 = (t3 + t5) % p
    t7 = (t2 + t4) % p
    return [t6, t5, t7, t4]


def _s_external_linear(state):
    groups = [_s_m4(state[i : i + 4]) for i in range(0, WIDTH, 4)]
    sums = [sum(g[j] for g in groups) % bb.P for j in range(4)]
    return [(groups[i // 4][i % 4] + sums[i % 4]) % bb.P for i in range(WIDTH)]


def _s_internal_linear(state):
    total = sum(state) % bb.P
    return [(INTERNAL_DIAG[i] * state[i] + total) % bb.P for i in range(WIDTH)]


def s_permute(state):
    """Scalar Poseidon2 permutation on a list of 16 standard-form ints."""
    assert len(state) == WIDTH
    state = _s_external_linear([x % bb.P for x in state])
    for r in range(ROUNDS_F // 2):
        state = [(x + c) % bb.P for x, c in zip(state, EXTERNAL_CONSTANTS[r])]
        state = [_s_sbox(x) for x in state]
        state = _s_external_linear(state)
    for r in range(ROUNDS_P):
        state[0] = _s_sbox((state[0] + INTERNAL_CONSTANTS[r]) % bb.P)
        state = _s_internal_linear(state)
    for r in range(ROUNDS_F // 2, ROUNDS_F):
        state = [(x + c) % bb.P for x, c in zip(state, EXTERNAL_CONSTANTS[r])]
        state = [_s_sbox(x) for x in state]
        state = _s_external_linear(state)
    return state


# ---------------------------------------------------------------------------
# Plain PyTorch permutation on (N, 16) int64
# ---------------------------------------------------------------------------


def _sbox(x):
    x2 = x * x % bb.P
    x3 = x2 * x % bb.P
    x4 = x2 * x2 % bb.P
    return x4 * x3 % bb.P


def _external_linear(state):
    # M4 on each group of 4 words, then every word gets its column's sum
    # over the 4 groups.  Sums stay unreduced (< 80·p < 2⁴⁰) until one
    # final % P — exact, since only the residue matters.
    x0, x1, x2, x3 = state.reshape(-1, 4, 4).unbind(-1)
    t0 = x0 + x1
    t1 = x2 + x3
    t2 = 2 * x1 + t1
    t3 = 2 * x3 + t0
    t4 = 4 * t1 + t3
    t5 = 4 * t0 + t2
    y = torch.stack([t3 + t5, t5, t2 + t4, t4], dim=-1)  # (N, 4 groups, 4)
    return ((y + y.sum(dim=1, keepdim=True)) % bb.P).view(-1, WIDTH)


def _internal_linear(state, diag):
    return (state * diag + state.sum(dim=1, keepdim=True)) % bb.P


def permute_plain(states: torch.Tensor, consts: dict | None = None) -> torch.Tensor:
    """The permutation in plain PyTorch ops on (N, 16) int64 standard form —
    the kernel's reference and the CPU path.  ``consts`` defaults to the
    port's own tables (``params.constants``)."""
    from .. import params

    c = params.constants(states.device) if consts is None else consts
    ext, int_, diag = c["poseidon2_external"], c["poseidon2_internal"], c["poseidon2_diag"]
    state = _external_linear(states)
    for r in range(ROUNDS_F // 2):
        state = _external_linear(_sbox((state + ext[r]) % bb.P))
    for r in range(ROUNDS_P):
        s0 = _sbox((state[:, :1] + int_[r]) % bb.P)
        state = _internal_linear(torch.cat([s0, state[:, 1:]], dim=1), diag)
    for r in range(ROUNDS_F // 2, ROUNDS_F):
        state = _external_linear(_sbox((state + ext[r]) % bb.P))
    return state


# ---------------------------------------------------------------------------
# Plain versions of the loops around the permutation (the CPU path, and the
# references of K1b-K1d)
# ---------------------------------------------------------------------------


def hash_rows_plain(matrix: torch.Tensor) -> torch.Tensor:
    """Overwrite-mode rate-8 sponge of each row of an (n, w) int64 matrix:
    ``state[:8] = chunk`` (the last chunk zero-padded), permute; the digest
    is ``state[:8]`` → (n, 8)."""
    n, w = matrix.shape
    state = matrix.new_zeros((n, WIDTH))
    for off in range(0, w, RATE):
        chunk = matrix[:, off : off + RATE]
        state[:, : chunk.shape[1]] = chunk
        state[:, chunk.shape[1] : RATE] = 0
        state = permute_plain(state)
    return state[:, :DIGEST_WIDTH].contiguous()


def compress_plain(pairs: torch.Tensor) -> torch.Tensor:
    """(m, 16) digest pairs ``left ‖ right`` → (m, 8) parents."""
    return permute_plain(pairs)[:, :DIGEST_WIDTH].contiguous()


def merkle_levels_plain(buf: torch.Tensor, n: int) -> None:
    """Fill a (2n − 1, 8) buffer whose first n rows are leaf digests with
    every level after them, level by level; the root is the last row."""
    off = 0
    while n > 1:
        buf[off + n : off + n + n // 2] = compress_plain(buf[off : off + n].reshape(n // 2, WIDTH))
        off += n
        n //= 2


def grind_plain(base: torch.Tensor, pos: int, bits: int, start: int, count: int):
    """Lowest w in [start, start + count) whose state — ``base`` with word
    ``pos`` set to w mod p — permutes to a word 0 with ``bits`` low zero
    bits; None if there is none."""
    cands = torch.arange(start, start + count, dtype=torch.int64, device=base.device) % bb.P
    states = base.expand(count, WIDTH).clone()
    states[:, pos] = cands
    hits = torch.nonzero((permute_plain(states)[:, 0] & ((1 << bits) - 1)) == 0)
    return start + int(hits[0, 0]) if hits.numel() else None


# ---------------------------------------------------------------------------
# Kernel K1: csrc/poseidon2.cu (+ poseidon2_core.cuh), four entry points
# ---------------------------------------------------------------------------

#: states per launch from which one lane per state is the faster layout on
#: the H100; below it each state is split over 4 lanes, one M4 group each
#: (chip_smoke.py times both at the main path's shapes)
_FULL_STATES = 1 << 14
#: lanes per state of K1c: the faster layout for the levels above 2^14 leaves
_LEVEL_LANES = 4


def _lanes(states: int) -> int:
    """Lanes per state for a launch over ``states`` states: 1 or 4."""
    return 1 if states >= _FULL_STATES else 4


@lru_cache(maxsize=None)
def _library():
    """K1's library, loaded once, with the round constants uploaded."""
    lib = kernels.load("poseidon2")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    signatures = {
        "p2_set_constants": [ptr] * 3,
        "p2_permute": [ptr, ptr, i64, i32, ptr],
        "p2_hash_rows": [ptr, i64, i64, i64, i64, ptr, i32, ptr],
        "p2_merkle_levels": [ptr, i64, i32, ptr, ctypes.POINTER(ctypes.c_int)],
        "p2_grind": [ptr, i32, ctypes.c_uint, i64, i64, ptr, i32, ptr],
    }
    for name, argtypes in signatures.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    arrs = [np.ascontiguousarray(a, dtype=np.uint32) for a in constant_arrays().values()]
    kernels.check(
        lib.p2_set_constants(*[a.ctypes.data_as(ctypes.c_void_p) for a in arrs]),
        "p2_set_constants",
    )
    return lib


def _on_card(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one (the plain path)."""
    if t.dtype != torch.int64:
        raise ValueError(f"{what}: expected int64, got {t.dtype}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device.type == "cuda"


def poseidon2_permute(states: torch.Tensor) -> torch.Tensor:
    """K1a: permute a batch of (N, 16) int64 standard-form states.

    A CPU tensor takes ``permute_plain``; a CUDA tensor launches kernel K1
    (``csrc/poseidon2.cu``) or raises.  K1 replaces the Pallas kernel
    ``dvt_circuits_tpu/hash/poseidon2_pallas.py:_kernel``."""
    if states.dim() != 2 or states.shape[1] != WIDTH:
        raise ValueError(f"expected (N, {WIDTH}) int64 states, got "
                         f"{tuple(states.shape)} {states.dtype}")
    if not _on_card(states, "poseidon2_permute"):
        return permute_plain(states)
    states = states.contiguous()
    out = torch.empty_like(states)
    n = states.shape[0]
    if n:
        kernels.check(
            _library().p2_permute(states.data_ptr(), out.data_ptr(), n,
                                  _lanes(n), kernels.stream_handle(states)),
            "poseidon2 kernel launch",
        )
        poseidon2_permute.launches += 1
    return out


def poseidon2_hash_rows(matrix: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """K1b: the leaf sponge (``hash_rows_plain``) of every row of an (n, w)
    int64 matrix → (n, 8), in one launch on the card.  The matrix may have
    any strides; ``out``, if given, is a contiguous (n, 8) int64 tensor on
    the same device."""
    if matrix.dim() != 2:
        raise ValueError(f"expected an (n, w) matrix, got {tuple(matrix.shape)}")
    n, w = matrix.shape
    if out is None:
        out = matrix.new_empty((n, DIGEST_WIDTH))
    elif (out.shape != (n, DIGEST_WIDTH) or not out.is_contiguous()
          or out.device != matrix.device or out.dtype != torch.int64):
        raise ValueError("out must be a contiguous (n, 8) int64 tensor beside the matrix")
    if not _on_card(matrix, "poseidon2_hash_rows"):
        out.copy_(hash_rows_plain(matrix))
        return out
    if n:
        kernels.check(
            _library().p2_hash_rows(matrix.data_ptr(), n, w, matrix.stride(0), matrix.stride(1),
                                    out.data_ptr(), _lanes(n),
                                    kernels.stream_handle(matrix)),
            "poseidon2 sponge launch",
        )
        poseidon2_hash_rows.launches += 1
    return out


def poseidon2_merkle_levels(buf: torch.Tensor, n: int) -> None:
    """K1c: fill a contiguous (2n − 1, 8) int64 buffer whose first n rows
    are leaf digests (n a power of two) with every level of the tree,
    in place (``merkle_levels_plain``): one launch per level, one for the
    levels of at most 128 parents at the top."""
    if buf.shape != (2 * n - 1, DIGEST_WIDTH) or n & (n - 1) or not buf.is_contiguous():
        raise ValueError(f"expected a contiguous ({2 * n - 1}, 8) buffer for {n} leaves")
    if not _on_card(buf, "poseidon2_merkle_levels"):
        merkle_levels_plain(buf, n)
        return
    launched = ctypes.c_int(0)
    err = _library().p2_merkle_levels(buf.data_ptr(), n, _LEVEL_LANES,
                                      kernels.stream_handle(buf), ctypes.byref(launched))
    poseidon2_merkle_levels.launches += launched.value
    kernels.check(err, "poseidon2 Merkle level launch")


def poseidon2_grind(base: torch.Tensor, pos: int, bits: int, start: int, count: int):
    """K1d: one batch of the proof-of-work search (``grind_plain``): the
    lowest w in [start, start + count) with ``bits`` zero low bits, or None.
    ``base`` is the pending (16,) int64 state; on the card each thread
    builds and permutes its own candidate, and the host reads back 8
    bytes."""
    if base.shape != (WIDTH,) or not 0 <= pos < RATE or not 0 <= bits <= 27 or count < 1:
        raise ValueError("grind: expected a (16,) state, 0 <= pos < 8, bits <= 27, count >= 1")
    # the batch's one 8-byte result, counted on the plain path alike
    spans.host_read(8)
    if not _on_card(base, "poseidon2_grind"):
        return grind_plain(base, pos, bits, start, count)
    base = base.contiguous()
    best = torch.full((1,), -1, dtype=torch.int64, device=base.device)
    kernels.check(
        _library().p2_grind(base.data_ptr(), pos, (1 << bits) - 1, start, count, best.data_ptr(),
                            _lanes(count), kernels.stream_handle(base)),
        "poseidon2 grind launch",
    )
    poseidon2_grind.launches += 1
    w = int(best.item())
    return None if w == -1 else w


poseidon2_permute.launches = 0
poseidon2_hash_rows.launches = 0
poseidon2_merkle_levels.launches = 0
poseidon2_grind.launches = 0
