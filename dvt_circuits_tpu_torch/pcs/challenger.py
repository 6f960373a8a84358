"""Fiat–Shamir duplex challenger over the Poseidon2 permutation.

Port of ``dvt_circuits_tpu/pcs/challenger.py``: the same transcript spec
(observe/duplex/sample, RATE = 8, ``sample_bits`` ≤ 27, grind witness =
lowest w with ``sample_bits(bits) == 0`` after ``observe(w)``).  The
buffers stay host-side Python ints; every duplex permutes its one state
through ``poseidon2_permute`` on the challenger's device (K1a on the card),
and the grind searches batches of candidates with ``poseidon2_grind`` (K1d:
each candidate state is built and permuted in its own thread, and one
8-byte result per batch comes back).
"""

from __future__ import annotations

import torch

from .. import kernels
from ..field import babybear as bb
from ..field import ext
from ..hash.poseidon2 import RATE, WIDTH, poseidon2_grind, poseidon2_permute
from ..utils import spans


class DuplexChallenger:
    def __init__(self, device="cuda") -> None:
        self.device = kernels.resolve_device(device)
        self.state = [0] * WIDTH
        self.input_buffer: list[int] = []
        self.output_buffer: list[int] = []

    # -- observing ---------------------------------------------------------

    def observe(self, value: int) -> None:
        self.output_buffer.clear()
        self.input_buffer.append(int(value) % bb.P)
        if len(self.input_buffer) == RATE:
            self._duplex()

    def observe_many(self, values) -> None:
        for v in values:
            self.observe(v)

    def observe_ext(self, value) -> None:
        self.observe_many(value)

    # -- sampling ----------------------------------------------------------

    def _pending_state(self) -> list:
        state = list(self.state)
        state[: len(self.input_buffer)] = self.input_buffer
        return state

    def _duplex(self) -> None:
        st = torch.tensor([self._pending_state()], dtype=torch.int64, device=self.device)
        self.input_buffer.clear()
        out = poseidon2_permute(st)[0]
        spans.host_read(out)
        self.state = out.tolist()
        self.output_buffer = list(self.state[:RATE])

    def sample(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplex()
        return self.output_buffer.pop(0)

    def sample_ext(self):
        return tuple(self.sample() for _ in range(ext.D))

    def sample_bits(self, bits: int) -> int:
        if bits > 27:
            raise ValueError("sample_bits limited to 27 bits (p = 15·2^27+1)")
        return self.sample() & ((1 << bits) - 1)

    # -- proof of work -----------------------------------------------------

    def check_witness(self, bits: int, witness: int) -> bool:
        clone = self.clone()
        clone.observe(witness)
        ok = clone.sample_bits(bits) == 0
        if ok:
            self.observe(witness)
            assert self.sample_bits(bits) == 0
        return ok

    def grind(self, bits: int) -> int:
        """Lowest witness w with sample_bits(bits) == 0 after observe(w),
        searched in device batches; advances the transcript with it."""
        batch = 1 << min(bits + 2, 16)
        pos = len(self.input_buffer)
        base = torch.tensor(self._pending_state(), dtype=torch.int64, device=self.device)
        start = 0
        while True:
            w = poseidon2_grind(base, pos, bits, start, batch)
            if w is not None:
                assert self.check_witness(bits, w)
                return w
            start += batch

    def clone(self) -> "DuplexChallenger":
        c = DuplexChallenger(self.device)
        c.state = list(self.state)
        c.input_buffer = list(self.input_buffer)
        c.output_buffer = list(self.output_buffer)
        return c
