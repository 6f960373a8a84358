"""Latencies of one Fp product and one point operation on the card, in the
one-thread form of C1 and C3 and in the lane form of C2 and C4
(``csrc/lane_probe.cu``): the measurements that chose C2's and C4's design.

    python3 -m dvt_circuits_tpu_torch.curve.lane_probe

Run from the root of a checkout, on a machine with a CUDA card;
``chip_smoke.py``'s curve phase runs it too.  Each figure is a chain of
dependent operations in one block, timed (CUDA events, best of 3) at two
lengths, so one operation's latency is the difference over the difference
of the lengths, free of the launch.  The forms of each chain end on the
same limbs, which the probe checks.  Prints the card and one JSON line of
microseconds.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from functools import lru_cache

import numpy as np
import torch

from .. import kernels
from ..hostcrypto import bls12_381 as host
from . import lanes

REPS = (16, 80)
_R = 1 << 384


@lru_cache(maxsize=None)
def _library():
    lib = kernels.load("lane_probe")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_fp_chain.argtypes = [vp, i, i, i, vp]
    lib.probe_point_chain.argtypes = [vp, i, i, i, i, vp]
    lib.probe_program.argtypes = [vp, vp, i, i, vp]
    for fn in (lib.probe_fp_chain, lib.probe_point_chain, lib.probe_program):
        fn.restype = ctypes.c_int
    return lib


def _words(values) -> np.ndarray:
    """Standard-form ints → Montgomery words (12 uint32 each)."""
    out = []
    for v in values:
        m = v * _R % host.P
        out += [(m >> (32 * k)) & 0xFFFFFFFF for k in range(12)]
    return np.array(out, dtype=np.uint32)


def _chain_us(launch, io0: torch.Tensor) -> tuple:
    """(µs an operation, the io words after the longer chain)."""
    times = {}
    for reps in REPS:
        best = None
        for _ in range(3):
            io = io0.clone()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            kernels.check(launch(io.data_ptr(), reps, kernels.stream_handle(io)), "probe launch")
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            best = ms if best is None else min(best, ms)
        times[reps] = (best, io)
    (r0, (t0, _)), (r1, (t1, io)) = sorted(times.items())
    return (t1 - t0) * 1e3 / (r1 - r0), io.cpu()


def measure() -> dict:
    """{figure: µs}: the product with 1 lane out of line and inline, 32
    inline chains side by side in one warp, the lanes' sum; G1 and G2
    doubling and addition in one thread and in their lane groups."""
    lib = _library()
    rng = np.random.default_rng(7)
    out = {}
    elems = [int.from_bytes(rng.bytes(48), "big") % host.P for _ in range(64)]
    io0 = torch.as_tensor(_words(elems).view(np.int32), device="cuda")
    ends = {}
    for label, threads, form in (("fp product, out of line, 1 lane", 1, 0),
                                 ("fp product, inline, 1 lane", 1, 1),
                                 ("fp product, inline, 32 lanes side by side", 32, 1),
                                 ("fp sum (lanes), 1 lane", 1, 2)):
        out[label], io = _chain_us(
            lambda ptr, reps, s, t=threads, f=form: lib.probe_fp_chain(ptr, t, reps, f, s), io0)
        ends[label] = io[:12]
    if len({tuple(ends[k].tolist()) for k in list(ends)[:3]}) != 1:
        raise AssertionError("the product's forms end on different limbs")
    # a step of the interpreter (lanes.run), 8 groups of 4 lanes: one lane's
    # product, four lanes' products, one sum, one shifted sum (2^3 (a + 2^3
    # b): 7 sums).  Steps go in pairs, so each reads what the one before
    # wrote: lane k writes slot 2 + k from slots 0 and 1, then slot 0 (lane
    # 0) or 2 + k from slots 2 and 1.
    for label, kind, active, shift in (("step, 1 product", lanes.MUL, 1, 0),
                                       ("step, 4 products", lanes.MUL, 4, 0),
                                       ("step, 1 sum", lanes.ADD, 1, 0),
                                       ("step, 1 shifted sum", lanes.ADD, 1, 3)):
        pair = [lanes.encode((kind, 2 + k if step == 0 or k else 0, 2 * step, 1, shift, shift))
                if k < active else 0
                for step in (0, 1) for k in range(4)]
        prog = torch.as_tensor(np.array(pair * (REPS[1] // 2), dtype=np.uint32).view(np.int32),
                               device="cuda")
        out[f"interpreter {label}"], _ = _chain_us(
            lambda ptr, reps, s, pr=prog: lib.probe_program(ptr, pr.data_ptr(), reps, 4, s),
            io0[:4 * 12])
    g1_pts = [host.g1_mul(host.G1_GEN, 5), host.g1_mul(host.G1_GEN, 11)]
    g2_pts = [host.g2_mul(host.G2_GEN, 5), host.g2_mul(host.G2_GEN, 11)]
    g1_io = _words([v for pt in g1_pts for v in (*pt, 1)])
    g2_io = _words([v for pt in g2_pts for v in (*pt[0], *pt[1], 1, 0)])
    for curve, io_words, name, forms in ((1, g1_io, "g1", ("one thread", "4 lanes")),
                                         (2, g2_io, "g2", ("one thread", "a warp"))):
        io0 = torch.as_tensor(io_words.view(np.int32), device="cuda")
        for op, op_name in ((0, "dbl"), (1, "add")):
            got = []
            for form, form_name in enumerate(forms):
                us, io = _chain_us(
                    lambda ptr, reps, s, c=curve, o=op, f=form:
                    lib.probe_point_chain(ptr, c, reps, o, f, s), io0)
                out[f"{name} {op_name}, {form_name}"] = us
                got.append(io[:len(io_words) // 2].tolist())
            if got[0] != got[1]:
                raise AssertionError(f"{name} {op_name}: the forms end on different limbs")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("lane_probe: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    print(json.dumps({"lane_probe_us": measure()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
