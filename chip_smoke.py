#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dvt_circuits_tpu_torch``) on one
NVIDIA GPU — the quickest proof that the port still builds, proves and
verifies there.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

  1. require a CUDA card; print its name and power limit (nvidia-smi);
  2. build every kernel from ``dvt_circuits_tpu_torch/csrc`` (one nvcc per
     source, in parallel); print K1's register report, each curve
     kernel's registers and stack (``cuobjdump --dump-resource-usage``) and
     each K1 and K2 kernel's static integer instructions in the SASS (a
     diagnostic of the design); count K3's (K3 must hold at least 512 IMAD per element: its
     chain is not folded);
  3. K1a (the Poseidon2 permutation): kernel vs plain PyTorch on 2^20
     random states plus all-0 / all-(p−1) rows and at the prover's shapes,
     bit-equal, with 1 and 4 lanes per state; 16 rows vs the scalar
     ``s_permute``; CUDA-event timings;
  3b. K1b (the leaf sponge, one launch per tree) at 2^14 x 4314, 2^12 x 336
     and 2^14 x 32, also on a strided view; K1c (the Merkle levels) at 2^14
     leaves; K1d (the proof-of-work search) on 2^16 candidates at pending
     positions 0, 3 and 7: each bit-equal to its plain version, then timed
     with 1 and 4 lanes per state against the plain version and the bound;
  4. K2 (Keccak-f[1600]): kernel vs plain on 2^18 states (its path's
     batch), bit-equal; K2b (the sponge, one launch a batch) vs plain at 1
     message of 1 block and at 2^12 messages of 1 and 3 blocks, bit-equal;
     Keccak-256 / SHA3-256 known digests; where one-state time goes (CUDA
     events, the wrapper's host time, the kernel's device time from a
     CUDA-graph replay of 200 calls that must hold 200 kernel nodes) for
     K2, K2b and the fingerprint as the CLI runs it; K2 through its old
     launch path and the fingerprint's old per-block route against the new
     ones, in turns; timings;
  5. K3 (the multiply-add probe): kernel vs plain on (16, 2^18) random
     values plus rows of 0, 1 and 2^32−1, bit-equal; timings; its IMAD rate;
  5b. the curve package (phase ``curve``): the lane probe
     (``curve/lane_probe.py``: one product's and one point operation's
     latency, in one thread and spread over lanes); C1 (the Fp Montgomery
     product, tiles of ``kTile`` products, ``csrc/fp_tile.cuh``) bit-equal to
     ``mont_mul_plain`` on 1,024 (the curve path's batch), 2^16 and 2^20
     random pairs and the rows 0, 1, p − 1, p − 2, at the tails ``kTile`` ±
     1 and 2^16 + 3 and on views 8 bytes off a 16-byte boundary (the wrapper
     copies them), its call and its kernel alone (raw launches) timed at
     each size, its cuobjdump LOCAL and STACK 0; C2 (the windowed G1 MSM) and C3 (the GLV bucket MSM)
     equal to the host oracle on an edge batch (zero scalars, an identity,
     a repeated point, P and −P; C3 at w = 2, 4, 8) and at bench.py's 1,024
     and 4,096 points (P_i = (7i + 3)·G, so the oracle is one host scalar
     multiplication), C2's Jacobian limbs equal to ``msm_plain``'s (the edge
     batch too); C3 also
     on 4,096 points of one scalar, its four stages (C3a the sort, C3b the
     bucket sums, C3c the window sums, C3d the Horner) each equal to its
     plain stage (``msm_bucket_plain``'s limbs) and the same in a second
     run, each stage timed; C4 (the
     G2 scalar multiplication) limb-equal to ``scalar_mul_plain``, the same
     in two runs and equal to the host ``g2_mul`` on 16 points (one the
     identity), then on 1,024 points whose first 16 are those (their limbs
     equal the 16-point run's, a sample equals the host ``g2_mul``; the
     plain version is not run again); each timed against its plain
     version and its bound; then the curve path: ``msm`` and ``msm_bucket``
     at 4,096 points (``msm_bucket``'s wall time split into its host input,
     C3's kernels and its host output), ``g2.scalar_mul`` and
     ``g1.add``/``double`` (products through C1) with the launch counts
     reset;
  6. the pre-curve bad-share path: ``prove_circuit("bad-share")`` at
     ``DEFAULT_CONFIG`` for a 7-of-10 committee whose seed exchange names a
     destination outside the committee (the guest slashes before the
     curve check), cold then warm, with launch counts; the container's
     fingerprint through one K2b launch; Merkle openings re-checked with the scalar
     permutation; the same proof on the CPU (plain path) must give equal
     container bytes without ``timing`` (the CLI runs in phase 12);
  7. the probe path: ``probe_vpu.main()`` in-process (K3 launches) and
     ``python -m dvt_circuits_tpu_torch.probe_vpu`` as a subprocess;
  7b. the keccak-f path: ``keccak_f1600`` on 2^18 states, as the
     reference's bench calls its permutation (K2's launches);
  8. the curve paths at full width, 7-of-10: the curve-fault bad-share
     (tables stream, sha256, g1mul with chains 256 + 6×32) and
     bad-partial-key (6 chains of 32 bits), cold then warm (once with each
     prover phase's time and device memory), profiled; every chain's result
     equals the host ``g1_mul``; openings re-checked; the port's own strict
     verifier on the card says ``curve-bound+sig``;
  8b. bad-encrypted-share 7-of-10 (tables stream, sha256, chacha20 2^7 x
     1080 for a 178-byte ciphertext), cold then warm (once with each prover
     phase's time and device memory), profiled; the keystream equals the
     host cipher's; openings re-checked; the port's strict verifier on the
     card says ``hash-bound``; the CLI ``prove`` and ``verify --show-report``
     in-process, each fingerprint one K2b launch; the ChaCha20 quotient
     through ``eval_tensor`` and the generic ``eval``, bit-equal, timed,
     with its launches;
  9. finalization 7-of-10 the same way (its g1mul table 2^16 × 4314, LDE
     2^18), with its device memory peak, unprofiled;
  9b. the sharded prover (phase ``dist``): min(cards, 4) ranks spawned over
     NCCL, one a card (``parallel/mesh.py:spawn``), each with its launch
     counts reset before each path and read after it: the 7-of-10 curve
     fault sharded over every rank (cold, warm, and with ``DVT_EP=1``),
     ``prove_batch`` of two scenarios over ``dp``, ``dist_msm`` at 4,096
     points and, on two cards or more, finalization 7-of-10 sharded; every
     container equal to the single-card one (phases 8 and 9 keep theirs;
     ``--only dist`` proves them here) on every rank, the leaf sponge one
     launch a tree on every rank, each path's time and peak device memory
     a rank; the sharded curve fault accepted by the strict verifier on the
     card; the CLI ``prove`` and ``verify --show-report`` under
     ``torchrun --nproc-per-node`` (its proof file equal to the
     single-card container); the EP commit demo (``ep_commit_tables`` of 4
     tables in the 7-of-10 tables' shapes, padded to 4,096 x 4,314, over
     ep = world when 4 splits over it) and the PP demo
     (``pp_commit_pipeline`` of 8 microbatches of 4,096 x 336 over S =
     world stages; at world < 3 its ValueError is asserted instead), their
     roots equal to the single-card ``merkle_root`` of each coset LDE on
     every rank, EP's leaf sponge one launch a table of the rank, PP's
     stage kernels on their ranks alone;
 10. where the time of one g1mul table goes (the prover's phases timed
     one by one at the curve fault's table shape), and its constraint
     quotient both through ``eval_tensor`` and the generic ``eval``:
     bit-equal, each timed, with its launches (under 10,000 for the first);
 10b. the wide G1 chip (phase ``g1-chip``): ``G1PolyAir`` for the 7-of-10
     curve fault's relation at production widths (k = 7: 512 x 26,477,
     LDE 2,048): K1b on its trace LDE (3,310 absorbed blocks a row)
     bit-equal to ``hash_rows_plain``, its quotient through ``eval_tensor``
     and the generic ``eval`` bit-equal, a legacy ``g1``-kind container
     [stream, SHA-256, G1PolyAir] proven on the card with the launch
     counts reset and accepted by the strict verifier on the card as
     ``curve-bound``, refused with a tampered output public; the
     reduced-width table's proof equal on the card and the CPU;
     ``sha256_batch`` of 2^12 messages of 3 blocks equal to hashlib;
 11. GPU == CPU at the CPU tests' inputs: the 2-of-3 curve fault,
     bad-partial-key, bad-encrypted-share and finalization at
     ``TEST_CONFIG`` give equal container bytes;
 12. the CLI ``prove`` of the 7-of-10 curve fault and ``verify
     --show-report`` of its file, as subprocesses;
 13. the HTTP node (phase ``node``): ``make_server(..., device="cuda")``
     in a thread; ``POST /prove/bad-share`` of the pre-curve 7-of-10
     scenario with the launch counts reset (K1 must launch), its
     ``public_values`` equal to ``prove_circuit``'s; the spec route equal to
     ``schema_for``; ``execute`` 200, an unknown type and a malformed body
     500; the CLI ``get-schema`` and ``validate-schema`` in-process;
 14. one ``{"kernels": [...]}`` line, the card line, and as the last line
     ``{"ok": true, "device": {...}}``.

``--only phase,...`` runs the kernel builds and the named phases alone
(``PHASES``) and prints no result line.

Every path runs with the launch counts set to 0 just before it and read
just after; a kernel that a path should launch and did not fails the run,
and so does a path whose leaf-sponge launches differ from the Merkle
trees it committed plus its batched opening checks (one launch each).
Randomness comes from numpy with fixed seeds.  Bounds:
bytes each kernel must move over 3.35 TB/s, and its integer work over the
int32 instruction rates (see ``_INT32_OPS_PER_S`` and ``_IMAD_PER_S``); the
larger of the two.  K1's and K2's work is the permutation's, counted from
its definition (``P2_IMAD``, ``P2_INSTR``; ``K2_INSTR``, and
``K2B_ABSORB_INSTR`` per absorbed block) times the permutations of the
call, the same for every design; C1–C4's is Fp products of
``FP_MUL_IMAD`` multiplies, counted per point operation from the
formulas (``G1_ADD_MULS``, ``G1_DBL_MULS``, ``G2_ADD_MULS``,
``G2_DBL_MULS``) and per algorithm from this run's digits and bits; K3's
comes from its SASS
(``kernel_work``).  No call can take less than a launch, so each record
also carries ``launch_floor_ms``, the measured time of the cheapest launch
(``launch_floor_ms()``), and ``floor_bound_ms``, the larger of the two.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

#: H100 SXM device-memory rate (NVIDIA data sheet)
_BYTES_PER_S = 3.35e12
#: 32-bit integer instruction rate: Hopper issues IMAD to its FMA pipe and
#: IADD3/ISETP/LOP3/SHF to its ALU pipe, 64 lanes each per SM per clock, so
#: a mix peaks at the fp32 lane rate: the data sheet's 67 TFLOP/s (an FMA
#: counts 2) is 33.5e12 instructions per second
_INT32_OPS_PER_S = 67e12 / 2
#: IMAD alone runs on one of the two pipes, at half that rate: K3, a chain of
#: nothing but IMAD, measures 0.46 of _INT32_OPS_PER_S on the H100
_IMAD_PER_S = _INT32_OPS_PER_S / 2

#: Poseidon2 work per permutation as the algorithm defines it
#: (hash/poseidon2.py), whatever the design: 564 S-box products (8 full
#: rounds x 16 words x 4, 13 partial rounds x 4), each a Montgomery product
#: at 3 IMAD on the FMA pipe; 208 products by the internal diagonal 1..16
#: (13 rounds x 16), one instruction each; 1,084 additions, one instruction
#: each: 9 external layers x 60 (M4's chain of 8 with its doublings folded
#: into shift-adds, x 4 groups, 12 for the column sums, 16 to add them), 13
#: internal layers x 31 (15 for the row sum, 16 to add it) and 141 round
#: constants (8 x 16 + 13)
P2_SBOX_PRODUCTS = 8 * 16 * 4 + 13 * 4
P2_DIAG_PRODUCTS = 13 * 16
P2_ADDS = 9 * (4 * 8 + 12 + 16) + 13 * (15 + 16) + 8 * 16 + 13
P2_IMAD = 3 * P2_SBOX_PRODUCTS
P2_INSTR = P2_IMAD + P2_DIAG_PRODUCTS + P2_ADDS
#: Keccak-f[1600] work per permutation as its definition counts it, in 32-bit
#: instructions (Hopper has no 64-bit logic unit), whatever the design: per
#: round theta 80 (5 column parities at 2 three-input LOP3 per 32-bit half,
#: 5 rotations by one at 2 funnel SHF, 25 lane XORs at one LOP3 per half),
#: rho 48 (24 rotations at 2 SHF), chi 50 (a ^ (~b & c) is one LOP3 per
#: half), iota 2; 24 rounds
K2_THETA = 5 * 2 * 2 + 5 * 2 + 25 * 2
K2_RHO = 24 * 2
K2_CHI = 25 * 2
K2_IOTA = 2
K2_INSTR = 24 * (K2_THETA + K2_RHO + K2_CHI + K2_IOTA)
#: K2b absorbs each rate block before its permutation: 17 lane XORs at one
#: LOP3 per half
K2B_ABSORB_INSTR = 17 * 2
#: bytes each permutation must move: K1a 16 int64 words in and out, K2 25;
#: K2b a rate block of 17 lanes in per block and 4 digest lanes out per
#: message; K3 one int64 in and out per element
K1_BYTES_PER_PERM = 2 * 16 * 8
K2_BYTES_PER_PERM = 2 * 25 * 8
K2B_BYTES_PER_BLOCK = 17 * 8
K2B_BYTES_PER_DIGEST = 4 * 8
K3_BYTES_PER_ELEM = 2 * 8
#: BLS12-381 work as the algorithms define it, whatever the design: one Fp
#: Montgomery product on 12 words of 32 bits is 2 * 12^2 + 12 = 300 32-bit
#: multiplies (a * b_i and m * p_j for each word i, and m), counted as IMAD;
#: a G1 addition is 16 products (add-2007-bl: 11 multiplies, 5 squares; the
#: doubling the JAX code also computes on every addition is not counted), a
#: doubling 7 (dbl-2009-l: 2 multiplies, 5 squares); over Fp^2 a multiply is
#: 3 base products (Karatsuba) and a square 2, so a G2 addition is 11 * 3 +
#: 5 * 2 and a doubling 2 * 3 + 5 * 2
FP_MUL_IMAD = 2 * 12 * 12 + 12
G1_ADD_MULS = 16
G1_DBL_MULS = 7
G2_ADD_MULS = 11 * 3 + 5 * 2
G2_DBL_MULS = 2 * 3 + 5 * 2
#: bytes of one Fp element in the port's layout (32 int64 limbs)
FP_BYTES = 32 * 8
#: the curve phase's sizes: C1's products (1024, the batch of the curve
#: path's g1.add / g1.double; no caller makes batches of 2^16 or more, so
#: 2^16 and 2^20, where device memory and not the launch sets the time, are
#: throughput yardsticks), the MSM points (bench.py times its MSMs at 1024
#: and 4096), C4's G2 points (16, and 1024 where the card is full: a warp a
#: point)
C1_PRODUCTS = (1 << 10, 1 << 16, 1 << 20)
MSM_POINTS = (1024, 4096)
G2_POINTS = 16
G2_POINTS_FULL = 1024
#: integer ALU opcodes counted as work in the compiled kernels
_INT_OPCODES = {"IMAD", "IADD3", "ISETP", "VIADD", "SHF", "LOP3", "SEL", "IMNMX", "LEA", "PRMT"}

SEED = 20261016
_T0 = time.perf_counter()


def _log(msg: str) -> None:
    """One line, prefixed with the seconds since the script started (the
    whole run must stay well inside its time limit)."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def _time_ms(fn, reps: int, warmup: int = 2) -> float:
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


def _sass_functions(lib) -> dict:
    """Opcode counts (base names) of each kernel function of a built
    library, from ``cuobjdump -sass``."""
    from dvt_circuits_tpu_torch import kernels

    tool = Path(kernels._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    funcs: dict = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name, body = part.split("\n", 1)
        counts = funcs.setdefault(name.strip(), {})
        for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", body):
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return funcs


def resource_usage(lib) -> dict:
    """Each kernel's registers, stack frame, local and shared bytes as
    ``cuobjdump --dump-resource-usage`` reports them: {kernel: {"REG": ...,
    "STACK": ..., "LOCAL": ..., "SHARED": ...}}, kernels by their source
    name."""
    from dvt_circuits_tpu_torch import kernels

    tool = Path(kernels._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "--dump-resource-usage", str(lib)], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    usage = {}
    for name, fields in re.findall(r"Function (\S+):\s*\n\s*(REG:.*)", out):
        key = name
        if "_kernel" in name:  # the mangled name's last part: <length><name>
            end = name.index("_kernel") + len("_kernel")
            start = next((end - n for n in range(len("_kernel") + 1, end)
                          if name[:end - n].endswith(str(n))), 0)
            key = name[start:end]
        usage[key] = {k: int(v) for k, v in re.findall(r"(REG|STACK|LOCAL|SHARED):(\d+)", fields)}
    return usage


def _sass_opcodes(lib) -> dict:
    """Opcode counts summed over every kernel function of a library."""
    total: dict = {}
    for counts in _sass_functions(lib).values():
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


def _ints(ops) -> int:
    return sum(v for k, v in ops.items() if k in _INT_OPCODES)


def kernel_work(libs: dict) -> dict:
    """K3's integer instructions per element, as (all, IMAD), from the
    compiled SASS: K3 is straight-line code (one thread per element), so its
    static count is its work.  K1's and K2's bounds do not come from here
    (see ``P2_INSTR`` and ``K2_INSTR``): their kernels' static counts are
    printed as a diagnostic of the design."""
    for name, ops in sorted(_sass_functions(libs["poseidon2"]).items()):
        kernel = re.search(r"(\w+_kernel)ILi(\d)E", name)
        label = f"{kernel.group(1)}<lanes={kernel.group(2)}>" if kernel else name
        _log(f"K1 SASS {label}: {sum(ops.values())} instructions, {_ints(ops)} integer, "
             f"{ops.get('IMAD', 0)} IMAD (static count: one full and one partial round body)")
    for name, ops in sorted(_sass_functions(libs["keccak"]).items()):
        _log(f"K2 SASS {name}: LOP3 + SHF {ops.get('LOP3', 0) + ops.get('SHF', 0)} (static "
             f"count: one round body; Keccak-f's definition counts "
             f"{K2_INSTR // 24} a round), {_ints(ops)} integer instructions in all")
    k3 = _sass_opcodes(libs["mulchain"])
    work = {"mulchain": (_ints(k3), k3.get("IMAD", 0))}
    _log(f"SASS integer instructions (all, IMAD) per element: {work}")
    if work["mulchain"][0] == 0:
        raise AssertionError("no integer instructions found in K3's SASS")
    from dvt_circuits_tpu_torch.probe_vpu import CHAIN

    if work["mulchain"][1] < CHAIN:
        raise AssertionError(f"K3's SASS holds {work['mulchain'][1]} IMAD, fewer than the "
                             f"{CHAIN} steps of its chain: the compiler folded it")
    return work


def _bound_ms(n: int, work, bytes_moved: int):
    """Least time for n items (permutations, elements) of ``work`` = (all
    integer instructions, IMAD) each that must move ``bytes_moved`` bytes:
    the bytes over the memory rate, or the instructions over the issue
    rate, or IMAD over the FMA pipe's rate; the larger."""
    total, imad = work
    t_ops = n * max(total / _INT32_OPS_PER_S, imad / _IMAD_PER_S)
    t_bytes = bytes_moved / _BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def launch_floor_ms() -> float:
    """The cheapest launch this harness can make: the fastest of an in-place
    add, fill and copy on a one-element CUDA tensor, each timed as every
    kernel is (``_time_ms``).  A call that launches a kernel takes about
    this long whatever its work."""
    one, two = (torch.zeros(1, dtype=torch.int64, device="cuda") for _ in range(2))
    return min(_time_ms(fn, 1000, warmup=20)
               for fn in (lambda: one.add_(1), lambda: one.zero_(), lambda: one.copy_(two)))


def with_floor(rec: dict, floor_ms: float) -> dict:
    """Adds the launch floor to a kernel record: ``floor_bound_ms`` is the
    larger of its throughput bound (``bound_ms``) and the floor, and the log
    line gives the kernel's share of each."""
    rec["launch_floor_ms"] = floor_ms
    rec["floor_bound_ms"] = max(rec["bound_ms"], floor_ms)
    rec["share"] = rec["bound_ms"] / rec["ms"]
    rec["floor_share"] = rec["floor_bound_ms"] / rec["ms"]
    _log(f"{rec['name']} {rec['shape']}: {rec['ms']:.6f} ms; share of the throughput bound "
         f"{rec['share']:.3e}, of the bound with the launch floor {rec['floor_share']:.4f}")
    return rec


def k1_bound_ms(perms: int, bytes_moved: int):
    """K1's bound: ``perms`` permutations of the algorithm's own work."""
    return _bound_ms(perms, (P2_INSTR, P2_IMAD), bytes_moved)


def _max_abs_err_u64(a, b) -> int:
    """Largest |a − b| over the 64-bit lanes read as unsigned, compared in
    32-bit halves (int64 differences would overflow)."""
    err = 0
    for shift in (0, 32):
        ha, hb = (a >> shift) & 0xFFFFFFFF, (b >> shift) & 0xFFFFFFFF
        err = max(err, int((ha - hb).abs().max()) << shift)
    return err


def _k1_record(name: str, shape, err: int, ms: float, plain_ms: float, bound) -> dict:
    return {
        "name": name,
        "route": "cuda",
        "source": "dvt_circuits_tpu_torch/csrc/poseidon2.cu",
        "replaces": "dvt_circuits_tpu/hash/poseidon2_pallas.py:71",
        "shape": list(shape),
        "launches": None,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound[0],
        "bound_by": bound[1],
        "library_ms": None,
    }


#: lanes per state of K1's two layouts: one thread per state, or the state
#: split over 4 lanes (one M4 group each)
_LANES = (1, 4)


@contextlib.contextmanager
def _lanes_forced(p2, lanes: int):
    """Every K1 entry point launches with ``lanes`` lanes per state while
    active, instead of the layout its wrapper picks from the batch size:
    to check and time both layouts at one shape."""
    saved = p2._lanes, p2._LEVEL_LANES
    p2._lanes, p2._LEVEL_LANES = (lambda states: lanes), lanes
    try:
        yield
    finally:
        p2._lanes, p2._LEVEL_LANES = saved


def _k1_times(p2, what: str, fn, reps: int, plain_fn, plain_reps: int, bound, chosen: int):
    """Time ``fn()`` with 1 and 4 lanes per state and the plain version; log
    them beside the bound; (ms at the lanes the wrapper picks by itself,
    ``chosen``, and plain ms)."""
    ms = {}
    for lanes in _LANES:
        with _lanes_forced(p2, lanes):
            ms[lanes] = _time_ms(fn, reps)
    plain_ms = _time_ms(plain_fn, plain_reps, warmup=1)
    _log(f"{what}: " + ", ".join(f"{n} lanes {t:.6f} ms" for n, t in ms.items())
         + f" (the wrapper picks {chosen}); plain {plain_ms:.6f} ms; bound {bound[0]:.6f} ms "
         f"({bound[1]}); share of the bound reached: "
         + ", ".join(f"{n} lanes {bound[0] / t:.4f}" for n, t in ms.items()))
    return ms[chosen], plain_ms


def phase_poseidon2(p2):
    """K1a vs its plain version; returns the kernel record (launches filled later)."""
    P = p2.bb.P
    rng = np.random.default_rng(SEED)
    host = rng.integers(0, P, (1 << 20, 16), dtype=np.int64)
    host = np.concatenate([host, np.zeros((1, 16), np.int64), np.full((1, 16), P - 1, np.int64)])
    x = torch.as_tensor(host, device="cuda")
    plain = p2.permute_plain(x)
    k1_err = 0
    for lanes in _LANES:
        with _lanes_forced(p2, lanes):
            out = p2.poseidon2_permute(x)
        k1_err = max(k1_err, int((out - plain).abs().max()))
        if k1_err:
            raise AssertionError(f"K1a ({lanes} lanes) disagrees with permute_plain on 2^20+2 states")
    out_h = out.cpu().numpy()
    for i in list(range(14)) + [len(host) - 2, len(host) - 1]:
        if out_h[i].tolist() != p2.s_permute(host[i].tolist()):
            raise AssertionError(f"K1a disagrees with s_permute on row {i}")
    _log("K1a permute: bit-equal to permute_plain on 2^20+2 states with 1 and 4 lanes; "
         "16 rows equal s_permute")

    rows = {}
    for n, reps in ((1, 200), (1 << 13, 200), (1 << 16, 100), (1 << 20, 20)):
        xs = x[:n].contiguous()
        if not torch.equal(p2.poseidon2_permute(xs), p2.permute_plain(xs)):
            raise AssertionError(f"K1a disagrees with permute_plain at N={n}")
        bound = k1_bound_ms(n, n * K1_BYTES_PER_PERM)
        rows[n] = _k1_times(p2, f"K1a permute N={n}", lambda: p2.poseidon2_permute(xs), reps,
                            lambda: p2.permute_plain(xs), max(2, reps // 20), bound,
                            p2._lanes(n)) + (bound,)
    # the record carries the prover's shape: one state per duplex
    ms, plain_ms, bound = rows[1]
    return _k1_record("poseidon2_permute", (1, 16), k1_err, ms, plain_ms, bound)


def phase_sponge(p2):
    """K1b, the leaf sponge, at the prover's matrix shapes: the curve fault's
    trace LDE (2^14 x 4314), the SHA-256 table's (2^12 x 336) and the
    stream table's (2^14 x 32); also on strided views."""
    rng = np.random.default_rng(SEED + 4)
    err, rec = 0, None
    for n, w, reps in ((1 << 14, 4314, 10), (1 << 12, 336, 50), (1 << 14, 32, 100)):
        m = torch.as_tensor(rng.integers(0, p2.bb.P, (n, w)), device="cuda")
        plain = p2.hash_rows_plain(m)
        padded = torch.empty((n, w + 3), dtype=torch.int64, device="cuda")
        padded[:, 3:] = m
        views = [m, padded[:, 3:]]  # row stride w + 3
        if w < 1000:
            views.append(m.t().contiguous().t())  # column-major: row stride 1
        for view in views:
            for lanes in _LANES:
                with _lanes_forced(p2, lanes):
                    got = p2.poseidon2_hash_rows(view)
                err = max(err, int((got - plain).abs().max()))
                if err:
                    raise AssertionError(f"K1b ({lanes} lanes, strides {view.stride()}) disagrees "
                                         f"with hash_rows_plain at {n} x {w}")
        del padded, views
        out = torch.empty((n, 8), dtype=torch.int64, device="cuda")
        bound = k1_bound_ms(n * -(-w // 8), n * (w + 8) * 8)
        ms, plain_ms = _k1_times(
            p2, f"K1b hash_rows {n} x {w} ({n * -(-w // 8)} permutations)",
            lambda: p2.poseidon2_hash_rows(m, out), reps,
            lambda: p2.hash_rows_plain(m), 2, bound, p2._lanes(n))
        if rec is None:  # the record carries the trace LDE's shape
            rec = ((n, w), ms, plain_ms, bound)
        del m, plain, out
    _log("K1b hash_rows: bit-equal to hash_rows_plain at every shape and stride, 1 and 4 lanes")
    shape, ms, plain_ms, bound = rec
    return _k1_record("poseidon2_hash_rows", shape, err, ms, plain_ms, bound)


def phase_levels(p2):
    """K1c, the Merkle levels of the curve fault's trace tree (2^14 leaves)."""
    n = 1 << 14
    rng = np.random.default_rng(SEED + 5)
    buf = torch.empty((2 * n - 1, 8), dtype=torch.int64, device="cuda")
    buf[:n] = torch.as_tensor(rng.integers(0, p2.bb.P, (n, 8)), device="cuda")
    want = buf.clone()
    p2.merkle_levels_plain(want, n)
    err = 0
    for lanes in _LANES:
        buf[n:] = 0
        with _lanes_forced(p2, lanes):
            p2.poseidon2_merkle_levels(buf, n)
        err = max(err, int((buf - want).abs().max()))
        if err:
            raise AssertionError(f"K1c ({lanes} lanes) disagrees with merkle_levels_plain")
    _log(f"K1c merkle_levels: bit-equal to merkle_levels_plain at {n} leaves, 1 and 4 lanes")
    bound = k1_bound_ms(n - 1, (2 * n - 1) * 8 * 8)
    ms, plain_ms = _k1_times(
        p2, f"K1c merkle_levels {n} leaves ({n - 1} permutations)",
        lambda: p2.poseidon2_merkle_levels(buf, n), 50,
        lambda: p2.merkle_levels_plain(want, n), 5, bound, p2._LEVEL_LANES)
    return _k1_record("poseidon2_merkle_levels", (n, 8), err, ms, plain_ms, bound)


def phase_grind(p2):
    """K1d, one batch of the proof-of-work search at the prover's shape
    (2^16 candidates, 16 bits), at pending positions 0, 3 and 7."""
    count, bits = 1 << 16, 16
    rng = np.random.default_rng(SEED + 6)
    base = torch.as_tensor(rng.integers(0, p2.bb.P, 16), device="cuda")
    for pos in (0, 3, 7):
        want = p2.grind_plain(base, pos, bits, 0, count)
        for lanes in _LANES:
            with _lanes_forced(p2, lanes):
                got = p2.poseidon2_grind(base, pos, bits, 0, count)
            if got != want:
                raise AssertionError(f"K1d ({lanes} lanes) found {got}, grind_plain {want} "
                                     f"(pending position {pos})")
        _log(f"K1d grind: pending position {pos}: lowest witness {want} with 1 and 4 lanes "
             f"and in grind_plain")
    bound = k1_bound_ms(count, 16 * 8 + 8)
    ms, plain_ms = _k1_times(
        p2, f"K1d grind {count} candidates (launch and 8-byte read)",
        lambda: p2.poseidon2_grind(base, 0, bits, 0, count), 50,
        lambda: p2.grind_plain(base, 0, bits, 0, count), 5, bound, p2._lanes(count))
    return _k1_record("poseidon2_grind", (count, 16), 0, ms, plain_ms, bound)


def _k2_record(name: str, shape, err: int, ms: float, plain_ms: float, bound) -> dict:
    return {
        "name": name,
        "route": "cuda",
        "source": "dvt_circuits_tpu_torch/csrc/keccak.cu",
        "replaces": "dvt_circuits_tpu/hash/keccak.py:105",
        "shape": list(shape),
        "launches": None,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound[0],
        "bound_by": bound[1],
        "library_ms": None,
    }


def k2_bound_ms(perms: int, absorbed_blocks: int, bytes_moved: int):
    """K2's and K2b's bound: ``perms`` permutations of Keccak-f's own work and
    ``absorbed_blocks`` rate-block absorbs."""
    return _bound_ms(1, (perms * K2_INSTR + absorbed_blocks * K2B_ABSORB_INSTR, 0), bytes_moved)


def _host_us_per_call(fn, calls: int) -> float:
    """Host time per call of ``fn`` (perf_counter over ``calls`` calls,
    synchronized once after them): what the wrapper costs the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host_us


#: ``CUgraphNodeType`` of a kernel node (CUDA driver API)
_CU_GRAPH_NODE_TYPE_KERNEL = 0


def _graph_node_types(graph) -> list:
    """The node types of a captured CUDA graph (``keep_graph=True``), read
    through the driver API."""
    import ctypes

    cuda = ctypes.CDLL("libcuda.so.1")
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(g, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cuda.cuGraphGetNodes(g, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    types = []
    for node in nodes:
        t = ctypes.c_int(-1)
        if cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        types.append(t.value)
    return types


def _graph_device_us(fn, calls: int) -> float:
    """Device time per call of ``fn``, a call that must launch exactly one
    kernel and nothing else: ``calls`` calls captured in one CUDA graph
    (checked to hold ``calls`` kernel nodes and no other node), the graph
    replayed between CUDA events, µs per call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    types = _graph_node_types(graph)
    if types != [_CU_GRAPH_NODE_TYPE_KERNEL] * calls:
        kinds = {t: types.count(t) for t in set(types)}
        raise AssertionError(f"{calls} calls captured {len(types)} graph nodes by type {kinds}, "
                             f"not {calls} kernel nodes")
    graph.instantiate()
    return _time_ms(graph.replay, 20, warmup=2) / calls * 1e3


def _k2_old_call(kk, state):
    """K2 through its launch path before the redesign: a
    ``torch.cuda.Stream`` object built per call and an unconditional
    ``.contiguous()``."""
    from dvt_circuits_tpu_torch import kernels

    state = state.contiguous()
    out = torch.empty_like(state)
    kernels.check(kk._entry_points()[0](state.data_ptr(), out.data_ptr(), state.shape[0],
                                        torch.cuda.current_stream(state.device).cuda_stream),
                  "keccak kernel launch")
    return out


def _fingerprint_old(kk, messages) -> list:
    """Keccak-256 as the fingerprint ran before K2b: the padded blocks
    widened to 25 lanes, a zero state, then per block one XOR and one K2
    launch (K2 as it was, ``_k2_old_call``), and the digest lanes sliced
    and copied back."""
    packed = kk._pack(messages, 0x01)
    full = np.zeros(packed.shape[:2] + (25,), dtype=np.int64)
    full[..., : kk.RATE_LANES] = packed
    blocks = torch.as_tensor(full, device="cuda")
    state = torch.zeros((len(messages), 25), dtype=torch.int64, device="cuda")
    for blk in blocks:
        state = _k2_old_call(kk, state ^ blk)
    return [row.tobytes() for row in state[:, :4].cpu().numpy().astype("<i8")]


#: the batch K2's only path runs (``phase_keccak_f_path``)
K2_PATH_STATES = 1 << 18


def phase_keccak(kk, floor_ms: float):
    """K2 (the permutation) and K2b (the sponge): each bit-equal to its plain
    version; where a one-state call's time goes (the kernel's device time
    from a CUDA-graph replay, the wrapper's host time, and the fingerprint
    as the CLI runs it); K2 through its old launch path against the new one,
    and the fingerprint before and after K2b, in turns, with each one's
    share of the bound with the launch floor.  Returns (K2 record at the
    batch of its path, K2b record at the fingerprint's one message)."""
    rng = np.random.default_rng(SEED + 1)
    y = torch.as_tensor(rng.integers(-(1 << 63), (1 << 63) - 1, (K2_PATH_STATES, 25),
                                     dtype=np.int64), device="cuda")
    y_plain = kk.keccak_f1600_plain(y)
    k2_err = _max_abs_err_u64(kk.keccak_f1600(y), y_plain)
    if k2_err:
        raise AssertionError("K2 disagrees with keccak_f1600_plain on 2^18 states")
    # K2b at the fingerprint's shape (one message, one block) and at 2^12
    # messages of 1 and 3 blocks
    k2b_err = 0
    sponge_in = {}
    for n_blocks, n in ((1, 1), (1, 1 << 12), (3, 1 << 12)):
        blocks = torch.as_tensor(rng.integers(-(1 << 63), (1 << 63) - 1, (n_blocks, n, 17),
                                              dtype=np.int64), device="cuda")
        k2b_err = max(k2b_err, _max_abs_err_u64(kk.keccak_sponge(blocks),
                                                kk.keccak_sponge_plain(blocks)))
        if k2b_err:
            raise AssertionError(f"K2b disagrees with keccak_sponge_plain at {n_blocks} x {n}")
        sponge_in[n_blocks, n] = blocks
    known = {
        b"": "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470",
        b"abc": "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45",
    }
    for msg, hexd in known.items():
        if kk.keccak256_batch([msg])[0].hex() != hexd:
            raise AssertionError(f"Keccak-256({msg!r}) wrong")
    msgs = [bytes(rng.integers(0, 256, 200, dtype=np.uint8)) for _ in range(8)]
    if kk.sha3_256_batch(msgs) != [hashlib.sha3_256(m).digest() for m in msgs]:
        raise AssertionError("SHA3-256 batch disagrees with hashlib")
    digest = [hashlib.sha256(b"dvt-chip-smoke/artifact").digest()]
    if _fingerprint_old(kk, digest) != kk.keccak256_batch(digest):
        raise AssertionError("the fingerprint before K2b differs from the one through K2b")
    _log("K2 keccak_f1600: bit-equal to keccak_f1600_plain on 2^18 states; K2b keccak_sponge: "
         "bit-equal to keccak_sponge_plain at 1 x 1, 1 x 2^12 and 3 x 2^12 (blocks x messages); "
         "known digests match")

    one = y[:1].contiguous()
    blocks1 = sponge_in[1, 1]
    bound_one = k2_bound_ms(1, 0, K2_BYTES_PER_PERM)
    bound_msg = k2_bound_ms(1, 1, K2B_BYTES_PER_BLOCK + K2B_BYTES_PER_DIGEST)
    kernel_calls = {"K2 one state": (lambda: kk.keccak_f1600(one), bound_one),
                    "K2b one message of one block": (lambda: kk.keccak_sponge(blocks1),
                                                     bound_msg)}
    fingerprint = "fingerprint keccak256_batch([32 bytes])"
    calls = {**kernel_calls, fingerprint: (lambda: kk.keccak256_batch(digest), bound_msg)}
    # K2 as it was, and the fingerprint's per-block route before K2b
    olds = {"K2 one state": lambda: _k2_old_call(kk, one),
            fingerprint: lambda: _fingerprint_old(kk, digest)}

    # every CUDA-event and host-clock time before the profile at the end: in
    # one run on the H100 the launches after a profiler session ran slower
    # (one-state K2 from 17.9 to 24 us a call)
    ms, host_us, old_new_ms = {}, {}, {}
    for what, (fn, _) in calls.items():
        ms[what] = _time_ms(fn, 500, warmup=20)
        host_us[what] = _host_us_per_call(fn, 500)
    device_us = {what: _graph_device_us(fn, 200) for what, (fn, _) in kernel_calls.items()}
    # old against new, in turns (old, new, new, old)
    for what, old in olds.items():
        t = {"old": [], "new": []}
        for label in ("old", "new", "new", "old"):
            t[label].append(_time_ms(old if label == "old" else calls[what][0], 500, warmup=20))
        old_new_ms[what] = (sum(t["old"]) / 2, sum(t["new"]) / 2)
    k2_ms = _time_ms(lambda: kk.keccak_f1600(y), 20)
    sponge_ms = {key: _time_ms(lambda: kk.keccak_sponge(blocks), 200 if key[1] == 1 else 50)
                 for key, blocks in sponge_in.items()}

    for what, (_, bound) in calls.items():
        fb = max(bound[0], floor_ms)
        device = (f"device {device_us[what]:.3f} us a launch (CUDA graph of 200 calls, one "
                  f"kernel node each), device share of the call "
                  f"{device_us[what] / (ms[what] * 1e3):.4f}" if what in device_us
                  else "device: the K2b launch above plus two copies")
        _log(f"{what}: {ms[what] * 1e3:.3f} us a call (CUDA events, back to back); host "
             f"{host_us[what]:.3f} us a call (perf_counter); {device}; bound "
             f"{bound[0] * 1e3:.6f} us ({bound[1]}), with the launch floor {fb * 1e3:.3f} us: "
             f"share {fb / ms[what]:.4f}")
    for what, old in olds.items():
        new, bound = calls[what]
        old_events, new_events = (_cuda_launches(fn)[1] for fn in (old, new))
        old_t, new_t = old_new_ms[what]
        fb = max(bound[0], floor_ms)
        _log(f"{what}, old design against new (old, new, new, old): old {old_t * 1e3:.3f} us "
             f"in {old_events} device events, new {new_t * 1e3:.3f} us in {new_events} "
             f"(profiler, one call each); share of the bound with the launch floor "
             f"({fb * 1e3:.3f} us): old {fb / old_t:.4f}, new {fb / new_t:.4f}")

    n = K2_PATH_STATES
    k2_plain_ms = _time_ms(lambda: kk.keccak_f1600_plain(y), 2, warmup=1)
    bound = k2_bound_ms(n, 0, n * K2_BYTES_PER_PERM)
    _log(f"K2 N=2^18 (the keccak-f path's batch): kernel {k2_ms:.6f} ms, plain "
         f"{k2_plain_ms:.6f} ms, bound {bound[0]:.9f} ms ({bound[1]})")
    k2 = _k2_record("keccak_f1600", (n, 25), k2_err, k2_ms, k2_plain_ms, bound)
    k2b = None
    for (n_blocks, n), t in sponge_ms.items():
        blocks = sponge_in[n_blocks, n]
        plain_ms = _time_ms(lambda: kk.keccak_sponge_plain(blocks), 3, warmup=1)
        bound = k2_bound_ms(n * n_blocks, n * n_blocks,
                            n * (n_blocks * K2B_BYTES_PER_BLOCK + K2B_BYTES_PER_DIGEST))
        _log(f"K2b {n_blocks} x {n:>5} (blocks x messages): kernel {t:.6f} ms, plain "
             f"{plain_ms:.6f} ms, bound {bound[0]:.9f} ms ({bound[1]})")
        if k2b is None:  # the fingerprint's shape: one message of one block
            k2b = _k2_record("keccak_sponge", (n_blocks, n, 17), k2b_err, t, plain_ms, bound)
    return k2, k2b


def phase_keccak_f_path(kk) -> dict:
    """The permutation's own entry point, ``keccak_f1600``, as its caller in
    the reference uses it (``bench.py``'s keccak section: one batch of 2^18
    states): K2 is on no prove or verify path since K2b took the CLI's
    fingerprint.  Launch counts reset just before, read just after; 16 rows
    checked against the plain version on the CPU."""
    rng = np.random.default_rng(SEED + 8)
    states = rng.integers(-(1 << 63), (1 << 63) - 1, (K2_PATH_STATES, 25), dtype=np.int64)
    x = torch.as_tensor(states, device="cuda")
    _reset_counts()
    t0 = time.perf_counter()
    out = kk.keccak_f1600(x)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = _read_counts("keccak-f", ("keccak_f1600",))
    want = kk.keccak_f1600_plain(torch.as_tensor(states[:16]))
    if out.shape != x.shape or not torch.equal(out[:16].cpu(), want):
        raise AssertionError("keccak_f1600 on 2^18 states: wrong shape or rows")
    _log(f"keccak-f path: 2^18 permutations in {wall_ms:.3f} ms (host clock), 16 rows equal "
         f"the plain version")
    return launches


def phase_mulchain(pv, work):
    """K3 vs its plain version, its time and IMAD rate at the probe's shape."""
    rng = np.random.default_rng(SEED + 2)
    n = 1 << 18
    host = rng.integers(0, 1 << 32, (16, n), dtype=np.int64)
    edges = np.array([[0], [1], [(1 << 32) - 1]], dtype=np.int64).repeat(n, axis=1)
    x_all = torch.as_tensor(np.concatenate([host, edges]), device="cuda")
    k3_err = int((pv.mulchain(x_all) - pv.mulchain_plain(x_all)).abs().max())
    if k3_err:
        raise AssertionError("K3 disagrees with mulchain_plain on (16 + 3, 2^18)")
    _log("K3 mulchain: bit-equal to mulchain_plain on (16, 2^18) plus rows of 0, 1, 2^32-1")
    x = x_all[:16].contiguous()
    ms = _time_ms(lambda: pv.mulchain(x), 50)
    plain_ms = _time_ms(lambda: pv.mulchain_plain(x), 2, warmup=1)
    bound, by = _bound_ms(x.numel(), work, x.numel() * K3_BYTES_PER_ELEM)
    imad_per_s = x.numel() * pv.CHAIN / ms * 1e3
    _log(f"K3 (16, 2^18): kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, bound {bound:.6f} ms "
         f"({by}); {imad_per_s:.4e} IMAD/s = {imad_per_s / _INT32_OPS_PER_S:.4f} of "
         f"_INT32_OPS_PER_S, {imad_per_s / _IMAD_PER_S:.4f} of _IMAD_PER_S")
    return {
        "name": "mulchain",
        "route": "cuda",
        "source": "dvt_circuits_tpu_torch/csrc/mulchain.cu",
        "replaces": "scripts/probe_vpu.py:21",
        "shape": [16, n],
        "launches": None,
        "max_abs_err": k3_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
    }


def _bad_share_scenario():
    """Seed exchange 0 → 1 of a 7-of-10 committee whose dst_base_hash is
    outside the committee, re-hashed and re-signed (auth mode): the guest
    slashes at the destination lookup, before the curve check."""
    from dvt_circuits_tpu_torch.dkg.keys import BlsDkgWithSecp256kCommitment as Setup
    from dvt_circuits_tpu_torch.dkg.scenario_gen import DkgCommittee
    from dvt_circuits_tpu_torch.dkg.types import SHA256Raw
    from dvt_circuits_tpu_torch.dkg.verification import compute_seed_exchange_hash

    com = DkgCommittee(10, 7)
    data = com.shared_data(0, 1, True)
    sec = data.seeds_exchange_commitment
    sec.shared_secret.dst_base_hash = SHA256Raw(
        hashlib.sha256(b"dvt-chip-smoke/outsider").digest()
    )
    h = compute_seed_exchange_hash(Setup, sec)
    sec.commitment.hash = h
    sec.commitment.signature = com.secp_keys[0].sign(bytes(h)).to_bytes()
    return data


def _check_openings(proof: dict, n_checked: int = 4) -> None:
    """Re-hash a few outer openings with the scalar permutation and walk
    them to the committed roots (an independent check of the trees)."""
    from dvt_circuits_tpu_torch.pcs.merkle import verify_opening
    from dvt_circuits_tpu_torch.utils.packing import unpack_u32

    n_lde = 1 << proof["fri"]["log_n"]
    for q, op in list(zip(proof["fri"]["queries"], proof["query_openings"]))[:n_checked]:
        for name in ("t", "q", "p"):
            if name not in op:
                continue
            for side, index in (("lo", q["index"]), ("hi", q["index"] + n_lde // 2)):
                row = unpack_u32(op[name][side]["row"])
                path = unpack_u32(op[name][side]["path"]).reshape(-1, 8)
                if not verify_opening(proof[f"root_{name}"], index, row, path):
                    raise AssertionError(f"opening of {name} at {index} misses root_{name}")


def _log_profile(prof, wall_s: float) -> None:
    """Device-busy share and the top kernels by device time of one profiled
    warm prove (one stream, so kernel times do not overlap)."""
    from torch.autograd import DeviceType

    kernels = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    busy_ms = sum(ev.device_time_total for ev in kernels) / 1e3
    launches = sum(ev.count for ev in kernels)
    _log(f"profiled warm prove: wall {wall_s * 1e3:.3f} ms (profiler on), {launches} kernel "
         f"launches, device busy {busy_ms:.3f} ms, idle share {1 - busy_ms / (wall_s * 1e3):.4f}")
    for ev in sorted(kernels, key=lambda e: -e.device_time_total)[:10]:
        _log(f"  device {ev.device_time_total / 1e3:9.3f} ms  calls {ev.count:6d}  {ev.key[:90]}")


def _wrappers() -> dict:
    """Every kernel wrapper by record name; each counts its launches."""
    from dvt_circuits_tpu_torch import probe_vpu
    from dvt_circuits_tpu_torch.curve import fp, g1, g2
    from dvt_circuits_tpu_torch.hash import keccak, poseidon2

    return {"poseidon2_permute": poseidon2.poseidon2_permute,
            "poseidon2_hash_rows": poseidon2.poseidon2_hash_rows,
            "poseidon2_merkle_levels": poseidon2.poseidon2_merkle_levels,
            "poseidon2_grind": poseidon2.poseidon2_grind,
            "keccak_f1600": keccak.keccak_f1600,
            "keccak_sponge": keccak.keccak_sponge,
            "mulchain": probe_vpu.mulchain,
            "fp_mont_mul": fp.mont_mul,
            "g1_msm_windowed": g1.msm_jacobian,
            "g1_msm_bucket": g1.msm_bucket_jacobian,
            # C3's four stages, each counted where it launches
            **g1.stage_counts,
            "g2_scalar_mul": g2.scalar_mul}


class _TreeCount:
    """Counts, while active, the Merkle trees committed (each ``MerkleTree``,
    a sharded prover's subtree too, since ``ShardedTree`` is one; each
    ``merkle_root`` and ``build_levels`` call, through whichever module
    holds the name) and the batched opening checks
    (``verify_openings_batch``).  ``check`` then holds the leaf sponge to one
    launch for each of them: a tree that took more or none, or rows hashed
    by another route, fail the run."""

    def __enter__(self):
        from dvt_circuits_tpu_torch.parallel import dist_stark, ep_tables  # noqa: F401
        from dvt_circuits_tpu_torch.pcs import fri, merkle  # noqa: F401  (holders of the names)
        from dvt_circuits_tpu_torch.stark import prover, verifier  # noqa: F401

        self.trees = self.batches = 0
        targets = [(merkle.MerkleTree, "__init__", "trees")]
        counted = {id(merkle.merkle_root): "trees", id(merkle.build_levels): "trees",
                   id(merkle.verify_openings_batch): "batches"}
        for name, mod in list(sys.modules.items()):
            if name.startswith("dvt_circuits_tpu_torch."):
                targets += [(mod, attr, counted[id(value)])
                            for attr, value in list(vars(mod).items()) if id(value) in counted]
        self._saved = [(holder, attr, getattr(holder, attr)) for holder, attr, _ in targets]
        for (holder, attr, what), (_, _, fn) in zip(targets, self._saved):
            setattr(holder, attr, self._counting(fn, what))
        from dvt_circuits_tpu_torch.hash.poseidon2 import poseidon2_hash_rows

        self._sponge, self._before = poseidon2_hash_rows, poseidon2_hash_rows.launches
        return self

    def _counting(self, fn, what: str):
        def counted(*args, **kwargs):
            setattr(self, what, getattr(self, what) + 1)
            return fn(*args, **kwargs)

        return counted

    def __exit__(self, *exc):
        for holder, attr, value in self._saved:
            setattr(holder, attr, value)
        return False

    def check(self, path: str) -> None:
        launches = self._sponge.launches - self._before
        _log(f"{path}: {self.trees} Merkle trees committed, {self.batches} batched opening "
             f"checks, {launches} leaf-sponge launches")
        if self.trees == 0 or launches != self.trees + self.batches:
            raise AssertionError(f"{path}: {launches} leaf-sponge launches for {self.trees} trees "
                                 f"and {self.batches} opening batches (one each expected)")


def _reset_counts() -> None:
    torch.cuda.synchronize()
    for fn in _wrappers().values():
        fn.launches = 0


#: the K1 entry points every prove launches, and every verify
_K1_PROVE = ("poseidon2_permute", "poseidon2_hash_rows", "poseidon2_merkle_levels",
             "poseidon2_grind")
_K1_VERIFY = ("poseidon2_permute", "poseidon2_hash_rows", "poseidon2_merkle_levels")


def _read_counts(path: str, expected) -> dict:
    """The launch counts of the path just driven; fails if a kernel the path
    runs was not launched."""
    torch.cuda.synchronize()
    counts = {name: fn.launches for name, fn in _wrappers().items()}
    k1 = sum(v for k, v in counts.items() if k.startswith("poseidon2_"))
    _log(f"launches on path {path!r}: {counts}; K1 in all: {k1}")
    for name in expected:
        if counts[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on path {path!r}")
    return counts


def phase_main_path(p2, kk, tmp: Path):
    from dvt_circuits_tpu_torch import cli
    from dvt_circuits_tpu_torch.prover.pipeline import container_digest, prove_circuit, save_proof
    from dvt_circuits_tpu_torch.stark.config import DEFAULT_CONFIG

    data = _bad_share_scenario()

    # -- the measured run: counts reset just before, read just after -------
    _reset_counts()
    with _TreeCount() as trees:
        t0 = time.perf_counter()
        container = prove_circuit("bad-share", data, True, DEFAULT_CONFIG, device="cuda")
        proof_path = tmp / "proof.bin"
        save_proof(container, str(proof_path))
        fingerprint = cli._artifact_fingerprint(str(proof_path), device="cuda")
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
    launches = _read_counts("bad-share pre-curve", _K1_PROVE + ("keccak_sponge",))
    if launches["keccak_sponge"] != 1:
        raise AssertionError(f"the fingerprint took {launches['keccak_sponge']} K2b launches")
    trees.check("bad-share pre-curve")
    _log(f"main path (cold): prove+save+fingerprint {cold_s:.3f} s, timing {container['timing']}")

    tables = [("stream", container["stark"])] + [
        (g["kind"], g["proof"]) for g in container["gadgets"]
    ]
    for name, proof in tables:
        _log(f"table {name}: rows 2^{proof['log_n']}, width {proof['width']}, "
             f"LDE 2^{proof['fri']['log_n']}, constraints {proof['constraint_count']}")
    if [t[0] for t in tables] != ["stream", "sha256"] or container["g1_omitted"]:
        raise AssertionError("unexpected table set for the pre-curve bad-share fault")
    if container["stark"]["log_n"] != 11 or container["gadgets"][0]["proof"]["log_n"] != 10:
        raise AssertionError("table heights differ from the JAX package's for this input")
    for _, proof in tables:
        _check_openings(proof)
    _log("Merkle openings re-hashed with s_permute reach their roots")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = prove_circuit("bad-share", data, True, DEFAULT_CONFIG, device="cuda")
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    _log(f"main path (warm): prove {warm_s:.3f} s, timing {warm['timing']}")
    if container_digest(warm) != container_digest(container):
        raise AssertionError("warm GPU container differs from the cold one")

    from torch.profiler import ProfilerActivity, profile

    # device activity only: host-op events would double the trace
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prove_circuit("bad-share", data, True, DEFAULT_CONFIG, device="cuda")
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    _log_profile(prof, prof_s)

    t0 = time.perf_counter()
    cpu = prove_circuit("bad-share", data, True, DEFAULT_CONFIG, device="cpu")
    cpu_s = time.perf_counter() - t0
    gpu_digest, cpu_digest = container_digest(container), container_digest(cpu)
    _log(f"CPU plain path: prove {cpu_s:.3f} s; container sha256 without timing: "
         f"gpu {gpu_digest} cpu {cpu_digest}")
    if gpu_digest != cpu_digest:
        raise AssertionError("GPU container differs from the CPU (plain) container")

    plain_fp = kk.keccak256_batch(
        [hashlib.sha256(proof_path.read_bytes()).digest()], device="cpu"
    )[0].hex()
    if fingerprint != plain_fp:
        raise AssertionError("K2b fingerprint differs from the plain Keccak")

    return launches


def phase_probe_path() -> dict:
    """The probe entry point: in-process (K3's launches), then as a user
    runs it, a subprocess that must exit 0."""
    from dvt_circuits_tpu_torch import probe_vpu

    _reset_counts()
    probe_vpu.main()
    launches = _read_counts("probe", ("mulchain",))
    res = subprocess.run([sys.executable, "-m", "dvt_circuits_tpu_torch.probe_vpu"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise AssertionError(f"probe exited {res.returncode}:\n{res.stdout}\n{res.stderr}")
    _log(f"probe subprocess: exit 0; {res.stdout.strip()}")
    return launches


def _check_chains(gadget: dict) -> None:
    """Every chain's proven result equals the host scalar-mul of its public
    operand by its public scalar."""
    from dvt_circuits_tpu_torch.hostcrypto.bls12_381 import g1_mul
    from dvt_circuits_tpu_torch.stark.g1mul_air import G1MulAir

    air = G1MulAir(tuple(gadget["block_counts"]))
    publics = [int(v) for v in gadget["proof"]["public_values"]]
    for c in range(len(air.chain_bits)):
        scalar = int.from_bytes(air.scalar_bytes_of(publics, c), "big")
        want = g1_mul(air.operand_of(publics, c), scalar)
        inf, x, y = air.result_of(publics, c)
        if (inf, None if inf else (x, y)) != (int(want is None), want):
            raise AssertionError(f"chain {c}: result differs from g1_mul(operand, scalar)")


def _log_tables(container: dict) -> list:
    tables = [("stream", container["stark"])] + [
        (g["kind"], g["proof"]) for g in container["gadgets"]
    ]
    for name, proof in tables:
        _log(f"table {name}: rows 2^{proof['log_n']}, width {proof['width']}, "
             f"LDE 2^{proof['fri']['log_n']}, constraints {proof['constraint_count']}")
    return tables


@contextlib.contextmanager
def _phase_memory(targets=None):
    """While active, each phase of ``stark.prover.prove`` (LDE, commit, a
    tree's batched openings, quotient, openings, DEEP, FRI), or each
    (holder, name) of ``targets``, is timed on the host clock between two
    synchronizes and followed by the device memory allocated and the peak so
    far; yields the list of (phase, shape of its first tensor argument, ms,
    allocated GiB, peak GiB)."""
    from dvt_circuits_tpu_torch.pcs.merkle import MerkleTree
    from dvt_circuits_tpu_torch.stark import prover as pr

    rows: list = []

    def wrap(name, fn):
        def timed(*args, **kwargs):
            tensors = [a.matrix if isinstance(a, MerkleTree) else a for a in args]
            shape = next((tuple(a.shape) for a in tensors if isinstance(a, torch.Tensor)), None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            rows.append((name, shape, (time.perf_counter() - t0) * 1e3,
                         torch.cuda.memory_allocated() / 2**30,
                         torch.cuda.max_memory_allocated() / 2**30))
            return out

        return timed

    if targets is None:
        targets = [(pr, name) for name in ("lde_body", "MerkleTree", "quotient_body",
                                           "openings_body", "deep_body", "fri_prove")]
        targets.append((MerkleTree, "open_many"))
    saved = [(holder, name, getattr(holder, name)) for holder, name in targets]
    for holder, name, fn in saved:
        setattr(holder, name, wrap(name, fn))
    torch.cuda.reset_peak_memory_stats()
    try:
        yield rows
    finally:
        for holder, name, fn in saved:
            setattr(holder, name, fn)


def _log_phase_memory(path: str, rows: list) -> float:
    """Logs each phase's row; returns the peak in GiB."""
    for name, shape, ms, alloc, peak in rows:
        _log(f"{path} phase {name} {shape}: {ms:.3f} ms, allocated after it {alloc:.3f} GiB, "
             f"peak so far {peak:.3f} GiB")
    peak = torch.cuda.max_memory_allocated() / 2**30
    _log(f"{path}: device memory peak {peak:.3f} GiB")
    return peak


def phase_curve_path(circuit: str, data, chain_bits, log_n: int, sig_checks: int,
                     profiled: bool = True) -> tuple:
    """One curve circuit at full width on the card: cold (launches counted)
    then warm with each prover phase's time and device memory, and (if
    ``profiled``) warm again and profiled; the chains, the openings and the
    port's own strict verifier on the card.  ``chain_bits`` None: the chain
    widths are logged, not held."""
    from dvt_circuits_tpu_torch.prover.pipeline import container_digest, prove_circuit, verify_proof
    from dvt_circuits_tpu_torch.stark.config import DEFAULT_CONFIG
    from torch.profiler import ProfilerActivity, profile

    _reset_counts()
    with _TreeCount() as trees:
        t0 = time.perf_counter()
        container = prove_circuit(circuit, data, True, DEFAULT_CONFIG, device="cuda")
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
    launches = _read_counts(f"{circuit} curve", _K1_PROVE)
    trees.check(f"{circuit} curve")
    _log(f"{circuit} (cold): prove {cold_s:.3f} s, timing {container['timing']}")
    tables = _log_tables(container)
    g1 = container["gadgets"][-1]
    _log(f"{circuit}: g1mul chains {g1['block_counts']}")
    if ([t[0] for t in tables] != ["stream", "sha256", "g1mul"] or container["g1_omitted"]
            or chain_bits not in (None, g1["block_counts"]) or g1["proof"]["log_n"] != log_n
            or g1["proof"]["width"] != 4314):
        raise AssertionError(f"unexpected tables for {circuit}: "
                             f"{[(t[0], t[1]['log_n'], t[1]['width']) for t in tables]}, "
                             f"chains {g1['block_counts']}, g1_omitted {container['g1_omitted']}")
    _check_chains(g1)
    for _, proof in tables:
        _check_openings(proof)
    _log(f"{circuit}: every chain equals g1_mul; openings re-hashed with s_permute reach their roots")

    with _phase_memory() as rows:
        t0 = time.perf_counter()
        warm = prove_circuit(circuit, data, True, DEFAULT_CONFIG, device="cuda")
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    _log(f"{circuit} (warm, phases synchronized): prove {warm_s:.3f} s, timing {warm['timing']}")
    _log_phase_memory(circuit, rows)
    if container_digest(warm) != container_digest(container):
        raise AssertionError(f"warm {circuit} container differs from the cold one")
    if profiled:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm = prove_circuit(circuit, data, True, DEFAULT_CONFIG, device="cuda")
        torch.cuda.synchronize()
        _log(f"{circuit} (warm): prove {time.perf_counter() - t0:.3f} s, timing {warm['timing']}")
        # device activity only: host-op events would double the trace
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            prove_circuit(circuit, data, True, DEFAULT_CONFIG, device="cuda")
            torch.cuda.synchronize()
            prof_s = time.perf_counter() - t0
        _log_profile(prof, prof_s)

    _reset_counts()
    with _TreeCount() as trees:
        t0 = time.perf_counter()
        res = verify_proof(container, circuit, strict=True, device="cuda")
        torch.cuda.synchronize()
        verify_s = time.perf_counter() - t0
    verify_launches = _read_counts(f"{circuit} verify", _K1_VERIFY)
    trees.check(f"{circuit} verify")
    _log(f"{circuit} verify on cuda: {res} in {verify_s:.3f} s")
    if (res.binding, res.g1_relations, res.sig_checks) != ("curve-bound+sig", 1, sig_checks):
        raise AssertionError(f"the port's verifier returned {res} for {circuit}")
    return container, launches, verify_launches


def _bad_encrypted_share(n: int, k: int):
    """Sender 0's share payload to receiver 1 of an n-participant, threshold-k
    committee, encrypted under the ECDH key of the guest's convention (the
    bytewise-largest base pubkey of each side; key = SHA-256 of the
    compressed ECDH point, nonce = its first 12 bytes).  The payload has the
    full auth layout of the guest's parser (178 bytes) but a wrong
    ``gen_id``, so the guest takes its only exit-0 path, a parse error."""
    from dvt_circuits_tpu_torch.dkg.keys import BlsDkgWithSecp256kCommitment as Setup
    from dvt_circuits_tpu_torch.dkg.keys import BlsSecretKey
    from dvt_circuits_tpu_torch.dkg.scenario_gen import DkgCommittee
    from dvt_circuits_tpu_torch.dkg.types import BadEncryptedShare
    from dvt_circuits_tpu_torch.hostcrypto.chacha20 import chacha20_xor

    com = DkgCommittee(n, k)
    sender_encr_pubkey = max(com.vvs[0], key=bytes)
    j = max(range(k), key=lambda i: bytes(com.vvs[1][i]))
    receiver_encr_seckey = BlsSecretKey(com.polys[1][j]).to_bytes()
    point = Setup.Point.from_bytes(bytes(sender_encr_pubkey)).mul_scalar(
        Setup.Scalar.from_bytes(receiver_encr_seckey))
    key = hashlib.sha256(bytes(point.to_bytes())).digest()
    sec = com.shared_data(0, 1, True).seeds_exchange_commitment
    payload = (hashlib.sha256(b"another generation").digest()[:16] + bytes([3])
               + bytes(sec.shared_secret.secret) + bytes(sec.commitment.hash)
               + bytes(sec.commitment.pubkey) + bytes(sec.commitment.signature))
    obj = {
        "sender_pubkey": bytes(com.secp_keys[0].to_public_key().to_bytes()).hex(),
        "sender_encr_pubkey": bytes(sender_encr_pubkey).hex(),
        "receiver_encr_seckey": bytes(receiver_encr_seckey).hex(),
        "encrypted_data": chacha20_xor(key, key[:12], payload).hex(),
        "settings": com.settings.to_json(),
        "base_hashes": [bytes(h).hex() for h in com.base_hashes],
        "sender_base_pubkeys": [bytes(p).hex() for p in com.vvs[0]],
        "receiver_base_pubkeys": [bytes(p).hex() for p in com.vvs[1]],
    }
    return BadEncryptedShare.from_json(obj, Setup.layout, True)


def _check_keystream(gadget: dict) -> None:
    """Every invocation's proven keystream is the host cipher's for its key
    and nonce from counter 0."""
    from dvt_circuits_tpu_torch.hostcrypto.chacha20 import chacha20_keystream
    from dvt_circuits_tpu_torch.stark.chacha20_air import init_from_publics, keystream_from_publics

    publics = [int(v) for v in gadget["proof"]["public_values"]]
    gb = 0
    for i, nb in enumerate(gadget["block_counts"]):
        key, ctr0, nonce = init_from_publics(publics, gb)
        ct_len = gadget["extras"][1 + 2 * i]
        ks = b"".join(keystream_from_publics(publics, gb + j) for j in range(nb))
        if ctr0 != 0 or nonce != key[:12] or ks[:ct_len] != chacha20_keystream(key, nonce, ct_len):
            raise AssertionError(f"invocation {i}: keystream differs from the host cipher's")
        gb += nb


def phase_encrypted_share(kk, tmp: Path) -> dict:
    """bad-encrypted-share 7-of-10 at full width on the card: cold (launches
    counted, the leaf sponge held to the trees), warm with each prover
    phase's time and device memory, warm again and profiled; the ChaCha20
    table's keystream against the host cipher, the openings, and the port's
    own strict verifier on the card; the CLI ``prove`` and ``verify
    --show-report`` in-process, each fingerprint one K2b launch; then the
    table's constraint quotient through both builders.  Returns the launch
    counts by path."""
    from dvt_circuits_tpu_torch import cli
    from dvt_circuits_tpu_torch.prover.pipeline import container_digest, prove_circuit, verify_proof
    from dvt_circuits_tpu_torch.stark.config import DEFAULT_CONFIG
    from torch.profiler import ProfilerActivity, profile

    circuit = "bad-encrypted-share"
    data = _bad_encrypted_share(10, 7)
    by_path = {}
    _reset_counts()
    with _TreeCount() as trees:
        t0 = time.perf_counter()
        container = prove_circuit(circuit, data, True, DEFAULT_CONFIG, device="cuda")
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
    by_path[circuit] = _read_counts(circuit, _K1_PROVE)
    trees.check(circuit)
    _log(f"{circuit} (cold): prove {cold_s:.3f} s, timing {container['timing']}")
    tables = _log_tables(container)
    g = container["gadgets"][-1]
    _log(f"{circuit}: chacha20 invocations {g['block_counts']}, extras {g['extras']}, "
         f"stream offsets {g['stream_offsets']}")
    if ([t[0] for t in tables] != ["stream", "sha256", "chacha20"] or container["chacha_omitted"]
            or g["block_counts"] != [3] or g["extras"][:2] != [4, 178]
            or g["proof"]["log_n"] != 7 or g["proof"]["width"] != 1080
            or g["stream_offsets"][0] is None):
        raise AssertionError(f"unexpected tables for {circuit}: "
                             f"{[(t[0], t[1]['log_n'], t[1]['width']) for t in tables]}, "
                             f"chacha {g['block_counts']} {g.get('extras')}, "
                             f"omitted {container['chacha_omitted']}")
    _check_keystream(g)
    for _, proof in tables:
        _check_openings(proof)
    _log(f"{circuit}: the keystream equals the host cipher's; openings re-hashed with s_permute "
         f"reach their roots")

    with _phase_memory() as rows:
        t0 = time.perf_counter()
        warm = prove_circuit(circuit, data, True, DEFAULT_CONFIG, device="cuda")
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    _log(f"{circuit} (warm, phases synchronized): prove {warm_s:.3f} s, timing {warm['timing']}")
    _log_phase_memory(circuit, rows)
    if container_digest(warm) != container_digest(container):
        raise AssertionError(f"warm {circuit} container differs from the cold one")
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm = prove_circuit(circuit, data, True, DEFAULT_CONFIG, device="cuda")
        torch.cuda.synchronize()
        _log(f"{circuit} (warm): prove {time.perf_counter() - t0:.3f} s, timing {warm['timing']}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prove_circuit(circuit, data, True, DEFAULT_CONFIG, device="cuda")
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    _log_profile(prof, prof_s)

    _reset_counts()
    with _TreeCount() as trees:
        t0 = time.perf_counter()
        res = verify_proof(container, circuit, strict=True, device="cuda")
        torch.cuda.synchronize()
        verify_s = time.perf_counter() - t0
    by_path[f"{circuit} verify"] = _read_counts(f"{circuit} verify", _K1_VERIFY)
    trees.check(f"{circuit} verify")
    _log(f"{circuit} verify on cuda: {res} in {verify_s:.3f} s")
    if (res.binding, res.g1_relations, res.g1_omitted) != ("hash-bound", 0, 0):
        raise AssertionError(f"the port's verifier returned {res} for {circuit}")

    scenario = tmp / "encrypted_scenario.json"
    scenario.write_text(json.dumps(data.to_json(True)))
    proof = tmp / "encrypted_proof.bin"
    for args in (["prove", "--type=" + circuit, "-i", str(scenario), "-o", str(proof)],
                 ["verify", "--type=" + circuit, "-i", str(proof), "--show-report"]):
        _reset_counts()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.run(["--auth-commitment"] + args)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = _read_counts(f"CLI {args[0]} {circuit}", _K1_VERIFY + ("keccak_sponge",))
        by_path[f"CLI {args[0]} {circuit}"] = counts
        expected = kk.keccak256_batch([hashlib.sha256(proof.read_bytes()).digest()],
                                      device="cpu")[0].hex()
        line = [ln for ln in out.getvalue().splitlines() if "keccak256: " in ln.lower()]
        if (rc != 0 or len(line) != 1 or line[0].split(": ", 1)[1] != expected
                or counts["keccak_sponge"] != 1 or counts["keccak_f1600"] != 0):
            raise AssertionError(f"CLI {args[0]} {circuit}: exit {rc}, fingerprint {line} vs "
                                 f"{expected}, K2b launches {counts['keccak_sponge']}, K2 "
                                 f"{counts['keccak_f1600']}:\n{out.getvalue()}")
        _log(f"CLI {args[0]} {circuit} (in-process): exit 0 in {wall_s:.3f} s; the fingerprint "
             f"took one K2b launch and equals the plain Keccak")
    phase_chacha_quotient([int(v) for v in g["proof"]["public_values"]])
    return by_path


def phase_chacha_quotient(publics: list) -> None:
    """The encrypted-share ChaCha20 table (its blocks re-derived from the
    proof's publics: 4 blocks, 2^7 x 1080, LDE 2^9 at ``DEFAULT_CONFIG``):
    its constraint quotient through ``eval_tensor`` (the prover's path) and
    through the generic ``eval``, bit-equal, each timed on the host clock
    between two synchronizes, with its launches."""
    from dvt_circuits_tpu_torch.field import babybear as bb
    from dvt_circuits_tpu_torch.field import ext
    from dvt_circuits_tpu_torch.stark import prover as pr
    from dvt_circuits_tpu_torch.stark.chacha20_air import (PUBLICS_PER_BLOCK, ChaCha20Air,
                                                           init_from_publics)
    from dvt_circuits_tpu_torch.stark.config import DEFAULT_CONFIG as cfg

    air = ChaCha20Air(len(publics) // PUBLICS_PER_BLOCK)
    trace, pubs = air.generate_trace([init_from_publics(publics, b)
                                      for b in range(air.num_blocks)])
    if pubs != publics:
        raise AssertionError("the ChaCha20 trace re-derived from the publics gives other publics")
    n = trace.shape[0]
    log_n = n.bit_length() - 1
    rng = np.random.default_rng(SEED + 7)
    alpha = tuple(int(v) for v in rng.integers(0, bb.P, ext.D))
    dev = torch.device("cuda")
    t_lde = pr.lde_body(torch.as_tensor(trace.astype(np.int64), device=dev), cfg)
    p_lde = pr.lde_body(torch.as_tensor(np.asarray(air.preprocessed_trace(n), dtype=np.int64),
                                        device=dev), cfg)
    tables = pr._domain_tables(log_n, cfg.log_blowup, cfg.shift, dev)
    args = (t_lde, p_lde, alpha, pubs, tables, log_n, cfg)
    times, results, launches = {}, {}, {}
    for name, which in (("eval_tensor", air), ("generic eval", _EvalOnly(air))):
        pr.quotient_body(which, *args)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[name] = pr.quotient_body(which, *args)
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        _, launches[name] = _cuda_launches(lambda: pr.quotient_body(which, *args))
    (q, qc, count), (gq, gqc, gcount) = results["eval_tensor"], results["generic eval"]
    if count != gcount or not (torch.equal(q, gq) and torch.equal(qc, gqc)):
        raise AssertionError("the ChaCha20 eval_tensor quotient differs from the generic eval's")
    _log(f"chacha20 constraint quotient on the card (2^{log_n} x {air.width}, LDE "
         f"2^{log_n + cfg.log_blowup}, {count} constraints): eval_tensor "
         f"{times['eval_tensor']:.3f} ms in {launches['eval_tensor']} launches; generic eval "
         f"{times['generic eval']:.3f} ms in {launches['generic eval']} launches; bit-equal")
    if launches["eval_tensor"] >= launches["generic eval"]:
        raise AssertionError("the ChaCha20 tensor quotient took no fewer launches than the "
                             "generic eval")


class _EvalOnly:
    """An AIR seen through its generic ``eval`` alone: ``quotient_body`` then
    takes the ``ProverBuilder`` route (the port's quotient before
    ``eval_tensor`` was ported)."""

    def __init__(self, air):
        self._air = air
        self.width = air.width
        self.preprocessed_width = air.preprocessed_width

    def eval(self, builder):
        self._air.eval(builder)


def _cuda_launches(fn):
    """(fn(), device kernels it launched), from a CUDA-only profile."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, sum(ev.count for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA)


#: the tensor quotient of the curve fault's g1mul table must stay below this
#: many launches (the generic eval's: 156,365)
_QUOTIENT_LAUNCH_LIMIT = 10_000


def phase_g1_breakdown() -> None:
    """Where the time of one g1mul table goes: the prover's phases at the
    curve fault's table shape (chains 256 + 6×32: 2^12 × 4314, LDE 2^14,
    ``DEFAULT_CONFIG``) on random chains from a numpy seed, each timed on
    the host clock between two synchronizes; the device memory peak.  The
    constraint quotient both ways in one run: through ``eval_tensor`` (the
    prover's path) and through the generic ``eval`` (``ProverBuilder``),
    bit-equal, each with its time and launches."""
    from dvt_circuits_tpu_torch.field import babybear as bb
    from dvt_circuits_tpu_torch.field import ext
    from dvt_circuits_tpu_torch.hostcrypto.bls12_381 import G1_GEN, g1_mul
    from dvt_circuits_tpu_torch.pcs.merkle import MerkleTree, hash_rows
    from dvt_circuits_tpu_torch.stark import prover as pr
    from dvt_circuits_tpu_torch.stark.config import DEFAULT_CONFIG as cfg
    from dvt_circuits_tpu_torch.stark.g1mul_air import G1MulAir

    rng = np.random.default_rng(SEED + 3)
    air = G1MulAir((256,) + (32,) * 6)
    chains = [(bytes(rng.integers(0, 256, bits // 8, dtype=np.uint8)),
               g1_mul(G1_GEN, int(rng.integers(2, 1 << 40)))) for bits in air.chain_bits]
    trace, publics = air.generate_trace(chains)
    n = trace.shape[0]
    log_n = n.bit_length() - 1
    alpha, zeta, gamma = (tuple(int(v) for v in rng.integers(0, bb.P, ext.D)) for _ in range(3))
    gzeta = ext.s_mul_base(zeta, bb.two_adic_generator(log_n))
    dev = torch.device("cuda")
    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        return out

    torch.cuda.reset_peak_memory_stats()
    t_lde = timed("trace LDE", lambda: pr.lde_body(
        torch.as_tensor(trace.astype(np.int64), device=dev), cfg))
    p_lde = timed("preprocessed LDE", lambda: pr.lde_body(
        torch.as_tensor(np.asarray(air.preprocessed_trace(n), dtype=np.int64), device=dev), cfg))
    timed("leaf sponge of the trace LDE (hash_rows)", lambda: hash_rows(t_lde))
    tree = timed("trace commit (leaf sponge + compress levels)", lambda: MerkleTree(t_lde))
    timed("80 openings of the committed LDE (MerkleTree.open_many)",
          lambda: tree.open_many(range(0, t_lde.shape[0], t_lde.shape[0] // 80)))
    tables = pr._domain_tables(log_n, cfg.log_blowup, cfg.shift, dev)
    args = (t_lde, p_lde, alpha, publics, tables, log_n, cfg)
    q_matrix, q_col_coeffs, count = timed("constraint quotient (eval_tensor)",
                                          lambda: pr.quotient_body(air, *args))
    opened = timed("openings at zeta and g*zeta", lambda: pr.openings_body(
        air, t_lde, p_lde, q_col_coeffs, zeta, gzeta, log_n, cfg))
    timed("DEEP codeword", lambda: pr.deep_body(
        air, t_lde, p_lde, q_matrix, opened, zeta, gzeta, gamma, tables, cfg))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    generic = timed("constraint quotient (generic eval)",
                    lambda: pr.quotient_body(_EvalOnly(air), *args))
    if generic[2] != count or not (torch.equal(generic[0], q_matrix)
                                   and torch.equal(generic[1], q_col_coeffs)):
        raise AssertionError("the eval_tensor quotient differs from the generic eval's on the card")
    _, q_launches = _cuda_launches(lambda: pr.quotient_body(air, *args))
    _, g_launches = _cuda_launches(lambda: pr.quotient_body(_EvalOnly(air), *args))
    _log(f"g1mul table breakdown (2^{log_n} x {air.width}, LDE 2^{log_n + cfg.log_blowup}, "
         f"{count} constraints), ms on the host clock: "
         + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
         + f"; device memory peak {peak_gib:.3f} GiB (before the generic quotient)")
    _log(f"g1mul constraint quotient on the card: eval_tensor {times['constraint quotient (eval_tensor)']:.3f} "
         f"ms in {q_launches} launches; generic eval {times['constraint quotient (generic eval)']:.3f} "
         f"ms in {g_launches} launches; bit-equal (q_matrix, q_col_coeffs, {count} constraints)")
    if q_launches >= _QUOTIENT_LAUNCH_LIMIT:
        raise AssertionError(f"the g1mul tensor quotient took {q_launches} launches")


def _g1_parts(data, config):
    """The curve fault's host side, as ``prove_circuit`` builds it at
    ``config`` with its prover stubbed: (container without proofs, the
    SHA-256 table entry, the recorded curve relation).  The witness runs on
    the host."""
    from dvt_circuits_tpu_torch.prover import curve_glue, pipeline

    captured = {"rels": []}
    build_gadget, prove_tables = curve_glue.build_gadget, pipeline.prove_tables

    def spy(rel, *args, **kwargs):
        captured["rels"].append(rel)
        return build_gadget(rel, *args, **kwargs)

    def stub(entries, config, device="cuda"):
        captured["entries"] = list(entries)
        return [{"public_values": [int(v) for v in pub]} for _, _, pub in entries]

    curve_glue.build_gadget, pipeline.prove_tables = spy, stub
    try:
        base = pipeline.prove_circuit("bad-share", data, True, config, device="cpu")
    finally:
        curve_glue.build_gadget, pipeline.prove_tables = build_gadget, prove_tables
    if [g["kind"] for g in base["gadgets"]] != ["sha256", "g1mul"] or len(captured["rels"]) != 1:
        raise AssertionError("unexpected tables for the curve fault")
    return base, captured["entries"][1], captured["rels"][0]


def _g1_entries(base, sha_entry, rel):
    """The legacy ``g1``-kind container's tables: [stream, SHA-256,
    ``G1PolyAir`` of the relation at production widths], the stream words
    over its descriptors (kind id 3, extras [k, 256, 32, seed_ref,
    init_ref]: the SHA-table indices the g1mul descriptor binds).  Returns
    (entries, gadgets without proofs)."""
    import copy

    from dvt_circuits_tpu_torch.prover import pipeline
    from dvt_circuits_tpu_torch.stark.g1_air import G1PolyAir
    from dvt_circuits_tpu_torch.stark.poseidon2_air import Poseidon2StreamAir

    seed_ref, init_ref = base["gadgets"][1]["extras"][2:4]
    k = len(rel["points"])
    air = G1PolyAir(k)
    g1 = {"kind": "g1", "block_counts": [k], "stream_offsets": [None],
          "extras": [k, 256, 32, seed_ref, init_ref], "proof": None}
    gadgets = [copy.deepcopy(base["gadgets"][0]), g1]
    words = pipeline._stream_words("bad-share", True, base["setup"],
                                   bytes.fromhex(base["public_values"]), gadgets,
                                   (base["gadgets_omitted"], base["chacha_omitted"], 0))
    stream_air = Poseidon2StreamAir(1 << (max(1, -(-len(words) // 8)) - 1).bit_length())
    entries = [(stream_air, *stream_air.generate_trace(words)), sha_entry,
               (air, *air.generate_trace(rel["secret"], rel["dest_id"], rel["points"]))]
    return entries, gadgets


def _g1_container(base, gadgets, proofs) -> dict:
    """The container of ``_g1_entries``'s tables and their ``proofs``."""
    gadgets[0]["proof"], gadgets[1]["proof"] = proofs[1], proofs[2]
    container = {key: value for key, value in base.items() if key != "timing"}
    container.update(stark=proofs[0], gadgets=gadgets, g1_omitted=0)
    return container


#: the batch of the SHA-256 timing: 2^12 messages of 150 bytes (3 blocks)
SHA_MESSAGES, SHA_MESSAGE_BYTES = 1 << 12, 150


def phase_g1_chip(p2) -> tuple:
    """The wide G1 chip (``G1PolyAir``) and the verifier's legacy ``g1``
    gadget on the card, at production widths (sk 256, id 32) for the
    7-of-10 curve fault's relation (k = 7: 512 × 26,477, LDE 2,048):

      * the trace, preprocessed trace and publics as the host builds them,
        and their copies on the card;
      * K1b on the trace LDE (rows of 3,310 absorbed blocks) bit-equal to
        ``hash_rows_plain``, timed with 1 and 4 lanes against its bound;
      * the constraint quotient through ``eval_tensor`` and the generic
        ``eval``: bit-equal, each timed (the first also with its launches);
      * the [stream, SHA-256, G1PolyAir] container proven on the card (cold
        with launch counts and the leaf sponge one launch a tree, warm with
        each prover phase), accepted by the port's strict ``verify_proof``
        on the card as ``curve-bound`` (launches counted, one leaf-sponge
        launch a tree and opening batch), refused with a tampered output
        public;
      * a G1PolyAir proof at the JAX tests' reduced widths (sk 16, id 8,
        k = 2: 32 × 26,477, ``TEST_CONFIG``) equal on the card and on the CPU
        (the CPU prove at production widths takes minutes);
      * ``sha256_batch`` at 2^12 messages of 3 blocks equal to hashlib, timed.

    Returns the launch counts of the prove and of the verify."""
    import copy

    from dvt_circuits_tpu_torch.dkg.scenario_gen import DkgCommittee
    from dvt_circuits_tpu_torch.field import babybear as bb
    from dvt_circuits_tpu_torch.hash import sha256
    from dvt_circuits_tpu_torch.hostcrypto.bls12_381 import G1_GEN, g1_mul
    from dvt_circuits_tpu_torch.pcs.challenger import DuplexChallenger
    from dvt_circuits_tpu_torch.prover.pipeline import VerifyError, verify_proof
    from dvt_circuits_tpu_torch.stark import prover as pr
    from dvt_circuits_tpu_torch.stark.config import DEFAULT_CONFIG as cfg
    from dvt_circuits_tpu_torch.stark.config import TEST_CONFIG
    from dvt_circuits_tpu_torch.stark.fused import prove_tables
    from dvt_circuits_tpu_torch.stark.g1_air import G1PolyAir
    from dvt_circuits_tpu_torch.utils import cbor

    card = _card_line()
    data = DkgCommittee(10, 7).shared_data_bad_secret(0, 1, True)
    t0 = time.perf_counter()
    base, sha_entry, rel = _g1_parts(data, cfg)
    entries, gadgets = _g1_entries(base, sha_entry, rel)
    air, trace, publics = entries[2]
    _log(f"g1-chip: witness, SHA-256 table and G1PolyAir trace on the host in "
         f"{time.perf_counter() - t0:.3f} s")
    n = trace.shape[0]
    log_n = n.bit_length() - 1
    pre = air.preprocessed_trace(n)
    if (air.k, trace.shape, pre.shape[1], len(publics)) != (7, (512, 26477), air.preprocessed_width,
                                                            air.num_public_values):
        raise AssertionError(f"unexpected G1PolyAir shape: k {air.k}, trace {trace.shape}")
    t_dev = torch.as_tensor(trace.astype(np.int64), device="cuda")
    p_dev = torch.as_tensor(pre.astype(np.int64), device="cuda")
    pub_dev = torch.as_tensor(publics, dtype=torch.int64, device="cuda")
    if not (np.array_equal(t_dev.cpu().numpy(), trace) and np.array_equal(p_dev.cpu().numpy(), pre)
            and pub_dev.tolist() == publics):
        raise AssertionError("the card's copies of the G1PolyAir trace differ from the host's")
    (inf_a, xa, ya), (inf_b, xb, yb) = air.out_points(publics)
    if (inf_a, (xa, ya)) != (0, g1_mul(G1_GEN, int.from_bytes(rel["secret"], "big"))):
        raise AssertionError("G1PolyAir's pk result differs from g1_mul(G, sk)")
    if (inf_a, xa, ya) == (inf_b, xb, yb):
        raise AssertionError("the 7-of-10 curve fault's relation shows a valid share")
    _log(f"g1-chip: G1PolyAir k = {air.k}, trace {trace.shape[0]} x {trace.shape[1]} "
         f"({air.min_rows} rows used), preprocessed width {pre.shape[1]}, "
         f"{len(publics)} publics; the card's copies equal the host's; pk = sk·G")

    # K1b on rows of 26,477 columns: 3,310 absorbed blocks a row
    t_lde = pr.lde_body(t_dev, cfg)
    p_lde = pr.lde_body(p_dev, cfg)
    n_lde, w = t_lde.shape
    perms = n_lde * -(-w // 8)
    plain, plain_ms = _cuda_ms(lambda: p2.hash_rows_plain(t_lde))
    for lanes in _LANES:
        with _lanes_forced(p2, lanes):
            if not torch.equal(p2.poseidon2_hash_rows(t_lde), plain):
                raise AssertionError(f"K1b ({lanes} lanes) disagrees with hash_rows_plain at "
                                     f"{n_lde} x {w}")
    bound = k1_bound_ms(perms, n_lde * (w + 8) * 8)
    ms = {}
    for lanes in _LANES:
        with _lanes_forced(p2, lanes):
            ms[lanes] = _time_ms(lambda: p2.poseidon2_hash_rows(t_lde), 5, warmup=1)
    _log(f"g1-chip: K1b hash_rows {n_lde} x {w} ({-(-w // 8)} absorbed blocks a row, {perms} "
         f"permutations): bit-equal to hash_rows_plain with 1 and 4 lanes; "
         + ", ".join(f"{lanes} lanes {t:.6f} ms" for lanes, t in ms.items())
         + f" (the wrapper picks {p2._lanes(n_lde)}); plain {plain_ms:.3f} ms (one call); bound "
         f"{bound[0]:.6f} ms ({bound[1]}); share of the bound "
         + ", ".join(f"{lanes} lanes {bound[0] / t:.4f}" for lanes, t in ms.items())
         + f"; {card}")
    del plain

    # the constraint quotient through both builders
    rng = np.random.default_rng(SEED + 11)
    alpha = tuple(int(v) for v in rng.integers(0, bb.P, 4))
    tables = pr._domain_tables(log_n, cfg.log_blowup, cfg.shift, torch.device("cuda"))
    args = (t_lde, p_lde, alpha, publics, tables, log_n, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q_matrix, q_col_coeffs, count = pr.quotient_body(air, *args)
    torch.cuda.synchronize()
    tensor_ms = (time.perf_counter() - t0) * 1e3
    _, tensor_launches = _cuda_launches(lambda: pr.quotient_body(air, *args))
    t0 = time.perf_counter()
    generic = pr.quotient_body(_EvalOnly(air), *args)
    torch.cuda.synchronize()
    generic_ms = (time.perf_counter() - t0) * 1e3
    if generic[2] != count or not (torch.equal(generic[0], q_matrix)
                                   and torch.equal(generic[1], q_col_coeffs)):
        raise AssertionError("the G1PolyAir eval_tensor quotient differs from the generic eval's")
    # the generic eval's ~7e5 launches are not counted here: under the
    # profiler they take minutes
    _log(f"g1-chip: constraint quotient ({count} constraints, LDE {n_lde} x {w}) through "
         f"eval_tensor {tensor_ms:.3f} ms in {tensor_launches} launches; through the generic eval "
         f"{generic_ms:.3f} ms; bit-equal; {card}")
    del t_lde, p_lde, generic, q_matrix, q_col_coeffs, t_dev, p_dev

    # the g1-kind container on the card
    _reset_counts()
    with _TreeCount() as trees:
        t0 = time.perf_counter()
        proofs = prove_tables(entries, cfg, device="cuda")
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
    launches = _read_counts("g1-chip", _K1_PROVE)
    trees.check("g1-chip")
    for name, proof in zip(("stream", "sha256", "g1"), proofs):
        _log(f"g1-chip table {name}: rows 2^{proof['log_n']}, width {proof['width']}, LDE "
             f"2^{proof['fri']['log_n']}, constraints {proof['constraint_count']}")
    if proofs[2]["public_values"] != publics or proofs[2]["constraint_count"] != count:
        raise AssertionError("the G1PolyAir proof carries other publics or constraints")
    torch.cuda.reset_peak_memory_stats()
    with _phase_memory() as rows:
        t0 = time.perf_counter()
        warm = prove_tables(entries, cfg, device="cuda")
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    _log(f"g1-chip: [stream, sha256, G1PolyAir] proven on the card cold {cold_s:.3f} s, warm "
         f"{warm_s:.3f} s (phases synchronized); {card}")
    _log_phase_memory("g1-chip", rows)
    if cbor.encode(warm) != cbor.encode(proofs):
        raise AssertionError("the warm g1-chip proofs differ from the cold ones")
    container = _g1_container(base, gadgets, proofs)
    _reset_counts()
    with _TreeCount() as trees:
        t0 = time.perf_counter()
        res = verify_proof(container, "bad-share", strict=True, device="cuda")
        torch.cuda.synchronize()
        verify_s = time.perf_counter() - t0
    verify_launches = _read_counts("g1-chip verify", _K1_VERIFY)
    trees.check("g1-chip verify")
    if (res.binding, res.g1_relations, res.g1_omitted, res.sig_checks) != ("curve-bound", 1, 0, 0):
        raise AssertionError(f"the port's verifier returned {res} for the g1 container")
    _log(f"g1-chip: the g1-kind container verifies on cuda in {verify_s:.3f} s: {res}; {card}")
    bad = copy.deepcopy(container)
    bad["gadgets"][1]["proof"]["public_values"][air.oa_base + 3] ^= 1
    try:
        verify_proof(bad, "bad-share", device="cuda")
    except VerifyError as e:
        if "STARK verification failed" not in str(e):
            raise
        _log(f"g1-chip: a tampered output public is refused: {e}")
    else:
        raise AssertionError("the port's verifier accepted a tampered G1PolyAir output public")
    del proofs, warm, container, bad

    # the card against the CPU at the JAX tests' reduced widths
    small = G1PolyAir(2, sk_bits=16, id_bits=8)
    rng = np.random.default_rng(SEED + 12)
    cs = [g1_mul(G1_GEN, int(rng.integers(2, 1 << 60))) for _ in range(2)]
    s_trace, s_pub = small.generate_trace(int(rng.integers(1, 1 << 16)).to_bytes(2, "big"),
                                          int(rng.integers(1, 1 << 8)), cs)
    gpu = pr.prove(small, s_trace, s_pub, TEST_CONFIG, DuplexChallenger("cuda"))
    t0 = time.perf_counter()
    cpu = pr.prove(small, s_trace, s_pub, TEST_CONFIG, DuplexChallenger("cpu"))
    cpu_s = time.perf_counter() - t0
    if cbor.encode(gpu) != cbor.encode(cpu):
        raise AssertionError("the reduced-width G1PolyAir proof differs between the card and CPU")
    _log(f"g1-chip: reduced-width G1PolyAir ({s_trace.shape[0]} x {s_trace.shape[1]}, "
         f"TEST_CONFIG) proof bytes equal on the card and the CPU (CPU prove {cpu_s:.3f} s)")

    # batched SHA-256, plain PyTorch on the card
    msgs = [rng.bytes(SHA_MESSAGE_BYTES) for _ in range(SHA_MESSAGES)]
    t0 = time.perf_counter()
    digests = sha256.sha256_batch(msgs, device="cuda")
    call_s = time.perf_counter() - t0
    if digests != [hashlib.sha256(m).digest() for m in msgs]:
        raise AssertionError("sha256_batch on the card differs from hashlib")
    words = sha256.pack_messages(msgs, device="cuda")
    words_ms = _time_ms(lambda: sha256.sha256_words(words), 5, warmup=1)
    _log(f"g1-chip: sha256_batch of {SHA_MESSAGES} messages of {words.shape[0]} blocks on the "
         f"card equals hashlib; sha256_words {words_ms:.3f} ms (CUDA events), the whole call "
         f"{call_s * 1e3:.3f} ms (host packing and copies included); {card}")
    return launches, verify_launches


def phase_gpu_equals_cpu() -> None:
    """The CPU tests' inputs (2-of-3 committee, TEST_CONFIG): the card and
    the plain CPU path give equal containers, so JAX == port-CPU (the tests;
    finalization's in the ``heavy`` test) == port-GPU."""
    from dvt_circuits_tpu_torch.dkg.scenario_gen import DkgCommittee
    from dvt_circuits_tpu_torch.prover.pipeline import container_digest, prove_circuit
    from dvt_circuits_tpu_torch.stark.config import TEST_CONFIG

    com = DkgCommittee(3, 2)
    for circuit, data in (("bad-share", com.shared_data_bad_secret(0, 1, True)),
                          ("bad-partial-key", com.bad_partial_key_data(1, True)),
                          ("bad-encrypted-share", _bad_encrypted_share(3, 2)),
                          ("finalization", com.finalization_data())):
        gpu = prove_circuit(circuit, data, True, TEST_CONFIG, device="cuda")
        t0 = time.perf_counter()
        cpu = prove_circuit(circuit, data, True, TEST_CONFIG, device="cpu")
        cpu_s = time.perf_counter() - t0
        g, c = container_digest(gpu), container_digest(cpu)
        _log(f"{circuit} 2-of-3 TEST_CONFIG: gpu prove_ms {gpu['timing']['prove_ms']}, "
             f"cpu {cpu_s:.3f} s; sha256 without timing gpu {g} cpu {c}")
        if g != c:
            raise AssertionError(f"GPU {circuit} container differs from the CPU one")


def phase_cli_curve(kk, data, tmp: Path) -> None:
    """The CLI ``prove`` of the curve fault and ``verify --show-report`` of
    its file, as a user runs them."""
    scenario = tmp / "curve_scenario.json"
    scenario.write_text(json.dumps(data.to_json(True)))
    proof = tmp / "curve_proof.bin"
    cli = [sys.executable, "-m", "dvt_circuits_tpu_torch.cli", "--auth-commitment"]
    for args in (["prove", "--type=bad-share", "-i", str(scenario), "-o", str(proof)],
                 ["verify", "--type=bad-share", "-i", str(proof), "--show-report",
                  "--require-curve-binding"]):
        t0 = time.perf_counter()
        res = subprocess.run(cli + args, cwd=ROOT, capture_output=True, text=True, timeout=600)
        wall_s = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"CLI {args[0]} exited {res.returncode}:\n{res.stdout}\n"
                                 f"{res.stderr}")
        expected = kk.keccak256_batch([hashlib.sha256(proof.read_bytes()).digest()],
                                      device="cpu")[0].hex()
        line = [ln for ln in res.stdout.splitlines() if "keccak256: " in ln.lower()]
        if len(line) != 1 or line[0].split(": ", 1)[1] != expected:
            raise AssertionError(f"CLI {args[0]} fingerprint line {line} != plain Keccak {expected}")
        report = "".join(f"; {ln}" for ln in res.stdout.splitlines() if ln.startswith("circuit: "))
        _log(f"CLI {args[0]} subprocess: exit 0 in {wall_s:.3f} s, fingerprint matches the plain "
             f"Keccak{report}")
    if "binding: curve-bound+sig" not in res.stdout:
        raise AssertionError("CLI verify did not report curve-bound+sig")


def _curve_record(name: str, replaces: str, shape, err: int, ms: float, plain_ms: float,
                  bound) -> dict:
    return {
        "name": name,
        "route": "cuda",
        "source": "dvt_circuits_tpu_torch/csrc/curve.cu",
        "replaces": replaces,
        "shape": list(shape),
        "launches": None,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound[0],
        "bound_by": bound[1],
        "library_ms": None,
    }


def curve_bound_ms(products: int, bytes_moved: int):
    """A curve kernel's bound: ``products`` Fp products of ``FP_MUL_IMAD``
    multiplies each, or its bytes; the larger."""
    return _bound_ms(products, (FP_MUL_IMAD, FP_MUL_IMAD), bytes_moved)


def _cuda_ms(fn):
    """(fn(), its ms) for one call, between CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _limb_err(a, b) -> int:
    """Largest |a − b| over nested tuples of limb tensors."""
    if isinstance(a, tuple):
        return max(_limb_err(x, y) for x, y in zip(a, b))
    return int((a - b).abs().max())


def _words_to_limbs(words):
    """The kernels' scratch points ((..., 36) int32: x, y, z as 12 words of
    32 bits each) as Jacobian limb tensors ((..., 32) int64 per coordinate)."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    coords = []
    for c in range(3):
        limbs = []
        for i in range(32):
            word, off = divmod(12 * i, 32)
            v = w[..., 12 * c + word] >> off
            if off > 20:
                v = v | (w[..., 12 * c + word + 1] << (32 - off))
            limbs.append(v & 0xFFF)
        coords.append(torch.stack(limbs, -1))
    return tuple(coords)


def _bench_points(n: int, equal: bool = False):
    """bench.py's MSM input: P_i = (7i + 3)·G (by additions of 7G) and random
    256-bit scalars from numpy (with ``equal``, one random scalar for every
    point: each window's points then share one bucket); the host oracle is
    one scalar multiplication (Σ s_i (7i + 3) mod r)·G."""
    from dvt_circuits_tpu_torch.hostcrypto import bls12_381 as host

    rng = np.random.default_rng(SEED + 20 + n)
    step = host.g1_mul(host.G1_GEN, 7)
    points = [host.g1_mul(host.G1_GEN, 3)]
    for _ in range(n - 1):
        points.append(host.g1_add(points[-1], step))
    scalars = [int.from_bytes(rng.bytes(32), "big") % host.R for _ in range(1 if equal else n)]
    scalars = scalars * n if equal else scalars
    want = host.g1_mul(host.G1_GEN, sum(s * (7 * i + 3) for i, s in enumerate(scalars)) % host.R)
    return points, scalars, want


def _edge_points():
    """Zero scalars, an identity point, a repeated point and a P / −P pair,
    with the host oracle's sum."""
    from dvt_circuits_tpu_torch.hostcrypto import bls12_381 as host

    pts = [host.g1_mul(host.G1_GEN, 7 * i + 3) for i in range(4)]
    points = [None, pts[0], pts[1], pts[1], pts[2], host.g1_neg(pts[2]), pts[3], host.G1_GEN]
    scalars = [5, 0, 7, 7, 11, 11, 0x1234_5678_9ABC_DEF0 << 190, host.R - 1]
    want = None
    for p, s in zip(points, scalars):
        want = host.g1_add(want, host.g1_mul(p, s) if p else None)
    return points, scalars, want


def _g2_batch(n: int):
    """C4's input: P_i = (3 + 2i)·G2 (by additions of 2·G2), the identity at
    i = 15, and random scalars from numpy; a batch's first 16 points and
    scalars are the 16-point batch's."""
    from dvt_circuits_tpu_torch.hostcrypto import bls12_381 as host

    rng = np.random.default_rng(SEED + 11)
    step = host.g2_add(host.G2_GEN, host.G2_GEN)
    points = [host.g2_mul(host.G2_GEN, 3)]
    for _ in range(n - 1):
        points.append(host.g2_add(points[-1], step))
    points[15] = None
    scalars = [int.from_bytes(rng.bytes(32), "big") % host.R for _ in range(n)]
    return points, scalars


def _g2_products(bits) -> int:
    """C4's Fp products for these bits: 256 doublings a point, an addition a
    set bit."""
    return bits.shape[0] * 256 * G2_DBL_MULS + int(bits.sum()) * G2_ADD_MULS


def _c2_device_launches(n: int) -> int:
    """C2's device launches for n points: the per-point pass, then a launch
    a level of the tree (a store for n <= 1)."""
    return (1 if n > 0 else 0) + (max(n - 1, 0).bit_length() if n > 1 else 1)


def _windowed_products(digits) -> int:
    """C2's Fp products for this input: per point 14 table additions, 256
    doublings and one addition for each nonzero digit; n − 1 additions to
    reduce."""
    n = digits.shape[0]
    adds = 14 * n + int((digits != 0).sum()) + max(n - 1, 0)
    return adds * G1_ADD_MULS + 256 * n * G1_DBL_MULS


def _bucket_products(digits, window_bits: int) -> int:
    """C3's Fp products for this input, Pippenger's count: each point with a
    nonzero digit once per window, 2 (2^w − 1) additions per window for the
    running sums, and the cross-window Horner's w doublings and one
    addition per window after the first."""
    nwin = digits.shape[1]
    adds = int((digits != 0).sum()) + nwin * 2 * ((1 << window_bits) - 1) + (nwin - 1)
    return adds * G1_ADD_MULS + (nwin - 1) * window_bits * G1_DBL_MULS


#: C3's stages C3a-C3d, in launch order (``g1._bucket_launches``)
C3_STAGES = ("g1_bucket_sort", "g1_bucket_sums", "g1_window_sums", "g1_horner")


def _bucket_stage_work(digits, window_bits: int) -> dict:
    """Each C3 stage's share of ``_bucket_products`` (Fp products) and the
    bytes it must move: the sort reads the digits and writes the order, the
    bucket sums read the points and write the bucket sums, the window sums
    read those and write one point per window, the Horner reads those and
    writes the result.  The products add up to ``_bucket_products``."""
    m, nwin = digits.shape
    nb = (1 << window_bits) - 1
    point = 3 * 12 * 4  # a G1 point in the kernels' scratch
    return {
        "g1_bucket_sort": (0, 2 * m * nwin * 4 + nwin * (nb + 2) * 4),
        "g1_bucket_sums": (int((digits != 0).sum()) * G1_ADD_MULS,
                           m * (3 * FP_BYTES + nwin * 4) + nwin * nb * point),
        "g1_window_sums": (nwin * 2 * nb * G1_ADD_MULS, nwin * (nb + 1) * point),
        "g1_horner": ((nwin - 1) * (G1_ADD_MULS + window_bits * G1_DBL_MULS),
                      nwin * point + 3 * FP_BYTES),
    }


def _c3_records(label: str, points, scalars, want) -> list:
    """C3 on one batch at ``msm_bucket``'s window: equal to the host oracle,
    its Jacobian limbs equal to the staged plain version's and the same in a
    second run; the whole call and each stage timed (CUDA events) against
    its plain stage and bound."""
    from dvt_circuits_tpu_torch.curve import g1

    n = len(points)
    w = g1.default_window_bits(n)
    t0 = time.perf_counter()
    pb, db = g1.bucket_inputs(points, scalars, w, "cuda")
    _log(f"C3 input at {label}: bucket_inputs {time.perf_counter() - t0:.3f} s")
    got = g1.msm_bucket_jacobian(pb, db, w)
    again = g1.msm_bucket_jacobian(pb, db, w)
    if g1.to_affine_points(tuple(c[None] for c in got))[0] != want:
        raise AssertionError(f"C3 at {label} differs from the host oracle")
    if _limb_err(got, again):
        raise AssertionError(f"C3 at {label}: two runs gave different Jacobian limbs")
    ms = _time_ms(lambda: g1.msm_bucket_jacobian(pb, db, w), 5, warmup=1)
    # the plain stages one by one, each timed, then the kernel's stages
    (idx, offsets), sort_ms = _cuda_ms(lambda: g1.bucket_sort_plain(db, w))
    buckets, sums_ms = _cuda_ms(lambda: g1.bucket_sums_plain(pb, db, idx, offsets, w))
    windows, win_ms = _cuda_ms(lambda: g1.window_sums_plain(buckets, w))
    plain, horner_ms = _cuda_ms(lambda: g1.horner_plain(windows, w))
    err = _limb_err(got, plain)
    if err:
        raise AssertionError(f"C3 at {label}: Jacobian limbs differ from msm_bucket_plain's")
    plain_ms = {"g1_bucket_sort": sort_ms, "g1_bucket_sums": sums_ms,
                "g1_window_sums": win_ms, "g1_horner": horner_ms}
    launches, bufs = g1._bucket_launches(pb, db, w)
    for launch in launches.values():
        launch()
    errs = {"g1_bucket_sort": max(_limb_err(bufs["idx"], idx), _limb_err(bufs["offsets"], offsets)),
            "g1_bucket_sums": _limb_err(_words_to_limbs(bufs["buckets"]), buckets),
            "g1_window_sums": _limb_err(_words_to_limbs(bufs["windows"]), windows),
            "g1_horner": _limb_err(tuple(bufs["out"]), plain)}
    if any(errs.values()):
        raise AssertionError(f"C3 at {label}: a stage differs from its plain version: {errs}")
    stage_ms = {name: _time_ms(launches[name], 5, warmup=1) for name in C3_STAGES}
    work = _bucket_stage_work(db, w)
    bound = curve_bound_ms(_bucket_products(db, w),
                           db.shape[0] * (3 * FP_BYTES + db.shape[1] * 4) + 3 * FP_BYTES)
    _log(f"C3 at {label} (m = {db.shape[0]}, w = {w}, {db.shape[1]} windows): equals the "
         f"oracle, Jacobian limbs equal msm_bucket_plain's and the same in two runs; "
         f"{ms:.6f} ms (4 device launches a call), plain {sum(plain_ms.values()):.3f} ms, "
         f"bound {bound[0]:.6f} ms ({bound[1]}), share {bound[0] / ms:.3e}; stages "
         + ", ".join(f"C3{'abcd'[k]} {name} {stage_ms[name]:.6f} ms (plain {plain_ms[name]:.3f})"
                     for k, name in enumerate(C3_STAGES)))
    shape = (n, "equal scalars") if "equal" in label else (n,)
    records = [_curve_record("g1_msm_bucket", "dvt_circuits_tpu/curve/g1.py:341", shape, err, ms,
                             sum(plain_ms.values()), bound)]
    for name in C3_STAGES:
        rec = _curve_record(name, "dvt_circuits_tpu/curve/g1.py:341", shape, errs[name],
                            stage_ms[name], plain_ms[name], curve_bound_ms(*work[name]))
        rec["stage_of"] = "g1_msm_bucket"
        records.append(rec)
    return records


def c1_operands(n: int):
    """C1's input of n products on the card: n random pairs below p (the top
    limb under p's), then 8 rows more, the rows 0, 1, p − 1, p − 2 against
    themselves and against their reverse."""
    from dvt_circuits_tpu_torch.curve import fp

    rng = np.random.default_rng([SEED + 10, n])
    top = int(fp.P_INT >> (12 * 31))
    limbs = rng.integers(0, 1 << 12, (2, n, 32), dtype=np.int64)
    limbs[..., 31] = rng.integers(0, top, (2, n))
    edges = np.stack([fp.int_to_limbs(v) for v in (0, 1, fp.P_INT - 1, fp.P_INT - 2)])
    a = torch.as_tensor(np.concatenate([limbs[0], edges, edges]), device="cuda")
    b = torch.as_tensor(np.concatenate([limbs[1], edges, edges[::-1].copy()]), device="cuda")
    return a, b


def c1_plain(a, b):
    """``mont_mul_plain`` over row blocks of 2^16 (its column sums hold 64
    products a row: 1 GiB of int64 at 2^16 rows, 16 GiB at 2^20)."""
    from dvt_circuits_tpu_torch.curve import fp

    step = 1 << 16
    return torch.cat([fp.mont_mul_plain(a[i:i + step], b[i:i + step])
                      for i in range(0, a.shape[0], step)])


def c1_kernel_ms(a, b, reps: int) -> float:
    """C1's kernel alone: ``reps`` launches of its C entry point through
    ctypes, no wrapper (operands ready, ``out`` allocated once), between
    CUDA events."""
    from dvt_circuits_tpu_torch import kernels
    from dvt_circuits_tpu_torch.curve import fp

    launch, out = fp._library().fp_mont_mul, torch.empty_like(a)
    args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], kernels.stream_handle(a))
    kernels.check(launch(*args), "fp_mont_mul kernel launch")
    return _time_ms(lambda: launch(*args), reps)


def _c1_times(a, b) -> tuple:
    """(call ms, kernel-alone ms, reps) of C1 on the n rows of a and b."""
    from dvt_circuits_tpu_torch.curve import fp

    reps = max(20, (100 << 16) // a.shape[0])
    return _time_ms(lambda: fp.mont_mul(a, b), reps), c1_kernel_ms(a, b, reps), reps


def c1_timed(n: int) -> dict:
    """C1 at n products checked on a sample (the first 256 rows and the 8
    edge rows bit-equal to ``mont_mul_plain``), then its call and its kernel
    alone timed (ms): how ``curve/compare_checkouts.py`` and
    ``curve/sweep.py`` hold one checkout's C1."""
    from dvt_circuits_tpu_torch.curve import fp

    a, b = c1_operands(n)
    got = fp.mont_mul(a, b)
    for rows in (slice(0, 256), slice(n, n + 8)):
        if _limb_err(got[rows], fp.mont_mul_plain(a[rows], b[rows])):
            raise AssertionError(f"C1 at {n} products differs from mont_mul_plain")
    ms, kernel_ms, _ = _c1_times(a[:n], b[:n])
    return {f"C1 {n} products": ms, f"C1 {n} products, kernel alone": kernel_ms}


def c1_record(n: int) -> dict:
    """C1 at n products: bit-equal to ``mont_mul_plain`` (the edge rows too),
    then the call (``mont_mul``) and the kernel alone timed, against the
    plain version and the bytes bound (768 bytes a product)."""
    from dvt_circuits_tpu_torch.curve import fp

    a, b = c1_operands(n)
    err = _limb_err(fp.mont_mul(a, b), c1_plain(a, b))
    if err:
        raise AssertionError(f"C1 fp_mont_mul differs from mont_mul_plain at {n} products")
    a, b = a[:n], b[:n]
    ms, kernel_ms, reps = _c1_times(a, b)
    plain_ms = _time_ms(lambda: c1_plain(a, b), 3 if n <= 1 << 16 else 1, warmup=1)
    # a yardstick of the rate the card reaches on these bytes: PyTorch's own
    # elementwise add reads two such operands and writes one (not a product)
    out = torch.empty_like(a)
    add_ms = _time_ms(lambda: torch.add(a, b, out=out), reps)
    bound = curve_bound_ms(n, 3 * n * FP_BYTES)
    _log(f"C1 fp_mont_mul: bit-equal to mont_mul_plain on {n} pairs and the rows 0, 1, p-1, "
         f"p-2; {n} products: call {ms:.6f} ms, kernel alone {kernel_ms:.6f} ms, plain "
         f"{plain_ms:.6f} ms, bound {bound[0]:.6f} ms ({bound[1]}), share of the call "
         f"{bound[0] / ms:.4f}, of the kernel {bound[0] / kernel_ms:.4f}; torch.add on the "
         f"same bytes {add_ms:.6f} ms")
    rec = _curve_record("fp_mont_mul", "dvt_circuits_tpu/curve/fp.py:151", (n, 32), err, ms,
                        plain_ms, bound)
    rec["kernel_ms"] = kernel_ms
    rec["same_bytes_add_ms"] = add_ms
    return rec


def c1_edge_checks() -> None:
    """C1 bit-equal to ``mont_mul_plain`` at the tails of a tile (``kTile`` ±
    1 and 2^16 + 3 products), on views whose rows start 8 bytes off a
    16-byte boundary (one operand, then both) and on a broadcast row: one
    launch a call."""
    from dvt_circuits_tpu_torch.curve import fp

    tile = fp._library().fp_mont_mul_tile()
    for n in (tile - 1, tile + 1, (1 << 16) + 3):
        a, b = c1_operands(n)
        if _limb_err(fp.mont_mul(a, b), c1_plain(a, b)):
            raise AssertionError(f"C1 differs from mont_mul_plain at {n + 8} products")
    a, b = c1_operands(3 * tile + 5)
    views = []
    for x in (a, b):
        view = torch.empty(x.numel() + 1, dtype=torch.int64, device="cuda")[1:].view(x.shape)
        view.copy_(x)
        if view.data_ptr() % 16 != 8:
            raise AssertionError("a view meant to start 8 bytes off is 16-byte aligned")
        views.append(view)
    want = c1_plain(a, b)
    for x, y, what in ((views[0], b, "a misaligned a"), (views[0], views[1], "misaligned a, b"),
                       (a, b[:1], "a broadcast row of b")):
        before = fp.mont_mul.launches
        got = fp.mont_mul(x, y)
        if fp.mont_mul.launches != before + 1:
            raise AssertionError(f"C1 on {what}: not one launch")
        if _limb_err(got, want if y.shape == b.shape else c1_plain(a, b[:1].expand_as(a))):
            raise AssertionError(f"C1 differs from mont_mul_plain on {what}")
    _log(f"C1 fp_mont_mul: bit-equal to mont_mul_plain at {tile - 1}, {tile + 1} and "
         f"{(1 << 16) + 3} products (kTile {tile}, 8 edge rows each), on views 8 bytes off a "
         f"16-byte boundary and on a broadcast row, one launch a call")


def phase_curve_kernels():
    """C1–C4 against their plain versions and the host oracle, timed; returns
    the kernel records (launches filled later)."""
    from dvt_circuits_tpu_torch.curve import g1, g2
    from dvt_circuits_tpu_torch.hostcrypto import bls12_381 as host

    from dvt_circuits_tpu_torch.curve import lane_probe

    probe = lane_probe.measure()
    _log("lane probe (csrc/lane_probe.cu; µs an operation in a chain, one block, the forms "
         "end on the same limbs): " + "; ".join(f"{k} {v:.4f}" for k, v in probe.items()))
    records = [c1_record(n) for n in C1_PRODUCTS]
    c1_edge_checks()

    # -- C2, C3: the edge batch, then bench's sizes ---------------------------
    points, scalars, want = _edge_points()
    for w in (2, 4, 8):
        if g1.msm_bucket(points, scalars, w, device="cuda") != want:
            raise AssertionError(f"C3 g1_msm_bucket (w = {w}) differs from the oracle on the "
                                 f"edge batch")
    if g1.msm(points, scalars, device="cuda") != want:
        raise AssertionError("C2 g1_msm_windowed differs from the oracle on the edge batch")
    p = g1.from_affine_points(points, "cuda")
    digits = g1.scalars_to_digits(scalars, "cuda")
    if _limb_err(g1.msm_jacobian(p, digits), g1.msm_plain(p, digits)):
        raise AssertionError("C2 on the edge batch: Jacobian limbs differ from msm_plain")
    _log("C2, C3: the edge batch (zero scalars, identity, a repeated point, P and -P) "
         "equals the host oracle (C3 at w = 2, 4, 8), C2's Jacobian limbs equal msm_plain's")
    for n in MSM_POINTS:
        t0 = time.perf_counter()
        points, scalars, want = _bench_points(n)
        p = g1.from_affine_points(points, "cuda")
        digits = g1.scalars_to_digits(scalars, "cuda")
        _log(f"MSM input of {n} points and the host oracle: {time.perf_counter() - t0:.3f} s")
        got2 = g1.msm_jacobian(p, digits)
        if g1.to_affine_points(tuple(c[None] for c in got2))[0] != want:
            raise AssertionError(f"C2 at {n} points differs from the host oracle")
        ms2 = _time_ms(lambda: g1.msm_jacobian(p, digits), 3, warmup=1)
        plain2, plain2_ms = _cuda_ms(lambda: g1.msm_plain(p, digits))
        err2 = _limb_err(got2, plain2)
        if err2:
            raise AssertionError(f"C2 at {n} points: Jacobian limbs differ from msm_plain")
        bound2 = curve_bound_ms(_windowed_products(digits),
                                n * (3 * FP_BYTES + 64 * 4) + 3 * FP_BYTES)
        _log(f"C2 g1_msm_windowed at {n} points: equals the oracle, Jacobian limbs equal "
             f"msm_plain's; {ms2:.6f} ms ({_c2_device_launches(n)} device launches a call), "
             f"plain {plain2_ms:.3f} ms, "
             f"bound {bound2[0]:.6f} ms ({bound2[1]}), share {bound2[0] / ms2:.3e}")
        records.append(_curve_record("g1_msm_windowed", "dvt_circuits_tpu/curve/g1.py:214",
                                     (n,), err2, ms2, plain2_ms, bound2))
        records += _c3_records(f"{n} points", points, scalars, want)
    points, scalars, want = _bench_points(MSM_POINTS[-1], equal=True)
    records += _c3_records(f"{MSM_POINTS[-1]} points, equal scalars", points, scalars, want)

    # -- C4: G2 points, one of them the identity ------------------------------
    n = G2_POINTS
    g2_points, g2_scalars = _g2_batch(n)
    pg = g2.from_host_points(g2_points, "cuda")
    bits = g1.scalars_to_bits(g2_scalars, "cuda")
    got = g2.scalar_mul(pg, bits)
    again = g2.scalar_mul(pg, bits)
    plain, plain_ms = _cuda_ms(lambda: g2.scalar_mul_plain(pg, bits))
    err = _limb_err(got, plain)
    if err:
        raise AssertionError("C4 g2_scalar_mul: Jacobian limbs differ from scalar_mul_plain")
    if _limb_err(got, again):
        raise AssertionError("C4 g2_scalar_mul: two runs gave different Jacobian limbs")
    if g2.to_host_points(got) != [host.g2_mul(q, k) if q else None
                                  for q, k in zip(g2_points, g2_scalars)]:
        raise AssertionError("C4 g2_scalar_mul differs from the host g2_mul")
    ms = _time_ms(lambda: g2.scalar_mul(pg, bits), 5, warmup=1)
    bound = curve_bound_ms(_g2_products(bits), n * (2 * 3 * 2 * FP_BYTES + 256 * 4))
    _log(f"C4 g2_scalar_mul at {n} points: Jacobian limbs equal scalar_mul_plain's and the same "
         f"in two runs, affine equals the host g2_mul; {ms:.6f} ms, plain {plain_ms:.3f} ms, "
         f"bound {bound[0]:.6f} ms ({bound[1]}), share {bound[0] / ms:.3e}")
    records.append(_curve_record("g2_scalar_mul", "dvt_circuits_tpu/curve/g2.py:170", (n,), err,
                                 ms, plain_ms, bound))
    # at 1024 points, where the card is full: the first 16 rows against the
    # 16-point run's limbs, a sample against the host oracle (the plain
    # version is not run again)
    n = G2_POINTS_FULL
    t0 = time.perf_counter()
    big_points, big_scalars = _g2_batch(n)
    pg = g2.from_host_points(big_points, "cuda")
    bits = g1.scalars_to_bits(big_scalars, "cuda")
    big = g2.scalar_mul(pg, bits)
    head = tuple((c[0][:G2_POINTS], c[1][:G2_POINTS]) for c in big)
    if _limb_err(head, got):
        raise AssertionError(f"C4 at {n} points: the first {G2_POINTS} rows differ from the "
                             f"{G2_POINTS}-point run's")
    sample = sorted(np.random.default_rng(SEED + 12).choice(n, 16, replace=False).tolist())
    picked = tuple((c[0][sample], c[1][sample]) for c in big)
    if g2.to_host_points(picked) != [host.g2_mul(big_points[i], big_scalars[i])
                                     if big_points[i] else None for i in sample]:
        raise AssertionError(f"C4 at {n} points differs from the host g2_mul on a sample")
    ms = _time_ms(lambda: g2.scalar_mul(pg, bits), 3, warmup=1)
    bound = curve_bound_ms(_g2_products(bits), n * (2 * 3 * 2 * FP_BYTES + 256 * 4))
    _log(f"C4 g2_scalar_mul at {n} points (input and checks {time.perf_counter() - t0:.1f} s): "
         f"the first {G2_POINTS} rows equal the {G2_POINTS}-point run's limbs, {len(sample)} "
         f"sampled rows equal the host g2_mul; {ms:.6f} ms, plain not run, bound "
         f"{bound[0]:.6f} ms ({bound[1]}), share {bound[0] / ms:.3e}")
    return records


_CURVE_KERNELS = ("fp_mont_mul", "g1_msm_windowed", "g1_msm_bucket", "g2_scalar_mul",
                  *C3_STAGES)


def phase_curve_package() -> dict:
    """The curve package's entry points as a user calls them, with the launch
    counts reset just before and read just after: ``msm`` and
    ``msm_bucket`` at 4096 points (bench's size), ``g2.scalar_mul`` on 16
    points, and ``g1.add`` / ``g1.double`` (products through C1) on 1024."""
    from dvt_circuits_tpu_torch.curve import g1, g2
    from dvt_circuits_tpu_torch.hostcrypto import bls12_381 as host

    points, scalars, want = _bench_points(MSM_POINTS[-1])
    g2_points = [host.g2_mul(host.G2_GEN, 3 + 2 * i) for i in range(G2_POINTS)]
    small = points[:MSM_POINTS[0]]
    _reset_counts()
    t0 = time.perf_counter()
    windowed = g1.msm(points, scalars, device="cuda")
    t1 = time.perf_counter()
    bucket = g1.msm_bucket(points, scalars, device="cuda")
    bucket_s = time.perf_counter() - t1
    g2_got = g2.to_host_points(g2.scalar_mul(g2.from_host_points(g2_points, "cuda"),
                                             g1.scalars_to_bits(scalars[:G2_POINTS], "cuda")))
    p = g1.from_affine_points(small, "cuda")
    summed = g1.to_affine_points(g1.add(p, g1.double(p)))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = _read_counts("curve", _CURVE_KERNELS)
    if windowed != want or bucket != want:
        raise AssertionError("msm / msm_bucket differ from the host oracle")
    if g2_got != [host.g2_mul(q, k) for q, k in zip(g2_points, scalars)]:
        raise AssertionError("g2.scalar_mul differs from the host g2_mul")
    if summed != [host.g1_mul(q, 3) for q in small]:
        raise AssertionError("g1.add(P, g1.double(P)) differs from the host 3·P")
    # msm_bucket's wall time split: the host input, the kernels, the host output
    t0 = time.perf_counter()
    w = g1.default_window_bits(len(points))
    pb, db = g1.bucket_inputs(points, scalars, w, "cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = g1.msm_bucket_jacobian(pb, db, w)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    split = g1.to_affine_points(tuple(c[None] for c in out))[0]
    t3 = time.perf_counter()
    if split != want:
        raise AssertionError("msm_bucket's stages, called one by one, differ from the oracle")
    _log(f"curve path: msm_bucket at {len(points)} points {bucket_s:.3f} s; called stage by "
         f"stage: bucket_inputs (host GLV split, digits, limbs) {t1 - t0:.3f} s, C3's kernels "
         f"{t2 - t1:.6f} s, to_affine_points {t3 - t2:.6f} s")
    _log(f"curve path: msm and msm_bucket at {len(points)} points, g2.scalar_mul on "
         f"{len(g2_points)}, g1.add and g1.double on {len(small)} in {wall_s:.3f} s (host input and output included); each equals "
         f"the host")
    return launches


def phase_node(tmp: Path) -> dict:
    """The port's HTTP service on the card: ``POST /prove/bad-share`` of the
    pre-curve 7-of-10 scenario (launch counts reset before the request, read
    after it), its spec route, ``execute``, an unknown type and a malformed
    body; then the CLI's ``get-schema`` and ``validate-schema`` in-process."""
    import threading
    import urllib.error
    import urllib.request

    from dvt_circuits_tpu_torch import cli
    from dvt_circuits_tpu_torch.circuits.registry import get_circuit
    from dvt_circuits_tpu_torch.dkg.schemas import schema_for
    from dvt_circuits_tpu_torch.prover.pipeline import prove_circuit
    from dvt_circuits_tpu_torch.service.node import make_server
    from dvt_circuits_tpu_torch.stark.config import DEFAULT_CONFIG

    data = _bad_share_scenario()
    body = json.dumps(data.to_json(True)).encode()
    schema = schema_for("SharedData", get_circuit("bad-share").setup.layout, True)

    def request(method: str, path: str, payload=None):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=payload,
                                     method=method)
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    server = make_server("127.0.0.1", 0, True, device="cuda")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        _reset_counts()
        t0 = time.perf_counter()
        status, proved = request("POST", "/prove/bad-share", body)
        wall_s = time.perf_counter() - t0
        launches = _read_counts("node", _K1_PROVE)
        if status != 200 or proved.get("status") != "proved":
            raise AssertionError(f"POST /prove/bad-share: {status} {proved}")
        direct = prove_circuit("bad-share", data, True, DEFAULT_CONFIG, device="cuda")
        if proved["public_values"] != direct["public_values"]:
            raise AssertionError("the node's public_values differ from prove_circuit's")
        _log(f"node: POST /prove/bad-share (7-of-10 pre-curve) 200 proved in {wall_s:.3f} s "
             f"(timing {proved['timing']}); public_values equal prove_circuit's")
        if request("GET", "/prove/bad-share/spec") != (200, {"status": "ok", "schema": schema}):
            raise AssertionError("GET /prove/bad-share/spec differs from schema_for")
        checks = [(("POST", "/execute/bad-share", body), 200),
                  (("POST", "/execute/no-such-circuit", body), 500),
                  (("POST", "/execute/bad-share", b"{not json"), 500)]
        for args, code in checks:
            got = request(*args)
            if got[0] != code:
                raise AssertionError(f"{args[0]} {args[1]}: {got}, expected {code}")
        _log("node: spec route equals schema_for; execute 200; unknown type and malformed "
             "body 500")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("the node's server thread did not stop")

    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = cli.run(["--auth-commitment", "get-schema", "--type=bad-share",
                      "--schema-type=json"])
    if rc != 0 or json.loads(out.getvalue()) != schema:
        raise AssertionError("CLI get-schema differs from schema_for")
    (tmp / "schema.json").write_text(json.dumps(schema))
    (tmp / "scenario.json").write_text(body.decode())
    (tmp / "wrong.json").write_text('{"wrong": 1}')
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        rcs = [cli.run(["validate-schema", "-s", str(tmp / "schema.json"), "-j",
                        str(tmp / name)]) for name in ("scenario.json", "wrong.json")]
    if rcs != [0, 1]:
        raise AssertionError(f"CLI validate-schema exit codes {rcs}, expected [0, 1]")
    _log("CLI in-process: get-schema equals schema_for; validate-schema accepts the scenario "
         "(0) and rejects {\"wrong\": 1} (1)")
    return launches


#: seconds the ranks of phase ``dist`` may take, spawned to the last one joined
DIST_TIMEOUT = 900
#: most ranks phase ``dist`` spawns
DIST_MAX_WORLD = 4


#: phase ``dist``'s EP tables, padded to one shape: random standard-form
#: words in the shapes of the 7-of-10 tables (stream, SHA-256, the curve
#: fault's g1mul, ChaCha20); and its PP batch of microbatches (SHA-256 table
#: shaped)
EP_SHAPES = ((1 << 11, 32), (1 << 10, 336), (1 << 12, 4314), (1 << 7, 1080))
PP_BATCH = (8, 1 << 12, 336)


def _ep_pp_inputs():
    """(padded EP tables (K, n, w), PP traces (B, n, w)) from a numpy seed."""
    from dvt_circuits_tpu_torch.field.babybear import P
    from dvt_circuits_tpu_torch.parallel.ep_tables import pad_tables

    rng = np.random.default_rng(SEED + 13)
    ragged = [rng.integers(0, P, size=shape, dtype=np.uint32) for shape in EP_SHAPES]
    return pad_tables(ragged), rng.integers(0, P, size=PP_BATCH, dtype=np.uint32)


def _pp_levels(n_lde: int, stages: int) -> list:
    """The compression levels of each reduce stage (2..S−1) of
    ``pp_commit_pipeline``: log2(n_lde) split by divmod, the earlier stages
    taking the extra level."""
    base, extra = divmod(n_lde.bit_length() - 1, stages - 2)
    return [base + (1 if i < extra else 0) for i in range(stages - 2)]


def _dist_rank(rank: int, world: int, cases: dict) -> dict:
    """One rank of phase ``dist`` (NCCL, card ``rank``): each sharded path
    with the launch counts set to 0 just before it and read just after,
    with the trees it committed, its wall time and its peak device memory.
    Containers come back as digests (rank 0's also whole)."""
    from dvt_circuits_tpu_torch.curve import g1
    from dvt_circuits_tpu_torch.parallel import dist_stark
    from dvt_circuits_tpu_torch.parallel.ep_tables import ep_commit_tables
    from dvt_circuits_tpu_torch.parallel.mesh import Mesh
    from dvt_circuits_tpu_torch.parallel.pp_pipeline import pp_commit_pipeline
    from dvt_circuits_tpu_torch.prover import pipeline
    from dvt_circuits_tpu_torch.stark import prover
    from dvt_circuits_tpu_torch.stark.config import DEFAULT_CONFIG

    os.environ["DVT_DIST"] = "1"  # shard over the group even at world 1
    out = {}

    def run(name: str, fn, phases=None):
        _reset_counts()
        with _TreeCount() as trees, _phase_memory(phases or []) as rows:
            t0 = time.perf_counter()
            value = fn()
            torch.cuda.synchronize()
        rec = {"s": time.perf_counter() - t0, "trees": trees.trees,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches": {n: f.launches for n, f in _wrappers().items()}}
        if phases:
            rec["phases"] = {}
            for phase, _, ms, _, _ in rows:
                rec["phases"][phase] = rec["phases"].get(phase, 0.0) + ms
        if isinstance(value, dict):
            rec["timing"], rec["digest"] = value["timing"], pipeline.container_digest(value)
            if rank == 0:
                rec["container"] = value
        elif isinstance(value, list):
            rec["digest"] = [pipeline.container_digest(c) for c in value]
        else:
            rec["value"] = value
        out[name] = rec

    def prove(circuit, data):
        return lambda: pipeline.prove_circuit(circuit, data, True, DEFAULT_CONFIG, device="cuda")

    run("curve-fault cold", prove("bad-share", cases["curve"]))
    run("curve-fault", prove("bad-share", cases["curve"]))
    os.environ["DVT_EP"] = "1"
    run("curve-fault EP", prove("bad-share", cases["curve"]))
    del os.environ["DVT_EP"]
    batch_mesh = Mesh({"dp": world, "sp": 1}, "cuda")
    run("prove_batch", lambda: pipeline.prove_batch("bad-share", cases["batch"], True,
                                                    DEFAULT_CONFIG, mesh=batch_mesh))
    mesh = Mesh({"sp": world}, "cuda")
    run("dist_msm", lambda: g1.dist_msm(*cases["msm"], mesh))
    ep_tables, pp_traces = _ep_pp_inputs()
    if len(ep_tables) % world == 0:
        ep_mesh = Mesh({"ep": world}, "cuda")
        run("ep_commit_tables", lambda: ep_commit_tables(ep_tables, ep_mesh).cpu())
    pp_mesh = Mesh({"pp": world}, "cuda")
    if world >= 3:
        run("pp_commit_pipeline", lambda: pp_commit_pipeline(pp_traces, pp_mesh).cpu())
    else:
        try:
            pp_commit_pipeline(pp_traces, pp_mesh)
        except ValueError as e:
            out["pp refused"] = str(e)
    if world >= 2:
        run("finalization", prove("finalization", cases["finalization"]))
        # each sharded layout's phase (and any table proven on one card) timed
        phases = ([(dist_stark.RowBlocks, name) for name in ("lde", "tree", "quotient",
                                                              "openings")]
                  + [(prover, "deep_body"), (prover, "fri_prove"), (pipeline, "stark_prove")])
        run("finalization, phases timed", prove("finalization", cases["finalization"]), phases)
    return out


def _check_ep_pp(rank: int, world: int, name: str, rec: dict, want: dict, n_tables: int,
                 pp_shape) -> None:
    """One rank's EP or PP run: roots equal to the single-card ones; EP's
    leaf sponge one launch a table of the rank, with its levels; PP's stage
    kernels on their ranks alone (stage 1 one leaf-sponge launch a
    microbatch, each reduce stage one K1a launch a level a microbatch)."""
    counts = rec["launches"]
    k1 = {k: v for k, v in counts.items() if k.startswith("poseidon2_") and v}
    if name == "ep_commit_tables":
        roots, per = want["ep"], n_tables // world
        ok = (counts["poseidon2_hash_rows"] == per == rec["trees"]
              and counts["poseidon2_merkle_levels"] > 0)
    else:
        roots = want["pp"]
        batch, n, _ = pp_shape
        expected = {}
        if rank == 1:
            expected = {"poseidon2_hash_rows": batch}
        elif rank >= 2:
            expected = {"poseidon2_permute": batch * _pp_levels(n << 1, world)[rank - 2]}
        ok = k1 == expected
    _log(f"dist rank {rank} {name}: {rec['s']:.3f} s, device memory peak {rec['peak_gib']:.3f} "
         f"GiB, {rec['trees']} trees, K1 launches {k1}")
    if rec["value"].tolist() != roots:
        raise AssertionError(f"dist rank {rank} {name}: roots differ from the single-card ones")
    if not ok:
        raise AssertionError(f"dist rank {rank} {name}: K1 launches {k1} are not the stages' "
                             f"({rec['trees']} trees)")


def _dist_reference(circuit: str, data, kept) -> dict:
    """A single-card container of ``data``: ``kept`` (an earlier phase's) or
    proven here."""
    from dvt_circuits_tpu_torch.prover.pipeline import prove_circuit
    from dvt_circuits_tpu_torch.stark.config import DEFAULT_CONFIG

    if kept is None:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        kept = prove_circuit(circuit, data, True, DEFAULT_CONFIG, device="cuda")
        _log(f"dist: single-card {circuit} reference proven here in "
             f"{time.perf_counter() - t0:.3f} s, timing {kept['timing']}, device memory peak "
             f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return kept


def phase_dist(com, curve_data, curve_container, fin_container, tmp: Path) -> dict:
    """The sharded prover over NCCL, one rank a card on min(cards, 4) cards:
    the 7-of-10 curve fault sharded (cold, warm, and with ``DVT_EP=1``),
    ``prove_batch`` of two scenarios over ``dp``, ``dist_msm`` at 4,096
    points, the EP and PP commit demos (PP from three cards), and, on two
    cards or more, finalization 7-of-10 sharded; each container and root
    equal to the single-card one on every rank, the sharded curve fault
    accepted by the strict verifier on the card, every rank's leaf sponge
    one launch a tree; then the CLI ``prove`` and ``verify --show-report``
    under ``torchrun``.  Returns rank 0's launch counts, summed over its
    paths."""
    from dvt_circuits_tpu_torch.curve import g1
    from dvt_circuits_tpu_torch.ntt.ntt import coset_lde
    from dvt_circuits_tpu_torch.parallel.mesh import spawn
    from dvt_circuits_tpu_torch.pcs.merkle import merkle_root
    from dvt_circuits_tpu_torch.prover.pipeline import container_digest, load_proof, verify_proof

    world = min(torch.cuda.device_count(), DIST_MAX_WORLD)
    second = com.shared_data_bad_secret(1, 2, True)
    curve_container = _dist_reference("bad-share", curve_data, curve_container)
    n_tables = 1 + len(curve_container["gadgets"])
    want = {"curve": container_digest(curve_container),
            "second": container_digest(_dist_reference("bad-share", second, None))}
    points, scalars, oracle = _bench_points(MSM_POINTS[-1])
    single_msm = g1.msm(points, scalars, device="cuda")
    if single_msm != oracle:
        raise AssertionError("g1.msm differs from the host oracle at 4,096 points")
    cases = {"curve": curve_data, "batch": [curve_data, second], "msm": (points, scalars)}
    if world >= 2:
        fin_data = com.finalization_data()
        want["finalization"] = container_digest(
            _dist_reference("finalization", fin_data, fin_container))
        cases["finalization"] = fin_data
    else:
        _log("dist: one card on this machine, so the ranks run at world 1 over NCCL; sp > 1 "
             "is not exercised here (the CPU tests hold sp = 2, 4 and 8 over Gloo), nor "
             "the sharded finalization")
    # the EP and PP roots on one card: each padded table's and each
    # microbatch's coset LDE (blowup 2, the demos' default) and merkle_root
    ep_tables, pp_traces = _ep_pp_inputs()
    for key, mats in (("ep", ep_tables), ("pp", pp_traces)):
        want[key] = [merkle_root(coset_lde(torch.as_tensor(m.astype(np.int64), device="cuda"), 1))
                     for m in mats]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # rank 0 shares card 0 with this process
    t0 = time.perf_counter()
    ranks = spawn(_dist_rank, world, backend="nccl", device="cuda", timeout=DIST_TIMEOUT,
                  args=(cases,))
    _log(f"dist: {world} NCCL rank(s) spawned, every path run and joined in "
         f"{time.perf_counter() - t0:.3f} s")

    expected = {"curve-fault cold": _K1_PROVE, "curve-fault": _K1_PROVE,
                "curve-fault EP": _K1_PROVE, "prove_batch": _K1_PROVE,
                # one partial a rank: the fold of the partials (C1) needs two
                "dist_msm": ("g1_msm_windowed",) + (("fp_mont_mul",) if world >= 2 else ()),
                "finalization": _K1_PROVE, "finalization, phases timed": _K1_PROVE}
    digests = {"curve-fault cold": want["curve"], "curve-fault": want["curve"],
               "curve-fault EP": want["curve"], "prove_batch": [want["curve"], want["second"]],
               "finalization": want.get("finalization"),
               "finalization, phases timed": want.get("finalization")}
    pp_refused = [out.pop("pp refused", None) for out in ranks]
    if world < 3:
        if pp_refused != ["pipeline needs at least 3 stages (lde, hash, reduce)"] * world:
            raise AssertionError(f"dist: pp_commit_pipeline at S = {world}: {pp_refused}")
        _log(f"dist: pp_commit_pipeline not run: S = {world} < 3 stages raises "
             f"ValueError({pp_refused[0]!r}) on every rank (four cards run it)")
    if len(ep_tables) % world:
        _log(f"dist: ep_commit_tables not run: {len(ep_tables)} tables do not split over "
             f"{world} ranks")
    for rank, out in enumerate(ranks):
        for name, rec in out.items():
            counts = rec["launches"]
            if name in ("ep_commit_tables", "pp_commit_pipeline"):
                _check_ep_pp(rank, world, name, rec, want, len(ep_tables), pp_traces.shape)
                continue
            k1 = sum(v for k, v in counts.items() if k.startswith("poseidon2_"))
            extra = f", prove_ms {rec['timing']['prove_ms']}" if "timing" in rec else ""
            if "phases" in rec:
                extra += ", phases (ms, synchronized) " + ", ".join(
                    f"{k} {v:.3f}" for k, v in rec["phases"].items())
            _log(f"dist rank {rank} {name}: {rec['s']:.3f} s{extra}, device memory peak "
                 f"{rec['peak_gib']:.3f} GiB, {rec['trees']} trees, K1 launches {k1} "
                 f"{ {k: v for k, v in counts.items() if v} }")
            # prove_batch's dp groups past the batch's length prove nothing,
            # and nor do EP's ranks past one range a table
            idle = ((name == "prove_batch" and rank >= len(cases["batch"]))
                    or (name == "curve-fault EP" and rank >= n_tables))
            missing = [k for k in expected[name] if counts[k] == 0 and not idle]
            if missing:
                raise AssertionError(f"dist rank {rank} {name}: kernels {missing} not launched")
            if name != "dist_msm" and counts["poseidon2_hash_rows"] != rec["trees"]:
                raise AssertionError(f"dist rank {rank} {name}: {counts['poseidon2_hash_rows']} "
                                     f"leaf-sponge launches for {rec['trees']} trees")
            if name == "dist_msm":
                if rec["value"] != single_msm:
                    raise AssertionError(f"dist rank {rank}: dist_msm differs from g1.msm")
            elif rec["digest"] != digests[name]:
                raise AssertionError(f"dist rank {rank} {name}: container differs from the "
                                     f"single-card one")
    _log(f"dist: ep_commit_tables of {len(ep_tables)} padded tables "
         f"{tuple(ep_tables.shape[1:])}"
         + (f" over ep = {world}" if len(ep_tables) % world == 0 else " (not run)")
         + (f" and pp_commit_pipeline of {pp_traces.shape[0]} microbatches "
            f"{tuple(pp_traces.shape[1:])} over S = {world} stages" if world >= 3 else "")
         + " give the single-card merkle_root of every coset LDE on every rank")
    _log(f"dist: on {world} rank(s) the sharded curve fault (cold, warm, DVT_EP=1), "
         f"prove_batch over dp = {world}"
         + (" and finalization 7-of-10" if world >= 2 else "")
         + " equal the single-card containers on every rank; dist_msm at 4,096 points equals "
           "g1.msm and the host oracle; leaf sponge one launch a tree on every rank")
    res = verify_proof(ranks[0]["curve-fault"]["container"], "bad-share", strict=True,
                       device="cuda")
    if (res.binding, res.g1_relations) != ("curve-bound+sig", 1):
        raise AssertionError(f"the port's verifier returned {res} for the sharded curve fault")
    _log(f"dist: the sharded curve-fault container verifies on cuda: {res}")

    # the CLI as a user runs it on this host's cards
    scenario, proof = tmp / "dist_scenario.json", tmp / "dist_proof.bin"
    scenario.write_text(json.dumps(curve_data.to_json(True)))
    env = dict(os.environ, DVT_DIST="1" if world == 1 else "auto")
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={world}", "-m", "dvt_circuits_tpu_torch.cli", "--auth-commitment"]
    for args in (["prove", "--type=bad-share", "-i", str(scenario), "-o", str(proof)],
                 ["verify", "--type=bad-share", "-i", str(proof), "--show-report",
                  "--require-curve-binding"]):
        t0 = time.perf_counter()
        res = subprocess.run(run + args, cwd=ROOT, env=env, capture_output=True, text=True,
                             timeout=600)
        if res.returncode != 0:
            raise AssertionError(f"torchrun CLI {args[0]} exited {res.returncode}:\n"
                                 f"{res.stdout[-4000:]}\n{res.stderr[-4000:]}")
        fingerprints = [ln for ln in res.stdout.splitlines() if "keccak256: " in ln.lower()]
        if len(fingerprints) != 1:
            raise AssertionError(f"torchrun CLI {args[0]}: {len(fingerprints)} fingerprint "
                                 f"lines (rank 0 alone prints)")
        _log(f"dist: torchrun --nproc-per-node={world} CLI {args[0]}: exit 0 in "
             f"{time.perf_counter() - t0:.3f} s")
    if container_digest(load_proof(str(proof))) != want["curve"]:
        raise AssertionError("the torchrun CLI's proof differs from the single-card container")
    if "binding: curve-bound+sig" not in res.stdout:
        raise AssertionError("torchrun CLI verify did not report curve-bound+sig")
    _log("dist: the torchrun CLI's proof file equals the single-card container; verify "
         "reports curve-bound+sig")
    summed = {}
    for rec in ranks[0].values():
        for k, v in rec["launches"].items():
            summed[k] = summed.get(k, 0) + v
    return summed


#: the phases ``--only`` may name, in the order they run
PHASES = ("kernels", "curve", "pre-curve", "probe", "keccak-f", "curve-fault",
          "encrypted-share", "finalization", "dist", "g1-breakdown", "g1-chip", "gpu-cpu",
          "cli-curve", "node")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run (default: all; a partial run prints "
                         "no kernels line and no result line)")
    only = set(ap.parse_args(argv).only.split(","))
    if not only <= set(PHASES):
        ap.error(f"unknown phases {sorted(only - set(PHASES))}; known: {', '.join(PHASES)}")
    full = only == set(PHASES)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a CUDA card",
              file=sys.stderr)
        return 2
    try:
        from dvt_circuits_tpu_torch import kernels, probe_vpu
        from dvt_circuits_tpu_torch.dkg.scenario_gen import DkgCommittee
        from dvt_circuits_tpu_torch.hash import keccak as kk
        from dvt_circuits_tpu_torch.hash import poseidon2 as p2
    except ImportError as e:
        print(f"chip_smoke: the port package is missing next to this script: {e}",
              file=sys.stderr)
        return 2

    card = _card_line()
    _log(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = kernels.build_all()
    _log(f"kernels built in {time.perf_counter() - t0:.3f} s: {', '.join(kernels.KERNEL_SOURCES)}")
    for name, what in (("poseidon2", "K1"), ("curve", "C1-C4")):
        _log(f"{what} build report (nvcc -Xptxas -v): " + " | ".join(
            ln.strip() for ln in kernels.build_log(name).splitlines()
            if any(key in ln for key in ("registers", "spill", "Compiling entry", "stack",
                                         "Function properties"))))
    usage = resource_usage(libs["curve"])
    for kernel, use in sorted(usage.items()):
        _log(f"C1-C4 resource usage (cuobjdump) {kernel}: REG {use['REG']} STACK {use['STACK']} "
             f"LOCAL {use['LOCAL']} SHARED {use['SHARED']}")
    c1 = usage["fp_mont_mul_kernel"]
    if c1["STACK"] or c1["LOCAL"]:
        raise AssertionError(f"C1's kernel uses local memory: {c1}")
    work = kernel_work(libs)
    floor_ms = launch_floor_ms()
    _log(f"launch floor (fastest in-place op on a one-element CUDA tensor): {floor_ms:.6f} ms")

    records = []
    if "kernels" in only:
        records = [phase_poseidon2(p2), phase_sponge(p2), phase_levels(p2), phase_grind(p2),
                   *phase_keccak(kk, floor_ms), phase_mulchain(probe_vpu, work["mulchain"])]
    if "curve" in only:
        records += phase_curve_kernels()
    records = [with_floor(rec, floor_ms) for rec in records]
    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        if "pre-curve" in only:
            by_path["bad-share pre-curve"] = phase_main_path(p2, kk, Path(tmp))
        if "probe" in only:
            by_path["probe"] = phase_probe_path()
        if "keccak-f" in only:
            by_path["keccak-f"] = phase_keccak_f_path(kk)
        com = DkgCommittee(10, 7)
        curve_data = com.shared_data_bad_secret(0, 1, True)
        if "curve" in only:
            by_path["curve"] = phase_curve_package()
        curve_container = fin_container = None
        if "curve-fault" in only:
            curve_container, by_path["bad-share curve"], by_path["bad-share verify"] = (
                phase_curve_path("bad-share", curve_data, [256] + [32] * 6, 12, 1))
            _, by_path["bad-partial-key"], by_path["bad-partial-key verify"] = phase_curve_path(
                "bad-partial-key", com.bad_partial_key_data(1, True), [32] * 6, 11, 2)
        if "encrypted-share" in only:
            by_path.update(phase_encrypted_share(kk, Path(tmp)))
        if "finalization" in only:
            fin_container, by_path["finalization"], by_path["finalization verify"] = (
                phase_curve_path("finalization", com.finalization_data(), None, 16, com.n,
                                 profiled=False))
        if "dist" in only:
            by_path["dist"] = phase_dist(com, curve_data, curve_container, fin_container,
                                         Path(tmp))
            curve_container = fin_container = None
        if "g1-breakdown" in only:
            phase_g1_breakdown()
        if "g1-chip" in only:
            by_path["g1-chip"], by_path["g1-chip verify"] = phase_g1_chip(p2)
        if "gpu-cpu" in only:
            phase_gpu_equals_cpu()
        if "cli-curve" in only:
            phase_cli_curve(kk, curve_data, Path(tmp))
        if "node" in only:
            by_path["node"] = phase_node(Path(tmp))
    if not full:
        _log(f"partial run ({', '.join(p for p in PHASES if p in only)}): every check passed")
        return 0
    # the record's count: the path each kernel serves (K3: the probe; K2b
    # the fingerprint of the pre-curve path; K2, the permutation's own entry
    # point, since K2b took the fingerprint)
    main_path = {"keccak_f1600": "keccak-f", "keccak_sponge": "bad-share pre-curve",
                 "mulchain": "probe", **{name: "curve" for name in _CURVE_KERNELS}}
    for rec in records:
        rec["launches"] = by_path[main_path.get(rec["name"], "bad-share curve")][rec["name"]]
        rec["launches_by_path"] = {path: counts[rec["name"]] for path, counts in by_path.items()}

    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
