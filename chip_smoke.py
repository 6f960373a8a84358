#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dvt_circuits_tpu_torch``) on one
NVIDIA GPU — the quickest proof that the port still builds and proves there.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

  1. require a CUDA card; print its name and power limit (nvidia-smi);
  2. build every kernel from ``dvt_circuits_tpu_torch/csrc`` (one nvcc per
     source, in parallel);
  3. K1 (Poseidon2): kernel vs plain PyTorch on 2^20 random states plus
     all-0 / all-(p−1) rows and at the prover's shapes, bit-equal; 16 rows
     vs the scalar ``s_permute``; CUDA-event timings;
  4. K2 (Keccak-f[1600]): kernel vs plain on 2^16 states, bit-equal;
     Keccak-256 / SHA3-256 known digests; timings;
  5. the main path: ``prove_circuit("bad-share")`` at ``DEFAULT_CONFIG`` for
     a 10-operator, 7-of-10 committee whose seed exchange names a
     destination outside the committee (the guest slashes before the
     curve check), cold then warm, with launch counts; the container's
     fingerprint through K2; Merkle openings re-checked with the scalar
     permutation; the same proof on the CPU (plain path) must give equal
     container bytes without ``timing``; the CLI ``prove`` as a subprocess;
  6. one ``{"kernels": [...]}`` line, the card line, and as the last line
     ``{"ok": true, "device": {...}}``.

Randomness comes from numpy with fixed seeds.  Bounds: bytes each kernel
must move over 3.35 TB/s, and its integer instructions (counted in the
compiled SASS, ``kernel_work``) over the int32 instruction rate (see
``_INT32_OPS_PER_S``); the larger of the two.
"""

from __future__ import annotations

import hashlib
import json
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

#: bytes each permutation must move: K1 16 int64 words in and out, K2 25
K1_BYTES_PER_PERM = 2 * 16 * 8
K2_BYTES_PER_PERM = 2 * 25 * 8
#: integer ALU opcodes counted as work in the compiled kernels
_INT_OPCODES = {"IMAD", "IADD3", "ISETP", "VIADD", "SHF", "LOP3", "SEL", "IMNMX", "LEA", "PRMT"}

SEED = 20261016


def _log(msg: str) -> None:
    print(msg, flush=True)


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


def _sass_opcodes(lib) -> dict:
    """Opcode counts (base names) of a built kernel library, from
    ``cuobjdump -sass``."""
    from dvt_circuits_tpu_torch import kernels

    tool = Path(kernels._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    counts: dict = {}
    for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", sass):
        counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return counts


def kernel_work(libs: dict) -> dict:
    """Integer instructions per permutation, from the compiled SASS: K1 is
    straight-line code (one thread per state), so its static count is its
    work; K2 loops over 24 rounds, so its work is 24 × the LOP3 and SHF of
    the round body (its only logic instructions)."""
    k1 = _sass_opcodes(libs["poseidon2"])
    k2 = _sass_opcodes(libs["keccak"])
    work = {
        "poseidon2_permute": sum(v for k, v in k1.items() if k in _INT_OPCODES),
        "keccak_f1600": 24 * (k2.get("LOP3", 0) + k2.get("SHF", 0)),
    }
    _log(f"SASS integer instructions per permutation: {work} "
         f"(K1 opcodes {dict(sorted(k1.items(), key=lambda kv: -kv[1])[:6])})")
    if min(work.values()) == 0:
        raise AssertionError("no integer instructions found in the kernels' SASS")
    return work


def _bound_ms(n: int, ops_per: int, bytes_per: int):
    t_ops = n * ops_per / _INT32_OPS_PER_S
    t_bytes = n * bytes_per / _BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _max_abs_err_u64(a, b) -> int:
    """Largest |a − b| over the 64-bit lanes read as unsigned, compared in
    32-bit halves (int64 differences would overflow)."""
    err = 0
    for shift in (0, 32):
        ha, hb = (a >> shift) & 0xFFFFFFFF, (b >> shift) & 0xFFFFFFFF
        err = max(err, int((ha - hb).abs().max()) << shift)
    return err


def phase_poseidon2(p2, ops_per_perm: int):
    """K1 vs its plain version; returns the kernel record (launches filled later)."""
    P = p2.bb.P
    rng = np.random.default_rng(SEED)
    host = rng.integers(0, P, (1 << 20, 16), dtype=np.int64)
    host = np.concatenate([host, np.zeros((1, 16), np.int64), np.full((1, 16), P - 1, np.int64)])
    x = torch.as_tensor(host, device="cuda")
    out = p2.poseidon2_permute(x)
    plain = p2.permute_plain(x)
    k1_err = int((out - plain).abs().max())
    if k1_err:
        raise AssertionError("K1 disagrees with permute_plain on 2^20+2 states")
    out_h = out.cpu().numpy()
    for i in list(range(14)) + [len(host) - 2, len(host) - 1]:
        if out_h[i].tolist() != p2.s_permute(host[i].tolist()):
            raise AssertionError(f"K1 disagrees with s_permute on row {i}")
    _log("K1 poseidon2: bit-equal to permute_plain on 2^20+2 states; 16 rows equal s_permute")

    rows = []
    for n, reps in ((1, 200), (1 << 13, 200), (1 << 16, 100), (1 << 20, 20)):
        xs = x[:n].contiguous()
        if not torch.equal(p2.poseidon2_permute(xs), p2.permute_plain(xs)):
            raise AssertionError(f"K1 disagrees with permute_plain at N={n}")
        ms = _time_ms(lambda: p2.poseidon2_permute(xs), reps)
        plain_ms = _time_ms(lambda: p2.permute_plain(xs), max(2, reps // 20), warmup=1)
        bound, by = _bound_ms(n, ops_per_perm, K1_BYTES_PER_PERM)
        rows.append((n, ms, plain_ms, bound, by))
        _log(f"K1 N={n:>8}: kernel {ms:.6f} ms ({n / ms * 1e3:.4e} perm/s), "
             f"plain {plain_ms:.6f} ms, bound {bound:.6f} ms ({by})")
    # the record carries the proof-of-work grind's batch shape (2^16 states)
    n, ms, plain_ms, bound, by = rows[2]
    return {
        "name": "poseidon2_permute",
        "route": "cuda",
        "source": "dvt_circuits_tpu_torch/csrc/poseidon2.cu",
        "replaces": "dvt_circuits_tpu/hash/poseidon2_pallas.py:71",
        "shape": [n, 16],
        "launches": None,
        "max_abs_err": k1_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
    }


def phase_keccak(kk, ops_per_perm: int):
    rng = np.random.default_rng(SEED + 1)
    y = torch.as_tensor(
        rng.integers(-(1 << 63), (1 << 63) - 1, (1 << 16, 25), dtype=np.int64), device="cuda"
    )
    k2_err = _max_abs_err_u64(kk.keccak_f1600(y), kk.keccak_f1600_plain(y))
    if k2_err:
        raise AssertionError("K2 disagrees with keccak_f1600_plain on 2^16 states")
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
    _log("K2 keccak: bit-equal to keccak_f1600_plain on 2^16 states; known digests match")
    rows = []
    for n, reps in ((1, 200), (1 << 16, 50)):
        ys = y[:n].contiguous()
        ms = _time_ms(lambda: kk.keccak_f1600(ys), reps)
        plain_ms = _time_ms(lambda: kk.keccak_f1600_plain(ys), max(2, reps // 20), warmup=1)
        bound, by = _bound_ms(n, ops_per_perm, K2_BYTES_PER_PERM)
        rows.append((n, ms, plain_ms, bound, by))
        _log(f"K2 N={n:>8}: kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, "
             f"bound {bound:.9f} ms ({by})")
    # the record carries the prover's shape: one state per fingerprint
    n, ms, plain_ms, bound, by = rows[0]
    return {
        "name": "keccak_f1600",
        "route": "cuda",
        "source": "dvt_circuits_tpu_torch/csrc/keccak.cu",
        "replaces": "dvt_circuits_tpu/hash/keccak.py:105",
        "shape": [n, 25],
        "launches": None,
        "max_abs_err": k2_err,
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
    from dvt_circuits_tpu_torch.hash.poseidon2 import s_permute
    from dvt_circuits_tpu_torch.utils.packing import unpack_u32

    def leaf(row):
        state = [0] * 16
        for off in range(0, len(row), 8):
            chunk = row[off : off + 8]
            state[:8] = chunk + [0] * (8 - len(chunk))
            state = s_permute(state)
        return state[:8]

    n_lde = 1 << proof["fri"]["log_n"]
    for q, op in list(zip(proof["fri"]["queries"], proof["query_openings"]))[:n_checked]:
        for name in ("t", "q", "p"):
            if name not in op:
                continue
            root = proof[f"root_{name}"]
            for side, index in (("lo", q["index"]), ("hi", q["index"] + n_lde // 2)):
                row = [int(v) for v in unpack_u32(op[name][side]["row"])]
                path = unpack_u32(op[name][side]["path"]).reshape(-1, 8)
                digest, idx = leaf(row), index
                for sib in path:
                    sib = [int(v) for v in sib]
                    pair = sib + digest if idx & 1 else digest + sib
                    digest = s_permute(pair)[:8]
                    idx >>= 1
                if digest != root:
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


def phase_main_path(p2, kk, tmp: Path):
    from dvt_circuits_tpu_torch import cli
    from dvt_circuits_tpu_torch.prover.pipeline import container_digest, prove_circuit, save_proof
    from dvt_circuits_tpu_torch.stark.config import DEFAULT_CONFIG

    data = _bad_share_scenario()

    # -- the measured run: counts reset just before, read just after -------
    p2.poseidon2_permute.launches = 0
    kk.keccak_f1600.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    container = prove_circuit("bad-share", data, True, DEFAULT_CONFIG, device="cuda")
    proof_path = tmp / "proof.bin"
    save_proof(container, str(proof_path))
    fingerprint = cli._artifact_fingerprint(str(proof_path), device="cuda")
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = {"poseidon2_permute": p2.poseidon2_permute.launches,
                "keccak_f1600": kk.keccak_f1600.launches}
    _log(f"main path (cold): prove+save+fingerprint {cold_s:.3f} s, timing {container['timing']}, "
         f"launches {launches}")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")

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

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
        raise AssertionError("K2 fingerprint differs from the plain Keccak")

    scenario = tmp / "scenario.json"
    scenario.write_text(json.dumps(data.to_json(True)))
    cli_out = tmp / "cli_proof.bin"
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "dvt_circuits_tpu_torch.cli", "--auth-commitment", "prove",
         "--type=bad-share", "-i", str(scenario), "-o", str(cli_out)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    cli_s = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"CLI prove exited {res.returncode}:\n{res.stdout}\n{res.stderr}")
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("Artifact keccak256: ")]
    expected = kk.keccak256_batch(
        [hashlib.sha256(cli_out.read_bytes()).digest()], device="cpu"
    )[0].hex()
    if len(line) != 1 or line[0].split(": ", 1)[1] != expected:
        raise AssertionError(f"CLI fingerprint line {line} != plain Keccak {expected}")
    _log(f"CLI prove subprocess: exit 0 in {cli_s:.3f} s, fingerprint matches the plain Keccak")
    return launches, {"cold_s": cold_s, "warm_s": warm_s, "cpu_s": cpu_s,
                      "warm_timing": warm["timing"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a CUDA card",
              file=sys.stderr)
        return 2
    try:
        from dvt_circuits_tpu_torch import kernels
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
    work = kernel_work(libs)

    records = [phase_poseidon2(p2, work["poseidon2_permute"]),
               phase_keccak(kk, work["keccak_f1600"])]
    with tempfile.TemporaryDirectory() as tmp:
        launches, _ = phase_main_path(p2, kk, Path(tmp))
    for rec in records:
        rec["launches"] = launches[rec["name"]]

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
