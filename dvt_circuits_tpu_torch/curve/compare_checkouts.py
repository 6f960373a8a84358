"""Time kernels C1–C4 (``csrc/curve.cu``) of another checkout of the port
beside this one's, in turns on one card: how a redesign is held against its
parent.

    python3 dvt_circuits_tpu_torch/curve/compare_checkouts.py --other build/parent

Run from the root of a checkout, on a machine with a CUDA card.  ``--other``
names a directory holding another ``dvt_circuits_tpu_torch`` (for the parent
commit: ``git archive <parent> dvt_circuits_tpu_torch | tar -x -C
build/parent``, a git-ignored directory).  Both build their kernels at
once, one process each; then each is timed in a process of its own, other,
this, this, other.  Each first checks its results (C1 against
``mont_mul_plain`` on a sample and the edge rows, C2, C3 and C4 against the
host oracle), then times, with CUDA-event means after warm-up (ms), C1 on
1,024, 2^16 and 2^20 products (``chip_smoke.c1_timed``: the call, and the
kernel alone, raw launches through ctypes), C2 at 1,024 and 4,096 points, C3 at 4,096 points and C4
at 16 and 1,024 points, on ``chip_smoke.py``'s inputs.  Prints the card and
one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def _smoke():
    """This checkout's ``chip_smoke.py`` (its inputs and timing helpers)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _child(root: str, build_only: bool) -> None:
    sys.path.insert(0, root)
    from dvt_circuits_tpu_torch import kernels
    from dvt_circuits_tpu_torch.curve import g1, g2
    from dvt_circuits_tpu_torch.hostcrypto import bls12_381 as host

    kernels.build_all(("curve",))
    if build_only:
        return
    smoke = _smoke()
    out = {"root": root}
    for n in smoke.C1_PRODUCTS:
        out.update(smoke.c1_timed(n))
    for m in smoke.MSM_POINTS:
        points, scalars, want = smoke._bench_points(m)
        p = g1.from_affine_points(points, "cuda")
        digits = g1.scalars_to_digits(scalars, "cuda")
        got = g1.msm_jacobian(p, digits)
        if g1.to_affine_points(tuple(c[None] for c in got))[0] != want:
            raise AssertionError(f"C2 at {m} points differs from the host oracle")
        out[f"C2 {m} points"] = smoke._time_ms(lambda: g1.msm_jacobian(p, digits), 3, warmup=1)
        if m == smoke.MSM_POINTS[-1]:
            w = g1.default_window_bits(m)
            pb, db = g1.bucket_inputs(points, scalars, w, "cuda")
            got = g1.msm_bucket_jacobian(pb, db, w)
            if g1.to_affine_points(tuple(c[None] for c in got))[0] != want:
                raise AssertionError(f"C3 at {m} points differs from the host oracle")
            out[f"C3 {m} points"] = smoke._time_ms(lambda: g1.msm_bucket_jacobian(pb, db, w), 5,
                                                   warmup=1)
    for m in (smoke.G2_POINTS, smoke.G2_POINTS_FULL):
        points, scalars = smoke._g2_batch(m)
        pg = g2.from_host_points(points, "cuda")
        bits = g1.scalars_to_bits(scalars, "cuda")
        got = g2.to_host_points(tuple((c[0][:4], c[1][:4]) for c in g2.scalar_mul(pg, bits)))
        if got != [host.g2_mul(q, k) if q else None for q, k in zip(points[:4], scalars[:4])]:
            raise AssertionError(f"C4 at {m} points differs from the host g2_mul")
        out[f"C4 {m} points"] = smoke._time_ms(lambda: g2.scalar_mul(pg, bits), 3, warmup=1)
    print(json.dumps(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="directory holding the other port package")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("compare_checkouts: needs a CUDA card", file=sys.stderr)
        return 2
    if args.child:
        _child(args.child, args.build_only)
        return 0
    other = str(Path(args.other).resolve())
    if not (Path(other) / "dvt_circuits_tpu_torch").is_dir():
        ap.error(f"{other} holds no dvt_circuits_tpu_torch")
    roots = [other, str(REPO)]
    me = [sys.executable, str(Path(__file__).resolve()), "--other", other, "--child"]
    builds = [subprocess.Popen(me + [r, "--build-only"]) for r in roots]
    if any(p.wait() for p in builds):
        raise RuntimeError("a build of the curve kernels failed")
    runs = []
    for root in (other, str(REPO), str(REPO), other):
        res = subprocess.run(me + [root], capture_output=True, text=True, check=True)
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    print(_smoke()._card_line())
    print(json.dumps({"compare_checkouts": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
