"""Time a curve kernel (``csrc/curve.cu``) in copies of the port that differ
in compile-time constants: how C1's tile shape and C3's chunk were chosen.

    python3 dvt_circuits_tpu_torch/curve/sweep.py c1 kTile=128,kStages=2 kTile=64,kStages=1
    python3 dvt_circuits_tpu_torch/curve/sweep.py c3 kChunk=8,BUCKET_CHUNK=8 kChunk=16,BUCKET_CHUNK=16

Run from the root of a checkout, on a machine with a CUDA card.  Each
variant is a list of ``NAME=VALUE``; each name must be defined exactly once
in the package, as ``constexpr int NAME = ...;`` in ``csrc/`` or as
``NAME = ...`` at the start of a line of a module.  C1's constants are
``kTile`` (products a tile, one thread each) and ``kStages`` (tiles a block
keeps in flight) in ``csrc/fp_tile.cuh``; C3's chunk, the sorted entries one
thread of C3b adds, is ``kChunk`` in ``csrc/curve.cu`` with
``g1.BUCKET_CHUNK`` beside it.  Each variant's copy of
``dvt_circuits_tpu_torch`` goes to ``build/sweep/<variant>/`` (git-ignored);
the copies' kernels are built at once, one process each, then timed in turns
(each copy in a process of its own, the list forward and then backward).

The timings (CUDA-event means after warm-up, ms): ``c1`` checks C1 on a
sample and the edge rows, reads its kernel's registers and stack
(``cuobjdump``), and times the call and the kernel alone at each of
``chip_smoke.C1_PRODUCTS`` (``chip_smoke.c1_timed``); ``c3`` checks C3
against the host oracle and times C3b alone and the whole of C3 on bench.py's
MSM inputs (1,024 and 4,096 points, and 4,096 points of one scalar, whose
points then share one bucket a window).  Prints the card and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def _set(pkg: Path, name: str, value: int) -> None:
    """Give the one definition of ``name`` in the package the value ``value``."""
    patterns = ((("*.cu", "*.cuh"), rf"(constexpr int {name} = )-?\d+;", rf"\g<1>{value};"),
                (("*.py",), rf"(?m)^({name} = )-?\d+$", rf"\g<1>{value}"))
    found = []
    for globs, pattern, repl in patterns:
        for glob in globs:
            for path in pkg.rglob(glob):
                text, n = re.subn(pattern, repl, path.read_text())
                found += [(path, text)] * n
    if len(found) != 1:
        raise RuntimeError(f"{name}: {len(found)} definitions in the package, not one")
    found[0][0].write_text(found[0][1])


def _copy(variant: str) -> Path:
    """The port with the variant's constants, under build/sweep/<variant>/."""
    root = REPO / "build" / "sweep" / variant.replace(",", "_").replace("=", "")
    pkg = root / "dvt_circuits_tpu_torch"
    shutil.rmtree(pkg, ignore_errors=True)
    shutil.copytree(REPO / "dvt_circuits_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for item in variant.split(","):
        name, value = item.split("=")
        _set(pkg, name, int(value))
    return root


def _time_c1(smoke, lib) -> dict:
    out = dict(smoke.resource_usage(lib)["fp_mont_mul_kernel"])
    for n in smoke.C1_PRODUCTS:
        out.update(smoke.c1_timed(n))
    return out


def _time_c3(smoke, lib) -> dict:
    from dvt_circuits_tpu_torch.curve import g1

    out = {}
    for n, equal in ((1024, False), (4096, False), (4096, True)):
        points, scalars, want = smoke._bench_points(n, equal)
        w = g1.default_window_bits(n)
        pb, db = g1.bucket_inputs(points, scalars, w, "cuda")
        got = g1.msm_bucket_jacobian(pb, db, w)
        if g1.to_affine_points(tuple(c[None] for c in got))[0] != want:
            raise AssertionError("C3 differs from the host oracle")
        launches, _ = g1._bucket_launches(pb, db, w)
        launches["g1_bucket_sort"]()
        label = f"{n} points" + (", equal scalars" if equal else "")
        out[f"C3b {label}"] = smoke._time_ms(launches["g1_bucket_sums"], 20)
        out[f"C3 {label}"] = smoke._time_ms(lambda: g1.msm_bucket_jacobian(pb, db, w), 10)
    return out


TIMINGS = {"c1": _time_c1, "c3": _time_c3}


def _child(root: str, timing: str, build_only: bool) -> None:
    sys.path[:0] = [root, str(REPO)]
    import chip_smoke as smoke
    from dvt_circuits_tpu_torch import kernels

    lib = kernels.build_all(("curve",))["curve"]
    if build_only:
        return
    print(json.dumps({"variant": Path(root).name, **TIMINGS[timing](smoke, lib)}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("timing", choices=sorted(TIMINGS))
    ap.add_argument("variants", nargs="+", help="NAME=VALUE[,NAME=VALUE...] each")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("sweep: needs a CUDA card", file=sys.stderr)
        return 2
    if args.child:
        _child(args.child, args.timing, args.build_only)
        return 0
    roots = [_copy(v) for v in args.variants]
    me = [sys.executable, str(Path(__file__).resolve()), args.timing, *args.variants, "--child"]
    builds = [subprocess.Popen(me + [str(r), "--build-only"]) for r in roots]
    if any(p.wait() for p in builds):
        raise RuntimeError("a build of the curve kernels failed")
    runs = []
    for root in roots + roots[::-1]:
        res = subprocess.run(me + [str(root)], capture_output=True, text=True, check=True)
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    sys.path.insert(0, str(REPO))
    from chip_smoke import _card_line

    print(_card_line())
    print(json.dumps({"sweep": args.timing, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
