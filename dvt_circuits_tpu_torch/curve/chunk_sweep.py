"""Time kernel C3 (``csrc/curve.cu``, the bucket MSM) at several values of
its compile-time chunk, the sorted entries one thread of C3b adds (``kChunk``
in the source, ``g1.BUCKET_CHUNK`` beside it), on bench.py's MSM inputs:
1,024 and 4,096 points, and 4,096 points of one scalar (each window's points
then share one bucket).  It is how ``kChunk`` was chosen.

    python3 dvt_circuits_tpu_torch/curve/chunk_sweep.py [--chunks 8,16,32]

Run from the root of a checkout, on a machine with a CUDA card.  For each
chunk a copy of ``dvt_circuits_tpu_torch`` with that constant goes to
``build/chunk_sweep/<chunk>/`` (git-ignored); the copies' kernels are built
at once, one process each, then timed in turns (each copy in a process of its
own, the list forward and then backward).  Each copy first checks C3's sum
against the host oracle, then times C3b alone and the whole of C3 (CUDA-event
means after warm-up, ms).  Prints the card and one JSON line.
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


def _copy(chunk: int) -> Path:
    """The port with C3's chunk set to ``chunk``, under build/chunk_sweep/."""
    root = REPO / "build" / "chunk_sweep" / str(chunk)
    pkg = root / "dvt_circuits_tpu_torch"
    shutil.rmtree(pkg, ignore_errors=True)
    shutil.copytree(REPO / "dvt_circuits_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, pattern, line in (("csrc/curve.cu", r"constexpr int kChunk = \d+;",
                                f"constexpr int kChunk = {chunk};"),
                               ("curve/g1.py", r"\nBUCKET_CHUNK = \d+\n",
                                f"\nBUCKET_CHUNK = {chunk}\n")):
        path = pkg / rel
        text, n = re.subn(pattern, line, path.read_text())
        if n != 1:
            raise RuntimeError(f"{rel}: C3's chunk constant not found")
        path.write_text(text)
    return root


def _child(root: str, build_only: bool) -> None:
    sys.path[:0] = [root, str(REPO)]
    from chip_smoke import _bench_points, _time_ms
    from dvt_circuits_tpu_torch import kernels
    from dvt_circuits_tpu_torch.curve import g1

    kernels.build_all(("curve",))
    if build_only:
        return
    out = {"chunk": g1.BUCKET_CHUNK}
    for n, equal in ((1024, False), (4096, False), (4096, True)):
        points, scalars, want = _bench_points(n, equal)
        w = g1.default_window_bits(n)
        pb, db = g1.bucket_inputs(points, scalars, w, "cuda")
        got = g1.msm_bucket_jacobian(pb, db, w)
        if g1.to_affine_points(tuple(c[None] for c in got))[0] != want:
            raise AssertionError(f"chunk {g1.BUCKET_CHUNK}: C3 differs from the host oracle")
        launches, _ = g1._bucket_launches(pb, db, w)
        launches["g1_bucket_sort"]()
        label = f"{n} points" + (", equal scalars" if equal else "")
        out[f"C3b {label}"] = _time_ms(launches["g1_bucket_sums"], 20)
        out[f"C3 {label}"] = _time_ms(lambda: g1.msm_bucket_jacobian(pb, db, w), 10)
    print(json.dumps(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunks", default="8,16,32")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chunk_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    if args.child:
        _child(args.child, args.build_only)
        return 0
    roots = [_copy(int(c)) for c in args.chunks.split(",")]
    me = [sys.executable, str(Path(__file__).resolve()), "--child"]
    builds = [subprocess.Popen(me + [str(r), "--build-only"]) for r in roots]
    if any(p.wait() for p in builds):
        raise RuntimeError("a build of C3 failed")
    runs = []
    for root in roots + roots[::-1]:
        res = subprocess.run(me + [str(root)], capture_output=True, text=True, check=True)
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    sys.path.insert(0, str(REPO))
    from chip_smoke import _card_line

    print(_card_line())
    print(json.dumps({"chunk_sweep": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
