"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json`` at the root of
the checkout.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device`` (with
``--trace 1`` also ``busy_s`` and ``window_s``), with ``--trace 1``
``breakdown``, and last ``checks``: each number the reference compared,
beside its limit.  The same numbers end standard error.  A run needs a
CUDA card and exits with code 2, printing no result, without one.
``--control`` runs one of the port's paths that break a guarantee of the
configuration (``core/program.py:CONTROLS``), to show that the
comparison fails it; no measured run uses it.
"""

from __future__ import annotations

import argparse
import json
import sys


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="portbench.run", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True, help="makes every input of the run")
    ap.add_argument("--seconds", type=float, required=True,
                    help="iterations start while this many seconds have not passed")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0,
                    help="1: trace the window and report the per-layer metrics")
    ap.add_argument("--control", default="", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from portbench.core import harness
    from portbench.core.spec import load_cell

    harness.cache_env()
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", args.control)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the process holds {found}, which the benchmark may not load",
              file=sys.stderr)
        return 3
    for note in out.notes:
        print(f"portbench: {note}", file=sys.stderr)
    for name, c in out.line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(out.line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
