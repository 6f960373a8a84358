#!/usr/bin/env python3
"""Time the Poseidon2 work of the PyTorch/CUDA port (kernel K1 and the
loops around it) through the functions that every design of it exposes, so
that two checkouts can be compared on one card in one run:

  * the leaf sponge, ``pcs.merkle.hash_rows``, at the prover's shapes:
    2^14 x 4314 (the curve fault's trace LDE), 2^12 x 336, 2^14 x 32;
  * the Merkle tree of a 2^14 x 8 digest matrix (``pcs.merkle.build_levels``:
    one sponge permutation per leaf, then the levels), and its levels alone
    as that time less the sponge's;
  * the proof-of-work search, ``DuplexChallenger.grind(16)``, from a
    transcript state whose witness lies in the first batch of 2^16;
  * ``poseidon2_permute`` on 1 and 2^16 states.

    python3 scripts/k1_designs.py [--root DIR] [--label NAME]

``--root`` is a checkout of the repository (default: the one holding this
script); ``dvt_circuits_tpu_torch`` is imported from there and builds its
kernels there.  Times are CUDA-event means after warm-up, in ms; the host
work inside a call (launches, copies, syncs) is part of its time.  Prints
the card and one JSON line.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import _card_line, _time_ms  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_designs: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    from dvt_circuits_tpu_torch.hash import poseidon2 as p2
    from dvt_circuits_tpu_torch.pcs import merkle
    from dvt_circuits_tpu_torch.pcs.challenger import DuplexChallenger

    card = _card_line()
    rng = np.random.default_rng(20261016)
    dev = torch.device("cuda")
    out = {"label": args.label, "root": args.root, "card": card}

    for n, w, reps in ((1 << 14, 4314, 5), (1 << 12, 336, 20), (1 << 14, 32, 50)):
        m = torch.as_tensor(rng.integers(0, p2.bb.P, (n, w)), device=dev)
        out[f"hash_rows {n}x{w}"] = _time_ms(lambda: merkle.hash_rows(m), reps)
        del m

    n = 1 << 14
    leaves = torch.as_tensor(rng.integers(0, p2.bb.P, (n, 8)), device=dev)
    tree_ms = _time_ms(lambda: merkle.build_levels(leaves), 20)
    sponge_ms = _time_ms(lambda: merkle.hash_rows(leaves), 20)
    out[f"merkle tree {n} x 8"] = tree_ms
    out[f"merkle levels {n} leaves (tree less sponge)"] = tree_ms - sponge_ms

    # a transcript whose 16-bit witness is below 2^16: one batch in either design
    for seed in range(64):
        ch = DuplexChallenger(dev)
        ch.observe_many(np.random.default_rng(seed).integers(0, p2.bb.P, 11).tolist())
        w = ch.clone().grind(16)
        if w < 1 << 16:
            break
    out["grind(16), one batch of 65536"] = _time_ms(lambda: ch.clone().grind(16), 20)
    out["grind witness"] = w

    for n, reps in ((1, 200), (1 << 16, 100)):
        x = torch.as_tensor(rng.integers(0, p2.bb.P, (n, 16)), device=dev)
        out[f"permute {n}"] = _time_ms(lambda: p2.poseidon2_permute(x), reps)
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
