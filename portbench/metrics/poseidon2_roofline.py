"""K1's share of its roofline in the proves (``csrc/poseidon2.cu``: the
permutation, the leaf sponge, the Merkle levels, the proof-of-work search):
the least time of the permutations the proves need, reckoned from the
containers' tables and STARK parameters (``core/roofline.py``), over K1's
device time inside the proofs' intervals, in percent."""

import re

from portbench.core.roofline import k1_bound_ms, prove_work

#: K1's four kernels, by the names they have in the profiler
K1 = re.compile(r"(?<![A-Za-z0-9_])(permute|sponge|compress|grind)_kernel\b")


def read(run):
    if run.trace is None:
        return None
    spans = run.trace.proof_intervals()
    k1_us = sum(e - s for name, s, e in run.trace.ops_in(spans) if K1.search(name))
    if not k1_us:
        return None
    perms = moved = 0
    for r in run.proven:
        p, b = prove_work(r["container"])
        perms, moved = perms + p, moved + b
    return 100.0 * k1_bound_ms(perms, moved)[0] / (k1_us / 1e3)
