"""The point operations of kernels C2 and C4 as programs spread over lanes.

A Jacobian point operation (``g1.py:add``/``double``, ``g2.py:add``/
``double``) is a straight-line program of Fp products, sums and
differences.  Written as one thread's chain, it waits on one product after
another; many of its products are independent (an addition over Fp has 8
side by side at its widest step, over Fp² ~19 base products).  Here each
operation is scheduled into steps: in one step every lane of a group does
at most one Fp operation, reading its operands from the group's slots (12
words each, in shared memory) and writing its result to another slot, and
the lanes of a warp meet at ``__syncwarp`` between steps.
``csrc/bls12_381_lanes.cuh`` runs the programs; this module writes them
into ``csrc/bls12_381_progs.cuh``:

    python3 -m dvt_circuits_tpu_torch.curve.lanes   # rewrites the header

Every Fp result is fully reduced into [0, p), so evaluating the JAX
formulas in any order gives the same limbs: the programs hold the JAX
package's values, and its selects stay in the kernels.  ``simulate`` runs a
program on Python ints (Montgomery products, R = 2^384), as the tests do.

``fuse`` folds doublings into the sums beside them (an operation is a
product a·b or a sum 2^k1 (a ± 2^k2 b)); ``schedule`` puts each wave of
products in one step, at most one operation a lane, the sums in between.
A slot is reused only by an operation of a later step than its value's
last read, so no lane can overwrite an operand that another lane of the
same step has yet to read; inputs are never overwritten.
"""

from __future__ import annotations

import sys
from pathlib import Path

from ..hostcrypto.bls12_381 import P

MUL, ADD, SUB = 1, 2, 3
_COST = {MUL: 10, ADD: 1, SUB: 1}
R_INV = pow(1 << 384, -1, P)
HEADER = Path(__file__).resolve().parents[1] / "csrc" / "bls12_381_progs.cuh"


class Program:
    """Values 0 .. n_inputs − 1 are the inputs; each operation adds one:
    (kind, a, b, k1, k2), a product a·b, or for a sum or difference
    2^k1 · (a ± 2^k2 · b) (``fuse`` sets the shifts)."""

    def __init__(self, n_inputs: int):
        self.n_inputs = n_inputs
        self.ops: list = []

    def _op(self, kind: int, a: int, b: int) -> int:
        self.ops.append((kind, a, b, 0, 0))
        return self.n_inputs + len(self.ops) - 1

    def mul(self, a, b):
        return self._op(MUL, a, b)

    def add(self, a, b):
        return self._op(ADD, a, b)

    def sub(self, a, b):
        return self._op(SUB, a, b)


class Fp1:
    """Fp over a program: elements are value ids."""

    def __init__(self, pr: Program):
        self.pr = pr

    def mul(self, a, b):
        return self.pr.mul(a, b)

    def sq(self, a):
        return self.pr.mul(a, a)

    def add(self, a, b):
        return self.pr.add(a, b)

    def sub(self, a, b):
        return self.pr.sub(a, b)


class Fp2:
    """Fp² = Fp[u]/(u² + 1) over a program: elements are pairs of value ids.
    A product is schoolbook (4 base products, 3 for a square), not
    ``g2.py``'s Karatsuba (3 and 2): lanes are plentiful, and Karatsuba's
    operand sums would put a step of sums before every product step.  The
    values are the same."""

    def __init__(self, pr: Program):
        self.pr = pr

    def mul(self, a, b):
        pr = self.pr
        c0 = pr.sub(pr.mul(a[0], b[0]), pr.mul(a[1], b[1]))
        return (c0, pr.add(pr.mul(a[0], b[1]), pr.mul(a[1], b[0])))

    def sq(self, a):
        pr = self.pr
        t = pr.mul(a[0], a[1])
        return (pr.sub(pr.mul(a[0], a[0]), pr.mul(a[1], a[1])), pr.add(t, t))

    def add(self, a, b):
        return (self.pr.add(a[0], b[0]), self.pr.add(a[1], b[1]))

    def sub(self, a, b):
        return (self.pr.sub(a[0], b[0]), self.pr.sub(a[1], b[1]))


def _twice(F, a, times: int = 1):
    for _ in range(times):
        a = F.add(a, a)
    return a


def double(F, p):
    """dbl-2009-l, the value ``g1.py:double`` computes (a = 0), with its
    D = 2((X + B)² − A − C) written as 4·X·B (C = B²): one product on X and
    B, and no sum before it.  (Writing Y3 = 12·E·XB − E·F − 8C instead saves
    two steps of sums but costs eight more sums, and measured slower.)"""
    X, Y, Z = p
    A, B, YZ = F.sq(X), F.sq(Y), F.mul(Y, Z)
    C = F.sq(B)
    D = _twice(F, F.mul(X, B), 2)
    E = F.add(F.add(A, A), A)
    X3 = F.sub(F.sq(E), F.add(D, D))
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), _twice(F, C, 3))
    return (X3, Y3, F.add(YZ, YZ))


def add_generic(F, p, q):
    """add-2007-bl, the value ``g1.py:add`` computes before its selects,
    rewritten so that fewer sums wait between products.  With r' = S2 − S1
    (r = 2r'), H² = HH, J' = H·HH and V' = U1·HH: I = (2H)² = 4HH, J = 4J',
    V = 4V', X3 = r² − J − 2V = 4(r'² − J' − 2V'), V − X3 = 4(3V' + J' −
    r'²), Y3 = r·(V − X3) − 2·S1·J = 2(r'·(V − X3) − 4·S1·J'), and Z3 =
    ((Z1 + Z2)² − Z1Z1 − Z2Z2)·H = 2·(Z1·H)·Z2.  Returns the sum, H and r'
    (zero exactly where r is, so ``same_x`` and ``same_y`` test H and
    r')."""
    (X1, Y1, Z1), (X2, Y2, Z2) = p, q
    Z1Z1, Z2Z2 = F.sq(Z1), F.sq(Z2)
    U1, U2 = F.mul(X1, Z2Z2), F.mul(X2, Z1Z1)
    S1 = F.mul(F.mul(Y1, Z2), Z2Z2)
    S2 = F.mul(F.mul(Y2, Z1), Z1Z1)
    H, rh = F.sub(U2, U1), F.sub(S2, S1)
    HH, RR = F.sq(H), F.sq(rh)
    J1, V1 = F.mul(H, HH), F.mul(U1, HH)
    X3 = _twice(F, F.sub(RR, F.add(J1, F.add(V1, V1))), 2)
    VmX3 = _twice(F, F.add(F.sub(J1, RR), F.add(V1, F.add(V1, V1))), 2)
    Y3 = _twice(F, F.sub(F.mul(rh, VmX3), _twice(F, F.mul(S1, J1), 2)))
    return (X3, Y3, _twice(F, F.mul(F.mul(Z1, H), Z2))), H, rh


def _flat(*elems) -> list:
    out = []
    for e in elems:
        out += list(e) if isinstance(e, tuple) else [e]
    return out


def _point(F, first: int):
    """Input point whose coordinates start at value ``first``."""
    if isinstance(F, Fp2):
        return tuple((first + 2 * c, first + 2 * c + 1) for c in range(3))
    return tuple(first + c for c in range(3))


def build(name: str):
    """(program, outputs, reserved slots) of one point operation.

    ``*_dbl``: inputs the point p (3 or 6 elements), outputs 2p.  ``*_add``:
    inputs p then q, outputs the sum before the selects, H and r'.  The JAX
    ``add`` also computes p's double and selects it where P = Q; the kernels
    run the doubling program in that case only (a branch uniform across the
    warp).  A doubling reserves the slots of an addition's inputs, so q
    stays where it is."""
    field = Fp2 if name.startswith("g2") else Fp1
    e = 2 if field is Fp2 else 1
    if name.endswith("dbl"):
        pr = Program(3 * e)
        F = field(pr)
        return pr, _flat(*double(F, _point(F, 0))), 6 * e
    pr = Program(6 * e)
    F = field(pr)
    s, H, rh = add_generic(F, _point(F, 0), _point(F, 3 * e))
    return pr, _flat(*s) + _flat(H, rh), 6 * e


#: the programs, with the lanes of their group: G1 four lanes a point (8
#: points a warp; its widest product step holds 5, its doubling's 3), G2 a
#: warp a point (its widest product step holds 18 base products)
PROGRAMS = {"g1_dbl": 4, "g1_add": 4, "g2_dbl": 32, "g2_add": 32}


def fuse(pr: Program, outputs: list) -> None:
    """Fold doublings into the sums next to them, in place, while the shifts
    stay at most 3: v = u + u with u = 2^k1 (a ± 2^k2 b) becomes 2^(k1 + 1)
    (a ± 2^k2 b), and v = x ± y with y = 2^j (z + z) becomes x ± 2^(j + 1)
    z, each where v is u's or y's only user.  A chain of sums then takes
    one step in one lane, not a step a sum: a step of sums costs far more
    than its sums."""
    n_in = pr.n_inputs
    changed = True
    while changed:
        changed = False
        uses = [0] * (n_in + len(pr.ops))
        for _, a, b, _, _ in pr.ops:
            uses[a] += 1
            uses[b] += 1
        for v in outputs:
            uses[v] += 1
        for idx, (kind, a, b, k1, k2) in enumerate(pr.ops):
            if kind == MUL:
                continue
            if kind == ADD and a == b and k1 == k2 == 0 and a >= n_in and uses[a] == 2:
                ku, au, bu, k1u, k2u = pr.ops[a - n_in]
                if ku != MUL and k1u < 3:
                    pr.ops[idx] = (ku, au, bu, k1u + 1, k2u)
                    changed = True
                    continue
            for x, y in ((a, b), (b, a)) if kind == ADD else ((a, b),):
                if y < n_in or k2 != 0 or uses[y] != 1:
                    continue
                ky, ay, by, k1y, k2y = pr.ops[y - n_in]
                if ky == ADD and ay == by and k2y == 0 and k1y < 3:
                    pr.ops[idx] = (kind, x, ay, k1, k1y + 1)
                    changed = True
                    break


def schedule(pr: Program, outputs: list, lanes: int, reserved: int):
    """Steps of at most ``lanes`` operations, slots for every value.

    A step with a product costs about a product (the sums beside it ride
    along); a step of sums alone costs a fraction of one.  So products go
    in waves: the pending products with the fewest products before them
    (their level) wait until all of them are ready, steps of sums making
    them ready meanwhile, and then go in one step (more than ``lanes``: in
    several).  Sums ready at a step join it, the longest weighted paths to
    the end first (a product weighs 10, a sum 1).

    Returns (steps, n_slots, output slots): steps a list of lists of
    (kind, dst slot, a slot, b slot, k1, k2)."""
    n_in, nv = pr.n_inputs, pr.n_inputs + len(pr.ops)
    needed = set(outputs)
    for v in range(nv - 1, n_in - 1, -1):  # only what the outputs need
        if v in needed:
            _, a, b, _, _ = pr.ops[v - n_in]
            needed |= {a, b}
    users: dict = {v: [] for v in range(nv)}
    for v in range(n_in, nv):
        if v in needed:
            _, a, b, _, _ = pr.ops[v - n_in]
            users[a].append(v)
            users[b].append(v)
    height = [0] * nv
    level = [0] * nv
    for v in range(n_in, nv):
        kind, a, b, _, _ = pr.ops[v - n_in]
        level[v] = max(level[a], level[b]) + (kind == MUL)
    for v in range(nv - 1, n_in - 1, -1):
        if v in needed:
            height[v] = _COST[pr.ops[v - n_in][0]] + max((height[u] for u in users[v]), default=0)
    step_of = {v: -1 for v in range(n_in)}
    todo = sorted(v for v in needed if v >= n_in)
    steps: list = []
    while todo:
        ready = [v for v in todo
                 if all(step_of.get(x, len(steps)) < len(steps) for x in pr.ops[v - n_in][1:3])]
        ready.sort(key=lambda v: (-height[v], v))
        muls = [v for v in ready if pr.ops[v - n_in][0] == MUL]
        lins = [v for v in ready if pr.ops[v - n_in][0] != MUL]
        wave = min((level[v] for v in todo if pr.ops[v - n_in][0] == MUL), default=None)
        waiting = any(level[v] == wave and v not in muls
                      for v in todo if pr.ops[v - n_in][0] == MUL)
        if muls and not (waiting and lins):
            chosen = muls[:lanes]
            chosen += lins[:lanes - len(chosen)]
        else:
            chosen = lins[:lanes]
        for v in chosen:
            step_of[v] = len(steps)
        steps.append(chosen)
        todo = [v for v in todo if v not in step_of]
    last = {v: max((step_of[u] for u in users[v]), default=-1) for v in step_of}
    for v in outputs:
        last[v] = len(steps)
    base = max(n_in, reserved)
    slot = {v: v for v in range(n_in)}
    free: list = []
    top = base
    out_steps = []
    for s, chosen in enumerate(steps):
        free += [slot[v] for v in slot if v >= n_in and last[v] == s - 1]
        free.sort()
        row = []
        for v in chosen:
            if free:
                slot[v] = free.pop(0)
            else:
                slot[v], top = top, top + 1
            kind, a, b, k1, k2 = pr.ops[v - n_in]
            row.append((kind, slot[v], slot[a], slot[b], k1, k2))
        out_steps.append(row)
    return out_steps, top, [slot[v] for v in outputs]


def encode(op) -> int:
    kind, dst, a, b, k1, k2 = op
    assert max(dst, a, b) < 256 and max(k1, k2) < 4
    return kind << 30 | k1 << 28 | k2 << 26 | dst << 16 | a << 8 | b


def check(steps) -> None:
    """No slot is written twice in a step, or written in a step that reads it."""
    for row in steps:
        dsts = [op[1] for op in row]
        reads = {x for op in row for x in op[2:4]}
        if len(set(dsts)) != len(dsts) or reads & set(dsts):
            raise AssertionError(f"a step writes a slot it reads or writes twice: {row}")


def simulate(steps, n_slots: int, inputs: list) -> list:
    """Run a program on Montgomery-form ints: a product is a·b·2^-384 mod p."""
    slots = list(inputs) + [None] * (n_slots - len(inputs))
    for row in steps:
        results = []
        for kind, dst, a, b, k1, k2 in row:
            x, y = slots[a], slots[b] << k2
            r = x * y * R_INV if kind == MUL else (x + y if kind == ADD else x - y) << k1
            results.append((dst, r % P))
        for dst, r in results:
            slots[dst] = r
    return slots


def compiled() -> dict:
    """{name: (lanes, steps, n_slots, output slots)} for every program."""
    out = {}
    for name, lanes in PROGRAMS.items():
        pr, outputs, reserved = build(name)
        fuse(pr, outputs)
        steps, n_slots, out_slots = schedule(pr, outputs, lanes, reserved)
        check(steps)
        out[name] = (lanes, steps, n_slots, out_slots)
    return out


def _camel(name: str) -> str:
    return "k" + "".join(part.capitalize() for part in name.split("_"))


def header() -> str:
    """The text of ``csrc/bls12_381_progs.cuh``."""
    lines = [
        "// Generated by dvt_circuits_tpu_torch/curve/lanes.py (python3 -m",
        "// dvt_circuits_tpu_torch.curve.lanes); do not edit.  The point operations",
        "// of csrc/bls12_381_lanes.cuh as programs: a step a row, one operation a",
        "// lane, kind << 30 | k1 << 28 | k2 << 26 | dst << 16 | a << 8 | b over",
        "// 12-word slots: kind 1 the Montgomery product a b, 2 and 3 the sum and",
        "// difference 2^k1 (a +- 2^k2 b), 0 none.",
        "#pragma once",
        "",
        "#include <cstdint>",
        "",
        "namespace bls::progs {",
    ]
    for name, (lanes, steps, n_slots, outs) in compiled().items():
        k = _camel(name)
        products = sum(any(op[0] == MUL for op in row) for row in steps)
        n_mul = sum(op[0] == MUL for row in steps for op in row)
        lines += [
            "",
            f"// {name}: {lanes} lanes, {len(steps)} steps ({products} with products), "
            f"{n_mul} products, {n_slots} slots",
            f"constexpr int {k}Lanes = {lanes};",
            f"constexpr int {k}Steps = {len(steps)};",
            f"constexpr int {k}Slots = {n_slots};",
        ]
        lines.append(f"__constant__ int {k}Out[{len(outs)}] = {{{', '.join(map(str, outs))}}};")
        lines.append(f"__device__ const uint32_t {k}[{len(steps) * lanes}] = {{")
        for row in steps:
            words = [encode(op) for op in row] + [0] * (lanes - len(row))
            for lo in range(0, lanes, 8):
                lines.append("    " + ", ".join(f"0x{w:08x}u" for w in words[lo:lo + 8]) + ",")
        lines.append("};")
    lines += ["", "}  // namespace bls::progs", ""]
    return "\n".join(lines)


def main() -> int:
    HEADER.write_text(header())
    for name, (lanes, steps, n_slots, _) in compiled().items():
        products = sum(any(op[0] == MUL for op in row) for row in steps)
        print(f"{name}: {lanes} lanes, {len(steps)} steps, {products} with products, "
              f"{n_slots} slots")
    return 0


if __name__ == "__main__":
    sys.exit(main())
