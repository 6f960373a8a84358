"""The Commitments layer's bytes read back to the host (``pcs/merkle.py``'s
``_materialize`` copies each committed matrix and its tree whole, and the
prover's smaller reads): the port's ``d2h_bytes`` counter summed over a
proof's spans, in MiB, a mean over the window's ``prove`` roots."""

from portbench.core.spans import counter


def read(run):
    n = counter(run, "prove", "d2h_bytes")
    return None if n is None else n / (1 << 20)
