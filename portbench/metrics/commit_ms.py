"""The Commitments layer's table trees (``stark/prover.py:_commit``: each
preprocessed, trace and quotient ``MerkleTree`` with its root, so with
``_materialize``'s host mirrors): the port's ``commit`` spans summed over a
proof, in ms, a mean over the window's ``prove`` roots."""

from portbench.core.spans import span_ms


def read(run):
    return span_ms(run, "prove", "commit")
