"""The Commitments layer's copies to the host (``pcs/merkle.py``'s
``MerkleTree._materialize`` fetches whole matrices): the device time of the
device-to-host copies inside the proofs' intervals, over the proofs, in ms."""

from portbench.core.trace import D2H


def read(run):
    if run.trace is None:
        return None
    spans = run.trace.proof_intervals()
    copies = [o for o in run.trace.ops_in(spans) if o[0].startswith(D2H)]
    return sum(e - s for _, s, e in copies) / 1e3 / len(spans) if copies else None
