"""The Prover layer (``stark/fused.py``, ``stark/prover.py``): the
container's own ``timing.prove_ms``, the tables' proving time, a mean over
the window's proofs."""


def read(run):
    done = run.proven
    return sum(r["container"]["timing"]["prove_ms"] for r in done) / len(done) if done else None
