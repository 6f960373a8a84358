"""The Witness layer (``prover/pipeline.py:execute_circuit``, table
assembly, ``prover/curve_glue.py``, the AIRs' ``generate_trace``): the
container's own ``timing.witness_ms``, a mean over the window's proofs."""


def read(run):
    done = run.proven
    return sum(r["container"]["timing"]["witness_ms"] for r in done) / len(done) if done else None
