"""The Prover layer's kernel launches: kernels the profiler saw start
inside the proofs' intervals (a parse's start to its verify's start), over
the proofs."""

from portbench.core.trace import is_copy


def read(run):
    if run.trace is None:
        return None
    spans = run.trace.proof_intervals()
    kernels = [o for o in run.trace.ops_in(spans) if not is_copy(o[0])]
    return len(kernels) / len(spans) if kernels else None
