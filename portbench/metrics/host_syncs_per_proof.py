"""The Prover layer's blocking reads to the host (each challenger duplex,
each tree's mirrors and root, the openings at zeta, the FRI final
coefficients, each grind batch): the port's ``host_syncs`` counter summed
over a proof's spans, a mean over the window's ``prove`` roots."""

from portbench.core.spans import counter


def read(run):
    return counter(run, "prove", "host_syncs")
