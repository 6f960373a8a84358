"""The Prover layer's constraint quotient (``stark/prover.py:quotient_body``
and its domain tables; the quotient's tree is in ``commit_ms``): the port's
``quotient`` spans summed over a proof, in ms, a mean over the window's
``prove`` roots."""

from portbench.core.spans import span_ms


def read(run):
    return span_ms(run, "prove", "quotient")
