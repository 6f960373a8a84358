"""The Prover layer's low-degree extensions (``stark/prover.py:prove``: the
preprocessed columns' generation, the trace's upload and ``lde_body``): the
port's ``lde`` spans summed over a proof, in ms, a mean over the window's
``prove`` roots."""

from portbench.core.spans import span_ms


def read(run):
    return span_ms(run, "prove", "lde")
