"""The Prover layer's openings (``stark/prover.py:prove`` from
``openings_body`` on: the openings at zeta, DEEP, ``pcs/fri.py:fri_prove``
with its layer trees, fold, final coefficients, grind and queries, and the
tables' outer openings): the port's ``open`` spans summed over a proof, in
ms, a mean over the window's ``prove`` roots."""

from portbench.core.spans import span_ms


def read(run):
    return span_ms(run, "prove", "open")
