"""The Witness layer's curve tables (``prover/curve_glue.py:build_gadget``
for each recorded curve relation, the G1 chips' ``generate_trace`` on the
host): the port's ``witness.g1`` span, in ms, a mean over the window's
``prove`` roots."""

from portbench.core.spans import span_ms


def read(run):
    return span_ms(run, "prove", "witness.g1")
