"""The Verifier layer's STARK checks (``stark/verifier.py:verify`` for every
table of a container, with its FRI): the port's ``verify.stark`` spans
summed over a verify, in ms, a mean over the window's ``verify`` roots."""

from portbench.core.spans import span_ms


def read(run):
    return span_ms(run, "verify", "verify.stark")
