"""The Witness layer's guest program (``prover/pipeline.py:execute_circuit``
under the hash, ChaCha20 and curve recorders): the port's
``witness.execute`` span, in ms, a mean over the window's ``prove`` roots."""

from portbench.core.spans import span_ms


def read(run):
    return span_ms(run, "prove", "witness.execute")
