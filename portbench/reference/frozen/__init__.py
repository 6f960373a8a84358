"""Frozen copies of the port's host layers and verifier, for the reference.

The benchmark judges the port's containers with these modules and with no
module of the port: the witness program (``circuits``, ``dkg``,
``hostcrypto``, ``utils``), the STARK verifier (``field``, ``hash``,
``ntt``, ``pcs``, ``stark``) and the container's bindings
(``prover.pipeline.verify_proof``, ``prover.curve_glue``), as the port had
them when the benchmark was written.  Every Poseidon2 call is the plain
PyTorch permutation, and the BLS12-381 arithmetic is pure Python; nothing
here loads a CUDA kernel or a native library.  Later changes to the port
do not reach this copy, so a changed prover is held to the same statement.
"""
