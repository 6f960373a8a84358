"""dvt_circuits_tpu_torch — the DKG fault-proving framework on PyTorch and CUDA.

The PyTorch port of ``dvt_circuits_tpu`` (the JAX/TPU package, which stays
the reference).  Module names mirror the JAX package:

  * ``hostcrypto``, ``dkg``, ``circuits``, ``utils`` — host layers, copied
  * ``field``   — BabyBear and its quartic extension, int64 standard form
  * ``hash``    — Poseidon2 and Keccak-f[1600] (hand-written CUDA kernels
    beside plain PyTorch versions), SHA-256 constants
  * ``ntt``     — NTT and coset LDE along axis 0
  * ``pcs``     — Merkle commitments, FRI, Fiat–Shamir challenger
  * ``stark``   — AIRs (stream, SHA-256, G1 scalar-mul), the phase prover
    and the verifier
  * ``prover``  — the proof pipeline, its curve glue, containers and
    ``verify_proof``
  * ``curve``   — BLS12-381 Fp, G1 (windowed and bucket MSM) and G2, each
    device algorithm a CUDA kernel beside its plain PyTorch version
  * ``parallel`` — the sharded prover over ``torch.distributed`` (one
    process a card; NCCL on the card, Gloo on the CPU): meshes, collectives,
    sharded NTT, Merkle, FRI and STARK, the (dp, sp, tp) commit step
  * ``service`` — the HTTP node (``prove`` / ``execute`` / spec routes)
  * ``cli``     — ``prove`` / ``execute`` / ``validate-schema`` /
    ``get-schema`` / ``verify`` / ``node``
  * ``probe_vpu`` — the integer multiply-add probe (a CUDA kernel beside
    its plain PyTorch version)

Entry points take a ``device`` (default ``"cuda"``) and raise when the card
is missing; nothing falls back to the CPU unless the caller asks for it.
The port imports nothing from ``dvt_circuits_tpu`` and never imports jax.
"""

__version__ = "0.1.0"
