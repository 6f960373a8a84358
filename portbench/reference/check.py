"""The plain reference's judgement of one container.

Given the scenario's JSON text (the same text the port parsed), the
container the port produced, and the configuration, the reference works
out the statement again with its frozen copies and no module of the port:

* it parses the text and runs the witness program: the verdict (a fault
  proven, a ceremony valid) and the committed public values with their
  commit count must be the container's;
* it verifies the container strictly, its plain PyTorch on the run's
  device: the transcript's challenges, every table's Merkle roots and
  openings (the Poseidon2 commitments), the constraints at the
  out-of-domain point, the FRI layers and the proof of work, the SHA-256
  bindings, and the curve relations the container binds (``curve_glue``),
  with every BLS and ECDSA signature check re-run; and the container must
  state the configuration's STARK parameters, circuit, setup and auth
  mode.

Each of the two verdicts is a count, 0 for a sound container.
"""

from __future__ import annotations

import json

from .frozen.circuits.registry import get_circuit
from .frozen.prover.pipeline import VerifyError, execute_circuit, verify_proof

#: the numbers a run compares, in the order it prints them
NUMBERS = ("failed_in_window", "wrong_statement", "rejected_by_reference")


def statement_differs(raw: str, container: dict, config: dict, circuit: str) -> str:
    """Why the container's statement is not the reference's, or ''."""
    setup, auth = config["setup"], bool(config["auth"])
    spec = get_circuit(circuit, setup)
    data = spec.data_type.from_json(json.loads(raw), spec.setup.layout, auth)
    result = execute_circuit(circuit, data, auth, setup)
    if result.exit_code != 0:
        return f"the reference's witness program panics: {result.panic_message}"
    if container.get("public_values") != result.public_values.hex():
        return "public values differ from the reference's"
    if container.get("commit_count") != result.commit_count:
        return "commit count differs from the reference's"
    return ""


def rejection(container: dict, config: dict, circuit: str, device: str = "cpu") -> str:
    """Why the reference rejects the container, or ''.  ``device`` is where
    the plain PyTorch verifier's tensors live."""
    want = {"circuit": circuit, "setup": config["setup"], "auth": bool(config["auth"])}
    got = {k: container.get(k) for k in want}
    if got != want:
        return f"container states {got}, the configuration {want}"
    stated = {k: int(v) for k, v in dict(container.get("config") or {}).items()}
    if stated != {k: int(v) for k, v in config["stark"].items()}:
        return f"container's STARK parameters {stated} are not the configuration's"
    try:
        result = verify_proof(container, circuit, strict=True, device=device)
    except VerifyError as e:
        return f"strict verification fails: {e}"
    if not result.binding.startswith("curve-bound"):
        return f"binding {result.binding!r}, not curve-bound"
    return ""
