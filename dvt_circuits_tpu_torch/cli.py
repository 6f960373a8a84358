"""Host CLI of the PyTorch port: ``prove``, ``execute``, ``validate-schema``,
``get-schema``, ``verify`` and ``node``.

Port of ``dvt_circuits_tpu/cli.py`` with the same subcommands, flags
(``--setup``, ``--auth-commitment``, ``--type``, ``-i``, ``-o``,
``--json-schema-file``, ``--num-queries``, ``--log-blowup``,
``--pow-bits``, ``--show-report``, ``--require-curve-binding``,
``--schema-type``, ``--port``, ``--host``), the git banner on stderr
(``DVT_NO_BANNER=1`` turns it off) and exit codes (guest panic, a rejected
proof, a failed schema validation or any host error → 1), plus
``--device`` on ``prove``, ``verify`` and ``node`` (default ``cuda``;
``cpu`` runs the plain PyTorch path).  ``prove`` and ``verify
--show-report`` print the artifact fingerprint keccak256(sha256(proof
file)) through the Keccak kernel.

Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) ``run`` starts the
process group itself (NCCL with ``--device cuda``, each rank on card
``LOCAL_RANK``; Gloo with ``--device cpu``), so ``prove`` shards every
container over the ranks (``DVT_DIST=auto``); rank 0 alone prints and
writes files:

    torchrun --nproc-per-node 4 -m dvt_circuits_tpu_torch.cli \
        --auth-commitment prove --type=bad-share -i scenario.json -o proof.bin

    python -m dvt_circuits_tpu_torch.cli --auth-commitment prove \\
        --type=bad-share -i scenario.json -o proof.bin
    python -m dvt_circuits_tpu_torch.cli verify --type=bad-share \\
        -i proof.bin --show-report
    python -m dvt_circuits_tpu_torch.cli --auth-commitment node --port 8080
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import sys

from .circuits.registry import CIRCUITS, get_circuit
from .dkg.schemas import json_schema_for, validate_json, yaml_schema_for
from .dkg.types import DeserializeError
from .hash.keccak import keccak256_batch
from .prover.pipeline import (
    ProveError,
    VerifyError,
    execute_circuit,
    load_proof,
    prove_circuit,
    save_proof,
    verify_proof,
)
from .stark.config import DEFAULT_CONFIG, StarkConfig


def _style_error(msg: str) -> str:
    return f"\x1b[1;31m❌ {msg}\x1b[0m"


def _style_success(msg: str) -> str:
    return f"\x1b[1;32m✅ {msg}\x1b[0m"


def _style_cyan(msg: str) -> str:
    return f"\x1b[1;36m🔎 {msg}\x1b[0m"


class CliError(RuntimeError):
    pass


def _artifact_fingerprint(path: str, device="cuda") -> str:
    """keccak256(sha256(artifact)) of a proof file; the inner SHA-256 keeps
    the Keccak input to one sponge block."""
    with open(path, "rb") as f:
        inner = hashlib.sha256(f.read()).digest()
    return keccak256_batch([inner], device=device)[0].hex()


def _read_json(path: str):
    if not os.path.exists(path):
        raise CliError(f"File not found: {path}")
    with open(path) as f:
        try:
            return json.load(f)
        except json.JSONDecodeError as e:
            raise CliError(f"Invalid JSON in '{path}': {e}") from None


def _validate_if_needed(schema_path, json_path):
    if schema_path is None:
        return
    schema = _read_json(schema_path)
    data = _read_json(json_path)
    try:
        validate_json(schema, data)
    except Exception as e:
        raise CliError(f"Schema validation error: {e}") from None


def _load_typed(circuit_name: str, path: str, auth: bool, setup: str = "secp-commitment"):
    spec = get_circuit(circuit_name, setup)
    raw = _read_json(path)
    try:
        return spec.data_type.from_json(raw, spec.setup.layout, auth)
    except DeserializeError as e:
        raise CliError(f"Failed to read input data: {e}") from None


def _stark_config(args) -> StarkConfig:
    return StarkConfig(
        log_blowup=args.log_blowup,
        num_queries=args.num_queries,
        proof_of_work_bits=args.pow_bits,
        log_final_poly_len=DEFAULT_CONFIG.log_final_poly_len,
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="dvt-prover-torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument(
        "--setup",
        choices=["secp-commitment", "bls-commitment"],
        default="secp-commitment",
        help="identity-cryptography setup",
    )
    ap.add_argument(
        "--auth-commitment",
        action="store_true",
        default=os.environ.get("DVT_AUTH_COMMITMENT") == "1",
        help="enable the auth_commitment variant (commitment hash+signature)",
    )
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("prove", help="generate a proof for an input scenario")
    p.add_argument("--input-file", "-i", required=True)
    p.add_argument("--type", dest="subtype", required=True, choices=sorted(CIRCUITS))
    p.add_argument("--json-schema-file", dest="json_schema", default=None)
    p.add_argument("--output-file-path", "-o", default=None)
    p.add_argument("--num-queries", type=int, default=DEFAULT_CONFIG.num_queries)
    p.add_argument("--log-blowup", type=int, default=DEFAULT_CONFIG.log_blowup)
    p.add_argument("--pow-bits", type=int, default=DEFAULT_CONFIG.proof_of_work_bits)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    p = sub.add_parser("execute", help="dry-run the witness program")
    p.add_argument("--input-file", "-i", required=True)
    p.add_argument("--type", dest="subtype", required=True, choices=sorted(CIRCUITS))
    p.add_argument("--json-schema-file", dest="json_schema", default=None)
    p.add_argument("--show-report", action="store_true", default=False)

    p = sub.add_parser("validate-schema", help="validate a JSON file against a schema")
    p.add_argument("--schema-file", "-s", required=True)
    p.add_argument("--json-file", "-j", required=True)

    p = sub.add_parser("get-schema", help="emit the JSON/YAML schema for a circuit input")
    p.add_argument("--type", dest="subtype", required=True, choices=sorted(CIRCUITS))
    p.add_argument("--schema-type", choices=["json", "yaml"], required=True)
    p.add_argument("--output-file-path", "-o", default=None)

    p = sub.add_parser("verify", help="verify a saved proof")
    p.add_argument("--input-file", "-i", dest="proof_file", required=True)
    p.add_argument("--type", dest="subtype", required=True, choices=sorted(CIRCUITS))
    p.add_argument("--show-report", action="store_true", default=False)
    p.add_argument(
        "--require-curve-binding",
        action="store_true",
        default=False,
        help="reject share-circuit proofs whose curve relations are "
        "omitted or absent (witness-trust fallback)",
    )
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    p = sub.add_parser("node", help="run the HTTP service (experimental)")
    p.add_argument("--port", "-a", type=int, required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def _verify(args) -> int:
    if not os.path.exists(args.proof_file):
        raise CliError(f"Failed to load proof from {args.proof_file}")
    container = load_proof(args.proof_file)
    try:
        result = verify_proof(container, args.subtype, strict=args.require_curve_binding,
                              device=args.device)
    except VerifyError as e:
        print(_style_error(f"Verification failed: {e}"))
        return 1
    if args.show_report:
        print(_style_cyan("Proof report:"))
        print(
            f"circuit: {container['circuit']}, auth: {container['auth']}, "
            f"binding: {result.binding}, "
            f"curve relations: {result.g1_relations} "
            f"(omitted: {result.g1_omitted}), "
            f"signature checks re-run: {result.sig_checks}, "
            f"public values: {len(container['public_values']) // 2} bytes, "
            f"timing: {container.get('timing')}"
        )
        print(f"artifact keccak256: {_artifact_fingerprint(args.proof_file, args.device)}")
    print(_style_success("Proof verified."))
    return 0


def _get_schema(args) -> int:
    spec = get_circuit(args.subtype)
    emit = json_schema_for if args.schema_type == "json" else yaml_schema_for
    text = emit(spec.schema_name, spec.setup.layout, args.auth_commitment)
    if args.output_file_path:
        with open(args.output_file_path, "w") as f:
            f.write(text)
    else:
        print(text)
    return 0


def _node(args) -> int:
    from .service.node import serve

    print(_style_error("WARNING: This is experimental. Don't use this service in production."))
    print(f"Starting server on port {args.port}")
    serve(args.host, args.port, args.auth_commitment, args.device)
    return 0


@contextlib.contextmanager
def _torchrun_ranks(device: str):
    """Under ``torchrun``, the process group for the command (NCCL on the
    card, Gloo on the CPU; never a fallback from one to the other), with
    every rank but 0 silent; elsewhere, nothing."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        yield
        return
    import torch
    import torch.distributed as dist

    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend)
    try:
        if dist.get_rank() == 0:
            yield
        else:
            with contextlib.redirect_stdout(io.StringIO()):
                yield
    finally:
        dist.destroy_process_group()


def run(argv=None) -> int:
    # the git provenance banner goes to stderr, so machine-read stdout
    # (get-schema) stays clean; DVT_NO_BANNER=1 turns it off
    if os.environ.get("DVT_NO_BANNER") != "1":
        from .utils.provenance import print_banner

        print_banner()
    args = build_parser().parse_args(argv)
    with _torchrun_ranks(getattr(args, "device", "cpu")):
        return _run(args)


def _run(args) -> int:
    auth = args.auth_commitment
    try:
        if args.command == "verify":
            return _verify(args)
        if args.command == "validate-schema":
            _validate_if_needed(args.schema_file, args.json_file)
            print(_style_success("Validation successful. No errors found."))
            return 0
        if args.command == "get-schema":
            return _get_schema(args)
        if args.command == "node":
            return _node(args)
        _validate_if_needed(args.json_schema, args.input_file)
        data = _load_typed(args.subtype, args.input_file, auth, args.setup)
        if args.command == "execute":
            result = execute_circuit(args.subtype, data, auth, args.setup)
            if result.exit_code != 0:
                print(_style_error(f"Verification failed: {result.panic_message}"))
                return 1
            if args.show_report:
                print(_style_cyan("Verification report:"))
                print(
                    f"commits: {result.commit_count}, "
                    f"public values: {len(result.public_values)} bytes"
                )
            return 0

        try:
            container = prove_circuit(
                args.subtype, data, auth, _stark_config(args), args.setup, args.device
            )
        except ProveError as e:
            print(_style_error(f"Proof generation failed: {e}"))
            return 1
        path = args.output_file_path or f"{args.input_file}_proof.bin"
        if _rank() != 0:  # every rank holds the same container; rank 0 writes it
            return 0
        save_proof(container, path)
        print(_style_success("Proof saved to:"), path)
        print(f"Artifact keccak256: {_artifact_fingerprint(path, args.device)}")
        return 0
    except CliError as e:
        print(_style_error(str(e)))
        return 1
    except Exception as e:  # any unexpected host error → exit 1
        print(_style_error(f"{type(e).__name__}: {e}"))
        return 1


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
