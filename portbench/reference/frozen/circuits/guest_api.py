"""Witness-program ("guest") ABI.

Re-creates the sp1-zkvm runtime surface the reference guests rely on
(``sp1_zkvm::io::read`` / ``io::commit`` / ``panic!``):

  * input: one CBOR blob (the host writes it to guest stdin, src/main.rs:435)
  * ``GuestContext.commit`` appends to the public-values stream using the
    same framing SP1's bincode serialization produces for the committed
    types (u64-LE length prefix + UTF-8 hex text for raw byte newtypes and
    strings)
  * any uncaught exception == ``panic!`` == exit code 1; a clean return ==
    exit code 0 (script/run.sh:85-96 exit-code contract)

The same witness programs run in two modes: ``execute`` (exit-code/public
values only — what the golden-vector suite checks) and ``prove`` (the public
values additionally get bound into a STARK via the prover pipeline).
"""

from __future__ import annotations

import io
import traceback
from contextlib import redirect_stdout
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from ..dkg.types import RawBytes


class GuestContext:
    """Guest-side I/O: the committed public-values stream."""

    def __init__(self) -> None:
        self.public_values = bytearray()
        self.commit_count = 0

    def commit(self, value) -> None:
        """Serialize a value into the public-values stream.

        Matches SP1's ``io::commit`` framing for the types the guests commit:
        raw byte newtypes and strings serialize as length-prefixed text (the
        raw types' serde impl emits hex strings).
        """
        if isinstance(value, RawBytes):
            payload = value.hex().encode("ascii")
        elif isinstance(value, str):
            payload = value.encode("utf-8")
        elif isinstance(value, bytes):
            payload = value
        else:
            raise TypeError(f"unsupported commit type: {type(value)!r}")
        self.public_values += len(payload).to_bytes(8, "little")
        self.public_values += payload
        self.commit_count += 1


@dataclass
class GuestResult:
    exit_code: int
    public_values: bytes
    stdout: str = ""
    panic_message: Optional[str] = None
    commit_count: int = 0

    @property
    def ok(self) -> bool:
        return self.exit_code == 0


def run_guest(
    guest_fn: Callable[[GuestContext, bytes, bool], None],
    input_bytes: bytes,
    auth: bool,
    capture_stdout: bool = True,
) -> GuestResult:
    """Execute a witness program with panic → exit-code-1 semantics."""
    ctx = GuestContext()
    buf = io.StringIO()
    try:
        if capture_stdout:
            with redirect_stdout(buf):
                guest_fn(ctx, input_bytes, auth)
        else:
            guest_fn(ctx, input_bytes, auth)
    except Exception as e:  # any exception == guest panic == exit 1
        msg = f"{type(e).__name__}: {e}"
        return GuestResult(
            exit_code=1,
            public_values=bytes(ctx.public_values),
            stdout=buf.getvalue(),
            panic_message=msg,
            commit_count=ctx.commit_count,
        )
    return GuestResult(
        exit_code=0,
        public_values=bytes(ctx.public_values),
        stdout=buf.getvalue(),
        commit_count=ctx.commit_count,
    )
