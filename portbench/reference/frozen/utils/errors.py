"""Error taxonomy mirroring the reference's semantics.

The reference distinguishes (crates/dkg/src/verification.rs:8-12):
  * ``SlashableError``   — the fault is attributable and publicly provable;
  * ``UnslashableError`` — something is wrong but no one can be slashed.

Guest programs turn errors into process-level outcomes
(crates/*/src/main.rs): a Rust ``panic!`` maps to exit code 1, a committed
public-value stream maps to exit code 0.  Here a guest "panic" is the
``GuestPanic`` exception, raised by witness programs and converted to exit
semantics by the executor (circuits/guest_api.py).
"""


class VerificationError(Exception):
    """Base class for DKG verification failures."""


class SlashableError(VerificationError):
    """Provable misbehaviour: the perpetrator can be slashed."""


class UnslashableError(VerificationError):
    """Invalid input / unprovable fault: nobody can be slashed."""


class GuestPanic(Exception):
    """Equivalent of a guest-program ``panic!`` (process exit code 1)."""


class InvalidPoint(ValueError):
    """Raised when decoding an invalid curve point / scalar encoding."""
