"""Circuit 1: invalid share exchange (bad_share_exchange_prove).

Re-creates crates/bad_share_exchange_prove/src/main.rs:12-82 and
doc/dkg_verification.md:172-195.  Outcomes:

  * Slashable fault proven  → commit(each verification hash, perpetrator
    commitment pubkey), exit 0
  * valid share / unslashable / malformed input → panic (exit 1)
"""

from __future__ import annotations

from ..dkg.keys import BlsDkgWithSecp256kCommitment
from ..dkg.types import SharedData
from ..dkg.verification import (
    verify_initial_commitment_hash,
    verify_seed_exchange_commitment,
)
from ..utils import cbor
from ..utils.errors import GuestPanic, SlashableError, UnslashableError, VerificationError
from .guest_api import GuestContext


def main(ctx: GuestContext, input_bytes: bytes, auth: bool) -> None:
    run(BlsDkgWithSecp256kCommitment, ctx, input_bytes, auth)


def run(setup, ctx: GuestContext, input_bytes: bytes, auth: bool) -> None:
    try:
        obj = cbor.decode(input_bytes)
        data = SharedData.from_json(obj, setup.layout, auth)
    except Exception as e:
        raise GuestPanic(f"Failed to deserialize share data: {e}") from None

    settings = data.initial_commitment.settings
    if len(data.verification_hashes) != settings.n:
        raise GuestPanic("The number of verification hashes does not match the number of keys")

    if settings.n < settings.k:
        raise GuestPanic("N should be greater than or equal to k")

    if not any(h == data.initial_commitment.hash for h in data.verification_hashes):
        raise GuestPanic("The seed exchange commitment is not part of the verification hashes")

    if not verify_initial_commitment_hash(data.initial_commitment):
        raise GuestPanic("Unsalshable error while verifying commitment hash")

    try:
        verify_seed_exchange_commitment(
            setup,
            data.verification_hashes,
            data.seeds_exchange_commitment,
            data.initial_commitment,
            auth,
        )
    except SlashableError as e:
        print(f"Slashable error seed exchange commitment: {e}")
        for h in data.verification_hashes:
            print(f"Verification hash: {h.hex()}")
            ctx.commit(h)
        print(f"Perpetrator public key: {data.seeds_exchange_commitment.commitment.pubkey.hex()}")
        ctx.commit(data.seeds_exchange_commitment.commitment.pubkey)
        return
    except UnslashableError as e:
        raise GuestPanic(f"Unslashable error seed exchange commitment: {e}") from None
    except VerificationError as e:
        raise GuestPanic(f"Unknown error seed exchange commitment: {e}") from None

    raise GuestPanic("The seed exchange commitment is valid")
