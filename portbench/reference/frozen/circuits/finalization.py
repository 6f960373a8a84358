"""Circuit 4: positive proof of successful DKG finalization.

Re-creates crates/finalization_prove/src/main.rs:7-33 — the only circuit
using the all-BLS setup.  Success commits every generation's base hash (in
input order) plus the aggregate pubkey; any verification error panics.
"""

from __future__ import annotations

from ..dkg.keys import BlsDkgWithBlsCommitment
from ..dkg.types import FinalizationData
from ..dkg.verification import verify_generations
from ..utils import cbor
from ..utils.errors import GuestPanic
from .guest_api import GuestContext


def main(ctx: GuestContext, input_bytes: bytes, auth: bool) -> None:
    setup = BlsDkgWithBlsCommitment
    try:
        obj = cbor.decode(input_bytes)
        data = FinalizationData.from_json(obj, setup.layout, auth)
    except Exception as e:
        raise GuestPanic(f"Failed to deserialize share data: {e}") from None

    try:
        agg_key = setup.DkgPubkey.from_bytes(data.aggregate_pubkey)
    except Exception as e:
        raise GuestPanic(f"Invalid aggregated key: {e}") from None

    try:
        verify_generations(setup, data.generations, data.settings, agg_key)
    except Exception as e:
        raise GuestPanic(str(e)) from None

    for g in data.generations:
        print(f"Verification hash: {g.base_hash.hex()}")
        ctx.commit(g.base_hash)

    print(f"Aggregate pubkey: {data.aggregate_pubkey.hex()}")
    ctx.commit(data.aggregate_pubkey)
