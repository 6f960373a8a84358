"""Circuit 2: incorrect final share generation (bad_parial_key_prove — the
reference crate name's typo is load-bearing for its build, not for ours).

Re-creates crates/bad_parial_key_prove/src/main.rs:16-51.  Outcomes:

  * prove_wrong_final_key_generation raises Slashable → commit(each
    generation base hash, perpetrator commitment pubkey), exit 0
  * returns Ok ("can't prove wrongdoing") or Unslashable → panic (exit 1)
"""

from __future__ import annotations

from ..dkg.keys import BlsDkgWithSecp256kCommitment
from ..dkg.types import BadPartialShareData
from ..dkg.verification import prove_wrong_final_key_generation
from ..utils import cbor
from ..utils.errors import GuestPanic, SlashableError, UnslashableError
from .guest_api import GuestContext


def main(ctx: GuestContext, input_bytes: bytes, auth: bool) -> None:
    run(BlsDkgWithSecp256kCommitment, ctx, input_bytes, auth)


def run(setup, ctx: GuestContext, input_bytes: bytes, auth: bool) -> None:
    try:
        obj = cbor.decode(input_bytes)
        data = BadPartialShareData.from_json(obj, setup.layout, auth)
    except Exception as e:
        raise GuestPanic(f"Failed to deserialize share data: {e}") from None

    try:
        prove_wrong_final_key_generation(setup, data, auth)
    except SlashableError as e:
        for g in data.generations:
            print(f"Verification hash: {g.base_hash.hex()}, {e}")
            ctx.commit(g.base_hash)
        print(f"Perpetrator public key: {data.bad_partial.commitment.pubkey.hex()}")
        ctx.commit(data.bad_partial.commitment.pubkey)
        return
    except UnslashableError as e:
        raise GuestPanic(f"Unslashable error while proving: {e}") from None

    raise GuestPanic("Can't prove wrong doing")
