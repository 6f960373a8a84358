"""Circuit registry: kebab-case CLI names → witness programs + data types.

Mirrors the host's CircuitType enum (src/main.rs:36-42) and its dispatch to
the four embedded guest ELFs (src/main.rs:115-118).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..dkg.keys import BlsDkgWithBlsCommitment, BlsDkgWithSecp256kCommitment
from ..dkg.types import (
    BadEncryptedShare,
    BadPartialShareData,
    FinalizationData,
    SharedData,
)
from . import bad_encrypted_share, bad_partial_key, bad_share, finalization


@dataclass(frozen=True)
class CircuitSpec:
    name: str  # CLI name (kebab-case)
    guest: Callable  # guest main(ctx, input_bytes, auth)
    data_type: type  # typed input (has from_json/to_json)
    setup: type  # DKG setup bundle
    schema_name: str  # schemars root title
    spec_file: str  # generated schema file stem (script/gen_spec.sh)
    module: object = None  # circuit module exposing run(setup, ctx, input, auth)

    def with_setup(self, setup_cls) -> "CircuitSpec":
        """Variant bound to a different DKG setup (e.g. BLS identity keys —
        the reference's guests are setup-generic too, but its host pins
        BlsDkgWithSecp256kCommitment; this extension unpins it)."""
        if setup_cls is self.setup:
            return self
        if self.module is None or not hasattr(self.module, "run"):
            return self  # finalization is all-BLS already
        from dataclasses import replace
        from functools import partial

        return replace(
            self, setup=setup_cls, guest=partial(self.module.run, setup_cls)
        )


CIRCUITS = {
    "bad-share": CircuitSpec(
        name="bad-share",
        guest=bad_share.main,
        data_type=SharedData,
        setup=BlsDkgWithSecp256kCommitment,
        schema_name="SharedData",
        spec_file="share_exchange_spec",
        module=bad_share,
    ),
    "finalization": CircuitSpec(
        name="finalization",
        guest=finalization.main,
        data_type=FinalizationData,
        setup=BlsDkgWithBlsCommitment,
        schema_name="FinalizationData",
        spec_file="finalization_spec",
        module=finalization,
    ),
    "bad-partial-key": CircuitSpec(
        name="bad-partial-key",
        guest=bad_partial_key.main,
        data_type=BadPartialShareData,
        setup=BlsDkgWithSecp256kCommitment,
        schema_name="BadPartialShareData",
        spec_file="bad_partial_key_spec",
        module=bad_partial_key,
    ),
    "bad-encrypted-share": CircuitSpec(
        name="bad-encrypted-share",
        guest=bad_encrypted_share.main,
        data_type=BadEncryptedShare,
        setup=BlsDkgWithSecp256kCommitment,
        schema_name="BadEncryptedShare",
        spec_file="bad_encrypted_partial_key_spec",
        module=bad_encrypted_share,
    ),
}

SETUPS = {
    "secp-commitment": BlsDkgWithSecp256kCommitment,
    "bls-commitment": BlsDkgWithBlsCommitment,
}


def get_circuit(name: str, setup: str = "secp-commitment") -> CircuitSpec:
    if name not in CIRCUITS:
        raise KeyError(
            f"unknown circuit type {name!r}; expected one of {sorted(CIRCUITS)}"
        )
    spec = CIRCUITS[name]
    if name == "finalization":
        return spec  # the finalization circuit is pinned to the all-BLS setup
    if setup not in SETUPS:
        raise KeyError(f"unknown setup {setup!r}; expected one of {sorted(SETUPS)}")
    return spec.with_setup(SETUPS[setup])
