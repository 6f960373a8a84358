"""JSON-Schema generation for the circuit input types.

The port's copy of ``dvt_circuits_tpu/dkg/schemas.py``; ``yaml`` is
imported by ``yaml_schema_for`` alone, so the module loads where PyYAML is
missing.

Re-creates the reference's schemars pipeline (types.rs:205-219,
script/gen_spec.sh): draft-07 schemas generated from the type definitions,
with the exact shapes of spec/json/*.json (those four files are the frozen
interface contract — SURVEY.md §2.2).  Definitions and required/properties
keys are sorted alphabetically like serde_json's BTreeMap rendering.
"""

from __future__ import annotations

import json
from typing import Dict

from .types import (
    BLS_BLS_LAYOUT,
    BLS_SECP_LAYOUT,
    BLSPubkeyRaw,
    BLSSecretRaw,
    BLSSignatureRaw,
    DkgGenId,
    SECP256K1PubkeyRaw,
    SECP256K1SignatureRaw,
    SHA256Raw,
    SetupLayout,
)

_U8 = {"type": "integer", "format": "uint8", "minimum": 0.0}
_STRING = {"type": "string"}


def _ref(name: str) -> dict:
    return {"$ref": f"#/definitions/{name}"}


def _arr(item: dict) -> dict:
    return {"type": "array", "items": item}


def _obj(properties: Dict[str, dict]) -> dict:
    return {
        "type": "object",
        "required": sorted(properties),
        "properties": {k: properties[k] for k in sorted(properties)},
    }


def _raw_def(cls) -> dict:
    n = cls.SIZE * 2
    return {
        "description": "Hex encoded byte array",
        "type": "string",
        "maxLength": n,
        "minLength": n,
        "pattern": f"^[0-9a-fA-F]{{{n}}}$",
    }


def _build_definitions(layout: SetupLayout, auth: bool, which: str) -> Dict[str, dict]:
    """Definitions for one root type; `which` picks the reachable set."""
    defs: Dict[str, dict] = {}

    def add_raw(cls):
        defs[cls.__name__] = _raw_def(cls)

    add_raw(DkgGenId)
    add_raw(SHA256Raw)
    defs["GenerateSettings"] = _obj(
        {"gen_id": _ref("DkgGenId"), "k": _U8, "n": _U8}
    )

    commitment_props = {"pubkey": _ref(layout.commitment_pubkey_raw.__name__)}
    if auth:
        commitment_props["hash"] = _ref("SHA256Raw")
        commitment_props["signature"] = _ref(layout.commitment_signature_raw.__name__)

    if which == "SharedData":
        add_raw(layout.point_raw)
        add_raw(layout.dkg_secret_raw)
        add_raw(layout.commitment_pubkey_raw)
        if auth:
            add_raw(layout.commitment_signature_raw)
        defs["Commitment"] = _obj(commitment_props)
        defs["ExchangedSecret"] = _obj(
            {
                "dst_base_hash": _ref("SHA256Raw"),
                "shared_secret": _ref(layout.dkg_secret_raw.__name__),
            }
        )
        defs["InitialCommitment"] = _obj(
            {
                "base_pubkeys": _arr(_ref(layout.point_raw.__name__)),
                "hash": _ref("SHA256Raw"),
                "settings": _ref("GenerateSettings"),
            }
        )
        defs["SeedExchangeCommitment"] = _obj(
            {
                "commitment": _ref("Commitment"),
                "initial_commitment_hash": _ref("SHA256Raw"),
                "ssecret": _ref("ExchangedSecret"),
            }
        )
    elif which == "FinalizationData":
        add_raw(layout.point_raw)
        add_raw(layout.dkg_signature_raw)
        defs["Generation"] = _obj(
            {
                "base_hash": _ref("SHA256Raw"),
                "base_pubkeys": _arr(_ref(layout.point_raw.__name__)),
                "message_cleartext": _STRING,
                "message_signature": _ref(layout.dkg_signature_raw.__name__),
                "partial_pubkey": _ref(layout.dkg_pubkey_raw.__name__),
            }
        )
    elif which == "BadPartialShareData":
        add_raw(layout.point_raw)
        add_raw(layout.dkg_signature_raw)
        add_raw(layout.commitment_pubkey_raw)
        if auth:
            add_raw(layout.commitment_signature_raw)
        defs["Commitment"] = _obj(commitment_props)
        defs["Generation"] = _obj(
            {
                "base_hash": _ref("SHA256Raw"),
                "base_pubkeys": _arr(_ref(layout.point_raw.__name__)),
                "message_cleartext": _STRING,
                "message_signature": _ref(layout.dkg_signature_raw.__name__),
                "partial_pubkey": _ref(layout.dkg_pubkey_raw.__name__),
            }
        )
        defs["BadPartialShare"] = _obj(
            {
                "commitment": _ref("Commitment"),
                "data": _ref("Generation"),
                "settings": _ref("GenerateSettings"),
            }
        )
        defs["BadPartialShareGeneration"] = _obj(
            {
                "base_hash": _ref("SHA256Raw"),
                "base_pubkeys": _arr(_ref(layout.point_raw.__name__)),
            }
        )
    elif which == "BadEncryptedShare":
        add_raw(layout.point_raw)
        add_raw(layout.dkg_secret_raw)
        add_raw(layout.commitment_pubkey_raw)
    else:
        raise KeyError(which)
    return dict(sorted(defs.items()))


_ROOT_PROPS = {
    "SharedData": lambda layout: {
        "base_hashes": _arr(_ref("SHA256Raw")),
        "initial_commitment": _ref("InitialCommitment"),
        "seeds_exchange_commitment": _ref("SeedExchangeCommitment"),
    },
    "FinalizationData": lambda layout: {
        "aggregate_pubkey": _ref(layout.dkg_pubkey_raw.__name__),
        "generations": _arr(_ref("Generation")),
        "settings": _ref("GenerateSettings"),
    },
    "BadPartialShareData": lambda layout: {
        "bad_partial": _ref("BadPartialShare"),
        "generations": _arr(_ref("BadPartialShareGeneration")),
        "settings": _ref("GenerateSettings"),
    },
    "BadEncryptedShare": lambda layout: {
        "base_hashes": _arr(_ref("SHA256Raw")),
        "encrypted_data": _STRING,
        "receiver_base_pubkeys": _arr(_ref(layout.dkg_pubkey_raw.__name__)),
        "receiver_encr_seckey": _ref(layout.dkg_secret_raw.__name__),
        "sender_base_pubkeys": _arr(_ref(layout.dkg_pubkey_raw.__name__)),
        "sender_encr_pubkey": _ref(layout.point_raw.__name__),
        "sender_pubkey": _ref(layout.commitment_pubkey_raw.__name__),
        "settings": _ref("GenerateSettings"),
    },
}


def schema_for(schema_name: str, layout: SetupLayout = BLS_SECP_LAYOUT, auth: bool = True) -> dict:
    props = _ROOT_PROPS[schema_name](layout)
    return {
        "$schema": "http://json-schema.org/draft-07/schema#",
        "title": schema_name,
        "type": "object",
        "required": sorted(props),
        "properties": {k: props[k] for k in sorted(props)},
        "definitions": _build_definitions(layout, auth, schema_name),
    }


def json_schema_for(schema_name: str, layout=BLS_SECP_LAYOUT, auth: bool = True) -> str:
    return json.dumps(schema_for(schema_name, layout, auth), indent=2)


def yaml_schema_for(schema_name: str, layout=BLS_SECP_LAYOUT, auth: bool = True) -> str:
    import yaml  # only this function needs it

    return yaml.safe_dump(schema_for(schema_name, layout, auth), sort_keys=False)


def validate_json(schema: dict, data) -> None:
    """Draft-07 validation (jsonschema lib when present, minimal fallback)."""
    try:
        import jsonschema

        jsonschema.validate(data, schema, cls=jsonschema.Draft7Validator)
    except ImportError:  # pragma: no cover
        _validate_minimal(schema, data, schema)


def _validate_minimal(schema: dict, data, root) -> None:  # pragma: no cover
    import re

    if "$ref" in schema:
        name = schema["$ref"].rsplit("/", 1)[-1]
        return _validate_minimal(root["definitions"][name], data, root)
    t = schema.get("type")
    if t == "object":
        if not isinstance(data, dict):
            raise ValueError("expected object")
        for req in schema.get("required", []):
            if req not in data:
                raise ValueError(f"missing required field {req}")
        for k, sub in schema.get("properties", {}).items():
            if k in data:
                _validate_minimal(sub, data[k], root)
    elif t == "array":
        if not isinstance(data, list):
            raise ValueError("expected array")
        for item in data:
            _validate_minimal(schema["items"], item, root)
    elif t == "string":
        if not isinstance(data, str):
            raise ValueError("expected string")
        pat = schema.get("pattern")
        if pat and not re.match(pat, data):
            raise ValueError(f"string does not match {pat}")
    elif t == "integer":
        if isinstance(data, bool) or not isinstance(data, int):
            raise ValueError("expected integer")
        if data < schema.get("minimum", float("-inf")):
            raise ValueError("integer below minimum")
