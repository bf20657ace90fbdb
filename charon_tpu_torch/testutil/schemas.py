"""Strict beacon-API schema validation for the validator-API surface.

The reference proves its vapi against REAL validator clients (Teku in
testutil/integration, full clients in the compose tier); this image has
no VC binary, so the equivalent rigor comes from asserting every request
and response against the published beacon-API OpenAPI shapes
(github.com/ethereum/beacon-APIs): field presence, quoted-uint64 and
0x-hex formats, and container structure. A stock VC parses exactly these
shapes — any violation here is a bug a real client would hit.

Use: `SchemaClient` wraps the HTTP test client and validates every
exchange against the route table; `validate(schema, value, where)`
raises SchemaError with a precise JSON path on the first violation.
"""

from __future__ import annotations

import re
from typing import Any, Callable


class SchemaError(AssertionError):
    pass


def _fail(where: str, msg: str) -> None:
    raise SchemaError(f"{where}: {msg}")


# -- combinators -------------------------------------------------------------


def Uint(where: str, v: Any) -> None:
    """Quoted uint64/uint256 — the beacon API serializes ALL integers as
    decimal strings."""
    if not isinstance(v, str) or not v.isdigit():
        _fail(where, f"expected quoted uint, got {v!r}")


def Hex(length: int | None = None) -> Callable:
    def check(where: str, v: Any) -> None:
        # whole bytes only: odd nibble counts are not decodable and a
        # real VC's hex parser rejects them
        if not isinstance(v, str) or not re.fullmatch(
            r"0x(?:[0-9a-fA-F]{2})*", v
        ):
            _fail(where, f"expected 0x-hex string (whole bytes), got {v!r}")
        if length is not None and len(v) != 2 + 2 * length:
            _fail(where, f"expected {length}-byte hex, got {len(v) // 2 - 1}")

    return check


def HexVar(where: str, v: Any) -> None:
    Hex(None)(where, v)


def Bool(where: str, v: Any) -> None:
    if not isinstance(v, bool):
        _fail(where, f"expected bool, got {v!r}")


def Str(where: str, v: Any) -> None:
    if not isinstance(v, str):
        _fail(where, f"expected string, got {v!r}")


def Enum(*values: str) -> Callable:
    def check(where: str, v: Any) -> None:
        if v not in values:
            _fail(where, f"expected one of {values}, got {v!r}")

    return check


def Arr(item: Callable) -> Callable:
    def check(where: str, v: Any) -> None:
        if not isinstance(v, list):
            _fail(where, f"expected array, got {type(v).__name__}")
        for i, x in enumerate(v):
            item(f"{where}[{i}]", x)

    return check


def Obj(fields: dict[str, Callable], optional: tuple[str, ...] = ()) -> Callable:
    """Every non-optional field REQUIRED with its format; extra fields
    are allowed (the spec permits additive evolution)."""

    def check(where: str, v: Any) -> None:
        if not isinstance(v, dict):
            _fail(where, f"expected object, got {type(v).__name__}")
        for name, sub in fields.items():
            if name not in v:
                if name in optional:
                    continue
                _fail(where, f"missing required field {name!r}")
            sub(f"{where}.{name}", v[name])

    return check


def OneOf(*alts: Callable) -> Callable:
    def check(where: str, v: Any) -> None:
        errors = []
        for alt in alts:
            try:
                alt(where, v)
                return
            except SchemaError as e:
                errors.append(str(e))
        _fail(where, "no variant matched: " + " | ".join(errors))

    return check


def Data(inner: Callable, extra: dict[str, Callable] | None = None, optional: tuple[str, ...] = ()) -> Callable:
    return Obj({"data": inner, **(extra or {})}, optional=optional)


# -- consensus containers ----------------------------------------------------

CHECKPOINT = Obj({"epoch": Uint, "root": Hex(32)})
ATT_DATA = Obj(
    {
        "slot": Uint,
        "index": Uint,
        "beacon_block_root": Hex(32),
        "source": CHECKPOINT,
        "target": CHECKPOINT,
    }
)
ATTESTATION = Obj(
    {"aggregation_bits": HexVar, "data": ATT_DATA, "signature": Hex(96)}
)
ETH1_DATA = Obj(
    {"deposit_root": Hex(32), "deposit_count": Uint, "block_hash": Hex(32)}
)
SYNC_AGGREGATE = Obj(
    {"sync_committee_bits": Hex(64), "sync_committee_signature": Hex(96)}
)
_PAYLOAD_COMMON = {
    "parent_hash": Hex(32),
    "fee_recipient": Hex(20),
    "state_root": Hex(32),
    "receipts_root": Hex(32),
    "logs_bloom": Hex(256),
    "prev_randao": Hex(32),
    "block_number": Uint,
    "gas_limit": Uint,
    "gas_used": Uint,
    "timestamp": Uint,
    "extra_data": HexVar,
    "base_fee_per_gas": Uint,
    "block_hash": Hex(32),
}
WITHDRAWAL = Obj(
    {"index": Uint, "validator_index": Uint, "address": Hex(20), "amount": Uint}
)
EXECUTION_PAYLOAD_DENEB = Obj(
    {
        **_PAYLOAD_COMMON,
        "transactions": Arr(HexVar),
        "withdrawals": Arr(WITHDRAWAL),
        "blob_gas_used": Uint,
        "excess_blob_gas": Uint,
    }
)
EXECUTION_PAYLOAD_HEADER_DENEB = Obj(
    {
        **_PAYLOAD_COMMON,
        "transactions_root": Hex(32),
        "withdrawals_root": Hex(32),
        "blob_gas_used": Uint,
        "excess_blob_gas": Uint,
    }
)
_BODY_COMMON = {
    "randao_reveal": Hex(96),
    "eth1_data": ETH1_DATA,
    "graffiti": Hex(32),
    "proposer_slashings": Arr(Obj({})),
    "attester_slashings": Arr(Obj({})),
    "attestations": Arr(ATTESTATION),
    "deposits": Arr(Obj({})),
    "voluntary_exits": Arr(Obj({})),
    "sync_aggregate": SYNC_AGGREGATE,
    "bls_to_execution_changes": Arr(Obj({})),
}
BLOCK_BODY_DENEB = Obj(
    {
        **_BODY_COMMON,
        "execution_payload": EXECUTION_PAYLOAD_DENEB,
        "blob_kzg_commitments": Arr(Hex(48)),
    }
)
BLINDED_BODY_DENEB = Obj(
    {
        **_BODY_COMMON,
        "execution_payload_header": EXECUTION_PAYLOAD_HEADER_DENEB,
        "blob_kzg_commitments": Arr(Hex(48)),
    }
)


def _block(body: Callable) -> Callable:
    return Obj(
        {
            "slot": Uint,
            "proposer_index": Uint,
            "parent_root": Hex(32),
            "state_root": Hex(32),
            "body": body,
        }
    )


BLOCK_DENEB = _block(BLOCK_BODY_DENEB)
BLINDED_BLOCK_DENEB = _block(BLINDED_BODY_DENEB)
BLOCK_CONTENTS_DENEB = Obj(
    {
        "block": BLOCK_DENEB,
        "kzg_proofs": Arr(Hex(48)),
        "blobs": Arr(HexVar),
    }
)
SIGNED_BLOCK_DENEB = Obj({"message": BLOCK_DENEB, "signature": Hex(96)})
SIGNED_BLOCK_CONTENTS_DENEB = Obj(
    {
        "signed_block": SIGNED_BLOCK_DENEB,
        "kzg_proofs": Arr(Hex(48)),
        "blobs": Arr(HexVar),
    }
)
SIGNED_BLINDED_BLOCK_DENEB = Obj(
    {"message": BLINDED_BLOCK_DENEB, "signature": Hex(96)}
)

CONTRIBUTION = Obj(
    {
        "slot": Uint,
        "beacon_block_root": Hex(32),
        "subcommittee_index": Uint,
        "aggregation_bits": Hex(16),
        "signature": Hex(96),
    }
)
SYNC_MSG = Obj(
    {
        "slot": Uint,
        "beacon_block_root": Hex(32),
        "validator_index": Uint,
        "signature": Hex(96),
    }
)
REGISTRATION = Obj(
    {
        "message": Obj(
            {
                "fee_recipient": Hex(20),
                "gas_limit": Uint,
                "timestamp": Uint,
                "pubkey": Hex(48),
            }
        ),
        "signature": Hex(96),
    }
)
SIGNED_EXIT = Obj(
    {
        "message": Obj({"epoch": Uint, "validator_index": Uint}),
        "signature": Hex(96),
    }
)
AGG_AND_PROOF = Obj(
    {
        "message": Obj(
            {
                "aggregator_index": Uint,
                "aggregate": ATTESTATION,
                "selection_proof": Hex(96),
            }
        ),
        "signature": Hex(96),
    }
)
CONTRIB_AND_PROOF = Obj(
    {
        "message": Obj(
            {
                "aggregator_index": Uint,
                "contribution": CONTRIBUTION,
                "selection_proof": Hex(96),
            }
        ),
        "signature": Hex(96),
    }
)
BEACON_SELECTION = Obj(
    {"validator_index": Uint, "slot": Uint, "selection_proof": Hex(96)}
)
SYNC_SELECTION = Obj(
    {
        "validator_index": Uint,
        "slot": Uint,
        "subcommittee_index": Uint,
        "selection_proof": Hex(96),
    }
)

ATTESTER_DUTY = Obj(
    {
        "pubkey": Hex(48),
        "validator_index": Uint,
        "committee_index": Uint,
        "committee_length": Uint,
        "committees_at_slot": Uint,
        "validator_committee_index": Uint,
        "slot": Uint,
    }
)
PROPOSER_DUTY = Obj(
    {"pubkey": Hex(48), "validator_index": Uint, "slot": Uint}
)
SYNC_DUTY = Obj(
    {
        "pubkey": Hex(48),
        "validator_index": Uint,
        "validator_sync_committee_indices": Arr(Uint),
    }
)
VALIDATOR_RESP = Obj(
    {
        "index": Uint,
        "balance": Uint,
        "status": Str,
        "validator": Obj(
            {
                "pubkey": Hex(48),
                "withdrawal_credentials": Hex(32),
                "effective_balance": Uint,
                "slashed": Bool,
                "activation_eligibility_epoch": Uint,
                "activation_epoch": Uint,
                "exit_epoch": Uint,
                "withdrawable_epoch": Uint,
            }
        ),
    }
)

PRODUCE_BLOCK_V3 = Obj(
    {
        "version": Enum("phase0", "altair", "bellatrix", "capella", "deneb", "electra"),
        "execution_payload_blinded": Bool,
        "execution_payload_value": Uint,
        "consensus_block_value": Uint,
        "data": OneOf(BLOCK_CONTENTS_DENEB, BLINDED_BLOCK_DENEB, BLOCK_DENEB),
    }
)

# -- route table -------------------------------------------------------------
# (method, path regex) -> (request schema | None, response schema | None)

ROUTES: list[tuple[str, str, Callable | None, Callable | None]] = [
    (
        "GET",
        r"/eth/v1/validator/attestation_data",
        None,
        Data(ATT_DATA),
    ),
    ("POST", r"/eth/v[12]/beacon/pool/attestations", Arr(ATTESTATION), None),
    ("GET", r"/eth/v3/validator/blocks/\d+", None, PRODUCE_BLOCK_V3),
    (
        "POST",
        r"/eth/v[12]/beacon/blocks",
        OneOf(SIGNED_BLOCK_CONTENTS_DENEB, SIGNED_BLOCK_DENEB),
        None,
    ),
    (
        "POST",
        r"/eth/v[12]/beacon/blinded_blocks",
        SIGNED_BLINDED_BLOCK_DENEB,
        None,
    ),
    (
        "POST",
        r"/eth/v1/validator/beacon_committee_selections",
        Arr(BEACON_SELECTION),
        Data(Arr(BEACON_SELECTION)),
    ),
    (
        "GET",
        r"/eth/v[12]/validator/aggregate_attestation",
        None,
        Data(ATTESTATION),
    ),
    (
        "POST",
        r"/eth/v[12]/validator/aggregate_and_proofs",
        Arr(AGG_AND_PROOF),
        None,
    ),
    ("POST", r"/eth/v1/beacon/pool/sync_committees", Arr(SYNC_MSG), None),
    (
        "POST",
        r"/eth/v1/validator/sync_committee_selections",
        Arr(SYNC_SELECTION),
        Data(Arr(SYNC_SELECTION)),
    ),
    (
        "GET",
        r"/eth/v1/validator/sync_committee_contribution",
        None,
        Data(CONTRIBUTION),
    ),
    (
        "POST",
        r"/eth/v1/validator/contribution_and_proofs",
        Arr(CONTRIB_AND_PROOF),
        None,
    ),
    (
        "POST",
        r"/eth/v1/validator/register_validator",
        Arr(REGISTRATION),
        None,
    ),
    ("POST", r"/eth/v1/beacon/pool/voluntary_exits", SIGNED_EXIT, None),
    (
        "POST",
        r"/eth/v1/validator/duties/attester/\d+",
        Arr(Uint),
        Data(
            Arr(ATTESTER_DUTY),
            extra={"dependent_root": Hex(32)},
            optional=("dependent_root",),
        ),
    ),
    (
        "GET",
        r"/eth/v1/validator/duties/proposer/\d+",
        None,
        Data(
            Arr(PROPOSER_DUTY),
            extra={"dependent_root": Hex(32)},
            optional=("dependent_root",),
        ),
    ),
    (
        "POST",
        r"/eth/v1/validator/duties/sync/\d+",
        Arr(Uint),
        Data(Arr(SYNC_DUTY)),
    ),
    (
        "GET",
        r"/eth/v1/beacon/states/[^/]+/validators/[^/]+",
        None,
        Data(VALIDATOR_RESP),
    ),
    (
        "GET",
        r"/eth/v1/beacon/states/[^/]+/validators",
        None,
        Data(Arr(VALIDATOR_RESP)),
    ),
    (
        "POST",
        r"/eth/v1/beacon/states/[^/]+/validators",
        None,
        Data(Arr(VALIDATOR_RESP)),
    ),
    (
        "GET",
        r"/eth/v1/beacon/blocks/head/root",
        None,
        Data(Obj({"root": Hex(32)})),
    ),
    ("GET", r"/eth/v1/node/version", None, Data(Obj({"version": Str}))),
    (
        "GET",
        r"/eth/v1/node/syncing",
        None,
        Data(
            Obj(
                {
                    "head_slot": Uint,
                    "sync_distance": Uint,
                    "is_syncing": Bool,
                },
            )
        ),
    ),
    (
        "GET",
        r"/eth/v1/beacon/genesis",
        None,
        Data(
            Obj(
                {
                    "genesis_time": Uint,
                    "genesis_validators_root": Hex(32),
                    "genesis_fork_version": Hex(4),
                }
            )
        ),
    ),
    (
        "GET",
        r"/eth/v1/beacon/states/[^/]+/fork",
        None,
        Data(
            Obj(
                {
                    "previous_version": Hex(4),
                    "current_version": Hex(4),
                    "epoch": Uint,
                }
            )
        ),
    ),
]


def find_route(method: str, path: str):
    for m, pattern, req, resp in ROUTES:
        if m == method and re.fullmatch(pattern, path):
            return req, resp
    return None


def validate(schema: Callable, value: Any, where: str) -> None:
    schema(where, value)
