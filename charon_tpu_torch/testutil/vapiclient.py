"""HTTP client for the ValidatorAPI router: a VC that speaks only HTTP.

Duck-type compatible with the in-process ValidatorAPI surface that
ValidatorMock drives, so the same duty flows run either in-process or over
the wire (ref: testutil/validatormock talks to charon only through the
beacon API HTTP server; simnet tests assert the HTTP path end-to-end,
testutil/integration/simnet_test.go).
"""

from __future__ import annotations

import aiohttp

from charon_tpu_torch.core.types import PubKey
from charon_tpu_torch.core.validatorapi import VapiError
from charon_tpu_torch.core.eth2data import (
    proposal_from_data_json,
    signed_proposal_json,
)
from charon_tpu_torch.core.vapi_http import (
    _att_data_from_json,
    _att_data_json,
    _attestation_from_json,
    _attestation_json,
    _bits_to_hex,
    _contribution_from_json,
    _contribution_json,
    _hex,
    _unhex,
)


class HttpVapiClient:
    """Each method performs one beacon-API HTTP call against the router."""

    def __init__(self, base_url: str, validators: dict[PubKey, int]) -> None:
        self.base = base_url.rstrip("/")
        self.validators = validators
        self._session: aiohttp.ClientSession | None = None

    async def _sess(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession()
        return self._session

    async def close(self) -> None:
        if self._session and not self._session.closed:
            await self._session.close()

    async def _get(self, path: str, params=None) -> dict:
        s = await self._sess()
        async with s.get(self.base + path, params=params) as resp:
            if resp.status >= 400:
                raise VapiError(f"GET {path}: {resp.status} {await resp.text()}")
            return await resp.json()

    async def _post(self, path: str, payload, headers=None) -> dict | None:
        s = await self._sess()
        async with s.post(
            self.base + path, json=payload, headers=headers
        ) as resp:
            if resp.status >= 400:
                raise VapiError(f"POST {path}: {resp.status} {await resp.text()}")
            if resp.content_type == "application/json":
                return await resp.json()
            return None

    # -- attester ----------------------------------------------------------

    async def attestation_data(self, slot: int, committee_index: int):
        j = await self._get(
            "/eth/v1/validator/attestation_data",
            params={"slot": str(slot), "committee_index": str(committee_index)},
        )
        return _att_data_from_json(j["data"])

    async def submit_attestations(self, atts) -> None:
        await self._post(
            "/eth/v1/beacon/pool/attestations",
            [_attestation_json(a) for a in atts],
        )

    # -- proposer ----------------------------------------------------------

    async def produce_block(self, slot: int, randao_reveal: bytes):
        j = await self._get(
            f"/eth/v3/validator/blocks/{slot}",
            params={"randao_reveal": _hex(randao_reveal)},
        )
        blinded = str(j.get("execution_payload_blinded", False)).lower() in (
            "true",
            "1",
        )
        return proposal_from_data_json(j["version"], blinded, j["data"])

    async def submit_block(self, proposal, signature: bytes) -> None:
        path = (
            "/eth/v2/beacon/blinded_blocks"
            if proposal.blinded
            else "/eth/v2/beacon/blocks"
        )
        await self._post(
            path,
            signed_proposal_json(proposal, signature),
            headers={"Eth-Consensus-Version": proposal.version},
        )

    # -- aggregator --------------------------------------------------------

    async def beacon_committee_selections(self, selections):
        """selections: list of (validator_index, slot, partial_proof).
        Returns list of (validator_index, slot, aggregated_proof)."""
        j = await self._post(
            "/eth/v1/validator/beacon_committee_selections",
            [
                {
                    "validator_index": str(vidx),
                    "slot": str(slot),
                    "selection_proof": _hex(proof),
                }
                for vidx, slot, proof in selections
            ],
        )
        return [
            (int(s["validator_index"]), int(s["slot"]), _unhex(s["selection_proof"]))
            for s in j["data"]
        ]

    async def aggregate_attestation(self, slot: int, att_data_root: bytes):
        j = await self._get(
            "/eth/v1/validator/aggregate_attestation",
            params={
                "slot": str(slot),
                "attestation_data_root": _hex(att_data_root),
            },
        )
        return _attestation_from_json(j["data"])

    async def submit_aggregate_and_proofs(self, items) -> None:
        """items: list of (AggregateAndProof, signature)."""
        await self._post(
            "/eth/v1/validator/aggregate_and_proofs",
            [
                {
                    "message": {
                        "aggregator_index": str(agg.aggregator_index),
                        "aggregate": _attestation_json(agg.aggregate),
                        "selection_proof": _hex(agg.selection_proof),
                    },
                    "signature": _hex(sig),
                }
                for agg, sig in items
            ],
        )

    # -- sync committee ----------------------------------------------------

    async def submit_sync_messages(self, msgs) -> None:
        await self._post(
            "/eth/v1/beacon/pool/sync_committees",
            [
                {
                    "slot": str(m.slot),
                    "beacon_block_root": _hex(m.beacon_block_root),
                    "validator_index": str(m.validator_index),
                    "signature": _hex(m.signature),
                }
                for m in msgs
            ],
        )

    async def sync_committee_selections(self, selections):
        """selections: list of (validator_index, slot, subcommittee_index,
        partial_proof) -> aggregated."""
        j = await self._post(
            "/eth/v1/validator/sync_committee_selections",
            [
                {
                    "validator_index": str(vidx),
                    "slot": str(slot),
                    "subcommittee_index": str(sub),
                    "selection_proof": _hex(proof),
                }
                for vidx, slot, sub, proof in selections
            ],
        )
        return [
            (
                int(s["validator_index"]),
                int(s["slot"]),
                int(s["subcommittee_index"]),
                _unhex(s["selection_proof"]),
            )
            for s in j["data"]
        ]

    async def sync_committee_contribution(
        self, slot: int, subcommittee_index: int, beacon_block_root: bytes
    ):
        j = await self._get(
            "/eth/v1/validator/sync_committee_contribution",
            params={
                "slot": str(slot),
                "subcommittee_index": str(subcommittee_index),
                "beacon_block_root": _hex(beacon_block_root),
            },
        )
        return _contribution_from_json(j["data"])

    async def submit_contribution_and_proofs(self, items) -> None:
        await self._post(
            "/eth/v1/validator/contribution_and_proofs",
            [
                {
                    "message": {
                        "aggregator_index": str(cap.aggregator_index),
                        "contribution": _contribution_json(cap.contribution),
                        "selection_proof": _hex(cap.selection_proof),
                    },
                    "signature": _hex(sig),
                }
                for cap, sig in items
            ],
        )

    # -- registrations / exits --------------------------------------------

    async def register_validators(self, items) -> None:
        """items: list of (ValidatorRegistration, signature)."""
        await self._post(
            "/eth/v1/validator/register_validator",
            [
                {
                    "message": {
                        "fee_recipient": _hex(reg.fee_recipient),
                        "gas_limit": str(reg.gas_limit),
                        "timestamp": str(reg.timestamp),
                        "pubkey": _hex(reg.pubkey),
                    },
                    "signature": _hex(sig),
                }
                for reg, sig in items
            ],
        )

    async def submit_voluntary_exit(self, exit_msg, signature: bytes) -> None:
        await self._post(
            "/eth/v1/beacon/pool/voluntary_exits",
            {
                "message": {
                    "epoch": str(exit_msg.epoch),
                    "validator_index": str(exit_msg.validator_index),
                },
                "signature": _hex(signature),
            },
        )

    async def head_root(self, slot: int | None = None) -> bytes:
        params = {"slot": str(slot)} if slot is not None else None
        j = await self._get("/eth/v1/beacon/blocks/head/root", params=params)
        return _unhex(j["data"]["root"])

    # -- metadata ----------------------------------------------------------

    async def get_validators(self, ids=None):
        params = {"id": ",".join(ids)} if ids else None
        j = await self._get("/eth/v1/beacon/states/head/validators", params=params)
        return j["data"]

    async def attester_duties(self, epoch: int, indices) -> list:
        j = await self._post(
            f"/eth/v1/validator/duties/attester/{epoch}",
            [str(i) for i in indices],
        )
        return j["data"]

    async def proposer_duties(self, epoch: int) -> list:
        j = await self._get(f"/eth/v1/validator/duties/proposer/{epoch}")
        return j["data"]

    async def node_version(self) -> str:
        j = await self._get("/eth/v1/node/version")
        return j["data"]["version"]


class SchemaCheckedVapiClient(HttpVapiClient):
    """HttpVapiClient that asserts every request body and response
    against the published beacon-API OpenAPI shapes
    (testutil/schemas.py). A violation raises SchemaError mid-duty, so
    any flow completed under this client is schema-conformant — the
    in-repo stand-in for the reference's real-VC integration tier
    (ref: testutil/integration runs Teku against charon's vapi)."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.checked = 0
        self.unmatched: list[tuple[str, str]] = []

    def _check(self, method: str, path: str, req, resp) -> None:
        from charon_tpu_torch.testutil import schemas

        route = schemas.find_route(method, path)
        if route is None:
            self.unmatched.append((method, path))
            return
        req_schema, resp_schema = route
        if req_schema is not None and req is not None:
            schemas.validate(req_schema, req, f"{method} {path} request")
        if resp_schema is not None:
            schemas.validate(resp_schema, resp, f"{method} {path} response")
        self.checked += 1

    async def _get(self, path: str, params=None) -> dict:
        j = await super()._get(path, params)
        self._check("GET", path, None, j)
        return j

    async def _post(self, path: str, payload, headers=None):
        j = await super()._post(path, payload, headers)
        self._check("POST", path, payload, j)
        return j
