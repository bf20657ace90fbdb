"""HTTP beacon-node client: the production upstream connection.

Mirrors ref: the go-eth2-client HTTP service the reference wraps in
app/eth2wrap (eth2wrap.go NewMultiHTTP). Speaks the standard beacon REST
API and maps it onto the framework's duck-typed beacon interface (the
same one BeaconMock implements), so MultiClient/ValidatorCache/fetcher
run unchanged against real infrastructure.

Lazy connections (ref: app/eth2wrap/lazy.go:28): one aiohttp session is
created on first use and re-created after connection errors.
"""

from __future__ import annotations

import asyncio
from typing import Any

import aiohttp

from charon_tpu_torch.core.eth2data import (
    AttestationData,
    Checkpoint,
    Proposal,
    proposal_from_data_json,
    signed_proposal_json,
)
from charon_tpu_torch.eth2util import spec as spec_mod


class HttpError(RuntimeError):
    def __init__(self, status: int, msg: str) -> None:
        super().__init__(msg)
        self.status = status


class NotSyncedError(RuntimeError):
    """Beacon node is still syncing (single-shot probe semantics: the
    scheduler retries — an internal wait loop would starve MultiClient's
    per-call timeout)."""


class Eth2HttpClient:
    def __init__(self, base_url: str, timeout: float = 5.0) -> None:
        self.base_url = base_url.strip().rstrip("/")
        self.timeout = timeout
        self._session: aiohttp.ClientSession | None = None

    # -- lazy session (ref: lazy.go) --------------------------------------

    def _sess(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=self.timeout)
            )
        return self._session

    async def close(self) -> None:
        if self._session and not self._session.closed:
            await self._session.close()

    async def _get(self, path: str, **params) -> Any:
        try:
            async with self._sess().get(
                self.base_url + path, params=params or None
            ) as resp:
                if resp.status != 200:
                    raise HttpError(
                        resp.status,
                        f"GET {path}: HTTP {resp.status} {await resp.text()}",
                    )
                return await resp.json()
        except (aiohttp.ClientConnectionError, asyncio.TimeoutError):
            await self.close()  # force a fresh connection next call
            raise

    async def _post(self, path: str, body: Any, headers=None) -> Any:
        try:
            async with self._sess().post(
                self.base_url + path, json=body, headers=headers
            ) as resp:
                if resp.status not in (200, 202):
                    raise HttpError(
                        resp.status,
                        f"POST {path}: HTTP {resp.status} {await resp.text()}",
                    )
                if resp.content_type == "application/json":
                    return await resp.json()
                return None
        except (aiohttp.ClientConnectionError, asyncio.TimeoutError):
            await self.close()
            raise

    # -- chain state ------------------------------------------------------

    async def await_synced(self) -> None:
        """Single-shot probe: raises NotSyncedError while syncing — the
        scheduler's startup loop retries (BeaconMock returns instantly)."""
        data = (await self._get("/eth/v1/node/syncing"))["data"]
        if data.get("is_syncing", False):
            raise NotSyncedError(self.base_url)

    async def spec(self) -> dict:
        return (await self._get("/eth/v1/config/spec"))["data"]

    async def genesis(self) -> dict:
        return (await self._get("/eth/v1/beacon/genesis"))["data"]

    # -- duties -----------------------------------------------------------

    async def attester_duties(self, epoch: int, validators: dict) -> list:
        idx_to_pubkey = {v: k for k, v in validators.items()}
        data = (
            await self._post(
                f"/eth/v1/validator/duties/attester/{epoch}",
                [str(i) for i in sorted(idx_to_pubkey)],
            )
        )["data"]
        return [
            dict(
                slot=int(d["slot"]),
                pubkey=idx_to_pubkey[int(d["validator_index"])],
                validator_index=int(d["validator_index"]),
                committee_index=int(d["committee_index"]),
                committee_length=int(d["committee_length"]),
                committees_at_slot=int(d["committees_at_slot"]),
                validator_committee_index=int(
                    d["validator_committee_index"]
                ),
            )
            for d in data
        ]

    async def proposer_duties(self, epoch: int, validators: dict) -> list:
        idx_to_pubkey = {v: k for k, v in validators.items()}
        data = (
            await self._get(f"/eth/v1/validator/duties/proposer/{epoch}")
        )["data"]
        return [
            dict(
                slot=int(d["slot"]),
                pubkey=idx_to_pubkey[int(d["validator_index"])],
                validator_index=int(d["validator_index"]),
            )
            for d in data
            if int(d["validator_index"]) in idx_to_pubkey
        ]

    async def sync_duties(self, epoch: int, validators: dict) -> list:
        idx_to_pubkey = {v: k for k, v in validators.items()}
        data = (
            await self._post(
                f"/eth/v1/validator/duties/sync/{epoch}",
                [str(i) for i in sorted(idx_to_pubkey)],
            )
        )["data"]
        return [
            dict(
                pubkey=idx_to_pubkey[int(d["validator_index"])],
                validator_index=int(d["validator_index"]),
                # real committee positions; the scheduler derives the
                # subcommittee (pos // 128) and in-subcommittee bit
                sync_committee_indices=[
                    int(p)
                    for p in d.get("validator_sync_committee_indices", [0])
                ],
            )
            for d in data
        ]

    # -- duty data --------------------------------------------------------

    async def attestation_data(
        self, slot: int, committee_index: int
    ) -> AttestationData:
        d = (
            await self._get(
                "/eth/v1/validator/attestation_data",
                slot=str(slot),
                committee_index=str(committee_index),
            )
        )["data"]
        return AttestationData(
            slot=int(d["slot"]),
            index=int(d["index"]),
            beacon_block_root=_hx(d["beacon_block_root"]),
            source=Checkpoint(
                int(d["source"]["epoch"]), _hx(d["source"]["root"])
            ),
            target=Checkpoint(
                int(d["target"]["epoch"]), _hx(d["target"]["root"])
            ),
        )

    async def block_proposal(
        self, slot: int, proposer_index: int, randao: bytes
    ) -> Proposal:
        """produceBlockV3: parse the full fork-versioned block container
        (or its blinded variant) from the response; the block root the
        cluster signs is computed with spec SSZ from the complete body
        (eth2util/spec.py), exactly as any consensus client would
        (ref: core/fetcher/fetcher.go fetchProposerData +
        eth2wrap Proposal)."""
        j = await self._get(
            f"/eth/v3/validator/blocks/{slot}",
            randao_reveal="0x" + randao.hex(),
        )
        version = j.get("version", spec_mod.latest_fork())
        blinded = str(j.get("execution_payload_blinded", False)).lower() in (
            "true",
            "1",
        )
        return proposal_from_data_json(version, blinded, j["data"])

    # -- aggregation / sync-committee surfaces ----------------------------

    async def aggregate_attestation(self, slot: int, att_data_root: bytes):
        d = (
            await self._get(
                "/eth/v1/validator/aggregate_attestation",
                slot=str(slot),
                attestation_data_root="0x" + att_data_root.hex(),
            )
        )["data"]
        from charon_tpu_torch.core.eth2data import Attestation

        data = d["data"]
        return Attestation(
            aggregation_bits=_bits(d["aggregation_bits"]),
            data=AttestationData(
                slot=int(data["slot"]),
                index=int(data["index"]),
                beacon_block_root=_hx(data["beacon_block_root"]),
                source=Checkpoint(
                    int(data["source"]["epoch"]),
                    _hx(data["source"]["root"]),
                ),
                target=Checkpoint(
                    int(data["target"]["epoch"]),
                    _hx(data["target"]["root"]),
                ),
            ),
            signature=_hx(d["signature"]),
        )

    async def sync_committee_block_root(self, slot: int) -> bytes:
        d = (await self._get("/eth/v1/beacon/blocks/head/root"))["data"]
        return _hx(d["root"])

    async def sync_contribution(
        self, slot: int, subcommittee_index: int, block_root: bytes
    ):
        d = (
            await self._get(
                "/eth/v1/validator/sync_committee_contribution",
                slot=str(slot),
                subcommittee_index=str(subcommittee_index),
                beacon_block_root="0x" + block_root.hex(),
            )
        )["data"]
        from charon_tpu_torch.core.eth2data import SyncCommitteeContribution

        return SyncCommitteeContribution(
            slot=int(d["slot"]),
            beacon_block_root=_hx(d["beacon_block_root"]),
            subcommittee_index=int(d["subcommittee_index"]),
            aggregation_bits=_bits(d["aggregation_bits"]) or tuple([False] * 128),
        )

    # -- inclusion surface (ref: core/tracker/inclusion.go data needs) ----

    async def block_attestations(self, slot: int):
        try:
            data = (
                await self._get(f"/eth/v1/beacon/blocks/{slot}/attestations")
            )["data"]
        except HttpError as e:
            if e.status == 404:
                return None  # genuinely no block at this slot
            raise  # 5xx etc: a transient failure is NOT "not included"
        from charon_tpu_torch.core.eth2data import Attestation

        out = []
        for a in data:
            d = a["data"]
            out.append(
                Attestation(
                    aggregation_bits=_bits(a["aggregation_bits"]),
                    data=AttestationData(
                        slot=int(d["slot"]),
                        index=int(d["index"]),
                        beacon_block_root=_hx(d["beacon_block_root"]),
                        source=Checkpoint(
                            int(d["source"]["epoch"]),
                            _hx(d["source"]["root"]),
                        ),
                        target=Checkpoint(
                            int(d["target"]["epoch"]),
                            _hx(d["target"]["root"]),
                        ),
                    ),
                    signature=_hx(a["signature"]),
                )
            )
        return out

    async def block_root(self, slot: int):
        try:
            d = (await self._get(f"/eth/v1/beacon/blocks/{slot}/root"))[
                "data"
            ]
            return _hx(d["root"])
        except HttpError as e:
            if e.status == 404:
                return None
            raise

    # -- submissions ------------------------------------------------------

    async def submit_attestation(self, att) -> None:
        await self._post(
            "/eth/v1/beacon/pool/attestations", [_att_json(att)]
        )

    async def submit_proposal(self, proposal, signature: bytes) -> None:
        """publishBlock / publishBlindedBlock (v2, with the
        Eth-Consensus-Version header): the exact SignedBeaconBlock (or
        deneb signed block contents) wire shape a production node
        requires."""
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

    async def submit_aggregate(self, agg_and_proof, signature: bytes) -> None:
        agg = agg_and_proof.aggregate
        await self._post(
            "/eth/v1/validator/aggregate_and_proofs",
            [
                {
                    "message": {
                        "aggregator_index": str(
                            agg_and_proof.aggregator_index
                        ),
                        "aggregate": _att_json(agg),
                        "selection_proof": "0x"
                        + agg_and_proof.selection_proof.hex(),
                    },
                    "signature": "0x" + signature.hex(),
                }
            ],
        )

    async def submit_sync_message(self, msg) -> None:
        await self._post(
            "/eth/v1/beacon/pool/sync_committees",
            [
                {
                    "slot": str(msg.slot),
                    "beacon_block_root": "0x"
                    + msg.beacon_block_root.hex(),
                    "validator_index": str(msg.validator_index),
                    "signature": "0x" + msg.signature.hex(),
                }
            ],
        )

    async def submit_contribution(
        self, contrib_and_proof, signature: bytes
    ) -> None:
        c = contrib_and_proof.contribution
        await self._post(
            "/eth/v1/validator/contribution_and_proofs",
            [
                {
                    "message": {
                        "aggregator_index": str(
                            contrib_and_proof.aggregator_index
                        ),
                        "contribution": {
                            "slot": str(c.slot),
                            "beacon_block_root": "0x"
                            + c.beacon_block_root.hex(),
                            "subcommittee_index": str(
                                c.subcommittee_index
                            ),
                            "aggregation_bits": _bits_hex_vector(
                                c.aggregation_bits
                            ),
                            "signature": "0x"
                            + getattr(c, "signature", b"").hex(),
                        },
                        "selection_proof": "0x"
                        + contrib_and_proof.selection_proof.hex(),
                    },
                    "signature": "0x" + signature.hex(),
                }
            ],
        )

    async def submit_exit(self, exit_msg, signature: bytes) -> None:
        await self._post(
            "/eth/v1/beacon/pool/voluntary_exits",
            {
                "message": {
                    "epoch": str(exit_msg.epoch),
                    "validator_index": str(exit_msg.validator_index),
                },
                "signature": "0x" + signature.hex(),
            },
        )

    async def submit_registration(self, reg, signature: bytes) -> None:
        await self._post(
            "/eth/v1/validator/register_validator",
            [
                {
                    "message": {
                        "fee_recipient": "0x"
                        + getattr(reg, "fee_recipient", b"").hex(),
                        "gas_limit": str(getattr(reg, "gas_limit", 0)),
                        "timestamp": str(getattr(reg, "timestamp", 0)),
                        "pubkey": "0x" + getattr(reg, "pubkey", b"").hex(),
                    },
                    "signature": "0x" + signature.hex(),
                }
            ],
        )


def _hx(s: str) -> bytes:
    return bytes.fromhex(s.removeprefix("0x"))


def _bits(hex_bitlist: str) -> tuple[bool, ...]:
    raw = _hx(hex_bitlist)
    bits = []
    for byte in raw:
        for i in range(8):
            bits.append(bool(byte & (1 << i)))
    # strip the SSZ length marker (highest set bit)
    while bits and not bits[-1]:
        bits.pop()
    if bits:
        bits.pop()  # the marker itself
    return tuple(bits)


def _att_json(att) -> dict:
    d = att.data
    return {
        "aggregation_bits": _bits_hex(att.aggregation_bits),
        "data": {
            "slot": str(d.slot),
            "index": str(d.index),
            "beacon_block_root": "0x" + d.beacon_block_root.hex(),
            "source": {
                "epoch": str(d.source.epoch),
                "root": "0x" + d.source.root.hex(),
            },
            "target": {
                "epoch": str(d.target.epoch),
                "root": "0x" + d.target.root.hex(),
            },
        },
        "signature": "0x" + att.signature.hex(),
    }


def _bits_hex(bits) -> str:
    marked = list(bits) + [True]  # SSZ bitlist length marker
    raw = bytearray((len(marked) + 7) // 8)
    for i, bit in enumerate(marked):
        if bit:
            raw[i // 8] |= 1 << (i % 8)
    return "0x" + bytes(raw).hex()


def _bits_hex_vector(bits) -> str:
    """Fixed-size bitvector encoding (no length marker) — sync-committee
    contribution aggregation bits."""
    raw = bytearray((len(bits) + 7) // 8)
    for i, bit in enumerate(bits):
        if bit:
            raw[i // 8] |= 1 << (i % 8)
    return "0x" + bytes(raw).hex()


