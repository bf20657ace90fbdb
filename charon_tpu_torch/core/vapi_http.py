"""HTTP router for the ValidatorAPI: the eth2 beacon API served to VCs.

Mirrors ref: core/validatorapi/router.go:97-253 — the full intercepted
endpoint set served locally with blocking awaits:

  attester:    attestation_data, submit attestations
  proposer:    v3 blocks (randao partial via query param), submit
               (blinded) blocks
  aggregator:  beacon-committee selections (partials in, aggregated out),
               aggregate_attestation, aggregate_and_proofs
  sync:        sync duties, sync-committee messages, sync-committee
               selections, contribution, contribution_and_proofs
  lifecycle:   validators (pubshare <-> group pubkey mapping), duties
               (attester/proposer/sync), registrations, voluntary exit,
               prepare_beacon_proposer, subscriptions, genesis/spec/fork,
               node version/health/syncing

Everything else 404s with a clear error (the reference proxies unknown
routes to the upstream BN, router.go proxyHandler; the simnet beacon mock
serves no extra routes worth proxying).

JSON schema follows the eth2 beacon API shapes for the implemented
endpoints (integers as strings, 0x-hex byte fields).
"""

from __future__ import annotations

import json
from dataclasses import dataclass

from aiohttp import web

from charon_tpu_torch.core.eth2data import (
    AggregateAndProof,
    Attestation,
    AttestationData,
    Checkpoint,
    ContributionAndProof,
    Proposal,
    SyncCommitteeContribution,
    SyncCommitteeMessage,
    ValidatorRegistration,
    VoluntaryExit,
    proposal_data_json,
    proposal_data_ssz,
    signed_proposal_from_json,
    signed_proposal_from_ssz,
)
from charon_tpu_torch.core.types import Duty, DutyType, PubKey
from charon_tpu_torch.core.validatorapi import ValidatorAPI, VapiError
from charon_tpu_torch.eth2util import spec

# ---------------------------------------------------------------------------
# JSON codecs (eth2 beacon API shapes)
# ---------------------------------------------------------------------------


def _hex(b: bytes) -> str:
    return "0x" + b.hex()


def _unhex(s: str) -> bytes:
    return bytes.fromhex(s[2:] if s.startswith("0x") else s)


# One SSZ-bitfield/attestation JSON codec exists: the descriptor-driven
# one in eth2util/spec.py. The wrappers below keep the local call sites
# and legacy signatures (proposal shapes live in core/eth2data.py).


def _att_data_json(d: AttestationData) -> dict:
    return spec.to_json(d)


def _att_data_from_json(j: dict) -> AttestationData:
    return spec.from_json(AttestationData, j)


def _bits_from_hex(hexstr: str) -> tuple[bool, ...]:
    return spec.bits_from_bytes(_unhex(hexstr), sentinel=True)


def _bits_to_hex(bits: tuple[bool, ...]) -> str:
    return "0x" + spec.bits_to_bytes(bits, sentinel=True).hex()


def _bitvector_to_hex(bits: tuple[bool, ...], size: int = 128) -> str:
    full = tuple(bits) + (False,) * (size - len(bits))
    return "0x" + spec.bits_to_bytes(full[:size], sentinel=False).hex()


def _bitvector_from_hex(hexstr: str, size: int = 128) -> tuple[bool, ...]:
    return spec.bits_from_bytes(_unhex(hexstr), sentinel=False, length=size)


def _attestation_json(a: Attestation) -> dict:
    return spec.to_json(a)


def _attestation_from_json(j: dict) -> Attestation:
    return spec.from_json(Attestation, j)


def _contribution_json(c: SyncCommitteeContribution) -> dict:
    return {
        "slot": str(c.slot),
        "beacon_block_root": _hex(c.beacon_block_root),
        "subcommittee_index": str(c.subcommittee_index),
        "aggregation_bits": _bitvector_to_hex(c.aggregation_bits),
        "signature": _hex(c.signature),
    }


def _contribution_from_json(j: dict) -> SyncCommitteeContribution:
    return SyncCommitteeContribution(
        slot=int(j["slot"]),
        beacon_block_root=_unhex(j["beacon_block_root"]),
        subcommittee_index=int(j["subcommittee_index"]),
        aggregation_bits=_bitvector_from_hex(j["aggregation_bits"]),
        signature=_unhex(j["signature"]),
    )


def _err(status: int, message: str) -> web.Response:
    return web.json_response({"code": status, "message": message}, status=status)


class VapiRouter:
    """vapi: the transport-agnostic component; beacon: duck-typed client
    for duties resolution; validators: group pubkey -> validator index."""

    def __init__(
        self,
        vapi: ValidatorAPI,
        beacon=None,
        validators: dict[PubKey, int] | None = None,
        genesis_time: float = 0.0,
        slots_per_epoch: int = 32,
        slot_duration: float = 12.0,
        clock=None,
    ) -> None:
        from charon_tpu_torch.core.deadline import SlotClock

        self.vapi = vapi
        self.beacon = beacon
        self.validators = validators or {}
        self.genesis_time = genesis_time
        self.slots_per_epoch = slots_per_epoch
        self.slot_duration = slot_duration
        self.clock = clock or SlotClock(genesis_time, max(slot_duration, 1e-9))
        # pubshare (this node's) -> group pubkey, for VC keystore lookups
        # (ref: validatorapi.go:1080,1167 pubshare<->group mapping)
        self._group_by_pubshare = {
            "0x" + ps.hex(): gpk for gpk, ps in vapi.pubshares.items()
        }
        self._pubkey_by_index = {
            i: pk for pk, i in self.validators.items()
        }
        self.app = web.Application()
        self.app.add_routes(
            [
                # attester (ref: router.go:115,121)
                web.get("/eth/v1/validator/attestation_data", self._attestation_data),
                web.post("/eth/v1/beacon/pool/attestations", self._submit_attestations),
                web.post("/eth/v2/beacon/pool/attestations", self._submit_attestations),
                # proposer (ref: router.go:151,157-175)
                web.get("/eth/v3/validator/blocks/{slot}", self._produce_block_v3),
                web.post("/eth/v1/beacon/blocks", self._submit_block),
                web.post("/eth/v2/beacon/blocks", self._submit_block),
                web.post("/eth/v1/beacon/blinded_blocks", self._submit_block),
                web.post("/eth/v2/beacon/blinded_blocks", self._submit_block),
                # aggregator (ref: router.go:127-145, validatorapi.go:724)
                web.post(
                    "/eth/v1/validator/beacon_committee_selections",
                    self._beacon_committee_selections,
                ),
                web.get(
                    "/eth/v1/validator/aggregate_attestation",
                    self._aggregate_attestation,
                ),
                web.get(
                    "/eth/v2/validator/aggregate_attestation",
                    self._aggregate_attestation,
                ),
                web.post(
                    "/eth/v1/validator/aggregate_and_proofs",
                    self._aggregate_and_proofs,
                ),
                web.post(
                    "/eth/v2/validator/aggregate_and_proofs",
                    self._aggregate_and_proofs,
                ),
                # sync committee (ref: router.go:181-205)
                web.post("/eth/v1/beacon/pool/sync_committees", self._submit_sync_messages),
                web.post(
                    "/eth/v1/validator/sync_committee_selections",
                    self._sync_committee_selections,
                ),
                web.get(
                    "/eth/v1/validator/sync_committee_contribution",
                    self._sync_contribution,
                ),
                web.post(
                    "/eth/v1/validator/contribution_and_proofs",
                    self._contribution_and_proofs,
                ),
                # registrations / exits (ref: router.go:211-223)
                web.post("/eth/v1/validator/register_validator", self._register_validator),
                web.post("/eth/v1/beacon/pool/voluntary_exits", self._voluntary_exit),
                # duties (ref: router.go:97-113)
                web.post("/eth/v1/validator/duties/attester/{epoch}", self._attester_duties),
                web.get("/eth/v1/validator/duties/proposer/{epoch}", self._proposer_duties),
                web.post("/eth/v1/validator/duties/sync/{epoch}", self._sync_duties),
                # validators mapping (ref: validatorapi.go:1080)
                web.get(
                    "/eth/v1/beacon/states/{state_id}/validators", self._get_validators
                ),
                web.post(
                    "/eth/v1/beacon/states/{state_id}/validators", self._get_validators
                ),
                web.get(
                    "/eth/v1/beacon/states/{state_id}/validators/{validator_id}",
                    self._get_validator,
                ),
                # accepted no-ops the VC expects 200 from
                web.post("/eth/v1/validator/prepare_beacon_proposer", self._ok),
                web.post("/eth/v1/validator/beacon_committee_subscriptions", self._ok),
                web.post("/eth/v1/validator/sync_committee_subscriptions", self._ok),
                # head block root for sync-committee messages — blocks on
                # the cluster-agreed SYNC_MESSAGE root so every node's VC
                # signs the same root (the reference proxies this to the BN
                # and relies on BN agreement; consensus is this framework's
                # redesign for the same endpoint)
                web.get("/eth/v1/beacon/blocks/head/root", self._head_root),
                # node / chain metadata
                web.get("/eth/v1/node/version", self._node_version),
                web.get("/eth/v1/node/syncing", self._syncing),
                web.get("/eth/v1/node/health", self._health),
                web.get("/eth/v1/beacon/genesis", self._genesis),
                web.get("/eth/v1/config/spec", self._spec),
                web.get("/eth/v1/config/fork_schedule", self._fork_schedule),
                web.get("/eth/v1/beacon/states/{state_id}/fork", self._state_fork),
            ]
        )
        # everything else is proxied verbatim to the upstream beacon node
        # when one is configured (ref: router.go proxyHandler — the
        # reference forwards unmatched beacon-API traffic to the BN)
        self.app.router.add_route("*", "/{tail:.*}", self._proxy)
        self._runner: web.AppRunner | None = None
        self.proxy_url: str | None = None
        self._proxy_session = None

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self._runner = web.AppRunner(self.app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, host, port)
        await site.start()
        return site._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._proxy_session is not None:
            await self._proxy_session.close()
            self._proxy_session = None
        if self._runner:
            await self._runner.cleanup()

    # hop-by-hop headers never forwarded in either direction (RFC 9110 §7.6)
    _HOP_HEADERS = frozenset(
        (
            "host",
            "connection",
            "content-length",
            "transfer-encoding",
            "keep-alive",
            "upgrade",
            "proxy-authenticate",
            "proxy-authorization",
            "te",
            "trailer",
        )
    )

    async def _proxy(self, request: web.Request) -> web.Response:
        if not self.proxy_url:
            return _err(404, f"unknown endpoint {request.path}")
        import aiohttp

        if self._proxy_session is None or self._proxy_session.closed:
            # one pooled session for the VC hot path — per-request
            # sessions would pay TCP/TLS setup on every proxied call
            self._proxy_session = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=10)
            )
        url = self.proxy_url.rstrip("/") + request.path_qs
        try:
            async with self._proxy_session.request(
                request.method,
                url,
                data=await request.read(),
                headers={
                    k: v
                    for k, v in request.headers.items()
                    if k.lower() not in self._HOP_HEADERS
                },
            ) as resp:
                body = await resp.read()
                # forward end-to-end response headers: the VC needs e.g.
                # Eth-Consensus-Version to decode fork-aware bodies.
                # content-encoding is dropped too: aiohttp has already
                # decompressed the body we are about to send verbatim
                headers = {
                    k: v
                    for k, v in resp.headers.items()
                    if k.lower() not in self._HOP_HEADERS
                    and k.lower() not in ("content-type", "content-encoding")
                }
                return web.Response(
                    status=resp.status,
                    body=body,
                    content_type=resp.content_type,
                    headers=headers,
                )
        except Exception as e:
            return _err(502, f"beacon proxy failed: {e}")

    # -- pubkey resolution -------------------------------------------------

    def _resolve_pubkey(self, pk_hex: str) -> PubKey:
        """Accept a group pubkey or this node's pubshare for it
        (the VC's keystores hold pubshares, ref: validatorapi.go:1167)."""
        pk_hex = pk_hex.lower()
        if pk_hex in self._group_by_pubshare:
            return self._group_by_pubshare[pk_hex]
        return PubKey(pk_hex)

    # -- attester ----------------------------------------------------------

    async def _attestation_data(self, request: web.Request) -> web.Response:
        """ref: router.go:115 attestation_data -> blocking DutyDB await."""
        try:
            slot = int(request.query["slot"])
            committee_index = int(request.query["committee_index"])
        except (KeyError, ValueError):
            return _err(400, "slot and committee_index required")
        try:
            data = await self.vapi.attestation_data(slot, committee_index)
        except VapiError as e:
            return _err(404, str(e))
        return web.json_response({"data": _att_data_json(data)})

    async def _submit_attestations(self, request: web.Request) -> web.Response:
        """ref: router.go:121 + validatorapi.go:274."""
        try:
            body = await request.json()
            if isinstance(body, dict):  # v2 shape {version, data}
                body = body["data"]
            atts = [_attestation_from_json(a) for a in body]
        except (json.JSONDecodeError, KeyError, ValueError, TypeError) as e:
            return _err(400, f"malformed attestation: {e}")
        try:
            await self.vapi.submit_attestations(atts)
        except VapiError as e:
            return _err(400, str(e))
        return web.Response(status=200)

    # -- proposer ----------------------------------------------------------

    async def _produce_block_v3(self, request: web.Request) -> web.Response:
        """GET /eth/v3/validator/blocks/{slot}?randao_reveal=0x...

        The randao reveal IS this node's partial randao signature; it is
        verified + stored, the aggregated randao unblocks the proposal
        fetcher, and the response blocks until cluster consensus on the
        block (ref: validatorapi.go:335-399 Proposal)."""
        try:
            slot = int(request.match_info["slot"])
            randao = _unhex(request.query["randao_reveal"])
        except (KeyError, ValueError):
            return _err(400, "slot and randao_reveal required")
        defs = (
            self.vapi._duty_defs(Duty(slot, DutyType.PROPOSER))
            if self.vapi._duty_defs
            else {}
        )
        if not defs:
            return _err(404, f"no proposer duty at slot {slot}")
        # Key by PUBKEY, not an arbitrary duty entry: the randao reveal is
        # a partial signature by exactly one validator's share, so the
        # candidate whose pubshare verifies it identifies the proposer —
        # correct even when two cluster validators propose in the same
        # slot (ref: router.go maps proposals by pubkey).
        pubkey, last_err = None, None
        for candidate in defs:
            try:
                await self.vapi.submit_randao(slot, candidate, randao)
                pubkey = candidate
                break
            except VapiError as e:
                last_err = e
        if pubkey is None:
            return _err(400, f"randao reveal matches no proposer: {last_err}")
        try:
            proposal = await self.vapi.proposal(slot, pubkey)
        except VapiError as e:
            return _err(400, str(e))
        headers = {
            "Eth-Consensus-Version": proposal.version,
            "Eth-Execution-Payload-Blinded": str(proposal.blinded).lower(),
            "Eth-Execution-Payload-Value": "0",
            "Eth-Consensus-Block-Value": "0",
        }
        if "application/octet-stream" in request.headers.get("Accept", ""):
            # SSZ response (Lighthouse-style clients prefer it for blocks)
            return web.Response(
                body=proposal_data_ssz(proposal),
                content_type="application/octet-stream",
                headers=headers,
            )
        return web.json_response(
            {
                "version": proposal.version,
                "execution_payload_blinded": proposal.blinded,
                "execution_payload_value": "0",
                "consensus_block_value": "0",
                "data": proposal_data_json(proposal),
            },
            headers=headers,
        )

    async def _submit_block(self, request: web.Request) -> web.Response:
        """Accepts the spec publishBlock/publishBlindedBlock POST body:
        a SignedBeaconBlock {message, signature} (or deneb signed block
        contents {signed_block, kzg_proofs, blobs}), with the fork taken
        from the Eth-Consensus-Version header when present
        (ref: router.go:157-175 + validatorapi.go:490 SubmitProposal)."""
        blinded = "blinded_blocks" in request.path
        version = request.headers.get("Eth-Consensus-Version")
        try:
            # branch on the RAW header: aiohttp's content_type property
            # defaults to octet-stream when the header is absent, which
            # would misroute header-less JSON POSTs to the SSZ path
            if "octet-stream" in request.headers.get("Content-Type", ""):
                # SSZ body: the spec requires the consensus-version header
                if not version:
                    return _err(
                        400,
                        "Eth-Consensus-Version header required for SSZ",
                    )
                proposal, signature = signed_proposal_from_ssz(
                    await request.read(), blinded, version
                )
            else:
                j = await request.json()
                proposal, signature = signed_proposal_from_json(
                    j, blinded, version
                )
        except (json.JSONDecodeError, KeyError, ValueError, TypeError) as e:
            return _err(400, f"malformed block: {e}")
        # key by PUBKEY via the block's proposer index (ref: router.go
        # submitProposal resolves the proposal by pubkey, never "the
        # first duty at this slot")
        pubkey = self._pubkey_by_index.get(proposal.proposer_index)
        if pubkey is None:
            # router built without a validators mapping: resolve through
            # the slot's proposer duty definitions instead
            defs = (
                self.vapi._duty_defs(Duty(proposal.slot, DutyType.PROPOSER))
                if self.vapi._duty_defs
                else {}
            )
            for pk, dd in defs.items():
                if getattr(dd, "validator_index", None) == proposal.proposer_index:
                    pubkey = pk
                    break
            # no single-def fallback: attributing a mismatched
            # proposer_index to the slot's only duty holder would be
            # caught by share-signature verification downstream, but
            # masks the VC's actual misconfiguration as a bad signature;
            # the 404 below is the actionable answer
        if pubkey is None:
            return _err(
                404,
                f"unknown proposer index {proposal.proposer_index} "
                f"at slot {proposal.slot}",
            )
        try:
            await self.vapi.submit_proposal(pubkey, proposal, signature)
        except VapiError as e:
            return _err(400, str(e))
        return web.Response(status=200)

    # -- aggregator --------------------------------------------------------

    async def _beacon_committee_selections(self, request: web.Request) -> web.Response:
        """Partial selection proofs in, threshold-aggregated proofs out
        (ref: validatorapi.go:724 AggregateBeaconCommitteeSelections)."""
        try:
            body = await request.json()
            parsed = [
                (
                    self._resolve_pubkey_by_index(int(s["validator_index"])),
                    int(s["slot"]),
                    _unhex(s["selection_proof"]),
                )
                for s in body
            ]
        except (
            json.JSONDecodeError, KeyError, ValueError, TypeError, VapiError
        ) as e:
            return _err(400, f"malformed selections: {e}")
        out = []
        try:
            for pubkey, slot, proof in parsed:
                await self.vapi.submit_selection_proof(slot, pubkey, proof)
            for pubkey, slot, _ in parsed:
                agg = await self.vapi.aggregate_selection(slot, pubkey)
                out.append(
                    {
                        "validator_index": str(self.validators.get(pubkey, 0)),
                        "slot": str(slot),
                        "selection_proof": _hex(agg.signature),
                    }
                )
        except VapiError as e:
            return _err(400, str(e))
        return web.json_response({"data": out})

    async def _aggregate_attestation(self, request: web.Request) -> web.Response:
        try:
            slot = int(request.query["slot"])
            root = _unhex(request.query["attestation_data_root"])
        except (KeyError, ValueError):
            return _err(400, "slot and attestation_data_root required")
        try:
            agg = await self.vapi.aggregate_attestation(slot, root)
        except VapiError as e:
            return _err(404, str(e))
        # DutyDB stores the consensus AggregateAndProof; the endpoint
        # serves the aggregate attestation inside it.
        att = agg.aggregate if hasattr(agg, "aggregate") else agg
        return web.json_response(
            {"version": "deneb", "data": _attestation_json(att)}
        )

    async def _aggregate_and_proofs(self, request: web.Request) -> web.Response:
        try:
            body = await request.json()
            if isinstance(body, dict):
                body = body["data"]
            items = []
            for sap in body:
                m = sap["message"]
                agg = AggregateAndProof(
                    aggregator_index=int(m["aggregator_index"]),
                    aggregate=_attestation_from_json(m["aggregate"]),
                    selection_proof=_unhex(m["selection_proof"]),
                )
                items.append((agg, _unhex(sap["signature"])))
        except (json.JSONDecodeError, KeyError, ValueError, TypeError) as e:
            return _err(400, f"malformed aggregate: {e}")
        try:
            for agg, sig in items:
                pubkey = self._resolve_pubkey_by_index(agg.aggregator_index)
                await self.vapi.submit_aggregate_and_proof(pubkey, agg, sig)
        except VapiError as e:
            return _err(400, str(e))
        return web.Response(status=200)

    # -- sync committee ----------------------------------------------------

    async def _submit_sync_messages(self, request: web.Request) -> web.Response:
        try:
            body = await request.json()
            msgs = [
                SyncCommitteeMessage(
                    slot=int(m["slot"]),
                    beacon_block_root=_unhex(m["beacon_block_root"]),
                    validator_index=int(m["validator_index"]),
                    signature=_unhex(m["signature"]),
                )
                for m in body
            ]
        except (json.JSONDecodeError, KeyError, ValueError, TypeError) as e:
            return _err(400, f"malformed sync message: {e}")
        try:
            for m in msgs:
                pubkey = self._resolve_pubkey_by_index(m.validator_index)
                await self.vapi.submit_sync_message(
                    m.slot, pubkey, m, m.signature
                )
        except VapiError as e:
            return _err(400, str(e))
        return web.Response(status=200)

    async def _sync_committee_selections(self, request: web.Request) -> web.Response:
        try:
            body = await request.json()
            parsed = [
                (
                    self._resolve_pubkey_by_index(int(s["validator_index"])),
                    int(s["slot"]),
                    int(s["subcommittee_index"]),
                    _unhex(s["selection_proof"]),
                )
                for s in body
            ]
        except (
            json.JSONDecodeError, KeyError, ValueError, TypeError, VapiError
        ) as e:
            return _err(400, f"malformed selections: {e}")
        out = []
        try:
            for pubkey, slot, subidx, proof in parsed:
                await self.vapi.submit_sync_selection(slot, subidx, pubkey, proof)
            for pubkey, slot, subidx, _ in parsed:
                agg = await self.vapi.sync_selection_aggregate(slot, pubkey)
                out.append(
                    {
                        "validator_index": str(self.validators.get(pubkey, 0)),
                        "slot": str(slot),
                        "subcommittee_index": str(subidx),
                        "selection_proof": _hex(agg.signature),
                    }
                )
        except VapiError as e:
            return _err(400, str(e))
        return web.json_response({"data": out})

    async def _sync_contribution(self, request: web.Request) -> web.Response:
        try:
            slot = int(request.query["slot"])
            subidx = int(request.query["subcommittee_index"])
            root = _unhex(request.query["beacon_block_root"])
        except (KeyError, ValueError):
            return _err(400, "slot, subcommittee_index, beacon_block_root required")
        try:
            contrib = await self.vapi.sync_contribution(slot, subidx, root)
        except VapiError as e:
            return _err(404, str(e))
        return web.json_response({"data": _contribution_json(contrib)})

    async def _contribution_and_proofs(self, request: web.Request) -> web.Response:
        try:
            body = await request.json()
            items = []
            for scp in body:
                m = scp["message"]
                cap = ContributionAndProof(
                    aggregator_index=int(m["aggregator_index"]),
                    contribution=_contribution_from_json(m["contribution"]),
                    selection_proof=_unhex(m["selection_proof"]),
                )
                items.append((cap, _unhex(scp["signature"])))
        except (json.JSONDecodeError, KeyError, ValueError, TypeError) as e:
            return _err(400, f"malformed contribution: {e}")
        try:
            for cap, sig in items:
                pubkey = self._resolve_pubkey_by_index(cap.aggregator_index)
                await self.vapi.submit_contribution_and_proof(pubkey, cap, sig)
        except VapiError as e:
            return _err(400, str(e))
        return web.Response(status=200)

    # -- registrations / exits ---------------------------------------------

    async def _register_validator(self, request: web.Request) -> web.Response:
        try:
            body = await request.json()
            items = []
            for r in body:
                m = r["message"]
                reg = ValidatorRegistration(
                    fee_recipient=_unhex(m["fee_recipient"]),
                    gas_limit=int(m["gas_limit"]),
                    timestamp=int(m["timestamp"]),
                    pubkey=_unhex(m["pubkey"]),
                )
                items.append((reg, _unhex(r["signature"])))
        except (json.JSONDecodeError, KeyError, ValueError, TypeError) as e:
            return _err(400, f"malformed registration: {e}")
        try:
            for reg, sig in items:
                pubkey = self._resolve_pubkey("0x" + reg.pubkey.hex())
                await self.vapi.submit_registration(pubkey, reg, sig)
        except VapiError as e:
            return _err(400, str(e))
        return web.Response(status=200)

    async def _voluntary_exit(self, request: web.Request) -> web.Response:
        try:
            j = await request.json()
            exit_msg = VoluntaryExit(
                epoch=int(j["message"]["epoch"]),
                validator_index=int(j["message"]["validator_index"]),
            )
            signature = _unhex(j["signature"])
        except (json.JSONDecodeError, KeyError, ValueError, TypeError) as e:
            return _err(400, f"malformed exit: {e}")
        try:
            pubkey = self._resolve_pubkey_by_index(exit_msg.validator_index)
            await self.vapi.submit_exit(pubkey, exit_msg, signature)
        except VapiError as e:
            return _err(400, str(e))
        return web.Response(status=200)

    # -- duties ------------------------------------------------------------

    def _resolve_pubkey_by_index(self, vidx: int) -> PubKey:
        pk = self._pubkey_by_index.get(vidx)
        if pk is None:
            raise VapiError(f"unknown validator index {vidx}")
        return pk

    async def _attester_duties(self, request: web.Request) -> web.Response:
        if self.beacon is None:
            return _err(404, "no beacon client")
        epoch = int(request.match_info["epoch"])
        try:
            want = {int(i) for i in await request.json()}
        except (json.JSONDecodeError, ValueError, TypeError):
            want = set(self.validators.values())
        duties = await self.beacon.attester_duties(epoch, self.validators)
        out = [
            {
                "pubkey": d["pubkey"],
                "validator_index": str(d["validator_index"]),
                "committee_index": str(d["committee_index"]),
                "committee_length": str(d["committee_length"]),
                "committees_at_slot": str(d["committees_at_slot"]),
                "validator_committee_index": str(d["validator_committee_index"]),
                "slot": str(d["slot"]),
            }
            for d in duties
            if d["validator_index"] in want
        ]
        return web.json_response(
            {"dependent_root": _hex(bytes(32)), "data": out}
        )

    async def _proposer_duties(self, request: web.Request) -> web.Response:
        if self.beacon is None:
            return _err(404, "no beacon client")
        epoch = int(request.match_info["epoch"])
        duties = await self.beacon.proposer_duties(epoch, self.validators)
        out = [
            {
                "pubkey": d["pubkey"],
                "validator_index": str(d["validator_index"]),
                "slot": str(d["slot"]),
            }
            for d in duties
        ]
        return web.json_response(
            {"dependent_root": _hex(bytes(32)), "data": out}
        )

    async def _sync_duties(self, request: web.Request) -> web.Response:
        if self.beacon is None:
            return _err(404, "no beacon client")
        epoch = int(request.match_info["epoch"])
        try:
            want = {int(i) for i in await request.json()}
        except (json.JSONDecodeError, ValueError, TypeError):
            want = set(self.validators.values())
        duties = await self.beacon.sync_duties(epoch, self.validators)
        # serve the validator's REAL committee position — the scheduler
        # derives subcommittee (pos // 128) and in-subcommittee bit
        # (pos % 128) from the same position. Served positions are
        # limited to the FIRST (the one the scheduler drives) so the
        # VC's contribution queries always match a stored duty; extra
        # seats are a logged, documented limitation (scheduler.py).
        out = [
            {
                "pubkey": d["pubkey"],
                "validator_index": str(d["validator_index"]),
                "validator_sync_committee_indices": [
                    str(int(p))
                    for p in d.get(
                        "sync_committee_indices",
                        [d.get("subcommittee_index", 0) * 128],
                    )[:1]
                ],
            }
            for d in duties
            if d["validator_index"] in want
        ]
        return web.json_response({"data": out})

    # -- validators mapping ------------------------------------------------

    def _validator_json(self, pubkey_hex: str, vidx: int) -> dict:
        return {
            "index": str(vidx),
            "balance": "32000000000",
            "status": "active_ongoing",
            "validator": {
                "pubkey": pubkey_hex,
                "withdrawal_credentials": _hex(bytes(32)),
                "effective_balance": "32000000000",
                "slashed": False,
                "activation_eligibility_epoch": "0",
                "activation_epoch": "0",
                "exit_epoch": "18446744073709551615",
                "withdrawable_epoch": "18446744073709551615",
            },
        }

    async def _get_validators(self, request: web.Request) -> web.Response:
        """Serves cluster validators; querying by this node's pubshare
        returns the entry with the pubshare as pubkey so an unmodified VC
        sees "its" keys as active (ref: validatorapi.go:1080,1167)."""
        ids: list[str] = []
        if request.method == "POST":
            try:
                j = await request.json()
                ids = list(j.get("ids", []))
            except (json.JSONDecodeError, AttributeError):
                ids = []
        else:
            # beacon API sends repeated ?id=...&id=... keys; comma-separated
            # values inside each are also accepted
            ids = [
                part
                for raw in request.query.getall("id", [])
                for part in raw.split(",")
                if part
            ]
        out = []
        if not ids:
            for pk, vidx in sorted(self.validators.items()):
                out.append(self._validator_json(pk, vidx))
        else:
            for ident in ids:
                ident = ident.lower()
                group = self._resolve_pubkey(ident) if ident.startswith("0x") else None
                if group is not None and group in self.validators:
                    out.append(
                        self._validator_json(ident, self.validators[group])
                    )
                elif ident.isdigit():
                    try:
                        pk = self._resolve_pubkey_by_index(int(ident))
                        out.append(self._validator_json(pk, int(ident)))
                    except VapiError:
                        pass
        return web.json_response({"data": out})

    async def _get_validator(self, request: web.Request) -> web.Response:
        ident = request.match_info["validator_id"].lower()
        if ident.startswith("0x"):
            group = self._resolve_pubkey(ident)
            if group in self.validators:
                return web.json_response(
                    {"data": self._validator_json(ident, self.validators[group])}
                )
        elif ident.isdigit():
            try:
                pk = self._resolve_pubkey_by_index(int(ident))
                return web.json_response(
                    {"data": self._validator_json(pk, int(ident))}
                )
            except VapiError:
                pass
        return _err(404, f"validator {ident} not found")

    async def _head_root(self, request: web.Request) -> web.Response:
        """Cluster-agreed head root for sync-committee signing. `slot` may
        be passed to select the SYNC_MESSAGE duty (defaults to the current
        slot by genesis arithmetic)."""
        try:
            if "slot" in request.query:
                slot = int(request.query["slot"])
            else:
                import time as _t

                # wall by design: "current slot" is wall-clock genesis
                # arithmetic, same timeline the VC's BN view uses
                slot = self.clock.slot_at(_t.time())  # lint: allow(monotonic-clock)
        except ValueError:
            return _err(400, "bad slot")
        defs = (
            self.vapi._duty_defs(Duty(slot, DutyType.SYNC_MESSAGE))
            if self.vapi._duty_defs
            else {}
        )
        if not defs:
            return _err(404, f"no sync duty at slot {slot}")
        duty = await self.vapi.sync_message_duty(slot, next(iter(defs)))
        return web.json_response(
            {"data": {"root": _hex(duty.beacon_block_root)}}
        )

    # -- metadata ----------------------------------------------------------

    async def _ok(self, request: web.Request) -> web.Response:
        return web.Response(status=200)

    async def _node_version(self, request: web.Request) -> web.Response:
        from charon_tpu_torch import __version__ as version

        return web.json_response({"data": {"version": f"charon-tpu/{version}"}})

    async def _syncing(self, request: web.Request) -> web.Response:
        return web.json_response(
            {
                "data": {
                    "head_slot": "0",
                    "sync_distance": "0",
                    "is_syncing": False,
                    "is_optimistic": False,
                }
            }
        )

    async def _health(self, request: web.Request) -> web.Response:
        return web.Response(status=200)

    async def _genesis(self, request: web.Request) -> web.Response:
        return web.json_response(
            {
                "data": {
                    "genesis_time": str(int(self.genesis_time)),
                    "genesis_validators_root": _hex(
                        self.vapi.fork.genesis_validators_root
                    ),
                    "genesis_fork_version": _hex(
                        self.vapi.fork.genesis_fork_version
                    ),
                }
            }
        )

    async def _spec(self, request: web.Request) -> web.Response:
        return web.json_response(
            {
                "data": {
                    "SECONDS_PER_SLOT": str(int(self.slot_duration) or 1),
                    "SLOTS_PER_EPOCH": str(self.slots_per_epoch),
                    "DOMAIN_BEACON_ATTESTER": "0x01000000",
                    "DOMAIN_BEACON_PROPOSER": "0x00000000",
                    "DOMAIN_RANDAO": "0x02000000",
                }
            }
        )

    async def _fork_schedule(self, request: web.Request) -> web.Response:
        fv = _hex(self.vapi.fork.fork_version)
        return web.json_response(
            {
                "data": [
                    {
                        "previous_version": fv,
                        "current_version": fv,
                        "epoch": "0",
                    }
                ]
            }
        )

    async def _state_fork(self, request: web.Request) -> web.Response:
        fv = _hex(self.vapi.fork.fork_version)
        return web.json_response(
            {
                "data": {
                    "previous_version": fv,
                    "current_version": fv,
                    "epoch": "0",
                },
                "execution_optimistic": False,
            }
        )
