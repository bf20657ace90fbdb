"""ValidatorAPI: the beacon-node facade served to the downstream VC.

Mirrors ref: core/validatorapi/validatorapi.go — maps group pubkeys to this
node's pubshares (validatorapi.go:1080,1167), serves duty data with
blocking awaits against DutyDB, verifies every incoming partial signature
against the node's pubshare (validatorapi.go:1213) and pushes it into
ParSigDB as a ParSignedData.

This module is the transport-agnostic component; the HTTP router
(the JAX package's core/vapi_http.py, not ported yet) exposes it as the eth2 beacon API the same
way ref core/validatorapi/router.go does. Partial-signature verification
is batched: one device call per submission set.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Awaitable, Callable, Sequence

from charon_tpu_torch import tbls
from charon_tpu_torch.core.eth2data import (
    Attestation,
    AttestationDuty,
    ParSignedData,
    Proposal,
    SignedData,
)
from charon_tpu_torch.core.types import Duty, DutyType, PubKey, pubkey_to_bytes
from charon_tpu_torch.eth2util.signing import ForkInfo


class VapiError(Exception):
    pass


@dataclass
class ValidatorAPI:
    """share_idx: this node's 1-based share index; pubshares maps group
    pubkey -> this node's compressed pubshare bytes."""

    share_idx: int
    pubshares: dict[PubKey, bytes]
    fork: ForkInfo
    slots_per_epoch: int = 32
    # optional core.cryptoplane.SlotCoalescer: partial-sig pubshare checks
    # from concurrent VC submissions merge into one sharded device program
    plane: object | None = None

    def __post_init__(self) -> None:
        self._subs: list = []
        self._await_attestation = None
        self._await_proposal = None
        self._await_agg_att = None
        self._await_contrib = None
        self._await_sync_msg = None
        self._pubkey_by_att = None
        self._duty_defs = None
        self._await_aggregated = None

    # -- wiring ------------------------------------------------------------

    def subscribe(self, sub) -> None:
        self._subs.append(sub)

    def register_await_attestation(self, fn) -> None:
        self._await_attestation = fn

    def register_await_proposal(self, fn) -> None:
        self._await_proposal = fn

    def register_await_aggregated_attestation(self, fn) -> None:
        self._await_agg_att = fn

    def register_await_sync_contribution(self, fn) -> None:
        self._await_contrib = fn

    def register_await_sync_message(self, fn) -> None:
        self._await_sync_msg = fn

    def register_pubkey_by_attestation(self, fn) -> None:
        self._pubkey_by_att = fn

    def register_get_duty_definition(self, fn) -> None:
        self._duty_defs = fn

    def register_await_aggregated(self, fn) -> None:
        """AggSigDB await — serves aggregated selection proofs back to the
        VC (ref: validatorapi.go:724 AggregateBeaconCommitteeSelections
        returns combined selections, not partials)."""
        self._await_aggregated = fn

    # -- queries (VC pulls duty data; blocking until consensus) ------------

    async def attestation_data(self, slot: int, committee_index: int):
        """GET /eth/v1/validator/attestation_data analogue
        (ref: validatorapi.go:261 via dutydb.AwaitAttestation)."""
        duty = Duty(slot, DutyType.ATTESTER)
        defs = self._duty_defs(duty) if self._duty_defs else {}
        for pubkey, d in defs.items():
            if d.committee_index == committee_index:
                att_duty = await self._await_attestation(slot, pubkey)
                return att_duty.data
        raise VapiError(f"no attester duty for slot {slot} committee {committee_index}")

    async def proposal(self, slot: int, pubkey: PubKey) -> Proposal:
        return await self._await_proposal(slot, pubkey)

    # -- submissions (VC pushes partial signatures) ------------------------

    async def submit_attestations(self, atts: Sequence[Attestation]) -> None:
        """POST /eth/v1/beacon/pool/attestations analogue
        (ref: validatorapi.go:274 SubmitAttestations)."""
        by_duty: dict[Duty, dict[PubKey, ParSignedData]] = {}
        items = []
        metas = []
        for att in atts:
            slot = att.data.slot
            root = att.data.hash_tree_root()
            pubkey = self._pubkey_by_att(slot, root)
            if pubkey is None:
                raise VapiError("unknown attestation (no DutyDB entry)")
            signed = SignedData("attestation", att, att.signature)
            items.append(self._verify_item(pubkey, signed, slot))
            metas.append((Duty(slot, DutyType.ATTESTER), pubkey, signed))
        await self._check_batch(items)
        for duty, pubkey, signed in metas:
            by_duty.setdefault(duty, {})[pubkey] = ParSignedData(
                data=signed, share_idx=self.share_idx
            )
        for duty, signed_set in by_duty.items():
            for sub in self._subs:
                await sub(duty, signed_set)

    async def submit_proposal(self, pubkey: PubKey, proposal: Proposal, signature: bytes) -> None:
        signed = SignedData("block", proposal, signature)
        await self._check_batch([self._verify_item(pubkey, signed, proposal.slot)])
        duty = Duty(proposal.slot, DutyType.PROPOSER)
        for sub in self._subs:
            await sub(duty, {pubkey: ParSignedData(signed, self.share_idx)})

    async def submit_randao(self, slot: int, pubkey: PubKey, signature: bytes) -> None:
        """Randao reveals arrive with proposal requests
        (ref: validatorapi.go:335 Proposal flow)."""
        epoch = slot // self.slots_per_epoch
        signed = SignedData("randao", epoch, signature)
        await self._check_batch([self._verify_item(pubkey, signed, slot)])
        duty = Duty(slot, DutyType.RANDAO)
        for sub in self._subs:
            await sub(duty, {pubkey: ParSignedData(signed, self.share_idx)})

    async def submit_selection_proof(self, slot: int, pubkey: PubKey, signature: bytes) -> None:
        """Beacon-committee selection partials
        (ref: validatorapi.go:724 AggregateBeaconCommitteeSelections)."""
        signed = SignedData("selection_proof", slot, signature)
        await self._check_batch([self._verify_item(pubkey, signed, slot)])
        duty = Duty(slot, DutyType.PREPARE_AGGREGATOR)
        for sub in self._subs:
            await sub(duty, {pubkey: ParSignedData(signed, self.share_idx)})

    async def aggregate_attestation(self, slot: int, att_data_root: bytes):
        """Blocking fetch of the cluster-agreed aggregate."""
        return await self._await_agg_att(slot, att_data_root)

    async def submit_aggregate_and_proof(self, pubkey: PubKey, agg, signature: bytes) -> None:
        signed = SignedData("aggregate_and_proof", agg, signature)
        await self._check_batch(
            [self._verify_item(pubkey, signed, agg.aggregate.data.slot)]
        )
        duty = Duty(agg.aggregate.data.slot, DutyType.AGGREGATOR)
        for sub in self._subs:
            await sub(duty, {pubkey: ParSignedData(signed, self.share_idx)})

    async def aggregate_selection(self, slot: int, pubkey: PubKey):
        """Blocking fetch of the threshold-aggregated beacon-committee
        selection proof (ref: validatorapi.go:724 returns the combined
        proof after cluster-wide aggregation)."""
        duty = Duty(slot, DutyType.PREPARE_AGGREGATOR)
        return await self._await_aggregated(duty, pubkey)

    async def submit_sync_selection(
        self, slot: int, subcommittee_index: int, pubkey: PubKey, signature: bytes
    ) -> None:
        """Sync-committee selection partials
        (ref: validatorapi.go AggregateSyncCommitteeSelections)."""
        from charon_tpu_torch.core.eth2data import SyncSelectionData

        payload = SyncSelectionData(slot, subcommittee_index)
        signed = SignedData("sync_selection", payload, signature)
        await self._check_batch([self._verify_item(pubkey, signed, slot)])
        duty = Duty(slot, DutyType.PREPARE_SYNC_CONTRIBUTION)
        for sub in self._subs:
            await sub(duty, {pubkey: ParSignedData(signed, self.share_idx)})

    async def sync_selection_aggregate(self, slot: int, pubkey: PubKey):
        duty = Duty(slot, DutyType.PREPARE_SYNC_CONTRIBUTION)
        return await self._await_aggregated(duty, pubkey)

    async def sync_contribution(
        self, slot: int, subcommittee_index: int, beacon_block_root: bytes
    ):
        """Blocking fetch of the cluster-agreed sync contribution."""
        return await self._await_contrib(
            slot, subcommittee_index, beacon_block_root
        )

    async def submit_contribution_and_proof(
        self, pubkey: PubKey, cap, signature: bytes
    ) -> None:
        signed = SignedData("contribution_and_proof", cap, signature)
        slot = cap.contribution.slot
        await self._check_batch([self._verify_item(pubkey, signed, slot)])
        duty = Duty(slot, DutyType.SYNC_CONTRIBUTION)
        for sub in self._subs:
            await sub(duty, {pubkey: ParSignedData(signed, self.share_idx)})

    async def sync_message_duty(self, slot: int, pubkey: PubKey):
        return await self._await_sync_msg(slot, pubkey)

    async def submit_sync_message(self, slot: int, pubkey: PubKey, msg, signature: bytes) -> None:
        signed = SignedData("sync_message", msg, signature)
        await self._check_batch([self._verify_item(pubkey, signed, slot)])
        duty = Duty(slot, DutyType.SYNC_MESSAGE)
        for sub in self._subs:
            await sub(duty, {pubkey: ParSignedData(signed, self.share_idx)})

    async def submit_exit(self, pubkey: PubKey, exit_msg, signature: bytes) -> None:
        """Voluntary exit partial (ref: exit flow, validatorapi exit
        endpoints + cmd/exit_sign.go)."""
        signed = SignedData("exit", exit_msg, signature)
        slot = exit_msg.epoch * self.slots_per_epoch
        await self._check_batch([self._verify_item(pubkey, signed, slot)])
        duty = Duty(slot, DutyType.EXIT)
        for sub in self._subs:
            await sub(duty, {pubkey: ParSignedData(signed, self.share_idx)})

    async def submit_registration(self, pubkey: PubKey, reg, signature: bytes, slot: int = 0) -> None:
        signed = SignedData("registration", reg, signature)
        await self._check_batch([self._verify_item(pubkey, signed, slot)])
        duty = Duty(slot, DutyType.BUILDER_REGISTRATION)
        for sub in self._subs:
            await sub(duty, {pubkey: ParSignedData(signed, self.share_idx)})

    # -- helpers -----------------------------------------------------------

    def _verify_item(self, pubkey: PubKey, signed: SignedData, slot: int):
        pubshare = self.pubshares.get(pubkey)
        if pubshare is None:
            raise VapiError(f"unknown validator {pubkey}")
        root = signed.signing_root(self.fork, slot // self.slots_per_epoch)
        return (pubshare, root, signed.signature)

    async def _check_batch(self, items) -> None:
        """Verify partial signatures against pubshares — batched
        (ref: validatorapi.go:1213 one herumi call per signature). With a
        crypto plane installed, concurrent submissions coalesce into one
        sharded device program."""
        if self.plane is not None:
            import asyncio

            from charon_tpu_torch.core.cryptosvc import PlaneOverloadError

            try:
                ok = await self.plane.verify(items)
            except PlaneOverloadError:
                # admission shed (core/cryptosvc backpressure): this
                # VC's submission verifies on the host tbls rung, off
                # the event loop (host BLS would stall it for seconds)
                ok = await asyncio.get_running_loop().run_in_executor(
                    None, tbls.verify_batch, items
                )
        else:
            # plane-less rung (simnet/unit wiring + the no-accelerator
            # floor): deliberately INLINE — an executor hop here GIL-
            # convoys the busy loop and reorders duty timing (measured
            # 7-17x e2e slowdown); production wires the plane, whose
            # path above is truly async
            ok = tbls.verify_batch(items)  # lint: allow(event-loop-blocking)
        if not all(ok):
            raise VapiError("partial signature failed pubshare verification")
