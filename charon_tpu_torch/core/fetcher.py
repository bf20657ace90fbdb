"""Fetcher: stateless duty input data fetch + consensus proposal.

Mirrors ref: core/fetcher/fetcher.go — fetches attestation data / block
proposals / aggregates from the beacon node per duty (fetcher.go:114, 237),
pulling prerequisite aggregated signatures (randao for proposals, selection
proofs for aggregates) from AggSigDB, then proposes the unsigned data set
to consensus.
"""

from __future__ import annotations

from typing import Awaitable, Callable

from charon_tpu_torch.core.eth2data import AttestationDuty, Proposal
from charon_tpu_torch.core.scheduler import DutyDefinition
from charon_tpu_torch.core.types import Duty, DutyType, PubKey


class Fetcher:
    def __init__(self, beacon) -> None:
        self.beacon = beacon
        self._propose = None
        self._await_agg_sig = None
        self._await_attestation = None

    def register_consensus(self, propose) -> None:
        self._propose = propose

    def register_agg_sig_db(self, await_) -> None:
        """ref: core/fetcher/fetcher.go:103 RegisterAggSigDB."""
        self._await_agg_sig = await_

    def register_await_attestation(self, await_att) -> None:
        """ref: core/fetcher/fetcher.go:109 RegisterAwaitAttData."""
        self._await_attestation = await_att

    async def fetch(
        self, duty: Duty, defs: dict[PubKey, DutyDefinition]
    ) -> None:
        """ref: core/fetcher/fetcher.go:50 Fetch."""
        if duty.type == DutyType.ATTESTER:
            unsigned = await self._fetch_attester(duty, defs)
        elif duty.type == DutyType.PROPOSER:
            unsigned = await self._fetch_proposer(duty, defs)
        elif duty.type == DutyType.AGGREGATOR:
            unsigned = await self._fetch_aggregator(duty, defs)
        elif duty.type == DutyType.SYNC_MESSAGE:
            unsigned = await self._fetch_sync_message(duty, defs)
        elif duty.type == DutyType.SYNC_CONTRIBUTION:
            unsigned = await self._fetch_sync_contribution(duty, defs)
        else:
            raise ValueError(f"unsupported fetch duty type {duty.type}")
        if unsigned:
            await self._propose(duty, unsigned)

    async def _fetch_attester(self, duty, defs):
        out: dict[PubKey, AttestationDuty] = {}
        # One att-data query per distinct committee (ref: fetcher.go:114).
        data_by_committee: dict[int, object] = {}
        for pubkey, d in defs.items():
            data = data_by_committee.get(d.committee_index)
            if data is None:
                data = await self.beacon.attestation_data(
                    duty.slot, d.committee_index
                )
                data_by_committee[d.committee_index] = data
            out[pubkey] = AttestationDuty(
                data=data,
                committee_length=d.committee_length,
                committee_index=d.committee_index,
                validator_committee_index=d.validator_committee_index,
            )
        return out

    async def _fetch_aggregator(self, duty, defs):
        """Aggregate attestations: needs the attestation data root from
        DutyDB plus the aggregated selection proof from AggSigDB
        (ref: core/fetcher/fetcher.go:158 aggregate flow)."""
        from charon_tpu_torch.core.eth2data import AggregateAndProof

        out = {}
        for pubkey, d in defs.items():
            # the aggregated selection proof gates aggregation and is
            # embedded in the unsigned AggregateAndProof the VC signs
            # (ref: fetcher.go:158 + eth2exp selections).
            sel = await self._await_agg_sig(
                Duty(duty.slot, DutyType.PREPARE_AGGREGATOR), pubkey
            )
            att_duty = await self._await_attestation(duty.slot, pubkey)
            root = att_duty.data.hash_tree_root()
            agg_att = await self.beacon.aggregate_attestation(duty.slot, root)
            out[pubkey] = AggregateAndProof(
                aggregator_index=d.validator_index,
                aggregate=agg_att,
                selection_proof=sel.signature,
            )
        return out

    async def _fetch_sync_message(self, duty, defs):
        from charon_tpu_torch.core.eth2data import SyncMessageDuty

        root = await self.beacon.sync_committee_block_root(duty.slot)
        return {pk: SyncMessageDuty(beacon_block_root=root) for pk in defs}

    async def _fetch_sync_contribution(self, duty, defs):
        out = {}
        for pubkey, d in defs.items():
            await self._await_agg_sig(
                Duty(duty.slot, DutyType.PREPARE_SYNC_CONTRIBUTION), pubkey
            )
            root = await self.beacon.sync_committee_block_root(duty.slot)
            out[pubkey] = await self.beacon.sync_contribution(
                duty.slot, d.committee_index, root
            )
        return out

    async def _fetch_proposer(self, duty, defs):
        out: dict[PubKey, Proposal] = {}
        for pubkey, d in defs.items():
            # The aggregated randao reveal gates the proposal fetch
            # (ref: fetcher.go:237-287 awaits DutyRandao aggregate).
            randao = await self._await_agg_sig(
                Duty(duty.slot, DutyType.RANDAO), pubkey
            )
            out[pubkey] = await self.beacon.block_proposal(
                duty.slot, d.validator_index, randao.signature
            )
        return out
