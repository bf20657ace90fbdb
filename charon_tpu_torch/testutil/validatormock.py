"""ValidatorMock: a fake validator client driving the ValidatorAPI.

Mirrors ref: testutil/validatormock — holds this node's *share* private
keys and performs duties against the vapi: pull attestation data, sign
with the share key, submit the partial signature (ref:
testutil/validatormock/attest.go, propose.go; wired in-process by
app/vmock.go).
"""

from __future__ import annotations

from dataclasses import dataclass

from charon_tpu_torch import tbls
from charon_tpu_torch.core.eth2data import Attestation, SignedData
from charon_tpu_torch.core.scheduler import DutyDefinition
from charon_tpu_torch.core.types import PubKey
from charon_tpu_torch.core.validatorapi import ValidatorAPI
from charon_tpu_torch.eth2util.signing import ForkInfo


@dataclass
class ValidatorMock:
    """share_keys: group pubkey -> this node's share private key bytes."""

    vapi: ValidatorAPI
    share_keys: dict[PubKey, bytes]
    fork: ForkInfo
    slots_per_epoch: int = 32

    async def attest(self, slot: int, defs: dict[PubKey, DutyDefinition]) -> None:
        """Perform the attester duty for all our validators in this slot
        (ref: validatormock/attest.go)."""
        atts = []
        for pubkey, d in defs.items():
            data = await self.vapi.attestation_data(slot, d.committee_index)
            bits = tuple(
                i == d.validator_committee_index
                for i in range(d.committee_length)
            )
            unsigned = Attestation(aggregation_bits=bits, data=data)
            root = SignedData("attestation", unsigned).signing_root(
                self.fork, slot // self.slots_per_epoch
            )
            sig = tbls.sign(self.share_keys[pubkey], root)
            atts.append(Attestation(bits, data, sig))
        if atts:
            await self.vapi.submit_attestations(atts)

    async def propose(self, slot: int, pubkey: PubKey) -> None:
        """Randao partial then signed proposal (ref: validatormock/propose.go)."""
        epoch = slot // self.slots_per_epoch
        randao_root = SignedData("randao", epoch).signing_root(self.fork, epoch)
        randao_sig = tbls.sign(self.share_keys[pubkey], randao_root)
        await self.vapi.submit_randao(slot, pubkey, randao_sig)

        proposal = await self.vapi.proposal(slot, pubkey)
        root = SignedData("block", proposal).signing_root(self.fork, epoch)
        sig = tbls.sign(self.share_keys[pubkey], root)
        await self.vapi.submit_proposal(pubkey, proposal, sig)


@dataclass
class HttpValidatorMock:
    """A fake VC that drives duties ONLY through the beacon-API HTTP
    server, covering every duty family the router serves (ref:
    testutil/validatormock drives charon's router over HTTP the same way;
    the simnet asserts completion via the broadcast recorder,
    testutil/integration/simnet_test.go:49-130).

    client: HttpVapiClient; validators: group pubkey -> index."""

    client: object
    share_keys: dict[PubKey, bytes]
    validators: dict[PubKey, int]
    fork: ForkInfo
    slots_per_epoch: int = 32

    def _sign(self, pubkey: PubKey, kind: str, payload, slot: int) -> bytes:
        root = SignedData(kind, payload).signing_root(
            self.fork, slot // self.slots_per_epoch
        )
        return tbls.sign(self.share_keys[pubkey], root)

    async def attest(self, slot: int, defs: dict[PubKey, DutyDefinition]) -> None:
        atts = []
        for pubkey, d in defs.items():
            data = await self.client.attestation_data(slot, d.committee_index)
            bits = tuple(
                i == d.validator_committee_index
                for i in range(d.committee_length)
            )
            unsigned = Attestation(aggregation_bits=bits, data=data)
            sig = self._sign(pubkey, "attestation", unsigned, slot)
            atts.append(Attestation(bits, data, sig))
        if atts:
            await self.client.submit_attestations(atts)

    async def propose(self, slot: int, pubkey: PubKey) -> None:
        """GET v3 blocks with the randao partial as randao_reveal, then
        sign + POST the block (ref: validatormock/propose.go)."""
        epoch = slot // self.slots_per_epoch
        randao_sig = self._sign(pubkey, "randao", epoch, slot)
        proposal = await self.client.produce_block(slot, randao_sig)
        sig = self._sign(pubkey, "block", proposal, slot)
        await self.client.submit_block(proposal, sig)

    async def aggregate(self, slot: int, defs: dict[PubKey, DutyDefinition]) -> None:
        """Selection partials -> aggregated proofs -> aggregate att ->
        signed AggregateAndProof (ref: validatormock attest.go aggregation
        + eth2exp beacon committee selections)."""
        from charon_tpu_torch.core.eth2data import AggregateAndProof

        selections = []
        for pubkey, d in defs.items():
            proof = self._sign(pubkey, "selection_proof", slot, slot)
            selections.append((d.validator_index, slot, proof))
        aggregated = await self.client.beacon_committee_selections(selections)
        by_vidx = {vidx: proof for vidx, _, proof in aggregated}

        items = []
        for pubkey, d in defs.items():
            data = await self.client.attestation_data(slot, d.committee_index)
            agg_att = await self.client.aggregate_attestation(
                slot, data.hash_tree_root()
            )
            cap = AggregateAndProof(
                aggregator_index=d.validator_index,
                aggregate=agg_att,
                selection_proof=by_vidx[d.validator_index],
            )
            sig = self._sign(pubkey, "aggregate_and_proof", cap, slot)
            items.append((cap, sig))
        await self.client.submit_aggregate_and_proofs(items)

    async def sync_message(self, slot: int, defs: dict[PubKey, DutyDefinition]) -> None:
        from charon_tpu_torch.core.eth2data import SyncCommitteeMessage

        root = await self.client.head_root(slot)
        msgs = []
        for pubkey, d in defs.items():
            msg = SyncCommitteeMessage(
                slot=slot,
                beacon_block_root=root,
                validator_index=d.validator_index,
            )
            sig = self._sign(pubkey, "sync_message", msg, slot)
            msgs.append(
                SyncCommitteeMessage(slot, root, d.validator_index, sig)
            )
        await self.client.submit_sync_messages(msgs)

    async def sync_contribution(self, slot: int, defs: dict[PubKey, DutyDefinition]) -> None:
        from charon_tpu_torch.core.eth2data import (
            ContributionAndProof,
            SyncSelectionData,
        )

        selections = []
        for pubkey, d in defs.items():
            sel = SyncSelectionData(slot, d.committee_index)
            proof = self._sign(pubkey, "sync_selection", sel, slot)
            selections.append(
                (d.validator_index, slot, d.committee_index, proof)
            )
        aggregated = await self.client.sync_committee_selections(selections)
        by_vidx = {vidx: proof for vidx, _, _, proof in aggregated}

        root = await self.client.head_root(slot)
        items = []
        for pubkey, d in defs.items():
            contrib = await self.client.sync_committee_contribution(
                slot, d.committee_index, root
            )
            cap = ContributionAndProof(
                aggregator_index=d.validator_index,
                contribution=contrib,
                selection_proof=by_vidx[d.validator_index],
            )
            sig = self._sign(pubkey, "contribution_and_proof", cap, slot)
            items.append((cap, sig))
        await self.client.submit_contribution_and_proofs(items)

    async def register(self, pubkey: PubKey, fee_recipient: bytes = b"\xfe" * 20) -> None:
        from charon_tpu_torch.core.eth2data import ValidatorRegistration
        from charon_tpu_torch.core.types import pubkey_to_bytes

        reg = ValidatorRegistration(
            fee_recipient=fee_recipient,
            gas_limit=30_000_000,
            timestamp=0,
            pubkey=pubkey_to_bytes(pubkey),
        )
        sig = self._sign(pubkey, "registration", reg, 0)
        await self.client.register_validators([(reg, sig)])

    async def exit(self, pubkey: PubKey, epoch: int) -> None:
        from charon_tpu_torch.core.eth2data import VoluntaryExit

        exit_msg = VoluntaryExit(
            epoch=epoch, validator_index=self.validators[pubkey]
        )
        sig = self._sign(
            pubkey, "exit", exit_msg, epoch * self.slots_per_epoch
        )
        await self.client.submit_voluntary_exit(exit_msg, sig)
