"""BeaconMock: a programmable in-process fake beacon node.

Mirrors ref: testutil/beaconmock — deterministic duties, static chain
spec, canned attestation data, and recording submit endpoints, with
override options in the same spirit as beaconmock/options.go
(WithDeterministicAttesterDuties, WithSlotDuration, WithValidatorSet...).
All components consume it through the same duck-typed beacon interface as
the production client.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field

from charon_tpu_torch.core.deadline import SlotClock
from charon_tpu_torch.core.eth2data import (
    AttestationData,
    Checkpoint,
    Proposal,
)
from charon_tpu_torch.core.types import PubKey
from charon_tpu_torch.eth2util import spec


@dataclass
class BeaconMock:
    """validators: pubkey -> validator index. Deterministic single-committee
    attester duties per slot; proposer duty round-robin by slot."""

    validators: dict[PubKey, int] = field(default_factory=dict)
    genesis_time: float = field(default_factory=lambda: time.time())
    slot_duration: float = 1.0
    slots_per_epoch: int = 16
    synced: bool = True

    def __post_init__(self) -> None:
        self.attestations: list = []
        self.proposals: list = []
        self.registrations: list = []
        self.exits: list = []
        self.aggregates: list = []
        self.sync_messages: list = []
        self.contributions: list = []
        # test override hooks (ref: beaconmock/options.go pattern)
        self.attestation_data_fn = self._attestation_data_default
        # att-data roots served, so aggregate_attestation can look up the
        # exact data the root refers to
        self._att_data_by_root: dict[bytes, AttestationData] = {}
        # inclusion simulation: pool attestations land in the next block
        # materialized after submission; tests set drop_inclusions=True to
        # simulate a chain that never includes them
        # (ref: testutil/beaconmock + core/tracker/inclusion_internal_test.go)
        self.drop_inclusions = False
        self._att_pool: list = []
        self._blocks: dict[int, list] = {}

    # -- chain metadata ---------------------------------------------------

    def clock(self) -> SlotClock:
        return SlotClock(self.genesis_time, self.slot_duration)

    async def await_synced(self) -> None:
        return None

    # -- duties -----------------------------------------------------------

    async def attester_duties(self, epoch: int, validators: dict[PubKey, int]):
        """Every validator attests every slot in its own committee —
        deterministic (ref: beaconmock WithDeterministicAttesterDuties)."""
        out = []
        for slot in range(
            epoch * self.slots_per_epoch, (epoch + 1) * self.slots_per_epoch
        ):
            for i, (pubkey, vidx) in enumerate(sorted(validators.items())):
                out.append(
                    dict(
                        slot=slot,
                        pubkey=pubkey,
                        validator_index=vidx,
                        committee_index=i,
                        committee_length=1,
                        committees_at_slot=max(1, len(validators)),
                        validator_committee_index=0,
                    )
                )
        return out

    async def proposer_duties(self, epoch: int, validators: dict[PubKey, int]):
        out = []
        ordered = sorted(validators.items())
        if not ordered:
            return out
        for slot in range(
            epoch * self.slots_per_epoch, (epoch + 1) * self.slots_per_epoch
        ):
            pubkey, vidx = ordered[slot % len(ordered)]
            out.append(dict(slot=slot, pubkey=pubkey, validator_index=vidx))
        return out

    def sync_committee_position(self, vidx: int) -> int:
        """Deterministic position of a validator in the 512-member sync
        committee. Multiplying by an odd constant mod 512 is a bijection,
        so positions (and hence subcommittees AND positions WITHIN a
        subcommittee) spread non-trivially — a test that conflates
        position, subcommittee, or in-subcommittee index will fail."""
        return (vidx * 131 + 7) % 512

    async def sync_duties(self, epoch: int, validators: dict[PubKey, int]):
        """Every validator is a sync-committee member (deterministic)
        with a REAL committee position; the spec duty shape carries the
        positions (`validator_sync_committee_indices`), everything else
        (subcommittee = pos // 128, bit = pos % 128) is derived from
        them (ref: beaconmock WithDeterministicSyncCommDuties)."""
        return [
            dict(
                pubkey=pubkey,
                validator_index=vidx,
                sync_committee_indices=[self.sync_committee_position(vidx)],
            )
            for pubkey, vidx in sorted(validators.items())
        ]

    # -- duty data --------------------------------------------------------

    def _root(self, *parts) -> bytes:
        h = hashlib.sha256()
        for p in parts:
            h.update(str(p).encode())
        return h.digest()

    def _attestation_data_default(self, slot: int, committee_index: int) -> AttestationData:
        epoch = slot // self.slots_per_epoch
        return AttestationData(
            slot=slot,
            index=committee_index,
            beacon_block_root=self._root("block", slot),
            source=Checkpoint(max(0, epoch - 1), self._root("cp", epoch - 1)),
            target=Checkpoint(epoch, self._root("cp", epoch)),
        )

    async def attestation_data(self, slot: int, committee_index: int) -> AttestationData:
        data = self.attestation_data_fn(slot, committee_index)
        self._att_data_by_root[data.hash_tree_root()] = data
        return data

    async def block_proposal(self, slot: int, proposer_index: int, randao: bytes) -> Proposal:
        """A spec-complete deneb block: the full BeaconBlockBody container
        with a real (if minimal) execution payload, so the proposer flow
        exercises exactly the JSON/SSZ shapes a production beacon node
        serves (ref: testutil/beaconmock serves go-eth2-client spec
        blocks for the same reason)."""
        payload = spec.ExecutionPayloadDeneb(
            parent_hash=self._root("elblock", slot - 1),
            fee_recipient=b"\xfe" * 20,
            state_root=self._root("elstate", slot),
            receipts_root=self._root("elrcpt", slot),
            logs_bloom=bytes(256),
            prev_randao=hashlib.sha256(randao).digest(),
            block_number=slot,
            gas_limit=30_000_000,
            gas_used=21_000,
            timestamp=int(self.genesis_time) + slot,
            extra_data=b"beaconmock",
            base_fee_per_gas=7,
            block_hash=self._root("elblock", slot),
            transactions=(b"\x02" + self._root("tx", slot),),
            withdrawals=(),
        )
        block = spec.BeaconBlockDeneb(
            slot=slot,
            proposer_index=proposer_index,
            parent_root=self._root("block", slot - 1),
            state_root=self._root("state", slot, randao.hex()),
            body=spec.BeaconBlockBodyDeneb(
                randao_reveal=randao[:96].ljust(96, b"\x00"),
                eth1_data=spec.Eth1Data(
                    self._root("dep", slot), slot, self._root("eth1", slot)
                ),
                graffiti=b"beaconmock".ljust(32, b"\x00"),
                sync_aggregate=spec.SyncAggregate(
                    tuple([False] * 512), bytes(96)
                ),
                execution_payload=payload,
            ),
        )
        return Proposal(version="deneb", block=block)

    async def aggregate_attestation(self, slot: int, att_data_root: bytes):
        """Aggregate attestation for an att data root (the BN would merge
        pool attestations; deterministic here)."""
        from charon_tpu_torch.core.eth2data import Attestation

        data = self._att_data_by_root.get(att_data_root)
        if data is None:
            data = self.attestation_data_fn(slot, 0)
        return Attestation(
            aggregation_bits=(True, True), data=data
        )

    async def sync_committee_block_root(self, slot: int) -> bytes:
        return self._root("block", slot)

    async def sync_contribution(self, slot: int, subcommittee_index: int, block_root: bytes):
        """The aggregation bits are the TRUE membership bits: position %
        128 for every registered validator whose committee position lands
        in this subcommittee (a real BN sets the bits of the messages it
        aggregated; the mock assumes every member's message arrived)."""
        from charon_tpu_torch.core.eth2data import SyncCommitteeContribution

        bits = [False] * 128
        for vidx in self.validators.values():
            pos = self.sync_committee_position(vidx)
            if pos // 128 == subcommittee_index:
                bits[pos % 128] = True
        return SyncCommitteeContribution(
            slot=slot,
            beacon_block_root=block_root,
            subcommittee_index=subcommittee_index,
            aggregation_bits=tuple(bits),
        )

    # -- chain/inclusion queries (ref: inclusion checker's BN surface) ----

    async def block_attestations(self, slot: int):
        """Attestations included in the block at `slot` (every slot has a
        block in the mock chain). Pool attestations submitted before this
        call land in the first block materialized afterwards — but only
        a block AFTER the attestation's slot, as on a real chain (an
        attestation can never appear in an earlier block)."""
        if slot not in self._blocks:
            take = [
                a
                for a in self._att_pool
                if getattr(a.data, "slot", slot - 1) < slot
            ]
            self._blocks[slot] = take
            self._att_pool = [a for a in self._att_pool if a not in take]
        return self._blocks[slot]

    async def block_root(self, slot: int):
        """Root of the block at `slot`: the submitted proposal's header
        root if one was broadcast for this slot, else the mock chain's
        deterministic root."""
        for proposal, _sig in self.proposals:
            if proposal.slot == slot:
                return proposal.hash_tree_root()
        return self._root("block", slot)

    # -- head events (ref: testutil/beaconmock/headproducer.go — the mock
    # serves SSE head events at /eth/v1/events; here subscribers get an
    # asyncio queue fed once per slot by run_head_producer) --------------

    def subscribe_head_events(self):
        import asyncio

        queue: asyncio.Queue = asyncio.Queue()
        if not hasattr(self, "_head_subs"):
            self._head_subs = []
        self._head_subs.append(queue)
        return queue

    async def run_head_producer(self, stop_event=None) -> None:
        """Emit one head event per slot until cancelled (or stop_event
        set). Event shape mirrors the eth2 SSE `head` topic."""
        import asyncio

        clock = self.clock()
        while stop_event is None or not stop_event.is_set():
            slot = clock.slot_at(time.time())
            await asyncio.sleep(
                max(0.0, clock.slot_start(slot + 1) - time.time())
            )
            event = {
                "slot": slot + 1,
                "block": "0x" + (await self.block_root(slot + 1)).hex(),
                "epoch_transition": (slot + 1) % self.slots_per_epoch == 0,
            }
            for q in getattr(self, "_head_subs", []):
                q.put_nowait(event)

    # -- fuzzing (ref: testutil/beaconmock/beaconmock_fuzz.go, enabled by
    # --simnet-beacon-mock-fuzz: responses become randomized but
    # shape-valid so the workflow's robustness is chaos-tested) ----------

    def enable_fuzz(self, seed: int = 0, error_rate: float = 0.1) -> None:
        import random as _random

        rng = _random.Random(seed)
        self._fuzz_rng = rng
        self._fuzz_error_rate = error_rate

        def fuzz_attestation_data(slot: int, committee_index: int):
            if rng.random() < error_rate:
                # ConnectionError: the honest simulation of a BN outage —
                # the workflow's retryer classifies it transient
                raise ConnectionError("beaconmock fuzz: synthetic BN error")
            epoch = slot // self.slots_per_epoch
            return AttestationData(
                slot=rng.randrange(max(1, slot * 2) + 1),
                index=rng.randrange(64),
                beacon_block_root=rng.randbytes(32),
                source=Checkpoint(max(0, epoch - 1), rng.randbytes(32)),
                target=Checkpoint(epoch, rng.randbytes(32)),
            )

        self.attestation_data_fn = fuzz_attestation_data

    # -- submissions ------------------------------------------------------

    async def submit_attestation(self, att) -> None:
        self.attestations.append(att)
        if not self.drop_inclusions:
            self._att_pool.append(att)

    async def submit_aggregate(self, agg_and_proof, signature: bytes) -> None:
        self.aggregates.append((agg_and_proof, signature))
        if not self.drop_inclusions:
            agg = getattr(agg_and_proof, "aggregate", None)
            if agg is not None:
                self._att_pool.append(agg)

    async def submit_sync_message(self, msg) -> None:
        self.sync_messages.append(msg)

    async def submit_contribution(self, contrib_and_proof, signature: bytes) -> None:
        self.contributions.append((contrib_and_proof, signature))

    async def submit_proposal(self, proposal, signature: bytes) -> None:
        self.proposals.append((proposal, signature))

    async def submit_registration(self, reg, signature: bytes) -> None:
        self.registrations.append((reg, signature))

    async def submit_exit(self, exit_msg, signature: bytes) -> None:
        self.exits.append((exit_msg, signature))
