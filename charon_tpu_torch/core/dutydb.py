"""DutyDB: in-memory store of consensus-agreed unsigned duty data with a
blocking query API.

Mirrors ref: core/dutydb/memory.go — the validator client's queries block
until consensus resolves for the slot (memory.go:143,168,197,237), a
unique index per (slot, type, pubkey) detects conflicting values (slashing
protection), and PubKeyByAttestation maps attestation data back to the
validator. asyncio redesign: awaits are futures resolved on store instead
of the reference's query channels.
"""

from __future__ import annotations

import asyncio
from collections import defaultdict

from charon_tpu_torch.core.eth2data import AttestationDuty, Proposal
from charon_tpu_torch.core.types import Duty, DutyType, PubKey


class ConflictError(Exception):
    """A second, different value was stored under the same unique key —
    a potential slashing hazard (ref: core/dutydb/memory.go conflicts)."""


class _AwaitMap:
    """Keyed futures: await_(key) blocks until resolve(key, value)."""

    def __init__(self) -> None:
        self._values: dict = {}
        self._waiters: dict[object, list[asyncio.Future]] = defaultdict(list)

    async def await_(self, key):
        if key in self._values:
            return self._values[key]
        fut = asyncio.get_running_loop().create_future()
        self._waiters[key].append(fut)
        return await fut

    def resolve(self, key, value) -> None:
        self._values[key] = value
        for fut in self._waiters.pop(key, []):
            if not fut.done():
                fut.set_result(value)

    def get(self, key):
        return self._values.get(key)

    def trim(self, keep) -> None:
        self._values = {k: v for k, v in self._values.items() if keep(k)}
        # waiters for trimmed keys stay pending until duty expiry cancels
        # the calling request (vapi requests carry their own timeouts).


class DutyDB:
    """Stores the cluster-agreed unsigned data per duty."""

    def __init__(self) -> None:
        self._att = _AwaitMap()  # (slot, pubkey) -> AttestationDuty
        self._proposal = _AwaitMap()  # (slot, pubkey) -> Proposal
        self._agg_att = _AwaitMap()  # (slot, att_data_root) -> Attestation
        self._contrib = _AwaitMap()  # (slot, subcommittee, root) -> Contribution
        self._sync_msg = _AwaitMap()  # (slot, pubkey) -> SyncMessageDuty
        self._att_by_root: dict[tuple[int, bytes], PubKey] = {}
        self._unique: dict[tuple, bytes] = {}

    # -- store (wired to consensus output) --------------------------------

    async def store(self, duty: Duty, unsigned_set: dict[PubKey, object]) -> None:
        """Store consensus output (ref: core/dutydb/memory.go:70 Store)."""
        if duty.type == DutyType.INFO_SYNC:
            # protocol-internal negotiation result, not VC duty data —
            # consumed by the Prioritiser's own decided-subscriber
            # (ref: infosync runs a dedicated consensus instance whose
            # output never reaches the dutydb)
            return
        for pubkey, unsigned in unsigned_set.items():
            self._check_unique(duty, pubkey, unsigned)
            if duty.type == DutyType.ATTESTER:
                assert isinstance(unsigned, AttestationDuty)
                self._att.resolve((duty.slot, pubkey), unsigned)
                root = unsigned.data.hash_tree_root()
                self._att_by_root[(duty.slot, root)] = pubkey
            elif duty.type == DutyType.PROPOSER:
                assert isinstance(unsigned, Proposal)
                self._proposal.resolve((duty.slot, pubkey), unsigned)
            elif duty.type == DutyType.AGGREGATOR:
                # unsigned is an AggregateAndProof; key by the aggregated
                # attestation's data root (ref: memory.go agg att keying)
                root = unsigned.aggregate.data.hash_tree_root()
                self._agg_att.resolve((duty.slot, root), unsigned)
            elif duty.type == DutyType.SYNC_MESSAGE:
                self._sync_msg.resolve((duty.slot, pubkey), unsigned)
            elif duty.type == DutyType.SYNC_CONTRIBUTION:
                key = (
                    duty.slot,
                    unsigned.subcommittee_index,
                    unsigned.beacon_block_root,
                )
                self._contrib.resolve(key, unsigned)
            else:
                raise ValueError(f"dutydb does not store {duty.type}")

    def _check_unique(self, duty: Duty, pubkey: PubKey, unsigned) -> None:
        key = (duty.slot, duty.type, pubkey)
        root = unsigned.hash_tree_root()
        prev = self._unique.get(key)
        if prev is not None and prev != root:
            raise ConflictError(f"conflicting unsigned data for {key}")
        self._unique[key] = root

    # -- blocking queries (vapi side) -------------------------------------

    async def await_attestation(self, slot: int, pubkey: PubKey) -> AttestationDuty:
        return await self._att.await_((slot, pubkey))

    async def await_proposal(self, slot: int, pubkey: PubKey) -> Proposal:
        return await self._proposal.await_((slot, pubkey))

    async def await_aggregated_attestation(self, slot: int, att_data_root: bytes):
        return await self._agg_att.await_((slot, att_data_root))

    async def await_sync_message(self, slot: int, pubkey: PubKey):
        return await self._sync_msg.await_((slot, pubkey))

    async def await_sync_contribution(
        self, slot: int, subcommittee_index: int, beacon_block_root: bytes
    ):
        return await self._contrib.await_(
            (slot, subcommittee_index, beacon_block_root)
        )

    def pubkey_by_attestation(self, slot: int, att_data_root: bytes) -> PubKey | None:
        """Map a submitted attestation back to its validator
        (ref: core/dutydb/memory.go:266)."""
        return self._att_by_root.get((slot, att_data_root))

    # -- trimming (wired to the Deadliner) --------------------------------

    def trim(self, expired: Duty) -> None:
        slot = expired.slot
        self._att.trim(lambda k: k[0] != slot)
        self._sync_msg.trim(lambda k: k[0] != slot)
        self._proposal.trim(lambda k: k[0] != slot)
        self._agg_att.trim(lambda k: k[0] != slot)
        self._contrib.trim(lambda k: k[0] != slot)
        self._att_by_root = {
            k: v for k, v in self._att_by_root.items() if k[0] != slot
        }
        self._unique = {
            k: v for k, v in self._unique.items() if k[0] != slot
        }
