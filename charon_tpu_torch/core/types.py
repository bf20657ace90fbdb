"""Abstract core value types.

Mirrors ref: core/types.go — Duty (slot, type), the DutyType enum, PubKey,
and the per-duty set maps keyed by validator pubkey ("critical for clusters
with a large number of DVs", ref: docs/architecture.md:131-133). Sets here
are plain dicts of frozen values: immutability replaces the reference's
defensive Clone() discipline (ref: docs/architecture.md:202-205).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import NewType

# 0x-prefixed lowercase hex of a 48-byte compressed BLS public key — the
# group (distributed validator) key, used as the set key everywhere
# (ref: core/types.go PubKey).
PubKey = NewType("PubKey", str)


def pubkey_from_bytes(b: bytes) -> PubKey:
    if len(b) != 48:
        raise ValueError("pubkey must be 48 bytes")
    return PubKey("0x" + b.hex())


def pubkey_to_bytes(pk: PubKey) -> bytes:
    if not pk.startswith("0x") or len(pk) != 98:
        raise ValueError(f"malformed pubkey {pk!r}")
    return bytes.fromhex(pk[2:])


class DutyType(enum.IntEnum):
    """Duty types (ref: core/types.go:30-50 — 14 types incl. the
    deprecated builder proposer)."""

    UNKNOWN = 0
    PROPOSER = 1
    ATTESTER = 2
    SIGNATURE = 3  # generic one-off signature (exit shares, etc.)
    EXIT = 4
    BUILDER_PROPOSER = 5  # deprecated upstream; kept for enum parity
    BUILDER_REGISTRATION = 6
    RANDAO = 7
    PREPARE_AGGREGATOR = 8
    AGGREGATOR = 9
    SYNC_MESSAGE = 10
    PREPARE_SYNC_CONTRIBUTION = 11
    SYNC_CONTRIBUTION = 12
    INFO_SYNC = 13

    def __str__(self) -> str:  # log-friendly
        return self.name.lower()


# Duty types that are scheduled directly from beacon-node duty queries; the
# rest are derived steps (randao before proposer, prepare before
# aggregator...) — ref: core/scheduler resolves attester/proposer/sync.
SCHEDULED_TYPES = (
    DutyType.ATTESTER,
    DutyType.PROPOSER,
    DutyType.SYNC_MESSAGE,
)


@dataclass(frozen=True, order=True)
class Duty:
    """One cluster-level unit of work: all validators' duties of one type
    in one slot flow together (ref: core/types.go Duty)."""

    slot: int
    type: DutyType

    def __str__(self) -> str:
        return f"{self.slot}/{self.type}"


def randao_duty(slot: int) -> Duty:
    return Duty(slot, DutyType.RANDAO)


def attester_duty(slot: int) -> Duty:
    return Duty(slot, DutyType.ATTESTER)


def proposer_duty(slot: int) -> Duty:
    return Duty(slot, DutyType.PROPOSER)
