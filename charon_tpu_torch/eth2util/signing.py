"""Eth2 signing domains and signing-root computation.

Spec-exact implementation of compute_domain / compute_signing_root
(mirrors ref: eth2util/signing/signing.go:22-115, which maps duty types to
domain names and verifies against them).
"""

from __future__ import annotations

import enum
import hashlib
from dataclasses import dataclass


class DomainName(enum.Enum):
    """Domain types (4-byte little-endian tags per the eth2 spec); the set
    the reference registers in eth2util/signing/signing.go:22-35."""

    BEACON_PROPOSER = bytes.fromhex("00000000")
    BEACON_ATTESTER = bytes.fromhex("01000000")
    RANDAO = bytes.fromhex("02000000")
    DEPOSIT = bytes.fromhex("03000000")
    VOLUNTARY_EXIT = bytes.fromhex("04000000")
    SELECTION_PROOF = bytes.fromhex("05000000")
    AGGREGATE_AND_PROOF = bytes.fromhex("06000000")
    SYNC_COMMITTEE = bytes.fromhex("07000000")
    SYNC_COMMITTEE_SELECTION_PROOF = bytes.fromhex("08000000")
    CONTRIBUTION_AND_PROOF = bytes.fromhex("09000000")
    APPLICATION_BUILDER = bytes.fromhex("00000001")


def _sha(a: bytes, b: bytes) -> bytes:
    return hashlib.sha256(a + b).digest()


def compute_fork_data_root(fork_version: bytes, genesis_validators_root: bytes) -> bytes:
    """hash_tree_root(ForkData{current_version, genesis_validators_root})."""
    if len(fork_version) != 4:
        raise ValueError("fork version must be 4 bytes")
    return _sha(fork_version + bytes(28), genesis_validators_root)


def compute_domain(
    domain: DomainName, fork_version: bytes, genesis_validators_root: bytes
) -> bytes:
    return domain.value + compute_fork_data_root(fork_version, genesis_validators_root)[:28]


def compute_signing_root(object_root: bytes, domain: bytes) -> bytes:
    """hash_tree_root(SigningData{object_root, domain})."""
    if len(object_root) != 32 or len(domain) != 32:
        raise ValueError("object root and domain must be 32 bytes")
    return _sha(object_root, domain)


@dataclass(frozen=True)
class ForkInfo:
    """What a signer needs from the chain to derive domains.

    APPLICATION_BUILDER domains pin the genesis fork version with an empty
    genesis validators root, per the builder spec (mirrored from the
    reference's registration handling, ref: eth2util/registration)."""

    genesis_validators_root: bytes
    fork_version: bytes
    genesis_fork_version: bytes

    def signing_root(self, domain: DomainName, object_root: bytes) -> bytes:
        if domain is DomainName.APPLICATION_BUILDER:
            d = compute_domain(domain, self.genesis_fork_version, bytes(32))
        else:
            d = compute_domain(
                domain, self.fork_version, self.genesis_validators_root
            )
        return compute_signing_root(object_root, d)
