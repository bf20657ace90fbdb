"""Eth2 duty data objects: unsigned inputs and signed outputs.

Mirrors the reference's UnsignedData / SignedData / Eth2SignedData value
taxonomy (ref: core/types.go:52-91, core/eth2signeddata.go,
core/unsigneddata.go, core/signeddata.go) with frozen dataclasses and
spec-exact SSZ roots (eth2util/ssz.py).

Every signed object knows its signing domain and object root, so partial
signatures can be verified against pubshares at the API boundary
(ref: core/validatorapi/validatorapi.go:1213) and recovered group
signatures against the group key (ref: core/sigagg/sigagg.go:117) through
one generic path.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import ClassVar

from charon_tpu_torch.eth2util import ssz
from charon_tpu_torch.eth2util.signing import DomainName, ForkInfo

# ---------------------------------------------------------------------------
# Spec containers — canonical definitions live in eth2util/spec.py (single
# SSZ schema per consensus container); re-exported here for the workflow.
# ---------------------------------------------------------------------------

from charon_tpu_torch.eth2util.spec import (  # noqa: E402,F401
    Attestation,
    AttestationData,
    BeaconBlockHeader,
    Checkpoint,
    VoluntaryExit,
)
from charon_tpu_torch.eth2util import spec as _spec  # noqa: E402


@dataclass(frozen=True)
class Proposal:
    """A fork-versioned block proposal: the FULL spec block container
    (or its blinded builder variant), exactly as the beacon node returned
    it and exactly as it is re-submitted once group-signed. The signed
    root is the block root, which by SSZ construction equals the
    header-with-body-root root (ref: core/unsigneddata.go
    VersionedProposal carries the same per-fork go-eth2-client block
    union; router.go:151-175 routes on the version discriminator).

    Deneb-onward full proposals also carry the sidecar blobs + KZG proofs
    through consensus so the winning node can publish complete block
    contents (they do not enter the signing root)."""

    version: str  # fork name: "capella" | "deneb"
    block: object  # eth2util/spec per-fork (Blinded)BeaconBlock container
    blinded: bool = False
    kzg_proofs: tuple = ()
    blobs: tuple = ()

    @property
    def slot(self) -> int:
        return self.block.slot

    @property
    def proposer_index(self) -> int:
        return self.block.proposer_index

    def header(self) -> BeaconBlockHeader:
        return self.block.header()

    def hash_tree_root(self) -> bytes:
        return self.block.hash_tree_root()


# Forks whose FULL proposals travel as block *contents* (block + blobs +
# proofs) on the produce/publish endpoints rather than a bare block.
FORKS_WITH_CONTENTS = frozenset({"deneb"})

_hex0x = _spec.hex0x
_unhex0x = _spec.unhex0x


def sniff_block_version(block_json: dict) -> str:
    """Fork of a bare block JSON object when no Eth-Consensus-Version
    header accompanied it: the body's field set discriminates."""
    body = block_json.get("body", {})
    return "deneb" if "blob_kzg_commitments" in body else "capella"


def proposal_data_json(p: Proposal) -> dict:
    """The produceBlockV3 `data` payload: bare (blinded) block JSON, or
    deneb-style block contents for full post-deneb proposals
    (ref: router.go:151 produceBlockV3 response shapes)."""
    bj = _spec.to_json(p.block)
    if p.blinded or p.version not in FORKS_WITH_CONTENTS:
        return bj
    return {
        "block": bj,
        "kzg_proofs": [_hex0x(x) for x in p.kzg_proofs],
        "blobs": [_hex0x(x) for x in p.blobs],
    }


def proposal_from_data_json(version: str, blinded: bool, data: dict) -> Proposal:
    cls = _spec.block_class(version, blinded)
    if blinded or version not in FORKS_WITH_CONTENTS:
        return Proposal(version, _spec.from_json(cls, data), blinded)
    return Proposal(
        version,
        _spec.from_json(cls, data["block"]),
        blinded,
        kzg_proofs=tuple(_unhex0x(x) for x in data.get("kzg_proofs", ())),
        blobs=tuple(_unhex0x(x) for x in data.get("blobs", ())),
    )


def signed_proposal_json(p: Proposal, signature: bytes) -> dict:
    """The publishBlock / publishBlindedBlock POST body: a
    SignedBeaconBlock (message+signature), wrapped as signed block
    contents for full post-deneb proposals (ref: router.go:157-175
    submitProposal / submitBlindedBlock)."""
    signed = {
        "message": _spec.to_json(p.block),
        "signature": _hex0x(signature),
    }
    if p.blinded or p.version not in FORKS_WITH_CONTENTS:
        return signed
    return {
        "signed_block": signed,
        "kzg_proofs": [_hex0x(x) for x in p.kzg_proofs],
        "blobs": [_hex0x(x) for x in p.blobs],
    }


def proposal_data_ssz(p: Proposal) -> bytes:
    """SSZ wire body for the produceBlockV3 `data` payload (served when
    the VC sends Accept: application/octet-stream — Lighthouse-style
    clients prefer SSZ for blocks)."""
    if p.blinded or p.version not in FORKS_WITH_CONTENTS:
        return ssz.serialize(p.block)
    return ssz.serialize(
        _spec.BlockContentsDeneb(p.block, p.kzg_proofs, p.blobs)
    )


def signed_proposal_ssz(p: Proposal, signature: bytes) -> bytes:
    """SSZ wire body for publishBlock/publishBlindedBlock."""
    full_cls, blind_cls = _spec.FORK_SIGNED_BLOCKS[p.version]
    if p.blinded:
        return ssz.serialize(blind_cls(p.block, signature))
    if p.version not in FORKS_WITH_CONTENTS:
        return ssz.serialize(full_cls(p.block, signature))
    return ssz.serialize(
        _spec.SignedBlockContentsDeneb(
            full_cls(p.block, signature), p.kzg_proofs, p.blobs
        )
    )


def signed_proposal_from_ssz(
    data: bytes, blinded: bool, version: str
) -> tuple[Proposal, bytes]:
    """Parse an SSZ publish POST body. Unlike JSON there is no field-set
    sniffing — the spec REQUIRES the Eth-Consensus-Version header on
    SSZ requests, so `version` is mandatory."""
    full_cls, blind_cls = _spec.FORK_SIGNED_BLOCKS[version]
    if blinded:
        s = ssz.deserialize(blind_cls, data)
        return Proposal(version, s.message, True), s.signature
    if version not in FORKS_WITH_CONTENTS:
        s = ssz.deserialize(full_cls, data)
        return Proposal(version, s.message, False), s.signature
    sc = ssz.deserialize(_spec.SignedBlockContentsDeneb, data)
    return (
        Proposal(
            version,
            sc.signed_block.message,
            False,
            kzg_proofs=tuple(sc.kzg_proofs),
            blobs=tuple(sc.blobs),
        ),
        sc.signed_block.signature,
    )


def signed_proposal_from_json(
    j: dict, blinded: bool, version: str | None = None
) -> tuple[Proposal, bytes]:
    """Parse a publish POST body. `version` comes from the
    Eth-Consensus-Version header when the VC sent one; otherwise the
    block JSON is sniffed."""
    if "signed_block" in j:  # deneb block contents
        inner = j["signed_block"]
        kzg = tuple(_unhex0x(x) for x in j.get("kzg_proofs", ()))
        blobs = tuple(_unhex0x(x) for x in j.get("blobs", ()))
    else:
        inner = j
        kzg, blobs = (), ()
    msg = inner["message"]
    ver = version or sniff_block_version(msg)
    block = _spec.from_json(_spec.block_class(ver, blinded), msg)
    return (
        Proposal(ver, block, blinded, kzg_proofs=kzg, blobs=blobs),
        _unhex0x(inner["signature"]),
    )


@dataclass(frozen=True)
class AggregateAndProof:
    aggregator_index: int
    aggregate: Attestation
    selection_proof: bytes = bytes(96)

    ssz_fields: ClassVar = (ssz.UINT64, ssz.Nested(), ssz.BYTES96)

    def hash_tree_root(self) -> bytes:
        return ssz.hash_tree_root(self)


@dataclass(frozen=True)
class SyncCommitteeMessage:
    slot: int
    beacon_block_root: bytes
    validator_index: int
    signature: bytes = bytes(96)

    # Signing root is over the block root only (spec: sync committee
    # messages sign the beacon block root).


@dataclass(frozen=True)
class SyncCommitteeContribution:
    slot: int
    beacon_block_root: bytes
    subcommittee_index: int
    aggregation_bits: tuple[bool, ...] = ()
    signature: bytes = bytes(96)

    ssz_fields: ClassVar = (
        ssz.UINT64,
        ssz.BYTES32,
        ssz.UINT64,
        ssz.Bitvector(128),
        ssz.BYTES96,
    )

    def hash_tree_root(self) -> bytes:
        bits = self.aggregation_bits or tuple([False] * 128)
        tmp = replace(self, aggregation_bits=bits)
        return ssz.hash_tree_root(tmp)


@dataclass(frozen=True)
class ContributionAndProof:
    aggregator_index: int
    contribution: SyncCommitteeContribution
    selection_proof: bytes = bytes(96)

    ssz_fields: ClassVar = (ssz.UINT64, ssz.Nested(), ssz.BYTES96)

    def hash_tree_root(self) -> bytes:
        return ssz.hash_tree_root(self)


# Canonical builder-spec ValidatorRegistrationV1 lives in
# eth2util/registration.py (single SSZ schema — two definitions of the
# same consensus container can silently drift); re-exported here for the
# core workflow's convenience.
from charon_tpu_torch.eth2util.registration import (  # noqa: E402
    ValidatorRegistration,
)


# ---------------------------------------------------------------------------
# Unsigned duty data (consensus payloads)
# ---------------------------------------------------------------------------

# UnsignedData is duck-typed: any frozen value with hash_tree_root().
# Per-duty unsigned payloads (ref: core/unsigneddata.go):
#   ATTESTER          -> AttestationDuty (att data + committee info)
#   PROPOSER          -> Proposal
#   AGGREGATOR        -> Attestation (the aggregate to sign over)
#   SYNC_CONTRIBUTION -> SyncCommitteeContribution


@dataclass(frozen=True)
class SyncMessageDuty:
    """Consensus payload for a sync-committee message: the agreed head
    block root every member signs."""

    beacon_block_root: bytes

    def hash_tree_root(self) -> bytes:
        return self.beacon_block_root


@dataclass(frozen=True)
class AttestationDuty:
    """Consensus payload for an attester duty: the agreed attestation data
    plus the validator's committee coordinates (the reference keeps these
    in its AttestationData wrapper, ref: core/unsigneddata.go:60-100)."""

    data: AttestationData
    committee_length: int
    committee_index: int  # position of the validator in the committee
    validator_committee_index: int

    def hash_tree_root(self) -> bytes:
        return self.data.hash_tree_root()


# ---------------------------------------------------------------------------
# Signed data: a generic envelope with a domain registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SignedData:
    """A signable duty output: payload + BLS signature.

    kind selects the signing domain and how the object root is derived
    (ref: core/eth2signeddata.go implements one Go type per kind; here one
    envelope + a registry keeps the wire/db layers fully generic)."""

    kind: str
    payload: object
    signature: bytes = b""

    def with_signature(self, sig: bytes) -> "SignedData":
        return replace(self, signature=sig)

    def signing_root(self, fork: ForkInfo, slot_epoch: int) -> bytes:
        spec = SIGNED_KINDS[self.kind]
        return fork.signing_root(spec.domain, spec.object_root(self.payload))


@dataclass(frozen=True)
class KindSpec:
    domain: DomainName
    object_root: object  # Callable[[payload], bytes]


def _epoch_root(epoch: int) -> bytes:
    return ssz.UINT64.hash_tree_root(epoch)


def _slot_root(slot: int) -> bytes:
    return ssz.UINT64.hash_tree_root(slot)


SIGNED_KINDS: dict[str, KindSpec] = {
    "attestation": KindSpec(
        DomainName.BEACON_ATTESTER, lambda att: att.data.hash_tree_root()
    ),
    "block": KindSpec(
        DomainName.BEACON_PROPOSER, lambda p: p.hash_tree_root()
    ),
    "randao": KindSpec(DomainName.RANDAO, _epoch_root),
    "selection_proof": KindSpec(DomainName.SELECTION_PROOF, _slot_root),
    "aggregate_and_proof": KindSpec(
        DomainName.AGGREGATE_AND_PROOF, lambda a: a.hash_tree_root()
    ),
    "sync_message": KindSpec(
        DomainName.SYNC_COMMITTEE, lambda m: m.beacon_block_root
    ),
    "sync_selection": KindSpec(
        DomainName.SYNC_COMMITTEE_SELECTION_PROOF,
        lambda d: ssz.Container((ssz.UINT64, ssz.UINT64)).hash_tree_root(
            (d.slot, d.subcommittee_index)
        ),
    ),
    "contribution_and_proof": KindSpec(
        DomainName.CONTRIBUTION_AND_PROOF, lambda c: c.hash_tree_root()
    ),
    "registration": KindSpec(
        DomainName.APPLICATION_BUILDER, lambda r: r.hash_tree_root()
    ),
    "exit": KindSpec(
        DomainName.VOLUNTARY_EXIT, lambda e: e.hash_tree_root()
    ),
}


@dataclass(frozen=True)
class SyncSelectionData:
    slot: int
    subcommittee_index: int


@dataclass(frozen=True)
class ParSignedData:
    """A partially signed duty output carrying its share index
    (ref: core/types.go ParSignedData)."""

    data: SignedData
    share_idx: int

    def message_root(self) -> bytes:
        """Root identifying *what* was signed — partials for the same duty
        group by this before threshold recombination
        (ref: core/parsigdb/memory.go:198 groups by message root).
        Cached: parsigdb grouping AND tracker consistency analysis hash
        the same object on the store hot path."""
        cached = getattr(self, "_root_cache", None)
        if cached is None:
            spec = SIGNED_KINDS[self.data.kind]
            cached = spec.object_root(self.data.payload)
            object.__setattr__(self, "_root_cache", cached)
        return cached
