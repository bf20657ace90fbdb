"""Fork-versioned eth2 spec containers + beacon-API JSON codec.

The canonical consensus-spec containers the duty workflow carries:
attestations, the FULL per-fork beacon-block family (capella, deneb) with
execution payloads, and their blinded (builder) variants. Roots are
spec-exact SSZ (eth2util/ssz.py); the JSON codec emits/parses the exact
beacon-API wire shapes (quoted uint64s, 0x-hex byte strings, SSZ-encoded
hex bitlists), so a stock validator client can round-trip blocks through
the validator API.

The reference gets these types from go-eth2-client's per-fork packages
and routes on the `version` discriminator (ref:
core/validatorapi/router.go:151-175 produceBlockV3 / submitProposal,
core/unsigneddata.go VersionedProposal, core/signeddata.go
VersionedSignedProposal). Here one descriptor-driven codec serves every
container: each dataclass declares `ssz_fields` aligned with its fields,
and `to_json`/`from_json` walk the descriptors — no per-type marshalling
code to drift.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, ClassVar

from charon_tpu_torch.eth2util import ssz

# ---------------------------------------------------------------------------
# Common containers (phase0/altair — fork-independent)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Checkpoint:
    epoch: int
    root: bytes  # 32

    ssz_fields: ClassVar = (ssz.UINT64, ssz.BYTES32)


@dataclass(frozen=True)
class AttestationData:
    slot: int
    index: int
    beacon_block_root: bytes
    source: Checkpoint
    target: Checkpoint

    ssz_fields: ClassVar = (
        ssz.UINT64,
        ssz.UINT64,
        ssz.BYTES32,
        ssz.Nested(Checkpoint),
        ssz.Nested(Checkpoint),
    )

    def hash_tree_root(self) -> bytes:
        return ssz.hash_tree_root(self)


@dataclass(frozen=True)
class Attestation:
    aggregation_bits: tuple[bool, ...]
    data: AttestationData
    signature: bytes = bytes(96)

    ssz_fields: ClassVar = (
        ssz.Bitlist(2048),
        ssz.Nested(AttestationData),
        ssz.BYTES96,
    )

    def hash_tree_root(self) -> bytes:
        return ssz.hash_tree_root(self)


@dataclass(frozen=True)
class BeaconBlockHeader:
    slot: int
    proposer_index: int
    parent_root: bytes
    state_root: bytes
    body_root: bytes

    ssz_fields: ClassVar = (
        ssz.UINT64,
        ssz.UINT64,
        ssz.BYTES32,
        ssz.BYTES32,
        ssz.BYTES32,
    )

    def hash_tree_root(self) -> bytes:
        return ssz.hash_tree_root(self)


@dataclass(frozen=True)
class SignedBeaconBlockHeader:
    message: BeaconBlockHeader
    signature: bytes = bytes(96)

    ssz_fields: ClassVar = (ssz.Nested(BeaconBlockHeader), ssz.BYTES96)


@dataclass(frozen=True)
class ProposerSlashing:
    signed_header_1: SignedBeaconBlockHeader
    signed_header_2: SignedBeaconBlockHeader

    ssz_fields: ClassVar = (
        ssz.Nested(SignedBeaconBlockHeader),
        ssz.Nested(SignedBeaconBlockHeader),
    )


@dataclass(frozen=True)
class IndexedAttestation:
    attesting_indices: tuple[int, ...]  # List[uint64, 2048]
    data: AttestationData
    signature: bytes = bytes(96)

    ssz_fields: ClassVar = (
        ssz.List(ssz.UINT64, 2048),
        ssz.Nested(AttestationData),
        ssz.BYTES96,
    )


@dataclass(frozen=True)
class AttesterSlashing:
    attestation_1: IndexedAttestation
    attestation_2: IndexedAttestation

    ssz_fields: ClassVar = (
        ssz.Nested(IndexedAttestation),
        ssz.Nested(IndexedAttestation),
    )


@dataclass(frozen=True)
class Eth1Data:
    deposit_root: bytes  # 32
    deposit_count: int
    block_hash: bytes  # 32

    ssz_fields: ClassVar = (ssz.BYTES32, ssz.UINT64, ssz.BYTES32)


@dataclass(frozen=True)
class DepositData:
    pubkey: bytes  # 48
    withdrawal_credentials: bytes  # 32
    amount: int
    signature: bytes = bytes(96)

    ssz_fields: ClassVar = (
        ssz.BYTES48,
        ssz.BYTES32,
        ssz.UINT64,
        ssz.BYTES96,
    )


@dataclass(frozen=True)
class Deposit:
    proof: tuple[bytes, ...]  # Vector[bytes32, 33]
    data: DepositData

    ssz_fields: ClassVar = (
        ssz.Vector(ssz.BYTES32, 33),
        ssz.Nested(DepositData),
    )


@dataclass(frozen=True)
class VoluntaryExit:
    epoch: int
    validator_index: int

    ssz_fields: ClassVar = (ssz.UINT64, ssz.UINT64)

    def hash_tree_root(self) -> bytes:
        return ssz.hash_tree_root(self)


@dataclass(frozen=True)
class SignedVoluntaryExit:
    message: VoluntaryExit
    signature: bytes = bytes(96)

    ssz_fields: ClassVar = (ssz.Nested(VoluntaryExit), ssz.BYTES96)


@dataclass(frozen=True)
class SyncAggregate:
    sync_committee_bits: tuple[bool, ...]  # Bitvector[512]
    sync_committee_signature: bytes = bytes(96)

    ssz_fields: ClassVar = (ssz.Bitvector(512), ssz.BYTES96)


@dataclass(frozen=True)
class BLSToExecutionChange:
    validator_index: int
    from_bls_pubkey: bytes  # 48
    to_execution_address: bytes  # 20

    ssz_fields: ClassVar = (ssz.UINT64, ssz.BYTES48, ssz.ByteVector(20))


@dataclass(frozen=True)
class SignedBLSToExecutionChange:
    message: BLSToExecutionChange
    signature: bytes = bytes(96)

    ssz_fields: ClassVar = (ssz.Nested(BLSToExecutionChange), ssz.BYTES96)


@dataclass(frozen=True)
class Withdrawal:
    index: int
    validator_index: int
    address: bytes  # 20
    amount: int

    ssz_fields: ClassVar = (
        ssz.UINT64,
        ssz.UINT64,
        ssz.ByteVector(20),
        ssz.UINT64,
    )


# ---------------------------------------------------------------------------
# Execution payloads (capella, deneb)
# ---------------------------------------------------------------------------

# spec constants
MAX_BYTES_PER_TRANSACTION = 2**30
MAX_TRANSACTIONS_PER_PAYLOAD = 2**20
MAX_EXTRA_DATA_BYTES = 32
MAX_WITHDRAWALS_PER_PAYLOAD = 16
MAX_BLOB_COMMITMENTS_PER_BLOCK = 4096

_PAYLOAD_HEAD_FIELDS = (
    ssz.BYTES32,  # parent_hash
    ssz.ByteVector(20),  # fee_recipient
    ssz.BYTES32,  # state_root
    ssz.BYTES32,  # receipts_root
    ssz.ByteVector(256),  # logs_bloom
    ssz.BYTES32,  # prev_randao
    ssz.UINT64,  # block_number
    ssz.UINT64,  # gas_limit
    ssz.UINT64,  # gas_used
    ssz.UINT64,  # timestamp
    ssz.ByteList(MAX_EXTRA_DATA_BYTES),  # extra_data
    ssz.Uint256(),  # base_fee_per_gas
    ssz.BYTES32,  # block_hash
)


@dataclass(frozen=True)
class ExecutionPayloadCapella:
    parent_hash: bytes
    fee_recipient: bytes
    state_root: bytes
    receipts_root: bytes
    logs_bloom: bytes
    prev_randao: bytes
    block_number: int
    gas_limit: int
    gas_used: int
    timestamp: int
    extra_data: bytes
    base_fee_per_gas: int
    block_hash: bytes
    transactions: tuple[bytes, ...] = ()
    withdrawals: tuple[Withdrawal, ...] = ()

    ssz_fields: ClassVar = (
        *_PAYLOAD_HEAD_FIELDS,
        ssz.List(
            ssz.ByteList(MAX_BYTES_PER_TRANSACTION),
            MAX_TRANSACTIONS_PER_PAYLOAD,
        ),
        ssz.List(ssz.Nested(Withdrawal), MAX_WITHDRAWALS_PER_PAYLOAD),
    )


@dataclass(frozen=True)
class ExecutionPayloadDeneb:
    parent_hash: bytes
    fee_recipient: bytes
    state_root: bytes
    receipts_root: bytes
    logs_bloom: bytes
    prev_randao: bytes
    block_number: int
    gas_limit: int
    gas_used: int
    timestamp: int
    extra_data: bytes
    base_fee_per_gas: int
    block_hash: bytes
    transactions: tuple[bytes, ...] = ()
    withdrawals: tuple[Withdrawal, ...] = ()
    blob_gas_used: int = 0
    excess_blob_gas: int = 0

    ssz_fields: ClassVar = (
        *_PAYLOAD_HEAD_FIELDS,
        ssz.List(
            ssz.ByteList(MAX_BYTES_PER_TRANSACTION),
            MAX_TRANSACTIONS_PER_PAYLOAD,
        ),
        ssz.List(ssz.Nested(Withdrawal), MAX_WITHDRAWALS_PER_PAYLOAD),
        ssz.UINT64,
        ssz.UINT64,
    )


@dataclass(frozen=True)
class ExecutionPayloadHeaderCapella:
    parent_hash: bytes
    fee_recipient: bytes
    state_root: bytes
    receipts_root: bytes
    logs_bloom: bytes
    prev_randao: bytes
    block_number: int
    gas_limit: int
    gas_used: int
    timestamp: int
    extra_data: bytes
    base_fee_per_gas: int
    block_hash: bytes
    transactions_root: bytes = bytes(32)
    withdrawals_root: bytes = bytes(32)

    ssz_fields: ClassVar = (
        *_PAYLOAD_HEAD_FIELDS,
        ssz.BYTES32,
        ssz.BYTES32,
    )


@dataclass(frozen=True)
class ExecutionPayloadHeaderDeneb:
    parent_hash: bytes
    fee_recipient: bytes
    state_root: bytes
    receipts_root: bytes
    logs_bloom: bytes
    prev_randao: bytes
    block_number: int
    gas_limit: int
    gas_used: int
    timestamp: int
    extra_data: bytes
    base_fee_per_gas: int
    block_hash: bytes
    transactions_root: bytes = bytes(32)
    withdrawals_root: bytes = bytes(32)
    blob_gas_used: int = 0
    excess_blob_gas: int = 0

    ssz_fields: ClassVar = (
        *_PAYLOAD_HEAD_FIELDS,
        ssz.BYTES32,
        ssz.BYTES32,
        ssz.UINT64,
        ssz.UINT64,
    )


# ---------------------------------------------------------------------------
# Block bodies + blocks (per fork, full + blinded)
# ---------------------------------------------------------------------------

_BODY_HEAD_FIELDS = (
    ssz.BYTES96,  # randao_reveal
    ssz.Nested(Eth1Data),
    ssz.BYTES32,  # graffiti
    ssz.List(ssz.Nested(ProposerSlashing), 16),
    ssz.List(ssz.Nested(AttesterSlashing), 2),
    ssz.List(ssz.Nested(Attestation), 128),
    ssz.List(ssz.Nested(Deposit), 16),
    ssz.List(ssz.Nested(SignedVoluntaryExit), 16),
    ssz.Nested(SyncAggregate),
)

_EMPTY_ETH1 = Eth1Data(bytes(32), 0, bytes(32))
_EMPTY_SYNC_AGG = SyncAggregate(tuple([False] * 512))


def _body_cls(name: str, payload_field: str, payload_cls, *, blobs: bool):
    """Build a per-fork body dataclass: identical head fields, then the
    fork's execution payload (or header, blinded) and — deneb on — the
    bls-to-execution-change and blob-commitment tails."""
    fields = [
        ("randao_reveal", bytes, dataclasses.field(default=bytes(96))),
        ("eth1_data", Eth1Data, dataclasses.field(default=_EMPTY_ETH1)),
        ("graffiti", bytes, dataclasses.field(default=bytes(32))),
        ("proposer_slashings", tuple, dataclasses.field(default=())),
        ("attester_slashings", tuple, dataclasses.field(default=())),
        ("attestations", tuple, dataclasses.field(default=())),
        ("deposits", tuple, dataclasses.field(default=())),
        ("voluntary_exits", tuple, dataclasses.field(default=())),
        (
            "sync_aggregate",
            SyncAggregate,
            dataclasses.field(default=_EMPTY_SYNC_AGG),
        ),
        (payload_field, payload_cls, dataclasses.field(default=payload_cls(
            parent_hash=bytes(32),
            fee_recipient=bytes(20),
            state_root=bytes(32),
            receipts_root=bytes(32),
            logs_bloom=bytes(256),
            prev_randao=bytes(32),
            block_number=0,
            gas_limit=0,
            gas_used=0,
            timestamp=0,
            extra_data=b"",
            base_fee_per_gas=0,
            block_hash=bytes(32),
        ))),
        ("bls_to_execution_changes", tuple, dataclasses.field(default=())),
    ]
    types = [
        *_BODY_HEAD_FIELDS,
        ssz.Nested(payload_cls),
        ssz.List(ssz.Nested(SignedBLSToExecutionChange), 16),
    ]
    if blobs:
        fields.append(
            ("blob_kzg_commitments", tuple, dataclasses.field(default=()))
        )
        types.append(
            ssz.List(ssz.BYTES48, MAX_BLOB_COMMITMENTS_PER_BLOCK)
        )
    cls = dataclasses.make_dataclass(
        name,
        fields,
        frozen=True,
        namespace={
            "ssz_fields": tuple(types),
            "hash_tree_root": lambda self: ssz.hash_tree_root(self),
        },
    )
    cls.__module__ = __name__
    return cls


BeaconBlockBodyCapella = _body_cls(
    "BeaconBlockBodyCapella",
    "execution_payload",
    ExecutionPayloadCapella,
    blobs=False,
)
BlindedBeaconBlockBodyCapella = _body_cls(
    "BlindedBeaconBlockBodyCapella",
    "execution_payload_header",
    ExecutionPayloadHeaderCapella,
    blobs=False,
)
BeaconBlockBodyDeneb = _body_cls(
    "BeaconBlockBodyDeneb",
    "execution_payload",
    ExecutionPayloadDeneb,
    blobs=True,
)
BlindedBeaconBlockBodyDeneb = _body_cls(
    "BlindedBeaconBlockBodyDeneb",
    "execution_payload_header",
    ExecutionPayloadHeaderDeneb,
    blobs=True,
)


def _block_cls(name: str, body_cls):
    cls = dataclasses.make_dataclass(
        name,
        [
            ("slot", int),
            ("proposer_index", int),
            ("parent_root", bytes),
            ("state_root", bytes),
            ("body", body_cls),
        ],
        frozen=True,
        namespace={
            "ssz_fields": (
                ssz.UINT64,
                ssz.UINT64,
                ssz.BYTES32,
                ssz.BYTES32,
                ssz.Nested(body_cls),
            ),
            "hash_tree_root": lambda self: ssz.hash_tree_root(self),
            "header": lambda self: BeaconBlockHeader(
                slot=self.slot,
                proposer_index=self.proposer_index,
                parent_root=self.parent_root,
                state_root=self.state_root,
                body_root=ssz.hash_tree_root(self.body),
            ),
        },
    )
    cls.__module__ = __name__
    return cls


BeaconBlockCapella = _block_cls("BeaconBlockCapella", BeaconBlockBodyCapella)
BlindedBeaconBlockCapella = _block_cls(
    "BlindedBeaconBlockCapella", BlindedBeaconBlockBodyCapella
)
BeaconBlockDeneb = _block_cls("BeaconBlockDeneb", BeaconBlockBodyDeneb)
BlindedBeaconBlockDeneb = _block_cls(
    "BlindedBeaconBlockDeneb", BlindedBeaconBlockBodyDeneb
)

# version string -> (full block class, blinded block class); ordered
# oldest-first so `latest_fork()` is the last entry
FORK_BLOCKS: dict[str, tuple[type, type]] = {
    "capella": (BeaconBlockCapella, BlindedBeaconBlockCapella),
    "deneb": (BeaconBlockDeneb, BlindedBeaconBlockDeneb),
}


def _signed_cls(name: str, block_cls):
    cls = dataclasses.make_dataclass(
        name,
        [
            ("message", block_cls),
            ("signature", bytes, dataclasses.field(default=bytes(96))),
        ],
        frozen=True,
        namespace={
            "ssz_fields": (ssz.Nested(block_cls), ssz.BYTES96),
            "hash_tree_root": lambda self: ssz.hash_tree_root(self),
        },
    )
    cls.__module__ = __name__
    return cls


SignedBeaconBlockCapella = _signed_cls(
    "SignedBeaconBlockCapella", BeaconBlockCapella
)
SignedBlindedBeaconBlockCapella = _signed_cls(
    "SignedBlindedBeaconBlockCapella", BlindedBeaconBlockCapella
)
SignedBeaconBlockDeneb = _signed_cls(
    "SignedBeaconBlockDeneb", BeaconBlockDeneb
)
SignedBlindedBeaconBlockDeneb = _signed_cls(
    "SignedBlindedBeaconBlockDeneb", BlindedBeaconBlockDeneb
)

# deneb block contents (produce) / signed block contents (publish):
# block + blob sidecar material as one SSZ container
BYTES_PER_BLOB = 131072  # 4096 field elements x 32 bytes


@dataclass(frozen=True)
class BlockContentsDeneb:
    block: Any
    kzg_proofs: tuple[bytes, ...] = ()
    blobs: tuple[bytes, ...] = ()

    ssz_fields: ClassVar = (
        ssz.Nested(BeaconBlockDeneb),
        ssz.List(ssz.BYTES48, MAX_BLOB_COMMITMENTS_PER_BLOCK),
        ssz.List(
            ssz.ByteVector(BYTES_PER_BLOB), MAX_BLOB_COMMITMENTS_PER_BLOCK
        ),
    )


@dataclass(frozen=True)
class SignedBlockContentsDeneb:
    signed_block: Any
    kzg_proofs: tuple[bytes, ...] = ()
    blobs: tuple[bytes, ...] = ()

    ssz_fields: ClassVar = (
        ssz.Nested(SignedBeaconBlockDeneb),
        ssz.List(ssz.BYTES48, MAX_BLOB_COMMITMENTS_PER_BLOCK),
        ssz.List(
            ssz.ByteVector(BYTES_PER_BLOB), MAX_BLOB_COMMITMENTS_PER_BLOCK
        ),
    )


# version -> (signed full class, signed blinded class)
FORK_SIGNED_BLOCKS: dict[str, tuple[type, type]] = {
    "capella": (SignedBeaconBlockCapella, SignedBlindedBeaconBlockCapella),
    "deneb": (SignedBeaconBlockDeneb, SignedBlindedBeaconBlockDeneb),
}


def block_class(version: str, blinded: bool) -> type:
    try:
        full, blind = FORK_BLOCKS[version]
    except KeyError:
        raise ValueError(f"unsupported block version {version!r}") from None
    return blind if blinded else full


def latest_fork() -> str:
    return next(reversed(FORK_BLOCKS))


# ---------------------------------------------------------------------------
# beacon-API JSON codec (descriptor-driven)
# ---------------------------------------------------------------------------


def bits_to_bytes(bits, sentinel: bool) -> bytes:
    n = len(bits)
    data = bytearray(n // 8 + 1 if sentinel else (n + 7) // 8)
    for i, bit in enumerate(bits):
        if bit:
            data[i // 8] |= 1 << (i % 8)
    if sentinel:
        data[n // 8] |= 1 << (n % 8)
    return bytes(data)


def bits_from_bytes(data: bytes, sentinel: bool, length: int | None = None):
    if sentinel:
        if not data or data[-1] == 0:
            raise ValueError("bitlist missing delimiter bit")
        total = (len(data) - 1) * 8 + data[-1].bit_length() - 1
    else:
        assert length is not None
        # truncated/oversized hex must be a ValueError (-> HTTP 400 in the
        # vapi handlers), not an IndexError 500; padding bits above
        # `length` must be zero (same canonicality rule as ssz._decode)
        if len(data) != (length + 7) // 8:
            raise ValueError("bitvector byte length mismatch")
        if length % 8 and data[-1] >> (length % 8):
            raise ValueError("bitvector has nonzero padding bits")
        total = length
    return tuple(
        bool(data[i // 8] >> (i % 8) & 1) for i in range(total)
    )


def _enc(t: ssz.SSZType, v: Any) -> Any:
    if isinstance(t, (ssz.Uint64, ssz.Uint256)):
        return str(int(v))
    if isinstance(t, ssz.Boolean):
        return bool(v)
    if isinstance(t, (ssz.ByteVector, ssz.ByteList)):
        return "0x" + bytes(v).hex()
    if isinstance(t, ssz.Bitlist):
        return "0x" + bits_to_bytes(v, sentinel=True).hex()
    if isinstance(t, ssz.Bitvector):
        return "0x" + bits_to_bytes(v, sentinel=False).hex()
    if isinstance(t, ssz.Nested):
        return to_json(v)
    if isinstance(t, (ssz.List, ssz.Vector)):
        return [_enc(t.elem, x) for x in v]
    raise TypeError(f"no JSON encoding for {type(t).__name__}")


def unhex0x(s: str) -> bytes:
    return bytes.fromhex(s[2:] if s.startswith("0x") else s)


def hex0x(b: bytes) -> str:
    return "0x" + bytes(b).hex()


def _dec(t: ssz.SSZType, v: Any) -> Any:
    if isinstance(t, (ssz.Uint64, ssz.Uint256)):
        return int(v)
    if isinstance(t, ssz.Boolean):
        return bool(v)
    if isinstance(t, (ssz.ByteVector, ssz.ByteList)):
        return unhex0x(v)
    if isinstance(t, ssz.Bitlist):
        bits = bits_from_bytes(unhex0x(v), sentinel=True)
        if len(bits) > t.limit:
            raise ValueError("bitlist exceeds limit")
        return bits
    if isinstance(t, ssz.Bitvector):
        return bits_from_bytes(unhex0x(v), sentinel=False, length=t.length)
    if isinstance(t, ssz.Nested):
        if t.cls is None:
            raise TypeError("Nested descriptor lacks cls; cannot decode")
        return from_json(t.cls, v)
    if isinstance(t, (ssz.List, ssz.Vector)):
        return tuple(_dec(t.elem, x) for x in v)
    raise TypeError(f"no JSON decoding for {type(t).__name__}")


def to_json(obj: Any) -> dict:
    """Beacon-API JSON object for an ssz_fields-bearing container."""
    out = {}
    for f, t in zip(dataclasses.fields(obj), obj.ssz_fields):
        out[f.name] = _enc(t, getattr(obj, f.name))
    return out


def from_json(cls: type, j: dict) -> Any:
    """Parse a beacon-API JSON object into container `cls` (strict: every
    SSZ field must be present — consensus objects have no optionals)."""
    kwargs = {}
    for f, t in zip(dataclasses.fields(cls), cls.ssz_fields):
        if f.name not in j:
            raise ValueError(f"{cls.__name__}: missing field {f.name!r}")
        kwargs[f.name] = _dec(t, j[f.name])
    return cls(**kwargs)
