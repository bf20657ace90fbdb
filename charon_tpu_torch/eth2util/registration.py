"""Builder (validator) registrations: SSZ container, signing root, and
the pre-generated registrations carried in cluster locks.

Mirrors ref: eth2util/registration/registration.go — builds
ValidatorRegistration messages, computes their APPLICATION_BUILDER
signing root (genesis fork version + empty genesis validators root, per
the builder spec), and round-trips the lock-file JSON form that
core/bcast/recast.go re-broadcasts every epoch.
"""

from __future__ import annotations

from dataclasses import dataclass

from charon_tpu_torch.eth2util import ssz
from charon_tpu_torch.eth2util.signing import DomainName, ForkInfo

# Obol's conventional default for pre-generated registrations
# (ref: eth2util/registration DefaultGasLimit).
DEFAULT_GAS_LIMIT = 30_000_000


@dataclass(frozen=True)
class ValidatorRegistration:
    """The builder-spec ValidatorRegistrationV1 message."""

    fee_recipient: bytes  # 20 bytes
    gas_limit: int
    timestamp: int  # unix seconds; spec: the chain's genesis time
    pubkey: bytes  # 48-byte group BLS pubkey

    ssz_fields = (
        ssz.ByteVector(20),
        ssz.Uint64(),
        ssz.Uint64(),
        ssz.ByteVector(48),
    )

    def __post_init__(self) -> None:
        if len(self.fee_recipient) != 20:
            raise ValueError("fee recipient must be 20 bytes")
        if len(self.pubkey) != 48:
            raise ValueError("pubkey must be 48 bytes")

    def hash_tree_root(self) -> bytes:
        return ssz.hash_tree_root(self)


def signing_root(reg: ValidatorRegistration, fork: ForkInfo) -> bytes:
    """APPLICATION_BUILDER domain root (ref: the reference pins the
    genesis fork version with an empty genesis validators root for
    builder registrations)."""
    return fork.signing_root(
        DomainName.APPLICATION_BUILDER, reg.hash_tree_root()
    )


def to_lock_json(reg: ValidatorRegistration, signature: bytes) -> dict:
    """The cluster-lock `builder_registration` object
    (ref: cluster/lock.go DistributedValidator.BuilderRegistration)."""
    return {
        "message": {
            "fee_recipient": "0x" + reg.fee_recipient.hex(),
            "gas_limit": reg.gas_limit,
            "timestamp": reg.timestamp,
            "pubkey": "0x" + reg.pubkey.hex(),
        },
        "signature": "0x" + signature.hex(),
    }


def from_lock_json(obj: dict) -> tuple[ValidatorRegistration, bytes]:
    msg = obj["message"]

    def unhex(s: str) -> bytes:
        return bytes.fromhex(s[2:] if s.startswith("0x") else s)

    reg = ValidatorRegistration(
        fee_recipient=unhex(msg["fee_recipient"]),
        gas_limit=int(msg["gas_limit"]),
        timestamp=int(msg["timestamp"]),
        pubkey=unhex(msg["pubkey"]),
    )
    return reg, unhex(obj["signature"])
