"""cluster-lock.json: the post-DKG cluster state.

Mirrors ref: cluster/lock.go — the definition plus the created distributed
validators (group pubkey, per-node pubshares, deposit/registration data),
sealed by a BLS aggregate signature over the lock hash (every DV group key
signs it during the ceremony, ref: dkg/exchanger.go sigLock) and per-node
secp256k1 signatures (ref: dkg/nodesigs.go).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass, field

from charon_tpu_torch import tbls
from charon_tpu_torch.app import k1util
from charon_tpu_torch.cluster.definition import ClusterDefinition, _canonical

_LOCK_DOMAIN = b"charon-tpu/lock-hash"


@dataclass(frozen=True)
class DistributedValidator:
    """ref: cluster/lock.go DistributedValidator."""

    distributed_public_key: str  # 0x-hex 48 bytes (group pubkey)
    public_shares: tuple[str, ...]  # 0x-hex 48 bytes per node (1-based order)
    deposit_data: dict = field(default_factory=dict)
    builder_registration: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "distributed_public_key": self.distributed_public_key,
            "public_shares": list(self.public_shares),
            "deposit_data": self.deposit_data,
            "builder_registration": self.builder_registration,
        }


@dataclass(frozen=True)
class ClusterLock:
    definition: ClusterDefinition
    validators: tuple[DistributedValidator, ...]
    signature_aggregate: str = ""  # 0x-hex BLS aggregate over lock hash
    node_signatures: tuple[str, ...] = ()  # hex k1 sigs, one per operator

    def lock_hash(self) -> bytes:
        payload = {
            "definition_hash": "0x" + self.definition.definition_hash().hex(),
            "validators": [v.to_json() for v in self.validators],
        }
        return hashlib.sha256(_LOCK_DOMAIN + _canonical(payload)).digest()

    def fork_info(self):
        """The cluster's signing ForkInfo: fork version from the
        definition, genesis validators root derived from the lock hash
        (single source shared by the node runtime and the exit CLI so
        signing roots always agree)."""
        from charon_tpu_torch.eth2util.signing import ForkInfo

        fv = bytes.fromhex(self.definition.fork_version[2:])
        return ForkInfo(
            genesis_validators_root=hashlib.sha256(
                b"gvr" + self.lock_hash()
            ).digest(),
            fork_version=fv,
            genesis_fork_version=fv,
        )

    # -- verification (ref: cluster/lock.go VerifySignatures) -------------

    def verify(self, operator_k1_pubkeys: list[bytes] | None = None) -> None:
        defn = self.definition
        if len(self.validators) != defn.num_validators:
            raise ValueError("validator count mismatch")
        n = len(defn.operators)
        for v in self.validators:
            if len(v.public_shares) != n:
                raise ValueError("pubshare count mismatch")

        # BLS aggregate: every group key signed the lock hash.
        if not self.signature_aggregate:
            raise ValueError("missing aggregate signature")
        msg = self.lock_hash()
        pubkeys = [
            bytes.fromhex(v.distributed_public_key[2:])
            for v in self.validators
        ]
        tbls.verify_aggregate(
            pubkeys, msg, bytes.fromhex(self.signature_aggregate[2:])
        )

        if operator_k1_pubkeys is not None:
            if len(self.node_signatures) != len(operator_k1_pubkeys):
                raise ValueError("node signature count mismatch")
            for i, (sig, pk) in enumerate(
                zip(self.node_signatures, operator_k1_pubkeys)
            ):
                if not k1util.verify_bytes(pk, msg, bytes.fromhex(sig)):
                    raise ValueError(f"bad node signature from operator {i}")

    # -- JSON round-trip --------------------------------------------------

    def to_json(self) -> dict:
        return {
            "cluster_definition": self.definition.to_json(),
            "distributed_validators": [v.to_json() for v in self.validators],
            "signature_aggregate": self.signature_aggregate,
            "node_signatures": list(self.node_signatures),
            "lock_hash": "0x" + self.lock_hash().hex(),
        }

    @classmethod
    def from_json(cls, data: dict) -> "ClusterLock":
        lock = cls(
            definition=ClusterDefinition.from_json(data["cluster_definition"]),
            validators=tuple(
                DistributedValidator(
                    distributed_public_key=v["distributed_public_key"],
                    public_shares=tuple(v["public_shares"]),
                    deposit_data=v.get("deposit_data", {}),
                    builder_registration=v.get("builder_registration", {}),
                )
                for v in data["distributed_validators"]
            ),
            signature_aggregate=data.get("signature_aggregate", ""),
            node_signatures=tuple(data.get("node_signatures", ())),
        )
        if "lock_hash" in data:
            if bytes.fromhex(data["lock_hash"][2:]) != lock.lock_hash():
                raise ValueError("lock hash mismatch")
        return lock

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "ClusterLock":
        with open(path) as f:
            return cls.from_json(json.load(f))
