"""Cluster manifest: a mutation-DAG over the cluster's life.

Mirrors ref: cluster/manifest — the cluster state is not a static lock
file but a chain of signed mutations materialised into the current
state (materialise.go:11):

  * legacy_lock      genesis mutation embedding the ceremony's lock
                     (mutationlegacylock.go)
  * add_validators   appends distributed validators produced by a later
                     ceremony (mutationaddvalidator.go)
  * node_approval    an operator's k1 signature over a parent mutation
                     (mutationnodeapproval.go); add_validators only takes
                     effect once EVERY operator has approved it

Each mutation commits to its parent's hash, so the file is an
append-only hash chain; `materialise()` folds it into the effective
cluster state (a ClusterLock with the combined validator set). Loaded at
startup in preference to the plain lock (ref: app/app.go:166).
"""

from __future__ import annotations

import hashlib
import json
import time
from dataclasses import dataclass, field, replace

from charon_tpu_torch.app import k1util
from charon_tpu_torch.cluster.definition import _canonical
from charon_tpu_torch.cluster.lock import ClusterLock, DistributedValidator
from charon_tpu_torch.eth2util import enr as enrlib

GENESIS_PARENT = bytes(32)

TYPE_LEGACY_LOCK = "legacy_lock"
TYPE_ADD_VALIDATORS = "add_validators"
TYPE_NODE_APPROVAL = "node_approval"


@dataclass(frozen=True)
class SignedMutation:
    parent: bytes  # parent mutation hash (32B; zero for genesis)
    type: str
    timestamp: int
    data: dict  # type-specific payload (canonical-JSON hashed)
    signer: bytes = b""  # 33B k1 pubkey for signed mutation types
    signature: bytes = b""  # 64B k1 signature

    def signing_payload(self) -> dict:
        return {
            "parent": "0x" + self.parent.hex(),
            "type": self.type,
            "timestamp": self.timestamp,
            "data": self.data,
            "signer": self.signer.hex(),
        }

    def signing_digest(self) -> bytes:
        return hashlib.sha256(
            b"charon-tpu/mutation" + _canonical(self.signing_payload())
        ).digest()

    def hash(self) -> bytes:
        payload = self.signing_payload()
        payload["signature"] = self.signature.hex()
        return hashlib.sha256(
            b"charon-tpu/mutation" + _canonical(payload)
        ).digest()

    def to_json(self) -> dict:
        out = self.signing_payload()
        out["signature"] = self.signature.hex()
        return out

    @classmethod
    def from_json(cls, data: dict) -> "SignedMutation":
        return cls(
            parent=bytes.fromhex(data["parent"][2:]),
            type=data["type"],
            timestamp=data["timestamp"],
            data=data["data"],
            signer=bytes.fromhex(data["signer"]),
            signature=bytes.fromhex(data["signature"]),
        )


def _validators_from_json(items: list[dict]) -> tuple[DistributedValidator, ...]:
    return tuple(
        DistributedValidator(
            distributed_public_key=v["distributed_public_key"],
            public_shares=tuple(v["public_shares"]),
        )
        for v in items
    )


@dataclass(frozen=True)
class Manifest:
    mutations: tuple[SignedMutation, ...]

    # -- construction -----------------------------------------------------

    @classmethod
    def genesis(cls, lock: ClusterLock) -> "Manifest":
        """legacy_lock genesis mutation (ref: mutationlegacylock.go)."""
        m = SignedMutation(
            parent=GENESIS_PARENT,
            type=TYPE_LEGACY_LOCK,
            timestamp=int(time.time()),
            data={"lock": lock.to_json()},
        )
        return cls(mutations=(m,))

    def head(self) -> bytes:
        return self.mutations[-1].hash()

    def propose_add_validators(
        self, validators: list[DistributedValidator]
    ) -> SignedMutation:
        """An unsigned add_validators mutation against the current head
        (ref: mutationaddvalidator.go)."""
        return SignedMutation(
            parent=self.head(),
            type=TYPE_ADD_VALIDATORS,
            timestamp=int(time.time()),
            data={"validators": [v.to_json() for v in validators]},
        )

    def approve(self, mutation_hash: bytes, privkey) -> SignedMutation:
        """One operator's node_approval of a pending mutation
        (ref: mutationnodeapproval.go)."""
        m = SignedMutation(
            parent=self.head(),
            type=TYPE_NODE_APPROVAL,
            timestamp=int(time.time()),
            data={"approved": "0x" + mutation_hash.hex()},
            signer=k1util.public_key_to_bytes(privkey.public_key()),
        )
        return replace(
            m, signature=k1util.sign(privkey, m.signing_digest())
        )

    def append(self, mutation: SignedMutation) -> "Manifest":
        if mutation.parent != self.head():
            raise ValueError("mutation parent does not match manifest head")
        return Manifest(mutations=self.mutations + (mutation,))

    # -- materialisation (ref: materialise.go Materialise) ----------------

    def materialise(self) -> ClusterLock:
        """Fold the chain into the effective cluster state. Verifies the
        hash chain, mutation signatures, and the all-operators approval
        rule for add_validators."""
        if not self.mutations:
            raise ValueError("empty manifest")
        first = self.mutations[0]
        if first.type != TYPE_LEGACY_LOCK or first.parent != GENESIS_PARENT:
            raise ValueError("manifest must start with a legacy_lock genesis")
        lock = ClusterLock.from_json(first.data["lock"])
        operator_pubkeys = [
            enrlib.pubkey_from_string(op.enr)
            for op in lock.definition.operators
        ]

        validators = list(lock.validators)
        # pending add_validators hash -> (validators, approvals set)
        pending: dict[bytes, tuple[list, set[bytes]]] = {}
        prev = first
        for m in self.mutations[1:]:
            if m.parent != prev.hash():
                raise ValueError("broken mutation chain")
            if m.type == TYPE_ADD_VALIDATORS:
                pending[m.hash()] = (
                    list(_validators_from_json(m.data["validators"])),
                    set(),
                )
            elif m.type == TYPE_NODE_APPROVAL:
                if m.signer not in operator_pubkeys:
                    raise ValueError("approval from non-operator")
                if not k1util.verify_bytes(
                    m.signer, m.signing_digest(), m.signature
                ):
                    raise ValueError("bad approval signature")
                target = bytes.fromhex(m.data["approved"][2:])
                if target not in pending:
                    raise ValueError("approval of unknown mutation")
                vals, approvals = pending[target]
                approvals.add(m.signer)
                if len(approvals) == len(operator_pubkeys):
                    validators.extend(vals)
                    del pending[target]
            else:
                raise ValueError(f"unknown mutation type {m.type}")
            prev = m

        return replace(lock, validators=tuple(validators))

    # -- disk -------------------------------------------------------------

    def to_json(self) -> dict:
        return {"mutations": [m.to_json() for m in self.mutations]}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)

    @classmethod
    def from_json(cls, data: dict) -> "Manifest":
        return cls(
            mutations=tuple(
                SignedMutation.from_json(m) for m in data["mutations"]
            )
        )

    @classmethod
    def load(cls, path: str) -> "Manifest":
        with open(path) as f:
            return cls.from_json(json.load(f))


def load_cluster_state(data_dir) -> ClusterLock:
    """Prefer cluster-manifest.json over cluster-lock.json
    (ref: app/app.go:166 loadClusterManifest)."""
    from pathlib import Path

    data_dir = Path(data_dir)
    manifest_path = data_dir / "cluster-manifest.json"
    if manifest_path.exists():
        return Manifest.load(str(manifest_path)).materialise()
    return ClusterLock.load(str(data_dir / "cluster-lock.json"))
