"""cluster-definition.json: the intended cluster configuration.

Mirrors ref: cluster/definition.go — operators agree on (name, validators,
threshold, fork) before DKG; each operator signs the config hash and their
ENR with their secp256k1 key as EIP-712 typed data (wallet-displayable,
ref: cluster/eip712sigs.go).
"""

from __future__ import annotations

import hashlib
import json
import uuid as uuidlib
from dataclasses import asdict, dataclass, field, replace

from charon_tpu_torch.app import k1util

# Current definition format revision. v1.1 adds `consensus_protocol`
# (the cluster's preferred consensus protocol, seeding the runtime
# priority negotiation) to the signed config payload.
DEFINITION_VERSION = "ctpu/v1.1"

# Parse/DKG gate: documents in any of these revisions are accepted;
# anything else is rejected up-front with an actionable error
# (ref: dkg/dkg.go:108-116 gates supported cluster-definition versions,
# cluster/definition.go supportedVersions).
SUPPORTED_VERSIONS = ("ctpu/v1.0", "ctpu/v1.1")

_CONFIG_DOMAIN = b"charon-tpu/definition-config-hash"


def _canonical(obj) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


@dataclass(frozen=True)
class Operator:
    """One node operator (ref: cluster/definition.go Operator)."""

    address: str  # operator identity (eth address or label)
    enr: str  # node record (charon_tpu_torch/eth2util/enr format)
    config_signature: str = ""  # hex k1 sig over the config hash
    enr_signature: str = ""  # hex k1 sig over the ENR

    def to_json(self) -> dict:
        return asdict(self)


@dataclass(frozen=True)
class ClusterDefinition:
    name: str
    num_validators: int
    threshold: int
    fork_version: str  # 0x-hex 4 bytes
    operators: tuple[Operator, ...]
    uuid: str = field(default_factory=lambda: str(uuidlib.uuid4()))
    version: str = DEFINITION_VERSION
    timestamp: str = ""
    fee_recipient_address: str = ""
    withdrawal_address: str = ""
    dkg_algorithm: str = "frost"
    creator_address: str = ""
    # v1.1+: preferred consensus protocol (empty = node default); feeds
    # the priority/infosync negotiation's proposal ordering
    consensus_protocol: str = ""

    # -- hashing ----------------------------------------------------------

    def config_payload(self) -> dict:
        """The operator-agnostic config (what everyone signs) —
        ref: definition.go config hash covers all fields except
        signatures. VERSIONED: fields added in later revisions enter the
        payload only for documents of those revisions, so hashes of old
        documents stay stable (ref: definition.go hashes per-version)."""
        out = {
            "name": self.name,
            "uuid": self.uuid,
            "version": self.version,
            "timestamp": self.timestamp,
            "num_validators": self.num_validators,
            "threshold": self.threshold,
            "fork_version": self.fork_version,
            "fee_recipient_address": self.fee_recipient_address,
            "withdrawal_address": self.withdrawal_address,
            "dkg_algorithm": self.dkg_algorithm,
            "creator_address": self.creator_address,
            "operators": [
                {"address": op.address, "enr": op.enr}
                for op in self.operators
            ],
        }
        if self.version != "ctpu/v1.0":
            out["consensus_protocol"] = self.consensus_protocol
        return out

    def config_hash(self) -> bytes:
        return hashlib.sha256(
            _CONFIG_DOMAIN + _canonical(self.config_payload())
        ).digest()

    def definition_hash(self) -> bytes:
        """Hash over everything incl. signatures (the DKG context id —
        ref: definition.go DefinitionHash)."""
        payload = self.config_payload()
        payload["signatures"] = [
            {
                "config_signature": op.config_signature,
                "enr_signature": op.enr_signature,
            }
            for op in self.operators
        ]
        return hashlib.sha256(_CONFIG_DOMAIN + _canonical(payload)).digest()

    # -- signing (EIP-712 typed data, ref: cluster/eip712sigs.go) ----------

    def _eip712_domain(self):
        from charon_tpu_torch.eth2util.eip712 import Domain

        return Domain(name="charon-tpu", version="1.0", chain_id=1)

    def config_signature_digest(self) -> bytes:
        """EIP-712 digest over the config hash — what wallets display and
        operators sign (ref: eip712sigs.go OperatorConfigHash type)."""
        from charon_tpu_torch.eth2util.eip712 import Field, TypedData, hash_typed_data

        return hash_typed_data(
            self._eip712_domain(),
            TypedData(
                primary_type="OperatorConfigHash",
                fields=(
                    Field("config_hash", "bytes32", self.config_hash()),
                ),
            ),
        )

    def enr_signature_digest(self, enr: str) -> bytes:
        from charon_tpu_torch.eth2util.eip712 import Field, TypedData, hash_typed_data

        return hash_typed_data(
            self._eip712_domain(),
            TypedData(
                primary_type="ENR",
                fields=(Field("enr", "string", enr),),
            ),
        )

    def sign_operator(self, op_index: int, privkey) -> "ClusterDefinition":
        """Operator signs the EIP-712 config digest + their ENR digest."""
        op = self.operators[op_index]
        cfg_sig = k1util.sign(privkey, self.config_signature_digest())
        enr_sig = k1util.sign(privkey, self.enr_signature_digest(op.enr))
        new_op = replace(
            op,
            config_signature=cfg_sig.hex(),
            enr_signature=enr_sig.hex(),
        )
        ops = list(self.operators)
        ops[op_index] = new_op
        return replace(self, operators=tuple(ops))

    def verify_signatures(self, pubkeys: list[bytes]) -> None:
        """pubkeys: 33-byte compressed k1 key per operator."""
        if len(pubkeys) != len(self.operators):
            raise ValueError("pubkey count mismatch")
        cfg_digest = self.config_signature_digest()
        for op, pk in zip(self.operators, pubkeys):
            if not op.config_signature or not op.enr_signature:
                raise ValueError(f"operator {op.address} has not signed")
            if not k1util.verify_bytes(
                pk, cfg_digest, bytes.fromhex(op.config_signature)
            ):
                raise ValueError(f"bad config signature for {op.address}")
            if not k1util.verify_bytes(
                pk,
                self.enr_signature_digest(op.enr),
                bytes.fromhex(op.enr_signature),
            ):
                raise ValueError(f"bad ENR signature for {op.address}")

    # -- JSON round-trip --------------------------------------------------

    def to_json(self) -> dict:
        out = self.config_payload()
        out["operators"] = [op.to_json() for op in self.operators]
        out["config_hash"] = "0x" + self.config_hash().hex()
        out["definition_hash"] = "0x" + self.definition_hash().hex()
        return out

    @classmethod
    def from_json(cls, data: dict) -> "ClusterDefinition":
        version = data.get("version", DEFINITION_VERSION)
        if version not in SUPPORTED_VERSIONS:
            # the gate every loader (run, dkg, CLI) passes through
            # (ref: dkg/dkg.go:108-116)
            raise ValueError(
                f"unsupported cluster definition version {version!r}; "
                f"supported: {', '.join(SUPPORTED_VERSIONS)}"
            )
        ops = tuple(
            Operator(
                address=o["address"],
                enr=o["enr"],
                config_signature=o.get("config_signature", ""),
                enr_signature=o.get("enr_signature", ""),
            )
            for o in data["operators"]
        )
        defn = cls(
            name=data["name"],
            num_validators=data["num_validators"],
            threshold=data["threshold"],
            fork_version=data["fork_version"],
            operators=ops,
            uuid=data["uuid"],
            version=version,
            timestamp=data.get("timestamp", ""),
            fee_recipient_address=data.get("fee_recipient_address", ""),
            withdrawal_address=data.get("withdrawal_address", ""),
            dkg_algorithm=data.get("dkg_algorithm", "frost"),
            creator_address=data.get("creator_address", ""),
            # v1.0 documents exclude this field from the signed config
            # hash, so a value smuggled into a signed v1.0 JSON would be
            # UNAUTHENTICATED — ignore it rather than store it
            consensus_protocol=(
                data.get("consensus_protocol", "")
                if version != "ctpu/v1.0"
                else ""
            ),
        )
        if "config_hash" in data:
            want = bytes.fromhex(data["config_hash"][2:])
            if want != defn.config_hash():
                raise ValueError("config hash mismatch")
        return defn
