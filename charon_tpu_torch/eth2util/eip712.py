"""EIP-712 typed structured data hashing.

Mirrors ref: eth2util/eip712/eip712.go — the reference signs cluster
definition config hashes, operator ENRs and terms-and-conditions as
EIP-712 typed data so wallets can display what is being signed. This is
the spec-exact hashing: domain separator, type hashes, and the final
keccak256(0x1901 || domainSeparator || hashStruct(message)).

Supported field types match the reference's subset: string, uint256,
address, bytes32 (primitives the cluster payloads need).
"""

from __future__ import annotations

from dataclasses import dataclass

from charon_tpu_torch.eth2util.keccak import keccak_256


@dataclass(frozen=True)
class Field:
    name: str
    type: str  # "string" | "uint256" | "address" | "bytes32"
    value: object


@dataclass(frozen=True)
class TypedData:
    """One primary type + its fields, hashed under a domain."""

    primary_type: str
    fields: tuple[Field, ...]


@dataclass(frozen=True)
class Domain:
    """EIP712Domain{name, version, chainId} (the reference's domain shape,
    ref: eip712.go eip712Domain)."""

    name: str
    version: str
    chain_id: int

    def separator(self) -> bytes:
        type_hash = keccak_256(
            b"EIP712Domain(string name,string version,uint256 chainId)"
        )
        return keccak_256(
            type_hash
            + keccak_256(self.name.encode())
            + keccak_256(self.version.encode())
            + self.chain_id.to_bytes(32, "big")
        )


def _encode_value(ftype: str, value) -> bytes:
    if ftype == "string":
        return keccak_256(
            value.encode() if isinstance(value, str) else bytes(value)
        )
    if ftype == "uint256":
        return int(value).to_bytes(32, "big")
    if ftype == "address":
        raw = (
            bytes.fromhex(value.removeprefix("0x"))
            if isinstance(value, str)
            else bytes(value)
        )
        return bytes(12) + raw
    if ftype == "bytes32":
        raw = (
            bytes.fromhex(value.removeprefix("0x"))
            if isinstance(value, str)
            else bytes(value)
        )
        if len(raw) != 32:
            raise ValueError("bytes32 value must be 32 bytes")
        return raw
    raise ValueError(f"unsupported EIP-712 field type {ftype}")


def hash_struct(data: TypedData) -> bytes:
    sig = (
        data.primary_type
        + "("
        + ",".join(f"{f.type} {f.name}" for f in data.fields)
        + ")"
    )
    encoded = keccak_256(sig.encode())
    for f in data.fields:
        encoded += _encode_value(f.type, f.value)
    return keccak_256(encoded)


def hash_typed_data(domain: Domain, data: TypedData) -> bytes:
    """The digest a wallet signs: keccak256(0x19 0x01 || domain || struct)
    (ref: eip712.go HashTypedData)."""
    return keccak_256(b"\x19\x01" + domain.separator() + hash_struct(data))
