"""Deposit data: the signed messages that activate validators on-chain.

Mirrors ref: eth2util/deposit/deposit.go — DepositMessage/DepositData
hash-tree-roots per the eth2 spec, the DOMAIN_DEPOSIT signing root
(computed against the genesis fork with an empty validators root), and
the launchpad-compatible deposit-data.json array.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass

from charon_tpu_torch.eth2util import ssz
from charon_tpu_torch.eth2util.signing import DomainName, compute_domain, compute_signing_root

# 32 ETH in gwei — the standard activation amount (ref: deposit.go).
DEFAULT_AMOUNT_GWEI = 32_000_000_000


def withdrawal_credentials_bls(withdrawal_pubkey: bytes) -> bytes:
    """0x00 BLS credentials: sha256(pubkey) with the first byte zeroed."""
    if len(withdrawal_pubkey) != 48:
        raise ValueError("withdrawal pubkey must be 48 bytes")
    h = hashlib.sha256(withdrawal_pubkey).digest()
    return b"\x00" + h[1:]


def withdrawal_credentials_eth1(address: bytes | str) -> bytes:
    """0x01 execution-address credentials (ref: deposit.go
    withdrawalCredsFromAddr)."""
    if isinstance(address, str):
        address = bytes.fromhex(address.removeprefix("0x"))
    if len(address) != 20:
        raise ValueError("execution address must be 20 bytes")
    return b"\x01" + bytes(11) + address


@dataclass(frozen=True)
class DepositMessage:
    pubkey: bytes  # 48
    withdrawal_credentials: bytes  # 32
    amount: int  # gwei

    ssz_fields = (ssz.BYTES48, ssz.BYTES32, ssz.UINT64)

    def hash_tree_root(self) -> bytes:
        return ssz.hash_tree_root(self)


@dataclass(frozen=True)
class DepositData:
    pubkey: bytes  # 48
    withdrawal_credentials: bytes  # 32
    amount: int
    signature: bytes  # 96

    ssz_fields = (ssz.BYTES48, ssz.BYTES32, ssz.UINT64, ssz.BYTES96)

    def hash_tree_root(self) -> bytes:
        return ssz.hash_tree_root(self)


def signing_root(msg: DepositMessage, genesis_fork_version: bytes) -> bytes:
    """DOMAIN_DEPOSIT is fork-agnostic: genesis fork version + zero
    validators root (ref: deposit.go GetMessageSigningRoot)."""
    domain = compute_domain(
        DomainName.DEPOSIT, genesis_fork_version, bytes(32)
    )
    return compute_signing_root(msg.hash_tree_root(), domain)


def deposit_data_json(
    deposits: list[DepositData],
    fork_version: bytes,
    network_name: str = "",
) -> str:
    """Launchpad-compatible deposit-data.json (ref: deposit.go
    MarshalDepositData)."""
    out = []
    for d in deposits:
        msg = DepositMessage(d.pubkey, d.withdrawal_credentials, d.amount)
        out.append(
            {
                "pubkey": d.pubkey.hex(),
                "withdrawal_credentials": d.withdrawal_credentials.hex(),
                "amount": str(d.amount),
                "signature": d.signature.hex(),
                "deposit_message_root": msg.hash_tree_root().hex(),
                "deposit_data_root": d.hash_tree_root().hex(),
                "fork_version": fork_version.hex(),
                "network_name": network_name,
            }
        )
    return json.dumps(out, indent=2)
