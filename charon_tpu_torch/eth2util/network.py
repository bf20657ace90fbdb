"""Ethereum network registry: fork versions, genesis times, names.

Mirrors ref: eth2util/network.go — a static registry of the public
networks charon supports plus custom/test networks registered at runtime.
The constants are public chain parameters (eth2 spec / client configs).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Network:
    name: str
    genesis_fork_version: bytes  # 4 bytes
    genesis_time: int  # unix seconds
    chain_id: int


_NETWORKS: dict[str, Network] = {}
_BY_FORK: dict[bytes, Network] = {}


def register(net: Network) -> None:
    _NETWORKS[net.name] = net
    _BY_FORK.setdefault(net.genesis_fork_version, net)


for _net in (
    Network("mainnet", bytes.fromhex("00000000"), 1_606_824_023, 1),
    Network("goerli", bytes.fromhex("00001020"), 1_616_508_000, 5),
    Network("sepolia", bytes.fromhex("90000069"), 1_655_733_600, 11155111),
    Network("holesky", bytes.fromhex("01017000"), 1_695_902_400, 17000),
    Network("gnosis", bytes.fromhex("00000064"), 1_638_993_340, 100),
    # reserved test fork version for in-process simnet clusters
    Network("simnet", bytes.fromhex("00000fff"), 0, 0),
):
    register(_net)


def by_name(name: str) -> Network:
    try:
        return _NETWORKS[name]
    except KeyError:
        raise ValueError(
            f"unknown network {name!r} (known: {sorted(_NETWORKS)})"
        ) from None


def by_fork_version(fork_version: bytes | str) -> Network | None:
    if isinstance(fork_version, str):
        fork_version = bytes.fromhex(
            fork_version[2:] if fork_version.startswith("0x") else fork_version
        )
    return _BY_FORK.get(fork_version)


def genesis_time(fork_version: bytes | str, default: int = 0) -> int:
    net = by_fork_version(fork_version)
    return net.genesis_time if net is not None else default
