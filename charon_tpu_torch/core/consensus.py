"""Consensus controller: pluggable protocols behind one interface.

Mirrors ref: core/consensus/controller.go — a controller holds the default
protocol (QBFT) plus dynamically selected alternates (switched by the
priority protocol, ref app/app.go:650-668). Until the QBFT engine lands,
EchoConsensus provides the "fetch-leader echo" protocol used by the
single-process simnet (SURVEY.md §7 minimum slice): every node's fetcher
output is delivered straight to its subscribers, which is sound when all
nodes fetch identical data from a shared deterministic beacon mock.
"""

from __future__ import annotations

from typing import Awaitable, Callable

from charon_tpu_torch.core.types import Duty, PubKey

DecidedSub = Callable[[Duty, dict[PubKey, object]], Awaitable[None]]


class EchoConsensus:
    """Trivial agreement for deterministic single-process clusters."""

    protocol_id = "echo/1.0.0"

    def __init__(self) -> None:
        self._subs: list[DecidedSub] = []
        self._decided: set[Duty] = set()

    def subscribe(self, sub: DecidedSub) -> None:
        self._subs.append(sub)

    async def propose(self, duty: Duty, unsigned_set: dict[PubKey, object]) -> None:
        if duty in self._decided:
            return
        self._decided.add(duty)
        for sub in self._subs:
            await sub(duty, unsigned_set)

    async def participate(self, duty: Duty) -> None:
        return None


class ConsensusController:
    """Holds default + current protocol (ref: controller.go:121)."""

    def __init__(self, default) -> None:
        self._default = default
        self._current = default
        self._protocols = {default.protocol_id: default}

    def register(self, consensus) -> None:
        self._protocols[consensus.protocol_id] = consensus

    def default_consensus(self):
        return self._default

    def current_consensus(self):
        return self._current

    def registered(self):
        """Registered protocols, current first — the preference order
        this node advertises in priority negotiation (ref: app/app.go
        Protocols ordering)."""
        return [self._current] + [
            p for p in self._protocols.values() if p is not self._current
        ]

    def set_current_for_protocol(self, protocol_id: str) -> bool:
        """Switch protocols by cluster preference (ref: app/app.go:650-668
        priority-driven switching)."""
        impl = self._protocols.get(protocol_id)
        if impl is None:
            return False
        self._current = impl
        return True

    # controller facade passes through to the current protocol
    def subscribe(self, sub) -> None:
        for impl in self._protocols.values():
            impl.subscribe(sub)

    async def propose(self, duty, unsigned_set) -> None:
        await self._current.propose(duty, unsigned_set)

    async def participate(self, duty) -> None:
        await self._current.participate(duty)
