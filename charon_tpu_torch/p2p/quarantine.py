"""Per-peer malformed-frame quarantine.

Dropping-and-counting a malformed frame keeps the authenticated
connection alive (p2p/transport per-frame fault isolation), but a peer
*streaming* garbage — a buggy build, a fuzzing adversary — still costs
a decode attempt and a log line per frame. This state machine mutes
such a peer temporarily: `strikes` CodecErrors inside `window` seconds
impose a mute of `base` seconds, doubling per repeat offense up to
`max_mute`; a clean frame after the mute expires forgives the backoff
level. Pure host bookkeeping with an injectable clock, deliberately
free of the transport's `cryptography` dependency so the fast tier
exercises it everywhere.
"""

from __future__ import annotations

import time

QUARANTINE_STRIKES = 5
QUARANTINE_WINDOW = 10.0
QUARANTINE_BASE = 5.0
QUARANTINE_MAX = 300.0


class PeerQuarantine:
    """Tracks strike windows and mute deadlines per peer id.

    observer(peer, mute_seconds) fires once per imposed mute (the
    transport chains logging + the wire_peer_quarantine_total metric
    through it).

    `exempt` peers (any hashable id — the crypto-service client keys by
    "host:port") still accumulate strike counts for observability but
    NEVER escalate into a mute: a client's own configured server
    address flapping mid-upgrade should trigger reconnect backoff, not
    a 300 s codec mute that silently extends the outage."""

    def __init__(
        self,
        strikes: int = QUARANTINE_STRIKES,
        window: float = QUARANTINE_WINDOW,
        base: float = QUARANTINE_BASE,
        max_mute: float = QUARANTINE_MAX,
        observer=None,
        clock=time.monotonic,
        exempt=(),
    ) -> None:
        self.strikes = strikes
        self.window = window
        self.base = base
        self.max_mute = max_mute
        self.observer = observer
        self.exempt = frozenset(exempt)
        self._clock = clock
        self._strikes: dict[int, list[float]] = {}
        self._until: dict[int, float] = {}
        self._level: dict[int, int] = {}
        self.quarantines = 0  # mutes imposed (wire_peer_quarantine_total)

    def muted(self, peer: int) -> bool:
        if peer in self.exempt:
            return False
        return self._clock() < self._until.get(peer, 0.0)

    def strike(self, peer: int) -> float | None:
        """One malformed frame from the peer. Returns the mute length
        when this strike imposes one, else None."""
        now = self._clock()
        strikes = self._strikes.setdefault(peer, [])
        strikes.append(now)
        while strikes and now - strikes[0] > self.window:
            strikes.pop(0)
        if peer in self.exempt:
            return None  # pinned address: backoff owns flap handling
        if len(strikes) < self.strikes:
            return None
        strikes.clear()
        level = self._level.get(peer, 0)
        mute = min(self.base * (2**level), self.max_mute)
        self._level[peer] = level + 1
        self._until[peer] = now + mute
        self.quarantines += 1
        if self.observer is not None:
            self.observer(peer, mute)
        return mute

    def forgive(self, peer: int) -> None:
        """A clean frame decoded after the mute expired: reset the
        exponential-backoff level (the peer recovered)."""
        self._level.pop(peer, None)
        self._until.pop(peer, None)

    @property
    def any_history(self) -> bool:
        """Cheap hot-path guard: False until a peer has ever offended."""
        return bool(self._level) or bool(self._strikes)
