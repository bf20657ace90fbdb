"""Exponential backoff with jitter — the one shared implementation.

Mirrors ref: app/expbackoff/expbackoff.go (grpc-style schedule: delay =
base * multiplier^retries, jittered, capped at max): `Config` presets
(default + fast), the pure `backoff_delay` schedule for callers that own
their sleeps, and the stateful awaitable `ExpBackoff` used by the Lazy
eth2 client, the relay reserver and the DKG sync clients.

This is the dedicated util the inline backoffs grew out of;
`app.eth2wrap.ExpBackoff` re-exports it for existing importers.
"""

from __future__ import annotations

import asyncio
import random
from dataclasses import dataclass


@dataclass(frozen=True)
class Config:
    base_delay: float = 1.0  # seconds before the first retry
    multiplier: float = 1.6  # growth factor per retry
    jitter: float = 0.2  # ± fraction randomization per delay
    max_delay: float = 120.0  # upper bound on the unjittered delay


# ref: expbackoff.go:33 DefaultConfig / :41 FastConfig
DEFAULT_CONFIG = Config()
FAST_CONFIG = Config(base_delay=0.1, multiplier=1.6, jitter=0.2, max_delay=5.0)


def backoff_delay(config: Config, retries: int, rng=None) -> float:
    """Delay in seconds before retry number `retries` (0-based), matching
    ref: expbackoff.go:145 Backoff — exponential growth capped at
    max_delay, then jittered by ±jitter."""
    delay = config.base_delay
    for _ in range(max(0, retries)):
        delay *= config.multiplier
        if delay >= config.max_delay:
            break
    delay = min(delay, config.max_delay)
    r = (rng or random).random()
    return max(0.0, delay * (1 + config.jitter * (2 * r - 1)))


class ExpBackoff:
    """Stateful awaitable backoff with full jitter and reset
    (ref: expbackoff.go:115 NewWithReset). The first `wait()` returns
    immediately; each later call sleeps one schedule step further."""

    def __init__(
        self,
        base: float = 0.25,
        factor: float = 2.0,
        max_delay: float = 30.0,
        jitter: bool = True,
    ) -> None:
        self.base = base
        self.factor = factor
        self.max_delay = max_delay
        self.jitter = jitter
        self._attempt = 0
        self._waited = False

    def next_delay(self) -> float:
        delay = min(self.max_delay, self.base * self.factor**self._attempt)
        self._attempt += 1
        return random.uniform(0, delay) if self.jitter else delay

    async def wait(self) -> None:
        # first call returns immediately WITHOUT consuming an attempt, so
        # the first real sleep is the base delay (not base*factor)
        if self._waited:
            await asyncio.sleep(self.next_delay())
        else:
            self._waited = True

    def reset(self) -> None:
        self._attempt = 0
        self._waited = False
