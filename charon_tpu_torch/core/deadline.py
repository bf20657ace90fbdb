"""Duty deadline engine: expiry-driven retry windows and store trimming.

Mirrors ref: core/deadline.go — duties expire lateFactor (5) slots after
their start (min 30s), after which stores trim them and the tracker runs
its failure analysis. asyncio redesign: one task per Deadliner draining a
heap instead of the reference's channel loop.
"""

from __future__ import annotations

import asyncio
import heapq
import time
from dataclasses import dataclass, field
from typing import Awaitable, Callable

from charon_tpu_torch.core.types import Duty

# Duties expire this many slots after their start (ref: core/deadline.go:23
# lateFactor = 5), with a minimum window (ref: core/deadline.go:26).
LATE_FACTOR = 5
MIN_WINDOW_SECS = 30.0


@dataclass(frozen=True)
class SlotClock:
    """Maps slots to wall-clock times (genesis + slot duration)."""

    genesis_time: float
    slot_duration: float

    def slot_start(self, slot: int) -> float:
        return self.genesis_time + slot * self.slot_duration

    def slot_at(self, t: float) -> int:
        return max(0, int((t - self.genesis_time) // self.slot_duration))

    def duty_deadline(self, duty: Duty) -> float:
        window = max(LATE_FACTOR * self.slot_duration, MIN_WINDOW_SECS)
        return self.slot_start(duty.slot) + window


class Deadliner:
    """Expires duties at their deadline (ref: core/deadline.go:28-43).

    add(duty) registers interest; expired duties are delivered to the
    callback exactly once. Duties already past deadline are dropped
    immediately (add returns False), matching the reference semantics.
    """

    def __init__(
        self,
        clock: SlotClock,
        on_expired: Callable[[Duty], Awaitable[None] | None],
        # wall clock by design: duty expiry tracks the slot timeline,
        # which IS wall-clock (genesis arithmetic) — an operator clock
        # step SHOULD move expiries with the chain's real schedule
        now: Callable[[], float] = time.time,  # lint: allow(monotonic-clock)
    ) -> None:
        self._clock = clock
        self._cb = on_expired
        self._now = now
        self._heap: list[tuple[float, Duty]] = []
        self._pending: set[Duty] = set()
        self._wake = asyncio.Event()
        self._task: asyncio.Task | None = None

    def add(self, duty: Duty) -> bool:
        deadline = self._clock.duty_deadline(duty)
        if deadline <= self._now():
            return False
        if duty in self._pending:
            return True
        self._pending.add(duty)
        heapq.heappush(self._heap, (deadline, duty))
        self._wake.set()
        return True

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._run(), name="deadliner")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _run(self) -> None:
        while True:
            self._wake.clear()
            if not self._heap:
                await self._wake.wait()
                continue
            deadline, duty = self._heap[0]
            delay = deadline - self._now()
            if delay > 0:
                try:
                    await asyncio.wait_for(self._wake.wait(), timeout=delay)
                    continue  # new earlier duty may have arrived
                except asyncio.TimeoutError:
                    pass
            heapq.heappop(self._heap)
            self._pending.discard(duty)
            res = self._cb(duty)
            if asyncio.iscoroutine(res):
                await res
