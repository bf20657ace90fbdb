"""Lifecycle manager: ordered async start/stop hooks.

Mirrors ref: app/lifecycle — hooks registered with explicit order labels,
started in order, stopped in reverse; app-context vs background tasks;
graceful then hard shutdown (lifecycle/manager.go:3-14, order.go).
"""

from __future__ import annotations

import asyncio
import enum
from dataclasses import dataclass, field
from typing import Awaitable, Callable


class Order(enum.IntEnum):
    """Start order (ref: app/lifecycle/order.go)."""

    TRACKER = 10
    P2P = 20
    MONITORING = 30
    VALIDATOR_API = 40
    DEADLINER = 50
    SCHEDULER = 60  # starts last: duties flow only once everything is up


@dataclass
class _Hook:
    order: int
    name: str
    fn: Callable
    background: bool  # background hooks run as tasks; sync hooks awaited


class LifecycleManager:
    def __init__(self) -> None:
        self._start_hooks: list[_Hook] = []
        self._stop_hooks: list[_Hook] = []
        self._tasks: list[asyncio.Task] = []
        self._stopped = asyncio.Event()

    def register_start(self, order: int, name: str, fn, background: bool = True) -> None:
        self._start_hooks.append(_Hook(order, name, fn, background))

    def register_stop(self, order: int, name: str, fn) -> None:
        self._stop_hooks.append(_Hook(order, name, fn, False))

    async def run(self, stop_signal: asyncio.Event | None = None) -> None:
        """Start hooks in order; block until stop; stop in reverse order
        (ref: lifecycle/manager.go:65-85)."""
        for hook in sorted(self._start_hooks, key=lambda h: h.order):
            if hook.background:
                task = asyncio.create_task(hook.fn(), name=hook.name)
                self._tasks.append(task)
            else:
                await hook.fn()
        stop = stop_signal or self._stopped
        await stop.wait()
        await self.shutdown()

    def stop(self) -> None:
        self._stopped.set()

    async def shutdown(self, grace: float = 5.0) -> None:
        for hook in sorted(self._stop_hooks, key=lambda h: -h.order):
            try:
                await asyncio.wait_for(hook.fn(), grace)
            except Exception:
                pass
        for task in self._tasks:
            task.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
