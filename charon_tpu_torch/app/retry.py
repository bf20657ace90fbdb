"""Deadline-bounded async retry of workflow steps.

Mirrors ref: app/retry/retry.go:28-120 — each duty step is retried with a
constant 1s backoff until the duty's deadline, with error classification
(network-ish errors retried, programming errors surfaced immediately).
Wired into the workflow as a wire() option (ref: core.WithAsyncRetry,
app/app.go:571).
"""

from __future__ import annotations

import asyncio
import time
from typing import Awaitable, Callable

BACKOFF_SECS = 1.0  # ref: retry/retry.go constant backoff


def retryable_errors() -> tuple:
    # lazy: avoid a hard import edge at module load; AllClientsFailedError
    # (every configured BN failed) is the framework's own transient
    # network failure and MUST be retried (ref: retry.go classifies
    # net/url errors as temporary)
    from charon_tpu_torch.app.eth2wrap import AllClientsFailedError

    return (
        ConnectionError,
        TimeoutError,
        asyncio.TimeoutError,
        OSError,
        AllClientsFailedError,
    )


_retryable = retryable_errors  # historical internal name

RETRYABLE = (ConnectionError, TimeoutError, asyncio.TimeoutError, OSError)


class Retryer:
    """deadline_of: maps a duty to its absolute wall-clock deadline
    (SlotClock). `now` (default: live `time.time`) is the wall clock
    the deadlines live on; `mono` is the clock the retry loop actually
    runs against. With the defaults the wall deadline is anchored to
    `time.monotonic()` ONCE per retry() call, so a host clock step
    mid-retry (NTP correction, chaos SkewedClock) can neither abort
    the remaining window nor stretch it past the duty deadline — the
    `_arm` bug class. Tests that inject a fake `now` drive a single
    steppable timeline and get `mono = now` automatically (one clock
    has no skew to misconvert)."""

    def __init__(
        self,
        deadline_of,
        now=None,
        backoff: float = BACKOFF_SECS,
        mono=None,
    ) -> None:
        self.deadline_of = deadline_of
        self.now = now
        self.backoff = backoff
        self.mono = mono
        self._tasks: set[asyncio.Task] = set()

    def _clocks(self):
        """(wall, mono) pair the loop runs on. Live `time.time` is read
        through the module attribute so clock-skew injection sees it."""
        if self.now is None:
            return (lambda: time.time()), (  # lint: allow(monotonic-clock) — wall INPUT timeline; loop runs on mono
                self.mono if self.mono is not None else time.monotonic
            )
        # injected wall clock IS the test's single timeline
        return self.now, (self.mono if self.mono is not None else self.now)

    async def retry(self, name: str, duty, fn, *args) -> None:
        """Deadline-bounded, not attempt-bounded: each attempt runs
        under wait_for(remaining) so a HUNG call cannot overshoot the
        duty deadline either — the timeout classifies as transient and
        the loop then stops at the deadline check. Cancellation (duty
        torn down / process stopping) propagates immediately: it is a
        BaseException and never swallowed as a retry."""
        now, mono = self._clocks()
        # wall deadline -> monotonic base, snapshotted once
        deadline = self.deadline_of(duty) - now() + mono()
        attempt = 0
        while True:
            attempt += 1
            remaining = deadline - mono()
            if remaining <= 0:
                return  # deadline exceeded; tracker reports the miss
            try:
                await asyncio.wait_for(fn(duty, *args), timeout=remaining)
                return
            except retryable_errors():
                if mono() + self.backoff >= deadline:
                    return  # deadline exceeded; tracker reports the miss
                await asyncio.sleep(self.backoff)
            except Exception:
                raise  # non-retryable: surface immediately

    def spawn(self, name: str, duty, fn, *args) -> None:
        """DoAsync (ref: retry.go:93): fire-and-forget with retries."""
        task = asyncio.create_task(self.retry(name, duty, fn, *args))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)


def with_async_retry(retryer: Retryer, edges: set[str] | None = None):
    """wire() option: wrap edges in deadline-bounded async retries."""
    edges = edges or {"fetcher.fetch"}

    def option(name: str, fn):
        if name not in edges:
            return fn

        async def wrapped(duty, *args, **kwargs):
            retryer.spawn(name, duty, fn, *args)

        return wrapped

    return option
