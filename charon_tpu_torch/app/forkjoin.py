"""Bounded fork/join fan-out (ref: app/forkjoin/forkjoin.go:3-19 — the
reference's generic worker-pool util, 8 workers by default, used for
parallel beacon-node queries).

asyncio redesign: a semaphore-bounded gather that preserves input order
and separates successes from failures instead of the reference's
channel-of-results."""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Any, Awaitable, Callable, Sequence

DEFAULT_WORKERS = 8


@dataclass
class Result:
    """One input's outcome: exactly one of `output` / `error` is set."""

    input: Any
    output: Any = None
    error: BaseException | None = None

    @property
    def ok(self) -> bool:
        return self.error is None


async def forkjoin(
    inputs: Sequence[Any],
    fn: Callable[[Any], Awaitable[Any]],
    workers: int = DEFAULT_WORKERS,
) -> list[Result]:
    """Apply `fn` to every input with at most `workers` concurrent calls;
    results come back in input order, failures captured per-input."""
    sem = asyncio.Semaphore(workers)

    async def one(x):
        async with sem:
            try:
                return Result(input=x, output=await fn(x))
            except asyncio.CancelledError:
                raise
            except BaseException as e:  # noqa: BLE001 — captured per input
                return Result(input=x, error=e)

    return list(await asyncio.gather(*(one(x) for x in inputs)))


def flatten(results: list[Result]) -> list[Any]:
    """Outputs of successful results; raises the FIRST failure if any
    (ref: forkjoin.Join's flatten helper semantics)."""
    for r in results:
        if not r.ok:
            raise r.error
    return [r.output for r in results]
