"""Progress-based waiting for simnet/e2e tests.

One shared watchdog instead of per-file copies: on a loaded 1-core CI
box the event loop can be starved for long stretches, so e2e waits must
demand fresh progress per window rather than raw speed across one fixed
wall-clock bound (the pattern proven by
tests/test_simnet.py::test_simnet_survives_fuzzed_beacon).
"""

from __future__ import annotations

import asyncio
import time

# every recorder list on BeaconMock that a full-duty e2e run fills
ALL_DUTY_RECORDERS = (
    "attestations",
    "proposals",
    "aggregates",
    "sync_messages",
    "contributions",
    "registrations",
    "exits",
)


async def wait_for_broadcasts(
    beacon,
    want: int = 4,
    recorders=ALL_DUTY_RECORDERS,
    first_window: float = 120.0,
    window: float = 60.0,
) -> None:
    """Wait until every named BeaconMock recorder holds >= `want`
    entries. The deadline extends whenever the outstanding count drops;
    a full window with zero fresh broadcasts raises TimeoutError."""

    def outstanding() -> int:
        return sum(
            max(0, want - len(getattr(beacon, name))) for name in recorders
        )

    deadline = time.monotonic() + first_window
    seen = outstanding()
    while outstanding() > 0:
        if outstanding() < seen:
            seen = outstanding()
            # progress only ever EXTENDS the allowance — early progress
            # inside the first window must not shrink what remains
            deadline = max(deadline, time.monotonic() + window)
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"no progress: {seen} broadcasts outstanding"
            )
        await asyncio.sleep(0.05)
