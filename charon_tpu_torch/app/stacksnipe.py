"""Stack sniping: detect co-located validator-stack processes.

Mirrors ref: app/stacksnipe/stacksnipe.go (wired app/app.go:155-156) —
periodically scans /proc for known Ethereum stack binaries running on the
same host and reports them as telemetry, giving operators visibility
into what shares the machine with the DV middleware.
"""

from __future__ import annotations

import asyncio
from pathlib import Path

# ref: stacksnipe.go binary allowlist (same stack components)
KNOWN_BINARIES = (
    "lighthouse",
    "prysm",
    "beacon-chain",
    "validator",
    "teku",
    "nimbus_beacon_node",
    "lodestar",
    "grandine",
    "geth",
    "nethermind",
    "besu",
    "erigon",
    "reth",
    "mev-boost",
    "charon",
)


def snipe(proc_root: str | Path = "/proc") -> dict[str, list[int]]:
    """One scan: binary name -> pids (ref: stacksnipe.go snipe)."""
    found: dict[str, list[int]] = {}
    root = Path(proc_root)
    try:
        entries = list(root.iterdir())
    except OSError:
        return found
    for entry in entries:
        if not entry.name.isdigit():
            continue
        try:
            cmdline = (entry / "cmdline").read_bytes()
        except OSError:
            continue
        if not cmdline:
            continue
        argv0 = cmdline.split(b"\x00", 1)[0].decode(errors="replace")
        base = argv0.rsplit("/", 1)[-1]
        for known in KNOWN_BINARIES:
            if base == known or base.startswith(known + "-"):
                found.setdefault(known, []).append(int(entry.name))
    return found


class StackSniper:
    """Periodic scanner feeding a metrics callback
    (ref: app/app.go wires stacksnipe with the promauto registry)."""

    def __init__(
        self,
        interval: float = 600.0,
        on_report=None,
        proc_root: str | Path = "/proc",
    ) -> None:
        self.interval = interval
        self.on_report = on_report
        self.proc_root = proc_root
        self.last: dict[str, list[int]] = {}
        self._task: asyncio.Task | None = None

    async def run(self) -> None:
        while True:
            self.last = snipe(self.proc_root)
            if self.on_report:
                self.on_report(self.last)
            await asyncio.sleep(self.interval)

    def start(self) -> None:
        self._task = asyncio.create_task(self.run())

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
