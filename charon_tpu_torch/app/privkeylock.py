"""Staleness-based private-key file lock.

Mirrors ref: app/privkeylock — prevents two nodes from running with the
same key share material (a double-signing hazard): a lock file holding pid
+ timestamp, refreshed periodically; a second process refuses to start
while the lock is fresh (ref wiring: app/app.go:145-153).
"""

from __future__ import annotations

import asyncio
import json
import os
import time
from pathlib import Path

STALENESS_SECS = 5.0
REFRESH_SECS = 1.0


class PrivKeyLockError(Exception):
    pass


class PrivKeyLock:
    def __init__(self, path: str | Path, command: str = "run") -> None:
        self.path = Path(path)
        self.command = command
        self._task: asyncio.Task | None = None

    def acquire(self) -> None:
        if self.path.exists():
            try:
                data = json.loads(self.path.read_text())
                age = time.time() - data.get("timestamp", 0)
                if age < STALENESS_SECS:
                    raise PrivKeyLockError(
                        f"private key locked by pid {data.get('pid')} "
                        f"(command {data.get('command')!r}, {age:.1f}s ago); "
                        "another node is using these keys"
                    )
            except (json.JSONDecodeError, OSError):
                pass  # stale/corrupt lock: take it over
        self._write()

    def _write(self) -> None:
        self.path.write_text(
            json.dumps(
                {
                    "pid": os.getpid(),
                    "command": self.command,
                    "timestamp": time.time(),
                }
            )
        )

    def start_refresh(self) -> None:
        async def loop():
            while True:
                await asyncio.sleep(REFRESH_SECS)
                self._write()

        self._task = asyncio.create_task(loop())

    async def release(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        try:
            self.path.unlink()
        except OSError:
            pass
