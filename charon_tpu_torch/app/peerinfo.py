"""Peer metadata exchange: version, start time, clock offset.

Mirrors ref: app/peerinfo — periodic exchange of node metadata over the
p2p mesh (version + git hash + start time + builder-api flag + clock
offset, ref app/app.go:299-304; metrics docs/metrics.md app_peerinfo_*).
Clock offset feeds the monitoring readiness checks.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field

from charon_tpu_torch.app import log
from charon_tpu_torch.app import version as version_mod

PROTOCOL = "peerinfo/1.0.0"


@dataclass
class PeerInfo:
    version: str
    start_time: float
    clock_offset: float = 0.0  # peer_time - our_time at receipt
    last_seen: float = 0.0
    compatible: bool = True  # version window check (ref: app/version)


class PeerInfoService:
    def __init__(self, node, version: str) -> None:
        self.node = node
        self.version = version
        self.start_time = time.time()
        self.peers: dict[int, PeerInfo] = {}
        self._task: asyncio.Task | None = None
        node.register_handler(PROTOCOL, self._handle)

    def _record(self, idx: int, msg, now: float) -> None:
        peer_version = msg.get("version", "?")
        compatible = version_mod.check_compatible(peer_version)
        prev = self.peers.get(idx)
        if not compatible and (prev is None or prev.compatible):
            # surface the mismatch once per transition
            # (ref: version.Supported gating in peerinfo)
            log.warn(
                "peer runs an unsupported version",
                topic="peerinfo",
                peer=idx,
                peer_version=peer_version,
                ours=self.version,
            )
        self.peers[idx] = PeerInfo(
            version=peer_version,
            start_time=msg.get("start_time", 0.0),
            clock_offset=msg.get("now", now) - now,
            last_seen=now,
            compatible=compatible,
        )

    def incompatible_peers(self) -> list[int]:
        return [i for i, p in self.peers.items() if not p.compatible]

    async def _handle(self, from_idx: int, msg):
        now = time.time()
        if msg is not None:
            self._record(from_idx, msg, now)
        return {
            "version": self.version,
            "start_time": self.start_time,
            "now": time.time(),
        }

    async def poll_once(self) -> None:
        for idx in self.node.peers:
            try:
                resp = await self.node.send(
                    idx,
                    PROTOCOL,
                    {
                        "version": self.version,
                        "start_time": self.start_time,
                        "now": time.time(),
                    },
                    await_response=True,
                )
                self._record(idx, resp, time.time())
            except Exception:
                pass

    def start(self, interval: float = 10.0) -> None:
        async def loop():
            while True:
                await self.poll_once()
                await asyncio.sleep(interval)

        self._task = asyncio.create_task(loop())

    def stop(self) -> None:
        if self._task:
            self._task.cancel()
