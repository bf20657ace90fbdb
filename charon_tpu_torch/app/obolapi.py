"""Obol-API-style remote registry client.

Mirrors ref: app/obolapi/api.go — the reference can publish the cluster
lock after a DKG and upload partial exit shares to a remote coordination
API. The HTTP surface here is a minimal JSON REST client with the same
two capabilities; the testutil.obolapimock server implements the
matching endpoints for tests (ref: testutil/obolapimock).
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import aiohttp


@dataclass
class ObolApiClient:
    base_url: str
    timeout: float = 10.0

    async def _post(self, path: str, body: dict) -> dict:
        async with aiohttp.ClientSession(
            timeout=aiohttp.ClientTimeout(total=self.timeout)
        ) as session:
            async with session.post(
                self.base_url.rstrip("/") + path, json=body
            ) as resp:
                if resp.status not in (200, 201):
                    raise RuntimeError(
                        f"obolapi {path} failed: HTTP {resp.status} "
                        f"{await resp.text()}"
                    )
                if resp.content_type == "application/json":
                    return await resp.json()
                return {}

    async def publish_lock(self, lock) -> dict:
        """Publish a cluster lock after the ceremony
        (ref: api.go PublishLock, wired dkg/dkg.go:118-128)."""
        return await self._post("/lock", lock.to_json())

    async def submit_partial_exit(
        self,
        lock_hash: bytes,
        share_idx: int,
        validator_pubkey: str,
        epoch: int,
        partial_signature: bytes,
    ) -> dict:
        """Upload one node's partial exit share
        (ref: api.go PostPartialExit, cmd/exit_sign.go)."""
        return await self._post(
            f"/exp/partial_exits/{lock_hash.hex()}",
            {
                "share_idx": share_idx,
                "validator_pubkey": validator_pubkey,
                "epoch": epoch,
                "partial_signature": partial_signature.hex(),
            },
        )

    async def fetch_full_exit(
        self, lock_hash: bytes, validator_pubkey: str
    ) -> dict | None:
        """Fetch the aggregated exit once threshold shares are uploaded
        (ref: api.go GetFullExit, cmd/exit_fetch.go)."""
        async with aiohttp.ClientSession(
            timeout=aiohttp.ClientTimeout(total=self.timeout)
        ) as session:
            async with session.get(
                self.base_url.rstrip("/")
                + f"/exp/exit/{lock_hash.hex()}/{validator_pubkey}"
            ) as resp:
                if resp.status == 404:
                    return None
                if resp.status != 200:
                    raise RuntimeError(
                        f"obolapi exit fetch failed: HTTP {resp.status}"
                    )
                return await resp.json()
