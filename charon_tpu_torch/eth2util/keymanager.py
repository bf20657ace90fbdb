"""Keymanager API client: push validator key shares into a VC.

Mirrors ref: eth2util/keymanager/keymanager.go — POST
/eth/v1/keystores with EIP-2335 keystores + passwords, so a DKG can
deliver each node's share keys directly to its validator client
(wired from dkg, ref: dkg/dkg.go:118-128).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import aiohttp


@dataclass
class KeymanagerClient:
    base_url: str  # e.g. http://localhost:7500
    # bearer token (keymanager API standard auth); repr=False keeps it
    # out of tracebacks/log formatting of the client object
    auth_token: str = field(default="", repr=False)
    timeout: float = 10.0

    async def import_keystores(
        self, keystores: list[dict], passwords: list[str]
    ) -> list[dict]:
        """Import EIP-2335 keystores. Returns per-key statuses
        (ref: keymanager.go ImportKeystores)."""
        if len(keystores) != len(passwords):
            raise ValueError("keystore/password count mismatch")
        body = {
            "keystores": [json.dumps(k) for k in keystores],
            "passwords": list(passwords),
        }
        headers = {"Content-Type": "application/json"}
        if self.auth_token:
            # the Authorization header IS the token's destination
            headers["Authorization"] = f"Bearer {self.auth_token}"  # lint: allow(secret-flow)
        async with aiohttp.ClientSession(
            timeout=aiohttp.ClientTimeout(total=self.timeout)
        ) as session:
            async with session.post(
                self.base_url.rstrip("/") + "/eth/v1/keystores",
                json=body,
                headers=headers,
            ) as resp:
                if resp.status != 200:
                    raise RuntimeError(
                        f"keymanager import failed: HTTP {resp.status} "
                        f"{await resp.text()}"
                    )
                data = await resp.json()
        statuses = data.get("data", [])
        for st in statuses:
            if st.get("status") not in ("imported", "duplicate"):
                raise RuntimeError(f"keystore import rejected: {st}")
        return statuses
