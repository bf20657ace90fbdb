"""In-process mock of the remote registry API (ref: testutil/obolapimock):
stores published locks and partial exit shares, aggregates exits at
threshold using tbls — the server side of app/obolapi.ObolApiClient.
"""

from __future__ import annotations

import json

from aiohttp import web

from charon_tpu_torch import tbls


class ObolApiMock:
    def __init__(self, threshold: int) -> None:
        self.threshold = threshold
        self.locks: list[dict] = []
        # (lock_hash_hex, pubkey) -> {share_idx: sig}
        self.partials: dict[tuple[str, str], dict[int, bytes]] = {}
        self.exits: dict[tuple[str, str], dict] = {}
        self._runner: web.AppRunner | None = None
        self.port = 0

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        app = web.Application()
        app.router.add_post("/lock", self._post_lock)
        app.router.add_post(
            "/exp/partial_exits/{lock_hash}", self._post_partial
        )
        app.router.add_get(
            "/exp/exit/{lock_hash}/{pubkey}", self._get_exit
        )
        self._runner = web.AppRunner(app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, host, port)
        await site.start()
        self.port = site._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self) -> None:
        if self._runner:
            await self._runner.cleanup()

    async def _post_lock(self, request: web.Request) -> web.Response:
        self.locks.append(await request.json())
        return web.json_response({"status": "published"}, status=201)

    async def _post_partial(self, request: web.Request) -> web.Response:
        body = await request.json()
        key = (request.match_info["lock_hash"], body["validator_pubkey"])
        shares = self.partials.setdefault(key, {})
        shares[int(body["share_idx"])] = bytes.fromhex(
            body["partial_signature"]
        )
        if len(shares) >= self.threshold and key not in self.exits:
            subset = dict(sorted(shares.items())[: self.threshold])
            sig = tbls.threshold_aggregate(subset)
            self.exits[key] = {
                "epoch": body["epoch"],
                "signature": "0x" + sig.hex(),
            }
        return web.json_response({"received": len(shares)})

    async def _get_exit(self, request: web.Request) -> web.Response:
        key = (
            request.match_info["lock_hash"],
            request.match_info["pubkey"],
        )
        if key not in self.exits:
            return web.json_response({"error": "not found"}, status=404)
        return web.json_response(self.exits[key])
