"""promrated: standalone telemetry sidecar publishing validator
effectiveness stats as prometheus gauges.

Mirrors ref: testutil/promrated/ — a small service (not part of the
node) that periodically queries a rated-API-compatible endpoint for
network- and operator-level effectiveness (uptime, correctness,
inclusion delay, validator/proposer/attester effectiveness), sets
labelled gauges, and serves them on a /metrics endpoint. Queries retry
with the shared exponential backoff (ref: promrated/rated.go uses
app/expbackoff exactly like this).

The HTTP fetch is pluggable (`fetcher`) so tests drive it against a
local mock; the default fetcher speaks plain HTTP/1.1 over asyncio
streams (this image has no egress — production deployments would sit
next to their rated API mirror).
"""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass, field
from urllib.parse import urlsplit

from prometheus_client import CollectorRegistry, Gauge, generate_latest

_LABELS = ["cluster_network", "node_operator"]

# gauge name -> (rated JSON key, help) — ref: promrated/metrics.go
_GAUGES = {
    "promrated_network_uptime": ("avgUptime", "Uptime of the network."),
    "promrated_network_correctness": (
        "avgCorrectness",
        "Average correctness of the network.",
    ),
    "promrated_network_inclusion_delay": (
        "avgInclusionDelay",
        "Average inclusion delay of the network.",
    ),
    "promrated_network_effectiveness": (
        "avgValidatorEffectiveness",
        "Effectiveness of the network.",
    ),
    "promrated_network_proposer_effectiveness": (
        "avgProposerEffectiveness",
        "Proposer effectiveness of the network.",
    ),
    "promrated_network_attester_effectiveness": (
        "avgAttesterEffectiveness",
        "Attester effectiveness of the network.",
    ),
}


@dataclass
class Config:
    rated_endpoint: str
    rated_auth: str = ""  # bearer token; never logged (redact_url)
    networks: tuple[str, ...] = ("mainnet",)
    node_operators: tuple[str, ...] = ()
    monitoring_host: str = "127.0.0.1"
    monitoring_port: int = 0  # 0 = ephemeral
    interval: float = 24 * 3600.0  # rated stats are daily (promrated.go)


def redact_url(url: str) -> str:
    """Strip userinfo/query secrets for logging
    (ref: promrated.go redactURL)."""
    parts = urlsplit(url)
    host = parts.hostname or ""
    if parts.port:
        host += f":{parts.port}"
    return f"{parts.scheme}://{host}{parts.path}"


def parse_effectiveness(body: bytes) -> dict[str, float]:
    """rated effectiveness JSON -> metric values. Accepts both the
    network-overview shape (a list of per-validator-class rows, the
    'all' row wins) and the operator shape ({"data": [row]})
    (ref: promrated/rated.go parseNetworkMetrics/parseNodeOperatorMetrics)."""
    doc = json.loads(body)
    if isinstance(doc, dict) and "data" in doc:
        rows = doc["data"]
    elif isinstance(doc, list):
        rows = [
            r
            for r in doc
            if r.get("validatorType") in (None, "all", "allValidators")
        ]
    else:
        rows = [doc]
    if not rows:
        raise ValueError("rated response contains no effectiveness rows")
    row = rows[0]
    out = {}
    for name, (key, _help) in _GAUGES.items():
        if key in row:
            out[name] = float(row[key])
    if not out:
        raise ValueError("rated response carries no known effectiveness keys")
    return out


async def _default_fetcher(url: str, headers: dict[str, str]) -> bytes:
    """Minimal HTTP/1.1 GET over asyncio streams."""
    parts = urlsplit(url)
    https = parts.scheme == "https"
    port = parts.port or (443 if https else 80)
    # ssl for https endpoints — the Authorization bearer token must
    # never leave the host in cleartext
    reader, writer = await asyncio.open_connection(
        parts.hostname, port, ssl=True if https else None
    )
    try:
        path = parts.path or "/"
        if parts.query:
            path += "?" + parts.query
        head = f"GET {path} HTTP/1.1\r\nHost: {parts.hostname}\r\n"
        for k, v in headers.items():
            head += f"{k}: {v}\r\n"
        head += "Connection: close\r\n\r\n"
        writer.write(head.encode())
        await writer.drain()
        status = await reader.readline()
        parts_s = status.split()
        if len(parts_s) < 2 or parts_s[1] != b"200":
            raise RuntimeError(f"rated API status: {status.decode().strip()}")
        while (await reader.readline()) not in (b"\r\n", b""):
            pass
        return await reader.read()
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except Exception:  # noqa: BLE001
            pass


class Promrated:
    """The service object: owns the registry, the /metrics endpoint and
    the periodic report loop (ref: promrated.go Run)."""

    def __init__(self, config: Config, fetcher=None) -> None:
        self.config = config
        self.fetcher = fetcher or _default_fetcher
        self.registry = CollectorRegistry()
        self.gauges = {
            name: Gauge(name, help_, _LABELS, registry=self.registry)
            for name, (_key, help_) in _GAUGES.items()
        }
        self.reports = 0
        self.report_errors = 0
        self._server: asyncio.AbstractServer | None = None
        self.port: int | None = None

    async def _fetch(self, path: str, network: str) -> dict[str, float]:
        from charon_tpu_torch.app import expbackoff as eb

        headers = {"X-Rated-Network": network}
        if self.config.rated_auth:
            headers["Authorization"] = f"Bearer {self.config.rated_auth}"
        url = self.config.rated_endpoint.rstrip("/") + path
        last: Exception | None = None
        for retries in range(5):
            try:
                return parse_effectiveness(await self.fetcher(url, headers))
            except Exception as e:  # noqa: BLE001 — retried with backoff
                last = e
                await asyncio.sleep(
                    eb.backoff_delay(eb.FAST_CONFIG, retries)
                )
        raise RuntimeError(f"rated API failed after retries: {last}")

    async def report_once(self) -> None:
        """One reporting pass over all networks/operators; individual
        failures count but do not abort the pass."""
        from charon_tpu_torch.app import log

        for network in self.config.networks:
            targets = [("/v0/eth/network/overview", "network")] + [
                (f"/v0/eth/operators/{op}/effectiveness?size=1", op)
                for op in self.config.node_operators
            ]
            for path, operator in targets:
                try:
                    values = await self._fetch(path, network)
                except Exception as e:  # noqa: BLE001
                    self.report_errors += 1
                    log.warn(
                        "promrated query failed",
                        topic="promrated",
                        url=redact_url(
                            self.config.rated_endpoint.rstrip("/") + path
                        ),
                        err=str(e)[:160],
                    )
                    continue
                for name, value in values.items():
                    self.gauges[name].labels(network, operator).set(value)
        self.reports += 1

    async def start_monitoring(self) -> int:
        """Serve /metrics; returns the bound port."""

        async def handle(reader, writer):
            try:
                request = await reader.readline()
                while (await reader.readline()) not in (b"\r\n", b""):
                    pass
                path = (
                    request.split()[1].decode() if request.split() else "/"
                )
                if path.startswith("/metrics"):
                    body, status = generate_latest(self.registry), b"200 OK"
                else:
                    body, status = b"not found\n", b"404 Not Found"
                writer.write(
                    b"HTTP/1.1 %s\r\nContent-Length: %d\r\n"
                    b"Content-Type: text/plain; version=0.0.4\r\n\r\n"
                    % (status, len(body))
                )
                writer.write(body)
                await writer.drain()
            finally:
                writer.close()

        self._server = await asyncio.start_server(
            handle, self.config.monitoring_host, self.config.monitoring_port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def run(self, stop: asyncio.Event) -> None:
        """Report on startup then every interval until `stop` is set
        (ref: promrated.go Run's onStartup + daily ticker)."""
        await self.start_monitoring()
        while not stop.is_set():
            await self.report_once()
            try:
                await asyncio.wait_for(
                    stop.wait(), timeout=self.config.interval
                )
            except asyncio.TimeoutError:
                continue
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
