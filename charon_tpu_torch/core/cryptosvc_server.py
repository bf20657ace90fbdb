"""Socket server exposing `CryptoPlaneService` to remote tenants.

The networked half of ROADMAP item 2's "crypto plane as a service": N
physically separate DV clusters dial ONE shared device mesh. The server
is a thin, failure-first adapter — every policy decision (EDF fairness,
admission, breaker quarantine) stays in `core/cryptosvc`; this module
only moves frames:

  * **accept** — send a fresh `CryptoChallenge` nonce, require a
    `CryptoHello` whose HMAC proof matches the tenant's configured
    token (`cryptosvc_wire.proof_ok`, constant-time). Auth failures get
    a generic ack and a closed socket: the error string never says
    whether the tenant id or the proof was wrong, and the token itself
    never appears anywhere — not on the wire, not in logs, not in
    metrics labels (secret-flow lint enforces this).
  * **submit** — `CryptoSubmit` maps onto `svc.submit(...)` with the
    relative deadline rebased onto this host's wall clock.
    `PlaneOverloadError` becomes a typed `CryptoShed` frame;
    `TblsError` rides back as a "tbls" result (a crypto VERDICT the
    client must not retry locally); any other exception as an "error"
    result (infrastructure — the client's local ladder takes over).
  * **attribution** — the server chains onto the shared coalescer's
    `stats_hook` and forwards each tenant's slice of every
    `FlushStats` as a compact dict on that tenant's next result frame
    (stage spans as offsets-back-from-send, so client-side rebasing
    needs no cross-host clock agreement).
  * **malformed frames** — per-frame drop-and-count through
    `p2p/quarantine.PeerQuarantine` (clients are NOT exempt here: a
    tenant streaming garbage gets its connection closed once muted).

The module is deliberately free of `jax` and `cryptography` imports so
a CPU-only image can serve (SimPlane-backed) and the chaos tier can
drive it everywhere.
"""

from __future__ import annotations

import asyncio
import os
import threading
import time

from charon_tpu_torch.core.cryptosvc import PlaneOverloadError
from charon_tpu_torch.core.cryptosvc_wire import (
    HELLO_TIMEOUT,
    WIRE_VERSION,
    CryptoChallenge,
    CryptoHeartbeat,
    CryptoHello,
    CryptoHelloAck,
    CryptoResult,
    CryptoShed,
    CryptoSubmit,
    read_frame,
    send_frame,
)
from charon_tpu_torch.p2p.codec import CodecError
from charon_tpu_torch.p2p.quarantine import PeerQuarantine
from charon_tpu_torch.tbls import TblsError

# pending per-tenant stats briefs are bounded: a tenant that stops
# submitting must not accumulate attribution dicts forever
_MAX_PENDING_STATS = 8


def _flush_brief(stats, now: float) -> dict:
    """Compact cross-process projection of one FlushStats: counters
    verbatim, stage spans as [start_back, end_back] offsets from `now`
    (the server's send instant) — the client rebases onto its own wall
    clock, so skewed hosts still get truthful span DURATIONS."""

    def rel(span):
        if not span:
            return None
        return [now - span[0], now - span[1]]

    return {
        "jobs": stats.jobs,
        "lanes": stats.lanes,
        "flush_seconds": stats.flush_seconds,
        "window": stats.window,
        "inflight": stats.inflight,
        "fallback": stats.fallback,
        "decode_mode": stats.decode_mode,
        "pack_rel": rel(stats.pack_span),
        "device_rel": rel(stats.device_span),
    }


class CryptoServiceServer:
    """Serves one `CryptoPlaneService` on a TCP port.

    auth_tokens: {tenant_id: token str|bytes}. Tenants must already be
    registered on the service (or pass `register_tenants=True` to have
    the server register them with default quotas on start).
    """

    def __init__(
        self,
        svc,
        auth_tokens: dict,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        heartbeat: float = 1.0,
        hello_timeout: float = HELLO_TIMEOUT,
        observer=None,  # callable(kind, tenant, **fields)
        quarantine: PeerQuarantine | None = None,
        register_tenants: bool = False,
    ) -> None:
        self._svc = svc
        self._auth_tokens = {
            tid: tok.encode() if isinstance(tok, str) else bytes(tok)
            for tid, tok in auth_tokens.items()
        }
        self.host = host
        self.port = port
        self.heartbeat = heartbeat
        self._hello_timeout = hello_timeout
        self.observer = observer
        self.quarantine = quarantine or PeerQuarantine()
        self._register_tenants = register_tenants
        self._server: asyncio.base_events.Server | None = None
        self._conn_tasks: set[asyncio.Task] = set()
        self._writers: set[asyncio.StreamWriter] = set()
        # tenant -> pending stats briefs; appended from the coalescer's
        # device worker THREAD, drained on the event loop — lock, not loop
        self._pending_stats: dict[str, list[dict]] = {}
        self._stats_mu = threading.Lock()
        self._stats_hook_installed = False
        self.served_jobs = 0
        self.auth_failures = 0

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        if self._register_tenants:
            for tid in self._auth_tokens:
                if tid not in getattr(self._svc, "_tenants", {}):
                    self._svc.register(tid)
        self._install_stats_hook()
        self._server = await asyncio.start_server(
            self._accept, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]

    async def close(self) -> None:
        """Graceful stop: close the listener and every connection."""
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        for w in list(self._writers):
            w.close()
        for t in list(self._conn_tasks):
            t.cancel()
        await asyncio.gather(*self._conn_tasks, return_exceptions=True)

    def abort(self) -> None:
        """SIGKILL stand-in for chaos scenarios: drop every connection
        transport without goodbye frames and stop accepting."""
        if self._server is not None:
            self._server.close()
            self._server = None
        for w in list(self._writers):
            transport = w.transport
            if transport is not None:
                transport.abort()
        for t in list(self._conn_tasks):
            t.cancel()

    # -- stats attribution -------------------------------------------------

    def _install_stats_hook(self) -> None:
        coal = getattr(self._svc, "coalescer", None)
        if coal is None or self._stats_hook_installed:
            return
        inner = getattr(coal, "stats_hook", None)

        def hook(stats, _inner=inner):
            self._on_flush_stats(stats)
            if _inner is not None:
                _inner(stats)

        coal.stats_hook = hook
        self._stats_hook_installed = True

    def _on_flush_stats(self, stats) -> None:
        """Runs on the coalescer's device worker thread."""
        tenant_lanes = getattr(stats, "tenant_lanes", ()) or ()
        if not tenant_lanes:
            return
        now = time.time()  # lint: allow(monotonic-clock) — attribution spans are wall-timestamped
        brief = _flush_brief(stats, now)
        with self._stats_mu:
            for tenant, lanes in tenant_lanes:
                per = dict(brief)
                per["tenant_lanes"] = lanes
                per["_captured"] = now
                q = self._pending_stats.setdefault(tenant, [])
                q.append(per)
                del q[:-_MAX_PENDING_STATS]

    def _pop_stats(self, tenant: str) -> dict | None:
        with self._stats_mu:
            q = self._pending_stats.get(tenant)
            if not q:
                return None
            brief = q.pop(0)
        # the span offsets were taken at capture; age them to THIS send
        age = time.time() - brief.pop("_captured", time.time())  # lint: allow(monotonic-clock)
        if age > 0:
            for key in ("pack_rel", "device_rel"):
                if brief.get(key):
                    brief[key] = [x + age for x in brief[key]]
        return brief

    def _observe(self, kind: str, tenant: str, **fields) -> None:
        if self.observer is not None:
            try:
                self.observer(kind, tenant, **fields)
            except Exception:  # noqa: BLE001 — observer bugs stay out
                pass

    # -- connection handling ----------------------------------------------

    async def _accept(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        task = asyncio.current_task()
        if task is not None:
            self._conn_tasks.add(task)
            task.add_done_callback(self._conn_tasks.discard)
        self._writers.add(writer)
        try:
            await self._serve_conn(reader, writer)
        except (
            ConnectionError,
            asyncio.IncompleteReadError,
            asyncio.TimeoutError,
            CodecError,
            OSError,
        ):
            pass  # per-connection faults never take the server down
        finally:
            self._writers.discard(writer)
            writer.close()

    async def _serve_conn(self, reader, writer) -> None:
        peername = writer.get_extra_info("peername") or ("?", 0)
        peer = f"{peername[0]}:{peername[1]}"
        # nonce is public by construction (the proof is what's secret)
        nonce = os.urandom(32)
        send_frame(writer, CryptoChallenge(nonce, WIRE_VERSION), False)
        await writer.drain()
        hello = await asyncio.wait_for(
            read_frame(reader), self._hello_timeout
        )
        if not isinstance(hello, CryptoHello):
            raise CodecError("expected CryptoHello")
        from charon_tpu_torch.core.cryptosvc_wire import proof_ok

        auth_token = self._auth_tokens.get(hello.tenant_id)
        if auth_token is None or not proof_ok(
            auth_token, nonce, hello.proof
        ):
            # deliberately generic: no unknown-tenant vs bad-proof oracle
            self.auth_failures += 1
            self._observe("auth_fail", hello.tenant_id)
            send_frame(
                writer,
                CryptoHelloAck(ok=False, error="authentication failed"),
                False,
            )
            await writer.drain()
            return
        tenant_id = hello.tenant_id
        wire = min(WIRE_VERSION, hello.wire)
        binary = wire >= 1
        send_frame(
            writer,
            CryptoHelloAck(
                ok=True,
                wire=wire,
                t=self._svc.t,
                heartbeat=self.heartbeat,
            ),
            False,
        )
        await writer.drain()
        self._observe("connect", tenant_id, wire=wire)
        job_tasks: set[asyncio.Task] = set()
        try:
            while True:
                try:
                    msg = await read_frame(reader)
                except CodecError:
                    # malformed payload inside an intact length-prefixed
                    # frame: drop-and-count, mute streams of garbage
                    self.quarantine.strike(peer)
                    if self.quarantine.muted(peer):
                        self._observe("quarantine", tenant_id)
                        return
                    continue
                self.quarantine.forgive(peer)
                if isinstance(msg, CryptoHeartbeat):
                    send_frame(
                        writer,
                        CryptoHeartbeat(msg.seq, echo=True),
                        binary,
                    )
                    await writer.drain()
                elif isinstance(msg, CryptoSubmit):
                    t = asyncio.create_task(
                        self._run_job(writer, tenant_id, msg, binary)
                    )
                    job_tasks.add(t)
                    t.add_done_callback(job_tasks.discard)
                # unknown-but-valid frames: ignore (forward compat)
        finally:
            for t in job_tasks:
                t.cancel()
            self._observe("disconnect", tenant_id)

    async def _run_job(
        self, writer, tenant_id: str, msg: CryptoSubmit, binary: bool
    ) -> None:
        deadline = (
            None
            if msg.deadline_rel is None
            # svc.submit deadlines are wall-clock by plane contract;
            # rebasing the relative remainder here needs no cross-host
            # clock agreement
            else time.time() + msg.deadline_rel  # lint: allow(monotonic-clock)
        )
        try:
            try:
                value = await self._svc.submit(
                    tenant_id, msg.kind, tuple(msg.args), msg.lanes,
                    deadline,
                )
            except PlaneOverloadError as e:
                self._observe(
                    "shed", tenant_id, reason=e.reason, lanes=msg.lanes
                )
                send_frame(
                    writer, CryptoShed(msg.job_id, e.reason), binary
                )
            except TblsError as e:
                send_frame(
                    writer,
                    CryptoResult(
                        msg.job_id,
                        error=str(e)[:200],
                        error_kind="tbls",
                    ),
                    binary,
                )
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — surfaced to client
                send_frame(
                    writer,
                    CryptoResult(
                        msg.job_id,
                        error=f"{type(e).__name__}: {str(e)[:200]}",
                        error_kind="error",
                    ),
                    binary,
                )
            else:
                self.served_jobs += 1
                send_frame(
                    writer,
                    CryptoResult(
                        msg.job_id,
                        value=value,
                        stats=self._pop_stats(tenant_id),
                    ),
                    binary,
                )
            await writer.drain()
        except (ConnectionError, OSError):
            pass  # client went away; its local ladder owns the job now
