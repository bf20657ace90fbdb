"""Remote crypto-plane client: a TenantPlane rung ABOVE the local one.

`RemotePlane` is a `TenantPlane` duck type (`t` / `verify` /
`recombine`) that SigAgg / Eth2Verifier / ValidatorAPI wire unchanged.
It dials a `cryptosvc_server` and treats the remote plane as the
PREFERRED rung of the existing degradation ladder — never as a
dependency. The failure contract, in one sentence: on ANY remote
failure the affected jobs run on the local rung (`local` — the node's
own SlotCoalescer / TenantPlane, which itself sits on the tbls ladder)
and duties keep completing.

Failure taxonomy -> behavior:

  * connect refused / handshake failure ... jobs go local immediately
    ("down" state); a supervisor task reconnects on the expbackoff
    schedule (`app/expbackoff.backoff_delay`).
  * heartbeat miss .......................... connection torn down, every
    in-flight job fails over local. Miss detection is pinned to
    `time.monotonic` (injectable `clock`) — a wall-clock step (NTP,
    `testutil/chaos.SkewedClock`) must never fabricate or mask a miss
    (the wall/monotonic bug class, kept out of this timer surface).
  * mid-flush socket death .................. ditto: the reader fails,
    pending futures get the failure, each waiter degrades locally.
  * malformed / corrupt result frame ........ quarantine strike (the
    configured server address is EXEMPT from mute escalation —
    p2p/quarantine — because a flapping server should cost reconnect
    backoff, not a 300 s mute) and the connection is torn down: after
    payload corruption the stream can't be trusted.
  * server shed (CryptoShed) ................ the job degrades locally;
    the shed is counted per reason.
  * "tbls" error result ..................... NOT a failure: a crypto
    verdict is identical on every rung, so it re-raises as TblsError
    without local retry (same rule as tbls/resilient.ResilientImpl).
  * local in-flight window overflow ......... typed shed: raises
    `PlaneOverloadError` exactly like the in-process service, so the
    submitters' existing catch-sites degrade to their host tbls rung.

Reconnection half-opens the remote rung: exactly ONE in-flight probe
job is allowed through; concurrent jobs stay local until the probe
gets a typed response (result OR shed — either proves the submit path
end to end). A transport failure during the probe drops straight back
to "down".

Cross-process FlushStats attribution: result frames carry the server's
compact stats brief; the client rebases the stage spans onto its own
wall clock, re-roots them on the submitting duty's trace context, and
feeds a synthesized `FlushStats` to `stats_hook` (normally
`app/tracer.plane_span_bridge`), so remote flushes appear in duty
traces exactly like local ones.

Deadlines propagate RELATIVE (seconds remaining at send) and also
bound the client-side wait: a result that can't arrive before the duty
deadline fails over local while the duty is still winnable.
"""

from __future__ import annotations

import asyncio
import random
import time

from charon_tpu_torch.app.expbackoff import Config, backoff_delay
from charon_tpu_torch.core.cryptoplane import FlushStats
from charon_tpu_torch.core.cryptosvc import PlaneOverloadError
from charon_tpu_torch.core.cryptosvc_wire import (
    WIRE_VERSION,
    CryptoChallenge,
    CryptoHeartbeat,
    CryptoHello,
    CryptoHelloAck,
    CryptoResult,
    CryptoShed,
    CryptoSubmit,
    auth_proof,
    read_frame,
    send_frame,
)
from charon_tpu_torch.p2p.codec import CodecError
from charon_tpu_torch.p2p.quarantine import PeerQuarantine
from charon_tpu_torch.tbls import TblsError

# fast reconnect schedule: a crypto-service blip must resolve within a
# slot, not within the p2p default's two-minute cap
RECONNECT_CONFIG = Config(
    base_delay=0.05, multiplier=1.6, jitter=0.2, max_delay=2.0
)


class _RemoteFailure(Exception):
    """Internal: one job's remote attempt failed for `reason` — the
    caller degrades it to the local rung. Never escapes RemotePlane."""

    def __init__(self, reason: str):
        self.reason = reason
        super().__init__(reason)


class _Job:
    __slots__ = ("fut", "lanes", "parent")

    def __init__(self, fut, lanes: int, parent):
        self.fut = fut
        self.lanes = lanes
        self.parent = parent  # (trace_id, span_id) | None at submit


class RemotePlane:
    """TenantPlane duck type over a remote crypto-plane service, with
    the local plane as the always-available rung below.

    local: the fallback plane (SlotCoalescer / TenantPlane / anything
    with `t`/`verify`/`recombine`). REQUIRED — the remote service must
    never be a single point of failure.
    """

    def __init__(
        self,
        host: str,
        port: int,
        tenant_id: str,
        auth_token,
        local,
        *,
        heartbeat_timeout: float = 3.0,
        request_timeout: float = 10.0,
        max_inflight_jobs: int = 256,
        max_inflight_lanes: int = 8192,
        backoff_config: Config = RECONNECT_CONFIG,
        rng=None,
        observer=None,  # callable(kind, **fields)
        stats_hook=None,  # callable(FlushStats)
        quarantine: PeerQuarantine | None = None,
        clock=time.monotonic,
        wire: int = WIRE_VERSION,
    ) -> None:
        if local is None:
            raise ValueError(
                "RemotePlane requires a local fallback plane"
            )
        self.host = host
        self.port = port
        self.tenant_id = tenant_id
        self._auth_token = (
            auth_token.encode()
            if isinstance(auth_token, str)
            else bytes(auth_token)
        )
        self._local = local
        self.heartbeat_timeout = heartbeat_timeout
        self.request_timeout = request_timeout
        self.max_inflight_jobs = max_inflight_jobs
        self.max_inflight_lanes = max_inflight_lanes
        self._backoff_cfg = backoff_config
        self._rng = rng or random.Random()
        self.observer = observer
        self.stats_hook = stats_hook
        self.addr = f"{host}:{port}"
        # the configured server address is exempt from mute escalation
        # (a flapping server costs reconnect backoff, not a mute)
        self.quarantine = quarantine or PeerQuarantine(exempt={self.addr})
        self._clock = clock
        self._wire = wire
        # state: "down" (no usable conn) | "probing" (conn up, one
        # probe in flight allowed) | "up" (full window)
        self.state = "down"
        self._probe_inflight = False
        self._closed = False
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._binary = wire >= 1
        self._heartbeat_interval = 1.0
        self._supervisor: asyncio.Task | None = None
        self._hb_task: asyncio.Task | None = None
        self._reader_task: asyncio.Task | None = None
        self._conn_lost: asyncio.Future | None = None
        self._seq = 0
        self._hb_seq = 0
        self._last_pong = self._clock()
        self._jobs: dict[int, _Job] = {}
        self.inflight_jobs = 0
        self.inflight_lanes = 0
        # observability (scenario tests + app/metrics.remote_hook)
        self.failovers: dict[str, int] = {}
        self.remote_jobs = 0
        self.local_jobs = 0
        self.sheds: dict[str, int] = {}
        self.connects = 0
        self.disconnects: dict[str, int] = {}
        self.reconnect_delays: list[float] = []
        self.remote_t: int | None = None

    # -- TenantPlane surface ----------------------------------------------

    @property
    def t(self) -> int:
        return self._local.t

    async def verify(self, items, deadline: float | None = None):
        items = list(items)
        if not items:
            return []
        res = await self._call(
            "verify", (items,), len(items), deadline
        )
        return list(res)

    async def recombine(
        self,
        pubshares,
        roots,
        partials,
        group_pks,
        indices,
        deadline: float | None = None,
    ):
        rows = (
            list(pubshares),
            list(roots),
            list(partials),
            list(group_pks),
            list(indices),
        )
        if not rows[1]:
            return [], []
        sigs, oks = await self._call(
            "recombine", rows, len(rows[1]), deadline
        )
        return list(sigs), list(oks)

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        """Begin connection supervision. Safe to call once; jobs
        submitted before the first connect simply run local."""
        if self._supervisor is None or self._supervisor.done():
            self._supervisor = asyncio.create_task(self._supervise())

    async def close(self) -> None:
        self._closed = True
        for task in (self._supervisor, self._hb_task):
            if task is not None and not task.done():
                task.cancel()
        tasks = [
            t
            for t in (self._supervisor, self._hb_task)
            if t is not None
        ]
        self._teardown("closed")
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)

    def _observe(self, kind: str, **fields) -> None:
        if self.observer is not None:
            try:
                self.observer(kind, **fields)
            except Exception:  # noqa: BLE001 — observer bugs stay out
                pass

    # -- connection supervision -------------------------------------------

    async def _supervise(self) -> None:
        retries = 0
        while not self._closed:
            try:
                await self._connect_once()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — any dial/handshake
                # fault lands here; the schedule below is the retry
                self._observe(
                    "connect_fail",
                    error=f"{type(e).__name__}",
                )
                delay = backoff_delay(
                    self._backoff_cfg, retries, self._rng
                )
                retries += 1
                self.reconnect_delays.append(delay)
                await asyncio.sleep(delay)
                continue
            retries = 0
            self.connects += 1
            self._observe("connect")
            conn_lost = self._conn_lost
            if conn_lost is not None:
                await conn_lost  # resolved by _teardown(reason)

    async def _connect_once(self) -> None:
        reader, writer = await asyncio.open_connection(
            self.host, self.port
        )
        try:
            challenge = await asyncio.wait_for(
                read_frame(reader), self.request_timeout
            )
            if not isinstance(challenge, CryptoChallenge):
                raise CodecError("expected CryptoChallenge")
            proof = auth_proof(self._auth_token, challenge.nonce)
            hello = CryptoHello(self.tenant_id, proof, self._wire)
            # the proof is an HMAC digest, not the token; the token
            # itself never crosses the wire
            send_frame(writer, hello, False)  # lint: allow(secret-flow)
            await writer.drain()
            ack = await asyncio.wait_for(
                read_frame(reader), self.request_timeout
            )
            if not isinstance(ack, CryptoHelloAck) or not ack.ok:
                raise ConnectionError("service hello rejected")
        except BaseException:
            writer.close()
            raise
        self._reader = reader
        self._writer = writer
        self._binary = min(self._wire, ack.wire) >= 1
        # the server echoes every ping on receipt, so pong freshness is
        # bounded by OUR ping cadence: never ping slower than a third of
        # the liveness budget, or a timeout tighter than the server's
        # advertised interval would flap on every single beat
        self._heartbeat_interval = max(
            0.05, min(float(ack.heartbeat), self.heartbeat_timeout / 3.0)
        )
        self.remote_t = ack.t or None
        self._last_pong = self._clock()
        self._conn_lost = asyncio.get_running_loop().create_future()
        self.state = "probing"
        self._probe_inflight = False
        self._observe("state", state=self.state)
        self._reader_task = asyncio.create_task(self._read_loop())
        self._hb_task = asyncio.create_task(self._heartbeat_loop())

    def _teardown(self, reason: str, reader=None) -> None:
        """Drop the connection (idempotent): fail in-flight jobs over
        to their waiters' local fallback and wake the supervisor.
        `reader` guards against a STALE read loop (its socket died
        after a reconnect already succeeded) tearing down the fresh
        connection."""
        if reader is not None and reader is not self._reader:
            return
        if self._writer is not None:
            self._writer.close()
        self._reader = None
        self._writer = None
        if self._hb_task is not None and not self._hb_task.done():
            self._hb_task.cancel()
        if self.state != "down":
            self.state = "down"
            self.disconnects[reason] = (
                self.disconnects.get(reason, 0) + 1
            )
            self._observe("disconnect", reason=reason)
            self._observe("state", state=self.state)
        self._probe_inflight = False
        for job in list(self._jobs.values()):
            if not job.fut.done():
                job.fut.set_exception(_RemoteFailure(reason))
        self._jobs.clear()
        if self._conn_lost is not None and not self._conn_lost.done():
            self._conn_lost.set_result(None)

    # -- heartbeats (time.monotonic ONLY) ---------------------------------

    def _heartbeat_expired(self) -> bool:
        """Pure check, injectable clock: True when the last echo is
        older than heartbeat_timeout on the MONOTONIC clock."""
        return (
            self._clock() - self._last_pong > self.heartbeat_timeout
        )

    async def _heartbeat_loop(self) -> None:
        while not self._closed:
            writer = self._writer
            if writer is None:
                return
            self._hb_seq += 1
            try:
                send_frame(
                    writer,
                    CryptoHeartbeat(self._hb_seq),
                    self._binary,
                )
                await writer.drain()
            except (ConnectionError, OSError, RuntimeError):
                self._teardown("io")
                return
            await asyncio.sleep(self._heartbeat_interval)
            if self._heartbeat_expired():
                self._observe("heartbeat_miss")
                self._teardown("heartbeat")
                return

    # -- read loop ---------------------------------------------------------

    async def _read_loop(self) -> None:
        reader = self._reader
        while reader is not None and reader is self._reader:
            try:
                msg = await read_frame(reader)
            except CodecError:
                # corrupt result frame: strike (the pinned server addr
                # never escalates to a mute) and drop the stream — the
                # framing can't be trusted after payload corruption
                self.quarantine.strike(self.addr)
                self._teardown("codec", reader=reader)
                return
            except (
                ConnectionError,
                asyncio.IncompleteReadError,
                OSError,
            ):
                self._teardown("io", reader=reader)
                return
            self.quarantine.forgive(self.addr)
            if isinstance(msg, CryptoHeartbeat):
                if msg.echo:
                    self._last_pong = self._clock()
                continue
            if isinstance(msg, CryptoResult):
                self._on_result(msg)
            elif isinstance(msg, CryptoShed):
                self._on_shed(msg)
            # unknown-but-valid frames: ignore (forward compat)

    def _probe_settled(self) -> None:
        """Any typed response proves the submit path end to end."""
        if self.state == "probing":
            self.state = "up"
            self._observe("state", state=self.state)

    def _on_result(self, msg: CryptoResult) -> None:
        self._probe_settled()
        job = self._jobs.pop(msg.job_id, None)
        if job is None:
            return  # late result for a timed-out/failed-over job
        if msg.error_kind == "tbls":
            # crypto verdict — identical on every rung; do NOT fail over
            if not job.fut.done():
                job.fut.set_exception(TblsError(msg.error))
            return
        if msg.error_kind:
            if not job.fut.done():
                job.fut.set_exception(_RemoteFailure("remote_error"))
            return
        if msg.stats is not None:
            self._bridge_stats(msg.stats, job)
        if not job.fut.done():
            job.fut.set_result(msg.value)

    def _on_shed(self, msg: CryptoShed) -> None:
        self._probe_settled()
        self.sheds[msg.reason] = self.sheds.get(msg.reason, 0) + 1
        self._observe("remote_shed", reason=msg.reason)
        job = self._jobs.pop(msg.job_id, None)
        if job is not None and not job.fut.done():
            job.fut.set_exception(_RemoteFailure("shed"))

    def _bridge_stats(self, brief: dict, job: _Job) -> None:
        """Rebase the server's flush brief onto this host's wall clock
        and feed it to the local tracer bridge, rooted on the
        submitting duty's trace context."""
        if self.stats_hook is None or not isinstance(brief, dict):
            return
        now = time.time()  # lint: allow(monotonic-clock) — attribution spans are wall-timestamped

        def span(rel):
            if not rel:
                return None
            try:
                return (now - float(rel[0]), now - float(rel[1]))
            except (TypeError, ValueError, IndexError):
                return None

        try:
            stats = FlushStats(
                jobs=int(brief.get("jobs", 1)),
                lanes=int(brief.get("lanes", job.lanes)),
                flush_seconds=float(brief.get("flush_seconds", 0.0)),
                window=float(brief.get("window", 0.0)),
                inflight=int(brief.get("inflight", 1)),
                pad_lanes=None,
                padded_lanes=None,
                decode_queue_seconds=(),
                fallback=bool(brief.get("fallback", False)),
                decode_mode=str(brief.get("decode_mode", "remote")),
                pack_span=span(brief.get("pack_rel")),
                device_span=span(brief.get("device_rel")),
                parents=(job.parent,) if job.parent else (),
                tenant_lanes=(
                    (
                        self.tenant_id,
                        int(brief.get("tenant_lanes", job.lanes)),
                    ),
                ),
            )
            self.stats_hook(stats)
        except Exception:  # noqa: BLE001 — attribution is best-effort;
            pass  # a malformed brief must never fail the job

    # -- job routing -------------------------------------------------------

    def _remote_usable(self) -> bool:
        if self._writer is None or self._closed:
            return False
        if self.state == "up":
            return True
        return self.state == "probing" and not self._probe_inflight

    async def _call(self, kind, args, lanes, deadline):
        if not self._remote_usable():
            reason = (
                "probing" if self.state == "probing" else "down"
            )
            return await self._run_local(kind, args, deadline, reason)
        if self.inflight_jobs + 1 > self.max_inflight_jobs:
            self._shed_local("jobs", lanes)
        if self.inflight_lanes + lanes > self.max_inflight_lanes:
            self._shed_local("lanes", lanes)
        probe = self.state == "probing"
        if probe:
            self._probe_inflight = True
        try:
            return await self._round_trip(kind, args, lanes, deadline)
        except _RemoteFailure as e:
            return await self._run_local(
                kind, args, deadline, e.reason
            )
        finally:
            if probe:
                self._probe_inflight = False

    def _shed_local(self, reason: str, lanes: int):
        """Typed shed on in-flight window overflow: same contract as
        the in-process service, so submitters' PlaneOverloadError
        catch-sites degrade to their own host rung."""
        self._observe("shed", reason=reason, lanes=lanes)
        raise PlaneOverloadError(
            self.tenant_id,
            reason,
            f"remote window {self.inflight_jobs} jobs / "
            f"{self.inflight_lanes} lanes in flight (+{lanes})",
        )

    async def _round_trip(self, kind, args, lanes, deadline):
        writer = self._writer
        if writer is None:
            raise _RemoteFailure("down")
        loop = asyncio.get_running_loop()
        self._seq += 1
        job_id = self._seq
        parent = None
        try:
            from charon_tpu_torch.app.tracer import current_ctx

            parent = current_ctx()
        except Exception:  # noqa: BLE001 — tracing is optional
            parent = None
        fut = loop.create_future()
        # the waiter can stop listening first (wait_for timeout racing a
        # teardown that fails the job over) — mark any late exception
        # retrieved so abandoned futures don't log spurious warnings
        fut.add_done_callback(
            lambda f: None if f.cancelled() else f.exception()
        )
        job = _Job(fut, lanes, parent)
        self._jobs[job_id] = job
        self.inflight_jobs += 1
        self.inflight_lanes += lanes
        try:
            deadline_rel = (
                # duty deadlines are wall-clock by plane contract; only
                # the RELATIVE remainder crosses the wire
                None if deadline is None else deadline - time.time()  # lint: allow(monotonic-clock)
            )
            try:
                send_frame(
                    writer,
                    CryptoSubmit(
                        job_id, kind, args, lanes, deadline_rel
                    ),
                    self._binary,
                )
                await writer.drain()
            except (ConnectionError, OSError, RuntimeError):
                self._teardown("io")
                raise _RemoteFailure("io") from None
            timeout = self.request_timeout
            if deadline_rel is not None:
                # never wait past the duty deadline: fail over while
                # the local rung can still win the duty
                timeout = min(
                    timeout, max(0.05, deadline_rel) + 0.25
                )
            try:
                value = await asyncio.wait_for(job.fut, timeout)
            except asyncio.TimeoutError:
                raise _RemoteFailure("timeout") from None
        finally:
            self._jobs.pop(job_id, None)
            self.inflight_jobs -= 1
            self.inflight_lanes -= lanes
        self.remote_jobs += 1
        return value

    async def _run_local(self, kind, args, deadline, reason: str):
        self.local_jobs += 1
        self.failovers[reason] = self.failovers.get(reason, 0) + 1
        lanes = len(args[0]) if kind == "verify" else len(args[1])
        self._observe("failover", reason=reason, lanes=lanes)
        if kind == "verify":
            return await self._local.verify(
                args[0], deadline=deadline
            )
        return await self._local.recombine(*args, deadline=deadline)
