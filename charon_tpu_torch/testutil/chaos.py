"""Seeded fault-injection plane for the three trust boundaries.

A distributed validator earns its keep when `n - t` nodes, beacon
endpoints, or crypto backends misbehave, so failure modes must be
*injectable on demand and reproducible by seed* (Handel-style adversarial
schedules, PAPERS.md; ref: the upstream project covers this with
p2p/fuzz.go + testutil/beaconmock/beaconmock_fuzz.go + compose chaos
runs). This module is the one home for all of it:

  * **p2p / partial-signature transport** — drop, delay, duplicate,
    reorder and corrupt frames, asymmetric partitions, node crash and
    restart (`ChaosParSigTransport`, `ChaosMsgNet`, `chaos_p2p_node`,
    `blast_garbage`, `fuzz_node`). The old `p2p/fuzz.py` stub is gone —
    this module is the only home.
  * **beacon clients** — injected timeouts, 5xx error bursts, slow
    responses and stale-head data (`ChaosBeacon`), fed through the same
    duck-typed surface as `app/eth2wrap.MultiClient`.
  * **crypto plane** — forced backend errors (`FlakyBackend`) so the
    tbls degradation ladder (`tbls/resilient.ResilientImpl`) and the
    cryptoplane host fallback are exercised, not just trusted.

Every injector draws from its own deterministic substream of one cluster
seed (`ChaosConfig.seed`), so a failing schedule replays exactly from the
seed alone. Production code never imports this module on the default
path: `app/faultinject.py` gates construction behind an env/flag and the
un-instrumented path constructs no wrapper objects at all.
"""

from __future__ import annotations

import asyncio
import random
import time as _time_mod
from dataclasses import dataclass, field, replace as _dc_replace


@dataclass
class ChaosConfig:
    """Fault rates per boundary. All probabilities are per frame/call in
    [0, 1]; zero disables that fault. One seed drives every injector —
    substreams are derived per (seed, label) so injectors never perturb
    each other's schedules."""

    seed: int = 0

    # -- transport frame faults (per delivery) ---------------------------
    drop: float = 0.0  # frame vanishes (sender sees an error)
    silent_drop: float = 0.0  # frame vanishes without any signal
    duplicate: float = 0.0  # frame delivered twice
    reorder: float = 0.0  # frame delivered late (later frames overtake)
    corrupt: float = 0.0  # frame delivered with a mangled signature
    delay: float = 0.0  # frame delivered after a random pause
    delay_max: float = 0.05  # upper bound (s) for reorder/delay pauses

    # -- beacon client faults (per call) ---------------------------------
    bn_error: float = 0.0  # start a 5xx burst
    bn_burst_max: int = 3  # burst length in calls, 1..bn_burst_max
    bn_timeout: float = 0.0  # call times out
    bn_slow: float = 0.0  # call succeeds after bn_slow_secs
    bn_slow_secs: float = 0.3
    bn_stale_head: float = 0.0  # attestation data votes for the old head

    # -- crypto backend faults (per op) ----------------------------------
    crypto_fail_rate: float = 0.0  # probability an op raises
    crypto_fail_after: int | None = None  # ops succeed until this count

    def stream(self, label: str) -> random.Random:
        """Deterministic per-injector substream: same seed + label ->
        same schedule, regardless of what other injectors consumed."""
        return random.Random(f"chaos:{self.seed}:{label}")


_SPEC_FIELDS = {f.name for f in ChaosConfig.__dataclass_fields__.values()}


def config_from_spec(spec: str) -> ChaosConfig:
    """Parse 'seed=42,drop=0.1,bn_error=0.2' into a ChaosConfig.
    Unknown keys raise ValueError (fail fast: a typo'd fault spec that
    silently injects nothing would void the whole chaos run)."""
    cfg = ChaosConfig()
    for part in spec.split(","):
        part = part.strip()
        if not part or part in ("1", "on", "true"):
            continue  # bare enable: all-zero rates, wrappers installed
        key, _, raw = part.partition("=")
        key = key.strip()
        if key not in _SPEC_FIELDS:
            raise ValueError(
                f"unknown fault-injection key {key!r}; known: "
                + ", ".join(sorted(_SPEC_FIELDS))
            )
        current = getattr(cfg, key)
        value: object
        if key == "crypto_fail_after":
            value = int(raw)
        elif isinstance(current, int) and not isinstance(current, bool):
            value = int(raw)
        else:
            value = float(raw)
        setattr(cfg, key, value)
    return cfg


class Partitioner:
    """Asymmetric partition state shared by the transports: an ordered
    pair (src, dst) being blocked does NOT imply (dst, src) is. Crashed
    nodes neither send nor receive until restarted."""

    def __init__(self) -> None:
        self._blocked: set[tuple[int, int]] = set()
        self.crashed: set[int] = set()

    def block(self, src: int, dst: int) -> None:
        self._blocked.add((src, dst))

    def partition(self, side_a, side_b, symmetric: bool = True) -> None:
        """Sever traffic from side_a to side_b (both directions when
        symmetric), e.g. partition({1,2,3}, {4}) isolates node 4."""
        for a in side_a:
            for b in side_b:
                self._blocked.add((a, b))
                if symmetric:
                    self._blocked.add((b, a))

    def isolate(self, idx: int, peers) -> None:
        self.partition([idx], [p for p in peers if p != idx])

    def heal(self) -> None:
        self._blocked.clear()

    def crash(self, idx: int) -> None:
        self.crashed.add(idx)

    def restart(self, idx: int) -> None:
        self.crashed.discard(idx)

    def blocked(self, src: int, dst: int) -> bool:
        return (src, dst) in self._blocked


def _corrupt_parsig(psig, rng: random.Random):
    """A shape-valid copy of a ParSignedData whose signature is garbage:
    receivers must *reject* it (verifier) without crashing — mangling the
    container itself would only exercise the codec, not the crypto gate."""
    from charon_tpu_torch.core.eth2data import ParSignedData

    return ParSignedData(
        data=psig.data.with_signature(rng.randbytes(96)),
        share_idx=psig.share_idx,
    )


class ChaosParSigTransport:
    """Drop-in for `core.parsigex.MemTransport` with seeded frame faults.

    Deliveries run as their own tasks (unlike MemTransport's serial
    awaits) so an injected delay on one destination cannot stall the
    fan-out — and so a receiver's long retry chain cannot block the
    sender, which is exactly the coupling real networks do not have.

    A delivery dropped by `drop` (or aimed at a crashed peer) raises
    ConnectionError after the healthy deliveries are dispatched, so the
    sender's deadline-aware retry re-sends; the receivers dedup by share
    index. `silent_drop` and partitions vanish frames without a signal,
    as real packet loss does.
    """

    def __init__(
        self, cfg: ChaosConfig, partitioner: Partitioner | None = None
    ) -> None:
        self.cfg = cfg
        self.part = partitioner or Partitioner()
        self.nodes: list = []
        self._rng = cfg.stream("parsig")
        self._tasks: set[asyncio.Task] = set()
        # observability: scenario tests assert faults actually fired
        self.dropped = 0
        self.silently_dropped = 0
        self.duplicated = 0
        self.delayed = 0
        self.corrupted = 0
        self.blocked = 0

    def attach(self, node) -> None:
        self.nodes.append(node)

    # -- control handles used by scenarios --------------------------------

    def crash(self, share_idx: int) -> None:
        self.part.crash(share_idx)

    def restart(self, share_idx: int) -> None:
        self.part.restart(share_idx)

    async def send(
        self, from_idx: int, duty, signed_set, tctx: str | None = None
    ) -> None:
        if from_idx in self.part.crashed:
            raise ConnectionError(f"chaos: node {from_idx} is crashed")
        failed: list[int] = []
        for node in self.nodes:
            dst = node.share_idx
            if dst == from_idx:
                continue
            if dst in self.part.crashed:
                failed.append(dst)
                continue
            if self.part.blocked(from_idx, dst):
                self.blocked += 1
                continue  # partition: silent, like real packet loss
            roll = self._rng.random()
            if roll < self.cfg.silent_drop:
                self.silently_dropped += 1
                continue
            if roll < self.cfg.silent_drop + self.cfg.drop:
                self.dropped += 1
                failed.append(dst)
                continue
            payload = signed_set
            frame_tctx = tctx
            if self._rng.random() < self.cfg.corrupt:
                self.corrupted += 1
                payload = {
                    pk: _corrupt_parsig(ps, self._rng)
                    for pk, ps in signed_set.items()
                }
                # corruption hits the whole frame: the propagated trace
                # context arrives as garbage too — receivers must fall
                # back to a fresh duty-rooted span, never crash
                frame_tctx = self._rng.randbytes(12).hex() + "-zz"
            self._deliver(node, duty, payload, frame_tctx, from_idx)
            if self._rng.random() < self.cfg.duplicate:
                self.duplicated += 1
                self._deliver(node, duty, payload, frame_tctx, from_idx)
        if failed:
            raise ConnectionError(
                f"chaos: delivery to peers {failed} failed"
            )

    def _deliver(
        self, node, duty, signed_set, tctx=None, sender=None
    ) -> None:
        async def run():
            # simulated network boundary: the delivery task inherits the
            # sender's contextvars — detach so trace context propagates
            # only via the frame's tctx (app/tracer.detached)
            from charon_tpu_torch.app.tracer import detached

            roll = self._rng.random()
            if roll < self.cfg.reorder + self.cfg.delay:
                self.delayed += 1
                await asyncio.sleep(
                    self._rng.uniform(0.0, self.cfg.delay_max)
                )
            if node.share_idx in self.part.crashed:
                return  # crashed while the frame was in flight
            try:
                with detached():
                    await node.receive(
                        duty, signed_set, tctx=tctx, sender=sender
                    )
            except Exception:  # noqa: BLE001 — receiver faults stay local
                pass

        task = asyncio.create_task(run())
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)


class ChaosMsgNet:
    """Seeded-lossy QBFT message fabric: drop-in for
    `core.consensus_qbft.MemMsgNet`. Message loss here is what forces
    round changes — the storm scenario drives the engine's liveness
    under sustained loss, not one lucky round."""

    def __init__(
        self, cfg: ChaosConfig, partitioner: Partitioner | None = None
    ) -> None:
        self.cfg = cfg
        self.part = partitioner or Partitioner()
        self.nodes: list = []
        self._rng = cfg.stream("qbft")
        self._tasks: set[asyncio.Task] = set()
        self.dropped = 0
        self.delayed = 0

    def attach(self, node) -> int:
        self.nodes.append(node)
        return len(self.nodes) - 1

    async def broadcast(
        self, from_idx: int, duty, msg, values, tctx: str | None = None
    ) -> None:
        if from_idx in self.part.crashed:
            return
        for node in self.nodes:
            if node.node_idx == from_idx:
                continue
            if node.node_idx in self.part.crashed or self.part.blocked(
                from_idx, node.node_idx
            ):
                continue
            if self._rng.random() < self.cfg.drop + self.cfg.silent_drop:
                self.dropped += 1
                continue
            if self._rng.random() < self.cfg.reorder + self.cfg.delay:
                self.delayed += 1
                self._late(node, duty, msg, values, tctx, from_idx)
                continue
            from charon_tpu_torch.app.tracer import detached

            with detached():
                node.deliver(duty, msg, values, tctx=tctx, sender=from_idx)

    def _late(
        self, node, duty, msg, values, tctx=None, sender=None
    ) -> None:
        async def run():
            from charon_tpu_torch.app.tracer import detached

            await asyncio.sleep(self._rng.uniform(0.0, self.cfg.delay_max))
            if node.node_idx not in self.part.crashed:
                with detached():
                    node.deliver(
                        duty, msg, values, tctx=tctx, sender=sender
                    )

        task = asyncio.create_task(run())
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)


_BEACON_FAULTY_METHODS = frozenset(
    {
        "await_synced",
        "attester_duties",
        "proposer_duties",
        "sync_duties",
        "attestation_data",
        "aggregate_attestation",
        "block_proposal",
        "sync_committee_block_root",
        "sync_contribution",
        "block_attestations",
        "block_root",
        "submit_attestation",
        "submit_aggregate",
        "submit_sync_message",
        "submit_contribution",
        "submit_proposal",
        "submit_registration",
        "submit_exit",
    }
)


class ChaosBeacon:
    """Fault-injecting wrapper around any beacon client (BeaconMock or an
    HTTP client): seeded timeouts, 5xx bursts (errors arrive in runs, as
    real outages do), slow responses, and stale-head attestation data.
    Everything else — recorder lists, `clock()`, overrides — delegates to
    the wrapped client untouched, so tests keep asserting on the inner
    mock."""

    def __init__(self, inner, cfg: ChaosConfig) -> None:
        self._inner = inner
        self._cfg = cfg
        self._rng = cfg.stream("beacon")
        self._burst_left = 0
        self.injected_errors = 0
        self.injected_timeouts = 0
        self.injected_slow = 0
        self.injected_stale = 0

    def _fault(self, name: str) -> str | None:
        cfg = self._cfg
        if self._burst_left > 0:
            self._burst_left -= 1
            return "error"
        roll = self._rng.random()
        if roll < cfg.bn_error:
            self._burst_left = self._rng.randint(1, max(1, cfg.bn_burst_max)) - 1
            return "error"
        roll = self._rng.random()
        if roll < cfg.bn_timeout:
            return "timeout"
        if roll < cfg.bn_timeout + cfg.bn_slow:
            return "slow"
        if (
            name == "attestation_data"
            and self._rng.random() < cfg.bn_stale_head
        ):
            return "stale"
        return None

    def __getattr__(self, name: str):
        inner = getattr(self._inner, name)
        if name not in _BEACON_FAULTY_METHODS or not callable(inner):
            return inner

        async def call(*args, **kwargs):
            mode = self._fault(name)
            if mode == "error":
                self.injected_errors += 1
                raise ConnectionError(
                    f"chaos: injected beacon 5xx on {name}"
                )
            if mode == "timeout":
                self.injected_timeouts += 1
                raise asyncio.TimeoutError(
                    f"chaos: injected beacon timeout on {name}"
                )
            if mode == "slow":
                self.injected_slow += 1
                await asyncio.sleep(self._cfg.bn_slow_secs)
            result = await inner(*args, **kwargs)
            if mode == "stale":
                # the BN has not seen the new head yet: shape-valid data
                # voting for the previous slot's block — the pipeline
                # must still reach consensus and sign it
                self.injected_stale += 1
                prev = getattr(self._inner, "_root", None)
                if prev is not None and hasattr(result, "beacon_block_root"):
                    slot = getattr(result, "slot", args[0] if args else 1)
                    result = _dc_replace(
                        result,
                        beacon_block_root=prev("block", max(0, slot - 1)),
                    )
            return result

        return call


class FlakyBackend:
    """Forced crypto-backend errors around any tbls Implementation:
    `fail_after=N` makes every op past the N-th raise (a device that
    wedges and stays wedged); `fail_rate` raises probabilistically
    (intermittent device). Raises RuntimeError — NOT TblsError — because
    a backend fault is infrastructure, not a crypto verdict, and the
    degradation ladder must distinguish the two."""

    def __init__(
        self,
        inner,
        cfg: ChaosConfig | None = None,
        fail_rate: float | None = None,
        fail_after: int | None = None,
        seed: int = 0,
    ) -> None:
        cfg = cfg or ChaosConfig(seed=seed)
        self._inner = inner
        self._rng = cfg.stream("crypto")
        self._fail_rate = (
            cfg.crypto_fail_rate if fail_rate is None else fail_rate
        )
        self._fail_after = (
            cfg.crypto_fail_after if fail_after is None else fail_after
        )
        self.calls = 0
        self.injected_failures = 0

    def _maybe_fail(self, name: str) -> None:
        self.calls += 1
        if self._fail_after is not None and self.calls > self._fail_after:
            self.injected_failures += 1
            raise RuntimeError(
                f"chaos: crypto backend lost (op {name}, call {self.calls})"
            )
        if self._fail_rate and self._rng.random() < self._fail_rate:
            self.injected_failures += 1
            raise RuntimeError(f"chaos: injected crypto fault on {name}")

    def __getattr__(self, name: str):
        inner = getattr(self._inner, name)
        if not callable(inner) or name.startswith("_"):
            return inner

        def call(*args, **kwargs):
            self._maybe_fail(name)
            return inner(*args, **kwargs)

        return call


# -- host clock skew ---------------------------------------------------------


class SkewedClock:
    """Steppable wall clock for chaos clock-skew scenarios: installed
    as a context manager it replaces `time.time` with real time plus a
    controllable offset, while `time.monotonic` stays untouched —
    exactly the asymmetry a real host clock step (NTP correction, VM
    migration, operator fat-finger) produces. Code converting between
    the two bases (e.g. SlotCoalescer._arm's duty deadlines) sees the
    bases disagree mid-run, which is the bug class this injector
    exists to reproduce deterministically.

        with SkewedClock() as clock:
            ...  # wall clock normal
            clock.step(60.0)   # host clock jumps forward a minute
            ...  # wall clock now leads monotonic by 60 s
    """

    def __init__(self, offset: float = 0.0) -> None:
        self.offset = offset
        self._real = _time_mod.time

    def __call__(self) -> float:
        return self._real() + self.offset

    def step(self, seconds: float) -> None:
        """Step the wall clock by `seconds` (negative = backward)."""
        self.offset += seconds

    def __enter__(self) -> "SkewedClock":
        _time_mod.time = self
        return self

    def __exit__(self, *exc) -> None:
        _time_mod.time = self._real


# -- forged-signature floods -------------------------------------------------


def forged_signatures(n: int, rng: random.Random) -> list[bytes]:
    """n seeded 96-byte G2 'signatures' with plausible compression
    flags (compressed bit set, infinity bit clear) but garbage field
    bytes: they pass the cheap flag checks and then fail decompression
    or verification — the forged-flood payload a byzantine tenant
    pours into a shared crypto plane."""
    out = []
    for _ in range(n):
        b = bytearray(rng.randbytes(96))
        b[0] = 0x80 | (0x20 if rng.random() < 0.5 else 0) | (b[0] & 0x1F)
        out.append(bytes(b))
    return out


# -- raw p2p frame chaos (absorbs the old p2p/fuzz.py) -----------------------


def chaos_p2p_node(node, cfg: ChaosConfig) -> None:
    """Wrap a `p2p.transport.P2PNode`'s send with seeded frame faults:
    drop, duplicate, and corrupt (garbage bytes on the raw connection —
    the receiver's codec/auth layer must reject them without dropping
    the authenticated connection's healthy traffic)."""
    rng = cfg.stream(f"p2p:{node.index}")
    orig_send = node.send

    async def chaotic_send(peer_idx, protocol, msg, await_response=False):
        roll = rng.random()
        if roll < cfg.drop + cfg.silent_drop:
            if await_response:
                raise TimeoutError("chaos: dropped request frame")
            return None
        if roll < cfg.drop + cfg.silent_drop + cfg.corrupt:
            try:
                conn = await node._get_conn(peer_idx)
                from charon_tpu_torch.p2p.transport import _write_frame

                async with conn.lock:
                    _write_frame(
                        conn.writer, rng.randbytes(rng.randrange(1, 64))
                    )
                    await conn.writer.drain()
            except Exception:  # noqa: BLE001 — chaos must not crash the node
                pass
            if await_response:
                raise TimeoutError("chaos: corrupted request frame")
            return None
        if rng.random() < cfg.duplicate:
            await orig_send(peer_idx, protocol, msg)
        if cfg.delay and rng.random() < cfg.delay:
            await asyncio.sleep(rng.uniform(0.0, cfg.delay_max))
        return await orig_send(peer_idx, protocol, msg, await_response)

    node.send = chaotic_send

    # broadcasts no longer route through send() (single-encode
    # fan-out) — inject the same per-delivery faults on that path too
    orig_bcast_one = node._broadcast_one

    async def chaotic_broadcast_one(peer_idx, protocol, req_id, msg, cache):
        roll = rng.random()
        if roll < cfg.silent_drop:
            return None
        if roll < cfg.silent_drop + cfg.drop:
            raise ConnectionError("chaos: dropped broadcast frame")
        if roll < cfg.silent_drop + cfg.drop + cfg.corrupt:
            try:
                conn = await node._get_conn(peer_idx)
                from charon_tpu_torch.p2p.transport import _write_frame

                async with conn.lock:
                    _write_frame(
                        conn.writer, rng.randbytes(rng.randrange(1, 64))
                    )
                    await conn.writer.drain()
            except Exception:  # noqa: BLE001 — chaos must not crash
                pass
            return None
        if rng.random() < cfg.duplicate:
            await orig_bcast_one(peer_idx, protocol, req_id, msg, cache)
        if cfg.delay and rng.random() < cfg.delay:
            await asyncio.sleep(rng.uniform(0.0, cfg.delay_max))
        return await orig_bcast_one(peer_idx, protocol, req_id, msg, cache)

    node._broadcast_one = chaotic_broadcast_one


def fuzz_node(node, rate: float = 0.2, seed: int = 0) -> None:
    """Convenience wrapper (absorbed from the deleted p2p/fuzz.py):
    split one aggregate fault `rate` evenly across drop/corrupt/duplicate
    and install the seeded p2p frame chaos on `node`."""
    chaos_p2p_node(
        node,
        ChaosConfig(
            seed=seed,
            drop=rate / 3,
            corrupt=rate / 3,
            duplicate=rate / 3,
        ),
    )


# -- remote crypto-service socket chaos ------------------------------------


class ChaosServiceProxy:
    """Seeded TCP chaos proxy for the remote crypto-plane socket: sits
    between `core/cryptosvc_client.RemotePlane` and
    `core/cryptosvc_server.CryptoServiceServer` forwarding raw bytes
    with injectable faults, so the client's failover ladder is
    exercised against *socket-level* misbehavior (not just polite
    server errors):

      * `partition()` / `heal()` — live connections blackhole silently
        (frames vanish mid-stream; only the heartbeat miss can notice)
        and new dials are refused;
      * `slow_drip` — per-chunk forwarding delay (a congested or
        rate-limited path; deadline propagation must fail jobs over
        before the duty expires);
      * `corrupt` — per-chunk probability of mangled bytes, which
        desyncs the length-prefixed framing and must surface as a
        typed CodecError teardown + reconnect, never a crash;
      * `kill_connections()` — abort every proxied socket (the
        mid-flush SIGKILL stand-in when the real server object must
        survive for assertions).

    Fault state is mutable mid-run — scenarios script phases against
    one proxy instance.
    """

    def __init__(
        self,
        upstream_host: str,
        upstream_port: int,
        cfg: ChaosConfig | None = None,
        host: str = "127.0.0.1",
    ) -> None:
        self.upstream = (upstream_host, upstream_port)
        self.cfg = cfg or ChaosConfig()
        self.host = host
        self.port = 0
        self._rng = self.cfg.stream("cryptosvc-proxy")
        self._server: asyncio.base_events.Server | None = None
        self._writers: set[asyncio.StreamWriter] = set()
        self._tasks: set[asyncio.Task] = set()
        self.partitioned = False
        self.slow_drip = 0.0  # seconds of added delay per chunk
        self.corrupt = 0.0  # per-chunk corruption probability
        # observability: scenarios assert the faults actually fired
        self.chunks = 0
        self.corrupted = 0
        self.swallowed = 0
        self.kills = 0

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._accept, self.host, 0
        )
        self.port = self._server.sockets[0].getsockname()[1]

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        self.kill_connections()
        await asyncio.gather(*self._tasks, return_exceptions=True)

    def partition(self) -> None:
        """Blackhole: live streams swallow bytes, new dials are cut."""
        self.partitioned = True

    def heal(self) -> None:
        self.partitioned = False

    def kill_connections(self) -> None:
        self.kills += 1
        for w in list(self._writers):
            if w.transport is not None:
                w.transport.abort()
        self._writers.clear()

    async def _accept(self, reader, writer) -> None:
        self._writers.add(writer)
        if self.partitioned:
            writer.close()
            self._writers.discard(writer)
            return
        try:
            up_reader, up_writer = await asyncio.open_connection(
                *self.upstream
            )
        except OSError:
            writer.close()
            self._writers.discard(writer)
            return
        self._writers.add(up_writer)
        for src, dst in (
            (reader, up_writer),
            (up_reader, writer),
        ):
            task = asyncio.create_task(self._pump(src, dst))
            self._tasks.add(task)
            task.add_done_callback(self._tasks.discard)

    async def _pump(self, src, dst) -> None:
        try:
            while True:
                chunk = await src.read(65536)
                if not chunk:
                    break
                self.chunks += 1
                if self.partitioned:
                    self.swallowed += 1
                    continue  # silent blackhole, like real packet loss
                if self.slow_drip:
                    await asyncio.sleep(self.slow_drip)
                if self.corrupt and self._rng.random() < self.corrupt:
                    self.corrupted += 1
                    b = bytearray(chunk)
                    for _ in range(max(1, len(b) // 64)):
                        b[self._rng.randrange(len(b))] ^= 0xFF
                    chunk = bytes(b)
                dst.write(chunk)
                await dst.drain()
        except (ConnectionError, OSError, asyncio.CancelledError):
            pass
        finally:
            try:
                dst.close()
            except RuntimeError:
                pass
            self._writers.discard(dst)


async def blast_garbage(
    host: str, port: int, n_frames: int = 50, seed: int = 0
) -> None:
    """Open raw connections and write random bytes at a p2p server —
    handshake and framing must reject them without taking the node
    down (moved from p2p/fuzz.py)."""
    rng = random.Random(seed)
    for _ in range(n_frames):
        try:
            _reader, writer = await asyncio.open_connection(host, port)
            writer.write(rng.randbytes(rng.randrange(1, 256)))
            await writer.drain()
            writer.close()
        except ConnectionError:
            pass
