"""ParSigEx: partial-signature exchange between cluster peers.

Mirrors ref: core/parsigex/parsigex.go — direct n² broadcast of every
locally stored partial-signature set to all peers; incoming sets are
verified against the sending share's pubshares *before* storing
(parsigex.go:94-98). MemTransport is the in-process variant the simnet
uses (ref: core/parsigex/memory.go); the TCP transport plugs into the same
component via the p2p layer.
"""

from __future__ import annotations

import asyncio
import time
from collections import defaultdict
from typing import Awaitable, Callable

from charon_tpu_torch import tbls
from charon_tpu_torch.core.cryptosvc import PlaneOverloadError
from charon_tpu_torch.core.deadline import LATE_FACTOR, SlotClock
from charon_tpu_torch.core.eth2data import ParSignedData
from charon_tpu_torch.core.types import Duty, DutyType, PubKey
from charon_tpu_torch.eth2util.signing import ForkInfo

ExSub = Callable[[Duty, dict[PubKey, ParSignedData]], Awaitable[None]]


def _transient() -> tuple:
    """Network-ish error classes worth a deadline-bounded resend — the
    ONE classification, owned by app/retry (lazy: core must not import
    app at module load)."""
    from charon_tpu_torch.app.retry import RETRYABLE

    return RETRYABLE


class DutyGater:
    """Rejects expired or far-future duties before any crypto runs
    (ref: core/parsigex/parsigex.go:81 wires core.NewDutyGater,
    core/gater.go:38-79): a peer flooding stale-slot sets must not reach
    the batch verifier — free DoS amplification on the crypto plane
    otherwise.

    Future bound is epoch-granular like the reference (duty epoch within
    allowed_future_epochs of current, gater.go:72-78); the stale bound
    (slot older than LATE_FACTOR, matching the Deadliner's expiry window,
    core/deadline.go:23-26) goes beyond the reference and is skipped for
    epoch-scale duty types (exits, builder registrations) whose slots
    legitimately lag."""

    ALLOWED_FUTURE_EPOCHS = 2  # ref: core/gater.go defaultAllowedFutureEpochs

    _EPOCH_SCALE = (DutyType.EXIT, DutyType.BUILDER_REGISTRATION)

    def __init__(
        self,
        clock: SlotClock,
        slots_per_epoch: int = 32,
        # wall clock by design: gating maps "now" onto the slot
        # timeline, which IS wall-clock (SlotClock genesis arithmetic)
        now: Callable[[], float] = time.time,  # lint: allow(monotonic-clock)
    ) -> None:
        self._clock = clock
        self._spe = slots_per_epoch
        self._now = now

    def __call__(self, duty: Duty) -> bool:
        if not isinstance(duty.type, DutyType) or duty.type == DutyType.UNKNOWN:
            return False
        current = self._clock.slot_at(self._now())
        if (
            duty.slot // self._spe
            > current // self._spe + self.ALLOWED_FUTURE_EPOCHS
        ):
            return False
        if duty.type in self._EPOCH_SCALE:
            return True
        return duty.slot >= current - LATE_FACTOR


class Eth2Verifier:
    """Verifies peer partial signatures against the sender's pubshares,
    batched (ref: core/parsigex/parsigex.go:146-170 NewEth2Verifier)."""

    def __init__(
        self,
        fork: ForkInfo,
        pubshares_by_idx: dict[int, dict[PubKey, bytes]],
        slots_per_epoch: int = 32,
        plane: object | None = None,  # core.cryptoplane.SlotCoalescer
        clock: SlotClock | None = None,  # duty deadlines for the plane
    ) -> None:
        self.fork = fork
        self.pubshares_by_idx = pubshares_by_idx
        self.slots_per_epoch = slots_per_epoch
        self.plane = plane
        self.clock = clock

    def _items(self, duty: Duty, signed_set: dict[PubKey, ParSignedData]):
        items = []
        for pubkey, psig in signed_set.items():
            shares = self.pubshares_by_idx.get(psig.share_idx)
            if shares is None or pubkey not in shares:
                return None
            root = psig.data.signing_root(
                self.fork, duty.slot // self.slots_per_epoch
            )
            items.append((shares[pubkey], root, psig.data.signature))
        return items

    def verify(self, duty: Duty, signed_set: dict[PubKey, ParSignedData]) -> bool:
        items = self._items(duty, signed_set)
        return items is not None and all(tbls.verify_batch(items))

    async def verify_async(
        self, duty: Duty, signed_set: dict[PubKey, ParSignedData]
    ) -> bool:
        """Plane path: inbound sets from all peers land within one
        coalescing window and verify as ONE sharded device program."""
        if self.plane is None:
            # plane-less rung: deliberately INLINE — the executor hop
            # GIL-convoys the busy loop and reorders inbound-set timing
            # (measured multi-x e2e slowdown); production wires the
            # plane. The overload-shed path below IS off-loop: it runs
            # exactly when the plane is saturated and the loop must
            # stay live.
            return self.verify(duty, signed_set)  # lint: allow(event-loop-blocking)
        items = self._items(duty, signed_set)
        if items is None:
            return False
        kwargs = {}
        if self.clock is not None:
            # near-deadline sets shrink the coalescing window instead of
            # waiting out a load-grown one (core/cryptoplane adaptive)
            kwargs["deadline"] = self.clock.duty_deadline(duty)
        try:
            return all(await self.plane.verify(items, **kwargs))
        except PlaneOverloadError:
            # admission shed (core/cryptosvc backpressure): serve THIS
            # set from the host tbls rung — on an executor thread, so
            # shed load costs latency on the degraded path, never a
            # dropped inbound set or a blocked event loop (host BLS is
            # ~0.3 s/verify on the python rung)
            loop = asyncio.get_running_loop()
            return await loop.run_in_executor(
                None, self.verify, duty, signed_set
            )


class MemTransport:
    """Loopback wiring of n ParSigEx components (in-process simnet).

    Deliveries are isolated per destination (ref: p2p sender failures
    are per-peer): one receiver's downstream failure must neither skip
    the remaining peers nor cascade back into the sender's own duty
    pipeline."""

    def __init__(self) -> None:
        self.nodes: list["ParSigEx"] = []

    def attach(self, node: "ParSigEx") -> None:
        self.nodes.append(node)

    async def send(
        self, from_idx: int, duty: Duty, signed_set, tctx: str | None = None
    ) -> None:
        # loopback crosses a simulated network boundary: drop the
        # sender's ambient span context so trace propagation happens
        # ONLY through the frame's tctx, as it would over real sockets
        from charon_tpu_torch.app.tracer import detached

        for node in self.nodes:
            if node.share_idx == from_idx:
                continue
            try:
                with detached():
                    await node.receive(
                        duty, signed_set, tctx=tctx, sender=from_idx
                    )
            except Exception as e:  # noqa: BLE001 — per-peer isolation
                from charon_tpu_torch.app import log

                log.warn(
                    "peer receive failed",
                    topic="parsigex",
                    peer=node.share_idx,
                    duty=str(duty),
                    err=f"{type(e).__name__}: {e}",
                )


class ParSigEx:
    """clock (optional SlotClock): enables deadline-aware resend — a
    transient transport failure re-sends with jittered backoff until the
    duty's deadline instead of giving up after one attempt (reusing
    app/expbackoff; ref: p2p sender retries under the duty context)."""

    def __init__(
        self,
        share_idx: int,
        transport: MemTransport,
        verifier: Eth2Verifier | None = None,
        gater: Callable[[Duty], bool] | None = None,
        clock: SlotClock | None = None,
        tracer=None,  # app/tracer.Tracer; None = process-global
        evidence=None,  # core/evidence.EvidenceRegistry; None = unrecorded
    ) -> None:
        self.share_idx = share_idx
        self.transport = transport
        self.verifier = verifier
        self.gater = gater
        self.clock = clock
        self.tracer = tracer
        self.evidence = evidence
        self.dropped_stale = 0  # metric: sets gated before crypto
        self.dropped_spoofed = 0  # sets claiming another peer's share idx
        self.dropped_invalid = 0  # sets that failed signature verification
        self.resend_total = 0  # metric: deadline-retry resends
        self._subs: list[ExSub] = []
        self._retry_tasks: set = set()
        transport.attach(self)

    def subscribe(self, sub: ExSub) -> None:
        self._subs.append(sub)

    async def broadcast(self, duty: Duty, signed_set: dict[PubKey, ParSignedData]) -> None:
        """Send our partials to all peers (ref: parsigex.go:112).

        First attempt inline; on a transient transport failure the send
        moves to a background deadline-bounded retry (fire-and-forget,
        like the reference's SendAsync) so the VC's submission path is
        never held hostage by a flapping peer link. Receivers dedup by
        share index, so a resend that partially succeeded is safe.

        The frame carries the sender's trace context (ref: the reference
        propagates OTel context in its p2p envelopes), so the receiving
        node's spans join this duty trace under true parentage."""
        tctx = self._trace_ctx()
        try:
            await self.transport.send(
                self.share_idx, duty, signed_set, tctx=tctx
            )
        except _transient() as e:
            if self.clock is None:
                raise
            import asyncio

            from charon_tpu_torch.app import log

            log.warn(
                "parsig send failed; retrying until duty deadline",
                topic="parsigex",
                duty=str(duty),
                err=f"{type(e).__name__}: {e}",
            )
            # anchor the wall duty deadline to the monotonic base HERE,
            # at failure time while the clock is still honest — the retry task then runs entirely on
            # monotonic, immune to host clock steps mid-backoff
            deadline_mono = time.monotonic() + (
                self.clock.duty_deadline(duty) - time.time()  # lint: allow(monotonic-clock) — one-shot wall->mono anchor
            )
            task = asyncio.create_task(
                self._resend(duty, signed_set, tctx, deadline_mono)
            )
            self._retry_tasks.add(task)
            task.add_done_callback(self._retry_tasks.discard)

    @staticmethod
    def _trace_ctx() -> str | None:
        from charon_tpu_torch.app.tracer import encode_ctx

        return encode_ctx()

    async def _resend(
        self, duty: Duty, signed_set, tctx: str | None, deadline: float
    ) -> None:
        """`deadline` is MONOTONIC-base (anchored by broadcast at
        failure time), so the backoff loop below never reads the wall
        clock — a host clock step mid-retry can neither abort the
        remaining resends nor resend past expiry."""
        import asyncio

        from charon_tpu_torch.app.expbackoff import FAST_CONFIG, backoff_delay

        attempt = 0
        while True:
            delay = backoff_delay(FAST_CONFIG, attempt)
            if time.monotonic() + delay >= deadline:
                return  # deadline exhausted; tracker reports the miss
            await asyncio.sleep(delay)
            attempt += 1
            try:
                await self.transport.send(
                    self.share_idx, duty, signed_set, tctx=tctx
                )
                self.resend_total += 1
                return
            except _transient():
                continue

    async def receive(
        self,
        duty: Duty,
        signed_set: dict[PubKey, ParSignedData],
        tctx: str | None = None,
        sender: int | None = None,
    ) -> None:
        """Peer partials arrive; gate, verify, then store
        (ref: parsigex.go:68-109). The gater runs *before* signature
        verification so stale floods never reach the batch verifier.

        `sender` is the CHANNEL identity — the authenticated share index
        the transport received this frame from (None for direct callers
        and legacy fakes). With it, two Byzantine detections attribute to
        the right peer: a set claiming a DIFFERENT share index than its
        channel is a spoof by the channel peer (dropped before any
        crypto — otherwise forged partials stamped with a victim's index
        would bill evidence to the victim), and a set that fails
        verification is billed to the channel that delivered it.

        `tctx` is the sender's propagated trace context: the receive
        span (and everything nested under it — verification, the
        store_external edge, threshold aggregation) joins the sender's
        duty trace. A corrupted/garbage tctx decodes to None and the
        span falls back to a fresh duty-rooted root — frame chaos must
        never crash the receive path."""
        from charon_tpu_torch.app.tracer import parse_ctx, span

        if self.gater is not None and not self.gater(duty):
            self.dropped_stale += 1
            return
        if sender is not None and any(
            ps.share_idx != sender for ps in signed_set.values()
        ):
            self.dropped_spoofed += 1
            if self.evidence is not None:
                self.evidence.record(sender, "parsig_spoof")
            return
        with span(
            "parsigex.receive",
            duty=duty,
            tracer=self.tracer,
            remote=parse_ctx(tctx),
            pubkeys=len(signed_set),
        ):
            if self.verifier is not None:
                check = getattr(self.verifier, "verify_async", None)
                if check is not None:
                    ok = await check(duty, signed_set)
                else:
                    # duck-typed sync verifier (test fakes): inline on
                    # purpose, same rationale as verify_async's plane-
                    # less rung above
                    ok = self.verifier.verify(duty, signed_set)  # lint: allow(event-loop-blocking)
                if not ok:
                    # drop invalid sets; billed to the channel peer when
                    # known, else to the claimed share indices (the best
                    # identity a channel-less caller has)
                    self.dropped_invalid += 1
                    if self.evidence is not None:
                        peers = (
                            {sender}
                            if sender is not None
                            else {
                                ps.share_idx
                                for ps in signed_set.values()
                            }
                        )
                        for peer in peers:
                            self.evidence.record(peer, "parsig_invalid")
                    return
            for sub in self._subs:
                await sub(duty, signed_set)
