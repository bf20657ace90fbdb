"""QBFT: a pure, transport-agnostic implementation of the Istanbul BFT
consensus algorithm (Moniz, arXiv:2002.03613).

Plays the role of ref: core/qbft/qbft.go — a generic engine with zero
dependencies, driven entirely through a Definition (validation, leader
selection, timers) and a Transport (broadcast + inbound queue), so the
simnet runs it over in-memory channels and production over the p2p layer.
This is a from-scratch implementation of the published algorithm, asyncio
style: one `run` coroutine per consensus instance.

Quorum: ceil(2n/3); tolerates floor((n-1)/3) byzantine nodes.

The subtle parts, implemented per the paper:
  * PRE-PREPARE justification for round > 1 (a quorum of ROUND-CHANGEs,
    and the proposed value must match the highest prepared value among
    them, which itself must be justified by a PREPARE quorum);
  * ROUND-CHANGE carries (prepared_round, prepared_value) plus the
    PREPARE messages justifying them;
  * f+1 ROUND-CHANGEs ahead of us pull us into the smallest such round.
"""

from __future__ import annotations

import asyncio
import enum
import math
from dataclasses import dataclass, field, replace
from typing import Awaitable, Callable, Hashable, Sequence


class MsgType(enum.IntEnum):
    PRE_PREPARE = 1
    PREPARE = 2
    COMMIT = 3
    ROUND_CHANGE = 4


@dataclass(frozen=True)
class Msg:
    """One QBFT message. `value` is the proposed value (hashable; the
    adapter layer uses 32-byte hashes with values carried out-of-band, ref:
    core/consensus/qbft/transport.go values-by-hash). Justification carries
    piggybacked messages for PRE-PREPARE/ROUND-CHANGE rules.

    `signature` authenticates the message independently of the channel it
    arrived on (ref: core/consensus/qbft/transport.go:25-50 signs every
    msg; qbft.go:561 verifies) — required because justification messages
    are relayed by third parties, so channel auth alone cannot vouch for
    their claimed sources. The engine treats it as opaque; signing happens
    via Definition.sign_msg and verification via Definition.is_valid."""

    type: MsgType
    instance: Hashable
    source: int  # node index 0..n-1
    round: int
    value: Hashable | None = None
    prepared_round: int = 0
    prepared_value: Hashable | None = None
    justification: tuple["Msg", ...] = ()
    signature: bytes = b""


def msg_digest(msg: Msg) -> bytes:
    """Deterministic 32-byte digest of a message, excluding its signature.

    Justification messages contribute their own digests *and* signatures,
    binding the exact set of piggybacked (already-signed) messages to the
    outer signature."""
    import hashlib

    just = tuple(
        (msg_digest(j), j.signature) for j in msg.justification
    )
    material = repr(
        (
            int(msg.type),
            msg.instance,
            msg.source,
            msg.round,
            msg.value,
            msg.prepared_round,
            msg.prepared_value,
            just,
        )
    ).encode()
    return hashlib.sha256(material).digest()


# Round-timer strategies (ref: core/consensus/utils/roundtimer.go:17-19
# constants, :72-97 increasing, :99-152 eager-double-linear). A timer is
# instantiated PER INSTANCE (ref TimerFunc is per duty) because the
# double-eager variant is stateful across restarts within one instance.
INC_ROUND_START = 0.75
INC_ROUND_INCREASE = 0.25
LINEAR_ROUND_INC = 1.0


class IncreasingRoundTimer:
    """Fresh `start + inc*round` countdown on every (re)arm — a restart
    for the same round fully resets it."""

    type = "inc"

    def __init__(
        self,
        start: float = INC_ROUND_START,
        increase: float = INC_ROUND_INCREASE,
    ) -> None:
        self._start = start
        self._increase = increase

    def duration(self, rnd: int, now: float) -> float:
        return self._start + self._increase * rnd


class DoubleEagerLinearRoundTimer:
    """Linear `round * inc` timeout whose per-round deadline is ABSOLUTE:
    re-arming the same round (the justified-pre-prepare restart) extends
    the deadline to first_deadline + linear(round) — i.e. doubles the
    round instead of resetting it, keeping every peer's round end-time
    aligned with the round start rather than with when each peer happened
    to see the leader's pre-prepare
    (ref: core/consensus/utils/roundtimer.go:112-131 rationale)."""

    type = "eager_dlinear"

    def __init__(self, inc: float = LINEAR_ROUND_INC) -> None:
        self._inc = inc
        self._first: dict[int, float] = {}

    def duration(self, rnd: int, now: float) -> float:
        first = self._first.get(rnd)
        if first is None:
            deadline = now + self._inc * rnd
            self._first[rnd] = deadline
        else:
            deadline = first + self._inc * rnd
        return max(0.0, deadline - now)


class _FnTimer:
    """Adapter for the legacy `Definition.timeout` callable."""

    type = "inc"

    def __init__(self, fn: Callable[[int], float]) -> None:
        self._fn = fn

    def duration(self, rnd: int, now: float) -> float:
        return self._fn(rnd)


@dataclass
class Definition:
    """Parameters binding the pure engine to an environment."""

    nodes: int
    leader: Callable[[Hashable, int], int]  # (instance, round) -> node idx
    # round -> timeout seconds (ref-equivalent default: 0.75 + 0.25*round)
    timeout: Callable[[int], float] = lambda r: 0.75 + 0.25 * r
    # Per-instance round-timer factory; when set it takes precedence over
    # `timeout` (ref: qbft.go:36 Definition.NewTimer from TimerFunc).
    new_timer: Callable[[], object] | None = None
    # Authenticates a message (signature over msg_digest against the
    # per-index cluster key) AND, for messages carrying justifications,
    # each piggybacked message (ref: qbft.go:561 verifies wrapped msgs).
    is_valid: Callable[[Msg], bool] = lambda m: True
    # Applied to every outbound message before broadcast/loopback.
    sign_msg: Callable[[Msg], Msg] = lambda m: m
    # Outer-signature-only check (no justification recursion). Used to
    # attribute evidence safely: a message whose SENDER authenticates but
    # whose piggybacked justification does not was forged by that sender,
    # while a message failing the outer check proves nothing about the
    # claimed source. None = fall back to is_valid (the unsigned/
    # channel-authenticated fabrics, where is_valid is trivially cheap).
    verify_sender: Callable[[Msg], bool] | None = None
    # Per-sender cap on messages the engine STORES for this instance (the
    # Transport bound only covers outstanding inbox depth — a sustained
    # flood streams through it into `_Engine.msgs` otherwise). A
    # protocol-honest sender stores <= 4 messages per round, so the
    # default allows ~32 rounds of headroom.
    max_stored_per_source: int = 128
    # Byzantine-evidence sink: (source, kind) per attributed detection.
    # Kind literals match core/evidence.py constants; the engine stays
    # import-free by design.
    on_evidence: Callable[[int, str], None] | None = None

    @property
    def quorum(self) -> int:
        return math.ceil(2 * self.nodes / 3)

    @property
    def faulty(self) -> int:
        return (self.nodes - 1) // 3


class DropReason(enum.Enum):
    """Why a transport refused an inbound message (typed, countable)."""

    SOURCE_OVER_BOUND = "source_over_bound"


class Transport:
    """Broadcast + inbound queue. The engine owns no sockets.

    The inbox is bounded per source (ref: core/qbft bounds the per-peer
    FIFO) so one byzantine peer cannot grow memory without limit: messages
    beyond `max_buffered_per_source` outstanding from one source are
    dropped at receive time, with the drop typed and counted in `drops`
    so callers (and the Byzantine harness) can assert the bound fired."""

    def __init__(
        self,
        broadcast: Callable[[Msg], Awaitable[None]],
        max_buffered_per_source: int = 128,
    ):
        self.broadcast = broadcast
        self.inbox: asyncio.Queue[Msg] = asyncio.Queue()
        self.max_buffered_per_source = max_buffered_per_source
        self._buffered: dict[int, int] = {}
        # (source, DropReason) -> count of refused messages
        self.drops: dict[tuple[int, DropReason], int] = {}

    def receive(self, msg: Msg) -> bool:
        """Enqueue an inbound message; False = dropped (source over bound)."""
        n = self._buffered.get(msg.source, 0)
        if n >= self.max_buffered_per_source:
            key = (msg.source, DropReason.SOURCE_OVER_BOUND)
            self.drops[key] = self.drops.get(key, 0) + 1
            return False
        self._buffered[msg.source] = n + 1
        self.inbox.put_nowait(msg)
        return True

    def _consumed(self, msg: Msg) -> None:
        n = self._buffered.get(msg.source, 0)
        if n > 0:
            self._buffered[msg.source] = n - 1


async def run(
    defn: Definition,
    transport: Transport,
    instance: Hashable,
    node: int,
    value: Hashable | None,
    value_ch: asyncio.Future | None = None,
    stats: dict | None = None,
) -> Hashable:
    """Run one QBFT instance until it decides; returns the decided value.

    `value` is this node's proposal input (may be None initially with a
    `value_ch` future supplying it later — the participate-then-propose
    pattern, ref: core/consensus/qbft/qbft.go Propose vs Participate).

    `stats`, when given, receives `{"round": decided_round}` on decide —
    the adapter feeds it into the decided-rounds metric (ref:
    consensus metrics SetDecidedRounds per timer type)."""
    engine = _Engine(defn, transport, instance, node)
    result = await engine.run(value, value_ch)
    if stats is not None:
        stats["round"] = engine.round
        stats["drops"] = engine.drop_stats()
    return result


class _Engine:
    def __init__(self, defn: Definition, transport: Transport, instance, node: int):
        self.d = defn
        self.t = transport
        self.instance = instance
        self.node = node
        self.round = 1
        self.prepared_round = 0
        self.prepared_value = None
        self.prepare_quorum_just: tuple[Msg, ...] = ()
        self.input_value = None
        # dedup: (type, source, round) -> Msg (first wins per slot)
        self.msgs: dict[tuple[MsgType, int, int], Msg] = {}
        # stored-message count per source (bounded by
        # Definition.max_stored_per_source — see _accept)
        self._stored_per_source: dict[int, int] = {}
        # flood evidence is attributed at most once per source per
        # instance (attribution costs one outer signature verify; the
        # drop itself stays free)
        self._flood_flagged: set[int] = set()
        # typed drop counters (satellite: dropped AND counted)
        self.replay_dropped = 0  # foreign-instance messages
        self.dup_dropped = 0  # identical re-deliveries
        self.flood_dropped = 0  # per-source stored bound hit
        self.equivocation_dropped = 0  # conflicting msg in a filled slot
        self.sent_prepare: set[int] = set()
        self.sent_commit: set[int] = set()
        self.sent_preprepare: set[int] = set()
        self.sent_round_change: set[int] = set()
        self.decided: asyncio.Future = None  # type: ignore
        self._restart_timer = None  # bound in run()
        self._timer_round = 0  # round the live timer is armed for

    # -- helpers ----------------------------------------------------------

    def _collect(self, typ: MsgType, rnd: int) -> list[Msg]:
        return [
            m
            for (t, _, r), m in self.msgs.items()
            if t == typ and r == rnd
        ]

    def _quorum_value(self, typ: MsgType, rnd: int) -> Hashable | None:
        """Value (or hash) agreed by a quorum of messages of typ@rnd."""
        counts: dict = {}
        for m in self._collect(typ, rnd):
            counts[m.value] = counts.get(m.value, 0) + 1
            if counts[m.value] >= self.d.quorum:
                return m.value
        return None

    async def _send(self, msg: Msg) -> None:
        msg = self.d.sign_msg(msg)
        await self.t.broadcast(msg)
        # Loopback: our own message must also drive the upon-rules (it may
        # be the final piece of a quorum). Recursion is bounded by the
        # sent_* dedup sets.
        if self._accept(msg):
            await self._on_msg(msg)

    def drop_stats(self) -> dict[str, int]:
        """Typed drop counters (surfaced via qbft.run stats)."""
        return {
            "replay": self.replay_dropped,
            "duplicate": self.dup_dropped,
            "flood": self.flood_dropped,
            "equivocation": self.equivocation_dropped,
        }

    def _evidence(self, source: int, kind: str) -> None:
        if self.d.on_evidence is not None:
            self.d.on_evidence(source, kind)

    def _sender_authentic(self, msg: Msg) -> bool:
        """May evidence be attributed to msg.source? Outer signature only
        — without this check, garbage stamped with a victim's source
        index would let an adversary frame an honest peer."""
        if self.d.verify_sender is not None:
            return self.d.verify_sender(msg)
        return self.d.is_valid(msg)

    def _accept(self, msg: Msg) -> bool:
        if msg.instance != self.instance:
            # Cross-instance replay: counted but NOT attributed here —
            # msg.source names the original (possibly honest) signer,
            # not whoever replayed the frame. Channel-level attribution
            # lives in the adapter (consensus_qbft.deliver sender check).
            self.replay_dropped += 1
            return False
        if not (0 <= msg.source < self.d.nodes):
            return False
        # Dedup BEFORE signature verification: replaying an already-stored
        # message must not cost ECDSA verifies (a justification-laden msg
        # carries ~2*quorum signatures — free CPU amplification otherwise).
        key = (msg.type, msg.source, msg.round)
        stored = self.msgs.get(key)
        if stored is not None:
            if msg == stored or msg_digest(msg) == msg_digest(stored):
                self.dup_dropped += 1  # identical content: plain replay
            elif len(msg.justification) <= 2 * self.d.nodes and (
                self.d.is_valid(msg)
            ):
                # Two DIFFERENT validly-signed messages in one
                # (type, source, round) slot: equivocation. First wins;
                # the full is_valid (not just the outer check) runs first
                # so unverifiable garbage cannot frame the slot's owner —
                # one verify per colliding frame, no cheaper for the
                # attacker than sending a fresh message.
                self.equivocation_dropped += 1
                self._evidence(msg.source, "qbft_equivocation")
            return False
        # A PRE-PREPARE must come from the round's leader; storing
        # non-leader proposals would let any peer squat PRE-PREPARE slots
        # (and a validly-signed one is a protocol violation by its sender).
        if msg.type == MsgType.PRE_PREPARE and msg.source != self.d.leader(
            self.instance, msg.round
        ):
            if self._sender_authentic(msg):
                self._evidence(msg.source, "qbft_malformed")
            return False
        # Bound + dedup justifications BEFORE signature verification: a
        # protocol-honest PRE-PREPARE carries at most a ROUND-CHANGE quorum
        # plus a PREPARE quorum (<= 2n distinct (type, source, round)
        # slots); anything larger or duplicated is a CPU-amplification
        # attack (each entry costs an ECDSA verify). Attribution costs one
        # outer verify — same price the sender paid to send the frame.
        if len(msg.justification) > 2 * self.d.nodes:
            if self._sender_authentic(msg):
                self._evidence(msg.source, "qbft_malformed")
            return False
        seen: set = set()
        for j in msg.justification:
            jkey = (j.type, j.source, j.round)
            if not (0 <= j.source < self.d.nodes) or jkey in seen:
                if self._sender_authentic(msg):
                    self._evidence(msg.source, "qbft_malformed")
                return False
            seen.add(jkey)
        # Per-sender stored bound, checked before the full is_valid so a
        # flood costs no justification-recursion verifies. Evidence is
        # attributed once per source (one outer verify, then free drops).
        n_stored = self._stored_per_source.get(msg.source, 0)
        if n_stored >= self.d.max_stored_per_source:
            self.flood_dropped += 1
            if msg.source not in self._flood_flagged and (
                self._sender_authentic(msg)
            ):
                self._flood_flagged.add(msg.source)
                self._evidence(msg.source, "qbft_flood")
            return False
        if not self.d.is_valid(msg):
            if self.d.verify_sender is not None and self.d.verify_sender(
                msg
            ):
                # The outer signature verifies but a piggybacked
                # justification does not: the sender forged its
                # justification (a garbage frame would have failed the
                # outer check too, proving nothing about the source).
                self._evidence(msg.source, "qbft_forged_justification")
            return False
        self._stored_per_source[msg.source] = n_stored + 1
        self.msgs[key] = msg
        return True

    # -- justification rules (paper §4.4) ---------------------------------

    def _highest_prepared(self, rcs: Sequence[Msg]) -> Msg | None:
        best = None
        for m in rcs:
            if m.prepared_round > 0 and (
                best is None or m.prepared_round > best.prepared_round
            ):
                best = m
        return best

    def _justify_preprepare(self, msg: Msg) -> bool:
        if msg.round == 1:
            return True
        rcs = [
            j
            for j in msg.justification
            if j.type == MsgType.ROUND_CHANGE
            and j.round == msg.round
            and j.instance == self.instance
        ]
        # distinct senders, quorum
        senders = {j.source for j in rcs}
        if len(senders) < self.d.quorum:
            return False
        best = self._highest_prepared(rcs)
        if best is None:
            return True  # free to propose anything
        if msg.value != best.prepared_value:
            return False
        # the claimed prepared value must be backed by a PREPARE quorum
        # FROM THIS INSTANCE — without the instance check a byzantine
        # leader could replay a validly-signed PREPARE quorum recorded in
        # a different instance to justify a foreign value here
        prepares = [
            j
            for j in msg.justification
            if j.type == MsgType.PREPARE
            and j.instance == self.instance
            and j.round == best.prepared_round
            and j.value == best.prepared_value
        ]
        return len({j.source for j in prepares}) >= self.d.quorum

    # -- main loop --------------------------------------------------------

    async def run(self, value, value_ch) -> Hashable:
        loop = asyncio.get_running_loop()
        self.decided = loop.create_future()
        self.input_value = value
        timer_task: asyncio.Task | None = None
        rt = (
            self.d.new_timer()
            if self.d.new_timer is not None
            else _FnTimer(self.d.timeout)
        )

        async def round_timer(rnd: int, duration: float):
            await asyncio.sleep(duration)
            await self._on_timeout(rnd)

        def restart_timer():
            nonlocal timer_task
            if timer_task is not None and timer_task is not asyncio.current_task():
                # a fired timer restarts the timer from inside its own
                # task (_on_timeout): cancelling that task would cancel
                # the round change it broadcasts next, at the
                # broadcast's first suspension (a TCP send's)
                timer_task.cancel()
            self._timer_round = self.round
            # duration computed NOW, not when the task first runs: the
            # eager-dlinear timer must anchor a round's first deadline to
            # the moment the round starts (its whole point is aligning
            # deadlines with round starts, not with scheduler latency)
            d = rt.duration(self.round, loop.time())
            timer_task = asyncio.create_task(round_timer(self.round, d))

        self._restart_timer = restart_timer
        restart_timer()

        if value is None and value_ch is not None:

            async def await_value():
                v = await value_ch
                self.input_value = v
                await self._maybe_propose()

            value_task = asyncio.create_task(await_value())
        else:
            value_task = None

        await self._maybe_propose()

        try:
            while not self.decided.done():
                get = asyncio.create_task(self.t.inbox.get())
                done, _ = await asyncio.wait(
                    {get, self.decided},
                    return_when=asyncio.FIRST_COMPLETED,
                )
                if self.decided.done():
                    get.cancel()
                    break
                msg = get.result()
                self.t._consumed(msg)
                if self._accept(msg):
                    await self._on_msg(msg)
                # Re-arm only if _on_msg didn't already arm this round
                # (the justified-pre-prepare rule restarts inline, ref
                # qbft.go:318-319 — re-arming again here would double the
                # eager-dlinear deadline twice for one rule firing).
                if self.round != self._timer_round:
                    restart_timer()
                    # Messages for the new round may already be buffered in
                    # self.msgs (they arrived while we were behind); re-run
                    # the upon-rules against the stored state.
                    await self._reevaluate()
            return self.decided.result()
        finally:
            if timer_task is not None:
                timer_task.cancel()
            if value_task is not None:
                value_task.cancel()

    async def _reevaluate(self) -> None:
        """Re-run upon-rules for the current round against stored messages
        (after a round catch-up, quorums may already be present)."""
        for m in self._collect(MsgType.PRE_PREPARE, self.round):
            await self._on_msg(m)
        for m in self._collect(MsgType.PREPARE, self.round)[:1]:
            await self._on_msg(m)
        for rnd in {r for (t, _, r) in self.msgs if t == MsgType.COMMIT}:
            for m in self._collect(MsgType.COMMIT, rnd)[:1]:
                await self._on_msg(m)
        await self._maybe_propose()

    async def _maybe_propose(self) -> None:
        """Leader of round 1 sends the PRE-PREPARE when it has a value."""
        if (
            self.input_value is not None
            and self.d.leader(self.instance, self.round) == self.node
            and self.round not in self.sent_preprepare
        ):
            just = ()
            if self.round > 1:
                just = self._round_change_justification(self.round)
                if just is None:
                    return
            self.sent_preprepare.add(self.round)
            await self._send(
                Msg(
                    MsgType.PRE_PREPARE,
                    self.instance,
                    self.node,
                    self.round,
                    self._leader_value(self.round),
                    justification=tuple(just),
                )
            )

    def _leader_value(self, rnd: int):
        rcs = self._collect(MsgType.ROUND_CHANGE, rnd)
        best = self._highest_prepared(rcs)
        if best is not None:
            return best.prepared_value
        return self.input_value

    def _round_change_justification(self, rnd: int):
        rcs = self._collect(MsgType.ROUND_CHANGE, rnd)
        if len({m.source for m in rcs}) < self.d.quorum:
            return None
        just = list(rcs)
        best = self._highest_prepared(rcs)
        if best is not None:
            just.extend(best.justification)  # piggybacked PREPARE quorum
        return just

    async def _on_msg(self, msg: Msg) -> None:
        d = self.d
        # uponRule: PRE-PREPARE from the round's leader, justified.
        if msg.type == MsgType.PRE_PREPARE:
            if msg.source != d.leader(self.instance, msg.round):
                return
            if not self._justify_preprepare(msg):
                return
            if msg.round < self.round:
                return
            if msg.round > self.round:
                # catch up to the pre-prepared round (paper: accept
                # justified pre-prepare for a future round)
                self.round = msg.round
            if self.round not in self.sent_prepare:
                self.sent_prepare.add(self.round)
                # Justified pre-prepare restarts the round timer (ref:
                # qbft.go:318-319). Once per round (the sent_prepare
                # guard is the ref's isDuplicatedRule): with the
                # increasing timer this is a full reset; with the
                # eager-double-linear timer it extends the round to
                # double its first deadline instead.
                if self._restart_timer is not None:
                    self._restart_timer()
                await self._send(
                    Msg(
                        MsgType.PREPARE,
                        self.instance,
                        self.node,
                        self.round,
                        msg.value,
                    )
                )

        elif msg.type == MsgType.PREPARE:
            v = self._quorum_value(MsgType.PREPARE, self.round)
            if v is not None and self.round not in self.sent_commit:
                self.prepared_round = self.round
                self.prepared_value = v
                self.prepare_quorum_just = tuple(
                    m
                    for m in self._collect(MsgType.PREPARE, self.round)
                    if m.value == v
                )
                self.sent_commit.add(self.round)
                await self._send(
                    Msg(
                        MsgType.COMMIT,
                        self.instance,
                        self.node,
                        self.round,
                        v,
                    )
                )

        elif msg.type == MsgType.COMMIT:
            # decide on any round's commit quorum
            v = self._quorum_value(MsgType.COMMIT, msg.round)
            if v is not None and not self.decided.done():
                self.decided.set_result(v)

        elif msg.type == MsgType.ROUND_CHANGE:
            await self._on_round_change(msg)

    async def _on_round_change(self, msg: Msg) -> None:
        d = self.d
        # f+1 round-changes ahead of us: jump to the smallest of them.
        ahead = [
            m
            for m in (
                m
                for (t, _, r), m in self.msgs.items()
                if t == MsgType.ROUND_CHANGE and r > self.round
            )
        ]
        if len({m.source for m in ahead}) >= d.faulty + 1:
            self.round = min(m.round for m in ahead)
            await self._broadcast_round_change()

        # leader of msg.round with a quorum: send justified PRE-PREPARE.
        if (
            msg.round >= self.round
            and d.leader(self.instance, msg.round) == self.node
            and msg.round not in self.sent_preprepare
        ):
            just = self._round_change_justification(msg.round)
            if just is not None and (
                self._leader_value(msg.round) is not None
            ):
                self.round = msg.round
                self.sent_preprepare.add(msg.round)
                await self._send(
                    Msg(
                        MsgType.PRE_PREPARE,
                        self.instance,
                        self.node,
                        msg.round,
                        self._leader_value(msg.round),
                        justification=tuple(just),
                    )
                )

    async def _on_timeout(self, rnd: int) -> None:
        if self.decided.done() or rnd != self.round:
            return
        self.round += 1
        self._restart_timer()
        await self._broadcast_round_change()

    async def _broadcast_round_change(self) -> None:
        if self.round in self.sent_round_change:
            return
        self.sent_round_change.add(self.round)
        await self._send(
            Msg(
                MsgType.ROUND_CHANGE,
                self.instance,
                self.node,
                self.round,
                prepared_round=self.prepared_round,
                prepared_value=self.prepared_value,
                justification=self.prepare_quorum_just,
            )
        )
