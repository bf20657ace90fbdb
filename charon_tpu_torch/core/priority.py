"""Priority protocol: cluster-wide preference negotiation.

Mirrors ref: core/priority — each node exchanges signed priority messages
listing its ordered preferences per topic (prioritiser.go:326), computes
the cluster-wide ordering (calculate.go: priorities supported by at least
quorum peers, ordered by aggregate position score), then agrees on the
result via a consensus instance. Infosync (ref: core/infosync) triggers it
in the last slot of each epoch and feeds the result to the consensus
controller for protocol switching (ref: app/app.go:650-668).
"""

from __future__ import annotations

import asyncio
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Sequence

from charon_tpu_torch.core.types import Duty, DutyType


@dataclass(frozen=True)
class PriorityMsg:
    peer_idx: int
    slot: int
    topics: tuple[tuple[str, tuple[str, ...]], ...]  # (topic, ordered prefs)


@dataclass(frozen=True)
class TopicResult:
    topic: str
    priorities: tuple[str, ...]  # cluster-agreed order
    scores: tuple[int, ...] = ()  # per-priority aggregate score
                                  # (ref: PriorityScoredResult.Score)


# Weight a supporting peer far above any relative-position contribution,
# so the aggregate score orders by COUNT first and by overall list
# position only within equal counts (ref: calculate.go:17-19
# maxPriorities/countWeight — one number encodes count-then-position).
MAX_PRIORITIES = 1000
COUNT_WEIGHT = MAX_PRIORITIES


class PriorityError(Exception):
    """Invalid priority message set (ref: calculate.go validateMsgs)."""


def validate_msgs(msgs: Sequence[PriorityMsg]) -> None:
    """Reference validation rules (ref: calculate.go:141-192): non-empty
    input, identical slots, no duplicate peers, per-peer unique topics,
    per-topic unique priorities, at most MAX_PRIORITIES priorities."""
    if not msgs:
        raise PriorityError("messages empty")
    slot = msgs[0].slot
    peers: set[int] = set()
    for m in msgs:
        if m.slot != slot:
            raise PriorityError("mismatching slots")
        if m.peer_idx in peers:
            raise PriorityError("duplicate peer")
        peers.add(m.peer_idx)
        topics_seen: set[str] = set()
        for topic, prefs in m.topics:
            if topic in topics_seen:
                raise PriorityError("duplicate topic")
            topics_seen.add(topic)
            if len(prefs) >= MAX_PRIORITIES:
                raise PriorityError("max priorities reached")
            if len(set(prefs)) != len(prefs):
                raise PriorityError("duplicate priority")


def calculate(msgs: Sequence[PriorityMsg], quorum: int) -> list[TopicResult]:
    """Deterministic cluster-wide ordering (ref: calculate.go:25-99
    calculateResult): a priority is included iff at least `quorum` peers
    list it, and included priorities order by supporter COUNT first,
    positional preferredness second, lexical tie-break last.

    Two deliberate strictness improvements over the reference's single
    blended score (countWeight - order summed per listing): the ref
    formula is only "effectively count-then-position" for short lists —
    deep positions can push a quorum-supported priority below its
    inclusion threshold and position sums can cross count boundaries —
    so count and position score are tracked separately here, and ties
    break lexically where the reference's unstable sort left equal
    scores unordered. Topics are emitted in sorted order
    (ref: orderTopicResults)."""
    validate_msgs(msgs)

    by_topic: dict[str, list[tuple[str, ...]]] = defaultdict(list)
    for m in sorted(msgs, key=lambda m: m.peer_idx):  # ref: sortInput
        for topic, prefs in m.topics:
            by_topic[topic].append(prefs)

    out = []
    for topic in sorted(by_topic):
        counts: dict[str, int] = defaultdict(int)
        pos_score: dict[str, int] = defaultdict(int)
        for prefs in by_topic[topic]:
            for pos, p in enumerate(prefs):
                counts[p] += 1
                pos_score[p] += MAX_PRIORITIES - 1 - pos
        included = [p for p, c in counts.items() if c >= quorum]
        included.sort(key=lambda p: (-counts[p], -pos_score[p], p))
        out.append(
            TopicResult(
                topic=topic,
                priorities=tuple(included),
                # blended score for observability, count-dominant
                # (ref: PriorityScoredResult.Score)
                scores=tuple(
                    counts[p] * COUNT_WEIGHT + pos_score[p]
                    for p in included
                ),
            )
        )
    return out


class Prioritiser:
    """exchange: async callable broadcasting our msg and returning all
    peers' msgs (the p2p or in-memory fabric); consensus: object with
    propose(duty, value_set) + subscribe(cb) — the cluster's consensus
    component, reused for agreement on the result."""

    def __init__(
        self,
        node_idx: int,
        quorum: int,
        exchange,
        consensus,
        topics_fn: Callable[[], dict[str, list[str]]],
        timeout: float = 6.0,  # ref: app/app.go:610 priority exchange timeout
        on_duty_done: Callable[[Duty], None] | None = None,
    ) -> None:
        self.node_idx = node_idx
        self.quorum = quorum
        self.exchange = exchange
        self.consensus = consensus
        self.topics_fn = topics_fn
        self.timeout = timeout
        # cleanup hook: the INFO_SYNC duty is Prioritiser-created (the
        # scheduler never emits it), so nothing else registers it with
        # the deadliner — without this hook the consensus instance and
        # tracker events for it would accumulate one per epoch forever
        self.on_duty_done = on_duty_done
        self._subs: list = []
        consensus.subscribe(self._on_decided)

    def subscribe(self, sub) -> None:
        """sub(slot, list[TopicResult])"""
        self._subs.append(sub)

    async def prioritise(self, slot: int) -> None:
        """One negotiation round (ref: prioritiser.go:326 Prioritise).
        Peers that do not answer within the timeout are simply absent
        from the input set — quorum support decides inclusion."""
        topics = tuple(
            (t, tuple(prefs)) for t, prefs in sorted(self.topics_fn().items())
        )
        my_msg = PriorityMsg(self.node_idx, slot, topics)
        msgs = await asyncio.wait_for(
            self.exchange(slot, my_msg), self.timeout
        )
        # drop malformed peer contributions instead of failing the
        # round: validate each peer's msg alone, then the joint set
        good = []
        for m in msgs.values():
            try:
                validate_msgs([m])
            except PriorityError:
                continue
            if m.slot == slot:
                good.append(m)
        result = calculate(good, self.quorum)
        duty = Duty(slot, DutyType.INFO_SYNC)
        try:
            await self.consensus.propose(
                duty, {"priority": tuple(result)}
            )
        finally:
            if self.on_duty_done is not None:
                self.on_duty_done(duty)

    async def _on_decided(self, duty: Duty, value_set) -> None:
        if duty.type != DutyType.INFO_SYNC:
            return
        result = value_set.get("priority")
        if result is None:
            return
        for sub in self._subs:
            await sub(duty.slot, list(result))


class InfoSync:
    """Triggers prioritisation in the last slot of each epoch
    (ref: core/infosync/infosync.go:145; wiring app/app.go:638-644)."""

    TOPIC_PROTOCOL = "consensus_protocol"
    TOPIC_VERSION = "node_version"

    def __init__(self, prioritiser: Prioritiser) -> None:
        self.prioritiser = prioritiser
        self._last_epoch = -1
        self._task: asyncio.Task | None = None

    async def on_slot(self, slot) -> None:
        if not slot.is_last_in_epoch():
            return
        if slot.epoch == self._last_epoch:
            return
        self._last_epoch = slot.epoch
        # background: negotiation (up to the exchange timeout) must not
        # delay the scheduler's duty spawning for this slot, and NO
        # failure may escape into the scheduler loop — negotiation is
        # best-effort per epoch
        self._task = asyncio.create_task(self._run(slot.slot))

    async def _run(self, slot: int) -> None:
        try:
            await self.prioritiser.prioritise(slot)
        except asyncio.TimeoutError:
            pass
        except Exception as e:  # noqa: BLE001 — never kill the caller
            from charon_tpu_torch.app import log

            log.warn(
                "priority negotiation failed",
                topic="infosync",
                slot=slot,
                err=f"{type(e).__name__}: {str(e)[:160]}",
            )


PRIORITY_PROTOCOL = "priority/1.0.0"


class MemPriorityFabric:
    """In-process exchange for the simnet: every joined node contributes
    its message for a slot and exchange() resolves once all have (or the
    Prioritiser's timeout fires with whatever arrived)."""

    def __init__(self) -> None:
        self.n = 0
        self._msgs: dict[int, dict[int, PriorityMsg]] = defaultdict(dict)
        self._events: dict[int, asyncio.Event] = {}

    def join(self) -> None:
        self.n += 1

    async def exchange(self, slot: int, my_msg: PriorityMsg):
        got = self._msgs[slot]
        got[my_msg.peer_idx] = my_msg
        ev = self._events.setdefault(slot, asyncio.Event())
        if len(got) >= self.n:
            ev.set()
        await ev.wait()
        return dict(got)


class P2PPriorityExchange:
    """Priority-message gather over the p2p mesh (production fabric;
    ref: core/priority/prioritiser.go exchange over libp2p streams).

    Our message for the slot is stored, then peers are polled with a
    typed request; each peer's handler answers with its own message for
    that slot once it has computed one. The Prioritiser bounds the whole
    gather with its timeout, so polling simply retries until then."""

    def __init__(
        self,
        node,
        poll_interval: float = 0.5,
        gather_timeout: float = 4.0,
    ) -> None:
        self.node = node
        self.poll_interval = poll_interval
        # returns the PARTIAL set once this budget elapses: an offline
        # peer must not starve negotiation — calculate() is quorum-based
        # and works from whatever arrived (kept below the Prioritiser's
        # 6 s timeout so wait_for never discards a gathered set)
        self.gather_timeout = gather_timeout
        self._mine: dict[int, PriorityMsg] = {}
        node.register_handler(PRIORITY_PROTOCOL, self._handle)

    async def _handle(self, from_idx: int, msg):
        slot = msg.get("slot") if isinstance(msg, dict) else None
        mine = self._mine.get(slot)
        return {"msg": mine} if mine is not None else {"msg": None}

    async def exchange(self, slot: int, my_msg: PriorityMsg):
        self._mine[slot] = my_msg
        # bounded memory: keep only the most recent few rounds
        for old in sorted(self._mine)[:-4]:
            self._mine.pop(old, None)
        got = {my_msg.peer_idx: my_msg}
        pending = set(self.node.peers)
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.gather_timeout
        while pending and loop.time() < deadline:
            for idx in sorted(pending):
                try:
                    resp = await self.node.send(
                        idx,
                        PRIORITY_PROTOCOL,
                        {"slot": slot},
                        await_response=True,
                    )
                except Exception:
                    continue
                peer_msg = resp.get("msg") if isinstance(resp, dict) else None
                if isinstance(peer_msg, PriorityMsg) and peer_msg.slot == slot:
                    got[peer_msg.peer_idx] = peer_msg
                    pending.discard(idx)
            if pending:
                await asyncio.sleep(
                    min(self.poll_interval, max(0.0, deadline - loop.time()))
                )
        return got


def order_protocol_prefs(registered: list[str], preferred: str) -> list[str]:
    """Supported protocols most-preferred first: a cluster-level
    preference (the v1.1 definition's hash-covered consensus_protocol)
    outranks the node default; an unsupported or empty preference leaves
    the order untouched (ref: the cluster consensus preference feeds the
    node's priority proposal ahead of its defaults)."""
    prefs = list(registered)
    if preferred in prefs:
        prefs.remove(preferred)
        prefs.insert(0, preferred)
    return prefs


def protocol_switcher(controller):
    """Priority subscriber that switches the consensus protocol to the
    cluster's top choice (ref: app/app.go:650-668)."""

    async def on_result(slot: int, results: list[TopicResult]) -> None:
        for r in results:
            if r.topic == InfoSync.TOPIC_PROTOCOL and r.priorities:
                for proto in r.priorities:
                    if controller.set_current_for_protocol(proto):
                        break

    return on_result
