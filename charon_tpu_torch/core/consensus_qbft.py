"""QBFT consensus adapter: binds the pure engine to the duty workflow.

Mirrors ref: core/consensus/qbft — consensus runs over 32-byte value
hashes with the actual unsigned-data sets carried alongside in a
values-by-hash cache (ref: core/consensus/qbft/transport.go:63-90), a
deterministic round-robin leader (ref qbft.go:706), and per-duty engine
instances started by propose/participate (ref qbft.go:247,317).

The in-memory transport is the simnet path; the p2p transport (signed
protobuf messages) plugs into the same MsgNet interface.
"""

from __future__ import annotations

import asyncio
import hashlib
from typing import Awaitable, Callable

from charon_tpu_torch.core import qbft
from charon_tpu_torch.core.types import Duty, PubKey

DecidedSub = Callable[[Duty, dict[PubKey, object]], Awaitable[None]]


def value_hash(unsigned_set: dict[PubKey, object]) -> bytes:
    """Canonical hash of an unsigned duty data set: consensus agrees on
    hashes, values travel out-of-band (ref: transport.go:63 values-by-hash).
    Frozen dataclasses repr deterministically."""
    items = sorted(unsigned_set.items())
    return hashlib.sha256(repr(items).encode()).digest()


class MemMsgNet:
    """In-memory QBFT message fabric for one cluster: routes engine
    messages and replicates the value cache (simnet only — production uses
    the signed p2p transport)."""

    def __init__(self) -> None:
        self.nodes: list["QBFTConsensus"] = []

    def attach(self, node: "QBFTConsensus") -> int:
        self.nodes.append(node)
        return len(self.nodes) - 1

    async def broadcast(
        self,
        from_idx: int,
        duty: Duty,
        msg: qbft.Msg,
        values,
        tctx: str | None = None,
    ) -> None:
        # simulated network boundary: see parsigex.MemTransport.send
        from charon_tpu_torch.app.tracer import detached

        for node in self.nodes:
            if node.node_idx != from_idx:
                with detached():
                    node.deliver(duty, msg, values, tctx=tctx, sender=from_idx)


class QBFTConsensus:
    protocol_id = "qbft/2.0.0"

    def __init__(
        self,
        net: MemMsgNet,
        nodes: int,
        round_timeout: float = 0.75,
        round_increase: float = 0.25,
        privkey=None,
        pubkeys: list[bytes] | None = None,
        gater=None,
        timer: str | None = None,
        linear_round_inc: float = qbft.LINEAR_ROUND_INC,
        tracer=None,  # app/tracer.Tracer; None = process-global
        evidence=None,  # core/evidence.EvidenceRegistry; None = unrecorded
    ) -> None:
        """`privkey`/`pubkeys` enable per-message k1 authentication
        (ref: core/consensus/qbft/transport.go:25-50 signs every msg,
        qbft.go:561 verifies each incl. piggybacked justifications). When
        provided, every outbound message is signed over qbft.msg_digest and
        every inbound message — and each of its justification messages — is
        verified against the per-index cluster pubkeys before the engine
        counts it.

        `timer` selects the round-timer strategy: "inc" (increasing,
        configured by round_timeout/round_increase) or "eager_dlinear"
        (double-eager-linear, configured by linear_round_inc). None picks
        per the EAGER_DOUBLE_LINEAR feature flag, mirroring
        ref: core/consensus/utils/roundtimer.go:26-37 GetTimerFunc +
        app/featureset/featureset.go:53 (stable → dlinear is the
        cluster default)."""
        self.net = net
        self.node_idx = net.attach(self)
        self.tracer = tracer
        self._privkey = privkey
        self._pubkeys = pubkeys
        # Byzantine-evidence ledger (core/evidence.EvidenceRegistry):
        # engine detections land here attributed by SHARE index (the
        # cluster-wide peer convention: share = engine node idx + 1).
        self.evidence = evidence
        # Duty gater: without it, deliver() would create transports and
        # value caches for ANY duty a byzantine-but-authenticated peer
        # names — unbounded memory (ref: consensus also gates inbound
        # duties, core/consensus/qbft/qbft.go handle()).
        self._gater = gater

        def leader(instance, rnd: int) -> int:
            """Deterministic round-robin (ref: qbft.go:706)."""
            h = int.from_bytes(
                hashlib.sha256(repr(instance).encode()).digest()[:8], "big"
            )
            return (h + rnd) % nodes

        def sign_msg(m: qbft.Msg) -> qbft.Msg:
            if privkey is None:
                return m
            from dataclasses import replace

            from charon_tpu_torch.app import k1util

            return replace(
                m, signature=k1util.sign(privkey, qbft.msg_digest(m))
            )

        def is_valid(m: qbft.Msg) -> bool:
            if pubkeys is None:
                return True
            return self._verify_msg(m, check_justification=True)

        def verify_sender(m: qbft.Msg) -> bool:
            # outer signature only — the engine uses this to attribute
            # evidence (forged justifications, floods) to the sender
            if pubkeys is None:
                return True
            return self._verify_msg(m, check_justification=False)

        def on_evidence(source: int, kind: str) -> None:
            if self.evidence is not None:
                self.evidence.record(source + 1, kind)

        if timer is None:
            from charon_tpu_torch.app import featureset

            timer = (
                "eager_dlinear"
                if featureset.enabled(featureset.Feature.EAGER_DOUBLE_LINEAR)
                else "inc"
            )
        if timer == "eager_dlinear":
            new_timer = lambda: qbft.DoubleEagerLinearRoundTimer(  # noqa: E731
                linear_round_inc
            )
        elif timer == "inc":
            new_timer = lambda: qbft.IncreasingRoundTimer(  # noqa: E731
                round_timeout, round_increase
            )
        else:
            raise ValueError(f"unknown round timer strategy: {timer}")
        self.timer_type = timer

        self.defn = qbft.Definition(
            nodes=nodes,
            leader=leader,
            # per-instance round timer, strategy selected above
            # (ref: core/consensus/utils/roundtimer.go:26-37)
            new_timer=new_timer,
            is_valid=is_valid,
            sign_msg=sign_msg,
            verify_sender=verify_sender,
            on_evidence=on_evidence,
        )
        self._subs: list[DecidedSub] = []
        # Consensus sniffer: bounded ring of recent message summaries
        # (in/out), served at /debug/consensus for post-mortem debugging
        # (ref: core/consensus/qbft/sniffer.go buffers instances for the
        # debugger endpoint, docs/consensus.md:74).
        from collections import deque

        self._sniffer: deque = deque(maxlen=512)
        # Per-duty values-by-hash cache: messages for one instance carry
        # only that instance's candidate values (ref: transport.go:63-90
        # keeps values per consensus instance, not globally).
        self._values: dict[Duty, dict[bytes, dict[PubKey, object]]] = {}
        self._instances: dict[Duty, qbft.Transport] = {}
        self._running: dict[Duty, asyncio.Task] = {}
        self._decided: set[Duty] = set()
        # most recent decide's {duty, round, duration, timer} + optional
        # observer (run.py wires it into the metrics catalogue)
        self.last_decided: dict | None = None
        self.on_decided_stats = None
        # flight-recorder edge: fired from the sniffer for
        # every ROUND_CHANGE observed in either direction —
        # on_round_change(duty, round, source, direction)
        self.on_round_change = None

    def subscribe(self, sub: DecidedSub) -> None:
        self._subs.append(sub)

    def _verify_msg(self, m: qbft.Msg, check_justification: bool) -> bool:
        """Signature check against the sender's cluster pubkey; recurses
        into justification messages so a byzantine leader cannot fabricate
        quorums of piggybacked ROUND-CHANGE/PREPARE messages
        (ref: core/consensus/qbft/qbft.go:561)."""
        from charon_tpu_torch.app import k1util

        if not (0 <= m.source < len(self._pubkeys)):
            return False
        if not k1util.verify_bytes(
            self._pubkeys[m.source], qbft.msg_digest(m), m.signature
        ):
            return False
        if check_justification:
            for j in m.justification:
                if not self._verify_msg(j, check_justification=False):
                    return False
        return True

    # -- engine plumbing ---------------------------------------------------

    def _transport(self, duty: Duty) -> qbft.Transport:
        tr = self._instances.get(duty)
        if tr is None:

            async def bcast(msg: qbft.Msg) -> None:
                self._sniff("out", duty, msg)
                # frame carries the sender's trace context so follower
                # nodes' message-handling spans join this duty trace
                from charon_tpu_torch.app.tracer import encode_ctx

                await self.net.broadcast(
                    self.node_idx,
                    duty,
                    msg,
                    dict(self._values.get(duty, {})),
                    tctx=encode_ctx(),
                )

            tr = qbft.Transport(bcast)
            self._instances[duty] = tr
        return tr

    def deliver(
        self,
        duty: Duty,
        msg: qbft.Msg,
        values,
        tctx: str | None = None,
        sender: int | None = None,
    ) -> None:
        """Incoming message from the fabric; values-by-hash cache merge.

        Each received value is re-hashed and inserted only under its
        *recomputed* key, and existing entries are never overwritten — a
        peer cannot bind a decided hash to substituted duty data
        (ref: core/consensus/qbft/qbft.go valuesByHash recomputes).

        `sender` is the CHANNEL identity (the authenticated node index
        the frame arrived from), distinct from msg.source (the signer's
        claim). Nodes only broadcast their own top-level messages, so a
        frame whose source differs from its channel — or whose instance
        differs from the duty it was delivered under — is a replay or
        spoof by the CHANNEL peer: the one attribution the engine itself
        cannot make, because a replayed message carries the original
        (possibly honest) signer's source. Dropped before any engine or
        cache state is touched, evidence named to the channel.

        `tctx` is the sending node's propagated trace context: the
        message-handling span joins the sender's duty trace, which is
        how a follower's consensus work appears in the proposer's
        cross-node timeline. Malformed tctx decodes to None (fresh
        duty-rooted span) — frame corruption never crashes delivery."""
        if self._gater is not None and not self._gater(duty):
            return
        if sender is not None and (
            msg.source != sender or msg.instance != duty
        ):
            if self.evidence is not None:
                self.evidence.record(sender + 1, "qbft_replay")
            return
        from charon_tpu_torch.app.tracer import parse_ctx, span

        with span(
            "qbft.deliver",
            duty=duty,
            tracer=self.tracer,
            remote=parse_ctx(tctx),
            msg_type=getattr(msg.type, "name", str(msg.type)),
            round=msg.round,
            source=msg.source,
        ):
            self._sniff("in", duty, msg)
            # Inbox first: if the sender is over its per-source buffer
            # bound, its value payloads are dropped too — otherwise the
            # cache merge would be an unbounded-memory side channel
            # around the bound.
            if not self._transport(duty).receive(msg):
                return
            cache = self._values.setdefault(duty, {})
            # One honest node contributes one candidate value per
            # instance, so an honest cache never exceeds n entries; cap
            # at 2n.
            max_values = 2 * self.defn.nodes
            for v in values.values():
                if len(cache) >= max_values:
                    break
                try:
                    rh = value_hash(v)
                except Exception:
                    continue
                cache.setdefault(rh, v)

    def _sniff(self, direction: str, duty: Duty, msg: qbft.Msg) -> None:
        import time as _time

        self._sniffer.append(
            {
                # debug-sniffer timestamp: a logging edge operators
                # correlate with wall-clock log lines, never math
                "ts": round(_time.time(), 3),  # lint: allow(monotonic-clock)
                "dir": direction,
                "duty": str(duty),
                "type": getattr(msg.type, "name", str(msg.type)),
                "round": msg.round,
                "source": msg.source,
                "value": (
                    msg.value.hex()[:16]
                    if isinstance(msg.value, bytes)
                    else (str(msg.value)[:16] if msg.value is not None else None)
                ),
                "justification": len(msg.justification or ()),
            }
        )
        mtype = getattr(msg.type, "name", str(msg.type))
        if mtype == "ROUND_CHANGE" and self.on_round_change is not None:
            try:
                self.on_round_change(duty, msg.round, msg.source, direction)
            except Exception:  # noqa: BLE001 — observability must not break delivery
                pass

    def debug_dump(self) -> list[dict]:
        """Recent consensus messages, oldest first (served at
        /debug/consensus; ref: docs/consensus.md:74)."""
        return list(self._sniffer)

    def _ensure_running(self, duty: Duty, value_hash_or_none) -> asyncio.Task:
        task = self._running.get(duty)
        if task is None:
            tr = self._transport(duty)
            task = asyncio.create_task(
                self._run_instance(duty, tr, value_hash_or_none)
            )
            self._running[duty] = task
        return task

    async def _run_instance(self, duty: Duty, tr: qbft.Transport, vhash) -> None:
        import time as _time

        stats: dict = {}
        t0 = _time.monotonic()
        decided_hash = await qbft.run(
            self.defn, tr, duty, self.node_idx, vhash, stats=stats
        )
        if duty in self._decided:
            return
        self._decided.add(duty)
        # decided round + wall duration per timer strategy (ref:
        # consensus metrics ObserveConsensusDuration / SetDecidedRounds
        # labelled by timer type)
        self.last_decided = {
            "duty": duty,
            "round": stats.get("round", 0),
            "duration": _time.monotonic() - t0,
            "timer": self.timer_type,
        }
        if self.on_decided_stats is not None:
            self.on_decided_stats(self.last_decided)
        unsigned_set = self._values.get(duty, {}).get(decided_hash)
        if unsigned_set is None:
            raise RuntimeError(
                f"decided hash with no value in cache for {duty}"
            )
        for sub in self._subs:
            await sub(duty, unsigned_set)

    def trim(self, duty: Duty) -> None:
        """Drop instance state for an expired duty (Deadliner hook)."""
        self._values.pop(duty, None)
        self._instances.pop(duty, None)
        task = self._running.pop(duty, None)
        if task is not None and not task.done():
            task.cancel()
        self._decided.discard(duty)

    # -- workflow API ------------------------------------------------------

    async def propose(self, duty: Duty, unsigned_set: dict[PubKey, object]) -> None:
        """ref: core/consensus/qbft/qbft.go:247 Propose."""
        vhash = value_hash(unsigned_set)
        self._values.setdefault(duty, {})[vhash] = unsigned_set
        task = self._ensure_running(duty, vhash)
        await asyncio.shield(task)

    async def participate(self, duty: Duty) -> None:
        """Join the instance without a proposal
        (ref: core/consensus/qbft/qbft.go:317 Participate)."""
        self._ensure_running(duty, None)
