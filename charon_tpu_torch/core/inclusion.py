"""Inclusion checker: did broadcast duties actually land on-chain?

Mirrors ref: core/tracker/inclusion.go — every submitted attestation,
aggregate and block proposal is tracked; the checker trails the head by
INCL_CHECK_LAG slots (reorg mitigation) and inspects each block for the
submission (attestation-data root + covered aggregation bits for
attestations, the block root itself for proposals). Submissions found
are reported included (with the inclusion delay); submissions still
pending after INCL_MISSED_LAG slots are reported missed. Synthetic
proposals (fabricated by the SyntheticProposer wrapper and swallowed at
submit) are reported included immediately — they have no on-chain
footprint and must not surface as false misses (ref: inclusion.go:80
Submitted's IsSyntheticProposal branch). Wiring mirrors
app/app.go:746-780: subscribes downstream of the broadcaster and on the
scheduler's slot ticks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Awaitable, Callable

from charon_tpu_torch.core.types import Duty, DutyType, PubKey

# ref: core/tracker/inclusion.go:28 InclCheckLag — blocks are inspected
# only once they are this many slots deep, so a short reorg cannot make
# the checker mis-report (6 covers almost all PoS reorgs).
INCL_CHECK_LAG = 6

# ref: core/tracker/inclusion.go:33 InclMissedLag — a duty still pending
# this many slots after its slot is declared missed and dropped.
INCL_MISSED_LAG = 32

# Duty types the checker can observe on-chain. Everything else (randao,
# selection proofs, exits, registrations) has no per-block footprint
# (ref: inclusion.go only tracks attestations/aggregates/blocks).
_TRACKED = (DutyType.ATTESTER, DutyType.AGGREGATOR, DutyType.PROPOSER)


@dataclass(frozen=True)
class InclusionReport:
    duty: Duty
    pubkey: PubKey
    included: bool
    delay_slots: int  # block slot - duty slot when included, else -1
    # seconds from slot start to broadcast, when a clock was provided
    # (ref: inclusion.go submission.Delay in every report log line)
    broadcast_delay: float | None = None
    # fabricated duty with no on-chain footprint, reported included at
    # submit time (ref: inclusion.go Submitted synthetic branch)
    synthetic: bool = False


ReportSub = Callable[[InclusionReport], Awaitable[None] | None]


@dataclass
class _Pending:
    duty: Duty
    pubkey: PubKey
    att_data_root: bytes | None  # attester/aggregator match key
    agg_bits: tuple[bool, ...]  # bits our submission covered
    block_root: bytes | None  # proposer match key
    broadcast_delay: float | None = None


def _is_synthetic_block(payload) -> bool:
    """Fabricated proposal from the SyntheticProposer wrapper — detected
    structurally (the wrapper tags dict proposals) so core never imports
    app (ref: app/eth2wrap/synthproposer.go marks via graffiti)."""
    if isinstance(payload, dict):
        return bool(payload.get("synthetic"))
    return bool(getattr(payload, "synthetic", False))


class InclusionChecker:
    """beacon duck-type requirements (provided by BeaconMock and the
    production client): `block_attestations(slot) -> list | None` (None =
    no block at that slot) and `block_root(slot) -> bytes | None`.

    `check_lag`/`missed_lag` default to the reference's production
    constants; tests shrink them to drive scenarios quickly. `clock`
    (optional, `slot_start(slot) -> epoch seconds`) stamps each report
    with the broadcast delay."""

    def __init__(
        self,
        beacon,
        on_report: ReportSub | None = None,
        check_lag: int = INCL_CHECK_LAG,
        missed_lag: int = INCL_MISSED_LAG,
        clock=None,
    ) -> None:
        self.beacon = beacon
        self.check_lag = check_lag
        self.missed_lag = missed_lag
        self.clock = clock
        self._pending: list[_Pending] = []
        self._subs: list[ReportSub] = list(filter(None, [on_report]))
        self._checked_until: int | None = None
        self.included_total = 0
        self.missed_total = 0
        self.inclusion_delay_sum = 0

    def subscribe(self, sub: ReportSub) -> None:
        self._subs.append(sub)

    # -- intake: wire after broadcaster.broadcast -------------------------

    async def submitted(self, duty: Duty, data_set) -> None:
        """Record broadcast signed duties (ref: inclusion.go Submitted)."""
        if duty.type not in _TRACKED:
            return
        delay = None
        if self.clock is not None:
            import time as _time

            # attribution edge: inclusion delay vs the slot's wall-clock
            # start — both terms live on the wall timeline
            delay = _time.time() - self.clock.slot_start(duty.slot)  # lint: allow(monotonic-clock)
        for pubkey, signed in data_set.items():
            att_root = None
            bits: tuple[bool, ...] = ()
            block_root = None
            payload = getattr(signed, "payload", signed)
            if duty.type == DutyType.ATTESTER:
                att_root = payload.data.hash_tree_root()
                bits = tuple(payload.aggregation_bits)
            elif duty.type == DutyType.AGGREGATOR:
                # payload is an AggregateAndProof carrying .aggregate
                agg = getattr(payload, "aggregate", payload)
                att_root = agg.data.hash_tree_root()
                bits = tuple(agg.aggregation_bits)
            elif duty.type == DutyType.PROPOSER:
                if _is_synthetic_block(payload):
                    # swallowed at submit, never on-chain: report
                    # included NOW or it would surface as a false miss
                    # 32 slots later (ref: inclusion.go:80 Submitted)
                    self.included_total += 1
                    await self._report(
                        InclusionReport(
                            duty,
                            pubkey,
                            included=True,
                            delay_slots=0,
                            broadcast_delay=delay,
                            synthetic=True,
                        )
                    )
                    continue
                block_root = payload.hash_tree_root()
            self._pending.append(
                _Pending(
                    duty=duty,
                    pubkey=pubkey,
                    att_data_root=att_root,
                    agg_bits=bits,
                    block_root=block_root,
                    broadcast_delay=delay,
                )
            )

    # -- per-slot check: subscribe to scheduler slot ticks ----------------

    async def on_slot(self, slot) -> None:
        """Check blocks trailing the current slot by `check_lag` (reorg
        mitigation, ref: inclusion.go:28 and its Run loop checking slot
        head-lag each tick): at slot N's tick the newest block inspected
        is N - check_lag, by which point the slot-N duty's submissions
        exist and short reorgs have settled. Then expire submissions
        past `missed_lag`."""
        current = slot.slot
        newest = current - self.check_lag
        if not self._pending:
            # idle: nothing to look for — skip the beacon round-trips
            # entirely rather than polling every slot forever
            self._checked_until = newest
            return
        start = self._checked_until
        if start is None:
            start = newest - 1
        for s in range(start + 1, newest + 1):
            await self._check_block(s)
        self._checked_until = max(start, newest)

        still = []
        for p in self._pending:
            # expire against the CHECKED frontier, not the head: blocks
            # are only inspected up to `newest`, so expiring at
            # head - missed_lag would falsely miss inclusions landing in
            # the last check_lag slots of the window
            if newest - p.duty.slot > self.missed_lag:
                await self._report(
                    InclusionReport(
                        p.duty,
                        p.pubkey,
                        included=False,
                        delay_slots=-1,
                        broadcast_delay=p.broadcast_delay,
                    )
                )
                self.missed_total += 1
            else:
                still.append(p)
        self._pending = still

    async def _check_block(self, block_slot: int) -> None:
        # fetch only what the pending submissions actually need
        atts = (
            await self.beacon.block_attestations(block_slot)
            if any(p.att_data_root is not None for p in self._pending)
            else None
        )
        root = (
            await self.beacon.block_root(block_slot)
            if any(p.block_root is not None for p in self._pending)
            else None
        )
        if atts is None and root is None:
            return  # no block this slot
        by_root: dict[bytes, list] = {}
        for att in atts or []:
            by_root.setdefault(att.data.hash_tree_root(), []).append(att)

        still = []
        for p in self._pending:
            hit = False
            if p.att_data_root is not None:
                for att in by_root.get(p.att_data_root, []):
                    chain_bits = tuple(att.aggregation_bits)
                    ours = tuple(p.agg_bits)
                    if all(
                        not mine or (i < len(chain_bits) and chain_bits[i])
                        for i, mine in enumerate(ours)
                    ):
                        hit = True
                        break
            elif p.block_root is not None:
                hit = block_slot == p.duty.slot and root == p.block_root
            if hit:
                delay = block_slot - p.duty.slot
                self.included_total += 1
                self.inclusion_delay_sum += delay
                await self._report(
                    InclusionReport(
                        p.duty,
                        p.pubkey,
                        included=True,
                        delay_slots=delay,
                        broadcast_delay=p.broadcast_delay,
                    )
                )
            else:
                still.append(p)
        self._pending = still

    async def _report(self, report: InclusionReport) -> None:
        for sub in self._subs:
            res = sub(report)
            if hasattr(res, "__await__"):
                await res
