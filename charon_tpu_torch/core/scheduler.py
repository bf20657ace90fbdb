"""Scheduler: slot ticker + per-epoch duty resolution + offset triggers.

Mirrors ref: core/scheduler/scheduler.go — ticks slots from genesis time
and slot duration (scheduler.go:546-548), resolves attester/proposer/sync
duties per epoch from the beacon node (scheduler.go:246), triggers each
duty at its offset into the slot (attester ⅓, aggregator ⅔ —
core/scheduler/offset.go:12-16), and emits slot events to subscribers
(fee-recipient, validator-cache refresh, infosync — ref app/app.go:433+).

asyncio redesign: one ticker task; each duty trigger is its own task (the
reference's goroutine-per-duty, scheduler.go:193). Deterministic tests
inject a fake clock/sleep (the reference injects clockwork + delayFunc,
scheduler.go:27-43).
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Awaitable, Callable

from charon_tpu_torch.core.deadline import SlotClock
from charon_tpu_torch.core.types import Duty, DutyType, PubKey

# Trigger offsets as fractions of the slot (ref: core/scheduler/offset.go).
OFFSETS = {
    DutyType.ATTESTER: 1 / 3,
    DutyType.AGGREGATOR: 2 / 3,
    DutyType.SYNC_CONTRIBUTION: 2 / 3,
    DutyType.PROPOSER: 0.0,
    DutyType.RANDAO: 0.0,
    DutyType.SYNC_MESSAGE: 1 / 3,
}


@dataclass(frozen=True)
class Slot:
    slot: int
    time: float
    slot_duration: float
    slots_per_epoch: int

    @property
    def epoch(self) -> int:
        return self.slot // self.slots_per_epoch

    def is_last_in_epoch(self) -> bool:
        return self.slot % self.slots_per_epoch == self.slots_per_epoch - 1


@dataclass(frozen=True)
class DutyDefinition:
    """What the VC needs to perform a duty (ref: core/types.go
    DutyDefinition — attester definitions carry committee coordinates)."""

    pubkey: PubKey
    validator_index: int
    committee_index: int = 0
    committee_length: int = 1
    committees_at_slot: int = 1
    validator_committee_index: int = 0
    # sync-committee duties: the validator's full set of committee
    # positions (0..511). The workflow currently drives the FIRST
    # position's subcommittee (committee_index/validator_committee_index
    # derive from it); the rest are carried for forward-compat and the
    # scheduler logs when a validator holds more than one seat.
    sync_committee_positions: tuple = ()


DutiesSub = Callable[[Duty, dict[PubKey, DutyDefinition]], Awaitable[None]]
SlotSub = Callable[[Slot], Awaitable[None]]


class Scheduler:
    """beacon: duck-typed beacon client (testutil/beaconmock or the real
    multi-client); validators: pubkey -> validator index map."""

    def __init__(
        self,
        beacon,
        clock: SlotClock,
        validators: dict[PubKey, int],
        slots_per_epoch: int = 32,
        # wall clock by design: the slot ticker follows the chain's
        # wall-clock schedule (genesis arithmetic) — skew tests inject
        now: Callable[[], float] = time.time,  # lint: allow(monotonic-clock)
        sleep: Callable[[float], Awaitable[None]] = asyncio.sleep,
    ) -> None:
        self.beacon = beacon
        self.clock = clock
        self.validators = dict(validators)
        self.slots_per_epoch = slots_per_epoch
        self._now = now
        self._sleep = sleep
        self._duty_subs: list[DutiesSub] = []
        self._slot_subs: list[SlotSub] = []
        # epoch -> duty -> pubkey -> definition
        self._defs: dict[int, dict[Duty, dict[PubKey, DutyDefinition]]] = {}
        self._stop = asyncio.Event()
        self._tasks: set[asyncio.Task] = set()

    def subscribe_duties(self, sub: DutiesSub) -> None:
        self._duty_subs.append(sub)

    def subscribe_slots(self, sub: SlotSub) -> None:
        self._slot_subs.append(sub)

    def get_duty_definition(self, duty: Duty) -> dict[PubKey, DutyDefinition]:
        """ref: core/scheduler/scheduler.go:142 GetDutyDefinition."""
        epoch = duty.slot // self.slots_per_epoch
        return dict(self._defs.get(epoch, {}).get(duty, {}))

    # -- lifecycle --------------------------------------------------------

    def stop(self) -> None:
        self._stop.set()
        for t in self._tasks:
            t.cancel()

    def reset(self) -> None:
        """Clear a previous stop() so run() can be re-entered — the
        RESTART boundary owns this, not run() itself: clearing inside
        run() would erase a stop() issued between task creation and the
        task's first execution, leaving the node unstoppable."""
        self._stop.clear()

    async def run(self) -> None:
        """Tick slots until stopped (ref: scheduler.go:97 Run). Waits for
        beacon sync first, retrying single-shot probes (ref:
        scheduler.go:678 waitBeaconSync).

        Re-runnable after stop() + reset(): a crashed-then-restarted
        node calls run() again on the same wired components
        (crash/recover scenarios; ref: charon's crash-only model
        restarts the whole wiring, the asyncio analogue restarts the
        tick loop)."""
        while not self._stop.is_set():
            try:
                await self.beacon.await_synced()
                break
            except Exception:
                await asyncio.sleep(5)
        while not self._stop.is_set():
            now = self._now()
            slot_no = self.clock.slot_at(now)
            start = self.clock.slot_start(slot_no)
            if start + self.clock.slot_duration <= now:
                slot_no += 1
                start = self.clock.slot_start(slot_no)
            if start > now:
                await self._sleep(start - now)
            if self._stop.is_set():
                return
            await self._handle_slot(
                Slot(
                    slot=slot_no,
                    time=start,
                    slot_duration=self.clock.slot_duration,
                    slots_per_epoch=self.slots_per_epoch,
                )
            )
            # sleep to next slot start
            next_start = self.clock.slot_start(slot_no + 1)
            delta = next_start - self._now()
            if delta > 0:
                await self._sleep(delta)

    async def _handle_slot(self, slot: Slot) -> None:
        for sub in self._slot_subs:
            # slot observers (inclusion checker, infosync, recaster) are
            # isolated: one observer hitting a flaky BN must not kill
            # the duty tick loop for every remaining slot
            try:
                await sub(slot)
            except Exception as e:  # noqa: BLE001
                from charon_tpu_torch.app import log

                log.warn(
                    "slot subscriber failed",
                    topic="scheduler",
                    slot=slot.slot,
                    err=f"{type(e).__name__}: {e}",
                )
        try:
            await self._resolve_epoch(slot.epoch)
        except Exception as e:  # noqa: BLE001 — degraded: retry next slot
            from charon_tpu_torch.app import log

            log.warn(
                "epoch duty resolution failed; retrying next slot",
                topic="scheduler",
                epoch=slot.epoch,
                err=f"{type(e).__name__}: {e}",
            )
        duties = self._defs.get(slot.epoch, {})
        for duty, defs in duties.items():
            if duty.slot != slot.slot:
                continue
            self._spawn(self._trigger(slot, duty, defs))

    def _spawn(self, coro) -> None:
        task = asyncio.create_task(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _trigger(self, slot: Slot, duty: Duty, defs) -> None:
        """Goroutine-per-duty analogue (ref: scheduler.go:172-214): wait to
        the duty's offset into the slot, then emit."""
        offset = OFFSETS.get(duty.type, 0.0) * slot.slot_duration
        delay = slot.time + offset - self._now()
        if delay > 0:
            await self._sleep(delay)
        for sub in self._duty_subs:
            await sub(duty, dict(defs))

    async def _resolve_epoch(self, epoch: int) -> None:
        """Fetch duty definitions for the epoch once (ref: scheduler.go:246
        resolveDuties)."""
        if epoch in self._defs:
            return
        out: dict[Duty, dict[PubKey, DutyDefinition]] = {}
        att = await self.beacon.attester_duties(epoch, self.validators)
        for ad in att:
            duty = Duty(ad["slot"], DutyType.ATTESTER)
            out.setdefault(duty, {})[ad["pubkey"]] = DutyDefinition(
                pubkey=ad["pubkey"],
                validator_index=ad["validator_index"],
                committee_index=ad["committee_index"],
                committee_length=ad["committee_length"],
                committees_at_slot=ad["committees_at_slot"],
                validator_committee_index=ad["validator_committee_index"],
            )
        prop = await self.beacon.proposer_duties(epoch, self.validators)
        for pd in prop:
            duty = Duty(pd["slot"], DutyType.PROPOSER)
            out.setdefault(duty, {})[pd["pubkey"]] = DutyDefinition(
                pubkey=pd["pubkey"],
                validator_index=pd["validator_index"],
            )
        # Aggregator duties mirror attester duties at the ⅔-slot offset —
        # every attester is a potential aggregator; actual selection is
        # decided by the aggregated selection proof (ref: scheduler
        # resolveAttDuties also schedules DutyAggregator,
        # core/scheduler/scheduler.go:246+).
        for duty, defs in [
            (d, v) for d, v in out.items() if d.type == DutyType.ATTESTER
        ]:
            out[Duty(duty.slot, DutyType.AGGREGATOR)] = dict(defs)
        # Sync-committee membership spans the epoch: one SYNC_MESSAGE and
        # one SYNC_CONTRIBUTION duty per slot for each member
        # (ref: scheduler.go resolveSyncCommDuties).
        if hasattr(self.beacon, "sync_duties"):
            sync = await self.beacon.sync_duties(epoch, self.validators)
            for slot in range(
                epoch * self.slots_per_epoch, (epoch + 1) * self.slots_per_epoch
            ):
                for sd in sync:
                    # membership is a committee POSITION (0..511); the
                    # subcommittee and the bit inside it derive from it
                    # (spec duty shape: validator_sync_committee_indices)
                    positions = [
                        int(p)
                        for p in sd.get("sync_committee_indices", [])
                    ] or [int(sd.get("subcommittee_index", 0)) * 128]
                    if len(positions) > 1 and slot % self.slots_per_epoch == 0:
                        from charon_tpu_torch.app import log

                        log.warn(
                            "validator holds multiple sync-committee "
                            "seats; only the first position's "
                            "subcommittee is driven",
                            topic="sched",
                            validator=sd["validator_index"],
                            positions=positions,
                        )
                    d = DutyDefinition(
                        pubkey=sd["pubkey"],
                        validator_index=sd["validator_index"],
                        committee_index=positions[0] // 128,
                        validator_committee_index=positions[0] % 128,
                        sync_committee_positions=tuple(positions),
                    )
                    out.setdefault(
                        Duty(slot, DutyType.SYNC_MESSAGE), {}
                    )[sd["pubkey"]] = d
                    out.setdefault(
                        Duty(slot, DutyType.SYNC_CONTRIBUTION), {}
                    )[sd["pubkey"]] = d
        self._defs[epoch] = out
        # keep two epochs of definitions
        for old in [e for e in self._defs if e < epoch - 1]:
            del self._defs[old]
