"""Bcast: submit aggregated signed duties to the beacon node.

Mirrors ref: core/bcast/bcast.go — type-switch per duty kind, broadcast
delay metrics, and duplicate suppression. The beacon client is duck-typed
(beaconmock in tests, the failover multi-client in production).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from charon_tpu_torch.core.eth2data import SignedData
from charon_tpu_torch.core.types import Duty, DutyType, PubKey


@dataclass
class Broadcaster:
    beacon: object
    clock: object | None = None  # SlotClock for delay metrics

    def __post_init__(self) -> None:
        self.broadcast_total: dict[DutyType, int] = {}
        self.broadcast_delay: list[tuple[Duty, float]] = []
        self.recast_errors = 0  # feeds app/health (ref: recast.go metric)
        self.retried_total = 0  # deadline-aware submit retries
        self._registrations: dict[Duty, dict] = {}
        self._subs: list = []  # post-broadcast hooks (inclusion checker)

    def subscribe(self, sub) -> None:
        """Called with (duty, data_set) after a successful broadcast
        (ref: the inclusion checker subscribes downstream of bcast,
        app/app.go:746-780)."""
        self._subs.append(sub)

    async def _submit(self, duty: Duty, fn, *args) -> None:
        """Submit with deadline-aware retry: a transient BN failure
        (connection reset, timeout, every-endpoint-down) retries with
        jittered exponential backoff (app/expbackoff FAST schedule)
        until the duty's deadline — a flapping BN a few hundred ms
        before recovery must not turn an aggregated signature into a
        missed duty. Without a clock (bare unit-test wiring) the first
        error propagates unchanged."""
        import asyncio

        from charon_tpu_torch.app.expbackoff import FAST_CONFIG, backoff_delay
        from charon_tpu_torch.app.retry import retryable_errors

        attempt = 0
        # wall duty deadline anchored to monotonic ONCE, at entry while
        # the clock is still honest: a host
        # clock step mid-retry must neither abort the remaining window
        # nor retry past the duty deadline
        deadline_mono = (
            None
            if self.clock is None
            else time.monotonic()
            + (self.clock.duty_deadline(duty) - time.time())  # lint: allow(monotonic-clock) — one-shot wall->mono anchor
        )
        while True:
            try:
                return await fn(*args)
            except retryable_errors() as e:
                if deadline_mono is None:
                    raise
                delay = backoff_delay(FAST_CONFIG, attempt)
                if time.monotonic() + delay >= deadline_mono:
                    raise
                if attempt == 0:
                    from charon_tpu_torch.app import log

                    log.warn(
                        "broadcast failed; retrying until duty deadline",
                        topic="bcast",
                        duty=str(duty),
                        err=f"{type(e).__name__}: {e}",
                    )
                self.retried_total += 1
                attempt += 1
                await asyncio.sleep(delay)

    async def broadcast(self, duty: Duty, data_set: dict[PubKey, SignedData]) -> None:
        """ref: core/bcast/bcast.go:42 Broadcast type-switch."""
        for pubkey, signed in data_set.items():
            if duty.type == DutyType.ATTESTER:
                await self._submit(
                    duty, self.beacon.submit_attestation, self._with_sig(signed)
                )
            elif duty.type == DutyType.PROPOSER:
                await self._submit(
                    duty, self.beacon.submit_proposal, signed.payload, signed.signature
                )
            elif duty.type == DutyType.RANDAO:
                pass  # randao is an input to proposals, never broadcast
            elif duty.type == DutyType.BUILDER_REGISTRATION:
                await self._submit(
                    duty, self.beacon.submit_registration, signed.payload, signed.signature
                )
                # merge per pubkey — separate submissions share the duty
                # key (slot 0), and the recaster needs all of them
                merged = dict(self._registrations.get(duty, {}))
                merged.update(data_set)
                self._registrations[duty] = merged
            elif duty.type == DutyType.EXIT:
                await self._submit(
                    duty, self.beacon.submit_exit, signed.payload, signed.signature
                )
            elif duty.type == DutyType.AGGREGATOR:
                await self._submit(
                    duty, self.beacon.submit_aggregate, signed.payload, signed.signature
                )
            elif duty.type == DutyType.SYNC_MESSAGE:
                from dataclasses import replace as _replace

                await self._submit(
                    duty,
                    self.beacon.submit_sync_message,
                    _replace(signed.payload, signature=signed.signature)
                    if hasattr(signed.payload, "signature")
                    else signed.payload,
                )
            elif duty.type == DutyType.SYNC_CONTRIBUTION:
                await self._submit(
                    duty, self.beacon.submit_contribution, signed.payload, signed.signature
                )
            elif duty.type in (
                DutyType.PREPARE_AGGREGATOR,
                DutyType.PREPARE_SYNC_CONTRIBUTION,
            ):
                pass  # selection proofs are inputs to later duties
            else:
                raise ValueError(f"cannot broadcast duty type {duty.type}")
        self.broadcast_total[duty.type] = (
            self.broadcast_total.get(duty.type, 0) + len(data_set)
        )
        if self.clock is not None:
            self.broadcast_delay.append(
                # attribution edge: delay INTO the slot — both terms live
                # on the wall timeline (slots are wall-clock)
                (duty, time.time() - self.clock.slot_start(duty.slot))  # lint: allow(monotonic-clock)
            )
        for sub in self._subs:
            # post-broadcast observers (inclusion checker) are
            # best-effort: the duty IS broadcast by now, and an observer
            # bug must not re-report it failed — nor cascade the error
            # back through the aggregation chain that invoked us
            try:
                await sub(duty, data_set)
            except Exception as e:  # noqa: BLE001
                from charon_tpu_torch.app import log

                log.warn(
                    "post-broadcast subscriber failed",
                    topic="bcast",
                    duty=str(duty),
                    err=f"{type(e).__name__}: {e}",
                )

    def _with_sig(self, signed: SignedData):
        """Attestations carry their signature inline."""
        from dataclasses import replace

        return replace(signed.payload, signature=signed.signature)

    def load_pregen_registrations(self, validators) -> int:
        """Load the lock file's pre-generated builder registrations so the
        recaster re-broadcasts them even when no VC ever submits one
        (ref: core/bcast/recast.go pre-generate path — lock-file
        registrations signed during the DKG, dkg.go:190-194).

        `validators`: the lock's DistributedValidator entries. Returns the
        number loaded."""
        from charon_tpu_torch.eth2util import registration as regmod

        loaded = 0
        self._pregen: list[tuple[object, bytes]] = []
        for dv in validators:
            obj = getattr(dv, "builder_registration", None) or {}
            if not obj.get("message"):
                continue
            reg, sig = regmod.from_lock_json(obj)
            self._pregen.append((reg, sig))
            loaded += 1
        return loaded

    async def recast(self, slot) -> None:
        """Re-broadcast validator registrations every epoch
        (ref: core/bcast/recast.go Recaster; wiring app/app.go:677-743).
        Subscribe to scheduler slots.

        Failures are contained: the scheduler's slot loop has no
        exception isolation, and a transient BN outage at an epoch
        boundary must not kill duty scheduling (the reference's recaster
        logs and carries on)."""
        if slot.slot % slot.slots_per_epoch != 0:
            return
        from charon_tpu_torch.app import log

        async def _submit_one(pubkey, payload, signature) -> None:
            # per-registration isolation: one persistently rejected
            # registration (e.g. a 400 on one pubkey) must not starve
            # every other validator's recast
            try:
                await self.beacon.submit_registration(payload, signature)
            except Exception as e:  # noqa: BLE001 — log-and-continue
                self.recast_errors += 1  # feeds app/health recast check
                log.warn(
                    "registration recast failed",
                    topic="bcast",
                    slot=slot.slot,
                    pubkey=str(pubkey)[:18],
                    err=str(e),
                )

        for duty, data_set in list(self._registrations.items()):
            for pubkey, signed in data_set.items():
                await _submit_one(pubkey, signed.payload, signed.signature)
        # pre-generated registrations from the lock: skip any pubkey
        # the VC has submitted a fresher registration for
        submitted = {
            getattr(signed.payload, "pubkey", None)
            for ds in self._registrations.values()
            for signed in ds.values()
        }
        for reg, sig in getattr(self, "_pregen", []):
            if reg.pubkey in submitted:
                continue
            await _submit_one(reg.pubkey, reg, sig)
