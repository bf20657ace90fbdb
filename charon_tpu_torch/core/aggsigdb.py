"""AggSigDB: store of aggregated (group) signatures for later queries.

Two implementations behind the AGG_SIG_DB_V2 feature flag, mirroring the
reference's rollout pair (ref: core/aggsigdb/memory.go command-loop
design as the default, memory_v2.go simpler-locking design behind
app/featureset/featureset.go:56 AggSigDBV2, selected at wiring time in
app/app.go) — randao reveals are awaited by the proposal fetcher,
selection proofs by the aggregator fetcher. Both are trimmed by the
Deadliner and fail outstanding waiters at duty expiry.
"""

from __future__ import annotations

import asyncio
from collections import defaultdict

from charon_tpu_torch.core.eth2data import SignedData
from charon_tpu_torch.core.types import Duty, PubKey


class DutyExpiredError(Exception):
    """The duty's deadline passed before its aggregate arrived."""


def new_agg_sigdb():
    """Implementation selected by the AGG_SIG_DB_V2 feature flag
    (ref: app wiring picks memory_v2 only when the alpha flag is on)."""
    from charon_tpu_torch.app import featureset

    if featureset.enabled(featureset.Feature.AGG_SIG_DB_V2):
        return AggSigDBV2()
    return AggSigDBLoop()


class AggSigDBV2:
    def __init__(self) -> None:
        self._values: dict[tuple[Duty, PubKey], SignedData] = {}
        self._waiters: dict[tuple[Duty, PubKey], list[asyncio.Future]] = (
            defaultdict(list)
        )

    async def store(self, duty: Duty, pubkey: PubKey, data: SignedData) -> None:
        key = (duty, pubkey)
        prev = self._values.get(key)
        if prev is not None:
            if prev.signature != data.signature:
                raise ValueError(f"conflicting aggregate for {key}")
            return
        self._values[key] = data
        for fut in self._waiters.pop(key, []):
            if not fut.done():
                fut.set_result(data)

    async def store_set(self, duty: Duty, data_set: dict[PubKey, SignedData]) -> None:
        for pubkey, data in data_set.items():
            await self.store(duty, pubkey, data)

    async def await_(self, duty: Duty, pubkey: PubKey) -> SignedData:
        key = (duty, pubkey)
        if key in self._values:
            return self._values[key]
        fut = asyncio.get_running_loop().create_future()
        self._waiters[key].append(fut)
        return await fut

    def trim(self, expired: Duty) -> None:
        """Drop stored values AND fail outstanding waiters for the duty:
        a VC request awaiting an aggregate that never formed must error
        at duty expiry, not hang until its HTTP timeout (ref: the
        deadliner trim path errors queued queries, memory_v2.go)."""
        self._values = {
            k: v for k, v in self._values.items() if k[0] != expired
        }
        for key in [k for k in self._waiters if k[0] == expired]:
            for fut in self._waiters.pop(key, []):
                if not fut.done():
                    fut.set_exception(
                        DutyExpiredError(
                            f"duty expired before aggregate arrived: {key[0]}"
                        )
                    )


class AggSigDBLoop:
    """Command-loop variant: every mutation and query is a command
    consumed by ONE actor task, so state is touched from a single
    coroutine and blocked queries are parked and retried after each
    write (ref: core/aggsigdb/memory.go — the original
    channel-serialized design; our actor task is the asyncio analogue
    of its run() goroutine + command channels).

    Same API and semantics as AggSigDBV2: identical-store idempotence,
    ValueError on a conflicting aggregate, DutyExpiredError for waiters
    of a trimmed duty."""

    def __init__(self) -> None:
        self._cmds: asyncio.Queue = asyncio.Queue()
        self._values: dict[tuple[Duty, PubKey], SignedData] = {}
        # parked queries awaiting a value: key -> futures
        self._parked: dict[tuple[Duty, PubKey], list[asyncio.Future]] = (
            defaultdict(list)
        )
        self._task: asyncio.Task | None = None

    def _ensure_loop(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(
                self._run(), name="aggsigdb-loop"
            )

    async def _run(self) -> None:
        while True:
            op, *args = await self._cmds.get()
            if op == "store":
                key, data, done = args
                prev = self._values.get(key)
                if prev is not None:
                    # done() guards: a timed-out caller may have
                    # cancelled its ack future while the command sat in
                    # the queue — resolving it would InvalidStateError
                    # and kill the actor task
                    if prev.signature != data.signature:
                        if not done.done():
                            done.set_exception(
                                ValueError(
                                    f"conflicting aggregate for {key}"
                                )
                            )
                    elif not done.done():
                        done.set_result(None)
                    continue
                self._values[key] = data
                for fut in self._parked.pop(key, []):
                    if not fut.done():
                        fut.set_result(data)
                if not done.done():
                    done.set_result(None)
            elif op == "query":
                key, fut = args
                value = self._values.get(key)
                if value is not None:
                    if not fut.done():  # caller may have timed out
                        fut.set_result(value)
                else:
                    self._parked[key].append(fut)
            elif op == "trim":
                (expired,) = args
                self._values = {
                    k: v for k, v in self._values.items() if k[0] != expired
                }
                for key in [k for k in self._parked if k[0] == expired]:
                    for fut in self._parked.pop(key, []):
                        if not fut.done():
                            fut.set_exception(
                                DutyExpiredError(
                                    "duty expired before aggregate "
                                    f"arrived: {key[0]}"
                                )
                            )

    async def store(self, duty: Duty, pubkey: PubKey, data: SignedData) -> None:
        self._ensure_loop()
        done = asyncio.get_running_loop().create_future()
        self._cmds.put_nowait(("store", (duty, pubkey), data, done))
        await done

    async def store_set(self, duty: Duty, data_set: dict[PubKey, SignedData]) -> None:
        for pubkey, data in data_set.items():
            await self.store(duty, pubkey, data)

    async def await_(self, duty: Duty, pubkey: PubKey) -> SignedData:
        self._ensure_loop()
        fut = asyncio.get_running_loop().create_future()
        self._cmds.put_nowait(("query", (duty, pubkey), fut))
        return await fut

    def trim(self, expired: Duty) -> None:
        # Deadliner hook runs inside the event loop, so the actor task
        # exists whenever there is anything to trim; a pre-loop trim is
        # a no-op on empty state.
        self._cmds.put_nowait(("trim", expired))
        if self._task is None or self._task.done():
            try:
                self._ensure_loop()
            except RuntimeError:
                pass  # no running loop: nothing stored yet either


# Historical name: the mutex/keyed-futures design was this framework's
# first implementation.
AggSigDB = AggSigDBV2
