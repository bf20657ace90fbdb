"""Multi beacon-node client: failover, instrumentation, validator cache.

Mirrors ref: app/eth2wrap — the multi-client races/falls back across
beacon nodes (eth2wrap/multi.go:21-100), instruments latency and errors
(eth2wrap_gen.go), lazily reconnects (lazy.go:28), and caches the active
validator set per epoch (valcache.go). Duck-typed over any object exposing
the beacon interface (testutil.BeaconMock or an HTTP client).
"""

from __future__ import annotations

import asyncio
import time
from collections import defaultdict
from typing import Any, Sequence

from charon_tpu_torch.app.errors import StructuredError


class AllClientsFailedError(StructuredError):
    """Every configured beacon client failed the call; fields carry the
    endpoint and per-client errors (ref: app/errors at the BN boundary)."""


_METHODS = (
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
)


class MultiClient:
    """Try each client in best-first order; first success wins.

    Best-client selection (ref: multi.go picks the best client
    adaptively): clients are ordered by recent ERROR count first, then
    by rolling median LATENCY — a healthy-but-slow fallback BN stops
    being primary as soon as the fast one recovers, and duty-critical
    calls (attestation data at ⅓ slot) ride the fastest healthy node."""

    LATENCY_WINDOW = 64
    # hedge dispatch: when the best client has not answered within
    # HEDGE_FACTOR x its rolling-median latency (floored at HEDGE_MIN,
    # so a cold cache cannot hedge instantly), the runner-up is raced
    # and the first success wins — a stalled primary BN then costs one
    # median-latency wait, not a full `timeout`
    HEDGE_FACTOR = 2.0
    HEDGE_MIN = 0.05

    def __init__(
        self,
        clients: Sequence[Any],
        timeout: float = 5.0,
        hedge: bool = True,
    ) -> None:
        from collections import deque

        if not clients:
            raise ValueError("need at least one beacon client")
        self.clients = list(clients)
        self.timeout = timeout
        self.hedge = hedge and len(self.clients) >= 2
        self.hedged_total = 0  # hedges dispatched
        self.hedge_wins = 0  # hedges that answered first
        self.latencies: dict[str, list[float]] = defaultdict(list)
        self.errors: dict[int, int] = defaultdict(int)
        # rolling per-client latency window for the selection heuristic
        self.client_latency: dict[int, Any] = {
            i: deque(maxlen=self.LATENCY_WINDOW)
            for i in range(len(self.clients))
        }

    def _median_latency(self, i: int) -> float:
        import statistics

        window = self.client_latency[i]
        # untried clients get a chance at the front
        return statistics.median_high(window) if window else 0.0

    def best_order(self) -> list[int]:
        return sorted(
            range(len(self.clients)),
            key=lambda i: (self.errors[i], self._median_latency(i)),
        )

    @property
    def best_idx(self) -> int:
        return self.best_order()[0]

    async def _call_one(self, i: int, name: str, args, kwargs):
        client = self.clients[i]
        t0 = time.monotonic()
        result = await asyncio.wait_for(
            getattr(client, name)(*args, **kwargs), self.timeout
        )
        elapsed = time.monotonic() - t0
        self.latencies[name].append(elapsed)
        self.client_latency[i].append(elapsed)
        self.errors[i] = max(0, self.errors[i] - 1)
        return result

    def _hedge_delay(self, i: int) -> float | None:
        """Seconds to wait before racing the runner-up, or None when the
        primary has no latency history yet (an untried client gets one
        un-hedged sample first — hedging on zero data would double every
        call's load)."""
        window = self.client_latency[i]
        if not self.hedge or not window:
            return None
        return max(self._median_latency(i) * self.HEDGE_FACTOR, self.HEDGE_MIN)

    async def _hedged_pair(self, first: int, second: int, name: str, args, kwargs):
        """Race primary vs runner-up: runner-up starts only after the
        hedge delay elapses with the primary still pending (ref:
        multi.go's best-client race, plus the classic tail-latency hedge).
        Returns (ok, result, errs, failed) — ok is the explicit success
        flag because most beacon methods legitimately return None, and
        `failed` are the indices that ran and failed."""
        errs: list[str] = []
        failed: set[int] = set()
        race: set = set()
        primary = asyncio.ensure_future(
            self._call_one(first, name, args, kwargs)
        )
        race.add(primary)
        try:
            done, _ = await asyncio.wait(
                {primary}, timeout=self._hedge_delay(first)
            )
            if done:
                try:
                    return True, primary.result(), errs, failed
                except Exception as e:  # noqa: BLE001 — fails over
                    self.errors[first] += 1
                    errs.append(f"client{first}: {e!r}")
                    return False, None, errs, {first}
            self.hedged_total += 1
            hedge = asyncio.ensure_future(
                self._call_one(second, name, args, kwargs)
            )
            race.add(hedge)
            pending = set(race)
            while pending:
                done, pending = await asyncio.wait(
                    pending, return_when=asyncio.FIRST_COMPLETED
                )
                for task in done:
                    race.discard(task)
                    exc = task.exception()
                    if exc is None:
                        if task is hedge:
                            self.hedge_wins += 1
                        return True, task.result(), errs, failed
                    idx = first if task is primary else second
                    self.errors[idx] += 1
                    failed.add(idx)
                    errs.append(f"client{idx}: {exc!r}")
            return False, None, errs, failed
        finally:
            # cancel losers AND in-flight calls on external cancellation
            # (a duty-deadline cancel mid-hedge must not leave a submit
            # landing at the BN after the tracker reported the miss)
            for task in race:
                if not task.done():
                    task.cancel()

    def __getattr__(self, name: str):
        if name not in _METHODS:
            raise AttributeError(name)

        async def call(*args, **kwargs):
            errs: list[str] = []
            tried: set[int] = set()
            order = self.best_order()
            # best two ride the hedge; the race resolves stalls, the
            # sequential tail below resolves hard failures
            if len(order) >= 2 and self._hedge_delay(order[0]) is not None:
                ok, result, errs, tried = await self._hedged_pair(
                    order[0], order[1], name, args, kwargs
                )
                if ok:
                    return result
            for i in order:
                if i in tried:
                    continue
                try:
                    return await self._call_one(i, name, args, kwargs)
                except Exception as e:  # noqa: BLE001 — any failure fails over
                    self.errors[i] += 1
                    errs.append(f"client{i}: {e!r}")
            raise AllClientsFailedError(
                "all beacon clients failed",
                endpoint=name,
                errors="; ".join(errs),
            )

        return call


class InstrumentedClient:
    """Per-endpoint latency/error instrumentation around a beacon client
    (ref: app/eth2wrap/eth2wrap_gen.go wraps every generated method with
    latency() + incError(); metrics app_eth2_latency_seconds /
    app_eth2_errors_total in docs/metrics.md).

    `metrics` is a ClusterMetrics (app/metrics.py); falls back to local
    in-memory tallies when None so tests can instrument without a
    registry."""

    def __init__(self, client: Any, metrics=None, name: str = "beacon") -> None:
        from collections import deque

        self._client = client
        self._metrics = metrics
        self._name = name
        # bounded: full history lives in the Prometheus histogram; this
        # window only serves in-process diagnostics
        self.latency: dict[str, deque] = defaultdict(
            lambda: deque(maxlen=1024)
        )
        self.error_count: dict[str, int] = defaultdict(int)

    def __getattr__(self, name: str):
        inner = getattr(self._client, name)
        if not callable(inner) or name.startswith("_"):
            return inner

        async def call(*args, **kwargs):
            t0 = time.monotonic()
            try:
                result = await inner(*args, **kwargs)
            except BaseException:
                # BaseException: asyncio.CancelledError (e.g. the enclosing
                # MultiClient's wait_for timing this BN out) must count as
                # an error too, or a hung BN shows perfectly healthy metrics
                self.error_count[name] += 1
                if self._metrics is not None:
                    self._metrics.labels(
                        self._metrics.eth2_errors, self._name, name
                    ).inc()
                raise
            elapsed = time.monotonic() - t0
            self.latency[name].append(elapsed)
            if self._metrics is not None:
                self._metrics.labels(
                    self._metrics.eth2_latency, self._name, name
                ).observe(elapsed)
            return result

        return call


class LazyClient:
    """Connect-on-first-use beacon client with reconnect-on-failure
    (ref: app/eth2wrap/lazy.go:28 — the lazy client defers dialing the BN
    until the first call and rebuilds the underlying client when a call
    fails, so charon starts cleanly while its BN is still syncing/down).

    `factory` is an async callable returning a connected client. After a
    call fails the cached client is dropped; the next call redials with
    exponential backoff bounded by `max_backoff`."""

    def __init__(self, factory, max_backoff: float = 30.0) -> None:
        self._factory = factory
        self._client: Any = None
        self._lock = asyncio.Lock()
        self._backoff = ExpBackoff(max_delay=max_backoff)

    async def _get(self):
        async with self._lock:
            if self._client is None:
                await self._backoff.wait()
                self._client = await self._factory()
                self._backoff.reset()
            return self._client

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)

        async def call(*args, **kwargs):
            client = await self._get()
            try:
                return await getattr(client, name)(*args, **kwargs)
            except Exception:
                async with self._lock:
                    if self._client is client:  # drop the broken client
                        self._client = None
                raise

        return call


# Canonical home is the dedicated util module (ref:
# app/expbackoff/expbackoff.go); re-exported here for existing importers.
from charon_tpu_torch.app.expbackoff import ExpBackoff  # noqa: E402


SYNTH_GRAFFITI = b"charon-tpu-synthetic"


class SyntheticProposerClient:
    """Synthetic block-proposal duties for idle validators
    (ref: app/eth2wrap/synthproposer.go — WithSyntheticDuties fabricates
    deterministic proposer duties for validators that have none in an
    epoch, serves marker-graffiti blocks for them, and swallows their
    submission so the whole proposer pipeline is exercised in testing
    without hitting the chain).

    Deterministic assignment: validator v proposes at slot
    epoch_start + (stable_hash(pubkey, epoch) % SLOTS_PER_EPOCH)."""

    def __init__(self, client: Any, slots_per_epoch: int = 32) -> None:
        self._client = client
        self.slots_per_epoch = slots_per_epoch
        self.synthetic_submitted = 0
        # epoch -> slots WE fabricated duties for; trimmed so a
        # long-lived node doesn't accumulate past epochs forever
        self._synth_by_epoch: dict[int, set[int]] = {}

    def _synth_slot(self, epoch: int, pubkey: bytes) -> int:
        import hashlib

        h = hashlib.sha256(b"synth-proposer" + pubkey + epoch.to_bytes(8, "big"))
        return epoch * self.slots_per_epoch + (
            int.from_bytes(h.digest()[:4], "big") % self.slots_per_epoch
        )

    async def proposer_duties(self, epoch: int, validators):
        real = list(await self._client.proposer_duties(epoch, validators))
        have = {d.get("pubkey") if isinstance(d, dict) else d[0] for d in real}
        # validators: mapping pubkey -> validator index (the shape the
        # scheduler passes), or a plain pubkey sequence in tests
        items = (
            validators.items()
            if isinstance(validators, dict)
            else [(v, i) for i, v in enumerate(validators)]
        )
        slots = self._synth_by_epoch.setdefault(epoch, set())
        # keep a small window of epochs (proposals only query duties
        # around the current epoch)
        for old in [e for e in self._synth_by_epoch if e < epoch - 2]:
            del self._synth_by_epoch[old]
        for pk, vidx in items:
            if pk in have:
                continue
            raw = pk if isinstance(pk, bytes) else str(pk).encode()
            slot = self._synth_slot(epoch, raw)
            slots.add(slot)
            real.append(
                {
                    "pubkey": pk,
                    "slot": slot,
                    "validator_index": vidx,
                    "synthetic": True,
                }
            )
        return real

    async def block_proposal(self, slot: int, *args, randao_reveal=None, graffiti=None, **kw):
        if any(slot in s for s in self._synth_by_epoch.values()):
            # ONLY slots we fabricated duties for get synthetic blocks; a
            # transient BN failure on a real duty must propagate so the
            # retryer can re-fetch it (ref: synthproposer.go consults its
            # own duty cache before synthesizing)
            return {
                "slot": slot,
                "graffiti": SYNTH_GRAFFITI.hex(),
                "synthetic": True,
                "body": {"randao_reveal": randao_reveal},
            }
        return await self._client.block_proposal(
            slot, *args, randao_reveal=randao_reveal, graffiti=graffiti, **kw
        )

    async def submit_proposal(self, signed_block, *a, **kw):
        block = getattr(signed_block, "message", signed_block)
        if isinstance(block, dict) and (
            block.get("synthetic")
            or block.get("graffiti") == SYNTH_GRAFFITI.hex()
        ):
            self.synthetic_submitted += 1  # swallowed, never broadcast
            return None
        return await self._client.submit_proposal(signed_block, *a, **kw)

    def __getattr__(self, name):
        return getattr(self._client, name)


class ValidatorCache:
    """Per-epoch cache of duty queries (ref: eth2wrap/valcache.go)."""

    def __init__(self, beacon) -> None:
        self.beacon = beacon
        self._cache: dict[tuple, object] = {}

    async def attester_duties(self, epoch: int, validators):
        key = ("att", epoch, tuple(sorted(validators)))
        if key not in self._cache:
            self._cache[key] = await self.beacon.attester_duties(
                epoch, validators
            )
        return self._cache[key]

    async def proposer_duties(self, epoch: int, validators):
        key = ("prop", epoch, tuple(sorted(validators)))
        if key not in self._cache:
            self._cache[key] = await self.beacon.proposer_duties(
                epoch, validators
            )
        return self._cache[key]

    def trim(self, before_epoch: int) -> None:
        self._cache = {
            k: v for k, v in self._cache.items() if k[1] >= before_epoch
        }

    def __getattr__(self, name):
        return getattr(self.beacon, name)
