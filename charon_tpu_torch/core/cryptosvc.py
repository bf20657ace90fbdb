"""Multi-tenant crypto-plane service: one device plane, many clusters.

The port of charon_tpu/core/cryptosvc.py. Many independent DV clusters
(or the nodes of one in-process cluster) share one card's slot plane:
the `SlotCoalescer` already pipelines and buckets, but it trusts its
submitters — any caller can flood the coalescing window, and a tenant
whose lanes persistently fail verification dilutes every other tenant's
RLC batches. Handel (arXiv:1906.05132) and aggregated-signature gossip
BFT (arXiv:1911.04698) both assume cheap bulk verification *surviving
byzantine load*; the RLC batches provide the "cheap", this boundary
provides the "surviving":

  * **per-tenant submission queues with deadline-aware weighted-fair
    scheduling** — duty deadlines already travel on submissions; the
    dispatcher admits work into the shared coalescer earliest-deadline-
    first *within a per-tenant lane quota per scheduling round* (round
    length = the coalescing window), so a starved tenant's near-deadline
    duty preempts a flooder's backlog instead of queueing behind it;
  * **admission control / backpressure** — bounded queue depth (jobs AND
    lanes, counting in-flight work) per tenant; over-budget submissions
    fail fast with the typed `PlaneOverloadError`, which the submitters
    (parsigex / sigagg / validatorapi) catch and serve with an inline
    call of the installed tbls backend — shed load costs the flooder
    latency, never the event loop a deadlock;
  * **per-tenant circuit breaker** — a tenant whose lanes persistently
    fail verification (forged-signature flood) is *quarantined to its
    own flushes*: while the breaker is open its submissions route to a
    dedicated per-tenant coalescer sharing the same device plane, so a
    forged batch can never force an RLC retry-split or false-reject on
    an honest tenant's lanes sharing the window. After a cooldown the
    breaker half-opens; one fully-clean quarantined flush closes it.

The service is a *narrow* boundary: components hold a `TenantPlane`
handle exposing exactly the coalescer surface they already use
(`t`, `verify`, `recombine`), so `SigAgg` / `Eth2Verifier` /
`ValidatorAPI` are tenant-agnostic. Everything here is event-loop-side
bookkeeping (heaps and counters); the crypto stays in the coalescer.

Observability: `observer(kind, tenant, **fields)` receives typed events
("shed", "dispatch", "complete", "breaker", "queue") — the JAX
package's `app/metrics.py` `tenant_hook()` turns them into the
tenant-labeled metric families (not ported yet) — and per-flush tenant
attribution rides `FlushStats.tenant_lanes`.
"""

from __future__ import annotations

import asyncio
import heapq
import time
from dataclasses import dataclass, field

from charon_tpu_torch.tbls import TblsError


class TenantConfigError(ValueError):
    """Invalid service wiring (duplicate tenant registration etc.) —
    a deploy/programming bug, typed so the plane's load-shedding
    handlers (which catch TblsError) never mistake it for overload."""


class PlaneOverloadError(TblsError):
    """Typed fail-fast admission rejection: the tenant's submission
    queue is over its configured depth. A TblsError subclass, which
    submitters catch SPECIFICALLY and serve with an inline call of the
    installed tbls backend — the caller must never block on an
    overloaded plane."""

    def __init__(self, tenant: str, reason: str, detail: str = ""):
        self.tenant = tenant
        self.reason = reason  # "jobs" | "lanes" | "closed"
        msg = f"crypto plane overloaded for tenant {tenant!r} ({reason})"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


@dataclass(frozen=True)
class TenantQuota:
    """Per-tenant admission and fairness knobs (docs/operations.md
    "Multi-tenant deployment" explains how to size them)."""

    # relative share of the service's per-round lane budget (weighted
    # fair: budget_i = round_lanes * weight_i / sum(weights))
    weight: float = 1.0
    # admission bounds: queued + in-flight submissions/lanes; beyond
    # either, new submissions shed with PlaneOverloadError
    max_queue_jobs: int = 256
    max_queue_lanes: int = 4096
    # circuit breaker: open when, over the last breaker_window lanes
    # (>= breaker_min_lanes seen), the failed-verification ratio
    # reaches breaker_threshold; half-open after breaker_cooldown s
    breaker_window: int = 128
    breaker_min_lanes: int = 32
    breaker_threshold: float = 0.5
    breaker_cooldown: float = 5.0


class CircuitBreaker:
    """Per-tenant forged-flood breaker over lane verification outcomes.

    closed -> open when the rolling failure ratio trips the threshold;
    open -> half_open after the cooldown; one fully-clean quarantined
    flush closes it, any failed lane re-opens (cooldown restarts).
    Lane outcomes recorded while open are ignored — an open breaker is
    already quarantined, and its backlog draining with failures must
    not keep resetting the window state."""

    def __init__(self, quota: TenantQuota, on_transition=None):
        self.quota = quota
        self.state = "closed"
        self.opened_at = 0.0
        self._window: list[tuple[int, int]] = []  # (ok, failed) per flush
        self._window_lanes = 0
        self._window_failed = 0
        self.transitions: dict[str, int] = {}
        self._on_transition = on_transition

    def _transition(self, state: str) -> None:
        if state == self.state:
            return
        self.state = state
        self.transitions[state] = self.transitions.get(state, 0) + 1
        if state == "open":
            self.opened_at = time.monotonic()
        if state in ("open", "closed"):
            self._window.clear()
            self._window_lanes = self._window_failed = 0
        if self._on_transition is not None:
            self._on_transition(state)

    def quarantined(self) -> bool:
        """True when this tenant's dispatches must use its own flushes.
        Checking also advances open -> half_open past the cooldown."""
        if self.state == "open" and (
            time.monotonic() - self.opened_at >= self.quota.breaker_cooldown
        ):
            self._transition("half_open")
        return self.state != "closed"

    def record(self, ok: int, failed: int) -> None:
        """Lane outcomes of one completed dispatch."""
        if self.state == "open":
            return
        if self.state == "half_open":
            # the probe verdict: one clean quarantined flush closes the
            # breaker, any forged lane re-opens it for another cooldown
            self._transition("closed" if failed == 0 else "open")
            return
        self._window.append((ok, failed))
        self._window_lanes += ok + failed
        self._window_failed += failed
        while (
            self._window
            and self._window_lanes - sum(self._window[0])
            >= self.quota.breaker_window
        ):
            o, f = self._window.pop(0)
            self._window_lanes -= o + f
            self._window_failed -= f
        if (
            self._window_lanes >= self.quota.breaker_min_lanes
            and self._window_failed
            >= self.quota.breaker_threshold * self._window_lanes
        ):
            self._transition("open")


@dataclass
class _Entry:
    kind: str  # "verify" | "recombine"
    args: tuple
    lanes: int
    deadline: float | None  # wall clock (time.time), as submitted
    fut: asyncio.Future
    seq: int


class _Tenant:
    def __init__(self, tenant_id: str, quota: TenantQuota, on_breaker=None):
        self.id = tenant_id
        self.quota = quota
        self.queue: list[tuple[float, int, _Entry]] = []  # (edf key, seq, e)
        self.pending_jobs = 0  # queued + dispatched, until completion
        self.pending_lanes = 0
        self.breaker = CircuitBreaker(quota, on_transition=on_breaker)
        self.quarantine_coal = None  # lazy SlotCoalescer for open-breaker
        # observability counters (scenario tests + /metrics attribution)
        self.shed: dict[str, int] = {}
        self.shed_lanes = 0
        self.admitted_jobs = 0
        self.admitted_lanes = 0
        self.completed_lanes = 0
        self.failed_lanes = 0
        self.quarantined_flushes = 0


class TenantPlane:
    """The narrow per-tenant handle components hold in place of the raw
    coalescer — same duck type (`t`, `verify`, `recombine`), tenant
    identity bound once at registration."""

    def __init__(self, svc: "CryptoPlaneService", tenant_id: str):
        self._svc = svc
        self.tenant_id = tenant_id

    @property
    def t(self) -> int:
        return self._svc.t

    async def verify(self, items, deadline: float | None = None):
        return await self._svc.submit(
            self.tenant_id, "verify", (list(items),), len(items), deadline
        )

    async def recombine(
        self, pubshares, roots, partials, group_pks, indices,
        deadline: float | None = None,
    ):
        rows = (
            list(pubshares), list(roots), list(partials),
            list(group_pks), list(indices),
        )
        return await self._svc.submit(
            self.tenant_id, "recombine", rows, len(rows[1]), deadline
        )


class CryptoPlaneService:
    """One shared SlotCoalescer behind per-tenant admission, fairness,
    and quarantine (module docstring). `round_lanes` is the total lane
    budget a scheduling round may admit across tenants; each tenant's
    share is weight-proportional. `round_interval` defaults to the
    coalescer's base window so one round feeds one coalescing window."""

    def __init__(
        self,
        coalescer,
        round_lanes: int = 4096,
        round_interval: float | None = None,
        observer=None,
        quarantine_window: float = 0.005,
        quarantine_factory=None,  # callable(tenant_id) -> coalescer
    ):
        self._coal = coalescer
        self.round_lanes = round_lanes
        self._round = (
            round_interval
            if round_interval is not None
            else max(float(getattr(coalescer, "window", 0.02)), 0.001)
        )
        self._quarantine_window = quarantine_window
        self._quarantine_factory = quarantine_factory
        self.observer = observer  # callable(kind, tenant, **fields)
        self._tenants: dict[str, _Tenant] = {}
        self._seq = 0
        self._closed = False
        self._wake = asyncio.Event()
        self._task: asyncio.Task | None = None
        self._entry_tasks: set[asyncio.Task] = set()

    # -- registration ------------------------------------------------------

    @property
    def t(self) -> int:
        return self._coal.t

    @property
    def coalescer(self):
        """The shared pooled coalescer (lifecycle hooks: prewarm,
        warm_caches, close all stay on the coalescer itself)."""
        return self._coal

    def register(
        self, tenant_id: str, quota: TenantQuota | None = None
    ) -> TenantPlane:
        if tenant_id in self._tenants:
            raise TenantConfigError(
                f"tenant {tenant_id!r} already registered"
            )
        quota = quota or TenantQuota()

        def on_breaker(state: str, _tid=tenant_id) -> None:
            self._observe("breaker", _tid, state=state)

        self._tenants[tenant_id] = _Tenant(tenant_id, quota, on_breaker)
        return TenantPlane(self, tenant_id)

    def tenant(self, tenant_id: str) -> _Tenant:
        """Tenant bookkeeping (counters, breaker) — observability and
        tests; the scheduling state inside is service-private."""
        return self._tenants[tenant_id]

    def _observe(self, kind: str, tenant: str, **fields) -> None:
        if self.observer is not None:
            try:
                self.observer(kind, tenant, **fields)
            except Exception:  # noqa: BLE001 — observer bugs stay out
                pass  # of the duty path

    # -- submission (event-loop side) --------------------------------------

    async def submit(
        self,
        tenant_id: str,
        kind: str,
        args: tuple,
        lanes: int,
        deadline: float | None,
    ):
        ten = self._tenants[tenant_id]
        if self._closed:
            raise PlaneOverloadError(tenant_id, "closed")
        if lanes == 0:
            # empty submissions short-circuit like the coalescer's own
            return [] if kind == "verify" else ([], [])
        q = ten.quota
        reason = None
        if ten.pending_jobs + 1 > q.max_queue_jobs:
            reason = "jobs"
        elif ten.pending_lanes + lanes > q.max_queue_lanes:
            reason = "lanes"
        if reason is not None:
            # fail FAST: no await between the check and the raise, so
            # an overloaded tenant can never wedge the event loop
            ten.shed[reason] = ten.shed.get(reason, 0) + 1
            ten.shed_lanes += lanes
            self._observe("shed", tenant_id, reason=reason, lanes=lanes)
            raise PlaneOverloadError(
                tenant_id,
                reason,
                f"{ten.pending_jobs} jobs / {ten.pending_lanes} lanes "
                f"pending (+{lanes})",
            )
        loop = asyncio.get_running_loop()
        self._seq += 1
        entry = _Entry(
            kind=kind,
            args=args,
            lanes=lanes,
            deadline=deadline,
            fut=loop.create_future(),
            seq=self._seq,
        )
        key = deadline if deadline is not None else float("inf")
        heapq.heappush(ten.queue, (key, entry.seq, entry))
        ten.pending_jobs += 1
        ten.pending_lanes += lanes
        self._observe(
            "queue", tenant_id,
            jobs=ten.pending_jobs, lanes=ten.pending_lanes,
        )
        self._kick()
        return await entry.fut

    def _kick(self) -> None:
        if self._task is None or self._task.done():
            # fresh Event per dispatcher task: asyncio primitives bind
            # to the running loop, and one service may serve several
            # asyncio.run lifetimes (tests, CLI tools)
            self._wake = asyncio.Event()
            self._task = asyncio.create_task(self._drain())
        else:
            self._wake.set()

    # -- dispatcher --------------------------------------------------------

    def _has_queued(self) -> bool:
        return any(t.queue for t in self._tenants.values())

    def _budget(self, ten: _Tenant) -> int:
        total = sum(t.quota.weight for t in self._tenants.values()) or 1.0
        return max(1, int(self.round_lanes * ten.quota.weight / total))

    def _run_round(self, budgets: dict[str, int], spent: dict[str, int]):
        """Admit everything admissible under the current round budgets,
        earliest-deadline-first ACROSS tenants: at each step the
        globally-nearest deadline among in-budget tenants dispatches,
        so a starved tenant's near-deadline duty preempts a flooder's
        backlog. One oversize submission per tenant per round may
        exceed the budget (a burst larger than the quota must degrade
        to per-round trickle, not starve forever)."""
        while True:
            best = None
            for ten in self._tenants.values():
                # drop entries whose waiter is already gone (tenant
                # crash-loop cancelled the submission mid-queue)
                while ten.queue and ten.queue[0][2].fut.done():
                    _, _, dead = heapq.heappop(ten.queue)
                    ten.pending_jobs -= 1
                    ten.pending_lanes -= dead.lanes
                if not ten.queue:
                    continue
                budgets.setdefault(ten.id, self._budget(ten))
                head = ten.queue[0]
                entry = head[2]
                remaining = budgets[ten.id] - spent.get(ten.id, 0)
                if entry.lanes > remaining and spent.get(ten.id, 0) > 0:
                    continue  # over quota this round; next round
                if best is None or head[:2] < best[0][:2]:
                    best = (head, ten)
            if best is None:
                return
            head, ten = best
            heapq.heappop(ten.queue)
            entry = head[2]
            spent[ten.id] = spent.get(ten.id, 0) + entry.lanes
            ten.admitted_jobs += 1
            ten.admitted_lanes += entry.lanes
            quarantined = ten.breaker.quarantined()
            self._observe(
                "dispatch", ten.id,
                lanes=entry.lanes, quarantined=quarantined,
            )
            task = asyncio.create_task(
                self._run_entry(ten, entry, quarantined)
            )
            self._entry_tasks.add(task)
            task.add_done_callback(self._entry_tasks.discard)

    async def _drain(self) -> None:
        """Dispatcher body: rounds of length `_round`, budgets reset per
        round, mid-round wakes admit fresh submissions immediately with
        whatever budget their tenant has left. Exits when every queue
        drains (a later submission spawns a fresh task)."""
        while not self._closed and self._has_queued():
            budgets: dict[str, int] = {}
            spent: dict[str, int] = {}
            round_end = time.monotonic() + self._round
            self._run_round(budgets, spent)
            while not self._closed:
                remaining = round_end - time.monotonic()
                if remaining <= 0:
                    break
                self._wake.clear()
                try:
                    await asyncio.wait_for(self._wake.wait(), remaining)
                except asyncio.TimeoutError:
                    break
                self._run_round(budgets, spent)

    # -- entry execution ---------------------------------------------------

    def _quarantine_coal(self, ten: _Tenant):
        """The tenant's own coalescer (lazy): same plane object, short
        window, the shared coalescer's decode mode and point caches (its
        TorchImpl). The port's coalescer has no degrade rungs, so there is
        no rung state to inherit. Its flushes interleave with pooled
        flushes in the device stream exactly like warm-up programs do —
        acceptable for a quarantined minority, and the forged lanes can no
        longer force RLC retries on honest tenants' batches."""
        if ten.quarantine_coal is None:
            if self._quarantine_factory is not None:
                ten.quarantine_coal = self._quarantine_factory(ten.id)
            else:
                from charon_tpu_torch.core.cryptoplane import SlotCoalescer

                ten.quarantine_coal = SlotCoalescer(
                    self._coal.plane,
                    window=self._quarantine_window,
                    decode_workers=getattr(self._coal, "decode_workers", 0),
                    stats_hook=getattr(self._coal, "stats_hook", None),
                    decode_mode=getattr(self._coal, "decode_mode", "auto"),
                    impl=getattr(self._coal, "impl", None),
                )
        return ten.quarantine_coal

    async def _run_entry(
        self, ten: _Tenant, entry: _Entry, quarantined: bool
    ) -> None:
        t0 = time.monotonic()
        coal = self._quarantine_coal(ten) if quarantined else self._coal
        try:
            if entry.kind == "verify":
                res = await coal.verify(
                    entry.args[0], deadline=entry.deadline, tenant=ten.id
                )
                ok = sum(1 for r in res if r)
                failed = len(res) - ok
            else:
                res = await coal.recombine(
                    *entry.args, deadline=entry.deadline, tenant=ten.id
                )
                oks = res[1]
                ok = sum(1 for r in oks if r)
                failed = len(oks) - ok
        except Exception as e:  # noqa: BLE001 — the coalescer failed
            # this flush's waiters; surface the error to this one
            if not entry.fut.done():
                entry.fut.set_exception(e)
            return
        finally:
            ten.pending_jobs -= 1
            ten.pending_lanes -= entry.lanes
        ten.completed_lanes += ok
        ten.failed_lanes += failed
        if quarantined:
            ten.quarantined_flushes += 1
        ten.breaker.record(ok, failed)
        self._observe(
            "complete", ten.id,
            lanes=ok + failed, failed=failed,
            seconds=time.monotonic() - t0, quarantined=quarantined,
        )
        if not entry.fut.done():
            entry.fut.set_result(res)

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Fail queued waiters fast and shut the quarantine coalescers
        (the SHARED coalescer's lifecycle belongs to its owner)."""
        self._closed = True
        for ten in self._tenants.values():
            while ten.queue:
                _, _, entry = heapq.heappop(ten.queue)
                ten.pending_jobs -= 1
                ten.pending_lanes -= entry.lanes
                if not entry.fut.done():
                    entry.fut.set_exception(
                        PlaneOverloadError(ten.id, "closed")
                    )
            if ten.quarantine_coal is not None and hasattr(
                ten.quarantine_coal, "close"
            ):
                ten.quarantine_coal.close()
        if self._task is not None and not self._task.done():
            self._wake.set()
