"""Crypto-plane profiler: decompose flush `device_span` into per-kernel-
family time (consumer (a) of the flight recorder's
hook spine).

`SlotCryptoPlane.on_program` (parallel/mesh.py) times every compiled-
program dispatch — family names match `kernel_families()` /
`core.cryptoplane.kernel_inventory()` ("mesh/verify_rlc", "mesh/step",
...) and each sample includes the result sync, so samples between two
FlushStats deliveries account for (approximately) that flush's
`device_span`. This module correlates the two streams:

  * the program hook buffers (family, seconds, lanes) samples — called
    on the coalescer's serialized device worker thread;
  * the stats hook (chained into the existing stats_hook pipeline)
    drains the buffer at each FlushStats and attributes the samples to
    that flush, exporting:
      - `tpu_plane_kernel_seconds_total{family}` (on_sample callback),
      - `tpu_plane_device_utilization` — device busy fraction over a
        rolling window (on_utilization callback),
      - `tpu_plane_tenant_device_seconds_total{tenant}` — device_span
        split by `FlushStats.tenant_lanes` share (on_tenant callback).

Planes without the packed on_program hook (SimHostPlane, host tbls
rungs) still profile: a flush arriving with no buffered samples
attributes its whole device_span to the synthetic family "device", so
the per-family sum equals device_span exactly on jax-free paths and
utilization stays truthful everywhere.

Pure stdlib, jax-free (app-layer rule); overhead per flush is one lock
round-trip and a few dict updates — bench_hostplane.py --profiler holds
this within the 5% gate.
"""

from __future__ import annotations

import threading
import time
from collections import deque

# synthetic family for flushes served by planes without program hooks
FALLBACK_FAMILY = "device"

DEFAULT_WINDOW = 60.0


class PlaneProfiler:
    """Correlates mesh program samples with FlushStats deliveries.

    Callbacks (all optional, all fired on the device worker thread —
    prometheus client objects are thread-safe):
      on_sample(family, seconds)       one per drained program sample
      on_tenant(tenant, seconds)       per-flush tenant device share
      on_utilization(fraction)         rolling busy/window after a flush
    """

    def __init__(
        self,
        window: float = DEFAULT_WINDOW,
        on_sample=None,
        on_tenant=None,
        on_utilization=None,
        clock=time.monotonic,
    ) -> None:
        if window <= 0:
            raise ValueError(f"profiler window must be > 0, got {window}")
        self.window = window
        self.on_sample = on_sample
        self.on_tenant = on_tenant
        self.on_utilization = on_utilization
        self._clock = clock
        self._lock = threading.Lock()
        self._pending: list[tuple[str, float, int]] = []
        self._busy: deque[tuple[float, float]] = deque()
        # cumulative totals (scenario tests + /debug introspection)
        self.kernel_seconds: dict[str, float] = {}
        self.kernel_calls: dict[str, int] = {}
        self.tenant_seconds: dict[str, float] = {}
        self.flushes = 0
        self.utilization = 0.0

    # -- producers ---------------------------------------------------------

    def program_hook(self):
        """The `SlotCryptoPlane.on_program` callable: buffer one timed
        program dispatch until the flush's FlushStats arrives."""

        def hook(family: str, seconds: float, lanes: int) -> None:
            with self._lock:
                self._pending.append((family, float(seconds), int(lanes)))

        return hook

    def stats_hook(self, inner=None):
        """Chain into the coalescer's stats_hook pipeline: profile the
        flush, then pass FlushStats on unchanged."""

        def hook(stats) -> None:
            try:
                self.observe_flush(stats)
            except Exception:  # noqa: BLE001 — profiling must never fail a flush
                pass
            if inner is not None:
                inner(stats)

        return hook

    # -- core --------------------------------------------------------------

    def observe_flush(self, stats) -> None:
        """Attribute everything sampled since the previous flush to this
        FlushStats. Runs on the serialized device worker thread, so the
        drained samples are exactly this flush's program dispatches."""
        span = getattr(stats, "device_span", None)
        device_s = max(0.0, span[1] - span[0]) if span else 0.0
        with self._lock:
            samples, self._pending = self._pending, []
        if not samples and device_s > 0.0:
            # hook-less plane (SimHostPlane, host rungs): the whole span
            # is one opaque device dispatch
            samples = [(FALLBACK_FAMILY, device_s, getattr(stats, "lanes", 0))]
        for family, seconds, _lanes in samples:
            self.kernel_seconds[family] = (
                self.kernel_seconds.get(family, 0.0) + seconds
            )
            self.kernel_calls[family] = self.kernel_calls.get(family, 0) + 1
            if self.on_sample is not None:
                self.on_sample(family, seconds)
        self.flushes += 1
        # tenant attribution: split device_span by live-lane share
        tenant_lanes = tuple(getattr(stats, "tenant_lanes", ()) or ())
        total = sum(lanes for _, lanes in tenant_lanes)
        if device_s > 0.0 and total > 0:
            for tenant, lanes in tenant_lanes:
                share = device_s * lanes / total
                self.tenant_seconds[tenant] = (
                    self.tenant_seconds.get(tenant, 0.0) + share
                )
                if self.on_tenant is not None:
                    self.on_tenant(tenant, share)
        # rolling duty cycle: busy seconds over the trailing window
        now = self._clock()
        busy = self._busy
        busy.append((now, device_s))
        while busy and busy[0][0] < now - self.window:
            busy.popleft()
        self.utilization = min(
            1.0, sum(s for _, s in busy) / self.window
        )
        if self.on_utilization is not None:
            self.on_utilization(self.utilization)

    # -- introspection -----------------------------------------------------

    def snapshot(self) -> dict:
        """Cumulative per-family/per-tenant totals + current duty cycle
        (served under /debug/flight?view=profile)."""
        with self._lock:
            pending = len(self._pending)
        return {
            "kernel_seconds": {
                k: round(v, 6) for k, v in sorted(self.kernel_seconds.items())
            },
            "kernel_calls": dict(sorted(self.kernel_calls.items())),
            "tenant_seconds": {
                k: round(v, 6) for k, v in sorted(self.tenant_seconds.items())
            },
            "flushes": self.flushes,
            "utilization": round(self.utilization, 4),
            "pending_samples": pending,
        }
