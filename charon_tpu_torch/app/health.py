"""Health checks over a rolling in-memory metric window.

Mirrors ref: app/health — a 10-minute rolling store of samples from the
node's OWN metrics, evaluated by a declarative check catalogue
(health/checker.go; catalogue health/checks.go:41-151): error/warning
log rates scaled by validator count, beacon-node sync state, connected
peer quorum, proposal failures, registration-recast failures — plus
clock skew from the peerinfo exchange (the reference surfaces it through
monitoring readiness, app/monitoringapi.go).

Severity semantics (ref: checks.go severityCritical/Warning/Info):
critical failures gate /readyz; warnings and infos are reported in the
readyz body and metrics but do not flip readiness.

The distributed plane extends this module two ways:

  * `plane_checks()` — the post-PR-8/17/18 catalogue: tenant breaker
    open, remote plane down/probing, peer quarantine active, autotune
    fell back to defaults. Sampled from the live subsystems by
    run.py's health sample loop under the series names each check
    documents.
  * `SLOEngine` — rolling per-tenant duty-miss and step-latency error
    budgets with multi-window burn-rate alerting (the SRE
    fast+slow-window construction: a page needs BOTH the fast window —
    still burning now — and the slow window — burned enough to matter —
    above threshold). Exported as `core_slo_*` metrics by run.py and
    gating /readyz through `SLOEngine.checks()`.
"""

from __future__ import annotations

import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Callable

WINDOW_SECS = 600.0  # ref: app/health 10-minute window

SEVERITY_CRITICAL = "critical"
SEVERITY_WARNING = "warning"
SEVERITY_INFO = "info"


class MetricStore:
    def __init__(self, now=time.time) -> None:
        self._now = now
        self._series: dict[str, deque] = defaultdict(deque)

    def sample(self, name: str, value: float) -> None:
        q = self._series[name]
        t = self._now()
        q.append((t, value))
        while q and q[0][0] < t - WINDOW_SECS:
            q.popleft()

    def latest(self, name: str, default: float = 0.0) -> float:
        q = self._series.get(name)
        return q[-1][1] if q else default

    def max(self, name: str, default: float = 0.0) -> float:
        """Max over the window (ref: checker.go gaugeMax)."""
        q = self._series.get(name)
        return max((v for _, v in q), default=default) if q else default

    def increase(self, name: str) -> float:
        """Increase of a counter over the window (ref: checker.go
        increase)."""
        q = self._series.get(name)
        if not q or len(q) < 2:
            return 0.0
        return max(0.0, q[-1][1] - q[0][1])


@dataclass
class Metadata:
    """Cluster facts the checks scale by (ref: health.Metadata)."""

    num_validators: int = 1
    quorum: int = 2
    # a remote crypto plane is configured: the remote-state
    # checks only mean anything when there is a remote to be down
    remote_plane: bool = False


@dataclass
class Check:
    name: str
    description: str
    failing: Callable[[MetricStore, Metadata], bool]
    severity: str = SEVERITY_WARNING


def default_checks() -> list[Check]:
    """The reference catalogue (ref: health/checks.go:41-151) evaluated
    over this node's own sampled metrics."""
    return [
        Check(
            "high_error_log_rate",
            "high rate of error logs (allow 2 per validator per window)",
            lambda m, md: m.increase("app_log_errors")
            > 2 * md.num_validators,
            SEVERITY_WARNING,
        ),
        Check(
            "high_warning_log_rate",
            "high rate of warning logs (allow 2 per validator per window)",
            lambda m, md: m.increase("app_log_warnings")
            > 2 * md.num_validators,
            SEVERITY_WARNING,
        ),
        Check(
            "beacon_node_syncing",
            "beacon node is in syncing state",
            lambda m, md: m.max("app_beacon_syncing") > 0,
            SEVERITY_CRITICAL,
        ),
        Check(
            "insufficient_connected_peers",
            "not connected to at least quorum-1 peers",
            lambda m, md: m.max("p2p_peers_connected") < md.quorum - 1,
            SEVERITY_CRITICAL,
        ),
        Check(
            "proposal_failures",
            "proposal duties failed in the window",
            lambda m, md: m.increase("core_tracker_failed_proposals") > 0,
            SEVERITY_WARNING,
        ),
        Check(
            "failed_duties",
            "duties failed in the window",
            lambda m, md: m.increase("core_tracker_failed_duties") > 0,
            SEVERITY_WARNING,
        ),
        Check(
            "high_registration_failures_rate",
            "validator-registration recasts failed in the window",
            lambda m, md: m.increase("core_bcast_recast_errors") > 0,
            SEVERITY_WARNING,
        ),
        Check(
            "high_clock_skew",
            "peer clock offset above 2s (peerinfo exchange)",
            lambda m, md: m.max("app_peerinfo_clock_offset_abs") > 2.0,
            SEVERITY_WARNING,
        ),
        Check(
            "pending_validators",
            "validators pending activation",
            lambda m, md: m.max("core_scheduler_validators_pending") > 0,
            SEVERITY_INFO,
        ),
    ]


def plane_checks() -> list[Check]:
    """The distributed-plane catalogue: checks over the tenant service,
    the remote plane and the tuner, evaluated against series run.py's
    health sample loop records each tick:

      tpu_plane_tenant_breaker_state .. max breaker state across tenants
                                        (0 closed, 1 half-open, 2 open)
      tpu_plane_remote_state .......... min remote rung state across
                                        tenants (0 down, 1 probing, 2 up)
      wire_peer_quarantine_total ...... cumulative imposed peer mutes
      tpu_autotune_fallback ........... 1 when the startup tuner failed
                                        and kernel routing fell back to
                                        defaults, else 0
    """
    return [
        Check(
            "tenant_breaker_open",
            "a tenant circuit breaker is open (forged-lane flood "
            "quarantined to its own flushes)",
            lambda m, md: m.max("tpu_plane_tenant_breaker_state") >= 2,
            SEVERITY_CRITICAL,
        ),
        Check(
            "remote_plane_down",
            "remote crypto plane unreachable; duties served from the "
            "local ladder",
            lambda m, md: md.remote_plane
            and m.latest("tpu_plane_remote_state", 2.0) == 0,
            SEVERITY_WARNING,
        ),
        Check(
            "remote_plane_probing",
            "remote crypto plane half-open (reconnect probe in flight)",
            lambda m, md: md.remote_plane
            and m.latest("tpu_plane_remote_state", 2.0) == 1,
            SEVERITY_WARNING,
        ),
        Check(
            "peer_quarantine_active",
            "peer codec mutes imposed in the window (a peer is "
            "streaming malformed frames)",
            lambda m, md: m.increase("wire_peer_quarantine_total") > 0,
            SEVERITY_WARNING,
        ),
        Check(
            "autotune_defaults",
            "startup kernel tuner failed; routing fell back to "
            "untuned defaults",
            lambda m, md: m.max("tpu_autotune_fallback") > 0,
            SEVERITY_WARNING,
        ),
    ]


class HealthChecker:
    def __init__(
        self,
        store: MetricStore,
        checks: list[Check] | None = None,
        metadata: Metadata | None = None,
    ) -> None:
        self.store = store
        self.checks = checks if checks is not None else default_checks()
        self.metadata = metadata or Metadata()

    def evaluate(self) -> dict[str, bool]:
        """check name -> failing?"""
        return {
            c.name: c.failing(self.store, self.metadata)
            for c in self.checks
        }

    def failing(self) -> list[Check]:
        return [c for c in self.checks if c.failing(self.store, self.metadata)]

    def healthy(self) -> bool:
        """Readiness gate: only CRITICAL checks flip readiness
        (ref: severity semantics, checks.go)."""
        return not any(
            c.severity == SEVERITY_CRITICAL for c in self.failing()
        )


# -- duty SLO engine -------------------------------------------


@dataclass(frozen=True)
class SLOConfig:
    """One rolling error-budget objective.

    `budget` is the allowed bad-event fraction (0.01 = 99% objective).
    Burn rate over a window = (bad fraction in window) / budget; a burn
    of 1.0 spends the budget exactly at the allowed pace. The classic
    multi-window rule pages when BOTH windows exceed `page_burn`
    (fast window: it is burning NOW; slow window: enough budget is gone
    to matter) and warns at `warn_burn`."""

    name: str
    budget: float
    fast_window: float = 300.0
    slow_window: float = 3600.0
    page_burn: float = 14.4  # SRE workbook: 5m/1h pair spending ~2%/h
    warn_burn: float = 6.0
    min_events: int = 10  # below this, a window stays silent (no data)


# per-(slo, tenant) event history cap — at one duty every 12 s a slot,
# 4096 events cover > 13 h, far past the slow window
_MAX_SLO_EVENTS = 4096

SLO_DUTY_MISS = "duty_miss"
SLO_STEP_LATENCY = "step_latency"


class SLOEngine:
    """Rolling per-tenant duty-miss and step-latency budgets with
    multi-window burn-rate alerts (module docstring).

    Feed it duty outcomes (`observe_duty`, from tracker reports) and
    step latencies (`observe_step`, from the tracer's span hook); call
    `evaluate()` periodically (run.py's health sample loop). Alert
    rising edges fire `on_alert(slo, tenant, severity)` — run.py chains
    the `core_slo_alerts_total` counter and a flight-recorder event
    through it. `checks()` returns Check objects for the HealthChecker
    so a paging duty-miss burn gates /readyz."""

    def __init__(
        self,
        duty_budget: float = 0.01,
        step_budget: float = 0.05,
        step_latency_target: float = 1.0,
        fast_window: float = 300.0,
        slow_window: float = 3600.0,
        page_burn: float = 14.4,
        warn_burn: float = 6.0,
        min_events: int = 10,
        on_alert=None,
        clock=time.monotonic,
    ) -> None:
        common = dict(
            fast_window=fast_window,
            slow_window=slow_window,
            page_burn=page_burn,
            warn_burn=warn_burn,
            min_events=min_events,
        )
        self.slos: dict[str, SLOConfig] = {
            SLO_DUTY_MISS: SLOConfig(SLO_DUTY_MISS, duty_budget, **common),
            SLO_STEP_LATENCY: SLOConfig(
                SLO_STEP_LATENCY, step_budget, **common
            ),
        }
        self.step_latency_target = step_latency_target
        self.on_alert = on_alert
        self._clock = clock
        # (slo, tenant) -> deque[(t_mono, bad)]
        self._events: dict[tuple[str, str], deque] = defaultdict(
            lambda: deque(maxlen=_MAX_SLO_EVENTS)
        )
        # (slo, tenant) -> currently-firing severity ("" when quiet)
        self._firing: dict[tuple[str, str], str] = {}
        self.alerts_total: dict[tuple[str, str, str], int] = {}

    # -- intake ------------------------------------------------------------

    def observe_duty(self, success: bool, tenant: str = "local") -> None:
        self._observe(SLO_DUTY_MISS, tenant, bad=not success)

    def observe_step(self, seconds: float, tenant: str = "local") -> None:
        self._observe(
            SLO_STEP_LATENCY, tenant, bad=seconds > self.step_latency_target
        )

    def _observe(self, slo: str, tenant: str, bad: bool) -> None:
        self._events[(slo, tenant)].append((self._clock(), bool(bad)))

    # -- burn math ---------------------------------------------------------

    def burn_rate(self, slo: str, tenant: str, window: float) -> float:
        """(bad fraction over the trailing window) / budget; 0.0 when
        the window holds fewer than min_events events (no data is not
        an incident)."""
        cfg = self.slos[slo]
        cutoff = self._clock() - window
        events = self._events.get((slo, tenant))
        if not events:
            return 0.0
        total = bad = 0
        for t, is_bad in events:
            if t < cutoff:
                continue
            total += 1
            bad += is_bad
        if total < cfg.min_events:
            return 0.0
        return (bad / total) / cfg.budget

    def budget_remaining(self, slo: str, tenant: str) -> float:
        """Fraction of the slow-window error budget still unspent,
        clamped to [0, 1]. 1.0 with no data."""
        cfg = self.slos[slo]
        burn = self.burn_rate(slo, tenant, cfg.slow_window)
        return max(0.0, min(1.0, 1.0 - burn))

    def tenants(self) -> list[str]:
        return sorted({t for _, t in self._events})

    # -- alerting ----------------------------------------------------------

    def evaluate(self) -> list[dict]:
        """One row per (slo, tenant) with both window burns and the
        firing severity; updates rising-edge alert state (on_alert +
        alerts_total fire here, so call this on a steady cadence)."""
        rows: list[dict] = []
        for slo, cfg in self.slos.items():
            for tenant in self.tenants():
                if (slo, tenant) not in self._events:
                    continue
                fast = self.burn_rate(slo, tenant, cfg.fast_window)
                slow = self.burn_rate(slo, tenant, cfg.slow_window)
                both = min(fast, slow)
                if both >= cfg.page_burn:
                    severity = SEVERITY_CRITICAL
                elif both >= cfg.warn_burn:
                    severity = SEVERITY_WARNING
                else:
                    severity = ""
                prev = self._firing.get((slo, tenant), "")
                self._firing[(slo, tenant)] = severity
                if severity and severity != prev:
                    key = (slo, tenant, severity)
                    self.alerts_total[key] = self.alerts_total.get(key, 0) + 1
                    if self.on_alert is not None:
                        self.on_alert(slo, tenant, severity)
                rows.append(
                    {
                        "slo": slo,
                        "tenant": tenant,
                        "fast_burn": fast,
                        "slow_burn": slow,
                        "budget_remaining": self.budget_remaining(
                            slo, tenant
                        ),
                        "severity": severity,
                    }
                )
        return rows

    def firing(self, slo: str, severity: str = SEVERITY_CRITICAL) -> bool:
        """Any tenant currently firing >= severity for the slo (state
        from the most recent evaluate())."""
        order = {SEVERITY_WARNING: 1, SEVERITY_CRITICAL: 2}
        want = order[severity]
        return any(
            s == slo and order.get(sev, 0) >= want
            for (s, _t), sev in self._firing.items()
        )

    def checks(self) -> list[Check]:
        """HealthChecker integration: a paging duty-miss burn is
        CRITICAL (gates /readyz — the node is actively failing its
        duty objective); step-latency burn warns."""
        return [
            Check(
                "slo_duty_miss_burn",
                "duty-miss error budget burning at paging rate on both "
                "alert windows",
                lambda m, md: self.firing(SLO_DUTY_MISS, SEVERITY_CRITICAL),
                SEVERITY_CRITICAL,
            ),
            Check(
                "slo_step_latency_burn",
                "step-latency error budget burning above warning rate",
                lambda m, md: self.firing(
                    SLO_STEP_LATENCY, SEVERITY_WARNING
                ),
                SEVERITY_WARNING,
            ),
        ]
