"""Flight recorder: always-on, bounded-overhead event history for
post-mortem debugging of the distributed plane.

Every operational hook in the node — FlushStats lifecycle, tenant
sheds/breaker transitions (core/cryptosvc), remote connect/failover/
shed (core/cryptosvc_client/_server), Byzantine evidence
(core/evidence), peer/codec quarantine (p2p/quarantine), autotune
decisions (core/autotune), QBFT round changes, duty tracker outcomes —
feeds one process-wide ring so an incident leaves a typed, ordered,
attributable record even when nobody was scraping /metrics.

Design constraints, in order:

1. **Bounded memory, storm-proof.** One fixed-capacity ring PER
   CATEGORY (``collections.deque(maxlen=...)``): a flush storm evicts
   old flush events, never the three byzantine detections that explain
   it. Eviction counts are kept per category so a dump says what was
   lost.
2. **Lock-light.** One tiny per-category lock held only for the
   append + counter bump — FlushStats arrives on the coalescer's
   device worker thread and server stats on socket threads, so the
   recorder must be safe from any thread without ever becoming a
   contention point on the duty path.
3. **Unrecordable secrets.** ``record()`` accepts only primitive field
   values (str/int/float/bool/None, short lists thereof); anything
   structured is replaced by its type name. Key material therefore
   cannot ride an event even by accident, and the secret-flow taint
   lint (analysis/rule_secret_flow.py) flags any tainted value reaching
   a ``record()`` sink at review time.
4. **Schema-versioned egress.** Dumps are JSONL with a header line
   carrying ``schema``/``node``; the event-field catalogue is an
   append-only golden (tests/testdata/flightrec_schema.json, checked by
   analysis/flightrec_check.py) so downstream incident tooling never
   silently breaks.

Cross-node reconstruction mirrors app/tracer.merge_jsonl: per-node
dumps merge on wall-clock order (dedup by (node, seq)) into one
incident timeline; ``render_timeline`` is the text view /debug/flight
serves with ``format=text``.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field

SCHEMA_VERSION = 1

# The closed category set. Per-category sub-rings are the storm
# isolation mechanism, so this is deliberately an enum-like tuple —
# adding one is a schema change (bless it into the golden).
CATEGORIES = (
    "flush",       # coalescer FlushStats lifecycle
    "tenant",      # cryptosvc sheds / breaker transitions / queue
    "remote",      # remote-plane connect / failover / shed (client+server)
    "byzantine",   # attributed evidence (core/evidence kinds)
    "quarantine",  # peer/codec mutes (p2p/quarantine)
    "autotune",    # startup kernel-tuner decisions + profile lifecycle
    "consensus",   # QBFT round changes
    "duty",        # tracker duty outcomes
    "lifecycle",   # process events: dumps, crash handlers, colocation
)

DEFAULT_CAPACITY = 512  # events kept per category

# The event vocabulary the shipped hook adapters emit, per category —
# the downstream contract incident tooling parses against. Checked
# APPEND-ONLY against tests/testdata/flightrec_schema.json by
# analysis/flightrec_check.py: kinds may be added (re-bless with
# --update after review), never removed or recategorized.
EVENT_KINDS: dict[str, tuple[str, ...]] = {
    "flush": ("flush", "flush_unparsed"),
    "tenant": ("shed", "breaker"),
    "remote": (
        # client side (core/cryptosvc_client.RemotePlane observer)
        "failover",
        "shed",
        "remote_shed",
        "connect",
        "connect_fail",
        "disconnect",
        "state",
        "heartbeat_miss",
        # server side (core/cryptosvc_server observer, server_ prefix)
        "server_auth_fail",
        "server_connect",
        "server_disconnect",
        "server_shed",
        "server_quarantine",
    ),
    "byzantine": (
        "qbft_equivocation",
        "qbft_flood",
        "qbft_replay",
        "qbft_malformed",
        "qbft_forged_justification",
        "parsig_conflict",
        "parsig_flood",
        "parsig_invalid",
        "parsig_spoof",
    ),
    "quarantine": ("peer_muted",),
    "autotune": ("profile", "decision", "bench", "prewarm"),
    "consensus": ("round_change",),
    "duty": ("duty_ok", "duty_failed"),
    "lifecycle": ("start", "stop", "crash_dump", "dump", "colocated"),
}

# Envelope keys every dumped event line may carry (append-only too).
ENVELOPE_FIELDS = (
    "seq",
    "t_mono",
    "t_wall",
    "category",
    "kind",
    "node",
    "tenant",
    "slot",
    "fields",
)

# Field-value sanitation bounds: everything recorded must stay cheap to
# hold and safe to dump.
_MAX_STR = 200
_MAX_SEQ_ITEMS = 16


@dataclass(frozen=True)
class Event:
    """One recorded event. ``t_mono`` orders events within a node;
    ``t_wall`` is the cross-node merge key (wall clock is the only
    clock two machines share)."""

    seq: int
    t_mono: float
    t_wall: float
    category: str
    kind: str
    tenant: str | None = None
    slot: int | None = None
    fields: dict = field(default_factory=dict)

    def to_dict(self, node: str | None = None) -> dict:
        d = {
            "seq": self.seq,
            "t_mono": round(self.t_mono, 6),
            "t_wall": round(self.t_wall, 6),
            "category": self.category,
            "kind": self.kind,
        }
        if node is not None:
            d["node"] = node
        if self.tenant is not None:
            d["tenant"] = self.tenant
        if self.slot is not None:
            d["slot"] = self.slot
        if self.fields:
            d["fields"] = self.fields
        return d


def _sanitize_value(v):
    """Primitives pass (strings truncated); short sequences of
    primitives pass as lists; everything else is reduced to its type
    name — structured objects (and therefore key material wrapped in
    them) are unrecordable by construction."""
    if v is None or isinstance(v, (bool, int, float)):
        return v
    if isinstance(v, str):
        return v if len(v) <= _MAX_STR else v[:_MAX_STR] + "..."
    if isinstance(v, (list, tuple)):
        out = []
        for item in list(v)[:_MAX_SEQ_ITEMS]:
            if item is None or isinstance(item, (bool, int, float)):
                out.append(item)
            elif isinstance(item, str):
                out.append(
                    item if len(item) <= _MAX_STR else item[:_MAX_STR] + "..."
                )
            elif isinstance(item, (list, tuple)) and len(item) == 2:
                # one level of (name, count) pairs — the tenant_lanes shape
                out.append([_sanitize_value(item[0]), _sanitize_value(item[1])])
            else:
                out.append(f"<{type(item).__name__}>")
        return out
    return f"<{type(v).__name__}>"


class FlightRecorder:
    """Typed per-category ring buffer; every method is thread-safe.

    `observer` (optional, ``callable(category, kind)``) fires after
    each append — app/metrics wires the flightrec_* counter families
    through it. Exceptions from it are swallowed: recording must never
    take down the path that emitted the event.
    """

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        node: str = "",
        observer=None,
    ) -> None:
        if capacity < 1:
            raise ValueError(f"flight recorder capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.node = node
        self.observer = observer
        self._rings: dict[str, deque[Event]] = {
            cat: deque(maxlen=capacity) for cat in CATEGORIES
        }
        self._locks: dict[str, threading.Lock] = {
            cat: threading.Lock() for cat in CATEGORIES
        }
        self._seq = 0
        self._seq_lock = threading.Lock()
        self.recorded_total: dict[str, int] = {cat: 0 for cat in CATEGORIES}
        self.dropped_total: dict[str, int] = {cat: 0 for cat in CATEGORIES}
        self.dumps_total: dict[str, int] = {}

    # -- intake ------------------------------------------------------------

    def record(
        self,
        category: str,
        kind: str,
        tenant: str | None = None,
        slot: int | None = None,
        **fields,
    ) -> None:
        """Append one event. Unknown categories are coerced into
        'lifecycle' rather than raised — a recorder bug must never
        crash an observer chain."""
        if category not in self._rings:
            fields = {"miscategorized": category, **fields}
            category = "lifecycle"
        ev = Event(
            seq=0,  # assigned under the seq lock below
            t_mono=time.monotonic(),
            # wall stamp is the cross-node merge key (logging edge,
            # never used for intra-node math)
            t_wall=time.time(),  # lint: allow(monotonic-clock)
            category=category,
            kind=str(kind)[:_MAX_STR],
            tenant=None if tenant is None else str(tenant)[:_MAX_STR],
            slot=None if slot is None else int(slot),
            fields={str(k)[:64]: _sanitize_value(v) for k, v in fields.items()},
        )
        with self._seq_lock:
            self._seq += 1
            object.__setattr__(ev, "seq", self._seq)
        ring = self._rings[category]
        with self._locks[category]:
            dropped = len(ring) == ring.maxlen
            ring.append(ev)
            self.recorded_total[category] += 1
            if dropped:
                self.dropped_total[category] += 1
        if self.observer is not None:
            try:
                self.observer(category, kind)
            except Exception:  # noqa: BLE001 — observers must not break intake
                pass

    # -- read side ---------------------------------------------------------

    def events(
        self,
        category: str | None = None,
        tenant: str | None = None,
        slot: int | None = None,
        limit: int | None = None,
    ) -> list[Event]:
        """Snapshot, merged across category rings, ordered by seq.
        Filters compose; `limit` keeps the NEWEST events."""
        cats = [category] if category in self._rings else list(CATEGORIES)
        out: list[Event] = []
        for cat in cats:
            with self._locks[cat]:
                out.extend(self._rings[cat])
        if tenant is not None:
            out = [e for e in out if e.tenant == tenant]
        if slot is not None:
            out = [e for e in out if e.slot == slot]
        out.sort(key=lambda e: e.seq)
        if limit is not None and limit >= 0:
            out = out[len(out) - min(limit, len(out)):]
        return out

    def __len__(self) -> int:
        return sum(len(r) for r in self._rings.values())

    # -- egress ------------------------------------------------------------

    def dump_jsonl(self, path: str, trigger: str = "demand") -> int:
        """Write the whole ring as schema-versioned JSONL (header line +
        one event per line), atomically (tmp + rename — a crash mid-dump
        never leaves a truncated file where tooling expects a dump).
        Returns the number of events written."""
        events = self.events()
        self.dumps_total[trigger] = self.dumps_total.get(trigger, 0) + 1
        header = {
            "schema": SCHEMA_VERSION,
            "node": self.node,
            "trigger": trigger,
            # dump stamp: operator-facing wall time for incident logs
            "written_at": round(time.time(), 3),  # lint: allow(monotonic-clock)
            "dropped": {k: v for k, v in self.dropped_total.items() if v},
        }
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(json.dumps(header) + "\n")
            for ev in events:
                f.write(json.dumps(ev.to_dict(node=self.node)) + "\n")
        os.replace(tmp, path)
        return len(events)


# -- crash/terminate dump handlers ----------------------------------------


def install_crash_handlers(rec: FlightRecorder, path: str):
    """Dump the ring on SIGTERM and on any unhandled exception (main
    thread AND worker threads), chaining whatever handlers were already
    installed. Returns an ``uninstall()`` callable that restores the
    previous handlers (tests and clean shutdowns).

    SIGTERM installation is best-effort: only the main thread may set
    signal handlers, and the dump-on-stop lifecycle hook covers clean
    exits anyway.
    """
    prev_excepthook = sys.excepthook
    prev_threading_hook = threading.excepthook

    def _dump(trigger: str) -> None:
        try:
            rec.record("lifecycle", "crash_dump", trigger=trigger)
            rec.dump_jsonl(path, trigger=trigger)
        except Exception:  # noqa: BLE001 — a failing dump must not mask the crash
            pass

    def excepthook(exc_type, exc, tb):
        _dump("crash")
        prev_excepthook(exc_type, exc, tb)

    def threading_hook(args):
        _dump("thread-crash")
        prev_threading_hook(args)

    sys.excepthook = excepthook
    threading.excepthook = threading_hook

    prev_sigterm = None
    installed_signal = False
    try:
        def on_sigterm(signum, frame):
            _dump("sigterm")
            if callable(prev_sigterm):
                prev_sigterm(signum, frame)
            elif prev_sigterm == signal.SIG_DFL:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        prev_sigterm = signal.signal(signal.SIGTERM, on_sigterm)
        installed_signal = True
    except ValueError:
        # not the main thread — excepthooks still installed
        pass

    def uninstall() -> None:
        sys.excepthook = prev_excepthook
        threading.excepthook = prev_threading_hook
        if installed_signal:
            try:
                signal.signal(signal.SIGTERM, prev_sigterm or signal.SIG_DFL)
            except ValueError:
                pass

    return uninstall


# -- cross-node merge + text timeline -------------------------------------


def merge_jsonl(paths) -> list[dict]:
    """Merge per-node flight dumps into one incident ordering: dedup by
    (node, seq), sort by wall stamp (ties broken by node then seq —
    deterministic across re-runs). Unreadable lines are skipped, not
    fatal: a post-mortem works with whatever survived."""
    seen: set[tuple[str, int]] = set()
    out: list[dict] = []
    for path in paths:
        try:
            with open(path, "r", encoding="utf-8") as f:
                lines = f.readlines()
        except OSError:
            continue
        node = ""
        for i, line in enumerate(lines):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if i == 0 and "schema" in obj and "seq" not in obj:
                node = str(obj.get("node", ""))
                continue
            if "seq" not in obj or "category" not in obj:
                continue
            obj.setdefault("node", node)
            key = (str(obj["node"]), int(obj["seq"]))
            if key in seen:
                continue
            seen.add(key)
            out.append(obj)
    out.sort(key=lambda e: (e.get("t_wall", 0.0), str(e.get("node", "")), e["seq"]))
    return out


def render_timeline(events, limit: int | None = None) -> str:
    """Plain-text incident timeline (the format=text view of
    /debug/flight and the `flight merge` CLI): one line per event,
    offset-stamped from the first event, same spirit as the tracer's
    duty waterfall."""
    rows = [e.to_dict(node=None) if isinstance(e, Event) else dict(e) for e in events]
    if limit is not None:
        rows = rows[len(rows) - min(limit, len(rows)):]
    if not rows:
        return "(no flight-recorder events)\n"
    t0 = rows[0].get("t_wall", 0.0)
    lines = []
    for r in rows:
        off = r.get("t_wall", 0.0) - t0
        node = f" {r['node']}" if r.get("node") else ""
        tenant = f" tenant={r['tenant']}" if r.get("tenant") else ""
        slot = f" slot={r['slot']}" if r.get("slot") is not None else ""
        extras = " ".join(
            f"{k}={v}" for k, v in sorted((r.get("fields") or {}).items())
        )
        lines.append(
            f"+{off:9.3f}s{node} [{r['category']:<10}] "
            f"{r['kind']}{tenant}{slot}"
            + (f" {extras}" if extras else "")
        )
    return "\n".join(lines) + "\n"


# -- hook adapters ---------------------------------------------------------
# Each adapter chains an existing observer callback shape through the
# recorder: construct with the previously-wired hook as `inner` and
# install the adapter in its place. Recording happens FIRST so a
# throwing inner hook cannot suppress the record.


_TENANT_INCIDENT_KINDS = frozenset({"shed", "breaker"})


def tenant_hook(rec: FlightRecorder, inner=None):
    """core/cryptosvc observer: (kind, tenant, **fields). Only the
    incident-relevant kinds enter the ring — queue/dispatch/complete
    are per-job telemetry (the metrics inner hook still sees them)."""

    def hook(kind, tenant, **fields):
        if kind in _TENANT_INCIDENT_KINDS:
            rec.record("tenant", kind, tenant=tenant, **fields)
        if inner is not None:
            inner(kind, tenant, **fields)

    return hook


def remote_hook(rec: FlightRecorder, tenant: str, addr: str = "", inner=None):
    """core/cryptosvc_client observer: (kind, **fields). `addr` names
    the dialed server so a merged post-mortem can attribute a failover
    to the exact aborted endpoint."""

    def hook(kind, **fields):
        rec.record("remote", kind, tenant=tenant, addr=addr, **fields)
        if inner is not None:
            inner(kind, **fields)

    return hook


def server_hook(rec: FlightRecorder, inner=None):
    """core/cryptosvc_server observer: (kind, tenant, **fields) —
    recorded with a server_ prefix so client and server views of the
    same incident stay distinguishable after a merge."""

    def hook(kind, tenant, **fields):
        rec.record("remote", f"server_{kind}", tenant=tenant, **fields)
        if inner is not None:
            inner(kind, tenant, **fields)

    return hook


def byzantine_hook(rec: FlightRecorder, inner=None):
    """core/evidence hook: (peer, kind[, detail])."""

    def hook(peer, kind, detail=""):
        rec.record("byzantine", kind, peer=peer, detail=detail)
        if inner is not None:
            inner(peer, kind)

    return hook


def quarantine_hook(rec: FlightRecorder, inner=None):
    """p2p/quarantine observer: (peer, mute_seconds)."""

    def hook(peer, mute_seconds):
        rec.record("quarantine", "peer_muted", peer=peer, mute_seconds=mute_seconds)
        if inner is not None:
            inner(peer, mute_seconds)

    return hook


def autotune_hook(rec: FlightRecorder, inner=None):
    """core/autotune observer: (kind, **fields)."""

    def hook(kind, **fields):
        rec.record("autotune", kind, **fields)
        if inner is not None:
            inner(kind, **fields)

    return hook


def consensus_hook(rec: FlightRecorder, inner=None):
    """QBFT round-change observer: (duty, round, source, direction)
    (core/consensus_qbft.QBFTConsensus.on_round_change)."""

    def hook(duty, rnd, source, direction):
        rec.record(
            "consensus",
            "round_change",
            slot=getattr(duty, "slot", None),
            duty=str(duty),
            round=rnd,
            source=source,
            direction=direction,
        )
        if inner is not None:
            inner(duty, rnd, source, direction)

    return hook


def stats_hook(rec: FlightRecorder, inner=None):
    """SlotCoalescer stats_hook: (FlushStats) — called from the device
    worker thread. Records the flush summary (never the payloads)."""

    def hook(stats):
        try:
            dev = stats.device_span
            dev_s = (dev[1] - dev[0]) if dev else 0.0
            rec.record(
                "flush",
                "flush",
                jobs=stats.jobs,
                lanes=stats.lanes,
                flush_seconds=round(stats.flush_seconds, 6),
                device_seconds=round(dev_s, 6),
                window=round(stats.window, 6),
                fallback=stats.fallback,
                decode_mode=stats.decode_mode,
                tenants=[t for t, _ in (stats.tenant_lanes or ())],
            )
        except Exception:  # noqa: BLE001 — a stats-shape change must not kill the device lane
            rec.record("flush", "flush_unparsed")
        if inner is not None:
            inner(stats)

    return hook


def duty_hook(rec: FlightRecorder):
    """core/tracker report subscriber: records every duty outcome
    (success AND attributed failure) — the SLO engine's raw history,
    replayable from a dump."""

    def sub(report):
        rec.record(
            "duty",
            "duty_ok" if report.success else "duty_failed",
            slot=report.duty.slot,
            duty=str(report.duty),
            failed_step=str(report.failed_step) if report.failed_step else None,
            reason=report.reason.value if report.reason else None,
            trace_id=report.trace_id,
        )

    return sub
