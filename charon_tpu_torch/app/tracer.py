"""Workflow tracing: duty-rooted spans across every wire edge.

Mirrors ref: app/tracer/trace.go (OpenTelemetry -> Jaeger) and
core/tracing.go (span-wrapped workflow steps, duty-rooted trace IDs via
StartDutyTrace). Redesign: a dependency-free span recorder — spans carry
OTel-compatible ids (128-bit trace, 64-bit span), nest via contextvars
(async-safe), and export to a ring buffer served at /debug/traces plus an
optional JSONL file. Duty traces use a DETERMINISTIC trace id derived
from the duty, so spans recorded on different nodes of the cluster can be
merged into one cross-node trace offline — same property the reference
gets from propagating trace context in its p2p envelopes.
"""

from __future__ import annotations

import contextlib
import contextvars
import hashlib
import json
import os
import secrets
import time
from collections import deque
from dataclasses import dataclass, field


@dataclass
class Span:
    trace_id: str  # 32 hex chars
    span_id: str  # 16 hex chars
    parent_id: str  # 16 hex chars or ""
    name: str
    start: float
    end: float = 0.0
    attrs: dict = field(default_factory=dict)
    status: str = "ok"  # ok | error

    def to_json(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start_us": int(self.start * 1e6),
            "duration_us": int((self.end - self.start) * 1e6),
            "attrs": self.attrs,
            "status": self.status,
        }


_current: contextvars.ContextVar[Span | None] = contextvars.ContextVar(
    "charon_tpu_span", default=None
)


def current_ctx() -> tuple[str, str] | None:
    """(trace_id, span_id) of the context's active span, or None."""
    s = _current.get()
    if s is None:
        return None
    return (s.trace_id, s.span_id)


def encode_ctx() -> str | None:
    """Wire encoding of the active span context for transport frames
    (ref: the reference propagates OTel trace context in its p2p
    envelopes). Format: '<32-hex-trace-id>-<16-hex-span-id>'."""
    ctx = current_ctx()
    if ctx is None:
        return None
    return f"{ctx[0]}-{ctx[1]}"


@contextlib.contextmanager
def detached():
    """Run with NO active span. In-process transports (simnet memory
    fabrics, chaos fabrics) cross a simulated network boundary where a
    real deployment would lose the ambient context — without this, the
    sender's contextvars leak into the receiver and trace context would
    appear to propagate even with broken frame encoding."""
    token = _current.set(None)
    try:
        yield
    finally:
        _current.reset(token)


def parse_ctx(raw) -> tuple[str, str] | None:
    """Defensive decode of a propagated trace context. ANY malformation
    (wrong type, wrong lengths, non-hex) returns None — the receiver
    then falls back to a fresh duty-rooted span instead of crashing on
    a corrupted or adversarial frame."""
    if not isinstance(raw, str):
        return None
    trace_id, sep, span_id = raw.partition("-")
    if not sep or len(trace_id) != 32 or len(span_id) != 16:
        return None
    # strict per-char check: int(x, 16) would accept '0x' prefixes,
    # whitespace and signs — exactly the garbage a corrupted frame sends
    hexdigits = set("0123456789abcdefABCDEF")
    if not all(c in hexdigits for c in trace_id + span_id):
        return None
    return (trace_id, span_id)


def _otlp_value(v) -> dict:
    """Map a Python attribute value to an OTLP JSON AnyValue."""
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def span_to_otlp(span: "Span") -> dict:
    """One span in OTLP/JSON encoding (opentelemetry-proto trace.v1.Span)."""
    return {
        "traceId": span.trace_id,
        "spanId": span.span_id,
        "parentSpanId": span.parent_id,
        "name": span.name,
        "kind": 1,  # SPAN_KIND_INTERNAL
        "startTimeUnixNano": str(int(span.start * 1e9)),
        "endTimeUnixNano": str(int(span.end * 1e9)),
        "attributes": [
            {"key": k, "value": _otlp_value(v)} for k, v in span.attrs.items()
        ],
        "status": {"code": 2 if span.status == "error" else 1},
    }


class OTLPExporter:
    """Pushes spans to an OTLP/HTTP collector (`/v1/traces`, JSON
    encoding) — the standard Jaeger ≥1.35 / otel-collector ingest.
    Mirrors ref: app/tracer/trace.go:40-124 which exports via OTLP
    to Jaeger. Dependency-free: urllib POST from a background thread;
    spans batch until `batch_size` or `flush_interval`, and a dead
    collector drops batches (bounded queue) rather than stalling the
    node — tracing must never backpressure duty processing."""

    def __init__(
        self,
        endpoint: str,
        service_name: str = "charon-tpu",
        batch_size: int = 256,
        flush_interval: float = 5.0,
        max_queue: int = 8192,
    ):
        import queue
        import threading

        if not endpoint.rstrip("/").endswith("/v1/traces"):
            endpoint = endpoint.rstrip("/") + "/v1/traces"
        self.endpoint = endpoint
        self.service_name = service_name
        self.batch_size = batch_size
        self.flush_interval = flush_interval
        self.dropped = 0  # spans lost to a full queue / dead collector
        self.exported = 0
        self._q: "queue.Queue[Span | None]" = queue.Queue(maxsize=max_queue)
        self._thread = threading.Thread(
            target=self._run, name="otlp-exporter", daemon=True
        )
        self._thread.start()

    def offer(self, span: "Span") -> None:
        try:
            self._q.put_nowait(span)
        except Exception:
            self.dropped += 1

    def _post(self, batch: list["Span"]) -> None:
        import urllib.request

        body = json.dumps(
            {
                "resourceSpans": [
                    {
                        "resource": {
                            "attributes": [
                                {
                                    "key": "service.name",
                                    "value": {"stringValue": self.service_name},
                                }
                            ]
                        },
                        "scopeSpans": [
                            {
                                "scope": {"name": "charon_tpu_torch.app.tracer"},
                                "spans": [span_to_otlp(s) for s in batch],
                            }
                        ],
                    }
                ]
            }
        ).encode()
        req = urllib.request.Request(
            self.endpoint,
            data=body,
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=5.0):
                self.exported += len(batch)
        except Exception:
            self.dropped += len(batch)

    def _run(self) -> None:
        import queue

        batch: list[Span] = []
        deadline = time.monotonic() + self.flush_interval
        while True:
            timeout = max(0.0, deadline - time.monotonic())
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                item = ()  # timer tick
            if item is None:  # shutdown sentinel
                if batch:
                    self._post(batch)
                return
            if item != ():
                batch.append(item)
            if len(batch) >= self.batch_size or (
                batch and time.monotonic() >= deadline
            ):
                self._post(batch)
                batch = []
            if time.monotonic() >= deadline:
                deadline = time.monotonic() + self.flush_interval

    def shutdown(self, timeout: float = 10.0) -> None:
        """Flush pending spans and stop the export thread. A full queue
        still gets its sentinel (blocking put with a bound) so the
        flush-on-shutdown contract holds after a long collector outage."""
        import queue

        try:
            self._q.put(None, timeout=timeout / 2)
        except queue.Full:
            return  # exporter thread is wedged; give up without joining
        self._thread.join(timeout=timeout)


class Tracer:
    """Ring-buffered span store with optional JSONL export and optional
    OTLP/HTTP push (ref: app/tracer Init wiring, app/app.go:1014-1027)."""

    def __init__(
        self,
        capacity: int = 4096,
        jsonl_path: str | None = None,
        exporter: OTLPExporter | None = None,
    ):
        import threading

        self.spans: deque[Span] = deque(maxlen=capacity)
        self.jsonl_path = jsonl_path
        self.exporter = exporter
        self._file = None
        # record() runs from the event loop AND worker threads (plane
        # span bridge); serialize the lazy open and the line writes so
        # neither a double-open leaks a descriptor nor lines interleave
        self._file_lock = threading.Lock()
        # called with each finished Span (same thread that records it —
        # may be a worker thread, so hooks must be thread-safe). Feeds
        # app/metrics.span_metrics and the slow-duty detector.
        self.hooks: list = []

    def record(self, span: Span) -> None:
        self.spans.append(span)
        for hook in self.hooks:
            try:
                hook(span)
            except Exception:  # noqa: BLE001 — observers never break tracing
                pass
        if self.jsonl_path:
            with self._file_lock:
                if self._file is None:
                    os.makedirs(
                        os.path.dirname(self.jsonl_path) or ".",
                        exist_ok=True,
                    )
                    self._file = open(self.jsonl_path, "a")
                self._file.write(json.dumps(span.to_json()) + "\n")
                self._file.flush()
        if self.exporter is not None:
            self.exporter.offer(span)

    def dump(self, trace_id: str | None = None) -> list[dict]:
        # snapshot first: record() appends from worker threads (plane
        # span bridge), and a Python-level comprehension over the live
        # deque would raise 'deque mutated during iteration' mid-scrape;
        # list(deque) copies atomically under the GIL
        spans = list(self.spans)
        return [
            s.to_json()
            for s in spans
            if trace_id is None or s.trace_id == trace_id
        ]

    def close(self) -> None:
        with self._file_lock:
            if self._file:
                self._file.close()
                self._file = None
        if self.exporter is not None:
            self.exporter.shutdown()


_GLOBAL = Tracer()


def global_tracer() -> Tracer:
    return _GLOBAL


def set_global_tracer(tracer: Tracer) -> None:
    global _GLOBAL
    _GLOBAL = tracer


def duty_trace_id(duty) -> str:
    """Deterministic trace id for a duty — identical on every node
    (ref: core/tracing.go StartDutyTrace derives the id from the duty)."""
    return hashlib.sha256(
        b"charon-tpu-trace" + str(duty).encode()
    ).hexdigest()[:32]


@contextlib.contextmanager
def span(
    name: str,
    duty=None,
    tracer: Tracer | None = None,
    remote: tuple[str, str] | None = None,
    **attrs,
):
    """Start a span; nests under the context's current span. If `duty` is
    given and there is no active trace, the span roots a duty trace.
    `remote` is a (trace_id, span_id) pair propagated from a peer node's
    transport frame (parse_ctx output): with no local parent the span
    joins the remote trace under that parent, so cross-node timelines
    carry true parentage instead of four disconnected roots."""
    tracer = tracer or _GLOBAL
    parent = _current.get()
    if parent is not None:
        trace_id = parent.trace_id
        parent_id = parent.span_id
    elif remote is not None:
        trace_id, parent_id = remote
    elif duty is not None:
        trace_id = duty_trace_id(duty)
        parent_id = ""
    else:
        trace_id = secrets.token_hex(16)
        parent_id = ""
    if duty is not None:
        attrs.setdefault("duty", str(duty))
        slot = getattr(duty, "slot", None)
        if slot is not None:
            attrs.setdefault("slot", slot)
    s = Span(
        trace_id=trace_id,
        span_id=secrets.token_hex(8),
        parent_id=parent_id,
        name=name,
        start=time.time(),
        attrs=attrs,
    )
    token = _current.set(s)
    try:
        yield s
    except BaseException as e:
        s.status = "error"
        s.attrs["error"] = repr(e)
        raise
    finally:
        s.end = time.time()
        _current.reset(token)
        tracer.record(s)


def tracing(tracer: Tracer | None = None):
    """wire() option wrapping every subscription edge in a span.
    Canonical implementation lives in core/wire.py (sibling of
    instrument/tracking); kept here as an alias for existing callers."""
    from charon_tpu_torch.core.wire import tracing as _wire_tracing

    return _wire_tracing(tracer)


def record_span(
    name: str,
    trace_id: str,
    parent_id: str,
    start: float,
    end: float,
    tracer: Tracer | None = None,
    status: str = "ok",
    **attrs,
) -> Span:
    """Record an already-measured span (explicit wall-clock window) —
    the bridge path for stages timed outside a context manager, e.g.
    the crypto plane's decode/pack/device stages delivered via
    FlushStats from worker threads."""
    s = Span(
        trace_id=trace_id,
        span_id=secrets.token_hex(8),
        parent_id=parent_id,
        name=name,
        start=start,
        end=end,
        attrs=attrs,
        status=status,
    )
    (tracer or _GLOBAL).record(s)
    return s


def plane_span_bridge(tracer: Tracer | None = None, inner_hook=None):
    """SlotCoalescer.stats_hook adapter: bridge each flush's pipeline
    stages (decode, pack, device) into real tracer spans, replacing the
    old ad-hoc `trace=True` (start, end) tuples.

    A flush coalesces submissions from several duties; `stats.parents`
    carries each submission's captured span context, so the stage spans
    are recorded into EVERY participating duty trace — each duty's
    timeline shows the shared device window it rode. Submissions with
    no active trace context get one standalone flush trace. Runs on the
    device worker thread (Tracer.record is thread-safe); `inner_hook`
    chains the plain metrics hook."""

    def hook(stats) -> None:
        t = tracer or _GLOBAL
        parents = []
        seen: set[str] = set()
        for trace_id, span_id in getattr(stats, "parents", ()) or ():
            if trace_id not in seen:
                seen.add(trace_id)
                parents.append((trace_id, span_id))
        if not parents:
            parents = [(secrets.token_hex(16), "")]
        stages = []
        if stats.decode_spans:
            stages.append(
                (
                    "cryptoplane.decode",
                    min(s for s, _ in stats.decode_spans),
                    max(e for _, e in stats.decode_spans),
                    {"chunks": len(stats.decode_spans)},
                )
            )
        if stats.pack_span is not None:
            stages.append(
                ("cryptoplane.pack", *stats.pack_span, {})
            )
        if stats.device_span is not None:
            stages.append(
                (
                    "cryptoplane.device",
                    *stats.device_span,
                    {"fallback": stats.fallback},
                )
            )
        start = min((s for _, s, _, _ in stages), default=0.0)
        end = max((e for _, _, e, _ in stages), default=0.0)
        flush_attrs = {
            "jobs": stats.jobs,
            "lanes": stats.lanes,
            "window": stats.window,
            "inflight": stats.inflight,
            "fallback": stats.fallback,
        }
        if stats.padded_lanes:
            flush_attrs["bucket"] = stats.padded_lanes
            flush_attrs["pad_lanes"] = stats.pad_lanes
        tenant_lanes = getattr(stats, "tenant_lanes", ()) or ()
        if tenant_lanes:
            # multi-tenant service (core/cryptosvc): name every tenant
            # whose lanes rode this flush, so a duty timeline shows WHO
            # shared the device window with it
            flush_attrs["tenants"] = ",".join(t for t, _ in tenant_lanes)
        for i, (trace_id, parent_id) in enumerate(parents):
            # one flush -> one record per participating duty trace: mark
            # the copies beyond the first so metric hooks (span_metrics)
            # count each physical flush stage once, not once per duty
            dup = {"shared": True} if i else {}
            flush = record_span(
                "cryptoplane.flush",
                trace_id,
                parent_id,
                start,
                end,
                tracer=t,
                **flush_attrs,
                **dup,
            )
            for name, s, e, attrs in stages:
                record_span(
                    name,
                    trace_id,
                    flush.span_id,
                    s,
                    e,
                    tracer=t,
                    **attrs,
                    **dup,
                )
        if inner_hook is not None:
            inner_hook(stats)

    return hook


# -- per-duty timeline assembly (served at /debug/duty/<slot>) ---------------


def merge_jsonl(paths) -> list[dict]:
    """Merge per-node span JSONL exports into one span list (dedup by
    span_id, sorted by start) — the offline cross-node merge the
    deterministic duty trace ids exist for."""
    seen: set[str] = set()
    spans: list[dict] = []
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                s = json.loads(line)
                if s["span_id"] in seen:
                    continue
                seen.add(s["span_id"])
                spans.append(s)
    spans.sort(key=lambda s: s["start_us"])
    return spans


def duty_timeline(
    slot: int, tracer: Tracer | None = None, spans: list[dict] | None = None
) -> list[dict]:
    """Assemble the per-duty timelines for one slot: every trace that
    carries a span with this slot attribute, as a depth-annotated span
    forest ordered by start time. `spans` overrides the tracer's live
    ring (e.g. a merged cross-node JSONL export)."""
    if spans is None:
        spans = (tracer or _GLOBAL).dump()
    # one pass: bucket by trace_id, then keep the traces at this slot
    by_trace: dict[str, list[dict]] = {}
    for s in spans:
        by_trace.setdefault(s["trace_id"], []).append(s)
    trace_ids = {
        s["trace_id"] for s in spans if s["attrs"].get("slot") == slot
    }
    timelines = []
    for trace_id in sorted(trace_ids):
        group = by_trace[trace_id]
        by_id = {s["span_id"]: s for s in group}
        children: dict[str, list] = {}
        roots = []
        for s in group:
            if s["parent_id"] and s["parent_id"] in by_id:
                children.setdefault(s["parent_id"], []).append(s)
            else:
                roots.append(s)
        t0 = min(s["start_us"] for s in group)
        t1 = max(s["start_us"] + s["duration_us"] for s in group)
        flat: list[dict] = []

        def walk(s: dict, depth: int) -> None:
            flat.append(
                {
                    "name": s["name"],
                    "depth": depth,
                    "offset_us": s["start_us"] - t0,
                    "duration_us": s["duration_us"],
                    "span_id": s["span_id"],
                    "parent_id": s["parent_id"],
                    "attrs": s["attrs"],
                    "status": s["status"],
                }
            )
            for c in sorted(
                children.get(s["span_id"], ()), key=lambda c: c["start_us"]
            ):
                walk(c, depth + 1)

        for root in sorted(roots, key=lambda s: s["start_us"]):
            walk(root, 0)
        duty = next(
            (s["attrs"]["duty"] for s in group if "duty" in s["attrs"]), ""
        )
        timelines.append(
            {
                "trace_id": trace_id,
                "duty": duty,
                "slot": slot,
                "start_us": t0,
                "wall_us": t1 - t0,
                "spans": flat,
            }
        )
    return timelines


def render_waterfall(timelines: list[dict], width: int = 40) -> str:
    """Plain-text waterfall of duty_timeline() output — offsets,
    durations and a scaled bar per span, nested by parentage."""
    out: list[str] = []
    for tl in timelines:
        out.append(
            f"duty {tl['duty'] or '?'}  trace {tl['trace_id']}  "
            f"wall {tl['wall_us'] / 1000:.1f}ms"
        )
        scale = max(tl["wall_us"], 1)
        for s in tl["spans"]:
            left = int(s["offset_us"] * width / scale)
            bar_len = max(1, int(s["duration_us"] * width / scale))
            bar = " " * left + "#" * min(bar_len, width - left)
            mark = " !" if s["status"] == "error" else ""
            out.append(
                f"  {s['offset_us'] / 1000:8.1f}ms "
                f"{s['duration_us'] / 1000:8.1f}ms "
                f"|{bar:<{width}}| "
                + "  " * s["depth"]
                + s["name"]
                + mark
            )
        out.append("")
    return "\n".join(out)
