"""Prometheus metrics with mandatory cluster labels.

Mirrors ref: app/promauto — a registry whose metrics all carry
cluster-identifying labels (app/app.go:227-241), plus the monitoring
HTTP endpoints (/metrics, /readyz, /livez — app/monitoringapi.go:47-122).
"""

from __future__ import annotations

import asyncio
import json as _json
from dataclasses import dataclass

from prometheus_client import (
    CollectorRegistry,
    Counter,
    Gauge,
    Histogram,
    generate_latest,
)


@dataclass
class ClusterMetrics:
    """Registry with cluster_hash/cluster_name/peer labels applied to every
    series (ref: promauto.NewRegistry cluster labels)."""

    cluster_hash: str
    cluster_name: str
    peer: str

    def __post_init__(self) -> None:
        self.registry = CollectorRegistry()
        labels = ["cluster_hash", "cluster_name", "peer"]
        self._label_values = [self.cluster_hash, self.cluster_name, self.peer]

        def counter(name, doc, extra=()):
            c = Counter(name, doc, labels + list(extra), registry=self.registry)
            return c

        self.duty_total = counter(
            "core_scheduler_duty_total", "Duties scheduled", ["duty"]
        )
        self.consensus_decided = counter(
            "core_consensus_decided_total", "Consensus decisions", ["duty"]
        )
        self.parsig_received = counter(
            "core_parsigex_received_total", "Partial signatures received", ["duty"]
        )
        self.sigagg_total = counter(
            "core_sigagg_aggregated_total", "Aggregated signatures", ["duty"]
        )
        self.bcast_total = counter(
            "core_bcast_broadcast_total", "Broadcast duties", ["duty"]
        )
        self.tracker_failed = counter(
            "core_tracker_failed_duties_total", "Failed duties", ["duty", "step"]
        )
        self.tracker_inconsistent = counter(
            "core_tracker_inconsistent_parsigs_total",
            "Duties with inconsistent partial signatures by duty type "
            "(ref: core/tracker/metrics.go:85)",
            ["duty"],
        )
        self.tracker_unexpected = counter(
            "core_tracker_unexpected_events_total",
            "Partial signatures from peers for unscheduled validators",
            ["peer_share"],
        )
        self.tracker_participation = counter(
            "core_tracker_participation_total",
            "Per-peer duty participation (dedup'd by validator)",
            ["duty", "peer_share"],
        )
        self.tracker_failed_validators = counter(
            "core_tracker_failed_validators_total",
            "Per-validator signing failures (expected pubkeys whose "
            "partials never reached threshold), by duty type and reason",
            ["duty", "reason"],
        )
        self.inclusion_checked = counter(
            "core_tracker_inclusion_total",
            "On-chain inclusion results for broadcast duties "
            "(ref: core/tracker/inclusion.go inclusion metrics)",
            ["duty", "result"],
        )
        self.inclusion_delay = Gauge(
            "core_tracker_inclusion_delay_slots",
            "Most recent on-chain inclusion delay in slots",
            labels,
            registry=self.registry,
        )
        self.consensus_decided_rounds = Gauge(
            "core_consensus_decided_rounds",
            "Round the most recent consensus instance decided in, by "
            "duty type and round-timer strategy (ref: consensus metrics "
            "SetDecidedRounds)",
            labels + ["duty", "timer"],
            registry=self.registry,
        )
        self.consensus_duration = Gauge(
            "core_consensus_duration_seconds",
            "Wall seconds the most recent consensus instance took, by "
            "duty type and round-timer strategy (ref: consensus metrics "
            "ObserveConsensusDuration)",
            labels + ["duty", "timer"],
            registry=self.registry,
        )
        self.peer_ping = Gauge(
            "p2p_ping_success",
            "Peer ping success",
            labels + ["peer_index"],
            registry=self.registry,
        )
        self.bcast_delay = Histogram(
            "core_bcast_delay_seconds",
            "Broadcast delay into the slot",
            labels,
            registry=self.registry,
        )
        self.eth2_latency = Histogram(
            "app_eth2_latency_seconds",
            "Beacon-node request latency per endpoint",
            labels + ["client", "endpoint"],
            registry=self.registry,
        )
        self.eth2_errors = Counter(
            "app_eth2_errors_total",
            "Beacon-node request errors per endpoint",
            labels + ["client", "endpoint"],
            registry=self.registry,
        )
        self.batch_size = Histogram(
            "tpu_batch_size",
            "Device batch sizes for crypto kernels",
            labels + ["kernel"],
            registry=self.registry,
            buckets=(1, 4, 16, 64, 256, 1024, 4096, 16384),
        )
        self.plane_flushes = counter(
            "tpu_plane_flushes_total",
            "Crypto-plane coalescer flushes (device program launches)",
        )
        self.plane_coalesced = counter(
            "tpu_plane_coalesced_flushes_total",
            "Flushes that merged work from >= 2 concurrent submissions",
        )
        self.plane_lanes = counter(
            "tpu_plane_lanes_total",
            "Crypto lanes executed through the coalesced plane",
        )
        # pipelined host plane: per-flush latency/occupancy,
        # decode-pool queueing, bucket-padding waste, device-lane depth
        self.plane_flush_seconds = Histogram(
            "tpu_plane_flush_seconds",
            "Device-lane wall clock per coalescer flush (pack excluded)",
            labels,
            registry=self.registry,
            buckets=(0.001, 0.005, 0.02, 0.05, 0.1, 0.5, 2.0, 10.0, 60.0),
        )
        self.plane_lanes_per_flush = Histogram(
            "tpu_plane_lanes_per_flush",
            "Crypto lanes merged into each coalescer flush (occupancy)",
            labels,
            registry=self.registry,
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 1024),
        )
        self.plane_decode_queue_seconds = Histogram(
            "tpu_plane_decode_queue_seconds",
            "Decode-pool queue delay per decode chunk (submit -> start)",
            labels,
            registry=self.registry,
            buckets=(0.0005, 0.002, 0.01, 0.05, 0.2, 1.0),
        )
        self.plane_pad_waste = Gauge(
            "tpu_plane_pad_waste_ratio",
            "Bucket-padding lanes / padded lanes of the most recent "
            "flush (shape-bucket overhead)",
            labels,
            registry=self.registry,
        )
        self.plane_inflight = Gauge(
            "tpu_plane_inflight_depth",
            "Device-lane depth when the most recent flush was submitted "
            "(>= 2 means flushes are double-buffering)",
            labels,
            registry=self.registry,
        )
        self.plane_overlapped = counter(
            "tpu_plane_overlapped_flushes_total",
            "Flushes whose host stages overlapped a device program "
            "still in flight (double-buffered windows)",
        )
        # decode-source breakdown: where each flush's point
        # decodes were served — LRU point-cache lookups (pubkeys,
        # messages, pubshares) vs signature lanes decompressed on
        # device (decode-fused flush programs) vs on host (python
        # bigint rung)
        self.plane_decode_lanes = counter(
            "tpu_plane_decode_lanes_total",
            "Point decodes per flush by source: cache = LRU point "
            "lookups, device = signature lanes decompressed inside the "
            "flush program, python = host bigint decompression",
            ["source"],
        )
        self.plane_decode_mode = Gauge(
            "tpu_plane_decode_mode",
            "Decode rung that served the most recent flush "
            "(1 = device decompression kernels, 0 = python host decode)",
            labels,
            registry=self.registry,
        )
        # tpu_impl point-cache efficiency, polled from the process-wide
        # lru_cache counters at scrape time (monotonic, but exported as
        # gauges because cache_info() owns the counter state)
        self.point_cache_hits = Gauge(
            "tpu_point_cache_hits",
            "Cumulative lru_cache hits of the tpu_impl point caches, "
            "by cache (pubkey decompression / message hash-to-curve)",
            labels + ["cache"],
            registry=self.registry,
        )
        self.point_cache_misses = Gauge(
            "tpu_point_cache_misses",
            "Cumulative lru_cache misses (cold decodes paid on host)",
            labels + ["cache"],
            registry=self.registry,
        )
        self.point_cache_size = Gauge(
            "tpu_point_cache_entries",
            "Current entries held by the tpu_impl point caches",
            labels + ["cache"],
            registry=self.registry,
        )
        # cold-start observability: the bulk point-cache
        # warm-up path — lanes decoded per warm pass by cache and
        # source (device = sharded bulk kernels, python = host bigint
        # rung, cached = already warm, invalid = rejected lanes), plus
        # wall seconds per warm pass
        self.point_cache_warmup_lanes = counter(
            "tpu_point_cache_warmup_lanes_total",
            "Point-cache warm-up lanes by cache (pubkey decompression / "
            "message hash-to-curve) and source (device bulk kernels, "
            "python host decode, cached = skipped, invalid = rejected)",
            ["cache", "source"],
        )
        self.point_cache_warmup_seconds = Histogram(
            "tpu_point_cache_warmup_seconds",
            "Wall seconds per bulk warm-up pass (startup or "
            "validator-set rotation)",
            labels,
            registry=self.registry,
            buckets=(0.05, 0.2, 1.0, 5.0, 20.0, 60.0, 300.0),
        )
        # wire codec observability: per-frame encode/decode
        # host CPU and byte volume, attributed to the codec that
        # carried the frame (binary vs json fallback) — the rollout
        # dashboard for the binary wire format
        self.wire_encode_seconds = Histogram(
            "wire_encode_seconds",
            "Envelope encode host seconds per transport frame, by codec",
            labels + ["codec"],
            registry=self.registry,
            buckets=(1e-5, 5e-5, 2e-4, 1e-3, 5e-3, 0.02, 0.1),
        )
        self.wire_decode_seconds = Histogram(
            "wire_decode_seconds",
            "Envelope decode host seconds per transport frame, by codec",
            labels + ["codec"],
            registry=self.registry,
            buckets=(1e-5, 5e-5, 2e-4, 1e-3, 5e-3, 0.02, 0.1),
        )
        self.wire_bytes = Counter(
            "wire_bytes_total",
            "Transport frame bytes by direction and codec (binary "
            "broadcast frames are encoded once and written per peer; "
            "every write counts here)",
            labels + ["dir", "codec"],
            registry=self.registry,
        )
        self.wire_frames = Counter(
            "wire_frames_total",
            "Transport frames by direction and codec",
            labels + ["dir", "codec"],
            registry=self.registry,
        )
        self.wire_peer_quarantine = Counter(
            "wire_peer_quarantine_total",
            "Temporary peer mutes imposed after repeated malformed "
            "frames (p2p codec quarantine, exponential backoff)",
            labels + ["peer_index"],
            registry=self.registry,
        )
        # Byzantine evidence: every attributed detection made
        # by the protocol components — qbft equivocation/forged
        # justifications/replay/floods, conflicting or spoofed partial
        # signatures. Attribution is authenticated before recording, so
        # the counter names ONLY the adversary (the acceptance
        # style); it feeds the per-peer quarantine primitive.
        self.byzantine_evidence = Counter(
            "byzantine_evidence_total",
            "Attributable Byzantine-behaviour detections by offending "
            "peer share index and evidence kind "
            "(core/evidence.py kind catalogue)",
            labels + ["peer", "kind"],
            registry=self.registry,
        )
        # multi-tenant crypto-plane service: per-tenant flush
        # attribution, admission-shed counts, queue occupancy, breaker
        # state machine and quarantined flushes — the isolation
        # dashboard that answers "who is hurting whom" on a shared mesh
        self.plane_tenant_lanes = Counter(
            "tpu_plane_tenant_lanes_total",
            "Crypto lanes flushed through the shared plane, by tenant "
            "(FlushStats.tenant_lanes attribution)",
            labels + ["tenant"],
            registry=self.registry,
        )
        self.plane_tenant_shed = Counter(
            "tpu_plane_tenant_shed_total",
            "Submissions shed at admission with PlaneOverloadError, by "
            "tenant and bound hit (jobs = queue depth, lanes = lane "
            "depth); shed work serves from the submitter's host rung",
            labels + ["tenant", "reason"],
            registry=self.registry,
        )
        self.plane_tenant_queue = Gauge(
            "tpu_plane_tenant_queue_lanes",
            "Pending (queued + in-flight) lanes in the tenant's "
            "submission queue at the most recent admission",
            labels + ["tenant"],
            registry=self.registry,
        )
        self.plane_tenant_breaker = Gauge(
            "tpu_plane_tenant_breaker_state",
            "Per-tenant circuit breaker state "
            "(0 = closed, 1 = half-open, 2 = open/quarantined)",
            labels + ["tenant"],
            registry=self.registry,
        )
        self.plane_tenant_breaker_transitions = Counter(
            "tpu_plane_tenant_breaker_transitions_total",
            "Breaker state transitions by tenant and entered state",
            labels + ["tenant", "state"],
            registry=self.registry,
        )
        self.plane_tenant_quarantined = Counter(
            "tpu_plane_tenant_quarantined_flushes_total",
            "Dispatches served by the tenant's own quarantine flushes "
            "(breaker open/half-open) instead of the shared RLC batch",
            labels + ["tenant"],
            registry=self.registry,
        )
        self.plane_tenant_submit_seconds = Histogram(
            "tpu_plane_tenant_submit_seconds",
            "Admission-to-result wall seconds per tenant submission "
            "through the crypto-plane service",
            labels + ["tenant"],
            registry=self.registry,
            buckets=(0.005, 0.02, 0.05, 0.1, 0.5, 2.0, 10.0, 60.0),
        )
        # remote crypto plane: the client-side view of the
        # networked service rung — every failover to the local ladder,
        # window/remote sheds, connection churn and rung state, all
        # attributed to the dialing tenant
        self.plane_remote_failovers = Counter(
            "tpu_plane_remote_failovers_total",
            "Jobs degraded from the remote crypto plane to the local "
            "ladder, by tenant and failure reason (down, probing, io, "
            "codec, timeout, heartbeat, shed, remote_error)",
            labels + ["tenant", "reason"],
            registry=self.registry,
        )
        self.plane_remote_failover_lanes = Counter(
            "tpu_plane_remote_failover_lanes_total",
            "Crypto lanes served by the local ladder after a remote "
            "failure, by tenant and failure reason",
            labels + ["tenant", "reason"],
            registry=self.registry,
        )
        self.plane_remote_shed = Counter(
            "tpu_plane_remote_shed_total",
            "Typed sheds on the remote rung by tenant and reason: the "
            "client's bounded in-flight window (jobs, lanes) and "
            "server admission sheds relayed as CryptoShed frames "
            "(remote_jobs, remote_lanes, remote_closed)",
            labels + ["tenant", "reason"],
            registry=self.registry,
        )
        self.plane_remote_connects = Counter(
            "tpu_plane_remote_connects_total",
            "Authenticated connections established to the remote "
            "crypto-plane service, by tenant (first dial + reconnects)",
            labels + ["tenant"],
            registry=self.registry,
        )
        self.plane_remote_disconnects = Counter(
            "tpu_plane_remote_disconnects_total",
            "Remote crypto-plane connections torn down, by tenant and "
            "reason (io, codec, heartbeat, closed)",
            labels + ["tenant", "reason"],
            registry=self.registry,
        )
        self.plane_remote_state = Gauge(
            "tpu_plane_remote_state",
            "Remote crypto-plane rung state per tenant "
            "(0 = down/local-only, 1 = probing half-open, 2 = up)",
            labels + ["tenant"],
            registry=self.registry,
        )
        # duty-rooted tracing: per-step latency from span
        # ends plus the slow-duty detector's wall-time/budget verdicts
        self.step_latency = Histogram(
            "core_step_latency_seconds",
            "Workflow step latency derived from span ends (wire edges, "
            "parsigex/qbft receive paths, crypto-plane stages)",
            labels + ["step"],
            registry=self.registry,
            buckets=(0.001, 0.005, 0.02, 0.05, 0.2, 0.5, 2.0, 10.0),
        )
        self.duty_wall_seconds = Histogram(
            "core_duty_wall_seconds",
            "Duty wall time: first span start to last span end of the "
            "duty trace, observed at duty expiry",
            labels + ["duty"],
            registry=self.registry,
            buckets=(0.05, 0.2, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 60.0),
        )
        self.duty_slow = counter(
            "core_duty_slow_total",
            "Duties whose traced wall time exceeded the deadline budget "
            "(slow-duty detector over span ends)",
            ["duty"],
        )
        # kernel auto-tuner + AOT compile-artifact cache:
        # profile lifecycle, per-axis decisions and micro-bench
        # timings from core/autotune.resolve, plus persistent
        # compile-cache effectiveness from jaxcache.cache_stats —
        # cold-start regressions show up here instead of in a
        # 6-minute boot
        self.autotune_profile_events = counter(
            "tpu_autotune_profile_events_total",
            "Kernel-profile lifecycle events from the startup tuner "
            "(hit, miss, stale, corrupt, rebuilt, off, skipped)",
            ["event"],
        )
        self.autotune_decisions = counter(
            "tpu_autotune_decisions_total",
            "Kernel-routing decisions applied at startup, per tunable "
            "axis, with the choice and where it came from (profile, "
            "tuned, env, default, inapplicable)",
            ["axis", "choice", "source"],
        )
        self.autotune_bench_seconds = Histogram(
            "tpu_autotune_bench_seconds",
            "Per-candidate micro-bench dispatch time measured by the "
            "startup tuner (best of its reps)",
            labels + ["axis", "choice"],
            registry=self.registry,
            buckets=(0.0005, 0.002, 0.01, 0.05, 0.2, 1.0, 5.0, 30.0),
        )
        self.autotune_prewarm_seconds = Histogram(
            "tpu_autotune_prewarm_seconds",
            "Ahead-of-time compile/load time per prewarm shape for the "
            "chosen kernel variants (cold = real XLA compile, warm = "
            "persistent-cache load)",
            labels + ["axis"],
            registry=self.registry,
            buckets=(0.01, 0.05, 0.2, 1.0, 5.0, 30.0, 120.0, 600.0),
        )
        self.compile_cache_hits = Gauge(
            "tpu_compile_cache_hits",
            "Persistent XLA compile-cache hits since process start "
            "(jaxcache monitoring listener; polled at scrape)",
            labels,
            registry=self.registry,
        )
        self.compile_cache_misses = Gauge(
            "tpu_compile_cache_misses",
            "Persistent XLA compile-cache misses (cache-consulting "
            "compile requests minus hits) since process start",
            labels,
            registry=self.registry,
        )
        self.compile_cache_entries = Gauge(
            "tpu_compile_cache_entries",
            "Artifact files in this process's persistent compile-cache "
            "dir (tuner profile excluded)",
            labels,
            registry=self.registry,
        )
        self.compile_cache_bytes = Gauge(
            "tpu_compile_cache_bytes",
            "Bytes on disk in this process's persistent compile-cache "
            "dir (tuner profile excluded)",
            labels,
            registry=self.registry,
        )
        # flight recorder + plane profiler + duty SLO engine:
        # the post-mortem spine's own telemetry — ring intake/eviction,
        # dump triggers, per-kernel-family device time, device duty
        # cycle, per-tenant device attribution, and the rolling
        # error-budget burn state
        self.flightrec_events = counter(
            "flightrec_events_total",
            "Events recorded into the flight-recorder ring, by category",
            ["category"],
        )
        self.flightrec_dropped = Gauge(
            "flightrec_dropped_events",
            "Events evicted from a full flight-recorder category ring "
            "(cumulative; the recorder owns the counter state)",
            labels + ["category"],
            registry=self.registry,
        )
        self.flightrec_dumps = Gauge(
            "flightrec_dumps",
            "Flight-recorder JSONL dumps written, by trigger (demand, "
            "sigterm, crash, stop; cumulative — recorder-owned state)",
            labels + ["trigger"],
            registry=self.registry,
        )
        self.plane_kernel_seconds = counter(
            "tpu_plane_kernel_seconds_total",
            "Device-dispatch wall seconds by mesh kernel family "
            "(mesh/verify_rlc, mesh/step, ... per kernel_inventory; "
            "'device' = plane without program hooks), sampled by the "
            "plane profiler from SlotCryptoPlane.on_program",
            ["family"],
        )
        self.plane_device_utilization = Gauge(
            "tpu_plane_device_utilization",
            "Device duty cycle: flush device_span seconds over the "
            "profiler's rolling window, 0..1",
            labels,
            registry=self.registry,
        )
        self.plane_tenant_device_seconds = Counter(
            "tpu_plane_tenant_device_seconds_total",
            "Flush device_span seconds attributed to each tenant by "
            "its live-lane share (FlushStats.tenant_lanes)",
            labels + ["tenant"],
            registry=self.registry,
        )
        self.slo_burn_rate = Gauge(
            "core_slo_burn_rate",
            "Error-budget burn rate by objective (duty_miss, "
            "step_latency), tenant, and alert window (fast, slow); "
            "1.0 spends the budget exactly at the allowed pace",
            labels + ["slo", "tenant", "window"],
            registry=self.registry,
        )
        self.slo_budget_remaining = Gauge(
            "core_slo_budget_remaining",
            "Fraction of the slow-window error budget still unspent, "
            "by objective and tenant (0..1)",
            labels + ["slo", "tenant"],
            registry=self.registry,
        )
        self.slo_alerts = Counter(
            "core_slo_alerts_total",
            "Burn-rate alert rising edges by objective, tenant, and "
            "severity (critical gates /readyz via the health checker)",
            labels + ["slo", "tenant", "severity"],
            registry=self.registry,
        )
        self.stack_colocated = Gauge(
            "stack_colocated_processes",
            "Co-located validator-stack processes found on this host "
            "by the stacksnipe /proc scan, by binary name",
            labels + ["binary"],
            registry=self.registry,
        )
        # device-accelerated ceremonies: verification lanes
        # by ceremony stage and execution path, plus the resharing
        # lifecycle (operator join/leave, threshold change, proactive
        # rotation) as a live, benchmarked workload
        self.dkg_verify_lanes = counter(
            "dkg_verify_lanes_total",
            "Ceremony verification lanes by stage (pok / share / "
            "pubshare_eval / reshare_share / reshare_pubshare) and "
            "execution path (device batched kernels vs host bigint)",
            ["stage", "path"],
        )
        self.dkg_reshare_total = counter(
            "dkg_reshare_total",
            "Key resharing ceremonies by kind (join / leave / "
            "threshold / rotate) and result (ok / error)",
            ["kind", "result"],
        )
        self.dkg_reshare_seconds = Histogram(
            "dkg_reshare_seconds",
            "Wall seconds per resharing ceremony (rounds + share "
            "derivation, excluding transport wait on remote dealers)",
            labels,
            registry=self.registry,
            buckets=(0.05, 0.2, 1.0, 5.0, 20.0, 60.0, 300.0),
        )
        self.dkg_reshare_validators = counter(
            "dkg_reshare_validators_total",
            "Validators whose shares were rotated by completed "
            "resharing ceremonies",
        )

    def labels(self, metric, *extra):
        return metric.labels(*self._label_values, *extra)

    def observe_point_caches(self) -> None:
        """Refresh the point-cache gauges from the PointCache counters of
        the registry's TorchImpl. Only when tbls/torch_impl is already
        imported — a scrape must never pull torch into a host-only
        process."""
        import sys

        mod = sys.modules.get("charon_tpu_torch.tbls.torch_impl")
        if mod is None:
            return
        from charon_tpu_torch import tbls

        impl = tbls._current
        if not isinstance(impl, mod.TorchImpl):
            return
        for name, cache in (
            ("pubkey", impl.pubkey_points),
            ("message", impl.msg_points),
        ):
            info = cache.cache_info()
            self.labels(self.point_cache_hits, name).set(info.hits)
            self.labels(self.point_cache_misses, name).set(info.misses)
            self.labels(self.point_cache_size, name).set(info.currsize)

    def observe_dkg_verify(self, stage: str, path: str, lanes: int) -> None:
        """Record one ceremony verification wave: `lanes` checks of
        `stage` served by `path` ("device" batched kernels or "host"
        python bigint fallback)."""
        if lanes:
            self.labels(self.dkg_verify_lanes, stage, path).inc(lanes)

    def observe_reshare(
        self,
        kind: str,
        result: str,
        seconds: float | None = None,
        validators: int = 0,
    ) -> None:
        """Record one resharing ceremony outcome. `kind` is the
        operator-facing mode (join / leave / threshold / rotate),
        `validators` the rotated share count on success."""
        self.labels(self.dkg_reshare_total, kind, result).inc()
        if seconds is not None:
            self.labels(self.dkg_reshare_seconds).observe(
                max(0.0, float(seconds))
            )
        if validators:
            self.labels(self.dkg_reshare_validators).inc(validators)

    def observe_warmup(self, stats: dict) -> None:
        """Record one bulk warm-up pass (the stats dict returned by
        tpu_impl.warm_point_caches / SlotCoalescer.warm_caches).
        Thread-safe — warm-up runs on its own worker thread."""
        for cache in ("pubkey", "message"):
            for source, count in stats.get(cache, {}).items():
                if count:
                    self.labels(
                        self.point_cache_warmup_lanes, cache, source
                    ).inc(count)
        self.labels(self.point_cache_warmup_seconds).observe(
            max(0.0, float(stats.get("seconds", 0.0)))
        )

    def wire_hook(self):
        """P2PNode.wire_observer sink: called per frame with
        (direction "tx"|"rx", codec "binary"|"json", frame_bytes,
        codec_seconds | None). seconds is None for broadcast cache
        hits — the frame hit the wire but paid no encode (the
        single-encode broadcast), so only bytes/frames count. Runs on
        the event loop; prometheus objects are thread-safe anyway."""

        def hook(direction, codec_name, nbytes, seconds) -> None:
            self.labels(self.wire_bytes, direction, codec_name).inc(nbytes)
            self.labels(self.wire_frames, direction, codec_name).inc()
            if seconds is None:
                return
            hist = (
                self.wire_encode_seconds
                if direction == "tx"
                else self.wire_decode_seconds
            )
            self.labels(hist, codec_name).observe(max(0.0, seconds))

        return hook

    def tenant_hook(self):
        """CryptoPlaneService.observer sink: typed service events ->
        the tenant-labeled metric families. Runs on the event loop;
        prometheus client objects are thread-safe anyway."""
        state_value = {"closed": 0, "half_open": 1, "open": 2}

        def hook(kind: str, tenant: str, **f) -> None:
            if kind == "shed":
                self.labels(self.plane_tenant_shed, tenant, f["reason"]).inc()
            elif kind == "queue":
                self.labels(self.plane_tenant_queue, tenant).set(f["lanes"])
            elif kind == "breaker":
                self.labels(self.plane_tenant_breaker, tenant).set(
                    state_value.get(f["state"], 0)
                )
                self.labels(
                    self.plane_tenant_breaker_transitions, tenant, f["state"]
                ).inc()
            elif kind == "complete":
                self.labels(self.plane_tenant_submit_seconds, tenant).observe(
                    max(0.0, f["seconds"])
                )
                if f.get("quarantined"):
                    self.labels(self.plane_tenant_quarantined, tenant).inc()

        return hook

    def remote_hook(self, tenant: str):
        """core/cryptosvc_client.RemotePlane observer sink: typed
        client events -> the tenant-labeled remote-plane families.
        Tenant identity is bound once here — the client never passes
        labels (and MUST never pass secrets) into metrics."""
        state_value = {"down": 0, "probing": 1, "up": 2}

        def hook(kind: str, **f) -> None:
            if kind == "failover":
                reason = f.get("reason", "unknown")
                self.labels(
                    self.plane_remote_failovers, tenant, reason
                ).inc()
                self.labels(
                    self.plane_remote_failover_lanes, tenant, reason
                ).inc(f.get("lanes", 0))
            elif kind == "shed":
                self.labels(
                    self.plane_remote_shed, tenant, f["reason"]
                ).inc()
            elif kind == "remote_shed":
                self.labels(
                    self.plane_remote_shed,
                    tenant,
                    f"remote_{f['reason']}",
                ).inc()
            elif kind == "connect":
                self.labels(self.plane_remote_connects, tenant).inc()
            elif kind == "disconnect":
                self.labels(
                    self.plane_remote_disconnects, tenant, f["reason"]
                ).inc()
            elif kind == "state":
                self.labels(self.plane_remote_state, tenant).set(
                    state_value.get(f["state"], 0)
                )

        return hook

    def autotune_hook(self):
        """core/autotune.resolve observer sink: typed tuner events ->
        the autotune metric families. Runs on the tuner's worker
        thread; prometheus client objects are thread-safe."""

        def hook(kind: str, **f) -> None:
            if kind == "profile":
                self.labels(self.autotune_profile_events, f["event"]).inc()
            elif kind == "decision":
                self.labels(
                    self.autotune_decisions,
                    f["axis"],
                    f["choice"],
                    f["source"],
                ).inc()
            elif kind == "bench":
                self.labels(
                    self.autotune_bench_seconds, f["axis"], f["choice"]
                ).observe(max(0.0, f["seconds"]))
            elif kind == "prewarm":
                self.labels(
                    self.autotune_prewarm_seconds, f["axis"]
                ).observe(max(0.0, f["seconds"]))

        return hook

    def observe_compile_cache(self) -> None:
        """Refresh the compile-cache gauges from the kernel build cache:
        the nvcc libraries in charon_tpu_torch/_build/ (entries and
        bytes). Only when ops/mont_kernels is already imported, as a
        host-only process has no kernels to report. nvcc's cache keeps
        no hit or miss counts, so those two gauges stay unset."""
        import sys

        mk = sys.modules.get("charon_tpu_torch.ops.mont_kernels")
        if mk is None:
            return
        entries = nbytes = 0
        try:
            for lib in mk.BUILD_DIR.glob("*.so"):
                entries += 1
                try:
                    nbytes += lib.stat().st_size
                except OSError:
                    pass
        except OSError:
            pass
        self.labels(self.compile_cache_entries).set(entries)
        self.labels(self.compile_cache_bytes).set(nbytes)

    def byzantine_hook(self):
        """core/evidence.EvidenceRegistry hook: one increment per
        attributed Byzantine detection, labelled by the offending peer
        (share index) and evidence kind."""

        def hook(peer, kind: str) -> None:
            self.labels(self.byzantine_evidence, str(peer), kind).inc()

        return hook

    def peer_quarantine_hook(self):
        """P2PNode.quarantine_observer sink: count imposed peer mutes
        by peer index."""

        def hook(peer_idx: int, mute_seconds: float) -> None:
            self.labels(self.wire_peer_quarantine, str(peer_idx)).inc()

        return hook

    def flightrec_hook(self):
        """app/flightrec.FlightRecorder observer: one increment per
        recorded event, by category. Runs on whatever thread recorded
        the event; prometheus client objects are thread-safe."""

        def hook(category: str, kind: str) -> None:
            self.labels(self.flightrec_events, category).inc()

        return hook

    def observe_flightrec(self, rec) -> None:
        """Refresh the recorder-owned cumulative state (eviction and
        dump counts) into the flightrec gauges — same polled-gauge
        pattern as the point caches."""
        for category, n in rec.dropped_total.items():
            if n:
                self.labels(self.flightrec_dropped, category).set(n)
        for trigger, n in rec.dumps_total.items():
            self.labels(self.flightrec_dumps, trigger).set(n)

    def profiler_hooks(self):
        """app/planeprof.PlaneProfiler callbacks -> the kernel-family /
        tenant-attribution / duty-cycle families. All run on the device
        worker thread; prometheus client objects are thread-safe."""

        def on_sample(family: str, seconds: float) -> None:
            self.labels(self.plane_kernel_seconds, family).inc(
                max(0.0, seconds)
            )

        def on_tenant(tenant: str, seconds: float) -> None:
            self.labels(self.plane_tenant_device_seconds, tenant).inc(
                max(0.0, seconds)
            )

        def on_utilization(fraction: float) -> None:
            self.labels(self.plane_device_utilization).set(fraction)

        return on_sample, on_tenant, on_utilization

    def observe_slo(self, rows) -> None:
        """Export one SLOEngine.evaluate() pass into the core_slo_*
        gauges (run.py's health sample loop cadence)."""
        for r in rows:
            self.labels(
                self.slo_burn_rate, r["slo"], r["tenant"], "fast"
            ).set(r["fast_burn"])
            self.labels(
                self.slo_burn_rate, r["slo"], r["tenant"], "slow"
            ).set(r["slow_burn"])
            self.labels(
                self.slo_budget_remaining, r["slo"], r["tenant"]
            ).set(r["budget_remaining"])

    def slo_alert_hook(self):
        """SLOEngine.on_alert sink: count burn-rate alert rising edges."""

        def hook(slo: str, tenant: str, severity: str) -> None:
            self.labels(self.slo_alerts, slo, tenant, severity).inc()

        return hook

    def stacksnipe_hook(self):
        """app/stacksnipe.StackSniper.on_report sink: publish the scan
        as per-binary gauges, zeroing binaries that disappeared since
        the previous scan."""
        seen: set[str] = set()

        def hook(report: dict) -> None:
            for binary in seen - set(report):
                self.labels(self.stack_colocated, binary).set(0)
            for binary, pids in report.items():
                self.labels(self.stack_colocated, binary).set(len(pids))
            seen.clear()
            seen.update(report)

        return hook

    def render(self) -> bytes:
        self.observe_point_caches()
        self.observe_compile_cache()
        return generate_latest(self.registry)


# wire() edges -> the counter each one increments when it fires
# (ref: the reference instruments components directly; one wire option
# keeps the components metric-free here)
_EDGE_COUNTERS = {
    "fetcher.fetch": "duty_total",
    "dutydb.store": "consensus_decided",
    "parsigdb.store_external": "parsig_received",
    "sigagg.aggregate": "sigagg_total",
    "broadcaster.broadcast": "bcast_total",
}


def instrument(metrics: "ClusterMetrics"):
    """wire() option: count workflow-edge completions per duty type."""

    def option(name: str, fn):
        attr = _EDGE_COUNTERS.get(name)
        if attr is None:
            return fn
        counter = getattr(metrics, attr)

        async def wrapped(duty, *args, **kwargs):
            result = await fn(duty, *args, **kwargs)
            metrics.labels(counter, str(duty.type.name.lower())).inc()
            return result

        return wrapped

    return option


def span_metrics(metrics: "ClusterMetrics"):
    """Tracer hook (app/tracer.Tracer.hooks): observe every finished
    span's duration into the per-step latency histogram. Runs on
    whatever thread records the span — prometheus client objects are
    thread-safe."""

    def hook(span) -> None:
        # bridged crypto-plane stages are recorded once per duty trace
        # that rode the flush; copies carry shared=True so one physical
        # flush observes each stage latency exactly once
        if span.attrs.get("shared"):
            return
        metrics.labels(metrics.step_latency, span.name).observe(
            max(0.0, span.end - span.start)
        )

    return hook


class SlowDutyDetector:
    """Duty wall-time vs deadline budget, derived from span ends
    ('was the duty late?' answered from the trace, not logs).

    Feed every finished span via `observe` (a tracer hook); at duty
    expiry call `finalize(duty, budget)` — it computes the traced wall
    time (first span start to last span end across the duty's
    deterministic trace) and flags the duty slow when it exceeded the
    budget. State is per-trace and popped at finalize, so memory is
    bounded by in-flight duties."""

    def __init__(self, metrics: "ClusterMetrics | None" = None) -> None:
        import threading

        self.metrics = metrics
        self._window: dict[str, tuple[float, float]] = {}
        # observe() runs as a tracer hook on whatever thread records the
        # span — device worker threads for bridged plane spans, the
        # event loop for wire edges. Serialize the read-modify-write
        # (and the eviction scan) or concurrent observes lose window
        # updates / crash mid-iteration.
        self._lock = threading.Lock()
        self.slow_total = 0
        self.last: dict | None = None  # most recent finalize verdict

    def observe(self, span) -> None:
        with self._lock:
            cur = self._window.get(span.trace_id)
            if cur is None:
                self._window[span.trace_id] = (span.start, span.end)
            else:
                self._window[span.trace_id] = (
                    min(cur[0], span.start),
                    max(cur[1], span.end),
                )
            # bounded: a trace that never finalizes (non-duty spans)
            # must not leak; duty traces are finalized long before 4096
            # others
            if len(self._window) > 4096:
                for k in list(self._window)[:2048]:
                    self._window.pop(k, None)

    def finalize(self, duty, budget: float) -> float | None:
        """Wall seconds of the duty's trace, or None when no spans were
        recorded. `budget` is the duty's allotted seconds (deadline
        minus slot start)."""
        from charon_tpu_torch.app.tracer import duty_trace_id

        with self._lock:
            window = self._window.pop(duty_trace_id(duty), None)
        if window is None:
            return None
        wall = max(0.0, window[1] - window[0])
        slow = budget > 0 and wall > budget
        self.last = {
            "duty": str(duty),
            "wall_seconds": wall,
            "budget_seconds": budget,
            "slow": slow,
        }
        d = str(duty.type.name).lower()
        if self.metrics is not None:
            self.metrics.labels(self.metrics.duty_wall_seconds, d).observe(
                wall
            )
        if slow:
            self.slow_total += 1
            if self.metrics is not None:
                self.metrics.labels(self.metrics.duty_slow, d).inc()
            from charon_tpu_torch.app import log

            log.warn(
                "slow duty: traced wall time exceeded deadline budget",
                topic="tracer",
                duty=str(duty),
                wall_seconds=round(wall, 3),
                budget_seconds=round(budget, 3),
            )
        return wall


# cProfile is interpreter-global state: exactly one /debug/pprof/profile
# may hold it at a time (a concurrent enable() raises on CPython 3.12)
_PROFILE_ACTIVE = asyncio.Lock()


async def serve_monitoring(
    host: str,
    port: int,
    metrics: ClusterMetrics,
    health_checker=None,
    ready_fn=None,
    consensus_dump=None,
    tracer=None,
    flightrec=None,
    profiler=None,
) -> asyncio.AbstractServer:
    """Minimal HTTP endpoint: /metrics, /livez, /readyz, /debug/traces,
    /debug/duty/<slot>, /debug/consensus (ref: app/monitoringapi.go:47;
    docs/consensus.md:74 for the consensus debugger), /debug/flight
    (the flight-recorder ring, filterable by category/tenant/
    slot, ?format=text for the incident timeline, ?view=profile for the
    plane profiler snapshot). `tracer` overrides the process-global span
    store for the debug trace endpoints."""

    async def handle(reader, writer):
        try:
            request = await reader.readline()
            while (await reader.readline()) not in (b"\r\n", b""):
                pass
            path = request.split()[1].decode() if request.split() else "/"
            if path.startswith("/metrics"):
                body = metrics.render()
                ctype = b"text/plain; version=0.0.4"
                status = b"200 OK"
            elif path.startswith("/debug/traces"):
                # recorded workflow spans (ref: app/monitoringapi.go debug
                # endpoints + /debug/consensus, docs/consensus.md:74)
                from charon_tpu_torch.app import tracer as _tracer

                from urllib.parse import parse_qs, urlsplit

                query = parse_qs(urlsplit(path).query)
                trace_id = (query.get("trace_id") or [None])[0]
                body = _json.dumps(
                    (tracer or _tracer.global_tracer()).dump(trace_id)
                ).encode()
                ctype = b"application/json"
                status = b"200 OK"
            elif path.startswith("/debug/duty/"):
                # assembled per-duty timeline for one slot: every trace
                # with spans at that slot, depth-annotated (JSON), or a
                # plain-text waterfall with ?format=text
                from charon_tpu_torch.app import tracer as _tracer

                from urllib.parse import parse_qs, urlsplit

                parts = urlsplit(path)
                raw_slot = parts.path.split("/debug/duty/", 1)[1].strip("/")
                fmt = (parse_qs(parts.query).get("format") or ["json"])[0]
                try:
                    slot = int(raw_slot)
                except ValueError:
                    slot = None
                timelines = (
                    _tracer.duty_timeline(slot, tracer=tracer)
                    if slot is not None
                    else []
                )
                if not timelines:
                    body = b"no spans recorded for that slot"
                    ctype = b"text/plain"
                    status = b"404 Not Found"
                elif fmt == "text":
                    body = _tracer.render_waterfall(timelines).encode()
                    ctype = b"text/plain"
                    status = b"200 OK"
                else:
                    body = _json.dumps(timelines).encode()
                    ctype = b"application/json"
                    status = b"200 OK"
            elif path.startswith("/debug/pprof/profile"):
                # CPU profile of the event-loop thread for ?seconds=N
                # (ref: monitoringapi.go net/http/pprof profile endpoint)
                import cProfile
                import io
                import math
                import pstats
                from urllib.parse import parse_qs, urlsplit

                q = parse_qs(urlsplit(path).query)
                try:
                    secs = float((q.get("seconds") or ["5"])[0])
                except ValueError:
                    secs = float("nan")
                if not math.isfinite(secs) or secs < 0:
                    body = b"bad seconds parameter"
                    ctype = b"text/plain"
                    status = b"400 Bad Request"
                elif _PROFILE_ACTIVE.locked():
                    # cProfile is interpreter-global: a second enable()
                    # raises; serialize instead of crashing the handler
                    body = b"another profile is already running"
                    ctype = b"text/plain"
                    status = b"503 Service Unavailable"
                else:
                    async with _PROFILE_ACTIVE:
                        prof = cProfile.Profile()
                        prof.enable()
                        try:
                            await asyncio.sleep(min(secs, 60.0))
                        finally:
                            prof.disable()
                    buf = io.StringIO()
                    pstats.Stats(prof, stream=buf).sort_stats(
                        pstats.SortKey.CUMULATIVE
                    ).print_stats(60)
                    body = buf.getvalue().encode()
                    ctype = b"text/plain"
                    status = b"200 OK"
            elif path.startswith("/debug/pprof/threads"):
                # all-thread stack dump — the goroutine-dump analogue
                import sys as _sys
                import threading as _threading
                import traceback as _traceback

                names = {
                    t.ident: t.name for t in _threading.enumerate()
                }
                parts = []
                for tid, frame in _sys._current_frames().items():
                    parts.append(
                        f"--- thread {tid} ({names.get(tid, '?')}) ---\n"
                        + "".join(_traceback.format_stack(frame))
                    )
                body = "\n".join(parts).encode()
                ctype = b"text/plain"
                status = b"200 OK"
            elif path.startswith("/debug/pprof/heap"):
                # allocation snapshots via tracemalloc. Tracing costs
                # ~2x on every allocation, so it NEVER arms implicitly:
                # ?start=1 arms, ?stop=1 disarms, bare GET reports (or
                # explains how to arm) — unlike Go's free heap profile,
                # the analogue here is an explicit toggle
                import tracemalloc
                from urllib.parse import parse_qs, urlsplit

                q = parse_qs(urlsplit(path).query)
                if q.get("start"):
                    if not tracemalloc.is_tracing():
                        tracemalloc.start(10)
                    body = b"tracemalloc armed; GET without params for a snapshot, ?stop=1 to disarm"
                elif q.get("stop"):
                    if tracemalloc.is_tracing():
                        tracemalloc.stop()
                    body = b"tracemalloc stopped"
                elif not tracemalloc.is_tracing():
                    body = (
                        b"tracemalloc not armed; GET ?start=1 to begin "
                        b"tracing (allocation overhead until ?stop=1)"
                    )
                else:
                    snap = tracemalloc.take_snapshot()
                    lines = [
                        str(stat)
                        for stat in snap.statistics("lineno")[:40]
                    ]
                    body = "\n".join(lines).encode()
                ctype = b"text/plain"
                status = b"200 OK"
            elif path.startswith("/debug/flight"):
                # the flight-recorder ring: newest-first-
                # bounded JSON by default, ?format=text for the merged
                # incident timeline, filters category/tenant/slot/limit,
                # ?view=profile for the plane profiler's kernel-family
                # decomposition. 404 when no recorder is wired (the
                # endpoint must say so, not fake an empty incident).
                from urllib.parse import parse_qs, urlsplit

                q = parse_qs(urlsplit(path).query)

                def one(name, conv=str):
                    raw = (q.get(name) or [None])[0]
                    if raw is None:
                        return None
                    try:
                        return conv(raw)
                    except ValueError:
                        return None

                if flightrec is None:
                    body = b"flight recorder not enabled"
                    ctype = b"text/plain"
                    status = b"404 Not Found"
                elif one("view") == "profile":
                    if profiler is None:
                        body = b"plane profiler not enabled"
                        ctype = b"text/plain"
                        status = b"404 Not Found"
                    else:
                        body = _json.dumps(profiler.snapshot()).encode()
                        ctype = b"application/json"
                        status = b"200 OK"
                else:
                    from charon_tpu_torch.app import flightrec as _flightrec

                    events = flightrec.events(
                        category=one("category"),
                        tenant=one("tenant"),
                        slot=one("slot", int),
                        limit=one("limit", int),
                    )
                    if one("format") == "text":
                        body = _flightrec.render_timeline(events).encode()
                        ctype = b"text/plain"
                    else:
                        body = _json.dumps(
                            {
                                "schema": _flightrec.SCHEMA_VERSION,
                                "node": flightrec.node,
                                "events": [
                                    e.to_dict(node=flightrec.node)
                                    for e in events
                                ],
                            }
                        ).encode()
                        ctype = b"application/json"
                    status = b"200 OK"
            elif path.startswith("/debug/consensus"):
                body = _json.dumps(
                    consensus_dump() if consensus_dump else []
                ).encode()
                ctype = b"application/json"
                status = b"200 OK"
            elif path.startswith("/livez"):
                body = b"ok"
                ctype = b"text/plain"
                status = b"200 OK"
            elif path.startswith("/readyz"):
                ready = ready_fn() if ready_fn else True
                healthy = health_checker.healthy() if health_checker else True
                ok = ready and healthy
                if ok:
                    body = b"ok"
                else:
                    # name every failing check with its severity so the
                    # operator sees WHY (ref: monitoringapi readyz errors)
                    lines = ["not ready"]
                    if health_checker is not None:
                        lines += [
                            f"{c.severity}: {c.name} - {c.description}"
                            for c in health_checker.failing()
                        ]
                    body = "\n".join(lines).encode()
                ctype = b"text/plain"
                status = b"200 OK" if ok else b"503 Service Unavailable"
            else:
                body = b"not found"
                ctype = b"text/plain"
                status = b"404 Not Found"
            writer.write(
                b"HTTP/1.1 " + status + b"\r\nContent-Type: " + ctype
                + b"\r\nContent-Length: " + str(len(body)).encode()
                + b"\r\nConnection: close\r\n\r\n" + body
            )
            await writer.drain()
        finally:
            writer.close()

    return await asyncio.start_server(handle, host, port)
