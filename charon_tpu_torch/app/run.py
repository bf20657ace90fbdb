"""Application wiring: config -> running node.

Mirrors ref: app/app.go:131 Run — load the cluster lock, derive key maps,
start p2p, monitoring, the core workflow (wire()), and the lifecycle
manager. Every component is the production one; test configs swap the
beacon client for a mock and transports for in-memory fakes
(ref: app/app.go TestConfig pattern).

The port's node has one tbls backend and no degradation ladder: with
`use_tpu_tbls` it is TorchImpl on `Config.device` (the card unless the
caller asks for the CPU), else the host's NativeImpl, or PythonImpl where
the native library does not load. On the card a failed tuner, prewarm or
point-cache warm-up stops the node and `run` raises its error.
"""

from __future__ import annotations

import asyncio
import hashlib
from dataclasses import dataclass, field
from pathlib import Path

from charon_tpu_torch import tbls
from charon_tpu_torch.app import featureset, k1util, log, tracer
from charon_tpu_torch.app.eth2wrap import (
    InstrumentedClient,
    MultiClient,
    SyntheticProposerClient,
    ValidatorCache,
)
from charon_tpu_torch.app.lifecycle import LifecycleManager, Order
from charon_tpu_torch.app.metrics import ClusterMetrics, instrument, serve_monitoring
from charon_tpu_torch.cluster.lock import ClusterLock
from charon_tpu_torch.core.aggsigdb import new_agg_sigdb
from charon_tpu_torch.core.bcast import Broadcaster
from charon_tpu_torch.core.consensus import ConsensusController
from charon_tpu_torch.core.consensus_qbft import QBFTConsensus
from charon_tpu_torch.core.deadline import Deadliner, SlotClock
from charon_tpu_torch.core.dutydb import DutyDB
from charon_tpu_torch.core.fetcher import Fetcher
from charon_tpu_torch.core.inclusion import InclusionChecker, InclusionReport
from charon_tpu_torch.core.parsigdb import ParSigDB
from charon_tpu_torch.core.parsigex import DutyGater, Eth2Verifier, ParSigEx
from charon_tpu_torch.core.scheduler import Scheduler
from charon_tpu_torch.core.sigagg import SigAgg
from charon_tpu_torch.core.tracker import Tracker, tracking
from charon_tpu_torch.core.types import DutyType, PubKey, pubkey_from_bytes
from charon_tpu_torch.core.validatorapi import ValidatorAPI
from charon_tpu_torch.core.vapi_http import VapiRouter
from charon_tpu_torch.core.wire import tracing, wire
from charon_tpu_torch.eth2util import enr, keystore
from charon_tpu_torch.eth2util.signing import ForkInfo
from charon_tpu_torch.p2p.adapters import TcpParSigTransport, TcpQbftNet
from charon_tpu_torch.p2p.transport import P2PNode, PeerSpec


@dataclass
class Config:
    """ref: app/app.go:70-99 Config."""

    data_dir: str
    node_index: int  # 0-based operator index
    p2p_host: str = "127.0.0.1"
    p2p_port: int = 0
    relay_addr: str = ""  # host:port of a charon-tpu relay (NAT fallback)
    validator_api_port: int = 0
    monitoring_port: int = 0
    peer_addrs: list[tuple[str, int]] = field(default_factory=list)
    beacon_nodes: list = field(default_factory=list)  # client objects
    beacon_urls: list[str] = field(default_factory=list)  # HTTP endpoints
    simnet: bool = False
    simnet_vmock: bool = True  # in-process VC in simnet (ref: app/vmock.go)
    slot_duration: float = 12.0
    slots_per_epoch: int = 32
    genesis_time: float | None = None
    use_tpu_tbls: bool = True
    # the torch device of the TorchImpl backend and the crypto plane
    # ("cuda": every visible card; "cuda:N" one; "cpu" for tests)
    device: str = "cuda"
    # sharded crypto plane over the visible device mesh: "auto" installs
    # it when >= 2 devices are visible (single-card keeps the cheaper
    # single-device TorchImpl path), "on" forces it, "off" disables
    crypto_plane: str = "auto"
    crypto_plane_window: float = 0.02  # base coalescing window, seconds
    # adaptive window bounds: grows toward max under sustained load,
    # duty deadlines shrink it down to min (core/cryptoplane)
    crypto_plane_window_min: float = 0.002
    crypto_plane_window_max: float = 0.08
    # decode/pack pool size; 0 disables the pipelined host plane (decode
    # runs synchronously on the event loop — the pre-pipeline path)
    crypto_plane_decode_workers: int = 4
    # startup compile of the canonical duty shapes: "auto" pre-warms
    # on a real accelerator backend OR when the kernel auto-tuner left
    # a warm artifact story behind (valid tuned profile + a prewarm
    # that COMPLETED once under the same kernel sources, recorded by
    # autotune.mark_prewarmed — prewarm then costs cache loads, not
    # minutes-long compiles); "on" forces, "off" disables
    crypto_plane_prewarm: str = "auto"
    # startup kernel auto-tune (core/autotune): "auto" loads
    # the persisted per-platform profile (or micro-benches + persists
    # one on first boot); on the CPU it degrades to KernelConfig
    # defaults on any failure, on the card a failure stops the node;
    # "on" is auto but refuses hosts without the device
    # stack; "force" always re-benches; "off" applies defaults + the
    # deprecated CHARON_* env overrides only
    crypto_autotune: str = "auto"
    # persisted kernel-profile path; "" = beside the kernel build
    # (core/autotune.default_profile_path)
    crypto_autotune_profile: str = ""
    # bulk point-cache warm-up at startup: decode every
    # cluster pubshare/group key through the batched device kernels so
    # the first live slot starts at a warm cache instead of paying a
    # python-bigint burst; "auto" warms on real accelerator backends
    # only, "on" forces (python rung on CPU), "off" disables. The same
    # path re-runs at validator-set rotation (Node.rewarm_point_caches).
    crypto_plane_warmup: str = "auto"
    # signature-decode rung: "device" batches compressed-point
    # decompression into the flush programs (ops/decompress.py),
    # "python" keeps the host bigint decode, "auto" resolves to device
    # on a card and to python on the CPU
    crypto_plane_decode: str = "auto"
    # OTLP/HTTP collector for workflow spans (ref: --jaeger-address,
    # app/app.go:1014-1027 wireTracing); "" disables export
    tracing_endpoint: str = ""
    # per-node span JSONL export path; per-node files from a cluster
    # merge offline into one cross-node timeline (tracer.merge_jsonl —
    # the deterministic duty trace ids make the merge trivial)
    tracing_jsonl: str = ""
    # seeded fault-injection spec ("seed=42,drop=0.1,bn_error=0.2"; see
    # app/faultinject + testutil/chaos). "" keeps the plane inert: no
    # wrapper objects are constructed on the un-instrumented path.
    fault_injection: str = ""
    # multi-tenant crypto-plane service (core/cryptosvc): the
    # node registers its cluster as a tenant of the (possibly shared)
    # device plane; quotas bound the damage any one tenant can do to
    # the others. "" = tenant id defaults to the cluster name.
    crypto_tenant: str = ""
    crypto_tenant_weight: float = 1.0  # share of the per-round budget
    crypto_tenant_queue_jobs: int = 256  # admission bound (submissions)
    crypto_tenant_queue_lanes: int = 4096  # admission bound (lanes)
    crypto_plane_round_lanes: int = 4096  # total admission per round
    crypto_breaker_threshold: float = 0.5  # failed ratio that opens
    crypto_breaker_cooldown: float = 5.0  # seconds open -> half-open
    # networked crypto plane (core/cryptosvc_client): dial a
    # remote CryptoServiceServer at "host:port". The remote service is
    # a rung ABOVE the local plane: any remote failure (refused
    # connect, heartbeat miss, mid-flush socket death, malformed frame,
    # shed) degrades the affected jobs down the local tbls ladder —
    # never a single point of failure. "" keeps everything in-process.
    crypto_remote: str = ""
    # tenant auth token for the remote service handshake. repr=False:
    # the token must never reach logs, reprs or metrics labels
    # (analysis/rule_secret_flow enforces this).
    crypto_remote_token: str = field(default="", repr=False)
    # serve THIS node's CryptoPlaneService over TCP so other clusters
    # can share the device mesh (core/cryptosvc_server). None = off;
    # 0 = ephemeral port (resolved at start, Node.crypto_server.port).
    crypto_serve: int | None = None
    crypto_serve_host: str = "127.0.0.1"
    # tenant_id -> auth token for dialing clusters (repr=False: secret)
    crypto_serve_tokens: dict = field(default_factory=dict, repr=False)
    # flight recorder: always-on bounded per-category ring;
    # dumps land in flight_dump_dir on SIGTERM / unhandled crash / clean
    # stop for post-mortem merge (`charon-tpu flight merge`). 0 disables
    # (harnesses that build many throwaway nodes).
    flight_capacity: int = 512
    flight_dump_dir: str = ""  # "" = <data_dir>/flightrec
    # stack-sniping scan cadence (app/stacksnipe); 0 disables
    stacksnipe_interval: float = 600.0


@dataclass
class Node:
    """A fully wired node (returned by build_node for tests/CLI)."""

    config: Config
    lock: ClusterLock
    life: LifecycleManager
    scheduler: Scheduler
    vapi: ValidatorAPI
    vapi_router: VapiRouter
    p2p: P2PNode | None
    bcast: Broadcaster
    tracker: Tracker
    metrics: ClusterMetrics
    beacon: object
    sigagg: SigAgg | None = None
    crypto_plane: object | None = None  # core.cryptoplane.SlotCoalescer
    crypto_svc: object | None = None  # core.cryptosvc.CryptoPlaneService
    crypto_remote_plane: object | None = None  # cryptosvc_client.RemotePlane
    crypto_server: object | None = None  # cryptosvc_server.CryptoServiceServer
    inclusion: InclusionChecker | None = None
    flightrec: object | None = None  # app/flightrec.FlightRecorder
    profiler: object | None = None  # app/planeprof.PlaneProfiler
    slo: object | None = None  # app/health.SLOEngine
    # the live pubshare registry (shared with Eth2Verifier/ValidatorAPI
    # by reference) — apply_reshare rotates it in place
    pubshares_by_idx: dict | None = None
    # boot hooks on the card (tuner, prewarm, warm-up) whose failure
    # stops the node: set on the first failure, which `errors` holds
    failed: asyncio.Event | None = None
    errors: list = field(default_factory=list)

    async def apply_reshare(
        self, new_pubshares_by_idx: dict, kind: str = "rotate"
    ) -> dict:
        """Rotate the live pubshare registry after a completed resharing
        ceremony (dkg/reshare) and re-warm the point caches for the
        delta only. The registry dicts are shared by reference with
        Eth2Verifier and ValidatorAPI, so the in-place update takes
        effect on the next partial-signature verification — partials
        signed with pre-reshare shares stop verifying from that moment
        (the stale-share unusability property). Returns the warm-up
        stats dict; already-cached pubshares cost zero lanes."""
        if self.pubshares_by_idx is None:
            raise RuntimeError("node was built without a pubshare registry")
        delta: list[bytes] = []
        for idx, shares in new_pubshares_by_idx.items():
            reg = self.pubshares_by_idx.setdefault(idx, {})
            for gpk, pub in shares.items():
                if reg.get(gpk) != pub:
                    delta.append(pub)
                reg[gpk] = pub
        stats = await self.rewarm_point_caches(pubkeys=delta)
        self.metrics.observe_reshare(
            kind,
            "ok",
            validators=max(
                (len(s) for s in new_pubshares_by_idx.values()), default=0
            ),
        )
        return stats

    async def rewarm_point_caches(
        self, pubkeys=(), messages=()
    ) -> dict:
        """Validator-set rotation hook: bulk-warm the point
        caches for a new key/message set BEFORE the next slot's flush,
        through the coalescer's sharded warm programs when a crypto
        plane is installed (single-chip nodes fall back to the
        BlsEngine bulk path, off the event loop). Idempotent: already-
        cached keys are skipped, so calling this on every rotation
        costs only the delta. A device failure mid-pass propagates:
        there is no step-down to the host."""
        return await _warm_point_caches(
            self.crypto_plane, self.metrics, pubkeys, messages
        )


async def _warm_point_caches(
    crypto_plane, metrics: ClusterMetrics, pubkeys=(), messages=()
) -> dict:
    """The ONE warm dispatch both the startup lifecycle hook and
    Node.rewarm_point_caches ride: coalescer warm programs when a plane
    is installed (it fires its own warmup_hook), else the registry's
    TorchImpl bulk path off the event loop with metrics recorded here."""
    if crypto_plane is not None and hasattr(crypto_plane, "warm_caches"):
        return await crypto_plane.warm_caches(
            pubkeys=pubkeys, messages=messages
        )
    import asyncio as _asyncio

    from charon_tpu_torch.tbls import torch_impl

    impl = tbls.get_implementation()
    stats = await _asyncio.get_running_loop().run_in_executor(
        None,
        lambda: torch_impl.warm_point_caches(
            impl, pubkeys=list(pubkeys), messages=list(messages)
        ),
    )
    metrics.observe_warmup(stats)
    return stats


def _devices(device: str) -> list[str]:
    """The torch devices a node's plane shards over: every visible card
    for "cuda", else the one device named."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return [str(dev)]


async def build_node(config: Config) -> Node:
    data_dir = Path(config.data_dir)
    # manifest mutation-DAG takes precedence over the plain lock
    # (ref: app/app.go:166 loadClusterManifest)
    from charon_tpu_torch.cluster.manifest import load_cluster_state

    lock = load_cluster_state(data_dir)
    n = len(lock.definition.operators)
    t = lock.definition.threshold
    share_idx = config.node_index + 1

    # fault-injection plane (inert unless the flag/env carries a spec):
    # installed FIRST so every boundary below can be wrapped
    from charon_tpu_torch.app import faultinject

    if config.fault_injection:
        faultinject.install(config.fault_injection)
        log.warn(
            "fault injection ACTIVE",
            topic="app",
            spec=config.fault_injection,
        )
    else:
        faultinject.init_from_env()

    # plane profiler: constructed before the crypto plane so
    # the plane factory can install its per-program timing hook; the
    # metric callbacks attach once the catalogue exists below
    from charon_tpu_torch.app.planeprof import PlaneProfiler

    profiler = PlaneProfiler()

    crypto_plane = None
    crypto_svc = None
    tenant_plane = None  # the handle components hold (core/cryptosvc)
    remote_plane = None  # cryptosvc_client.RemotePlane when configured
    crypto_server = None  # cryptosvc_server.CryptoServiceServer
    on_card = False  # TorchImpl on a CUDA device: boot hooks fail the node
    if config.use_tpu_tbls:
        from charon_tpu_torch.tbls.torch_impl import TorchImpl

        # one backend, no ladder: a TorchImpl that cannot reach its
        # device raises here and the node does not start
        impl = TorchImpl(
            device=config.device, decode_mode=config.crypto_plane_decode
        )
        on_card = impl.engine.device.type == "cuda"
        tbls.set_implementation(faultinject.maybe_wrap_tbls(impl))
        if config.crypto_plane != "off":
            devices = _devices(config.device)
            n_devices = len(devices)
            if config.crypto_plane == "on" or n_devices >= 2:
                # route the core workflow's batch crypto through the
                # sharded slot plane: one coalesced device program per
                # window across ALL concurrent duties (SURVEY §7 step 4)
                from charon_tpu_torch.core.cryptoplane import SlotCoalescer
                from charon_tpu_torch.parallel import SlotCryptoPlane, make_mesh

                plane = SlotCryptoPlane(make_mesh(devices), t=t)
                # per-program timing feeds the kernel-family
                # decomposition of every flush's device_span
                plane.on_program = profiler.program_hook()
                crypto_plane = SlotCoalescer(
                    plane,
                    window=config.crypto_plane_window,
                    window_min=config.crypto_plane_window_min,
                    window_max=config.crypto_plane_window_max,
                    decode_workers=config.crypto_plane_decode_workers,
                    decode_mode=config.crypto_plane_decode,
                    impl=impl,
                    submit_ctx=tracer.current_ctx,
                )
                log.info(
                    "crypto plane installed",
                    topic="app",
                    devices=n_devices,
                    window=config.crypto_plane_window,
                    decode_workers=config.crypto_plane_decode_workers,
                    decode_mode=config.crypto_plane_decode,
                )
    else:
        # host path: prefer the native C++ backend — pure-Python pairing
        # (~0.3 s/verify) stalls the event loop for whole slots
        try:
            from charon_tpu_torch.tbls.native_impl import NativeImpl

            tbls.set_implementation(faultinject.maybe_wrap_tbls(NativeImpl()))
        except Exception as e:
            from charon_tpu_torch.tbls.python_impl import PythonImpl

            log.warn(
                "native tbls backend unavailable; pure-python crypto",
                topic="app",
                err=str(e),
            )
            tbls.set_implementation(faultinject.maybe_wrap_tbls(PythonImpl()))

    # -- key material -----------------------------------------------------
    share_secrets = keystore.load_keys(data_dir / "validator_keys")
    group_pubkeys = [
        pubkey_from_bytes(bytes.fromhex(v.distributed_public_key[2:]))
        for v in lock.validators
    ]
    share_keys = dict(zip(group_pubkeys, share_secrets))
    pubshares_by_idx: dict[int, dict[PubKey, bytes]] = {
        j: {} for j in range(1, n + 1)
    }
    for v, gpk in zip(lock.validators, group_pubkeys):
        for j in range(1, n + 1):
            pubshares_by_idx[j][gpk] = bytes.fromhex(v.public_shares[j - 1][2:])
    validators = {gpk: i for i, gpk in enumerate(group_pubkeys)}

    k1_key = k1util.private_key_from_bytes(
        (data_dir / "charon-enr-private-key").read_bytes()
    )

    fork = lock.fork_info()

    # -- metrics ----------------------------------------------------------
    metrics = ClusterMetrics(
        cluster_hash="0x" + lock.lock_hash().hex()[:16],
        cluster_name=lock.definition.name,
        peer=f"node{config.node_index}",
    )

    # -- flight recorder + SLO engine --------------------------
    # The recorder is the post-mortem spine: every observer chain below
    # records into it FIRST, then forwards to the existing metrics hook.
    from charon_tpu_torch.app import flightrec as flightrec_mod
    from charon_tpu_torch.app.health import SLOEngine

    flight = None
    flight_dump_dir = (
        Path(config.flight_dump_dir)
        if config.flight_dump_dir
        else data_dir / "flightrec"
    )
    if config.flight_capacity > 0:
        flight = flightrec_mod.FlightRecorder(
            capacity=config.flight_capacity,
            node=f"node{config.node_index}",
            observer=metrics.flightrec_hook(),
        )
        flight.record("lifecycle", "start", node_index=config.node_index)
    (
        profiler.on_sample,
        profiler.on_tenant,
        profiler.on_utilization,
    ) = metrics.profiler_hooks()
    # duty-miss + step-latency error budgets with multi-window burn-rate
    # alerting; tenant identity matches the crypto-plane tenant so the
    # SLO series line up with the plane attribution families
    slo_tenant = config.crypto_tenant or lock.definition.name
    slo = SLOEngine(on_alert=metrics.slo_alert_hook())
    # sampled by the health loop into the plane health-check series
    plane_health = {"quarantines": 0, "autotune_fallback": 0}

    # -- tracing ----------------------------------------------------------
    # installed BEFORE the workflow wires so every span — including those
    # recorded during component construction — lands in this node's
    # tracer (ref: app/app.go:162 wireTracing runs first)
    otlp = None
    if config.tracing_endpoint:
        otlp = tracer.OTLPExporter(
            config.tracing_endpoint,
            service_name=f"charon-tpu-node{config.node_index}",
        )
    if otlp is not None or config.tracing_jsonl:
        tracer.set_global_tracer(
            tracer.Tracer(
                jsonl_path=config.tracing_jsonl or None, exporter=otlp
            )
        )
    node_tracer = tracer.global_tracer()
    # span ends feed the per-step latency histograms and the slow-duty
    # detector (finalized at duty expiry, below)
    from charon_tpu_torch.app.metrics import SlowDutyDetector, span_metrics

    slow_detector = SlowDutyDetector(metrics)

    def _slo_span(span) -> None:
        # every finished workflow-step span feeds the step-latency SLO
        # (same series the step-latency histogram observes; shared
        # plane-bridge copies are skipped for the same reason)
        if span.attrs.get("shared"):
            return
        slo.observe_step(max(0.0, span.end - span.start), tenant=slo_tenant)

    # keep handles so shutdown can unhook: node_tracer may be the
    # process-global tracer (default build), and a later build_node in
    # the same process must not feed spans into THIS node's registry
    _node_hooks = [span_metrics(metrics), slow_detector.observe, _slo_span]
    node_tracer.hooks.extend(_node_hooks)
    if crypto_plane is not None:
        # one rich per-flush stats hook (runs on the device worker
        # thread — prometheus client objects are thread-safe)
        def _plane_stats(s) -> None:  # chained behind the span bridge
            metrics.labels(metrics.plane_flushes).inc()
            if s.jobs >= 2:
                metrics.labels(metrics.plane_coalesced).inc()
            metrics.labels(metrics.plane_lanes).inc(s.lanes)
            metrics.labels(metrics.plane_flush_seconds).observe(
                s.flush_seconds
            )
            metrics.labels(metrics.plane_lanes_per_flush).observe(s.lanes)
            for q in s.decode_queue_seconds:
                metrics.labels(metrics.plane_decode_queue_seconds).observe(q)
            if s.padded_lanes:
                metrics.labels(metrics.plane_pad_waste).set(
                    s.pad_lanes / s.padded_lanes
                )
            metrics.labels(metrics.plane_inflight).set(s.inflight)
            if s.inflight >= 2:
                metrics.labels(metrics.plane_overlapped).inc()
            # decode-source breakdown: cache lookups vs
            # device-decompressed vs host-decoded signature lanes
            for source, count in (
                ("cache", s.decode_cache_lanes),
                ("device", s.decode_device_lanes),
                ("python", s.decode_python_lanes),
            ):
                if count:
                    metrics.labels(
                        metrics.plane_decode_lanes, source
                    ).inc(count)
            metrics.labels(metrics.plane_decode_mode).set(
                1 if s.decode_mode == "device" else 0
            )
            # per-tenant flush attribution
            for tenant, lanes in s.tenant_lanes:
                if lanes:
                    metrics.labels(
                        metrics.plane_tenant_lanes, tenant
                    ).inc(lanes)

        # bridge each flush's decode/pack/device stages into tracer
        # spans joined to the duty traces that rode the flush;
        # the profiler attributes the buffered per-program samples to
        # this flush, and the flight recorder logs the flush summary —
        # all on the serialized device worker thread
        _stats_chain = profiler.stats_hook(
            inner=tracer.plane_span_bridge(node_tracer, inner_hook=_plane_stats)
        )
        if flight is not None:
            _stats_chain = flightrec_mod.stats_hook(flight, inner=_stats_chain)
        crypto_plane.stats_hook = _stats_chain
        # bulk warm-up passes (startup + rotation) land in the
        # cold-start metric families
        crypto_plane.warmup_hook = metrics.observe_warmup

        # multi-tenant service boundary: components below
        # hold a TenantPlane handle, never the raw coalescer — the
        # service adds admission control, deadline-aware fair
        # scheduling and the per-tenant forged-flood breaker in front
        # of the shared coalescing window
        from charon_tpu_torch.core.cryptosvc import (
            CryptoPlaneService,
            TenantQuota,
        )

        tenant_id = config.crypto_tenant or lock.definition.name
        tenant_obs = metrics.tenant_hook()
        if flight is not None:
            tenant_obs = flightrec_mod.tenant_hook(flight, inner=tenant_obs)
        crypto_svc = CryptoPlaneService(
            crypto_plane,
            round_lanes=config.crypto_plane_round_lanes,
            observer=tenant_obs,
        )
        tenant_plane = crypto_svc.register(
            tenant_id,
            TenantQuota(
                weight=config.crypto_tenant_weight,
                max_queue_jobs=config.crypto_tenant_queue_jobs,
                max_queue_lanes=config.crypto_tenant_queue_lanes,
                breaker_threshold=config.crypto_breaker_threshold,
                breaker_cooldown=config.crypto_breaker_cooldown,
            ),
        )
        log.info(
            "crypto plane tenant registered",
            topic="app",
            tenant=tenant_id,
            queue_lanes=config.crypto_tenant_queue_lanes,
            round_lanes=config.crypto_plane_round_lanes,
        )

        # networked crypto plane: dial a shared remote
        # service; the just-registered local tenant plane becomes the
        # always-available rung below. The same span bridge that feeds
        # local FlushStats into duty traces receives the remote
        # attribution briefs (rebased onto this host's clock), so
        # operators see one consistent trace either way.
        if config.crypto_remote:
            from charon_tpu_torch.core.cryptosvc_client import RemotePlane

            from charon_tpu_torch.core.deadline import (
                LATE_FACTOR,
                MIN_WINDOW_SECS,
            )

            r_host, _, r_port = config.crypto_remote.rpartition(":")
            remote_obs = metrics.remote_hook(tenant_id)
            if flight is not None:
                # addr names the dialed server in the ring: a merged
                # post-mortem attributes a failover to the exact
                # aborted endpoint
                remote_obs = flightrec_mod.remote_hook(
                    flight,
                    tenant_id,
                    addr=f"{r_host or '127.0.0.1'}:{int(r_port)}",
                    inner=remote_obs,
                )
            remote_plane = RemotePlane(
                r_host or "127.0.0.1",
                int(r_port),
                tenant_id,
                config.crypto_remote_token,
                local=tenant_plane,
                observer=remote_obs,
                stats_hook=crypto_plane.stats_hook,
                # a flush on the card costs seconds: a job may wait its
                # duty's deadline window (the client clamps each job to
                # its duty's deadline)
                request_timeout=max(
                    LATE_FACTOR * config.slot_duration, MIN_WINDOW_SECS
                ),
            )
            tenant_plane = remote_plane
            log.info(
                "remote crypto plane configured",
                topic="app",
                addr=remote_plane.addr,
                tenant=tenant_id,
            )

        # expose this node's service to other clusters (the serving
        # side of the same topology; tenants register with default
        # quotas on start unless pre-registered above)
        if config.crypto_serve is not None:
            from charon_tpu_torch.core.cryptosvc_server import (
                CryptoServiceServer,
            )

            crypto_server = CryptoServiceServer(
                crypto_svc,
                config.crypto_serve_tokens,
                host=config.crypto_serve_host,
                port=config.crypto_serve,
                register_tenants=True,
                observer=(
                    flightrec_mod.server_hook(flight)
                    if flight is not None
                    else None
                ),
            )

    # -- beacon client ----------------------------------------------------
    import time as _time

    http_clients = []
    if config.beacon_urls and not config.beacon_nodes:
        from charon_tpu_torch.app.eth2http import Eth2HttpClient

        http_clients = [Eth2HttpClient(url) for url in config.beacon_urls]
        config.beacon_nodes = list(http_clients)
        # derive chain timing from the node itself unless configured
        # (ref: app/app.go:754 uses Spec()/genesis from the BN)
        for client in http_clients:
            try:
                if config.genesis_time is None:
                    genesis = await client.genesis()
                    config.genesis_time = float(genesis["genesis_time"])
                spec = await client.spec()
                config.slot_duration = float(
                    spec.get("SECONDS_PER_SLOT", config.slot_duration)
                )
                config.slots_per_epoch = int(
                    spec.get("SLOTS_PER_EPOCH", config.slots_per_epoch)
                )
                break
            except Exception as e:
                log.warn(
                    "failed to fetch chain spec from beacon node",
                    topic="app",
                    url=client.base_url,
                    err=str(e),
                )
        if config.genesis_time is None:
            raise RuntimeError(
                "could not determine genesis time from any beacon node; "
                "pass --genesis-time"
            )
    if config.simnet or not config.beacon_nodes:
        from charon_tpu_torch.testutil.beaconmock import BeaconMock

        beacon = BeaconMock(
            validators=validators,
            genesis_time=(
                config.genesis_time
                if config.genesis_time is not None
                else _time.time()
            ),
            slot_duration=config.slot_duration,
            slots_per_epoch=config.slots_per_epoch,
        )
        clock = beacon.clock()
    else:
        # each BN gets latency/error instrumentation before the failover
        # multi-client (ref: app/eth2wrap Instrument + NewMultiHTTP)
        instrumented = [
            InstrumentedClient(c, metrics, name=f"bn{i}")
            for i, c in enumerate(config.beacon_nodes)
        ]
        beacon = ValidatorCache(MultiClient(instrumented))
        clock = SlotClock(config.genesis_time or 0.0, config.slot_duration)
    if featureset.enabled(featureset.Feature.SYNTHETIC_DUTIES):
        # fabricate proposer duties for idle validators so the proposal
        # pipeline is exercised (ref: eth2wrap.WithSyntheticDuties)
        beacon = SyntheticProposerClient(
            beacon, slots_per_epoch=config.slots_per_epoch
        )
    # outermost so every component sees the injected faults (inert
    # no-op returning `beacon` unchanged unless the plane is active)
    beacon = faultinject.maybe_wrap_beacon(beacon)

    # -- lifecycle ---------------------------------------------------------
    life = LifecycleManager()
    if http_clients:

        async def close_clients():
            for client in http_clients:
                await client.close()

        life.register_stop(Order.P2P, "beacon-http", close_clients)

    # -- p2p --------------------------------------------------------------
    p2p_node = None
    qbft_net = None
    parsig_transport = None
    if config.peer_addrs:
        specs = []
        for i, (host, port) in enumerate(config.peer_addrs):
            # operator ENR field carries the k1 pubkey hex in this format
            pub = enr.pubkey_from_string(lock.definition.operators[i].enr)
            specs.append(PeerSpec(index=i, pubkey=pub, host=host, port=port))
        relay_client = None
        if config.relay_addr:
            # NAT fallback: unreachable peers are dialed through the
            # relay with the same end-to-end handshake (ref:
            # app/app.go:307-356 wires relays into the libp2p host)
            from charon_tpu_torch.p2p.relay import RelayClient

            rhost, rport = config.relay_addr.rsplit(":", 1)
            relay_client = RelayClient(
                rhost, int(rport), lock.lock_hash(), config.node_index
            )
        p2p_node = P2PNode(
            config.node_index, k1_key, specs, lock.lock_hash(),
            relay=relay_client,
        )
        # wire codec observability: per-frame encode/decode
        # seconds + byte volume by codec (binary vs json fallback)
        p2p_node.wire_observer = metrics.wire_hook()
        # per-peer codec quarantine mutes; counted
        # for the peer_quarantine_active health check and recorded in
        # the flight ring
        _q_metrics = metrics.peer_quarantine_hook()

        def _q_obs(peer_idx, mute_seconds):
            plane_health["quarantines"] += 1
            _q_metrics(peer_idx, mute_seconds)

        p2p_node.quarantine_observer = (
            flightrec_mod.quarantine_hook(flight, inner=_q_obs)
            if flight is not None
            else _q_obs
        )
        await p2p_node.start()
        # frame-level faults on the live mesh (inert no-op by default)
        faultinject.maybe_wrap_p2p_node(p2p_node)
        qbft_net = TcpQbftNet(p2p_node)
        parsig_transport = TcpParSigTransport(p2p_node)
        life.register_stop(Order.P2P, "p2p", p2p_node.stop)

        # peer metadata + version-compat monitoring (ref: app/app.go:299)
        from charon_tpu_torch.app import version as version_mod
        from charon_tpu_torch.app.peerinfo import PeerInfoService

        peerinfo = PeerInfoService(p2p_node, version_mod.VERSION)
        peerinfo.start()

        async def stop_peerinfo():
            peerinfo.stop()

        life.register_stop(Order.P2P, "peerinfo", stop_peerinfo)
    else:
        # single-node / in-memory configurations (tests wire their own)
        from charon_tpu_torch.core.consensus_qbft import MemMsgNet
        from charon_tpu_torch.core.parsigex import MemTransport

        qbft_net = MemMsgNet()
        parsig_transport = MemTransport()

    # -- core workflow ----------------------------------------------------
    # Byzantine-evidence ledger: every attributed detection
    # across qbft / parsigex / parsigdb increments
    # byzantine_evidence_total{peer,kind}, and equivocation-class
    # evidence excludes the peer's lanes from sigagg recombination.
    from charon_tpu_torch.core.evidence import EvidenceRegistry

    byz_hook = metrics.byzantine_hook()
    if flight is not None:
        # the flightrec adapter takes the 3-arg form: the registry
        # passes the free-text detail through to the ring
        byz_hook = flightrec_mod.byzantine_hook(flight, inner=byz_hook)
    evidence = EvidenceRegistry(hook=byz_hook)
    dutydb = DutyDB()
    parsigdb = ParSigDB(threshold=t, evidence=evidence)
    sigagg = SigAgg(
        threshold=t,
        fork=fork,
        slots_per_epoch=config.slots_per_epoch,
        plane=tenant_plane,
        pubshares_by_idx=pubshares_by_idx if tenant_plane else None,
        clock=clock if tenant_plane else None,
        evidence=evidence,
    )
    # impl selected by the AGG_SIG_DB_V2 feature flag (ref: app wiring
    # gates memory_v2 behind the alpha flag)
    aggsigdb = new_agg_sigdb()
    bcast = Broadcaster(beacon=beacon, clock=clock)
    # lock-file registrations re-broadcast every epoch by the recaster
    # (ref: app/app.go:676-743 wireRecaster pre-generate path)
    bcast.load_pregen_registrations(lock.validators)
    fetcher = Fetcher(beacon)
    # Per-message k1 auth: every consensus message (and each piggybacked
    # justification) is signed/verified against the operators' keys
    # (ref: core/consensus/qbft/transport.go:25-50, qbft.go:561).
    op_pubkeys = [
        enr.pubkey_from_string(op.enr)
        for op in lock.definition.operators
    ]
    duty_gater = DutyGater(clock, slots_per_epoch=config.slots_per_epoch)
    qbft_consensus = QBFTConsensus(
        qbft_net,
        n,
        privkey=k1_key,
        pubkeys=op_pubkeys,
        gater=duty_gater,
        evidence=evidence,
    )
    consensus = ConsensusController(qbft_consensus)

    def _consensus_stats(s):
        d = str(s["duty"].type.name).lower()
        metrics.labels(
            metrics.consensus_decided_rounds, d, s["timer"]
        ).set(s["round"])
        metrics.labels(
            metrics.consensus_duration, d, s["timer"]
        ).set(s["duration"])

    qbft_consensus.on_decided_stats = _consensus_stats
    if flight is not None:
        # round changes are the consensus-stall signature a post-mortem
        # looks for first
        qbft_consensus.on_round_change = flightrec_mod.consensus_hook(flight)
    vapi = ValidatorAPI(
        share_idx=share_idx,
        pubshares=pubshares_by_idx[share_idx],
        fork=fork,
        slots_per_epoch=config.slots_per_epoch,
        plane=tenant_plane,
    )
    verifier = Eth2Verifier(
        fork,
        pubshares_by_idx,
        config.slots_per_epoch,
        plane=tenant_plane,
        clock=clock if tenant_plane else None,
    )
    parsigex = ParSigEx(
        share_idx,
        parsig_transport,
        verifier,
        gater=duty_gater,
        evidence=evidence,
    )
    scheduler = Scheduler(
        beacon,
        clock,
        validators,
        slots_per_epoch=config.slots_per_epoch,
    )
    tracker = Tracker(
        peer_share_indices=list(range(1, n + 1)), threshold=t
    )

    # fetcher.fetch runs as its own deadline-bounded retried task (ref:
    # core.WithAsyncRetry, app/app.go:571; the simnet wires the same):
    # the scheduler awaits its duty subscribers in turn, and a proposer
    # fetch blocks on the aggregated randao that the validator client,
    # a later subscriber, has yet to sign
    from charon_tpu_torch.app.retry import Retryer, with_async_retry

    retryer = Retryer(
        deadline_of=clock.duty_deadline,
        backoff=max(0.05, config.slot_duration / 8),
    )
    wire(
        scheduler=scheduler,
        fetcher=fetcher,
        consensus=consensus,
        dutydb=dutydb,
        validatorapi=vapi,
        parsigdb=parsigdb,
        parsigex=parsigex,
        sigagg=sigagg,
        aggsigdb=aggsigdb,
        broadcaster=bcast,
        options=[
            tracking(tracker),
            tracing(node_tracer),
            instrument(metrics),
            with_async_retry(retryer),
        ],
    )

    # tracker reports -> metrics: failures, participation counts,
    # inconsistent partials, unexpected peers (ref: core/tracker
    # newFailedDutyReporter / newParticipationReporter / reportParSigs)
    def _report_metrics(report):
        d = str(report.duty.type.name).lower()
        if not report.success and report.failed_step is not None:
            metrics.labels(
                metrics.tracker_failed, d, str(report.failed_step)
            ).inc()
        if report.inconsistent_pubkeys:
            metrics.labels(metrics.tracker_inconsistent, d).inc()
        for share, cnt in report.participation_counts.items():
            metrics.labels(
                metrics.tracker_participation, d, str(share)
            ).inc(cnt)
        for share, cnt in report.unexpected_shares.items():
            metrics.labels(metrics.tracker_unexpected, str(share)).inc(cnt)
            log.warn(
                "unexpected peer participation",
                topic="tracker",
                duty=str(report.duty),
                peer_share=share,
                count=cnt,
            )
        for pk, why in report.failed_pubkeys.items():
            metrics.labels(
                metrics.tracker_failed_validators, d, why.value
            ).inc()
            log.warn(
                "validator failed to assemble threshold partials",
                topic="tracker",
                duty=str(report.duty),
                pubkey=str(pk)[:18],
                reason=why.value,
            )

    tracker.subscribe(_report_metrics)
    if flight is not None:
        tracker.subscribe(flightrec_mod.duty_hook(flight))

    def _slo_duty(report):
        slo.observe_duty(report.success, tenant=slo_tenant)

    tracker.subscribe(_slo_duty)

    # deadliner trims stores + triggers tracker analysis; the slow-duty
    # detector settles each duty's traced wall time against its budget
    # (deadline minus slot start) at the same expiry point
    deadliner = Deadliner(
        clock,
        _make_expiry(
            dutydb,
            parsigdb,
            aggsigdb,
            tracker,
            qbft_consensus,
            slow_detector=slow_detector,
            clock=clock,
        ),
    )
    scheduler.subscribe_duties(_register_deadline(deadliner))
    # recaster: re-broadcast VC + lock-file registrations once per epoch
    # (ref: app/app.go:676-743 wireRecaster subscribes to slots)
    scheduler.subscribe_slots(bcast.recast)

    # priority/infosync: negotiate the cluster-wide protocol preference
    # at each epoch edge over the p2p mesh and switch the consensus
    # implementation to the cluster's top choice (ref: core/priority +
    # core/infosync, wiring app/app.go:610-668)
    if p2p_node is not None:
        from charon_tpu_torch.core.priority import (
            InfoSync,
            P2PPriorityExchange,
            Prioritiser,
            protocol_switcher,
        )

        from charon_tpu_torch.app import version as version_mod

        from charon_tpu_torch.core.priority import order_protocol_prefs

        prio_exchange = P2PPriorityExchange(p2p_node)

        def _protocol_prefs() -> list[str]:
            # v1.1+ definitions carry an operator-signed cluster-level
            # protocol preference that outranks the node default
            return order_protocol_prefs(
                [p.protocol_id for p in consensus.registered()],
                getattr(lock.definition, "consensus_protocol", ""),
            )

        prioritiser = Prioritiser(
            # the scheduler never emits INFO_SYNC, so the Prioritiser
            # itself registers its duty for expiry — consensus instance,
            # tracker events, and stores all trim on the normal path
            on_duty_done=deadliner.add,
            node_idx=share_idx,
            quorum=t,
            exchange=prio_exchange.exchange,
            consensus=consensus,
            topics_fn=lambda: {
                InfoSync.TOPIC_PROTOCOL: _protocol_prefs(),
                InfoSync.TOPIC_VERSION: [version_mod.VERSION],
            },
        )
        prioritiser.subscribe(protocol_switcher(consensus))
        infosync = InfoSync(prioritiser)
        scheduler.subscribe_slots(infosync.on_slot)

    # inclusion checker: broadcast duties must land on-chain within 32
    # slots (ref: core/tracker/inclusion.go, wiring app/app.go:746-780)
    inclusion = None
    if hasattr(beacon, "block_attestations"):
        inclusion = InclusionChecker(
            beacon, on_report=_log_inclusion, clock=clock
        )
        bcast.subscribe(inclusion.submitted)
        scheduler.subscribe_slots(inclusion.on_slot)
        # feed results back into the tracker's chain-inclusion step
        # counters and the metrics catalogue
        # (ref: app/app.go:562 wires track.InclusionChecked)
        def _on_inclusion(r):
            tracker.inclusion_checked(r.duty, r.pubkey, r.included)
            metrics.labels(
                metrics.inclusion_checked,
                str(r.duty.type.name).lower(),
                "included" if r.included else "missed",
            ).inc()
            if r.included:
                metrics.labels(metrics.inclusion_delay).set(r.delay_slots)

        inclusion.subscribe(_on_inclusion)

    # in-process validator client for simnet runs (ref: app/vmock.go —
    # the reference wires validatormock when --simnet-validator-mock)
    if config.simnet and config.simnet_vmock:
        from charon_tpu_torch.core.types import DutyType
        from charon_tpu_torch.testutil.validatormock import ValidatorMock

        vmock = ValidatorMock(
            vapi=vapi,
            share_keys=share_keys,
            fork=fork,
            slots_per_epoch=config.slots_per_epoch,
        )

        # keep strong refs to fire-and-forget proposer tasks and surface
        # their failures (asyncio holds tasks weakly)
        vmock_tasks: set[asyncio.Task] = set()

        def _spawn(coro, what: str) -> None:
            task = asyncio.create_task(coro)
            vmock_tasks.add(task)

            def done(t: asyncio.Task) -> None:
                vmock_tasks.discard(t)
                if not t.cancelled() and t.exception() is not None:
                    log.error(
                        "vmock duty failed",
                        topic="vmock",
                        exc=t.exception(),
                        duty=what,
                    )

            task.add_done_callback(done)

        async def on_duty(duty, defs):
            if duty.type == DutyType.ATTESTER:
                await vmock.attest(duty.slot, defs)
            elif duty.type == DutyType.PROPOSER:
                for pubkey in defs:
                    _spawn(vmock.propose(duty.slot, pubkey), str(duty))

        scheduler.subscribe_duties(on_duty)

    vapi_router = VapiRouter(
        vapi,
        beacon=beacon,
        validators=validators,
        genesis_time=config.genesis_time or 0.0,
        slots_per_epoch=config.slots_per_epoch,
        slot_duration=config.slot_duration,
        clock=clock,
    )
    if config.beacon_urls:
        # unmatched VC requests forward to the first beacon endpoint
        # (ref: router.go proxyHandler)
        vapi_router.proxy_url = config.beacon_urls[0]

    # -- lifecycle hooks --------------------------------------------------
    async def start_vapi():
        port = await vapi_router.start("127.0.0.1", config.validator_api_port)
        log.info("validator api listening", topic="vapi", port=port)

    life.register_start(Order.VALIDATOR_API, "vapi", start_vapi, background=False)
    life.register_stop(Order.VALIDATOR_API, "vapi", vapi_router.stop)
    life.register_start(
        Order.DEADLINER,
        "deadliner",
        _async_noop(deadliner.start),
        background=False,
    )
    life.register_stop(Order.DEADLINER, "deadliner", deadliner.stop)
    life.register_start(Order.SCHEDULER, "scheduler", scheduler.run)

    async def stop_sched():
        scheduler.stop()

    life.register_stop(Order.SCHEDULER, "scheduler", stop_sched)

    # -- kernel auto-tune (core/autotune) -----------------------
    # resolve the KernelConfig for this boot BEFORE the prewarm/warm-up
    # hooks compile anything, so the duty programs compile under the
    # TUNED routing (tune -> prewarm -> warm-up). Mode "off" flows
    # through the SAME resolve() call: the ops/ hot paths no longer read
    # the environment, so the deprecated CHARON_MSM/CHARON_MXU_MONT
    # deploy pins only take effect if something applies them — "off"
    # means defaults + env overrides, never silently-dropped pins. On
    # the CPU it is a background task off the event loop whose failure
    # degrades to defaults + env overrides. On the card it is awaited
    # before the later start hooks, and its failure stops the node.
    tune_done = asyncio.Event()
    failed = asyncio.Event()  # a boot hook on the card failed
    errors: list = []

    def _boot_failed(what: str, e: BaseException, seconds: float) -> None:
        log.error(
            f"{what} failed on the card; stopping the node",
            topic="app",
            err=f"{type(e).__name__}: {str(e)[:160]}",
            seconds=round(seconds, 1),
        )
        errors.append(e)
        failed.set()

    if config.use_tpu_tbls:

        async def autotune_start():
            import time as _t

            from charon_tpu_torch.core import autotune as _autotune

            t0 = _t.monotonic()
            loop = asyncio.get_running_loop()
            autotune_obs = metrics.autotune_hook()
            if flight is not None:
                autotune_obs = flightrec_mod.autotune_hook(
                    flight, inner=autotune_obs
                )
            try:
                result = await loop.run_in_executor(
                    None,
                    lambda: _autotune.resolve(
                        config.crypto_autotune,
                        config.crypto_autotune_profile or None,
                        observer=autotune_obs,
                        device=config.device,
                    ),
                )
                # "skipped" = the tuner refused/degraded to defaults —
                # the autotune_defaults health check watches this
                plane_health["autotune_fallback"] = (
                    1 if result.outcome == "skipped" else 0
                )
                log.info(
                    "kernel auto-tune resolved",
                    topic="autotune",
                    outcome=result.outcome,
                    config=result.config.as_dict(),
                    sources=result.sources,
                    bench_runs=result.bench_runs,
                    seconds=round(_t.monotonic() - t0, 1),
                )
            except Exception as e:  # noqa: BLE001 — see below
                if on_card:
                    # kernel selection on the card has no fallback: the
                    # error reaches run() through the stopped node
                    _boot_failed("kernel auto-tune", e, _t.monotonic() - t0)
                    raise
                # on the CPU a tuner failure logs here AND degrades to
                # the proven defaults — kernel selection is a perf
                # choice, never worth a failed boot
                log.warn(
                    "kernel auto-tune failed; running KernelConfig "
                    "defaults",
                    topic="autotune",
                    err=f"{type(e).__name__}: {str(e)[:160]}",
                    seconds=round(_t.monotonic() - t0, 1),
                )
                plane_health["autotune_fallback"] = 1
                _autotune.apply_env()
            finally:
                tune_done.set()

        life.register_start(
            Order.MONITORING,
            "crypto-autotune",
            autotune_start,
            background=not on_card,
        )
    else:
        tune_done.set()

    if crypto_plane is not None:
        # queue live flushes behind the boot-time tuner: micro_bench's
        # trial.apply() flips the global dispatch flags, so a duty
        # flush racing the tuning window would run under a transient
        # trial config. tune_done is set in the tuner hook's finally
        # (or immediately when tbls is off), so the gate never wedges
        # the plane.
        crypto_plane.dispatch_gate = tune_done
        prewarm = config.crypto_plane_prewarm
        if prewarm == "auto":
            # on the card prewarm always runs; elsewhere only with a
            # warm artifact story (fresh tuned profile + a prewarm that
            # COMPLETED once under the same fingerprint:
            # core/autotune.warm_boot_ready)
            if on_card:
                prewarm = "on"
            else:
                from charon_tpu_torch.core import autotune as _at

                prewarm = (
                    "on"
                    if config.crypto_autotune != "off"
                    and _at.warm_boot_ready(
                        config.crypto_autotune_profile or None,
                        device=config.device,
                    )
                    else "off"
                )
        if prewarm == "on":
            # background: duties arriving mid-warmup queue behind the
            # prewarm on the serialized device lane instead of racing it
            async def prewarm_plane():
                import time as _t

                # run under the TUNED kernel routing, not whatever
                # defaults the tuner is about to replace
                await tune_done.wait()
                t0 = _t.monotonic()
                try:
                    shapes = await crypto_plane.prewarm()
                except Exception as e:  # noqa: BLE001 — background task:
                    # lifecycle gathers it silently at shutdown, so a
                    # failed warmup must log here
                    if on_card:
                        _boot_failed(
                            "crypto plane pre-warm", e, _t.monotonic() - t0
                        )
                        raise
                    log.warn(
                        "crypto plane pre-warm failed; first live "
                        "flushes will compile cold",
                        topic="app",
                        err=f"{type(e).__name__}: {str(e)[:160]}",
                        seconds=round(_t.monotonic() - t0, 1),
                    )
                    return
                log.info(
                    "crypto plane pre-warmed",
                    topic="app",
                    shapes=[(k, n) for k, n, _ in shapes],
                    seconds=round(_t.monotonic() - t0, 1),
                )
                # record it so the NEXT boot's
                # `--crypto-plane-prewarm auto` gate knows a prewarm
                # completed under this fingerprint
                # (autotune.warm_boot_ready)
                try:
                    from charon_tpu_torch.core import autotune as _at2

                    _at2.mark_prewarmed(
                        config.crypto_autotune_profile or None,
                        device=config.device,
                    )
                except Exception as e:  # noqa: BLE001 — marker is an
                    # optimization signal; losing it only means the
                    # next auto boot stays conservative
                    log.warn(
                        "could not record prewarm completion marker",
                        topic="app",
                        err=f"{type(e).__name__}: {str(e)[:160]}",
                    )

            life.register_start(
                Order.MONITORING, "crypto-prewarm", prewarm_plane
            )

        async def stop_plane():
            if crypto_svc is not None:
                # service first: fail queued waiters fast and close the
                # per-tenant quarantine coalescers before the shared one
                crypto_svc.close()
            crypto_plane.close()

        life.register_stop(Order.SCHEDULER, "crypto-plane", stop_plane)

    if remote_plane is not None:
        # connection supervision starts with the node; jobs submitted
        # while the remote is down simply run on the local rung
        life.register_start(
            Order.MONITORING, "crypto-remote", remote_plane.start
        )
        life.register_stop(
            Order.SCHEDULER, "crypto-remote", remote_plane.close
        )

    if crypto_server is not None:

        async def start_crypto_server():
            await crypto_server.start()
            # tenant IDS only — the token VALUES never leave the dict
            log.info(  # lint: allow(secret-flow)
                "crypto plane service listening",
                topic="app",
                host=crypto_server.host,
                port=crypto_server.port,
                tenants=sorted(config.crypto_serve_tokens),
            )

        life.register_start(
            Order.MONITORING, "crypto-serve", start_crypto_server
        )
        life.register_stop(
            Order.SCHEDULER, "crypto-serve", crypto_server.close
        )

    if config.use_tpu_tbls:
        # bulk point-cache warm-up: decode the whole cluster
        # key set through the batched device kernels at startup so the
        # first live slot never pays the python-bigint cold burst
        warmup = config.crypto_plane_warmup
        if warmup == "auto":
            # the same device test as the decode rung: TorchImpl's
            # decode_mode "auto" is the device decode on a card
            warmup = "on" if on_card else "off"
        if warmup == "on":
            warm_keyset = sorted(
                {
                    bytes.fromhex(v.distributed_public_key[2:])
                    for v in lock.validators
                }
                | {
                    bytes.fromhex(ps[2:])
                    for v in lock.validators
                    for ps in v.public_shares
                }
            )

            async def warm_point_caches_start():
                import time as _t

                # the decode kernels route through the tuned mont_mul
                # dispatch — warm AFTER the tuner settled the flags
                await tune_done.wait()
                t0 = _t.monotonic()
                try:
                    stats = await _warm_point_caches(
                        crypto_plane, metrics, pubkeys=warm_keyset
                    )
                except Exception as e:  # noqa: BLE001 — background task:
                    # a failed warm-up must log (the operator otherwise
                    # believes the caches are warm)
                    if on_card:
                        _boot_failed(
                            "point-cache warm-up", e, _t.monotonic() - t0
                        )
                        raise
                    log.warn(
                        "point-cache warm-up failed; first live slot "
                        "decodes cold",
                        topic="app",
                        err=f"{type(e).__name__}: {str(e)[:160]}",
                        seconds=round(_t.monotonic() - t0, 1),
                    )
                    return
                log.info(
                    "point caches warmed",
                    topic="app",
                    pubkeys=stats.get("pubkey"),
                    seconds=round(_t.monotonic() - t0, 1),
                )

            life.register_start(
                Order.MONITORING, "crypto-cache-warmup", warm_point_caches_start
            )

    # health: the reference catalogue evaluated over this node's own
    # sampled metrics, gating /readyz (ref: app/health + monitoringapi)
    from charon_tpu_torch.app import log as app_log
    from charon_tpu_torch.app.health import (
        HealthChecker,
        Metadata,
        MetricStore,
        default_checks,
        plane_checks,
    )

    health_store = MetricStore()
    health = HealthChecker(
        health_store,
        # reference catalogue + distributed-plane catalogue + the SLO
        # engine's burn-rate gates
        checks=default_checks() + plane_checks() + slo.checks(),
        metadata=Metadata(
            num_validators=len(lock.validators),
            quorum=t,
            remote_plane=remote_plane is not None,
        ),
    )

    async def _sample_health_loop(interval: float = 30.0):
        import asyncio as _asyncio

        while True:
            try:
                health_store.sample(
                    "app_log_errors", sum(app_log.error_counts.values())
                )
                health_store.sample(
                    "app_log_warnings", sum(app_log.warn_counts.values())
                )
                if p2p_node is not None:
                    health_store.sample(
                        "p2p_peers_connected",
                        sum(
                            1
                            for ok in p2p_node.ping_success.values()
                            if ok
                        ),
                    )
                else:  # in-process simnet: peers are always reachable
                    health_store.sample("p2p_peers_connected", n - 1)
                health_store.sample(
                    "core_tracker_failed_duties",
                    sum(tracker.failed_total.values()),
                )
                health_store.sample(
                    "core_tracker_failed_proposals",
                    sum(
                        cnt
                        for (dtype, _), cnt in tracker.failed_total.items()
                        if dtype == DutyType.PROPOSER
                    ),
                )
                health_store.sample(
                    "core_bcast_recast_errors", bcast.recast_errors
                )
                if p2p_node is not None and peerinfo.peers:
                    health_store.sample(
                        "app_peerinfo_clock_offset_abs",
                        max(
                            abs(p.clock_offset)
                            for p in peerinfo.peers.values()
                        ),
                    )
                try:
                    await beacon.await_synced()
                    health_store.sample("app_beacon_syncing", 0)
                except Exception:  # noqa: BLE001 — syncing or unreachable
                    health_store.sample("app_beacon_syncing", 1)
                # distributed-plane catalogue series: the
                # plane_checks() docstring documents each name
                if crypto_svc is not None:
                    _bstate = {"closed": 0, "half_open": 1, "open": 2}
                    health_store.sample(
                        "tpu_plane_tenant_breaker_state",
                        max(
                            (
                                _bstate.get(ten.breaker.state, 0)
                                for ten in crypto_svc._tenants.values()
                            ),
                            default=0,
                        ),
                    )
                if remote_plane is not None:
                    health_store.sample(
                        "tpu_plane_remote_state",
                        {"down": 0, "probing": 1, "up": 2}.get(
                            remote_plane.state, 0
                        ),
                    )
                health_store.sample(
                    "wire_peer_quarantine_total",
                    plane_health["quarantines"],
                )
                health_store.sample(
                    "tpu_autotune_fallback",
                    plane_health["autotune_fallback"],
                )
                # SLO burn gauges + recorder eviction/dump gauges ride
                # the same cadence
                metrics.observe_slo(slo.evaluate())
                if flight is not None:
                    metrics.observe_flightrec(flight)
            except Exception as e:  # noqa: BLE001 — sampling must not die
                log.warn("health sampling failed", topic="app", err=str(e))
            await _asyncio.sleep(interval)

    life.register_start(Order.MONITORING, "health-sampler", _sample_health_loop)

    # stack sniping: periodic /proc scan for
    # co-located validator-stack processes -> stack_colocated_processes
    # gauges + a lifecycle event in the flight ring
    if config.stacksnipe_interval > 0:
        from charon_tpu_torch.app.stacksnipe import StackSniper

        _snipe_metrics = metrics.stacksnipe_hook()

        def _snipe_report(report):
            _snipe_metrics(report)
            if flight is not None and report:
                flight.record(
                    "lifecycle",
                    "colocated",
                    binaries=sorted(report),
                    processes=sum(len(p) for p in report.values()),
                )

        sniper = StackSniper(
            interval=config.stacksnipe_interval, on_report=_snipe_report
        )
        life.register_start(Order.MONITORING, "stacksnipe", sniper.run)

    # flight-recorder egress: crash/SIGTERM handlers dump the
    # ring; the stop hook dumps on clean shutdown and restores the
    # previous handlers. TRACKER order (lowest) = the dump runs LAST, so
    # events recorded during other components' teardown are captured.
    if flight is not None:
        flight_dump_dir.mkdir(parents=True, exist_ok=True)
        _uninstall_crash = flightrec_mod.install_crash_handlers(
            flight,
            str(flight_dump_dir / f"node{config.node_index}.crash.jsonl"),
        )

        async def stop_flight():
            flight.record("lifecycle", "stop")
            try:
                flight.dump_jsonl(
                    str(
                        flight_dump_dir
                        / f"node{config.node_index}.stop.jsonl"
                    ),
                    trigger="stop",
                )
            except OSError as e:
                log.warn(
                    "flight-recorder stop dump failed",
                    topic="app",
                    err=str(e),
                )
            _uninstall_crash()

        life.register_stop(Order.TRACKER, "flightrec", stop_flight)

    # exporter/JSONL built at the top of build_node (spans flow for the
    # node's whole life); flushed + closed at shutdown. Registered
    # unconditionally: the metric/slow-duty hooks must come OFF the
    # tracer even in default builds where it is the process-global one,
    # or a rebuild in the same process would keep feeding spans into
    # this node's dead registry.
    _own_tracer = otlp is not None or bool(config.tracing_jsonl)

    async def stop_tracing():
        for h in _node_hooks:
            try:
                node_tracer.hooks.remove(h)
            except ValueError:
                pass
        if _own_tracer:
            # close() joins the export thread (final POST can take
            # seconds against a dead collector) — keep the loop free so
            # later stop hooks' grace timeouts still fire
            await asyncio.get_running_loop().run_in_executor(
                None, node_tracer.close
            )

    # TRACKER order (lowest): stop hooks run highest-first, so the
    # exporter flushes AFTER p2p/beacon teardown — spans recorded
    # during other components' shutdown still reach the collector
    life.register_stop(Order.TRACKER, "tracing", stop_tracing)

    if config.monitoring_port:
        consensus_dump = getattr(qbft_consensus, "debug_dump", None)

        async def start_mon():
            await serve_monitoring(
                "127.0.0.1",
                config.monitoring_port,
                metrics,
                health_checker=health,
                consensus_dump=consensus_dump,
                tracer=node_tracer,
                flightrec=flight,
                profiler=profiler,
            )

        life.register_start(Order.MONITORING, "monitoring", start_mon, background=False)

    return Node(
        config=config,
        lock=lock,
        life=life,
        scheduler=scheduler,
        vapi=vapi,
        vapi_router=vapi_router,
        p2p=p2p_node,
        bcast=bcast,
        tracker=tracker,
        metrics=metrics,
        beacon=beacon,
        sigagg=sigagg,
        crypto_plane=crypto_plane,
        crypto_svc=crypto_svc,
        crypto_remote_plane=remote_plane,
        crypto_server=crypto_server,
        inclusion=inclusion,
        flightrec=flight,
        profiler=profiler,
        slo=slo,
        pubshares_by_idx=pubshares_by_idx,
        failed=failed,
        errors=errors,
    )


def _log_inclusion(report: InclusionReport) -> None:
    if report.included:
        log.debug(
            "duty included on-chain",
            topic="inclusion",
            duty=str(report.duty),
            delay_slots=report.delay_slots,
        )
    else:
        log.warn(
            "duty missed on-chain inclusion",
            topic="inclusion",
            duty=str(report.duty),
        )


def _make_expiry(
    dutydb,
    parsigdb,
    aggsigdb,
    tracker,
    consensus=None,
    slow_detector=None,
    clock=None,
):
    async def on_expired(duty):
        dutydb.trim(duty)
        parsigdb.trim(duty)
        aggsigdb.trim(duty)
        if consensus is not None:
            consensus.trim(duty)
        if slow_detector is not None and clock is not None:
            budget = clock.duty_deadline(duty) - clock.slot_start(duty.slot)
            slow_detector.finalize(duty, budget)
        await tracker.duty_expired(duty)

    return on_expired


def _register_deadline(deadliner):
    async def on_duty(duty, defs):
        deadliner.add(duty)

    return on_duty


def _async_noop(fn):
    async def run():
        fn()

    return run


async def run(config: Config, stop: asyncio.Event | None = None) -> None:
    """ref: app.Run (app/app.go:131) — build then run the lifecycle.
    The node stops at `stop` (or its lifecycle's own stop) or when a
    boot hook on the card fails; then its first error is raised."""
    node = await build_node(config)
    ended = asyncio.Event()

    async def relay(event: asyncio.Event) -> None:
        await event.wait()
        ended.set()

    relays = [
        asyncio.create_task(relay(e))
        for e in (stop or node.life._stopped, node.failed)
    ]
    try:
        await node.life.run(ended)
    finally:
        for task in relays:
            task.cancel()
        await asyncio.gather(*relays, return_exceptions=True)
    if node.errors:
        raise node.errors[0]
