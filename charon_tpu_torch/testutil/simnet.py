"""Simnet: a whole t-of-n cluster in one process.

The port of charon_tpu/testutil/simnet.py (ref:
testutil/integration/simnet_test.go:49-130) — N nodes with real workflow
components, a shared deterministic beacon mock, in-memory
partial-signature exchange, and validatormock VCs, asserting duty
completion via the broadcast recorder.

`build_cluster(crypto_service=...)` wires every node the way a
production node is wired onto a shared crypto plane: node i registers as
tenant `node{i}` of the given `core/cryptosvc.CryptoPlaneService` and its
SigAgg, ValidatorAPI and Eth2Verifier hold that TenantPlane, so on one
card the n nodes are n tenants of one slot plane; with `crypto_remote=`
some of them reach it over TCP as remote tenants
(`core/cryptosvc_client.RemotePlane`). `chaos` builds the cluster on
the seeded fault-injection plane (testutil/chaos.py).
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field

from charon_tpu_torch import tbls
from charon_tpu_torch.core.aggsigdb import new_agg_sigdb
from charon_tpu_torch.core.bcast import Broadcaster
from charon_tpu_torch.core.consensus import ConsensusController, EchoConsensus
from charon_tpu_torch.core.dutydb import DutyDB
from charon_tpu_torch.core.fetcher import Fetcher
from charon_tpu_torch.core.inclusion import InclusionChecker
from charon_tpu_torch.core.parsigdb import ParSigDB
from charon_tpu_torch.core.parsigex import Eth2Verifier, MemTransport, ParSigEx
from charon_tpu_torch.core.scheduler import Scheduler
from charon_tpu_torch.core.sigagg import SigAgg
from charon_tpu_torch.core.tracker import Tracker, tracking
from charon_tpu_torch.core.types import PubKey, pubkey_from_bytes
from charon_tpu_torch.core.validatorapi import ValidatorAPI
from charon_tpu_torch.core.wire import tracing, wire
from charon_tpu_torch.eth2util.signing import ForkInfo
from charon_tpu_torch.testutil.beaconmock import BeaconMock
from charon_tpu_torch.testutil.validatormock import ValidatorMock

SIMNET_FORK = ForkInfo(
    genesis_validators_root=b"\x42" * 32,
    fork_version=b"\x00\x00\x00\x00",
    genesis_fork_version=b"\x00\x00\x00\x00",
)


@dataclass
class SimCluster:
    n: int
    t: int
    beacon: BeaconMock
    fork: ForkInfo
    group_pubkeys: list[PubKey]
    share_keys: list[dict[PubKey, bytes]]  # per node
    pubshares_by_idx: dict[int, dict[PubKey, bytes]]
    nodes: list["SimNode"] = field(default_factory=list)
    # set when built with chaos: the shared fault-injection handles
    chaos_transport: object | None = None
    chaos_qbft: object | None = None
    partitioner: object | None = None
    # set when built with crypto_service: the shared CryptoPlaneService
    # every node is a tenant of (its owner closes it)
    crypto_service: object | None = None
    # set when built with crypto_remote: (share_idx, TenantPlane) -> the
    # plane that node holds
    crypto_remote: object | None = None

    # -- chaos control (no-ops without a chaos build) ---------------------

    def crash_node(self, share_idx: int) -> None:
        """Crash-stop a node mid-run: its scheduler halts and the fault
        plane black-holes its traffic in BOTH directions."""
        node = self.nodes[share_idx - 1]
        node.scheduler.stop()
        if self.partitioner is not None:
            self.partitioner.crash(share_idx)

    def restart_node(self, share_idx: int):
        """Restart a crashed node; returns the new scheduler task
        (crash-only model: same wired components, fresh tick loop)."""
        if self.partitioner is not None:
            self.partitioner.restart(share_idx)
        node = self.nodes[share_idx - 1]
        node.scheduler.reset()
        return asyncio.create_task(node.scheduler.run())

    def partition(self, side_a, side_b, symmetric: bool = True) -> None:
        assert self.partitioner is not None, "build_cluster(chaos=...) first"
        self.partitioner.partition(side_a, side_b, symmetric)

    def heal(self) -> None:
        if self.partitioner is not None:
            self.partitioner.heal()

    def close(self) -> None:
        """Release per-node resources (crypto-plane pools, trace JSONL
        handles) — tracing/crypto_plane builds should call this."""
        for node in self.nodes:
            if node.crypto_plane is not None:
                node.crypto_plane.close()
            if node.tracer is not None:
                node.tracer.close()

    def trace_paths(self) -> list[str]:
        """Per-node span JSONL export paths (tracing builds with a
        trace_dir); merge with app/tracer.merge_jsonl."""
        return [
            node.tracer.jsonl_path
            for node in self.nodes
            if node.tracer is not None and node.tracer.jsonl_path
        ]

    async def apply_reshare(
        self,
        new_share_keys: dict[int, dict[PubKey, bytes]],
        new_pubshares_by_idx: dict[int, dict[PubKey, bytes]],
    ) -> None:
        """Rotate key material live, mid-duties (dkg/reshare output).

        The per-node `share_keys` dict (held by each ValidatorMock) and
        the shared `pubshares_by_idx` registry (held by every node's
        Eth2Verifier and ValidatorAPI) are mutated IN PLACE, so the
        rotation takes effect on the next signature without rebuilding
        any node — the simnet mirror of app/run.Node.apply_reshare. A
        node whose index is absent from `new_share_keys` (it left the
        cluster) keeps its old share and its partials stop verifying
        against the rotated registry. Nodes with a crypto plane, and the
        shared service's coalescer, re-warm the point caches for the new
        pubshares (delta only)."""
        for idx, shares in new_share_keys.items():
            self.share_keys[idx - 1].clear()
            self.share_keys[idx - 1].update(shares)
        for idx, pubs in new_pubshares_by_idx.items():
            self.pubshares_by_idx.setdefault(idx, {}).clear()
            self.pubshares_by_idx[idx].update(pubs)
        planes = [node.crypto_plane for node in self.nodes]
        if self.crypto_service is not None:
            planes.append(self.crypto_service.coalescer)
        pubkeys = [p for pubs in new_pubshares_by_idx.values() for p in pubs.values()]
        for plane in planes:
            if plane is not None and hasattr(plane, "warm_caches"):
                await plane.warm_caches(pubkeys=pubkeys)

    def dump_flight(self, out_dir: str) -> list[str]:
        """Dump every node's flight-recorder ring (flightrec=True
        builds) into out_dir; returns the per-node dump paths, ready
        for app/flightrec.merge_jsonl cross-node reconstruction."""
        paths: list[str] = []
        for node in self.nodes:
            if node.flightrec is None:
                continue
            path = f"{out_dir}/node{node.share_idx}.flight.jsonl"
            node.flightrec.dump_jsonl(path, trigger="demand")
            paths.append(path)
        return paths


@dataclass
class SimNode:
    share_idx: int
    scheduler: Scheduler
    vapi: ValidatorAPI
    vmock: ValidatorMock
    dutydb: DutyDB
    parsigdb: ParSigDB
    sigagg: SigAgg
    aggsigdb: AggSigDB
    bcast: Broadcaster
    consensus: ConsensusController
    inclusion: InclusionChecker | None = None
    tracker: Tracker | None = None
    tracer: object | None = None  # app/tracer.Tracer (tracing=True builds)
    crypto_plane: object | None = None  # SlotCoalescer (crypto_plane=True)
    # core/cryptosvc.TenantPlane (crypto_service builds), or what
    # crypto_remote returned for it: the handle its SigAgg, ValidatorAPI
    # and Eth2Verifier hold
    tenant_plane: object | None = None
    parsigex: ParSigEx | None = None
    # core/evidence.EvidenceRegistry — per-node Byzantine detections,
    # same wiring as production (app/run.py)
    evidence: object | None = None
    # app/flightrec.FlightRecorder — per-node post-mortem ring, same
    # hook chains as production (flightrec=True builds)
    flightrec: object | None = None


class SimHostPlane:
    """Stand-in device plane for the SlotCoalescer in observability
    simnet runs: the DECODE stage upstream is the real pure-python
    point decompression + hash-to-curve (it already rejects malformed
    encodings), while the device program itself is a wall-clock sleep, so
    tracing tests run without a device. Implements the packed two-stage API so the pipelined
    pack stage (and its span) engages. NOT a verifier: decode-valid
    lanes all pass, so only wire it where a test doesn't rely on
    signature rejection."""

    def __init__(self, t: int, device_s: float = 0.002) -> None:
        self.t = t
        self.device_s = device_s

    def verify_host(self, pks, msgs, sigs):
        import time as _time

        _time.sleep(self.device_s)
        return [True] * len(pks)

    def recombine_host(self, pubshares, msgs, partials, group_pks, indices):
        raise NotImplementedError("verify-only sim plane")

    # packed two-stage API (core/cryptoplane._plane_has_packed_api)
    def pack_verify_inputs(self, pks, msgs, sigs):
        import numpy as np

        return (np.ones(len(pks), dtype=bool),)  # live mask only

    def make_lane_rand(self, n):
        return None

    def verify_packed(self, arrays, rand, n):
        import time as _time

        _time.sleep(self.device_s)
        return [True] * n

    def pack_inputs(self, *a):
        raise NotImplementedError("verify-only sim plane")

    def make_rand(self, n):
        return None

    def recombine_packed(self, *a):
        raise NotImplementedError("verify-only sim plane")


def build_cluster(
    n: int = 4,
    t: int = 3,
    num_validators: int = 1,
    slot_duration: float = 0.2,
    slots_per_epoch: int = 8,
    genesis_time: float | None = None,
    use_qbft: bool = False,
    wire_vmock: bool = True,
    protocol_prefs: list[list[str]] | None = None,
    chaos=None,  # testutil.chaos.ChaosConfig: seeded fault injection
    tracing_on: bool = False,
    trace_dir: str | None = None,
    crypto_plane: bool = False,
    flightrec: bool = False,
    crypto_service=None,  # core/cryptosvc.CryptoPlaneService: tenants
    crypto_remote=None,  # (share_idx, TenantPlane) -> plane of that node
) -> SimCluster:
    """Create keys and wire n in-process nodes (ref: app/app.go simnet +
    cluster/test_cluster.go generator, redesigned for asyncio).

    With `chaos`, the cluster is built on the fault-injection plane:
    chaos transports for parsig exchange and QBFT messages, a ChaosBeacon
    around the shared mock, and a Partitioner for crash/restart and
    partition/heal control.
    `flightrec` gives every node its own post-mortem ring with the
    production hook chains (evidence, round changes, duty outcomes,
    flush summaries); dump with cluster.dump_flight().

    `protocol_prefs` gives node i the protocol preference list
    `protocol_prefs[i - 1]` and joins every node to one in-memory
    priority/infosync fabric that switches the consensus protocol to the
    cluster's choice at epoch edges (core/priority.py).

    With `tracing_on`, every node gets its OWN app/tracer.Tracer wired
    as a wire() option plus transport-frame trace-context propagation
    — spans land per node as they would across real machines;
    `trace_dir` additionally exports per-node JSONL for the cross-node
    merge. `crypto_plane` routes inbound parsig verification through a
    SlotCoalescer over SimHostPlane so duty traces carry real
    decode/pack/device stage spans without a device; call
    cluster.close() when done.

    With `crypto_service`, node i registers as tenant `node{i}` of that
    shared service, and its SigAgg (with the pubshares and the slot
    clock), ValidatorAPI and Eth2Verifier (with the clock) hold the
    TenantPlane, as app/run.py wires a production node; it excludes
    `crypto_plane`. `crypto_remote(share_idx, tenant_plane)`, given with
    `crypto_service`, returns the plane node i holds instead of its
    TenantPlane: a core/cryptosvc_client.RemotePlane whose local rung is
    that TenantPlane, as app/run.py wires a node with a remote crypto
    service (return the TenantPlane itself to keep a node in-process)."""
    if crypto_service is not None and crypto_plane:
        raise ValueError("crypto_service and crypto_plane exclude each other")
    if crypto_remote is not None and crypto_service is None:
        raise ValueError("crypto_remote needs crypto_service")
    impl = tbls.get_implementation()

    group_pubkeys: list[PubKey] = []
    share_keys: list[dict[PubKey, bytes]] = [dict() for _ in range(n)]
    pubshares_by_idx: dict[int, dict[PubKey, bytes]] = {
        i: {} for i in range(1, n + 1)
    }
    validators: dict[PubKey, int] = {}

    for v in range(num_validators):
        secret = impl.generate_secret_key()
        shares = impl.threshold_split(secret, n, t)
        group_pk = pubkey_from_bytes(impl.secret_to_public_key(secret))
        group_pubkeys.append(group_pk)
        validators[group_pk] = v
        for idx, share in shares.items():
            share_keys[idx - 1][group_pk] = share
            pubshares_by_idx[idx][group_pk] = impl.secret_to_public_key(share)

    import time as _time

    beacon = BeaconMock(
        validators=validators,
        genesis_time=genesis_time if genesis_time is not None else _time.time(),
        slot_duration=slot_duration,
        slots_per_epoch=slots_per_epoch,
    )

    partitioner = None
    if chaos is not None:
        from charon_tpu_torch.testutil.chaos import ChaosBeacon, Partitioner

        partitioner = Partitioner()
        beacon = ChaosBeacon(beacon, chaos)

    cluster = SimCluster(
        n=n,
        t=t,
        beacon=beacon,
        fork=SIMNET_FORK,
        group_pubkeys=group_pubkeys,
        share_keys=share_keys,
        pubshares_by_idx=pubshares_by_idx,
        partitioner=partitioner,
        crypto_service=crypto_service,
        crypto_remote=crypto_remote,
    )

    if chaos is not None:
        from charon_tpu_torch.testutil.chaos import ChaosParSigTransport

        transport = ChaosParSigTransport(chaos, partitioner)
        cluster.chaos_transport = transport
    else:
        transport = MemTransport()
    qbft_net = None
    if use_qbft:
        if chaos is not None:
            from charon_tpu_torch.testutil.chaos import ChaosMsgNet

            qbft_net = ChaosMsgNet(chaos, partitioner)
            cluster.chaos_qbft = qbft_net
        else:
            from charon_tpu_torch.core.consensus_qbft import MemMsgNet

            qbft_net = MemMsgNet()
    # priority negotiation fabric (opt-in: protocol_prefs per node)
    prio_fabric = None
    if protocol_prefs is not None:
        from charon_tpu_torch.core.priority import MemPriorityFabric

        assert len(protocol_prefs) == n
        prio_fabric = MemPriorityFabric()
    for i in range(1, n + 1):
        cluster.nodes.append(
            _build_node(
                cluster,
                i,
                transport,
                slots_per_epoch,
                qbft_net,
                wire_vmock,
                prio_fabric=prio_fabric,
                protocol_prefs=(
                    protocol_prefs[i - 1] if protocol_prefs else None
                ),
                tracing_on=tracing_on,
                trace_dir=trace_dir,
                crypto_plane=crypto_plane,
                flightrec=flightrec,
            )
        )
    return cluster


def _build_node(
    cluster: SimCluster,
    share_idx: int,
    transport: MemTransport,
    spe: int,
    qbft_net=None,
    wire_vmock: bool = True,
    prio_fabric=None,
    protocol_prefs: list[str] | None = None,
    tracing_on: bool = False,
    trace_dir: str | None = None,
    crypto_plane: bool = False,
    flightrec: bool = False,
) -> SimNode:
    beacon = cluster.beacon
    fork = cluster.fork

    node_tracer = None
    if tracing_on:
        from charon_tpu_torch.app.tracer import Tracer

        jsonl = (
            f"{trace_dir}/node{share_idx}.jsonl" if trace_dir else None
        )
        node_tracer = Tracer(jsonl_path=jsonl)

    rec = None
    if flightrec:
        from charon_tpu_torch.app import flightrec as flightrec_mod

        rec = flightrec_mod.FlightRecorder(node=f"node{share_idx}")

    plane = None
    if crypto_plane:
        from charon_tpu_torch.app.tracer import current_ctx, plane_span_bridge
        from charon_tpu_torch.core.cryptoplane import SlotCoalescer
        from charon_tpu_torch.tbls.torch_impl import TorchImpl

        plane_stats = plane_span_bridge(node_tracer)
        if rec is not None:
            plane_stats = flightrec_mod.stats_hook(rec, inner=plane_stats)
        # the stand-in plane decodes on the host: the TorchImpl only
        # holds the point caches, so it lives on the CPU
        plane = SlotCoalescer(
            SimHostPlane(cluster.t),
            window=0.005,
            decode_workers=2,
            stats_hook=plane_stats,
            impl=TorchImpl(device="cpu"),
            submit_ctx=current_ctx,
        )
    clock = beacon.clock()
    tenant_plane = None
    if cluster.crypto_service is not None:
        tenant_plane = cluster.crypto_service.register(f"node{share_idx}")
        if cluster.crypto_remote is not None:
            tenant_plane = cluster.crypto_remote(share_idx, tenant_plane)

    from charon_tpu_torch.core.evidence import EvidenceRegistry

    evidence = EvidenceRegistry(
        hook=flightrec_mod.byzantine_hook(rec) if rec is not None else None
    )
    dutydb = DutyDB()
    parsigdb = ParSigDB(threshold=cluster.t, evidence=evidence)
    sigagg = SigAgg(
        threshold=cluster.t,
        fork=fork,
        slots_per_epoch=spe,
        plane=tenant_plane,
        pubshares_by_idx=cluster.pubshares_by_idx if tenant_plane else None,
        clock=clock if tenant_plane else None,
        evidence=evidence,
    )
    # flag-selected impl, mirroring production wiring (run.py)
    aggsigdb = new_agg_sigdb()
    bcast = Broadcaster(beacon=beacon, clock=clock)
    fetcher = Fetcher(beacon)
    if qbft_net is not None:
        from charon_tpu_torch.core.consensus_qbft import QBFTConsensus

        qc = QBFTConsensus(
            qbft_net,
            cluster.n,
            round_timeout=0.3,
            timer="inc",
            tracer=node_tracer,
            evidence=evidence,
        )
        if rec is not None:
            qc.on_round_change = flightrec_mod.consensus_hook(rec)
        consensus = ConsensusController(qc)
        # echo stays registered as a switchable alternate so priority
        # negotiation can change the protocol mid-run
        consensus.register(EchoConsensus())
    else:
        consensus = ConsensusController(EchoConsensus())
    vapi = ValidatorAPI(
        share_idx=share_idx,
        pubshares=cluster.pubshares_by_idx[share_idx],
        fork=fork,
        slots_per_epoch=spe,
        plane=tenant_plane,
    )
    verifier = Eth2Verifier(
        fork,
        cluster.pubshares_by_idx,
        spe,
        plane=tenant_plane if tenant_plane is not None else plane,
        clock=clock if tenant_plane else None,
    )
    # clock enables the deadline-aware resend when a chaos transport
    # (or a real p2p link) raises on send
    parsigex = ParSigEx(
        share_idx,
        transport,
        verifier,
        clock=clock,
        tracer=node_tracer,
        evidence=evidence,
    )
    scheduler = Scheduler(
        beacon,
        clock,
        beacon.validators,
        slots_per_epoch=spe,
    )

    # fetcher.fetch runs as its own deadline-bounded retried task, same
    # as production (ref: app/retry wired via core.WithAsyncRetry,
    # app/app.go:571): the proposer fetch blocks on the aggregated
    # randao, and transient BN failures (fuzzed or real) re-fetch until
    # the duty deadline.
    from charon_tpu_torch.app.retry import Retryer, with_async_retry

    retryer = Retryer(
        deadline_of=clock.duty_deadline,
        backoff=max(0.05, beacon.slot_duration / 8),
    )
    spawn_fetch = with_async_retry(retryer)

    # same tracker wiring as production (app/run.py): every edge feeds
    # step/participation events; tests expire duties to get reports.
    # threshold comes from the CLUSTER definition, not the quorum
    # default — participation accounting must agree with parsigdb/sigagg
    # about how many partials a validator needs.
    tracker = Tracker(
        peer_share_indices=list(range(1, cluster.n + 1)),
        threshold=cluster.t,
    )
    if rec is not None:
        tracker.subscribe(flightrec_mod.duty_hook(rec))

    options = [tracking(tracker), spawn_fetch]
    if node_tracer is not None:
        # same wire option as production (app/run.py): duty-rooted span
        # per workflow edge, recorded into THIS node's tracer
        options.insert(0, tracing(node_tracer))
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
        options=options,
    )
    # fetcher pulls the aggregated randao from aggsigdb
    fetcher.register_agg_sig_db(aggsigdb.await_)

    vmock = ValidatorMock(
        vapi=vapi,
        share_keys=cluster.share_keys[share_idx - 1],
        fork=fork,
        slots_per_epoch=spe,
    )

    # The vmock performs duties when the scheduler triggers them
    # (ref: app/vmock.go wires validatormock to scheduler duties).
    # wire_vmock=False lets tests drive duties over HTTP instead.
    async def on_duty(duty, defs):
        from charon_tpu_torch.core.types import DutyType

        if duty.type == DutyType.ATTESTER:
            await vmock.attest(duty.slot, defs)
        elif duty.type == DutyType.PROPOSER:
            # run concurrently: proposal request blocks until consensus,
            # which needs this very VC's randao partial first
            for pubkey in defs:
                asyncio.create_task(vmock.propose(duty.slot, pubkey))

    if wire_vmock:
        scheduler.subscribe_duties(on_duty)

    # inclusion checker (ref: core/tracker/inclusion.go wiring)
    # check_lag=1: simnet runs span a handful of slots; the
    # production 6-slot reorg lag would make the checker inert here
    inclusion = InclusionChecker(beacon, check_lag=1)
    bcast.subscribe(inclusion.submitted)
    scheduler.subscribe_slots(inclusion.on_slot)

    # priority/infosync negotiation at epoch edges, switching the
    # consensus protocol to the cluster choice (same wiring as
    # app/run.py; ref: core/priority + core/infosync)
    if prio_fabric is not None and protocol_prefs is not None:
        from charon_tpu_torch.core.priority import (
            InfoSync,
            Prioritiser,
            protocol_switcher,
        )

        prio_fabric.join()
        prioritiser = Prioritiser(
            node_idx=share_idx,
            quorum=cluster.t,
            exchange=prio_fabric.exchange,
            consensus=consensus,
            topics_fn=lambda: {InfoSync.TOPIC_PROTOCOL: protocol_prefs},
        )
        prioritiser.subscribe(protocol_switcher(consensus))
        infosync = InfoSync(prioritiser)
        scheduler.subscribe_slots(infosync.on_slot)

    return SimNode(
        share_idx=share_idx,
        scheduler=scheduler,
        vapi=vapi,
        vmock=vmock,
        dutydb=dutydb,
        parsigdb=parsigdb,
        sigagg=sigagg,
        aggsigdb=aggsigdb,
        bcast=bcast,
        consensus=consensus,
        inclusion=inclusion,
        tracker=tracker,
        tracer=node_tracer,
        crypto_plane=plane,
        tenant_plane=tenant_plane,
        parsigex=parsigex,
        evidence=evidence,
        flightrec=rec,
    )
