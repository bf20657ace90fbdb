"""PyTorch port: the in-process cluster (charon_tpu_torch/testutil/simnet.py)
and the node's duty workflow end to end, held against the JAX package.

  * The JAX package's tests/test_simnet.py cases run on the port's simnet
    (`reference_cases`), the priority negotiation case included.
  * The slice as a whole: the reference simnet and the port's, built from
    the same seeded secrets and the same genesis and driven in one event
    loop, broadcast byte-equal attestations and blocks (SSZ and
    signature) for every slot both complete.
  * The tenant seam: `build_cluster(crypto_service=...)` over the port's
    SlotCoalescer on a test-side host plane that verifies and recombines
    with the reference's pure-Python oracle (crypto/pairing_fast,
    crypto/shamir): every node's SigAgg, ValidatorAPI and Eth2Verifier
    holds its TenantPlane, the duties complete with no inline tbls call,
    and the service's flushes carry every node's lanes.
  * The registry: build_cluster's options that later slices ported build
    (chaos, protocol_prefs, flightrec), and get_implementation() raises
    without a card.
    Clusters here run on the port's host backends (NativeImpl where
    native/libcharon_native.so loads, else PythonImpl).
  * Signed QBFT: a cluster whose messages are k1-signed over the port's
    app/k1util decides.
  * `slow`: one attester duty through the service over the port's
    SlotCryptoPlane on the CPU with TorchImpl(device="cpu"), against the
    reference simnet's broadcast (each CPU plane program takes 5-15 s).

Tolerance: exact (bytes).
"""

from __future__ import annotations

import asyncio
import importlib
import time

import numpy as np
import pytest
import torch
from test_torch_node_core import export_cases, port_globals, reference_cases  # noqa: F401 — port_globals: autouse

from charon_tpu import tbls as ref_tbls
from charon_tpu.crypto import shamir as ref_shamir
from charon_tpu.crypto.bls import G1_GEN, g1_neg
from charon_tpu.core.types import pubkey_to_bytes as ref_pubkey_to_bytes
from charon_tpu.crypto.pairing_fast import is_gt_one, multi_pairing_fast
from charon_tpu.eth2util import ssz as ref_ssz
from charon_tpu.testutil import simnet as ref_simnet
from charon_tpu_torch import tbls as port_tbls
from charon_tpu_torch.core.cryptoplane import SlotCoalescer
from charon_tpu_torch.core.cryptosvc import CryptoPlaneService, TenantPlane
from charon_tpu_torch.core.eth2data import SignedData
from charon_tpu_torch.core.types import Duty, DutyType, pubkey_to_bytes
from charon_tpu_torch.crypto.fields import R
from charon_tpu_torch.eth2util import ssz as port_ssz
from charon_tpu_torch.tbls.python_impl import PythonImpl
from charon_tpu_torch.tbls.torch_impl import TorchImpl
from charon_tpu_torch.testutil import simnet as port_simnet

torch.set_num_threads(1)  # tiny tensors: more intra-op threads only spin

SIMNET_CASES = export_cases(reference_cases("test_simnet"), globals())


def _host_backend(package: str = "charon_tpu_torch"):
    """The package's native backend where it builds, else its PythonImpl
    (the reference simnet's own choice): the port's by default, the
    reference's for the reference cluster."""
    try:
        return importlib.import_module(f"{package}.tbls.native_impl").NativeImpl()
    except ImportError:
        return importlib.import_module(f"{package}.tbls.python_impl").PythonImpl()


class SeededKeys:
    """A host tbls backend whose generate_secret_key draws from a seeded
    generator: two of them with one seed hand both packages' clusters the
    same validator secrets. `inline` counts the batch crypto calls, which a
    cluster on a crypto service must never make."""

    def __init__(self, inner, seed: int):
        self._inner = inner
        self._rng = np.random.default_rng(seed)
        self.inline = 0

    def generate_secret_key(self) -> bytes:
        while True:
            sk = int.from_bytes(self._rng.bytes(32), "big") % R
            if sk:
                return sk.to_bytes(32, "big")

    def verify_batch(self, items):
        self.inline += 1
        return self._inner.verify_batch(items)

    def threshold_aggregate_batch(self, batch):
        self.inline += 1
        return self._inner.threshold_aggregate_batch(batch)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _completed_by_all(cluster) -> tuple[dict, dict]:
    """slot -> the n broadcast attestations, and slot -> the n broadcast
    (proposal, signature) pairs, for slots every node broadcast."""
    n = cluster.n
    atts: dict[int, list] = {}
    for a in cluster.beacon.attestations:
        atts.setdefault(a.data.slot, []).append(a)
    props: dict[int, list] = {}
    for proposal, sig in cluster.beacon.proposals:
        props.setdefault(proposal.slot, []).append((proposal, sig))
    return (
        {s: v for s, v in atts.items() if len(v) >= n},
        {s: v for s, v in props.items() if len(v) >= n},
    )


async def _drive(clusters, done, timeout: float) -> None:
    """Run every node's scheduler until done() holds, then stop them."""
    tasks = [asyncio.create_task(node.scheduler.run()) for c in clusters for node in c.nodes]
    try:

        async def wait():
            while not done():
                await asyncio.sleep(0.05)

        await asyncio.wait_for(wait(), timeout=timeout)
    finally:
        for c in clusters:
            for node in c.nodes:
                node.scheduler.stop()
        await asyncio.gather(*tasks, return_exceptions=True)


def _att_bytes(ssz, atts) -> set[tuple[bytes, bytes]]:
    return {(ssz.serialize(a), a.signature) for a in atts}


def _block_bytes(ssz, props) -> set[tuple[bytes, bytes]]:
    return {(ssz.serialize(p.block), sig) for p, sig in props}


def test_port_simnet_broadcasts_the_reference_bytes():
    """The slice as a whole: both packages' clusters from the same seeded
    secrets broadcast identical attestations and blocks."""
    ref_tbls.set_implementation(SeededKeys(_host_backend("charon_tpu"), seed=7))
    port_tbls.set_implementation(SeededKeys(_host_backend(), seed=7))

    async def run():
        genesis = time.time()
        kw = dict(n=4, t=3, num_validators=1, slot_duration=0.6, genesis_time=genesis)
        ref = ref_simnet.build_cluster(**kw)
        port = port_simnet.build_cluster(**kw)
        assert [pubkey_to_bytes(pk) for pk in port.group_pubkeys] == [ref_pubkey_to_bytes(pk) for pk in ref.group_pubkeys]

        def common():
            (ra, rp), (pa, pp) = _completed_by_all(ref), _completed_by_all(port)
            return sorted(set(ra) & set(pa)), sorted(set(rp) & set(pp))

        await _drive([ref, port], lambda: all(len(c) >= 2 for c in common()), timeout=90)
        att_slots, prop_slots = common()
        (ra, rp), (pa, pp) = _completed_by_all(ref), _completed_by_all(port)
        for s in att_slots:
            want = _att_bytes(ref_ssz, ra[s])
            assert len(want) == 1  # every reference node broadcast the same bytes
            assert _att_bytes(port_ssz, pa[s]) == want, s
        for s in prop_slots:
            want = _block_bytes(ref_ssz, rp[s])
            assert len(want) == 1
            assert _block_bytes(port_ssz, pp[s]) == want, s

    asyncio.run(run())


class OraclePlane:
    """Test-side host plane for the port's SlotCoalescer: per-lane pairing
    verify and Lagrange recombination on decoded points with the
    reference's pure-Python oracle (what its PythonImpl computes)."""

    def __init__(self, t: int):
        self.t = t
        self.verify_lanes = 0
        self.recombine_rows = 0

    @staticmethod
    def _check(pk_pt, msg_pt, sig_pt) -> bool:
        return is_gt_one(multi_pairing_fast([(sig_pt, g1_neg(G1_GEN)), (msg_pt, pk_pt)]))

    def verify_host(self, pks, msgs, sigs, rng=None):
        self.verify_lanes += len(pks)
        return [self._check(*lane) for lane in zip(pks, msgs, sigs)]

    def recombine_host(self, pubshares, msgs, partials, group_pks, indices, rng=None):
        self.recombine_rows += len(msgs)
        sigs = [ref_shamir.threshold_aggregate_g2(dict(zip(idx, parts))) for idx, parts in zip(indices, partials)]
        return sigs, [self._check(g, m, s) for g, m, s in zip(group_pks, msgs, sigs)]


def test_cluster_on_a_crypto_service_runs_every_node_as_a_tenant():
    backend = SeededKeys(_host_backend(), seed=11)
    port_tbls.set_implementation(backend)
    stats: list = []
    plane = OraclePlane(3)

    async def run():
        coal = SlotCoalescer(plane, window=0.02, stats_hook=stats.append, impl=TorchImpl(device="cpu"))
        svc = CryptoPlaneService(coal)
        cluster = port_simnet.build_cluster(n=4, t=3, num_validators=2, slot_duration=6.0, crypto_service=svc)
        assert cluster.crypto_service is svc
        for node in cluster.nodes:
            tp = node.tenant_plane
            assert isinstance(tp, TenantPlane) and tp.tenant_id == f"node{node.share_idx}"
            assert node.sigagg.plane is tp and node.vapi.plane is tp and node.parsigex.verifier.plane is tp
            assert node.sigagg.pubshares_by_idx is cluster.pubshares_by_idx and node.crypto_plane is None
        def slot_done():
            atts, props = _completed_by_all(cluster)
            return {s for s in atts if len(atts[s]) == 2 * cluster.n} & set(props)

        try:
            await _drive([cluster], slot_done, timeout=120)
        finally:
            svc.close()
            coal.close()
        slot = min(slot_done())
        atts, props = _completed_by_all(cluster)
        epoch = slot // cluster.beacon.slots_per_epoch
        gpks = [pubkey_to_bytes(pk) for pk in cluster.group_pubkeys]
        by_committee: dict[int, set] = {}
        for a in atts[slot]:
            by_committee.setdefault(a.data.index, set()).add(a.signature)
            root = SignedData("attestation", a).signing_root(cluster.fork, epoch)
            # a valid group signature of exactly one validator
            assert sum(backend._inner.verify_batch([(gpk, root, a.signature) for gpk in gpks])) == 1
        assert len(by_committee) == 2 and all(len(sigs) == 1 for sigs in by_committee.values())  # the nodes agree
        proposal, psig = props[slot][0]
        assert {sig for _, sig in props[slot]} == {psig}
        proot = SignedData("block", proposal).signing_root(cluster.fork, epoch)
        assert sum(backend._inner.verify_batch([(gpk, proot, psig) for gpk in gpks])) == 1
        # the tracker on every node names no missed validator for the slot
        for node in cluster.nodes:
            for duty_type in (DutyType.ATTESTER, DutyType.PROPOSER, DutyType.RANDAO):
                report = await node.tracker.duty_expired(Duty(slot, duty_type))
                assert report.success and not report.failed_pubkeys, (node.share_idx, duty_type)

    asyncio.run(run())
    assert backend.inline == 0  # the service carried every verify and recombine
    assert plane.verify_lanes > 0 and plane.recombine_rows > 0
    tenants = {t for s in stats for t, _ in s.tenant_lanes}
    assert tenants == {f"node{i}" for i in range(1, 5)}


def test_mem_transport_delivers_to_every_peer_at_once():
    """The port's MemTransport.send is the reference's again: given the
    same peers and the same set, both deliver it to every peer but the
    sender, one peer at a time in attach order (each delivery awaited
    before the next starts), with the sender's index and the same set
    object; a failing receiver is isolated and skips nobody, and the send
    returns only after the last delivery."""
    from charon_tpu.core.parsigex import MemTransport as RefMemTransport
    from charon_tpu_torch.core.parsigex import MemTransport

    def trace(transport_cls):
        log = []

        class Peer:
            def __init__(self, share_idx, fail=False):
                self.share_idx, self.fail = share_idx, fail

            async def receive(self, duty, signed_set, tctx=None, sender=None):
                log.append(("enter", self.share_idx, sender, duty, id(signed_set) == id(sset)))
                await asyncio.sleep(0.01)
                log.append(("leave", self.share_idx))
                if self.fail:
                    raise RuntimeError("receiver down")

        sset = {"pk": "partial"}

        async def main():
            net = transport_cls()
            for i in (3, 1, 4, 2):
                net.attach(Peer(i, fail=i == 4))
            await asyncio.wait_for(net.send(1, Duty(7, DutyType.ATTESTER), sset), 5.0)
            log.append(("returned",))

        asyncio.run(main())
        return log

    port, ref = trace(MemTransport), trace(RefMemTransport)
    assert port == ref
    duty = Duty(7, DutyType.ATTESTER)
    assert port == [
        ("enter", 3, 1, duty, True), ("leave", 3),
        ("enter", 4, 1, duty, True), ("leave", 4),
        ("enter", 2, 1, duty, True), ("leave", 2),
        ("returned",),
    ]


@pytest.mark.parametrize(
    "option",
    [dict(chaos="seed=1"), dict(protocol_prefs=[["qbft/2.0.0"]] * 4), dict(flightrec=True)],
    ids=["chaos", "protocol_prefs", "flightrec"],
)
def test_unported_build_cluster_options_raise(option):
    """chaos (testutil/chaos.py, ported with the chaos harness) builds
    every node on one fault plane and the cluster attests; protocol_prefs
    (core/priority.py, ported with the wire) builds every node on one
    priority fabric; flightrec (app/flightrec.py, ported with
    observability) gives every node its own recorder, which
    `dump_flight` writes out for the cross-node merge."""
    import tempfile

    from charon_tpu_torch.app import flightrec

    port_tbls.set_implementation(PythonImpl())
    if "protocol_prefs" in option:
        cluster = port_simnet.build_cluster(n=4, t=3, **option)
        assert len(cluster.nodes) == 4
        return
    if "flightrec" in option:
        cluster = port_simnet.build_cluster(n=4, t=3, **option)
        recs = [node.flightrec for node in cluster.nodes]
        assert all(isinstance(r, flightrec.FlightRecorder) for r in recs)
        assert [r.node for r in recs] == ["node1", "node2", "node3", "node4"]
        recs[2].record("lifecycle", "start")
        with tempfile.TemporaryDirectory() as out:
            paths = cluster.dump_flight(out)
            assert len(paths) == 4
            merged = flightrec.merge_jsonl(paths)
        assert [(e["node"], e["kind"]) for e in merged] == [("node3", "start")]
        return
    from charon_tpu_torch.testutil import chaos

    cluster = port_simnet.build_cluster(
        n=4, t=3, num_validators=1, slot_duration=0.4, chaos=chaos.config_from_spec(option["chaos"])
    )
    assert isinstance(cluster.beacon, chaos.ChaosBeacon) and isinstance(cluster.partitioner, chaos.Partitioner)
    assert isinstance(cluster.chaos_transport, chaos.ChaosParSigTransport)

    async def attest():
        tasks = [asyncio.create_task(node.scheduler.run()) for node in cluster.nodes]
        try:
            while not cluster.beacon.attestations:
                await asyncio.sleep(0.05)
        finally:
            for node in cluster.nodes:
                node.scheduler.stop()
            for task in tasks:
                task.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

    asyncio.run(asyncio.wait_for(attest(), 60.0))


def test_qbft_message_keys_raise_until_k1util():
    """QBFTConsensus(privkey=, pubkeys=) raised NotImplementedError until
    the port had app/k1util.py. Now a 4-node cluster whose every message
    is k1-signed over the port's k1util decides one value on every node,
    every message it sent verifies under its sender's key, and a copy
    signed with another node's key is refused."""
    import dataclasses

    from charon_tpu_torch.app import k1util
    from charon_tpu_torch.core import qbft
    from charon_tpu_torch.core.consensus_qbft import MemMsgNet, QBFTConsensus

    n = 4
    privs = [k1util.generate_private_key() for _ in range(n)]
    pubs = [k1util.public_key_to_bytes(k.public_key()) for k in privs]
    sent: list = []

    class RecordingNet(MemMsgNet):
        async def broadcast(self, from_idx, duty, msg, values, tctx=None):
            sent.append((from_idx, msg))
            await super().broadcast(from_idx, duty, msg, values, tctx=tctx)

    net = RecordingNet()
    nodes = [
        QBFTConsensus(net, n, round_timeout=0.15, round_increase=0.15, privkey=privs[i], pubkeys=pubs, timer="inc")
        for i in range(n)
    ]
    duty = Duty(slot=1, type=DutyType.ATTESTER)
    unsigned = {"pk1": "attdata"}
    decided = []
    for node in nodes:

        async def sub(d, s):
            decided.append((d, s))

        node.subscribe(sub)

    async def run():
        await asyncio.wait_for(asyncio.gather(*(node.propose(duty, dict(unsigned)) for node in nodes)), 10)

    asyncio.run(run())
    assert decided == [(duty, unsigned)] * n
    assert sent and all(nodes[0].defn.is_valid(msg) for _, msg in sent)
    msg = next(m for s, m in sent if s != 0)
    forged = dataclasses.replace(msg, signature=k1util.sign(privs[0], qbft.msg_digest(msg)))
    assert not nodes[0].defn.is_valid(forged)


def test_registry_default_is_the_card_and_raises_without_one():
    """No backend installed: get_implementation() builds TorchImpl() on
    the card, so on a host without CUDA it raises, and nothing falls back
    to the host."""
    port_tbls.set_implementation(None)
    if torch.cuda.is_available():
        assert isinstance(port_tbls.get_implementation(), TorchImpl)
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        port_tbls.get_implementation()
    with pytest.raises(RuntimeError, match="CUDA"):
        port_tbls.verify_batch([])
    assert port_tbls._current is None


@pytest.mark.slow
def test_attester_duty_through_the_torch_plane_on_the_cpu_equals_the_reference():
    """One attester duty of a 3-of-4, 1-validator cluster through the
    service over the port's SlotCryptoPlane on the CPU, against the
    reference simnet's broadcast in the same slot."""
    from charon_tpu_torch.parallel import SlotCryptoPlane, make_mesh

    ref_tbls.set_implementation(SeededKeys(_host_backend("charon_tpu"), seed=5))
    backend = SeededKeys(_host_backend(), seed=5)
    port_tbls.set_implementation(backend)
    slot_s = 120.0

    async def run():
        impl = TorchImpl(device="cpu")
        coal = SlotCoalescer(SlotCryptoPlane(make_mesh(["cpu"]), t=3), window=0.5, impl=impl, decode_workers=2)
        svc = CryptoPlaneService(coal)
        # slot 0 started a third of a slot ago: its attester duty is due now
        genesis = time.time() - slot_s / 3 + 1.0
        kw = dict(n=4, t=3, num_validators=1, slot_duration=slot_s, genesis_time=genesis)
        ref = ref_simnet.build_cluster(**kw)
        port = port_simnet.build_cluster(crypto_service=svc, **kw)
        await coal.warm_caches(pubkeys=[p for pubs in port.pubshares_by_idx.values() for p in pubs.values()])
        try:
            await _drive([ref, port], lambda: 0 in _completed_by_all(port)[0] and 0 in _completed_by_all(ref)[0], 1500)
        finally:
            svc.close()
            coal.close()
        want = _att_bytes(ref_ssz, _completed_by_all(ref)[0][0])
        assert len(want) == 1
        assert _att_bytes(port_ssz, _completed_by_all(port)[0][0]) == want

    asyncio.run(run())
    assert backend.inline == 0
