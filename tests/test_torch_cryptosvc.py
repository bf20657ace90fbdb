"""PyTorch port: the multi-tenant crypto-plane service
(charon_tpu_torch/core/cryptosvc.py), the JAX package's service cases of
tests/test_hostplane.py (overload fail-fast, EDF preemption, the breaker,
shed load, cancelled submissions, tenant lanes) run on the port's service,
over the reference's StubCoalescer and over the port's SlotCoalescer on a
test-side fake plane.

The port's coalescer has no degrade rungs, so the reference's inherited
rung (the quarantine coalescer built with the shared coalescer's live
decode step-down) is inverted here: the quarantine coalescer takes the
shared coalescer's decode mode and point caches, and a plane failure in
it fails the quarantined waiter with TblsError instead of stepping down.
Shed load still goes to the submitter's inline tbls call. Tolerance:
exact (verdicts, signature bytes, counters).
"""

from __future__ import annotations

import asyncio
import time

import pytest
import torch
from test_cryptoplane import FakePlane, T
from test_hostplane import StubCoalescer, _sig_items
from test_torch_node_core import port_globals  # noqa: F401 — autouse registry hygiene

from charon_tpu_torch import tbls
from charon_tpu_torch.core import eth2data as d
from charon_tpu_torch.core.cryptoplane import SlotCoalescer
from charon_tpu_torch.core.cryptosvc import (
    CryptoPlaneService,
    PlaneOverloadError,
    TenantConfigError,
    TenantQuota,
)
from charon_tpu_torch.core.parsigex import Eth2Verifier
from charon_tpu_torch.core.sigagg import SigAgg
from charon_tpu_torch.core.types import Duty, DutyType, pubkey_from_bytes
from charon_tpu_torch.eth2util.signing import ForkInfo
from charon_tpu_torch.tbls import TblsError
from charon_tpu_torch.tbls.python_impl import PythonImpl
from charon_tpu_torch.tbls.torch_impl import TorchImpl

torch.set_num_threads(1)  # tiny tensors: more intra-op threads only spin

FORK = ForkInfo(
    genesis_validators_root=b"\x11" * 32,
    fork_version=b"\x00\x00\x00\x01",
    genesis_fork_version=b"\x00" * 4,
)


def _duty_workload(impl, slot: int):
    """One validator's attestation duty on the port's containers:
    (pubkey, psigs, expected group signature, pubshares by share index)."""
    secret = impl.generate_secret_key()
    shares = impl.threshold_split(secret, 4, T)
    pk = pubkey_from_bytes(impl.secret_to_public_key(secret))
    data = d.AttestationData(
        slot=slot,
        index=0,
        beacon_block_root=b"\xaa" * 32,
        source=d.Checkpoint(0, b"\xbb" * 32),
        target=d.Checkpoint(1, b"\xcc" * 32),
    )
    unsigned = d.SignedData("attestation", d.Attestation(aggregation_bits=(True,), data=data))
    root = unsigned.signing_root(FORK, slot // 32)
    psigs = [d.ParSignedData(data=unsigned.with_signature(impl.sign(shares[i], root)), share_idx=i) for i in (1, 2, 3)]
    expected = impl.threshold_aggregate({p.share_idx: p.data.signature for p in psigs})
    pubshares = {i: impl.secret_to_public_key(shares[i]) for i in shares}
    return pk, psigs, expected, pubshares


def test_overload_fails_fast_never_blocks_the_loop():
    """Submissions beyond the tenant's queue bounds raise the typed
    PlaneOverloadError IMMEDIATELY, while in-flight work completes
    normally; shed counters attribute the rejections."""
    stub = StubCoalescer(delay=0.2)
    svc = CryptoPlaneService(stub, round_interval=0.001)
    plane = svc.register("a", TenantQuota(max_queue_jobs=2, max_queue_lanes=100))

    async def main():
        first = asyncio.create_task(plane.verify([1]))
        second = asyncio.create_task(plane.verify([1, 1]))
        await asyncio.sleep(0.05)  # both dispatched, device busy
        t0 = time.monotonic()
        with pytest.raises(PlaneOverloadError) as exc:
            await plane.verify([1])
        assert time.monotonic() - t0 < 0.1, "overload must fail fast, not queue"
        assert exc.value.tenant == "a" and exc.value.reason == "jobs"
        assert await first == [True]
        assert await second == [True, True]
        with pytest.raises(PlaneOverloadError) as exc2:
            await plane.verify([1] * 101)
        assert exc2.value.reason == "lanes"

    asyncio.run(main())
    ten = svc.tenant("a")
    assert ten.shed == {"jobs": 1, "lanes": 1}
    assert ten.shed_lanes == 1 + 101
    svc.close()


def test_edf_preempts_flooder_backlog():
    """A starved tenant's near-deadline duty dispatches ahead of a
    flooder's queued no-deadline backlog."""
    stub = StubCoalescer()
    svc = CryptoPlaneService(stub, round_lanes=8, round_interval=0.03)
    flood = svc.register("flood", TenantQuota(max_queue_lanes=10_000))
    victim = svc.register("victim", TenantQuota())

    async def main():
        # budget/round = 8 * 1/2 = 4 lanes: one 4-lane entry per round
        flood_tasks = [asyncio.create_task(flood.verify([1] * 4)) for _ in range(3)]
        await asyncio.sleep(0.005)  # round 1 dispatched one flood entry
        assert await victim.verify([1] * 4, deadline=time.time() + 0.05) == [True] * 4
        await asyncio.gather(*flood_tasks)

    asyncio.run(main())
    order = [tenant for _, tenant, _ in stub.calls]
    assert order[0] == "flood"
    assert order.index("victim") < len(order) - 1
    assert order.count("flood") == 3 and order.count("victim") == 1
    svc.close()


def test_breaker_open_quarantine_half_open_close():
    """Persistent failed lanes open the breaker (dispatches quarantine to
    the tenant's own coalescer), the cooldown half-opens it, one clean
    quarantined flush closes it, and a failing probe re-opens instead."""
    shared = StubCoalescer()
    quarantine = StubCoalescer()
    transitions: list[tuple[str, str]] = []

    def observer(kind, tenant, **f):
        if kind == "breaker":
            transitions.append((tenant, f["state"]))

    svc = CryptoPlaneService(
        shared, round_interval=0.001, observer=observer, quarantine_factory=lambda tid: quarantine
    )
    plane = svc.register(
        "evil", TenantQuota(breaker_window=64, breaker_min_lanes=8, breaker_threshold=0.5, breaker_cooldown=0.05)
    )

    async def main():
        assert await plane.verify([1, 1]) == [True, True]
        assert svc.tenant("evil").breaker.state == "closed"
        await plane.verify([0] * 8)
        assert svc.tenant("evil").breaker.state == "open"
        before = len(shared.calls)
        await plane.verify([0] * 4)
        assert len(shared.calls) == before
        assert quarantine.calls[-1] == ("verify", "evil", 4)
        assert svc.tenant("evil").quarantined_flushes == 1
        await asyncio.sleep(0.06)
        await plane.verify([0, 1])
        assert svc.tenant("evil").breaker.state == "open"
        await asyncio.sleep(0.06)
        await plane.verify([1, 1])
        assert svc.tenant("evil").breaker.state == "closed"
        await plane.verify([1])
        assert shared.calls[-1] == ("verify", "evil", 1)

    asyncio.run(main())
    assert [s for _, s in transitions] == ["open", "half_open", "open", "half_open", "closed"]
    svc.close()


def test_shed_load_consumed_by_the_inline_tbls_call():
    """The submitters catch PlaneOverloadError and serve shed work with an
    inline call of the installed tbls backend: Eth2Verifier inbound sets
    still verify, SigAgg still aggregates — shed costs latency, never a
    duty."""
    impl = PythonImpl()
    tbls.set_implementation(impl)
    stub = StubCoalescer()
    svc = CryptoPlaneService(stub, round_interval=0.001)
    plane = svc.register("a", TenantQuota(max_queue_jobs=0))  # every submission sheds

    pk, psigs, want, pubshares = _duty_workload(impl, slot=3)
    pubshares_by_idx = {i: {pk: pubshares[i]} for i in pubshares}
    duty = Duty(3, DutyType.ATTESTER)

    async def main():
        verifier = Eth2Verifier(FORK, pubshares_by_idx, plane=plane)
        assert await verifier.verify_async(duty, {pk: psigs[0]}) is True
        agg = SigAgg(threshold=T, fork=FORK, plane=plane, pubshares_by_idx=pubshares_by_idx)
        out: dict = {}

        async def sub(_duty, result):
            out.update(result)

        agg.subscribe(sub)
        await agg.aggregate(duty, {pk: psigs})
        assert out[pk].signature == want

    asyncio.run(main())
    assert stub.calls == []
    assert svc.tenant("a").shed.get("jobs", 0) == 2
    svc.close()


def test_cancelled_submission_dropped_not_dispatched():
    """Cancelled submissions are dropped at dispatch (never shipped) and
    their pending accounting is released."""
    stub = StubCoalescer(delay=0.05)
    svc = CryptoPlaneService(stub, round_interval=0.01)
    plane = svc.register("crashy", TenantQuota())

    async def main():
        hold = asyncio.create_task(plane.verify([1]))  # occupies device
        await asyncio.sleep(0.005)
        doomed = [asyncio.create_task(plane.verify([1] * 2)) for _ in range(4)]
        await asyncio.sleep(0)
        for task in doomed:
            task.cancel()
        await asyncio.gather(*doomed, return_exceptions=True)
        assert await hold == [True]
        assert await plane.verify([1, 1]) == [True, True]

    asyncio.run(main())
    ten = svc.tenant("crashy")
    assert ten.pending_jobs == 0 and ten.pending_lanes == 0
    assert sum(n for _, _, n in stub.calls) == 3
    svc.close()


def test_flush_stats_carry_tenant_lanes():
    """Tenant tags travel submission -> the port coalescer's job ->
    FlushStats.tenant_lanes."""
    stats: list = []
    coal = SlotCoalescer(FakePlane(T), window=0.01, stats_hook=stats.append, impl=TorchImpl(device="cpu"))
    svc = CryptoPlaneService(coal, round_interval=0.001)
    a = svc.register("tenant-a", TenantQuota())
    b = svc.register("tenant-b", TenantQuota())

    async def main():
        items = _sig_items(2)
        assert await asyncio.gather(a.verify(items), b.verify(items[:1])) == [[True, True], [True]]

    asyncio.run(main())
    svc.close()
    coal.close()
    per: dict[str, int] = {}
    for s in stats:
        for tenant, lanes in s.tenant_lanes:
            per[tenant] = per.get(tenant, 0) + lanes
    assert per == {"tenant-a": 2, "tenant-b": 1}


class _FailingPlane(FakePlane):
    """FakePlane whose verify programs raise: a device error."""

    def verify_host(self, pks, msgs, sigs, rng=None):
        raise RuntimeError("device fault")


@pytest.mark.parametrize("decode_mode", ["python", "device"])
def test_quarantine_coalescer_shares_the_plane_mode_and_caches(decode_mode):
    """The default quarantine coalescer is a port SlotCoalescer over the
    SHARED plane with the shared coalescer's decode mode and TorchImpl
    (its point caches), and no degrade state: a plane failure fails the
    quarantined waiter with TblsError, never a host fallback."""
    impl = TorchImpl(device="cpu")
    coal = SlotCoalescer(_FailingPlane(T), window=0.01, decode_mode=decode_mode, impl=impl)
    svc = CryptoPlaneService(coal, round_interval=0.001)
    plane = svc.register(
        "evil", TenantQuota(breaker_window=8, breaker_min_lanes=1, breaker_threshold=0.5, breaker_cooldown=60.0)
    )
    ten = svc.tenant("evil")

    async def main():
        ten.breaker.record(0, 4)  # forged flood on record: the breaker opens
        assert ten.breaker.state == "open"
        with pytest.raises(TblsError) as exc:
            await plane.verify(_sig_items(1))
        assert isinstance(exc.value.__cause__, RuntimeError)

    asyncio.run(main())
    q = ten.quarantine_coal
    assert isinstance(q, SlotCoalescer) and q is not coal
    assert q.plane is coal.plane and q.impl is impl and q.decode_mode == decode_mode
    assert q.window == svc._quarantine_window
    assert not hasattr(q, "plane_factory")
    assert q.failed_flushes == 1 and coal.flushes == 0 and coal.failed_flushes == 0
    svc.close()
    coal.close()


def test_service_errors_are_the_ports():
    """PlaneOverloadError is the port's TblsError (what the submitters'
    shed handlers catch); a duplicate tenant is a config error."""
    assert issubclass(PlaneOverloadError, TblsError)
    svc = CryptoPlaneService(StubCoalescer())
    svc.register("a")
    with pytest.raises(TenantConfigError):
        svc.register("a")
    svc.close()
