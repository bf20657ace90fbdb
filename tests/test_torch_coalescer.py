"""PyTorch port: SlotCoalescer (charon_tpu_torch/core/cryptoplane.py), the
cases of the JAX package's tests/test_cryptoplane.py and
tests/test_hostplane.py that concern the coalescer, run on the port's
twin with their counting fake planes (FakePlane, PackedFakePlane, and the
parsed and warm-up fakes with the port's ParsedPoint), plus one coalesced
two-duty flush on the CPU torch plane.

The port has no degrade ladder, so the JAX package's three degrade tests
(msm-off rebuild, host oracle, decode step-down) are inverted here: a
failing plane fails that flush's waiters with TblsError, leaves
msm_active() alone, and the next flush runs. Tolerance: exact (verdicts,
signature bytes, counters).
"""

from __future__ import annotations

import asyncio
import time

import numpy as np
import pytest
import torch
from test_cryptoplane import FORK, FakePlane, T, _duty_workload
from test_hostplane import PackedFakePlane, ParsedFakePlane, WarmFakePlane, _decode_threads, _sig_items

from charon_tpu import tbls
from charon_tpu.core import eth2data as d
from charon_tpu.core.parsigex import Eth2Verifier
from charon_tpu.core.sigagg import AggregationError, SigAgg
from charon_tpu.core.types import Duty, DutyType
from charon_tpu.tbls.python_impl import PythonImpl
from charon_tpu_torch.core.cryptoplane import FlushStats, PlaneConfigError, SlotCoalescer, _VerifyJob
from charon_tpu_torch.ops import decompress as DEC
from charon_tpu_torch.ops import msm as MSM
from charon_tpu_torch.tbls import TblsError
from charon_tpu_torch.tbls.torch_impl import PointCache, TorchImpl, _decode_pubkey_point

torch.set_num_threads(1)  # tiny tensors: more intra-op threads only spin


def coalescer(plane, **kw) -> SlotCoalescer:
    """A coalescer over `plane` with a fresh CPU TorchImpl's point caches."""
    return SlotCoalescer(plane, impl=TorchImpl(device="cpu"), **kw)


class _PortParsed:
    """The parsed fakes' pack, asserting the port's ParsedPoint."""

    def pack_verify_inputs_parsed(self, pks, msgs, parsed):
        assert all(isinstance(p, DEC.ParsedPoint) for p in parsed)
        return ("vp", np.empty(len(pks)))


class PortParsedFakePlane(_PortParsed, ParsedFakePlane):
    pass


class PortWarmFakePlane(_PortParsed, WarmFakePlane):
    pass


class BoomPlane(FakePlane):
    """FakePlane whose first `fail` verify programs raise `exc`."""

    def __init__(self, t, exc, fail=1):
        super().__init__(t)
        self.exc, self.fail = exc, fail

    def verify_host(self, pks, msgs, sigs, rng=None):
        if self.fail:
            self.fail -= 1
            raise self.exc
        return super().verify_host(pks, msgs, sigs, rng)


def _single(seed: int = 0):
    impl = PythonImpl()
    sk = impl.generate_secret_key()
    pk = impl.secret_to_public_key(sk)
    root = bytes([seed]) * 32
    return impl, sk, pk, root, impl.sign(sk, root)


# -- test_cryptoplane.py ------------------------------------------------------------


def test_two_duties_one_device_call():
    """Two simultaneous duties' SigAgg recombinations coalesce into ONE
    plane program, and each duty still gets its own group signature."""
    impl = PythonImpl()
    tbls.set_implementation(impl)
    fake = FakePlane(T)
    plane = coalescer(fake, window=0.01)
    pk1, gpk1, psigs1, root1, want1, ps1 = _duty_workload(impl, slot=5)
    pk2, gpk2, psigs2, root2, want2, ps2 = _duty_workload(impl, slot=5)
    agg = SigAgg(
        threshold=T, fork=FORK, plane=plane, pubshares_by_idx={i: {pk1: ps1[i], pk2: ps2[i]} for i in (1, 2, 3, 4)}
    )
    out: dict = {}

    async def on_agg(duty, data_set):
        out.update(data_set)

    agg.subscribe(on_agg)

    async def main():
        await asyncio.gather(
            agg.aggregate(Duty(5, DutyType.ATTESTER), {pk1: psigs1}),
            agg.aggregate(Duty(5, DutyType.SYNC_MESSAGE), {pk2: psigs2}),
        )

    asyncio.run(main())
    plane.close()
    assert fake.recombine_calls == 1, "two duties must share one program"
    assert fake.recombine_lane_count == 2
    assert plane.coalesced_flushes == 1
    assert out[pk1].signature == want1 and out[pk2].signature == want2
    impl.verify(gpk1, root1, out[pk1].signature)
    impl.verify(gpk2, root2, out[pk2].signature)


def test_verify_lanes_coalesce_across_components():
    """Concurrent verify submissions merge into one program; malformed
    encodings fail on the host without reaching the device."""
    _, _, pk, root, sig = _single(0x44)
    fake = FakePlane(T)
    plane = coalescer(fake, window=0.01)

    async def main():
        return await asyncio.gather(
            plane.verify([(pk, root, sig), (pk, root, b"\x00" * 96)]),
            plane.verify([(pk, root, sig)]),
        )

    r1, r2 = asyncio.run(main())
    plane.close()
    assert fake.verify_calls == 1 and fake.verify_lane_count == 2
    assert r1 == [True, False] and r2 == [True]
    assert plane.coalesced_flushes == 1


@pytest.mark.parametrize(
    "exc", [RuntimeError("kernel launch failed"), TypeError("host shape bug")], ids=["device", "host-bug"]
)
def test_flush_failure_fails_the_waiters_and_the_next_flush_runs(exc):
    """A failing plane (a device error, or a host bug class) fails every
    waiter of that flush with TblsError carrying the cause; nothing flips
    the MSM family or rebuilds the plane, and the next flush succeeds."""
    _, _, pk, root, sig = _single(0x55)
    boom = BoomPlane(T, exc)
    plane = coalescer(boom, window=0.01)
    try:
        assert MSM.msm_active()

        async def first():
            return await asyncio.gather(
                plane.verify([(pk, root, sig)]), plane.verify([(pk, root, sig)]), return_exceptions=True
            )

        errs = asyncio.run(first())
        assert [type(e) for e in errs] == [TblsError, TblsError]
        assert all(e.__cause__ is exc for e in errs)
        assert plane.failed_flushes == 1 and plane.flushes == 0
        assert MSM.msm_active(), "a failed flush must not flip the MSM family"
        assert plane.plane is boom
        assert asyncio.run(plane.verify([(pk, root, sig)])) == [True]
        assert plane.flushes == 1 and plane.failed_flushes == 1
    finally:
        plane.close()
        MSM.set_msm(None)


def test_persistent_device_failure_never_falls_back_to_the_host():
    """A plane that keeps failing keeps failing its waiters: no host-oracle
    rung serves the batch, and a bad signature is never judged on the
    host."""
    _, _, pk, root, sig = _single(0x66)
    boom = BoomPlane(T, RuntimeError("still broken"), fail=2)
    plane = coalescer(boom, window=0.01)
    try:
        for _ in range(2):
            with pytest.raises(TblsError, match="crypto plane flush failed: RuntimeError: still broken"):
                asyncio.run(plane.verify([(pk, root, sig)]))
        assert plane.failed_flushes == 2 and plane.flushes == 0 and boom.verify_calls == 0
        assert MSM.msm_active()
    finally:
        plane.close()
        MSM.set_msm(None)


def test_recombine_decode_failure_isolated():
    """A duty carrying an undecodable partial fails alone; a concurrent
    healthy duty still aggregates in the same flush."""
    impl = PythonImpl()
    tbls.set_implementation(impl)
    fake = FakePlane(T)
    plane = coalescer(fake, window=0.01)
    pk1, _, psigs1, _, want1, ps1 = _duty_workload(impl, slot=9)
    pk2, _, psigs2, _, _, ps2 = _duty_workload(impl, slot=9)
    psigs2[0] = d.ParSignedData(data=psigs2[0].data.with_signature(b"\xff" * 96), share_idx=psigs2[0].share_idx)
    agg = SigAgg(
        threshold=T, fork=FORK, plane=plane, pubshares_by_idx={i: {pk1: ps1[i], pk2: ps2[i]} for i in (1, 2, 3, 4)}
    )
    out: dict = {}

    async def on_agg(duty, data_set):
        out.update(data_set)

    agg.subscribe(on_agg)

    async def main():
        return await asyncio.gather(
            agg.aggregate(Duty(9, DutyType.ATTESTER), {pk1: psigs1}),
            agg.aggregate(Duty(9, DutyType.SYNC_MESSAGE), {pk2: psigs2}),
            return_exceptions=True,
        )

    ok, err = asyncio.run(main())
    plane.close()
    assert ok is None and isinstance(err, AggregationError)
    assert out[pk1].signature == want1
    assert fake.recombine_calls == 1 and fake.recombine_lane_count == 1


def test_verifier_async_routes_through_plane():
    impl = PythonImpl()
    tbls.set_implementation(impl)
    fake = FakePlane(T)
    plane = coalescer(fake, window=0.01)
    pk, _, psigs, _, _, ps = _duty_workload(impl, slot=7)
    pubshares_by_idx = {i: {pk: ps[i]} for i in (1, 2, 3, 4)}
    with_plane = Eth2Verifier(FORK, pubshares_by_idx, plane=plane)
    without = Eth2Verifier(FORK, pubshares_by_idx)
    duty = Duty(7, DutyType.ATTESTER)

    async def main():
        assert await with_plane.verify_async(duty, {pk: psigs[0]})
        assert await without.verify_async(duty, {pk: psigs[0]})
        bad = d.ParSignedData(data=psigs[0].data, share_idx=9)
        assert not await with_plane.verify_async(duty, {pk: bad})

    asyncio.run(main())
    plane.close()
    assert fake.verify_calls == 1


def test_dispatch_gate_queues_flush_until_tuner_settles():
    """A flush whose window closes while the startup tuner still settles
    the kernel routing queues behind dispatch_gate and keeps coalescing."""
    _, _, pk, root, sig = _single(0x88)
    fake = FakePlane(T)
    plane = coalescer(fake, window=0.01)

    async def main():
        gate = asyncio.Event()
        plane.dispatch_gate = gate
        t1 = asyncio.create_task(plane.verify([(pk, root, sig)]))
        await asyncio.sleep(0.05)
        assert fake.verify_calls == 0, "flush must wait for the tuner"
        assert not t1.done()
        t2 = asyncio.create_task(plane.verify([(pk, root, sig)]))
        await asyncio.sleep(0.02)
        gate.set()
        return await asyncio.gather(t1, t2)

    r1, r2 = asyncio.run(main())
    plane.close()
    assert r1 == [True] and r2 == [True]
    assert plane.gated_flushes == 1
    assert fake.verify_calls == 1 and fake.verify_lane_count == 2


def test_no_dispatch_gate_means_no_gating():
    _, _, pk, root, sig = _single(0x99)
    plane = coalescer(FakePlane(T), window=0.01)
    assert asyncio.run(plane.verify([(pk, root, sig)])) == [True]
    plane.close()
    assert plane.gated_flushes == 0


def test_bad_decode_mode_is_a_config_error():
    with pytest.raises(PlaneConfigError):
        coalescer(FakePlane(T), decode_mode="gpu")


# -- test_hostplane.py: decode pool and windows --------------------------------------


def test_decode_pool_results_match_sync_path():
    items = _sig_items(3)
    items.append((items[0][0], b"\x01" * 32, b"\x00" * 96))

    def run(workers):
        plane = coalescer(FakePlane(T), window=0.01, decode_workers=workers)
        try:
            return asyncio.run(plane.verify(items))
        finally:
            plane.close()

    assert run(0) == run(2) == [True, True, True, False]


def test_no_decode_threads_until_used_and_none_when_disabled():
    for th in _decode_threads():  # pools closed by earlier tests wind down
        th.join(timeout=5)
    assert not _decode_threads()
    idle = coalescer(FakePlane(T), window=0.01)
    assert idle._decode_pool is None and not _decode_threads()
    idle.close()
    off = coalescer(FakePlane(T), window=0.01, decode_workers=0)
    assert asyncio.run(off.verify(_sig_items(1))) == [True]
    assert off._decode_pool is None and not _decode_threads()
    off.close()
    on = coalescer(FakePlane(T), window=0.01, decode_workers=2)
    assert asyncio.run(on.verify(_sig_items(1))) == [True]
    assert len(_decode_threads()) >= 1
    on.close()


def test_recombine_decodes_off_loop():
    """recombine() rows decode on the pool too; a bad row prefails and
    never ships, the good row still lands."""
    impl = PythonImpl()
    secret = impl.generate_secret_key()
    shares = impl.threshold_split(secret, 4, T)
    gpk = impl.secret_to_public_key(secret)
    root = b"\x21" * 32
    partials = [impl.sign(shares[i], root) for i in (1, 2, 3)]
    pubshares = [impl.secret_to_public_key(shares[i]) for i in (1, 2, 3)]
    fake = FakePlane(T)
    plane = coalescer(fake, window=0.01, decode_workers=2)
    sigs, oks = asyncio.run(
        plane.recombine(
            [pubshares, pubshares, pubshares],
            [root, root, root],
            [partials, [b"\xff" * 96] * 3, partials],
            [gpk, gpk, gpk],
            [[1, 2, 3], [1, 2, 3], [0, 1, 2]],  # third row: a 0 index
        )
    )
    plane.close()
    assert oks == [True, False, False]
    assert sigs[1] is None and sigs[2] is None
    assert fake.recombine_lane_count == 1
    impl.verify(gpk, root, sigs[0])


def test_window_grows_under_load_and_decays_when_idle():
    plane = coalescer(FakePlane(T), window=0.005, window_max=0.05)
    items = _sig_items(1)

    async def burst():
        await asyncio.gather(plane.verify(items), plane.verify(items))

    base = plane.current_window
    asyncio.run(burst())
    grown = plane.current_window
    assert grown > base
    for _ in range(6):
        asyncio.run(plane.verify(items))
    plane.close()
    assert plane.current_window == pytest.approx(base)


class SlowPlane(FakePlane):
    """FakePlane whose verify program holds the device lane `hold` s."""

    def __init__(self, t, hold):
        super().__init__(t)
        self.hold = hold

    def verify_host(self, pks, msgs, sigs, rng=None):
        time.sleep(self.hold)
        return super().verify_host(pks, msgs, sigs, rng)


@pytest.mark.parametrize("decode_workers", [0, 2])
def test_window_waits_for_a_busy_device_lane(decode_workers):
    """Windows whose time is up while the lane runs a flush stay open
    until it is free: three submissions spaced wider than the window,
    all made while the first flush holds the lane, ride ONE second flush
    (the JAX package would queue one flush each)."""
    stats: list = []
    plane = SlowPlane(T, hold=0.4)
    coal = coalescer(plane, window=0.01, window_max=0.01, stats_hook=stats.append, decode_workers=decode_workers)
    items = _sig_items(4)

    async def main():
        first = asyncio.create_task(coal.verify(items[:1]))
        await asyncio.sleep(0.1)  # the first flush holds the lane
        later = []
        for item in items[1:]:
            later.append(asyncio.create_task(coal.verify([item])))
            await asyncio.sleep(0.05)  # wider than the window
        return await asyncio.gather(first, *later)

    assert asyncio.run(main()) == [[True]] * 4
    coal.close()
    assert coal.flushes == 2 and plane.verify_calls == 2
    assert coal.held_flushes == 1
    assert [(st.jobs, st.lanes, st.inflight) for st in stats] == [(1, 1, 1), (3, 3, 1)]


def test_deadline_pulls_flush_earlier():
    plane = coalescer(FakePlane(T), window=5.0, window_min=0.001)
    items = _sig_items(1)

    async def main():
        t0 = time.monotonic()
        await plane.verify(items, deadline=time.time() + 0.05)
        return time.monotonic() - t0

    elapsed = asyncio.run(main())
    plane.close()
    assert elapsed < 2.0, f"deadline ignored: flush took {elapsed:.2f}s"


def test_late_tighter_deadline_rearms_armed_flush():
    fake = FakePlane(T)
    plane = coalescer(fake, window=5.0, window_min=0.001)
    items = _sig_items(1)

    async def main():
        t0 = time.monotonic()
        slow = asyncio.create_task(plane.verify(items))
        await asyncio.sleep(0.05)
        fast = asyncio.create_task(plane.verify(items, deadline=time.time() + 0.05))
        await asyncio.gather(slow, fast)
        return time.monotonic() - t0

    elapsed = asyncio.run(main())
    plane.close()
    assert elapsed < 2.0 and fake.verify_calls == 1


def test_clock_step_does_not_collapse_armed_window():
    """The wall -> monotonic offset is snapshotted once a window, so a host
    clock step between two submissions of one window neither shrinks nor
    stretches the armed flush."""
    from charon_tpu_torch.testutil.chaos import SkewedClock

    coal = coalescer(FakePlane(T), window=0.5, window_min=0.001)

    async def main():
        with SkewedClock() as clock:
            deadline = time.time() + 30.0
            coal._arm(deadline)
            armed_at, queue_deadline = coal._flush_at, coal._queue_deadline
            clock.step(3600.0)
            coal._arm(deadline)
            assert (coal._queue_deadline, coal._flush_at) == (queue_deadline, armed_at)
            clock.step(-7200.0)
            coal._arm(deadline)
            assert (coal._queue_deadline, coal._flush_at) == (queue_deadline, armed_at)
        coal._flush_task.cancel()

    asyncio.run(main())
    coal.close()


# -- test_hostplane.py: packed flush, stats, hooks ------------------------------------


def test_packed_flush_path_and_stats():
    fake = PackedFakePlane(T)
    stats: list[FlushStats] = []
    plane = coalescer(fake, window=0.01, decode_workers=2, stats_hook=stats.append)
    items = _sig_items(3)

    async def main():
        return await asyncio.gather(plane.verify(items), plane.verify(items[:1]))

    r1, r2 = asyncio.run(main())
    plane.close()
    assert r1 == [True] * 3 and r2 == [True]
    assert fake.packed_calls == 1 and fake.pack_calls == 1 and fake.verify_calls == 1
    [s] = stats
    assert (s.jobs, s.lanes, s.padded_lanes, s.pad_lanes) == (2, 4, 4, 0)
    assert s.decode_queue_seconds and s.pack_span and s.device_span and not s.fallback
    assert (s.decode_mode, s.decode_cache_lanes, s.decode_python_lanes) == ("python", 8, 4)
    assert plane.coalesced_flushes == 1 and plane.lanes_flushed == 4


def test_pack_failure_fails_the_waiters_without_a_single_stage_repack():
    """A pack error is a flush failure: no silent re-pack on the device
    lane."""

    class BadPack(PackedFakePlane):
        def pack_verify_inputs(self, pks, msgs, sigs):
            raise ValueError("pack bug")

    fake = BadPack(T)
    plane = coalescer(fake, window=0.01, decode_workers=2)
    with pytest.raises(TblsError, match="ValueError: pack bug"):
        asyncio.run(plane.verify(_sig_items(1)))
    plane.close()
    assert fake.verify_calls == 0 and plane.failed_flushes == 1 and plane.flushes == 0


def test_close_racing_flush_fails_waiters():
    plane = coalescer(FakePlane(T), window=0.05, decode_workers=0)
    items = _sig_items(1)

    async def main():
        task = asyncio.create_task(plane.verify(items))
        await asyncio.sleep(0)
        plane.close()
        with pytest.raises(TblsError, match="closed"):
            await task

    asyncio.run(main())
    assert MSM.msm_active() and plane.failed_flushes == 0


def test_legacy_metrics_hook_still_fires():
    seen = []
    plane = coalescer(FakePlane(T), window=0.01, metrics_hook=lambda j, n: seen.append((j, n)))
    asyncio.run(plane.verify(_sig_items(2)))
    plane.close()
    assert seen == [(1, 2)]


def test_flush_stats_carry_tenant_lanes_and_submit_ctx():
    from charon_tpu.core.cryptosvc import CryptoPlaneService, TenantQuota

    stats: list = []
    coal = coalescer(FakePlane(T), window=0.01, stats_hook=stats.append, submit_ctx=lambda: ("trace", "span"))
    svc = CryptoPlaneService(coal, round_interval=0.001)
    a = svc.register("tenant-a", TenantQuota())
    b = svc.register("tenant-b", TenantQuota())

    async def main():
        items = _sig_items(2)
        await asyncio.gather(a.verify(items), b.verify(items[:1]))

    asyncio.run(main())
    svc.close()
    coal.close()
    per: dict[str, int] = {}
    for s in stats:
        for tenant, lanes in s.tenant_lanes:
            per[tenant] = per.get(tenant, 0) + lanes
        assert set(s.parents) == {("trace", "span")}
    assert per == {"tenant-a": 2, "tenant-b": 1}


def test_point_caches_of_the_impl_serve_the_coalescer_decode():
    """The decode pool reads impl's pubkey cache: a second submission of
    the same pubkey never re-decodes."""
    calls = []
    impl = TorchImpl(device="cpu")
    impl.pubkey_points = PointCache(lambda b: calls.append(b) or _decode_pubkey_point(b), 16)
    items = _sig_items(2, distinct_roots=False)
    plane = SlotCoalescer(FakePlane(T), window=0.01, decode_workers=2, impl=impl)
    assert asyncio.run(plane.verify(items)) == [True, True]
    assert asyncio.run(plane.verify(items)) == [True, True]
    plane.close()
    assert len(calls) == 1


# -- test_hostplane.py: the device decode ------------------------------------------


def test_decode_mode_device_routes_parsed_lanes():
    stats = []
    plane = PortParsedFakePlane(T)
    coal = coalescer(plane, window=0.01, decode_workers=0, decode_mode="device", stats_hook=stats.append)
    items = _sig_items(3)
    items.append((items[0][0], b"\x01" * 32, b"\x00" * 96))
    try:
        assert asyncio.run(coal.verify(items)) == [True, True, True, False]
    finally:
        coal.close()
    assert plane.parsed_verify_calls == 1 and plane.verify_calls == 0
    assert (stats[-1].decode_mode, stats[-1].decode_device_lanes, stats[-1].decode_python_lanes) == ("device", 3, 0)


def test_decode_mode_auto_is_python_off_the_card():
    assert coalescer(PortParsedFakePlane(T))._decode_rung() == "python"
    fake = PortParsedFakePlane(T)
    fake.device = torch.device("cuda", 0)
    assert coalescer(fake)._decode_rung() == "device"


def test_parsed_flush_failure_fails_the_waiters_and_keeps_the_device_decode():
    """A device failure in a parsed flush is not a decode step-down: its
    waiters get TblsError, the decode mode stays device, and the next
    parsed flush runs."""
    plane = PortParsedFakePlane(T, fail_parsed=1)
    coal = coalescer(plane, window=0.01, decode_workers=0, decode_mode="device")
    items = _sig_items(2)
    try:
        with pytest.raises(TblsError, match="injected parsed-kernel failure") as err:
            asyncio.run(coal.verify(items))
        assert isinstance(err.value.__cause__, RuntimeError)
        assert coal._decode_live == "device" and plane.verify_calls == 0
        assert asyncio.run(coal.verify(items)) == [True, True]
        assert plane.parsed_verify_calls == 2 and plane.verify_calls == 0
        assert coal.failed_flushes == 1 and coal.flushes == 1 and MSM.msm_active()
    finally:
        coal.close()


def test_decode_breakdown_mode_falls_back_to_live_rung():
    coal = coalescer(PortParsedFakePlane(T), window=0.01, decode_workers=0, decode_mode="device")
    try:
        coal._decode_live = "device"
        job = _VerifyJob(lanes=[None, None], fut=None)
        assert coal._decode_breakdown([job], []) == ("device", 0, 0, 0)
    finally:
        coal.close()


def test_coalescer_prewarm_reports_bucket_shapes(monkeypatch):
    """SlotCoalescer.prewarm runs the canonical duty shapes through the
    plane on the device lane, one per bucket, both tiers (the field work
    faked)."""
    from charon_tpu_torch.ops import blsops
    from charon_tpu_torch.ops import pairing as DP
    from charon_tpu_torch.ops.curve import map_point
    from charon_tpu_torch.parallel import SlotCryptoPlane, make_mesh

    monkeypatch.setattr(blsops, "threshold_recombine", lambda ctx, fr_ctx, t, sig, idx: map_point(lambda a: a[:, 0], sig))
    monkeypatch.setattr(MSM, "msm_active", lambda: False)
    monkeypatch.setattr(DP, "batched_verify_rlc", lambda *a: torch.tensor(True))
    monkeypatch.setattr(DP, "batched_verify", lambda ctx, pk, msg, sig: torch.ones(pk[0].shape[0], dtype=torch.bool))
    plane = SlotCryptoPlane(make_mesh(["cpu"] * 8), t=T)
    coal = coalescer(plane, window=0.01)
    report = asyncio.run(coal.prewarm(verify_lanes=(4, 8, 17), recombine_lanes=(4,)))
    coal.close()
    assert plane.bucket_lanes(4) == plane.bucket_lanes(8) == 8  # one shape
    assert [(k, n) for k, n, _ in report] == [("verify", 8), ("verify", 32), ("recombine", 8)]
    assert plane.PREWARM_VERIFY_LANES[0] == 1
    assert plane.jit_cache_size() == 6  # both tiers of every shape
    bare = coalescer(FakePlane(T), window=0.01)
    assert asyncio.run(bare.prewarm()) == []
    bare.close()


def test_tuner_prewarm_ladder_matches_the_plane_buckets():
    from charon_tpu_torch.core import autotune
    from charon_tpu_torch.ops import blsops
    from charon_tpu_torch.parallel import SlotCryptoPlane

    assert {blsops.bucket_lanes(n) for n in SlotCryptoPlane.PREWARM_VERIFY_LANES} == set(autotune.PREWARM_LANES)


# -- test_hostplane.py: bulk cache warm-up ------------------------------------------


def test_warm_point_caches_device_engine_inserts_only_valid():
    """With an engine passed in, the bulk results feed the caches; lanes
    the engine masks invalid are not inserted, and chunking splits."""
    from charon_tpu_torch.tbls.torch_impl import warm_point_caches

    impl = TorchImpl(device="cpu")
    calls = []

    class FakeEngine:
        def decompress_g1_batch(self, batch, subgroup_check=True):
            calls.append(("g1", list(batch)))
            return [f"pt-{b.hex()[:4]}" for b in batch], [b[0] != 0xFF for b in batch]

        def hash_to_g2_batch(self, batch):
            calls.append(("h2c", list(batch)))
            return [f"h2c-{b.hex()[:4]}" for b in batch], [True] * len(batch)

    keys = [bytes([i]) * 48 for i in (1, 2, 0xFF)]
    msgs = [bytes([i]) * 32 for i in (5, 6, 7)]
    stats = warm_point_caches(impl, keys, msgs, engine=FakeEngine(), device=True, chunk=2)
    assert stats["pubkey"] == {"device": 2, "python": 0, "cached": 0, "invalid": 1}
    assert stats["message"]["device"] == 3
    assert [kind for kind, _ in calls] == ["g1", "g1", "h2c", "h2c"]
    assert keys[0] in impl.pubkey_points and keys[2] not in impl.pubkey_points
    assert all(m in impl.msg_points for m in msgs)


def test_warm_caches_device_rung_rotation_rewarm():
    from charon_tpu.app.metrics import ClusterMetrics
    from charon_tpu.crypto import h2c

    pk = _sig_items(1)[0][0]
    plane = PortWarmFakePlane(T)
    metrics = ClusterMetrics("0xhash", "c", "node0")
    coal = coalescer(plane, window=0.01, decode_workers=0, decode_mode="device")
    coal.warmup_hook = metrics.observe_warmup
    try:
        stats = asyncio.run(coal.warm_caches(pubkeys=[pk], messages=[b"slot-root-1"]))
        assert stats["pubkey"]["device"] == 1 and stats["message"]["device"] == 1
        assert pk in coal.impl.pubkey_points
        assert coal.impl.msg_points(b"slot-root-1") == h2c.hash_to_g2(b"slot-root-1")
        assert plane.warm_calls and all(name.startswith("crypto-warmup") for _, _, name in plane.warm_calls)
        stats2 = asyncio.run(coal.warm_caches(pubkeys=[pk], messages=[b"slot-root-1", b"slot-root-2"]))
        assert stats2["pubkey"] == {"device": 0, "python": 0, "cached": 1, "invalid": 0}
        assert stats2["message"]["device"] == 1 and stats2["message"]["cached"] == 1
        assert coal.warmups == 2 and coal.warmup_lanes == 3
    finally:
        coal.close()
    out = metrics.render().decode()
    assert 'tpu_point_cache_warmup_lanes_total{cache="pubkey"' in out
    assert 'source="device"' in out and 'source="cached"' in out


def test_warm_caches_does_not_serialize_behind_live_flush():
    items = _sig_items(2)
    plane = PortWarmFakePlane(T, verify_sleep=0.8)
    coal = coalescer(plane, window=0.01, decode_workers=0, decode_mode="device")

    async def main():
        flush = asyncio.create_task(coal.verify(items))
        await asyncio.get_running_loop().run_in_executor(None, plane.flush_started.wait, 5.0)
        t0 = time.monotonic()
        stats = await coal.warm_caches(messages=[b"rotation-root"])
        warm_elapsed = time.monotonic() - t0
        assert not flush.done(), "device flush finished before warm-up?"
        return stats, warm_elapsed, await flush

    try:
        stats, warm_elapsed, res = asyncio.run(main())
    finally:
        coal.close()
    assert res == [True, True] and stats["message"]["device"] == 1
    assert warm_elapsed < 0.6, f"warm-up serialized behind the live flush ({warm_elapsed:.2f}s)"


def test_warm_caches_python_rung_when_plane_lacks_warm_api():
    coal = coalescer(PortParsedFakePlane(T), window=0.01, decode_workers=0, decode_mode="device")
    try:
        stats = asyncio.run(coal.warm_caches(messages=[b"cold-root"]))
    finally:
        coal.close()
    assert stats["message"]["python"] == 1 and stats["message"]["device"] == 0


def test_node_rewarm_hook_routes_to_plane():
    """The JAX package's Node.rewarm_point_caches rides this coalescer's
    warm-up when it is installed as the node's crypto plane."""
    from charon_tpu.app.metrics import ClusterMetrics
    from charon_tpu.app.run import Node

    plane = PortWarmFakePlane(T)
    coal = coalescer(plane, window=0.01, decode_workers=0, decode_mode="device")
    node = Node(
        config=None, lock=None, life=None, scheduler=None, vapi=None, vapi_router=None, p2p=None, bcast=None,
        tracker=None, metrics=ClusterMetrics("0x", "c", "n0"), beacon=None, crypto_plane=coal,
    )
    try:
        stats = asyncio.run(node.rewarm_point_caches(messages=[b"rot"]))
    finally:
        coal.close()
    assert stats["message"]["device"] == 1
    assert [k for k, _, _ in plane.warm_calls] == ["h2c"]


# -- the CPU torch plane --------------------------------------------------------------


def test_two_duties_and_a_verify_burst_coalesce_on_the_cpu_torch_plane():
    """Two recombine duties and a verify submission, concurrent, run as ONE
    flush of the real plane: one step_rlc and one verify_rlc dispatch, the
    group signatures equal to the oracle's bytes."""
    from meshwork import make_workload

    from charon_tpu.crypto import g1g2, shamir
    from charon_tpu_torch.parallel import SlotCryptoPlane, make_mesh

    ps, _, parts, gpks, idx = make_workload(4, T)
    roots = [b"mesh-duty-%d" % v for v in range(4)]
    ps_b = [[g1g2.g1_to_bytes(p) for p in row] for row in ps]
    parts_b = [[g1g2.g2_to_bytes(s) for s in row] for row in parts]
    gpks_b = [g1g2.g1_to_bytes(p) for p in gpks]
    want = [g1g2.g2_to_bytes(shamir.threshold_aggregate_g2(dict(zip(idx[v], parts[v])))) for v in range(4)]
    plane = SlotCryptoPlane(make_mesh(["cpu"]), t=T)
    fams: list = []
    plane.on_program = lambda fam, seconds, lanes: fams.append((fam, lanes))
    stats: list = []
    coal = coalescer(plane, window=0.05, stats_hook=stats.append)

    def duty(lo, hi):
        return coal.recombine(ps_b[lo:hi], roots[lo:hi], parts_b[lo:hi], gpks_b[lo:hi], idx[lo:hi])

    async def main():
        return await asyncio.gather(
            duty(0, 2), duty(2, 4), coal.verify([(ps_b[v][0], roots[v], parts_b[v][0]) for v in range(3)])
        )

    try:
        (s1, ok1), (s2, ok2), vok = asyncio.run(main())
    finally:
        coal.close()
    assert ok1 + ok2 == [True] * 4 and vok == [True] * 3
    assert s1 + s2 == want
    assert coal.flushes == 1 and coal.coalesced_flushes == 1
    assert sorted(fams) == [("mesh/step_rlc", 4), ("mesh/verify_rlc", 3)]
    [s] = stats
    assert (s.jobs, s.lanes, s.padded_lanes, s.pad_lanes, s.decode_mode) == (3, 7, 8, 1, "python")
