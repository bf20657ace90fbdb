"""The metrics' arithmetic: slot_s over a window with a stall (whole slots,
the one in flight when the clock passes finished and counted, the ring
running out), a roofline share against a hand-worked kernel, and the
idle share's union of device intervals."""

import asyncio
import time

import pytest

from portbench import peaks, spec, system, trace


class _Kernels:
    LAUNCHES = {"fp2_mul": 0}

    def reset_launches(self):
        self.LAUNCHES["fp2_mul"] = 0


class _Stats:
    def __init__(self, pack):
        self.pack_span = (0.0, pack)


def fake_program(sleeps: list):
    """A Program whose slots sleep the given seconds, each a flush with a
    0.5 s pack span, 10 launches and one 0.25 s program."""
    prog = system.Program.__new__(system.Program)
    prog.cuda = False
    prog.kernels = _Kernels()
    prog.flushes, prog.programs = [], []
    it = iter(sleeps)

    async def slot(subs):
        await asyncio.sleep(next(it))
        prog.flushes.append(_Stats(0.5))
        prog.programs.append(("mesh/verify_rlc_dec", 0.25, 8, time.time_ns()))
        prog.kernels.LAUNCHES["fp2_mul"] += 10
        return [subs]

    prog._slot = slot
    return prog


def record_of(win):
    return {"setup_s": 1.0, "boot_s": 0.5, "trace": None,
            "window": {"slots": len(win["walls"]), **{k: win[k] for k in ("seconds", "flushes", "pack_s", "programs_s", "launches")}}}


def test_slot_s_over_a_window_with_a_stall():
    # the window is 0.25 s; the second slot stalls past it and is finished and counted
    prog = fake_program([0.05, 0.4, 0.05, 0.05])
    win = prog.window(iter(range(4)), 0.25)
    assert len(win["walls"]) == 2 and not win["ran_out"]
    assert win["walls"][1] >= 0.4 and win["seconds"] >= sum(win["walls"])
    rec = record_of(win)
    assert spec.reader("slot_s")(rec) == pytest.approx(win["seconds"] / 2)
    assert spec.reader("coalescer.slot_s")(rec) == spec.reader("slot_s")(rec)
    assert win["seconds"] / 2 > 0.225
    assert spec.reader("coalescer.flushes_per_slot")(rec) == 1
    assert spec.reader("coalescer.pack_s")(rec) == pytest.approx(0.5)
    assert spec.reader("plane.programs_s")(rec) == pytest.approx(0.25)
    assert spec.reader("kernels.launches_per_slot")(rec) == 10


def test_the_window_reports_a_ring_that_runs_out():
    prog = fake_program([0.01, 0.01])
    win = prog.window(iter(range(2)), 10.0)
    assert win["ran_out"] and len(win["walls"]) == 2


def test_roofline_against_a_hand_worked_kernel():
    # fp2_mul at 4,096 rows: 6 operands of 16 int64 limbs, read or written
    # once, 3,145,728 bytes over 3.35e12 B/s = 0.939 us; its 1,800 int32
    # operations a row, 7,372,800 over 33.5e12 op/s = 0.220 us: bound by bytes
    assert peaks.bound_s("fp2_mul", 4096) == pytest.approx(3_145_728 / 3.35e12)
    assert peaks.bound_s("mont_mul_fp", 1) == pytest.approx(max(3 * 16 * 8 / 3.35e12, 2 * 300 / 33.5e12))
    t = {"classes": {"fp2_mul": {"count": 10, "device_s": 10 * 4e-6}},
         "launches": {"fp2_mul": 10}, "rows": {"fp2_mul": {4096: 10}}}
    assert trace.roofline(t, "fp2_mul") == pytest.approx(100 * (3_145_728 / 3.35e12) / 4e-6)  # 23.48 %
    # a trace that dropped half the launches gives half the time: the bound is halved too
    t["classes"]["fp2_mul"] = {"count": 5, "device_s": 5 * 4e-6}
    assert trace.roofline(t, "fp2_mul") == pytest.approx(100 * (3_145_728 / 3.35e12) / 4e-6)
    assert spec.reader("fp2_mul_roofline")({"trace": t}) == pytest.approx(23.4756, rel=1e-4)
    assert spec.reader("fp2_sqr_roofline")({"trace": {**t, "classes": {"fp2_sqr": {"count": 0, "device_s": 0}}}}) is None
    assert spec.reader("mont_mul_roofline")({"trace": None}) is None


def test_kernel_classes_by_trace_name():
    assert trace.kernel_class("void fp2_mul_kernel(TilePtrs<4, 2>, long, Modulus)") == "fp2_mul"
    assert trace.kernel_class("void mont_mul_kernel<12, 32>(TilePtrs<2, 1>, long, Modulus)") == "mont_mul"
    assert trace.kernel_class("void mont_mul_warp_kernel<11>(...)") == "mont_mul"
    assert trace.kernel_class("void fp2_mul_mxu_kernel(...)") is None
    assert trace.kernel_class("elementwise_kernel") is None


def test_idle_share_of_overlapping_intervals():
    assert trace._union([20, 0, 5, 21], [30, 10, 15, 22]) == 25
    assert trace._union([], []) == 0
    rec = {"trace": {"busy_s": 0.25, "window_s": 2.0}}
    assert spec.reader("device.idle_share")(rec) == pytest.approx(87.5)
    assert spec.reader("device.idle_share")({"trace": None}) is None
    assert spec.reader("verify_device_s")(rec) == 0.25
    # a trace with no device events (the CPU) leaves the metric out, never 0
    assert spec.reader("verify_device_s")({"trace": {"busy_s": 0.0, "window_s": 2.0}}) is None
    assert spec.reader("verify_device_s")({"trace": None}) is None


class _Event:
    def __init__(self, name, start, dur, device):
        self._n, self._s, self._d, self._dev = name, start, dur, device

    def device_type(self):
        return self._dev

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def test_summarize_cuts_the_trace_to_the_span():
    from torch.autograd import DeviceType

    t0 = 1_700_000_000_000_000_000  # wall-clock ns
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [
        _Event("void fp2_mul_kernel(TilePtrs<4, 2>, long, Modulus)", t0 + 100, 50, cuda),
        _Event("elementwise_add", t0 + 120, 60, cuda),  # overlaps the one before
        _Event("cudaLaunchKernel", t0 + 90, 5, cpu),  # a host event: not device time
        _Event("void mont_mul_kernel<12, 32>(...)", t0 + 950, 100, cuda),  # runs past the span's end
        _Event("void fp2_sqr_kernel(...)", t0 + 1_200, 10, cuda),  # after the span: left out
    ]

    class Results:
        def events(self):
            return events

        def trace_start_ns(self):
            return t0

    class Prof:
        pass

    prof = Prof()
    prof.profiler = Prof()
    prof.profiler.kineto_results = Results()
    traced = {"prof": prof, "start_ns": t0, "end_ns": t0 + 1_000,
              "programs": [("mesh/verify_rlc_dec", 500e-9, 8, t0 + 1_000)],
              "launches": {"fp2_mul": 1, "mont_mul_fp": 1}, "rows": {"fp2_mul": {64: 1}, "mont_mul_fp": {64: 1}}}
    s = trace.summarize(traced)
    assert s["events"] == 3 and s["window_s"] == pytest.approx(1e-6)
    assert s["busy_s"] == pytest.approx((80 + 50) * 1e-9)  # [100, 180) and [950, 1000)
    assert s["classes"]["fp2_mul"] == {"count": 1, "device_s": pytest.approx(50e-9)}
    assert s["classes"]["mont_mul"] == {"count": 1, "device_s": pytest.approx(50e-9)}
    assert s["classes"]["fp2_sqr"] == {"count": 0, "device_s": 0.0}
    idle = dict(s["idle_gaps"])
    assert idle["mesh/verify_rlc_dec"] == pytest.approx((500 - 50) * 1e-9)
    assert idle["outside programs"] == pytest.approx((500 - 80) * 1e-9)
    assert spec.reader("device.idle_share")({"trace": s}) == pytest.approx(100 * (1 - 130 / 1000))
    assert spec.reader("verify_device_s")({"trace": s}) == pytest.approx(130e-9)
