"""PyTorch port: the chaos harness (charon_tpu_torch/testutil/chaos.py), the
fault-injection gate (app/faultinject.py) and `build_cluster(chaos=)`,
held against the JAX package.

  * The JAX package's tests/test_chaos_scenarios.py, test_faultinject.py,
    test_clock_skew.py, test_cryptosvc_chaos.py, test_tracing_wire.py and
    test_p2p_aux.py run on the port's modules (`reference_cases`).
  * The port has no degrade ladder (tbls/resilient.py is not ported), so
    the reference's five ladder cases are inverted: the injected backend
    fault reaches the caller, and the tracker names the failed duty
    (`test_chaos_crypto_backend_loss`, the three
    `test_resilient_ladder_*` of test_faultinject and
    `test_resilient_ladder_demotes_exactly_once_under_thread_race`).
  * Every rebound case is bounded: its module's `asyncio.run` runs the
    case's coroutine under `asyncio.wait_for` (`CASE_LIMIT`, the kill case
    `KILL_LIMIT`), and the progress waits of test_chaos_scenarios and
    test_cryptosvc_chaos keep their rule (the deadline moves while the
    probe moves) under a hard total cap that ends the wait, with its
    probe, before that limit.
  * The reference's coalescer decodes on the host when it is given no
    device; the port's asks for the card. So a rebound case's
    SlotCoalescer built without `impl` gets a CPU TorchImpl's point caches
    (`_CpuCoalescer`); nothing else of the case changes.
  * Parity on the same seeds: `ChaosConfig.stream(label)` draws, the
    configs `config_from_spec` parses, `forged_signatures(n, rng)` bytes
    and the fault schedules of ChaosBeacon and FlakyBackend are equal in
    both packages.
  * Every case runs under the thread/task leak guard that
    tests/conftest.py applies to test_chaos_scenarios.py, built on the
    port's analysis/sanitizer.py (`leak_guard`).

Tolerance: exact (verdicts, bytes, draws, counters).
"""

from __future__ import annotations

import asyncio
import contextlib
import random
import re
import threading
import time
import types

import pytest
from test_torch_node_core import export_cases, port_globals, reference_cases, reference_modules  # noqa: F401

from charon_tpu.testutil import chaos as ref_chaos
from charon_tpu_torch import tbls as port_tbls
from charon_tpu_torch.analysis import sanitizer as port_sanitizer
from charon_tpu_torch.app import faultinject as port_faultinject
from charon_tpu_torch.core import cryptoplane as port_cryptoplane
from charon_tpu_torch.core.tracker import Step
from charon_tpu_torch.core.types import Duty, DutyType
from charon_tpu_torch.tbls import TblsError
from charon_tpu_torch.tbls.python_impl import PythonImpl
from charon_tpu_torch.tbls.torch_impl import TorchImpl
from charon_tpu_torch.testutil import chaos as port_chaos
from charon_tpu_torch.testutil.simnet import build_cluster

CASE_LIMIT = 150.0  # seconds: a rebound case's own asyncio.wait_for limit
KILL_LIMIT = 175.0  # the kill-mid-flush case's: three progress waits and teardown
WAIT_MARGIN = 20.0  # a capped progress wait ends this long before the case limit


# -- bounding the rebound cases ------------------------------------------------


class _BoundedAsyncio(types.ModuleType):
    """`asyncio` for a rebound module: `run` gives the case's coroutine
    its own wait_for limit and starts the clock the capped progress wait
    reads; everything else is asyncio's."""

    def __init__(self, limit: float) -> None:
        super().__init__("asyncio")
        self.limit = limit
        self.case_deadline = None

    def __getattr__(self, name):
        return getattr(asyncio, name)

    def run(self, coro, **kw):
        self.case_deadline = time.monotonic() + self.limit - WAIT_MARGIN
        try:
            return asyncio.run(asyncio.wait_for(coro, self.limit), **kw)
        finally:
            self.case_deadline = None


def _capped_wait_progress(module, bounded: _BoundedAsyncio):
    """The reference's `_wait_progress` rule (the deadline moves on while
    the probe changes) under a hard total cap: the case's deadline."""

    async def _wait_progress(predicate, probe, first_window=120.0, window=60.0):
        deadline = time.monotonic() + first_window
        cap = bounded.case_deadline if bounded.case_deadline is not None else deadline
        last = None
        while True:
            value = predicate()
            if value:
                return value
            snapshot = probe()
            if snapshot != last:
                last = snapshot
                deadline = time.monotonic() + window
            if time.monotonic() > min(deadline, cap):
                raise TimeoutError(f"{module.__name__}: no progress within the cap (probe={last})")
            await asyncio.sleep(0.05)

    return _wait_progress


class _CpuCoalescer(port_cryptoplane.SlotCoalescer):
    """The port's coalescer with a CPU TorchImpl's point caches when the
    caller gives no `impl` (the reference's decodes on the host)."""

    def __init__(self, plane, *args, impl=None, **kw):
        super().__init__(plane, *args, impl=impl if impl is not None else TorchImpl(device="cpu"), **kw)


def bounded(module: types.ModuleType, limit: float = CASE_LIMIT) -> types.ModuleType:
    """Bound a rebound module's cases: its `asyncio.run` under wait_for,
    its `_wait_progress` capped, its SlotCoalescer the CPU one."""
    bound = _BoundedAsyncio(limit)
    if "asyncio" in vars(module):
        module.asyncio = bound
    if "_wait_progress" in vars(module):
        module._wait_progress = _capped_wait_progress(module, bound)
    if "SlotCoalescer" in vars(module):
        module.SlotCoalescer = _CpuCoalescer
    return module


@pytest.fixture(autouse=True)
def cpu_coalescer(monkeypatch):
    """Cases that import SlotCoalescer inside a function get the CPU one."""
    monkeypatch.setattr(port_cryptoplane, "SlotCoalescer", _CpuCoalescer)


@pytest.fixture(autouse=True)
def port_fault_plane():
    """Restore the port's fault-injection plane (tests/conftest.py
    restores only the reference's)."""
    plane = port_faultinject._plane
    yield
    port_faultinject._plane = plane


@contextlib.contextmanager
def no_leaks():
    """Fail the enclosed test if it leaks a thread or an asyncio task past
    its loop (the guard tests/conftest.py applies to
    test_chaos_scenarios.py, on the port's sanitizer)."""
    before = port_sanitizer.thread_snapshot()
    watcher = port_sanitizer.TaskDestroyedWatcher().install()
    yield
    destroyed = watcher.uninstall()
    leaked = port_sanitizer.check_thread_leaks(before, grace=5.0)
    problems = []
    if leaked:
        problems.append(f"leaked thread(s): {leaked} — an executor/worker outlived the test")
    if destroyed:
        problems.append(f"{len(destroyed)} asyncio task(s) destroyed while pending: {destroyed[:3]}")
    if problems:
        pytest.fail("; ".join(problems))


@pytest.fixture(autouse=True)
def leak_guard():
    with no_leaks():
        yield


_LADDER_CASES = (
    "test_resilient_ladder_demotes_dead_primary",
    "test_resilient_ladder_never_retries_crypto_verdicts",
    "test_resilient_ladder_exhaustion_surfaces_the_fault",
)
SCENARIO_CASES = export_cases(
    bounded(reference_cases("test_chaos_scenarios")), globals(), skip=("test_chaos_crypto_backend_loss",)
)
FAULTINJECT_CASES = export_cases(
    bounded(reference_cases("test_faultinject", drop_imports=("charon_tpu_torch.tbls.resilient",))),
    globals(),
    skip=_LADDER_CASES,
)
CLOCK_SKEW_CASES = export_cases(
    bounded(reference_cases("test_clock_skew")),
    globals(),
    skip=("test_resilient_ladder_demotes_exactly_once_under_thread_race",),
)
# test_chaos_scenarios' autouse `host_tbls` (the port's NativeImpl in the
# port's registry) serves every case here; the two other files' twins of it
# stay unbound
CRYPTOSVC_CHAOS_CASES = export_cases(
    bounded(reference_cases("test_cryptosvc_chaos"), KILL_LIMIT), globals(), skip=("host_tbls",)
)
TRACING_WIRE_CASES = export_cases(bounded(reference_cases("test_tracing_wire")), globals(), skip=("host_tbls",))
P2P_AUX_CASES = export_cases(bounded(reference_cases("test_p2p_aux", test_modules=("test_p2p",))), globals())


def test_reference_cases_run_on_the_port():
    """Every rebound case runs on the port's modules and none of the
    reference's."""
    cases = (SCENARIO_CASES, FAULTINJECT_CASES, CLOCK_SKEW_CASES, CRYPTOSVC_CHAOS_CASES, TRACING_WIRE_CASES,
             P2P_AUX_CASES)
    assert [len([n for n in c if n.startswith("test_")]) for c in cases] == [10, 10, 7, 3, 6, 4]
    for names in cases:
        for name in names:
            if name.startswith("test_"):
                assert not reference_modules(globals()[name]), name


# -- the ladder cases, inverted: the fault reaches the caller ------------------

SEED = 20260803


def test_flaky_backend_raises_to_every_caller_and_the_registry_keeps_it():
    """test_resilient_ladder_demotes_dead_primary, inverted: there is no
    ladder, so a dead backend in the registry raises its RuntimeError to
    every caller, and stays the registry's backend (nothing demotes it)."""
    flaky = port_chaos.FlakyBackend(PythonImpl(), fail_after=0)
    port_tbls.set_implementation(flaky)
    for call in (
        lambda: port_tbls.generate_secret_key(),
        lambda: port_tbls.verify(b"\x00" * 48, b"m" * 32, b"\x00" * 96),
        lambda: port_tbls.sign(b"\x01" * 32, b"m" * 32),
    ):
        with pytest.raises(RuntimeError, match="crypto backend lost"):
            call()
    assert port_tbls.get_implementation() is flaky
    assert flaky.injected_failures == flaky.calls == 3


def test_flaky_backend_passes_crypto_verdicts_through():
    """test_resilient_ladder_never_retries_crypto_verdicts, inverted: a
    healthy FlakyBackend hands the inner backend's TblsError verdict to
    the caller unchanged and injects nothing."""
    flaky = port_chaos.FlakyBackend(PythonImpl())
    sk = flaky.generate_secret_key()
    pk = flaky.secret_to_public_key(sk)
    sig = flaky.sign(sk, b"a" * 32)
    flaky.verify(pk, b"a" * 32, sig)
    with pytest.raises(TblsError):
        flaky.verify(pk, b"b" * 32, sig)
    assert flaky.injected_failures == 0 and flaky.calls == 5


def test_flaky_backend_fault_is_not_a_tbls_verdict():
    """test_resilient_ladder_exhaustion_surfaces_the_fault, inverted: the
    injected fault is a RuntimeError, never a TblsError, so no caller can
    read it as a failed signature."""
    flaky = port_chaos.FlakyBackend(PythonImpl(), fail_after=0)
    with pytest.raises(RuntimeError, match="crypto backend lost") as info:
        flaky.generate_secret_key()
    assert not isinstance(info.value, TblsError)


def test_flaky_backend_counts_every_racing_failure_once():
    """test_resilient_ladder_demotes_exactly_once_under_thread_race,
    inverted: 8 executor threads racing a wedged backend each get the
    RuntimeError, and the backend stays in place."""

    class Ok:
        def verify_batch(self, items):
            return [True]

    flaky = port_chaos.FlakyBackend(Ok(), fail_after=0)
    port_tbls.set_implementation(flaky)
    barrier = threading.Barrier(8)
    errors, results = [], []

    def worker():
        barrier.wait()
        try:
            results.append(port_tbls.verify_batch([b"x"]))
        except RuntimeError as e:
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results == [] and len(errors) == 8
    assert all("crypto backend lost" in str(e) for e in errors)
    assert port_tbls.get_implementation() is flaky


def test_chaos_crypto_backend_loss_reaches_the_caller_and_the_tracker():
    """test_chaos_crypto_backend_loss, inverted: the process backend dies
    after set-up (every op raises). With no ladder no node signs, nothing
    is broadcast, each validator client's signing call raises the fault,
    and every node's tracker names the attester duty as failed at its
    first step that needs the signature."""
    port_tbls.set_implementation(PythonImpl())

    async def run():
        cluster = build_cluster(n=4, t=3, num_validators=1, slot_duration=0.4, chaos=port_chaos.ChaosConfig(seed=SEED))
        flaky = port_chaos.FlakyBackend(port_tbls.get_implementation(), fail_after=0, seed=SEED)
        port_tbls.set_implementation(flaky)
        raised: list[tuple[int, BaseException]] = []
        for node in cluster.nodes:
            attest = node.vmock.attest

            async def attest_and_record(slot, defs, _attest=attest):
                try:
                    return await _attest(slot, defs)
                except RuntimeError as e:
                    raised.append((slot, e))
                    raise

            node.vmock.attest = attest_and_record
        tasks = [asyncio.create_task(node.scheduler.run()) for node in cluster.nodes]
        try:
            t0 = time.monotonic()
            while len(raised) < 8 and time.monotonic() - t0 < 30.0:
                await asyncio.sleep(0.05)
        finally:
            for node in cluster.nodes:
                node.scheduler.stop()
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
        assert len(raised) >= 8 and all("crypto backend lost" in str(e) for _, e in raised)
        assert flaky.injected_failures >= len(raised)
        assert cluster.beacon.attestations == []
        duty = Duty(min(slot for slot, _ in raised), DutyType.ATTESTER)
        return [await node.tracker.duty_expired(duty) for node in cluster.nodes]

    reports = asyncio.run(asyncio.wait_for(run(), CASE_LIMIT))
    for report in reports:
        assert not report.success
        assert report.failed_step in (Step.PARSIG_DB_INTERNAL, Step.VALIDATOR_API), report.describe()


# -- parity: the same seeds give the same faults -------------------------------

PACKAGES = {"port": port_chaos, "ref": ref_chaos}


@pytest.mark.parametrize("seed", [0, 7, 20260803])
def test_chaos_streams_equal_in_both_packages(seed):
    labels = ("parsig", "qbft", "beacon", "crypto", "p2p", "proxy", "fuzz")
    draws = {
        name: [[cfg.stream(lbl).random() for _ in range(16)] for lbl in labels]
        for name, cfg in ((n, m.ChaosConfig(seed=seed)) for n, m in PACKAGES.items())
    }
    assert draws["port"] == draws["ref"]


@pytest.mark.parametrize(
    "spec",
    ["on", "1", "seed=42,drop=0.1,bn_error=0.2", "seed=9,crypto_fail_after=3,delay_max=0.25,bn_burst_max=5",
     "seed=3,corrupt=0.05,dup=0.1,reorder=0.2,partition_rate=0.0"],
)
def test_config_from_spec_equal_in_both_packages(spec):
    try:
        ref = ref_chaos.config_from_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            port_chaos.config_from_spec(spec)
        return
    port = port_chaos.config_from_spec(spec)
    assert vars(port) == vars(ref)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_forged_signatures_equal_bytes(seed):
    out = {name: m.forged_signatures(24, random.Random(seed)) for name, m in PACKAGES.items()}
    assert out["port"] == out["ref"]
    assert all(len(s) == 96 for s in out["port"])


def test_fault_schedules_equal_in_both_packages():
    """ChaosBeacon and FlakyBackend roll the same faults in the same order."""

    class FakeBeacon:
        async def attestation_data(self, slot, committee):
            return {"slot": slot}

    async def schedule(m):
        beacon = m.ChaosBeacon(FakeBeacon(), m.ChaosConfig(seed=11, bn_error=0.4, bn_burst_max=3, bn_timeout=0.1))
        out = []
        for i in range(60):
            try:
                await beacon.attestation_data(i, 0)
                out.append("ok")
            except (ConnectionError, TimeoutError, asyncio.TimeoutError) as e:
                out.append(type(e).__name__)
        return out

    def crypto(m):
        flaky = m.FlakyBackend(types.SimpleNamespace(ping=lambda: "pong"), m.ChaosConfig(seed=5, crypto_fail_rate=0.3))
        out = []
        for _ in range(60):
            try:
                out.append(flaky.ping())
            except RuntimeError:
                out.append("fault")
        return out

    got = {name: (asyncio.run(schedule(m)), crypto(m)) for name, m in PACKAGES.items()}
    assert got["port"] == got["ref"]
    assert "fault" in got["port"][1] and "ok" in got["port"][0]


def test_fault_injection_spec_builds_the_port_wrappers():
    """`faultinject.chaos_module()` is the port's chaos module, and an
    installed spec wraps a backend in the port's FlakyBackend."""
    assert port_faultinject.chaos_module() is port_chaos
    port_faultinject.install("seed=1,crypto_fail_after=0")
    wrapped = port_faultinject.maybe_wrap_tbls(PythonImpl())
    assert isinstance(wrapped, port_chaos.FlakyBackend)
    with pytest.raises(RuntimeError, match="crypto backend lost"):
        wrapped.generate_secret_key()
    port_faultinject.uninstall()
