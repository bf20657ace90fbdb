"""PyTorch port: the slot plane's shards run at once
(charon_tpu_torch/parallel/mesh.py), make_mesh_2d, and launch counts that
stay exact under threads (charon_tpu_torch/ops/mont_kernels.py).

A program on two or more shards runs each shard's slice on a thread of its
own (on a card, on a stream of its own too). The stub-body cases pin the
contract: every shard's body runs at the same time (a barrier that only
opens when all of them wait at it), outputs gather in shard order, counts
sum, verdicts AND, each worker runs under inference mode, the
lowest-numbered shard's error reaches the caller after every shard has
ended, and no thread outlives the plane; on a card the threads take
turns at the host, passed on after a kernel launch. make_mesh_2d is held against the
JAX package's make_mesh_2d (layout, error, and the count reduction against
a shard_map psum over the reference's mesh). One crypto case runs the
decode-fused verify programs on a 2 x 2 CPU mesh against the host oracles;
the reference's 2 x 4 layout test is rebound at its own shape, marked slow.
Tolerance: exact (points, verdicts, counts).
"""

from __future__ import annotations

import gc
import random
import threading
import time

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P
from meshwork import make_workload
from test_torch_geometry import _FakeTensor, fake_card  # noqa: F401
from test_torch_plane import BAD, WL, T
from test_torch_plane_dec import OFF_SUBGROUP, parse

from charon_tpu.crypto import bls, g1g2
from charon_tpu.parallel import mesh as JM
from charon_tpu_torch.ops import mont_kernels as MK
from charon_tpu_torch.parallel import SlotCryptoPlane, make_mesh, make_mesh_2d
from charon_tpu_torch.parallel import mesh as M

torch.set_num_threads(1)  # tiny tensors: more intra-op threads only spin

try:  # jax >= 0.4.35 top-level spelling
    _shard_map = jax.shard_map
except AttributeError:  # older jax: experimental namespace
    from jax.experimental.shard_map import shard_map as _shard_map


def _plane(shards: int) -> SlotCryptoPlane:
    return SlotCryptoPlane(make_mesh(["cpu"] * shards), t=T)


def _shard_threads() -> list[str]:
    return [t.name for t in threading.enumerate() if t.name.startswith("plane-shard")]


# -- _program on stub bodies -------------------------------------------------------


@pytest.mark.parametrize("shards", [2, 4])
def test_every_shard_body_runs_at_once(shards):
    """A barrier of `shards` parties inside the body opens only if every
    shard's body waits at it at the same time; each runs on its own
    thread."""
    pl = _plane(shards)
    barrier = threading.Barrier(shards, timeout=30)
    names = []

    def body(x):
        barrier.wait()
        names.append(threading.current_thread().name)
        return (x + 1,)

    run = pl._program("stub", body, ("cat",))
    assert torch.equal(run(torch.arange(2 * shards)), torch.arange(1, 2 * shards + 1))
    assert len(set(names)) == shards and threading.current_thread().name not in names
    pl.close()


def _mixed_body(x, live):
    """Per shard: x squared (gathered), its live count (summed) and whether
    every lane is live (ANDed)."""
    return x * x, live.sum(), live.all()


@pytest.mark.parametrize("mesh", [["cpu"] * 2, ["cpu"] * 4, "2x2"])
def test_outputs_gather_in_shard_order_count_sums_all_ands(mesh):
    """The concurrent results equal the shards run one after another and
    the one-shard plane's: cat in shard order, count summed (within each
    host first on a 2-D layout), all ANDed."""
    pl = SlotCryptoPlane(make_mesh_2d(2, ["cpu"] * 4) if mesh == "2x2" else make_mesh(mesh), t=T)
    one = _plane(1)
    x = torch.arange(16)
    for live in (torch.ones(16, dtype=torch.bool), torch.arange(16) % 5 != 3):
        got = pl._program("stub", _mixed_body, ("cat", "count", "all"))(x, live)
        want = one._program("stub", _mixed_body, ("cat", "count", "all"))(x, live)
        per = 16 // pl.shard_count()
        in_turn = [_mixed_body(x[k * per : (k + 1) * per], live[k * per : (k + 1) * per]) for k in range(pl.shard_count())]
        assert torch.equal(got[0], want[0]) and torch.equal(got[0], torch.cat([o[0] for o in in_turn]))
        assert got[1] == want[1] == sum(int(o[1]) for o in in_turn) == int(live.sum())
        assert got[2] is want[2] is all(bool(o[2]) for o in in_turn)
    pl.close()


def test_each_worker_runs_under_inference_mode():
    """Inference mode is thread-local: the plane turns it on in each shard's
    thread, not only in the caller's."""
    pl = _plane(3)
    seen = []

    def body(x):
        seen.append((threading.current_thread().name, torch.is_inference_mode_enabled()))
        return (x,)

    pl._program("stub", body, ("cat",))(torch.arange(3))
    assert len(seen) == 3 and all(mode for _, mode in seen)
    assert all(name.startswith("plane-shard") for name, _ in seen)
    pl.close()


def test_one_shard_runs_in_the_calling_thread():
    """A one-shard plane starts no thread: its body runs in the caller."""
    pl = _plane(1)
    seen = []
    pl._program("stub", lambda x: (seen.append(threading.current_thread()) or x,), ("cat",))(torch.arange(2))
    assert seen == [threading.current_thread()] and pl._shards is None


def test_lowest_shard_error_raised_after_every_shard_ended():
    """Shards 1 and 3 fail; the caller gets shard 1's error, and only once
    the slow shards 0 and 2 have ended. No in-turn rerun follows."""
    pl = _plane(4)
    ended, calls = [], []

    def body(x):
        k = int(x[0])
        calls.append(k)
        if k in (1, 3):
            raise RuntimeError(f"shard {k} failed")
        time.sleep(0.3)
        ended.append(k)
        return (x,)

    with pytest.raises(RuntimeError, match="shard 1 failed"):
        pl._program("stub", body, ("cat",))(torch.arange(4))
    assert sorted(ended) == [0, 2] and sorted(calls) == [0, 1, 2, 3]
    pl.close()


def test_two_programs_in_flight_keep_their_slices():
    """Two device threads share one plane (as the service's quarantine
    coalescer shares the shared one's): each program's shards see only its
    own slices and each caller gets its own answer."""
    pl = _plane(2)
    run = pl._program("stub", lambda x: (x * 10, x.sum()), ("cat", "count"))
    results = {}

    def caller(i):
        x = torch.arange(8) + 100 * i
        for _ in range(5):
            results.setdefault(i, []).append(run(x))

    threads = [threading.Thread(target=caller, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for i in range(2):
        x = torch.arange(8) + 100 * i
        assert all(torch.equal(c, x * 10) and n == int(x.sum()) for c, n in results[i])
    pl.close()


def test_no_thread_left_after_close_or_drop():
    """close() joins the shards' threads; dropping a plane ends them too."""
    assert _shard_threads() == []
    pl = _plane(3)
    pl._program("stub", lambda x: (x,), ("cat",))(torch.arange(3))
    assert len(_shard_threads()) == 3
    pl.close()
    assert _shard_threads() == []
    with pytest.raises(RuntimeError):
        pl._program("stub", lambda x: (x,), ("cat",))(torch.arange(3))
    pl = _plane(2)
    pl._program("stub", lambda x: (x,), ("cat",))(torch.arange(2))
    assert len(_shard_threads()) == 2
    del pl
    gc.collect()
    deadline = time.monotonic() + 10
    while _shard_threads() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert _shard_threads() == []


def test_on_shards_reports_each_shards_interval():
    """The per-shard timing hook gets one (start, end) interval a shard,
    from a common origin, and they overlap when the shards run at once."""
    pl = _plane(2)
    barrier = threading.Barrier(2, timeout=30)
    spans = []
    pl.on_shards = lambda fam, s: spans.append((fam, s))

    def body(x):
        barrier.wait()
        time.sleep(0.05)
        return (x,)

    pl._program("stub", body, ("cat",))(torch.arange(2))
    [(fam, [(s0, e0), (s1, e1)])] = spans
    assert fam == "mesh/stub" and min(s0, s1) == 0.0
    assert max(s0, s1) < min(e0, e1)  # overlap
    pl.close()


def test_turns_hand_the_host_round_robin():
    """On a card the shards' threads take turns at the host: one holds it
    at a time, it passes on (at a kernel launch) only after SLICE and only
    to a waiting thread, first come first served, and every thread gets
    through its work, the turns interleaved."""
    turns = M._Turns()
    turns.SLICE = 0.003
    state = {"inside": 0, "most": 0}
    lock = threading.Lock()
    trace = []

    def shard(k):
        turns.enter()
        try:
            for _ in range(20):
                with lock:
                    state["inside"] += 1
                    state["most"] = max(state["most"], state["inside"])
                    trace.append(k)
                time.sleep(0.001)
                with lock:
                    state["inside"] -= 1
                turns.pass_on()
        finally:
            turns.leave()

    threads = [threading.Thread(target=shard, args=(k,)) for k in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert state["most"] == 1 and sorted(trace) == sorted([0, 1, 2] * 20)
    switches = sum(a != b for a, b in zip(trace, trace[1:]))
    assert switches >= 6  # each thread held the host several times
    assert not turns._busy and not turns._waiting
    # alone, a thread never passes its turn
    turns.enter()
    since = turns._since
    time.sleep(0.005)
    turns.pass_on()
    assert turns._since == since
    turns.leave()


def test_a_launch_runs_its_threads_after_launch_hook(fake_card):
    """The shards pass their turn after a kernel launch: _launch runs the
    calling thread's AFTER_LAUNCH hook, and no other thread's."""
    calls = []
    MK.AFTER_LAUNCH.hook = lambda: calls.append(threading.current_thread().name)
    try:
        for _ in range(3):
            MK._launch("mont_mul.cu", "charon_mont_mul", MK.limb.FP, "mont_mul_fp", [_FakeTensor(4)] * 3)
        other = threading.Thread(
            target=MK._launch, args=("mont_mul.cu", "charon_mont_mul", MK.limb.FP, "mont_mul_fp", [_FakeTensor(4)] * 3)
        )
        other.start()
        other.join(timeout=60)
    finally:
        MK.AFTER_LAUNCH.hook = None
    assert calls == [threading.current_thread().name] * 3 and MK.LAUNCHES["mont_mul_fp"] == 4


# -- make_mesh_2d against the reference ------------------------------------------


@pytest.mark.parametrize("hosts", [1, 2, 4, 8])
def test_make_mesh_2d_row_order_matches_reference(hosts):
    """The devices row by row as `hosts` rows, as JM.make_mesh_2d lays out
    jax.devices() (the conftest's 8 CPU devices)."""
    ref = JM.make_mesh_2d(hosts, jax.devices())
    got = make_mesh_2d(hosts, [f"cpu:{d.id}" for d in jax.devices()])
    assert [[d.index for d in row] for row in got] == [[d.id for d in row] for row in ref.devices]
    plane = SlotCryptoPlane(got, t=T)
    assert plane.hosts == hosts and [d.index for d in plane.mesh] == [d.id for d in ref.devices.flat]


@pytest.mark.parametrize("hosts,devices", [(3, 8), (2, 1), (16, 8)])
def test_make_mesh_2d_error_matches_reference(hosts, devices):
    with pytest.raises(ValueError) as ref:
        JM.make_mesh_2d(hosts, jax.devices()[:devices])
    with pytest.raises(ValueError) as got:
        make_mesh_2d(hosts, ["cpu"] * devices)
    assert str(got.value) == str(ref.value) == f"{devices} devices do not split over {hosts} hosts"


def test_make_mesh_2d_count_reduction_matches_reference_psum():
    """A 2 x 2 layout's count (per shard, within each host, then over the
    hosts) equals a psum over both axes of the reference's 2-D mesh of the
    same per-lane flags."""
    live = torch.as_tensor([1, 0, 1, 1, 0, 0, 1, 1], dtype=torch.bool)
    ref_mesh = JM.make_mesh_2d(2, jax.devices()[:4])
    axes = tuple(ref_mesh.axis_names)
    psum = _shard_map(
        lambda x: jax.lax.psum(jnp.sum(x.astype(jnp.int32)), axes), mesh=ref_mesh, in_specs=P(axes), out_specs=P()
    )
    want = int(jax.jit(psum)(jnp.asarray(live.numpy())))
    pl = SlotCryptoPlane(make_mesh_2d(2, ["cpu"] * 4), t=T)
    got = pl._program("stub", lambda x: (x.sum(),), ("count",))(live)
    assert got == want == 5
    pl.close()


# -- launch counts under threads ---------------------------------------------------


@pytest.mark.parametrize("threads", [8, 16])
def test_launch_counts_stay_exact_from_eight_threads(fake_card, threads):
    """Eight threads launching at once (as eight shards do), and more
    threads than most test machines have cores, with the interpreter switching
    threads as often as it can, lose no count: LAUNCHES, ROWS and
    ALIGN_COPIES are updated under one lock."""
    import sys

    per_thread = 400
    barrier = threading.Barrier(threads, timeout=30)
    base = torch.arange(9 * 11, dtype=torch.int64).view(9, 11)

    def launch(i):
        barrier.wait()
        for j in range(per_thread):
            MK._launch("mont_mul.cu", "charon_mont_mul", MK.limb.FR, "mont_mul_fr", [_FakeTensor(1 + i % 2, 11)] * 3)
            MK._aligned("mont_mul_fr", [base[1:3]])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=launch, args=(i,)) for i in range(threads)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in workers)
    assert MK.LAUNCHES["mont_mul_fr"] == threads * per_thread
    assert MK.ROWS["mont_mul_fr"] == {1: threads // 2 * per_thread, 2: threads // 2 * per_thread}
    assert MK.ALIGN_COPIES["mont_mul_fr"] == threads * per_thread


# -- crypto on a 2 x 2 CPU mesh ------------------------------------------------------

MESSAGES = [b"mesh-duty-%d" % v for v in range(4)]  # tests/meshwork.py's duty messages


def _oracle(pk, v: int, sig: bytes) -> bool:
    """The host verdict: decode with the subgroup check, then verify."""
    try:
        point = g1g2.g2_from_bytes(sig)
    except ValueError:
        return False
    return bls.verify(pk, MESSAGES[v], point)


def test_verify_dec_forged_and_undecodable_on_a_2x2_mesh():
    """verify_rlc_dec then verify_dec at V = 4 on a 2 x 2 layout (one lane
    a shard): lane 1 forged, lane 2 on the curve but off the subgroup. The
    RLC program says False, the per-lane program attributes, and every
    verdict equals the host oracle's."""
    ps, msgs, parts, _, _ = WL
    pks = [ps[v][v % T] for v in range(4)]
    sigs = [g1g2.g2_to_bytes(parts[v][v % T]) for v in range(4)]
    sigs[1] = g1g2.g2_to_bytes(BAD)
    sigs[2] = OFF_SUBGROUP
    pl = SlotCryptoPlane(make_mesh_2d(2, ["cpu"] * 4), t=T)
    fams = []
    pl.on_program = lambda fam, seconds, lanes: fams.append((fam, lanes))
    arrays = pl.pack_verify_inputs_parsed(pks, msgs[:4], [parse(s) for s in sigs])
    oks = pl.verify_packed_parsed(arrays, pl.make_lane_rand(4, random.Random(19)), 4)
    assert fams == [("mesh/verify_rlc_dec", 4), ("mesh/verify_dec", 4)]
    assert oks == [_oracle(pks[v], v, sigs[v]) for v in range(4)] == [True, False, False, True]
    pl.close()


@pytest.mark.slow
def test_2d_mesh_dcn_ici_layout():
    """tests/test_mesh.py::test_2d_mesh_dcn_ici_layout rebound at its own
    shape: the slot step on a 2 hosts x 4 devices layout, V = 8, every lane
    valid and the count summed over both axes."""
    plane = SlotCryptoPlane(make_mesh_2d(2, ["cpu"] * 8), t=T)
    v = 8
    pubshares, msgs, partials, group_pks, indices = make_workload(v, T)
    group_sig, ok, total = plane.step_host(pubshares, msgs, partials, group_pks, indices)
    assert ok == [True] * v
    assert total == v
    plane.close()
