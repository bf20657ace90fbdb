"""PyTorch port: the slot crypto plane (charon_tpu_torch/parallel/mesh.py)
on the CPU, held against the oracles charon_tpu.crypto.shamir and
charon_tpu.crypto.bls, at V = 4 validators, t = 3 (tests/meshwork.py).

This file: the plane's host API, `step_rlc` on one shard with corrupt
padding, `recombine_host` on a forged row (step_rlc rejects, `step`
attributes), the JAX package's entry-point cross-check on a two-shard plane,
and, marked slow, `step_rlc` and `step` against the JAX package's own
SlotCryptoPlane. The other programs and the other two-shard runs are in
test_torch_plane_*.py, which import the workload and helpers from here.
Tolerance: exact (points, verdicts, counts).
"""

from __future__ import annotations

import contextlib
import random
import threading

import pytest
import torch
from meshwork import make_workload

from charon_tpu.crypto import bls, shamir
from charon_tpu_torch.ops import blsops
from charon_tpu_torch.ops import curve as C
from charon_tpu_torch.ops import msm as MSM
from charon_tpu_torch.ops import pairing as DP
from charon_tpu_torch.parallel import SlotCryptoPlane, make_mesh
from charon_tpu_torch.parallel import mesh as M

torch.set_num_threads(1)  # tiny tensors: more intra-op threads only spin

T = 3
V = 3  # live validators of a padded batch: the bucket is 4 on 1 and 2 shards
WL = make_workload(4, T)  # (pubshares, msgs, partials, group_pks, indices)
BAD = bls.sign(bls.keygen(b"\x77" * 32), b"wrong message")  # a valid G2 point, wrong signer

_PLANES: dict = {}


def plane(shards: int) -> SlotCryptoPlane:
    if shards not in _PLANES:
        _PLANES[shards] = SlotCryptoPlane(make_mesh(["cpu"] * shards), t=T)
    return _PLANES[shards]


def rows(v: int = V, partials=None):
    ps, msgs, parts, gpks, idx = WL
    return ps[:v], msgs[:v], (partials or parts)[:v], gpks[:v], idx[:v]


def forged_partials():
    """Row 1's second partial replaced by a signature of another key."""
    parts = [list(r) for r in WL[2]]
    parts[1][1] = BAD
    return parts


def oracle_sigs(partials, v: int = V):
    return [shamir.threshold_aggregate_g2(dict(zip(WL[4][i], partials[i]))) for i in range(v)]


@contextlib.contextmanager
def recording(pl: SlotCryptoPlane, *programs: str):
    """Yield (families dispatched through on_program, {program: raw
    outputs}) while the block runs."""
    fams: list = []
    raw: dict = {p: [] for p in programs}
    saved = {p: getattr(pl, p) for p in programs}

    def capture(p):
        def run(*args):
            out = saved[p](*args)
            raw[p].append(out)
            return out

        return run

    for p in programs:
        setattr(pl, p, capture(p))
    pl.on_program = lambda fam, seconds, lanes: fams.append((fam, lanes))
    try:
        yield fams, raw
    finally:
        pl.on_program = None
        for p in programs:
            setattr(pl, p, saved[p])


_RUNS: dict = {}


def memo(key, fn):
    """Run fn once per test process: several tests read one plane run."""
    if key not in _RUNS:
        _RUNS[key] = fn()
    return _RUNS[key]


def forged_recombine(shards: int):
    """recombine_host on V rows with a forged partial in row 1: step_rlc
    says False, then `step` attributes. Returns (sigs, oks, families, raw
    step outputs)."""

    def run():
        pl = plane(shards)
        with recording(pl, "_step") as (fams, raw):
            sigs, oks = pl.recombine_host(*rows(partials=forged_partials()), rng=random.Random(5))
        return sigs, oks, fams, raw["_step"]

    return memo(("forged_recombine", shards), run)


# -- host API ---------------------------------------------------------------------


def test_make_mesh_default_is_the_card():
    if torch.cuda.is_available():
        assert make_mesh() == [torch.device("cuda:0")]
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
    assert make_mesh(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError):
        make_mesh([])


@pytest.mark.parametrize("shards", [1, 2, 8])
def test_bucket_lanes_split_evenly_over_shards(shards):
    pl = SlotCryptoPlane(make_mesh(["cpu"] * shards), t=T)
    assert pl.shard_count() == shards and pl.device == torch.device("cpu")
    for n in (1, 3, 4, 5, 17, 100, 257):
        b = pl.bucket_lanes(n)
        assert b == blsops.bucket_lanes(n, shards) and b >= n and b % shards == 0


def test_make_rand_is_raw_nonzero_64_bit_fr_limbs():
    pl = plane(1)
    rand = pl.make_rand(V, rng=random.Random(1))
    assert rand.shape == (4, T + 1, pl.fr_ctx.n_limbs) and rand.dtype == torch.int64
    vals = [int(sum(int(x) << (24 * i) for i, x in enumerate(row))) for row in rand.reshape(-1, pl.fr_ctx.n_limbs)]
    assert all(0 < v < 1 << 64 for v in vals) and len(set(vals)) == len(vals)
    lane = pl.make_lane_rand(5, rng=random.Random(1))
    assert lane.shape == (8, pl.fr_ctx.n_limbs)
    # SystemRandom by default: two draws differ
    assert not torch.equal(pl.make_lane_rand(4), pl.make_lane_rand(4))


def test_pack_inputs_pads_with_lane_zero_and_a_dead_mask():
    pl = plane(2)
    ps, msg, sig, gpk, idx, live = pl.pack_inputs(*rows())
    assert live.tolist() == [True, True, True, False]
    assert ps[0].shape == (4, T, 16) and sig[0][0].shape == (4, T, 16) and idx.shape == (4, T)
    assert torch.equal(sig[0][0][3], sig[0][0][0]) and idx[3].tolist() == WL[4][0]
    assert C.g2_unpack(pl.ctx, msg) == [*WL[1][:V], WL[1][0]]


def test_kernel_families_are_the_ten_mesh_programs():
    fams = plane(1).kernel_families()
    assert sorted(fams) == sorted(f"mesh/{n}" for n in M.FAMILIES) and len(fams) == 10
    assert [n for n, f in fams.items() if f.sentinel] == ["mesh/g1dec"]
    spec = fams["mesh/g1dec"].build()
    assert (spec.lanes, spec.multiple) == (4, 1)
    aff, valid = spec.launch()
    assert valid.tolist() == [True] * 4
    spec2 = plane(2).kernel_families()["mesh/verify_rlc"].build("cpu")
    assert (spec2.lanes, spec2.multiple) == (4, 1)  # a one-shard plane on the given device


def test_register_analysis_families_is_idempotent():
    M.register_analysis_families(["cpu"])
    before = blsops.kernel_families()
    M.register_analysis_families(["cpu"])
    assert blsops.kernel_families().keys() == before.keys()
    assert {f"mesh/{n}" for n in M.FAMILIES} <= before.keys()
    assert {"blsops/verify", "blsops/threshold_agg", "blsops/decompress_g2"} <= before.keys()


def test_program_runs_in_inference_mode_in_the_calling_thread():
    """Grad mode is thread-local: a program dispatched from a worker thread
    still runs without autograd, and leaves the caller's mode alone."""
    spec = plane(1).kernel_families()["mesh/g1dec"].build()
    out = {}

    def worker():
        out["grad"] = torch.is_grad_enabled()
        aff, valid = spec.fn(*spec.args)
        out["inference"] = aff[0].is_inference() and valid.is_inference()

    th = threading.Thread(target=worker)
    th.start()
    th.join()
    assert out == {"grad": True, "inference": True}
    assert torch.is_grad_enabled()


def test_on_program_hook_faults_never_fail_a_dispatch():
    pl = plane(1)
    seen = []

    def hook(fam, seconds, lanes):
        seen.append((fam, lanes))
        raise RuntimeError("broken metrics sink")

    pl.on_program = hook
    try:
        assert pl._timed("g1dec", 3, lambda: "done") == "done"
    finally:
        pl.on_program = None
    assert seen == [("mesh/g1dec", 3)]


def test_jit_cache_size_counts_program_bucket_pairs(monkeypatch):
    """100 random-size verify flushes dispatch one (program, bucket) pair a
    bucket: growth is O(log max batch), never one per flush (the pairing
    faked, so no field work runs)."""
    from charon_tpu.crypto.g1g2 import G1_GEN, G2_GEN

    shapes = []

    def fake_verify_rlc(ctx, fr_ctx, pk, msg, sig, rand):
        shapes.append(pk[0].shape[0])
        return torch.tensor(True)

    monkeypatch.setattr(DP, "batched_verify_rlc", fake_verify_rlc)
    pl = SlotCryptoPlane(make_mesh(["cpu", "cpu"]), t=T)
    rng = random.Random(7)
    sizes = [rng.randrange(1, 150) for _ in range(100)]
    for n in sizes:
        assert pl.verify_host([G1_GEN] * n, [G2_GEN] * n, [G2_GEN] * n) == [True] * n
    ladder = {pl.bucket_lanes(n) for n in sizes}
    assert set(shapes) == {b // 2 for b in ladder}  # each shard sees its slice
    assert pl.jit_cache_size() == len(ladder) <= 8


# -- step_rlc and step ------------------------------------------------------------


def test_step_rlc_all_valid_with_corrupt_padding():
    """The grouped-MSM path accepts a valid slot, its recombinations equal
    the oracle's, and a padding lane with garbage partials (live False) is
    masked out of the verdict."""
    pl = plane(1)
    ps, msg, sig, gpk, idx, live = pl.pack_inputs(*rows())
    # the padding lane carries row 1's partials under row 0's keys
    sig = C.map_point(lambda a: torch.cat((a[:V], a[1:2])), sig)
    assert MSM.msm_active()
    group_sig, all_ok = pl.step_rlc(ps, msg, sig, gpk, idx, live, pl.make_rand(V, random.Random(7)))
    assert all_ok is True
    assert C.g2_unpack(pl.ctx, group_sig)[:V] == oracle_sigs(WL[2])


def test_recombine_host_forged_row_fails_rlc_then_step_attributes():
    sigs, oks, fams, _ = forged_recombine(1)
    assert [f for f, _ in fams] == ["mesh/step_rlc", "mesh/step"]
    assert all(lanes == V for _, lanes in fams)
    assert oks == [True, False, True]
    assert sigs == oracle_sigs(forged_partials())


def test_step_counts_valid_rows_and_masks_padding():
    _, _, _, raw = forged_recombine(1)
    [(group_sig, ok, total)] = raw
    assert ok.tolist() == [True, False, True, False]  # lane 3: padding
    assert total == 2


def test_recombine_host_matches_both_host_oracles_on_two_shards():
    """The cross-check of the JAX package's __graft_entry__.py, on a
    two-shard plane: every recombined signature equals the Lagrange oracle
    and passes the pure-Python pairing verify against its group key."""
    pl = plane(2)
    ps, msgs, parts, gpks, idx = WL
    sigs, oks = pl.recombine_host(ps, msgs, parts, gpks, idx)
    assert oks == [True] * 4
    assert sigs == oracle_sigs(parts, 4)
    for v in range(4):
        assert bls.verify(gpks[v], b"mesh-duty-%d" % v, sigs[v])


# -- the JAX package's plane (slow: the XLA:CPU compile takes minutes) -------------


@pytest.mark.slow
def test_step_rlc_and_step_match_the_jax_plane():
    import jax

    from charon_tpu.ops import curve as RC
    from charon_tpu.parallel import SlotCryptoPlane as RefPlane
    from charon_tpu.parallel import make_mesh as ref_make_mesh

    ref = RefPlane(ref_make_mesh(jax.devices()[:1]), t=T)
    pl = plane(1)
    args = ref.pack_inputs(*rows())
    ref_sig, ref_ok = ref.step_rlc(*args, ref.make_rand(V, rng=random.Random(9)))
    sig, ok = pl.step_rlc(*pl.pack_inputs(*rows()), pl.make_rand(V, rng=random.Random(9)))
    assert bool(ref_ok) is ok is True
    assert RC.g2_unpack(ref.ctx, ref_sig)[:V] == C.g2_unpack(pl.ctx, sig)[:V] == oracle_sigs(WL[2])
    ref_sig, ref_ok, ref_total = ref.step(*ref.pack_inputs(*rows(partials=forged_partials())))
    _, _, _, [(sig, ok, total)] = forged_recombine(1)
    assert [bool(b) for b in ref_ok] == ok.tolist()
    assert int(ref_total) == total == 2
    assert RC.g2_unpack(ref.ctx, ref_sig)[:V] == C.g2_unpack(pl.ctx, sig)[:V]
