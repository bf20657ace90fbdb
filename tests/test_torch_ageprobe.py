"""PyTorch port: the main path's loop steps and the age probe
(charon_tpu_torch/app/ageprobe.py), at a tiny width on the CPU.

  * loop_steps() over two signatures: the sqrt-chain step computes x^2 * y
    of each point (against the host Fp2 arithmetic of crypto/fields.py),
    the psi ladder step a G2 double and the ladder step a double then an
    add (against crypto/g1g2.py, compared in affine form), the chain step
    an Fp12 value of 9 lanes;
  * chip_smoke.age_probe() prints one line with every field of a probe:
    each step's median wall, thread CPU and device ms, launches and
    aligning copies a step, gc's counts, collections and seconds since the
    last probe, the objects gc tracks, RSS, the allocator's allocated and
    reserved MiB and retries (None on the CPU), the live threads; and the
    cProfile line with each step's calls, torch ops and host us per op;
  * the sqrt-chain step's launches: one K3 and one K2 under the default
    route, K6 and K5 under int8, two K1 Fp unfused, none on the CPU; a step
    that launches otherwise raises, in the probe too;
  * chip_smoke.age_turns() probes this process and a fresh one (the
    --age-fresh protocol: a label a line on stdin, a JSON line back) in
    turns, AGE_TURNS each, and logs each step's ratio.

Tolerance: exact (field elements, points, counts).
"""

from __future__ import annotations

import gc
import json
import pathlib
import pickle
import sys
import textwrap

import pytest
import torch

import chip_smoke as cs
from charon_tpu_torch.app import ageprobe as A
from charon_tpu_torch.core.autotune import KernelConfig
from charon_tpu_torch.crypto import bls, fields as F, g1g2
from charon_tpu_torch.ops import curve as C
from charon_tpu_torch.ops import fptower as T
from charon_tpu_torch.ops import limb
from charon_tpu_torch.ops.blsops import BlsEngine

torch.set_num_threads(1)

STEP_FIELDS = {"reps", "wall_ms", "cpu_ms", "device_ms", "launches", "align_copies"}
PROBE_FIELDS = {"label", "steps", "gc_count", "gc_collections", "gc_seconds", "gc_objects", "rss_mib", "threads",
                "allocated_mib", "reserved_mib", "alloc_retries"}


@pytest.fixture(scope="module")
def signed():
    points = [bls.sign(bls.keygen(bytes([i + 1]) * 32), b"age probe %d" % i) for i in range(2)]
    engine = BlsEngine(device="cpu")
    return points, engine, A.loop_steps(engine, [g1g2.g2_to_bytes(p) for p in points])


def _affine(ctx, pt) -> list:
    return C.g2_unpack(ctx, C.point_to_affine(C.g2_ops(ctx), pt))


def test_loop_steps_compute_their_bodies(signed):
    points, engine, steps = signed
    assert [name for name, _ in steps] == ["g2_ladder_step_x2", "g2_sqrt_chain_step_x2", "psi_ladder_step_x2",
                                           "final_exp_chain_step_x9"]
    run = dict(steps)
    ctx = engine.ctx
    sqrt = T.fp2_unpack(ctx, run["g2_sqrt_chain_step_x2"]())
    dbl = _affine(ctx, run["psi_ladder_step_x2"]())
    lad = _affine(ctx, run["g2_ladder_step_x2"]())
    for i, (x, y) in enumerate(points):
        assert sqrt[i] == F.fp2_mul(F.fp2_sqr(x), y)
        assert dbl[i] == g1g2.g2_double((x, y))
        assert lad[i] == g1g2.g2_add(g1g2.g2_double((x, y)), (x, y))
    chain = run["final_exp_chain_step_x9"]()
    assert chain[0][0][0].shape == (9, ctx.n_limbs)


def test_age_probe_prints_every_field(signed, capsys):
    _, engine, steps = signed
    probe = A.AgeProbe(steps, engine.device, engine.ctx, reps=3, min_seconds=0.0)
    try:
        gc.collect()
        first = cs.age_probe(probe, "first", profiled=True)
        lines = capsys.readouterr().out.splitlines()
        gc.collect()
        last = cs.age_probe(probe, "last")
        cs.age_drift(first, last)
        more = capsys.readouterr().out.splitlines()
    finally:
        probe.close()
    [line] = [x for x in lines if "age probe first:" in x]
    got = json.loads(line.split("age probe first:", 1)[1])
    assert set(got) == PROBE_FIELDS and got == json.loads(json.dumps(first))
    assert set(got["steps"]) == {name for name, _ in steps}
    for step in got["steps"].values():
        assert set(step) == STEP_FIELDS and step["wall_ms"] > 0 and step["cpu_ms"] > 0
        assert step["device_ms"] is None and step["launches"] == {}
    assert got["allocated_mib"] is None and got["reserved_mib"] is None and got["alloc_retries"] is None
    assert len(got["gc_count"]) == 3 and got["gc_objects"] > 0 and got["rss_mib"] > 0 and got["threads"] >= 1
    assert last["gc_collections"][2] >= 1 and last["gc_seconds"] > 0  # the gc.collect() between the probes
    [prof] = [x for x in lines if "age profile first:" in x]
    prof = json.loads(prof.split("age profile first:", 1)[1])
    for name, _ in steps:
        assert prof[name]["torch_ops"] > 0 and prof[name]["us_per_op"] > 0 and prof[name]["top"]
    assert sum("age drift" in x for x in more) == len(steps)
    assert probe._on_gc not in gc.callbacks


@pytest.mark.parametrize("config,device,want", [
    (KernelConfig(), "cuda", {"fp2_sqr": 1, "fp2_mul": 1}),
    (KernelConfig(mxu_mont=True), "cuda", {"fp2_sqr_mxu": 1, "fp2_mul_mxu": 1}),
    (KernelConfig(fp2_fusion=False), "cuda", {"mont_mul_fp": 2}),
    (KernelConfig(mxu_mont=True), "cpu", {}),
])
def test_sqrt_step_kernels_under_each_route(config, device, want):
    config.apply()
    try:
        assert A.sqrt_step_kernels(limb.FP, device) == want
    finally:
        KernelConfig().apply()


def test_a_sqrt_step_off_its_route_raises(signed, monkeypatch):
    A.check_step_launches("s", {"fp2_sqr": 1, "fp2_mul": 1, "mont_mul_fp": 0}, {"fp2_sqr": 1, "fp2_mul": 1})
    with pytest.raises(AssertionError, match="launches a step"):
        A.check_step_launches("s", {"fp2_sqr": 1}, {"fp2_sqr": 1, "fp2_mul": 1})
    _, engine, steps = signed
    monkeypatch.setattr(A, "sqrt_step_kernels", lambda ctx, device: {"fp2_sqr": 1, "fp2_mul": 1})
    probe = A.AgeProbe([s for s in steps if s[0].startswith(A.SQRT_STEP)], engine.device, engine.ctx, reps=2, min_seconds=0.0)
    try:
        with pytest.raises(AssertionError, match="g2_sqrt_chain_step_x2: launches a step {}"):
            probe.probe("off route")
    finally:
        probe.close()


FRESH = """
import sys
sys.path.insert(0, {root!r})
import chip_smoke as cs
from charon_tpu_torch.app.ageprobe import AgeProbe, loop_steps
from charon_tpu_torch.ops.blsops import BlsEngine

def make(vals):
    engine = BlsEngine(device="cpu")
    steps = loop_steps(engine, [s for v in vals for s in v[3].values()])
    return AgeProbe(steps, "cpu", engine.ctx, reps=2, min_seconds=0.0)

cs.make_age_probe = make
sys.exit(cs.age_fresh(sys.argv[1]))
"""


def test_age_turns_hold_this_process_against_a_fresh_one(signed, tmp_path, monkeypatch, capsys):
    points, engine, steps = signed
    vals = tmp_path / "vals.pickle"
    vals.write_bytes(pickle.dumps([(None, None, None, {i: g1g2.g2_to_bytes(p) for i, p in enumerate(points)})]))
    fresh = tmp_path / "fresh.py"
    fresh.write_text(textwrap.dedent(FRESH.format(root=str(pathlib.Path(cs.__file__).parent))))
    monkeypatch.setattr(cs, "phase_command", lambda *flags: [sys.executable, str(fresh), str(flags[1])])
    probe = A.AgeProbe(steps, engine.device, engine.ctx, reps=2, min_seconds=0.0)
    try:
        cs.age_turns(probe, vals)
    finally:
        probe.close()
    out = capsys.readouterr().out
    for side in ("aged", "fresh"):
        assert [f"age probe {side} turn {i}:" in out for i in range(cs.AGE_TURNS)] == [True] * cs.AGE_TURNS
    turns = [line for line in out.splitlines() if "age turns " in line]
    assert len(turns) == len(steps) and all("ratio " in line for line in turns)
