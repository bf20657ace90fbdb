"""PyTorch port: the Byzantine adversary harness
(charon_tpu_torch/testutil/byzantine.py), held against the JAX package.

  * The JAX package's tests/test_byzantine.py runs on the port's modules
    (`reference_cases`), its two simnet differential cases `slow` as they
    are there; the differential cases wrap the port's host backend, and
    their oracle is the port's PythonImpl.
  * Every rebound case is bounded as in tests/test_torch_chaos.py (its
    `asyncio.run` under `asyncio.wait_for`) and runs under the same
    thread/task leak guard, on the port's analysis/sanitizer.py.
  * Parity on the same seeds: the leader rule, `find_instance`, the
    harness MACs and the adversary streams are equal in both packages,
    and the leader-equivocation scenario decides the same value with the
    same evidence and drop counters in both.
  * The card battery's CPU-size twin: chip_smoke.adversarial_battery
    (valid partials, forged signatures, wrong shares, off-subgroup
    points, infinity and wrong-length encodings, threshold sets with a
    repeated signer, a forged member and index 0, aggregates) through
    `differential_backend()` over `TorchImpl(device="cpu")` records zero
    mismatches against the port's PythonImpl, checks every lane, and
    gives the battery's verdicts.

Tolerance: exact (verdicts, signature bytes, decisions, counters).
"""

from __future__ import annotations

import asyncio
import random

import pytest
import torch
from test_torch_chaos import bounded, leak_guard  # noqa: F401
from test_torch_node_core import export_cases, port_globals, reference_cases, reference_modules  # noqa: F401

import chip_smoke
from charon_tpu.core import qbft as ref_qbft
from charon_tpu.testutil import byzantine as ref_byz
from charon_tpu_torch import tbls as port_tbls
from charon_tpu_torch.core import qbft as port_qbft
from charon_tpu_torch.tbls.torch_impl import TorchImpl
from charon_tpu_torch.testutil import byzantine as port_byz

torch.set_num_threads(1)  # tiny tensors: more intra-op threads only spin

BYZANTINE_CASES = export_cases(bounded(reference_cases("test_byzantine")), globals())
TWIN_LANES = 6  # the battery's smallest size: one verify_batch lane of each kind
PACKAGES = {"port": (port_byz, port_qbft), "ref": (ref_byz, ref_qbft)}


def test_reference_cases_run_on_the_port():
    """Every rebound case runs on the port's modules and none of the
    reference's; the two simnet differential cases stay `slow`."""
    tests = [n for n in BYZANTINE_CASES if n.startswith("test_")]
    assert len(tests) == 14
    for name in tests:
        assert not reference_modules(globals()[name]), name
    slow = {n for n in tests if any(m.name == "slow" for m in getattr(globals()[n], "pytestmark", ()))}
    assert slow == {"test_simnet_rogue_partial_flood_differential", "test_simnet_double_sign_excluded_from_aggregate"}


# -- parity: the same seeds, the same adversary --------------------------------


@pytest.mark.parametrize("n", [4, 7])
def test_leader_rule_and_find_instance_equal(n):
    for rnd in (1, 2, 5):
        for leader in range(n):
            insts = {name: m.find_instance(n, rnd, leader, prefix="p") for name, (m, _) in PACKAGES.items()}
            assert insts["port"] == insts["ref"]
            assert port_byz.deterministic_leader(n)(insts["port"], rnd) == leader


def test_harness_macs_and_streams_equal():
    out = {}
    for name, (m, q) in PACKAGES.items():
        signer = m.HarnessSigner(4, seed=160808)
        msg = signer.sign(q.Msg(q.MsgType.PREPARE, "inst-3", 2, 1, "value"))
        params = m.AdversaryParams(seed=160808, n=7, t=5, f=2)
        out[name] = (msg.signature, params.adversaries, params.honest, [params.stream("x").random() for _ in range(4)])
        assert signer.verify_sender(msg) and signer.is_valid(msg)
        assert not signer.is_valid(signer.forge(msg, random.Random(1)))
    assert out["port"] == out["ref"]


def test_equivocation_scenario_equal_in_both_packages():
    """Strategy 1 of the battery on both packages: the same decision, the
    same evidence ledger and the same drop counters."""
    got = {}
    for name, (m, q) in PACKAGES.items():
        params = m.AdversaryParams(seed=160808, n=4, t=3, f=1)
        adv = params.adversaries[0]
        inst = m.find_instance(4, 1, adv, prefix="equiv")

        async def attack(net, signer, p, q=q, inst=inst, adv=adv):
            net.inject_all(signer.sign(q.Msg(q.MsgType.PRE_PREPARE, inst, adv, 1, "good")))
            net.inject_all(signer.sign(q.Msg(q.MsgType.PRE_PREPARE, inst, adv, 1, "evil")))

        res = asyncio.run(asyncio.wait_for(m.run_with_adversary(params, inst, attack), 60.0))
        got[name] = (m.assert_agreement(res.decisions), res.evidence.snapshot(), res.merged_drops())
    assert got["port"] == got["ref"]
    assert got["port"][0] == "good"


# -- the card battery's CPU-size twin ------------------------------------------


def test_differential_battery_twin_on_the_cpu_torch_backend():
    """The adversarial battery of chip_smoke.py's phase 11 at its smallest
    size through DifferentialTbls over TorchImpl(device="cpu"): zero
    mismatches against the port's PythonImpl, every lane checked, every
    verdict, signature and raise the battery's."""
    battery = chip_smoke.adversarial_battery(1, lanes=TWIN_LANES)
    assert battery["counts"] == {
        "forged": 1, "wrong-share": 1, "off-subgroup": 1, "infinity": 1, "wrong-length": 1, "valid": 1,
    }
    port_tbls.set_implementation(TorchImpl(device="cpu"))
    with port_byz.differential_backend() as diff:
        assert isinstance(diff.inner, TorchImpl)
        chip_smoke.drive_battery(battery)
    port_byz.assert_no_mismatches(diff)
    assert diff.lanes_checked == chip_smoke.battery_lanes(battery) > TWIN_LANES


def test_differential_battery_flags_a_lying_backend():
    """The battery has teeth: a backend that accepts every signature fails
    drive_battery on its first forged lane, and DifferentialTbls records
    the divergence against the oracle."""
    from charon_tpu_torch.tbls.python_impl import PythonImpl

    class Liar(PythonImpl):
        def verify(self, pubkey, data, sig):
            return None

    battery = chip_smoke.adversarial_battery(2, lanes=TWIN_LANES)
    port_tbls.set_implementation(Liar())
    with port_byz.differential_backend() as diff:
        with pytest.raises(AssertionError, match="wrong verdicts"):
            chip_smoke.drive_battery(battery)
    assert len(diff.mismatches) == TWIN_LANES - 1
    with pytest.raises(AssertionError):
        port_byz.assert_no_mismatches(diff)
