"""A run of the harness on the CPU at a tiny size (the port's plain kernel
versions), past the look for a card: correct with the program as it is,
and not correct with the timed path broken underneath, once for each
fault the cells can have. Without a card, run.py exits non-zero and
prints no result. The `cuda` case runs a small cell on the card."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import run, spec

CFG = {"name": "tiny", "validators": 2, "nodes": 7, "threshold": 4, "roots_per_slot": 1, "signers": 4}
TRAFFIC = {"ring_slots": 1, "untimed_slots": 0, "spread_s": 0.0, "forged_per_slot": 0}
SEED = 2**31 + 2**20 + 3


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_run(traffic=TRAFFIC, device="cpu", cfg=CFG):
    bench = spec.benchmark()
    cell = {"name": "att1k.burst", "config": "tiny", "traffic": "burst", "chips": 1}
    return run.run_cell(bench, cell, cfg, traffic, SEED, 0.0, False, device)


@pytest.mark.parametrize("cell,metrics", [("att1k.burst", {"setup_s"}), ("sync512.burst", {"slot_s", "setup_s"})])
def test_dry_run_on_the_cpu_is_correct(cell, metrics):
    bench = spec.benchmark()
    result, compared = run.run_cell(bench, {**spec.workload(bench, cell), "config": "tiny"}, CFG, TRAFFIC, SEED, 0.0,
                                    False, "cpu")
    assert result["correct"] and result["failed"] == 0
    # the window's slot and the check slot, whose forged partial the program turned down
    assert result["attempted"] == 2 * (2 * 4 + 2)
    # the cell's end-to-end metrics; verify_device_s reads the device trace, which the CPU leaves empty
    assert set(result["metrics"]) == metrics
    assert "busy_s" not in result["device"] and "breakdown" not in result
    assert result["device"]["platform"] == "cpu"
    assert compared == {"verdicts_wrong": (0, 0), "group_sigs_wrong": (0, 0), "results_missing": (0, 0)}


@pytest.mark.parametrize("cell", ["att1k.burst", "sync512.burst"])
def test_traced_dry_run_profiles_the_check_slot_after_the_window(cell):
    bench = spec.benchmark()
    cell = spec.workload(bench, cell)
    result, _ = run.run_cell(bench, cell, CFG, {**TRAFFIC, "ring_slots": 2}, SEED, 0.0, True, "cpu")
    # a window of 0 s answers one whole slot; then the traced check slot
    assert result["correct"] and result["attempted"] == 2 * (2 * 4 + 2)
    m = result["metrics"]
    assert m["boot.program_s"]["value"] > 0
    if cell["name"] == "att1k.burst":
        assert m["coalescer.slot_s"]["value"] > 0 and "plane.programs_s" not in m
    else:
        assert m["coalescer.flushes_per_slot"]["value"] == 1 and m["plane.programs_s"]["value"] > 0
    # no device events on the CPU: the trace's metrics are left out, never 0
    assert not any(name.endswith("_roofline") or name == "device.idle_share" for name in m)
    assert result["device"]["busy_s"] == 0 and result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def _patch_outputs(monkeypatch, verify=None, recombine=None):
    """Break the plane's device stage where its answers are produced: the
    verdicts of each verify batch through `verify`, the (group signature
    points, ok flags) of each recombine batch through `recombine`."""
    from charon_tpu_torch.parallel import mesh

    for name, fault in (("verify_packed", verify), ("verify_packed_parsed", verify),
                        ("recombine_packed", recombine), ("recombine_packed_parsed", recombine)):
        if fault is None:
            continue
        real = getattr(mesh.SlotCryptoPlane, name)

        def broken(self, *args, _real=real, _fault=fault):
            return _fault(_real(self, *args))

        monkeypatch.setattr(mesh.SlotCryptoPlane, name, broken)


def _flip_first(oks):
    return [not oks[0], *oks[1:]]


def _alter_first_sig(out):
    from charon_tpu_torch.crypto import g1g2

    sigs, oks = out
    return [g1g2.g2_neg(sigs[0]), *sigs[1:]], oks


def _half_left_out(out):
    sigs, oks = out
    half = len(sigs) // 2
    return sigs[:half] + sigs[: len(sigs) - half], oks


class _Stale:
    """The recombine stage hands back the answers of the flush before it."""

    def __init__(self):
        self.last = None

    def __call__(self, out):
        last, self.last = self.last, out
        return out if last is None else last


def _says_true_without_checking(monkeypatch):
    """The RLC programs answer "every lane and row valid" whatever their
    pairing check found: the verdicts and rows then follow the decode
    masks alone."""
    from charon_tpu_torch.parallel import mesh

    for name, at in (("_verify_rlc_body", 0), ("_verify_rlc_dec_body", 0), ("_step_rlc_body", 1),
                     ("_step_rlc_dec_body", 1)):
        real = getattr(mesh.SlotCryptoPlane, name)

        def broken(self, *args, _real=real, _at=at):
            out = _real(self, *args)
            out = (out,) if not isinstance(out, tuple) else out
            yes = torch.ones_like(torch.as_tensor(out[_at]), dtype=torch.bool)
            return (*out[:_at], yes, *out[_at + 1 :])

        monkeypatch.setattr(mesh.SlotCryptoPlane, name, broken)


FAULTS = {
    "says_true_without_checking": dict(plant=_says_true_without_checking),
    "verdict_altered": dict(verify=_flip_first),
    "group_sig_altered": dict(recombine=_alter_first_sig),
    "half_the_rows_left_out": dict(recombine=_half_left_out),
    "state_unchanged": dict(recombine=_Stale()),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    faults = dict(FAULTS[fault])
    plant = faults.pop("plant", None)
    if plant is not None:
        plant(monkeypatch)
    _patch_outputs(monkeypatch, **faults)
    traffic = {**TRAFFIC, "ring_slots": 2, "untimed_slots": 0} if fault == "state_unchanged" else TRAFFIC
    if fault == "state_unchanged":
        # the window must reach the second slot: every slot is timed
        bench = spec.benchmark()
        cell = {"name": "att1k.burst", "config": "tiny", "traffic": "burst", "chips": 1}
        result, compared = run.run_cell(bench, cell, CFG, traffic, SEED, 1e9, False, "cpu")
    else:
        result, compared = tiny_run(traffic)
    assert not result["correct"] and result["failed"] >= 1
    assert any(value > limit for value, limit in compared.values())


def test_without_a_card_run_exits_nonzero_and_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    argv = ["--workload", "att1k.burst", "--seed", "5", "--seconds", "1", "--trace", "0"]
    out = subprocess.run([sys.executable, "portbench/run.py", *argv], cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and not any(line.startswith("{") for line in out.stdout.splitlines())
    # a checkout of BENCHMARK.json and portbench/ alone has no program to run either
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", *argv], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and not any(line.startswith("{") for line in out.stdout.splitlines())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda:0"


@pytest.mark.cuda
def test_a_small_cell_on_the_card_is_correct(card):
    cfg = {**CFG, "validators": 64, "roots_per_slot": 4}
    result, _ = tiny_run({**TRAFFIC, "untimed_slots": 1}, card, cfg)
    assert result["correct"] and result["attempted"] == 64 * 5
    assert json.dumps(result)
