"""PyTorch port: the startup kernel tuner (charon_tpu_torch/core/autotune.py).

The fake-bench battery of tests/test_autotune.py on the port's resolve():
cold tune then a pure hit, force re-tune, corrupt and truncated profiles, a
stale digest, the env pin outranking the profile, hosts without a card,
warm_boot_ready, the append-only profile schema against its blessed
snapshot (held here as a literal), and the port's own rules — apply()
raises for a value it has no route for, and a flip takes effect on the
next call. No real micro-bench runs here: resolve() gets device="cpu" and
an injected bench.
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from charon_tpu_torch.core import autotune
from charon_tpu_torch.core.autotune import KernelConfig, PlaneConfigError
from charon_tpu_torch.ops import limb as L
from charon_tpu_torch.ops import mont_kernels as MK
from charon_tpu_torch.ops import msm as MSM

torch.set_num_threads(1)  # tiny tensors: more intra-op threads only spin

# The blessed profile schema. Append-only: change it only together with
# PROFILE_FIELDS, and bump the version when a field becomes required.
GOLDEN = {
    "version": 1,
    "fields": [
        "version",
        "platform",
        "torch_version",
        "cuda_version",
        "capability",
        "source_digest",
        "host",
        "config",
        "sources",
        "timings",
        "families",
        "tune_lanes",
        "prewarm_lanes",
    ],
    "required": [
        "version",
        "platform",
        "torch_version",
        "cuda_version",
        "capability",
        "source_digest",
        "config",
    ],
}


@pytest.fixture(autouse=True)
def _kernel_flags():
    yield
    MSM.set_msm(None)
    L.set_mxu(None)


def fake_bench(tuned_msm=True, tuned_mxu=False):
    """micro_bench-compatible stand-in: no kernels, fixed verdicts."""

    def bench(candidates=None, lanes=0, reps=0, base=None, observer=None, device=None):
        assert device == torch.device("cpu")
        choices = {
            "msm": (tuned_msm, "tuned"),
            "mxu_mont": (tuned_mxu, "tuned"),
            "fp2_fusion": (True, "inapplicable"),
            "ceremony_straus": (True, "inapplicable"),
            "ceremony_msm_w8": (True, "inapplicable"),
        }
        timings = {"msm": {"on": 0.5, "off": 2.0}, "mxu_mont": {"on": 0.2, "off": 0.1}}
        return choices, timings, 4

    return bench


def resolve(mode, path, **kw):
    return autotune.resolve(mode, path, device="cpu", **kw)


def events_of(log):
    return [f["event"] for k, f in log if k == "profile"]


def make_obs(log):
    return lambda kind, **fields: log.append((kind, fields))


# -- resolve lifecycle ---------------------------------------------------------


def test_cold_tune_persists_then_pure_hit(tmp_path):
    path = tmp_path / "profile.json"
    log = []
    res = resolve("auto", path, bench=fake_bench(tuned_mxu=True), observer=make_obs(log))
    assert res.outcome == "tuned" and res.bench_runs == 4
    assert res.config.msm is True and res.config.mxu_mont is True
    assert L._mxu_active(L.FP)  # applied
    assert events_of(log) == ["miss", "rebuilt"]
    prof = autotune.load_profile(path)
    assert prof["platform"] == "cpu" and prof["torch_version"] == torch.__version__
    assert prof["families"] == [] and prof["sources"]["fp2_fusion"] == "inapplicable"

    def explode(**kw):  # a hit must not micro-bench
        raise AssertionError("bench ran on a warm boot")

    L.set_mxu(None)
    log2 = []
    res2 = resolve("auto", path, bench=explode, observer=make_obs(log2))
    assert res2.outcome == "hit" and res2.bench_runs == 0
    assert res2.config == res.config and L._mxu_active(L.FP)
    assert events_of(log2) == ["hit"]
    assert all(res2.sources[f] == "profile" for f in KernelConfig.TUNABLE)
    decisions = {f["axis"]: f["choice"] for k, f in log2 if k == "decision"}
    assert decisions["mxu_mont"] == "on" and set(decisions) == set(KernelConfig.TUNABLE)


def test_force_retunes_over_fresh_profile(tmp_path):
    path = tmp_path / "profile.json"
    resolve("auto", path, bench=fake_bench())
    res = resolve("force", path, bench=fake_bench(tuned_msm=False))
    assert res.outcome == "tuned" and res.config.msm is False
    assert autotune.load_profile(path)["config"]["msm"] is False
    assert MSM.msm_active() is False


def test_corrupt_profile_degrades_to_retune(tmp_path):
    path = tmp_path / "profile.json"
    path.write_text("{not json")
    with pytest.raises(autotune.ProfileError) as exc:
        autotune.load_profile(path)
    assert exc.value.reason == "corrupt"
    log = []
    res = resolve("auto", path, bench=fake_bench(), observer=make_obs(log))
    assert res.outcome == "tuned"
    assert events_of(log) == ["corrupt", "rebuilt"]


def test_truncated_profile_is_corrupt_not_crash(tmp_path):
    path = tmp_path / "profile.json"
    resolve("auto", path, bench=fake_bench())
    full = path.read_text()
    path.write_text(full[: len(full) // 2])
    with pytest.raises(autotune.ProfileError) as exc:
        autotune.load_profile(path)
    assert exc.value.reason == "corrupt"
    assert resolve("auto", path, bench=fake_bench()).outcome == "tuned"


def test_schema_and_version_reasons(tmp_path):
    path = tmp_path / "profile.json"
    autotune.save_profile({"version": 1, "platform": "cpu"}, path)
    with pytest.raises(autotune.ProfileError) as exc:
        autotune.load_profile(path)
    assert exc.value.reason == "schema"

    prof = {"version": autotune.PROFILE_VERSION + 1, **autotune.fingerprint("cpu"), "config": KernelConfig().as_dict()}
    autotune.save_profile(prof, path)
    with pytest.raises(autotune.ProfileError) as exc:
        autotune.load_profile(path)
    assert exc.value.reason == "version"

    prof["version"] = autotune.PROFILE_VERSION
    prof["config"] = {"mxu_mont": "yes"}
    autotune.save_profile(prof, path)
    with pytest.raises(autotune.ProfileError) as exc:
        autotune.load_profile(path)
    assert exc.value.reason == "schema"


@pytest.mark.parametrize("key", ["source_digest", "torch_version", "capability"])
def test_stale_fingerprint_triggers_retune(tmp_path, key):
    path = tmp_path / "profile.json"
    resolve("auto", path, bench=fake_bench())
    prof = autotune.load_profile(path)
    prof[key] = "not-this-build"
    autotune.save_profile(prof, path)
    log = []
    res = resolve("auto", path, bench=fake_bench(), observer=make_obs(log))
    assert res.outcome == "tuned" and res.bench_runs > 0
    assert events_of(log) == ["stale", "rebuilt"]
    assert autotune.staleness(autotune.load_profile(path), autotune.fingerprint("cpu")) is None


def test_source_digest_covers_kernel_sources(tmp_path, monkeypatch):
    """A change to any ops module or kernel source changes the digest."""
    before = autotune.source_digest()
    for sub in ("ops", "csrc"):
        (tmp_path / sub).mkdir()
    for path in (autotune._PKG / "ops").glob("*.py"):
        (tmp_path / "ops" / path.name).write_bytes(path.read_bytes())
    for path in (autotune._PKG / "csrc").glob("*"):
        (tmp_path / "csrc" / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(autotune, "_PKG", tmp_path)
    assert autotune.source_digest() == before
    with open(tmp_path / "csrc" / "mont_mxu.cuh", "a") as f:
        f.write("// edited\n")
    assert autotune.source_digest() != before


def test_env_override_outranks_profile(tmp_path):
    path = tmp_path / "profile.json"
    resolve("auto", path, bench=fake_bench(tuned_mxu=False))
    res = resolve("auto", path, bench=fake_bench(), environ={"CHARON_MXU_MONT": "1"})
    assert res.outcome == "hit"
    assert res.config.mxu_mont is True and L._mxu_active(L.FP)
    assert res.sources["mxu_mont"] == "env" and res.sources["msm"] == "profile"
    assert res.overrides == {"mxu_mont": True}
    # the persisted profile keeps the tuned verdict, not the pin
    assert autotune.load_profile(path)["config"]["mxu_mont"] is False


def test_mode_off_skips_profile_io(tmp_path):
    path = tmp_path / "nonexistent" / "profile.json"
    res = autotune.resolve("off", path, environ={"CHARON_MXU_MONT": "1"})
    assert res.outcome == "off" and res.bench_runs == 0 and res.profile_path is None
    assert res.config.mxu_mont is True and L._mxu_active(L.FR)
    assert not path.parent.exists()


def test_unknown_mode_is_typed(tmp_path):
    with pytest.raises(PlaneConfigError):
        resolve("bogus", tmp_path / "p.json")


def test_host_without_a_card(monkeypatch, tmp_path):
    """device=None means the card: with none, auto skips loudly to the
    defaults and on/force raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    log = []
    res = autotune.resolve("auto", tmp_path / "p.json", bench=fake_bench(), observer=make_obs(log),
                           environ={"CHARON_MXU_MONT": "1"})
    assert res.outcome == "skipped" and res.config.mxu_mont is True
    assert events_of(log) == ["skipped"]
    assert not (tmp_path / "p.json").exists()
    for mode in ("on", "force"):
        with pytest.raises(PlaneConfigError):
            autotune.resolve(mode, tmp_path / "p.json", bench=fake_bench())


# -- warm_boot_ready -----------------------------------------------------------


def test_warm_boot_ready(tmp_path):
    path = tmp_path / "profile.json"
    assert autotune.warm_boot_ready(path, device="cpu") is False  # no profile
    resolve("auto", path, bench=fake_bench())
    assert autotune.warm_boot_ready(path, device="cpu") is False  # no prewarm marker

    marker = autotune.mark_prewarmed(path, device="cpu")
    assert marker == autotune.prewarm_marker_path(path) and marker.parent == path.parent
    assert autotune.warm_boot_ready(path, device="cpu") is True

    mark = json.loads(marker.read_text())
    mark["source_digest"] = "doctored"
    autotune.save_profile(mark, marker)
    assert autotune.warm_boot_ready(path, device="cpu") is False  # stale marker

    autotune.mark_prewarmed(path, device="cpu")
    prof = autotune.load_profile(path)
    prof["cuda_version"] = "0.0"
    autotune.save_profile(prof, path)
    assert autotune.warm_boot_ready(path, device="cpu") is False  # stale profile

    autotune.prewarm_marker_path(path).write_text("{garbage")
    assert autotune.warm_boot_ready(path, device="cpu") is False


def test_profile_lives_in_the_build_directory():
    assert autotune.default_profile_path().parent == MK.BUILD_DIR
    assert autotune.prewarm_marker_path().parent == MK.BUILD_DIR


def test_save_profile_tmp_is_per_writer_and_cleaned(monkeypatch, tmp_path):
    path = tmp_path / "profile.json"
    autotune.save_profile({"version": 1}, path)
    assert list(tmp_path.glob("*.tmp")) == []
    seen = {}

    def fail_replace(src, dst):
        seen["src"] = str(src)
        raise OSError("disk full")

    monkeypatch.setattr(autotune.os, "replace", fail_replace)
    with pytest.raises(OSError):
        autotune.save_profile({"version": 1}, path)
    assert f".{os.getpid()}.tmp" in seen["src"]
    assert list(tmp_path.glob("*.tmp")) == []


# -- profile schema: golden sync and seeded violations -------------------------


def test_schema_matches_golden():
    assert autotune.compare_profile_schema(GOLDEN, autotune.profile_schema()) == []


def _violations():
    def removed(cur):
        cur["fields"].remove("timings")

    def reordered(cur):
        cur["fields"][0], cur["fields"][1] = cur["fields"][1], cur["fields"][0]

    def required_without_bump(cur):
        cur["fields"].append("new_field")
        cur["required"].append("new_field")

    def regressed(cur):
        cur["version"] = 0

    return [removed, reordered, required_without_bump, regressed]


@pytest.mark.parametrize("violate", _violations(), ids=lambda f: f.__name__)
def test_schema_violation_detected(violate):
    cur = autotune.profile_schema()
    violate(cur)
    assert autotune.compare_profile_schema(GOLDEN, cur)


def test_schema_append_and_bumped_requirement_allowed():
    cur = autotune.profile_schema()
    cur["fields"].append("new_optional_field")
    assert autotune.compare_profile_schema(GOLDEN, cur) == []
    cur["required"].append("new_optional_field")
    cur["version"] += 1
    assert autotune.compare_profile_schema(GOLDEN, cur) == []


# -- KernelConfig routing ------------------------------------------------------


@pytest.mark.parametrize(
    "field,value",
    [("fp2_fusion", False), ("pallas", False), ("ceremony_straus", False), ("ceremony_msm_w8", False)],
)
def test_apply_raises_for_a_value_without_a_route(field, value):
    """No route means no silent ignore: apply() raises and changes
    nothing."""
    KernelConfig(mxu_mont=True).apply()
    with pytest.raises(autotune.UnroutableConfigError, match=field):
        KernelConfig(mxu_mont=False, msm=False, **{field: value}).apply()
    assert L._mxu_active(L.FP) and MSM.msm_active()


def test_apply_flip_takes_effect_on_next_call(monkeypatch):
    """The port routes at call time: no caches to drop between flips."""
    calls = []
    for name in ("mont_mul_plain", "mont_mul_mxu_plain"):
        def spy(*args, _fn=getattr(MK, name), _name=name):
            calls.append(_name)
            return _fn(*args)

        monkeypatch.setattr(MK, name, spy)
    a = torch.as_tensor(L.pack_mont_host(L.FP, [3, 5]))
    want = L.mont_mul(L.FP, a, a)
    assert KernelConfig(mxu_mont=True).apply() is True
    got = L.mont_mul(L.FP, a, a)
    KernelConfig().apply()
    again = L.mont_mul(L.FP, a, a)
    assert calls == ["mont_mul_plain", "mont_mul_mxu_plain", "mont_mul_plain"]
    assert torch.equal(got, want) and torch.equal(again, want)


def test_ops_ignore_env(monkeypatch):
    monkeypatch.setenv("CHARON_MXU_MONT", "1")
    monkeypatch.setenv("CHARON_MSM", "0")
    L.set_mxu(None)
    MSM.set_msm(None)
    assert L._mxu_active(L.FP) is False and MSM.msm_active() is True


def test_env_overrides_parse_and_apply_env():
    env = {"CHARON_MSM": "0", "CHARON_MXU_MONT": "1"}
    assert autotune.env_overrides(env) == {"msm": False, "mxu_mont": True}
    assert autotune.env_overrides({}) == {}
    cfg = autotune.apply_env(env)
    assert cfg.msm is False and cfg.mxu_mont is True
    assert MSM.msm_active() is False and L._mxu_active(L.FP)


def test_candidates_cover_every_axis():
    """msm and mxu_mont bench on the card; the axes with no route in the
    port are registered as inapplicable."""
    assert set(autotune.CANDIDATES) == set(KernelConfig.TUNABLE)
    applicable = {f for f, c in autotune.CANDIDATES.items() if c.applicable()}
    assert applicable == {"msm", "mxu_mont"}
    with pytest.raises(ValueError):
        autotune.register_candidate(autotune.Candidate("pallas", "", lambda: True, lambda n, d: None))


def _fake_candidate(field, seconds, ran):
    """A candidate whose bench kernel just sleeps: `seconds[value]`."""
    import time

    def builder(lanes, device):
        value = getattr(L, "_MXU_MODE") if field == "mxu_mont" else MSM._MSM_MODE
        ran.append((field, lanes, value))
        return lambda: time.sleep(seconds[value])

    return autotune.Candidate(field, "fake", lambda: True, builder)


def test_micro_bench_picks_the_faster_value_greedily():
    ran = []
    cands = {
        "msm": _fake_candidate("msm", {True: 0.02, False: 0.0}, ran),
        "mxu_mont": _fake_candidate("mxu_mont", {True: 0.0, False: 0.02}, ran),
        "fp2_fusion": autotune.CANDIDATES["fp2_fusion"],
    }
    log = []
    choices, timings, runs = autotune.micro_bench(cands, lanes=8, reps=2, observer=make_obs(log), device="cpu")
    assert choices == {"msm": (False, "tuned"), "mxu_mont": (True, "tuned"), "fp2_fusion": (True, "inapplicable")}
    assert runs == 4 and set(timings) == {"msm", "mxu_mont"}
    assert timings["mxu_mont"]["on"] < timings["mxu_mont"]["off"]
    assert ran == [("msm", 8, True), ("msm", 8, False), ("mxu_mont", 8, True), ("mxu_mont", 8, False)]
    # the msm winner is carried into the mxu_mont trials
    assert MSM.msm_active() is False
    assert [f["axis"] for k, f in log if k == "bench"] == ["msm", "msm", "mxu_mont", "mxu_mont"]


def test_micro_bench_keeps_the_default_when_the_win_is_within_the_spread():
    """A value that is faster by less than the spread between runs does
    not replace the default: noise is not persisted."""
    import itertools
    import time

    def builder(lanes, device):
        if L._MXU_MODE:
            return lambda: time.sleep(0.008)
        slow = itertools.cycle([0.010, 0.040])
        return lambda: time.sleep(next(slow))

    cands = {"mxu_mont": autotune.Candidate("mxu_mont", "fake", lambda: True, builder)}
    choices, timings, _ = autotune.micro_bench(cands, lanes=8, reps=4, device="cpu")
    assert timings["mxu_mont"]["on"] < timings["mxu_mont"]["off"]
    assert timings["mxu_mont"]["spread"] > timings["mxu_mont"]["off"] - timings["mxu_mont"]["on"]
    assert choices["mxu_mont"] == (False, "tuned")
    assert not L._mxu_active(L.FP)


@pytest.mark.parametrize("mxu_mont", [False, True])
def test_mxu_mont_bench_runs_the_kernels_the_axis_reroutes(monkeypatch, mxu_mont):
    """The mxu_mont bench is the duty's ladder step over G2 and G1 points:
    it reaches the Fp product and the Fp2 multiply and square of the
    configuration in force (their plain versions on CPU tensors)."""
    names = ["mont_mul_plain", "fp2_mul_plain", "fp2_sqr_plain"]
    names = [n.replace("_plain", "_mxu_plain") for n in names] if mxu_mont else names
    calls = {}
    for name in names:
        def spy(*args, _fn=getattr(MK, name), _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args)

        monkeypatch.setattr(MK, name, spy)
    KernelConfig(mxu_mont=mxu_mont).apply()
    autotune.CANDIDATES["mxu_mont"].builder(3, torch.device("cpu"))()
    assert set(calls) == set(names)


def test_aot_prewarm_walks_the_lane_ladder():
    ran = []
    cands = {"mxu_mont": _fake_candidate("mxu_mont", {True: 0.0, False: 0.0}, ran),
             "ceremony_straus": autotune.CANDIDATES["ceremony_straus"]}
    report = autotune.aot_prewarm(KernelConfig(mxu_mont=True), lanes=(3, 16), candidates=cands, device="cpu")
    assert [(axis, lanes) for axis, lanes, _ in report] == [("mxu_mont", 4), ("mxu_mont", 16)]
    assert ran == [("mxu_mont", 3, True), ("mxu_mont", 16, True)]
