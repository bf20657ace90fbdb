"""Startup kernel tuner: typed kernel routing, micro-benches on the card,
and a persisted profile.

The port of charon_tpu/core/autotune.py.

  * `KernelConfig` is the one source of truth for kernel routing.
    `apply()` pushes it into the port's call-time dispatch flags
    (`ops/msm.set_msm`, `set_ceremony_straus`, `set_ceremony_window`,
    `ops/limb.set_mxu`, `ops/fptower.set_fp2_fusion`). The port routes at
    call time, so a flip takes
    effect on the next call; there are no compiled-kernel
    caches to drop. An axis the port has no route for yet accepts only its
    default, and `apply()` raises `UnroutableConfigError` for any other
    value. The `CHARON_MSM` / `CHARON_MXU_MONT` deploy pins fold in as
    explicit overrides (`env_overrides`) that outrank the tuned profile;
    the ops never read the environment.

  * `resolve()` is the startup tuner. It micro-benches each applicable
    boot axis (`boot_candidates()`; fp2_fusion is benched only on request)
    on the card at the lane count the caller reads from its
    duty, keeps an axis's default unless another value wins by more than
    the spread between repeated runs, and persists the profile (JSON,
    schema-versioned, keyed by platform, torch and CUDA versions, the
    device's compute capability and a digest of the port's kernel sources)
    in `charon_tpu_torch/_build/`. A later boot with the same key loads it
    and benches nothing; a changed key re-tunes.

  * `aot_prewarm()` builds the kernels with nvcc and launches the chosen
    variants over the prewarm lane ladder, so the first duty pays neither
    the build nor first-launch costs.

Entry points run on the card unless the caller passes device="cpu". With
no card, "auto" skips loudly to the defaults and "on"/"force" raise
PlaneConfigError. Every duration here is taken with the monotonic clock.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import platform
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import torch

from charon_tpu_torch.core.cryptoplane import PlaneConfigError, kernel_inventory

log = logging.getLogger("charon_tpu_torch")

_PKG = Path(__file__).resolve().parent.parent

# Canonical micro-bench / prewarm shapes: the blsops bucket ladder. A
# caller that knows its duty passes the duty's lane count instead of
# TUNE_LANES; at 8 lanes every bench is a few launches of host work.
TUNE_LANES = 8
TUNE_REPS = 5
# the bucket shapes of parallel.mesh.SlotCryptoPlane.PREWARM_VERIFY_LANES
PREWARM_LANES = (4, 16, 64, 256)

PROFILE_VERSION = 1
PROFILE_BASENAME = "autotune_profile.json"
# written by mark_prewarmed() after a prewarm completed; warm_boot_ready
# requires it beside a fresh profile
PREWARM_MARKER_BASENAME = "prewarm_complete.json"
# Append-only field ledger: existing fields never move or vanish, new
# fields append, and a new field joins PROFILE_REQUIRED only together
# with a version bump. tests/test_torch_autotune.py holds the blessed
# snapshot and gates the contract.
PROFILE_FIELDS = (
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
)
PROFILE_REQUIRED = (
    "version",
    "platform",
    "torch_version",
    "cuda_version",
    "capability",
    "source_digest",
    "config",
)
# the fingerprint keys a profile must match to be trusted
_STALENESS_KEYS = ("platform", "torch_version", "cuda_version", "capability", "source_digest")

# Deploy pins, folded in as explicit KernelConfig overrides that outrank
# the tuned profile.
_ENV_TOGGLES = (
    ("CHARON_MSM", "msm", lambda v: v != "0"),
    ("CHARON_MXU_MONT", "mxu_mont", lambda v: v == "1"),
)
_ENV_WARNED = False


class UnroutableConfigError(PlaneConfigError):
    """A KernelConfig value the port has no route for yet."""


class ProfileError(ValueError):
    """A kernel profile that cannot be used; the resolver re-tunes.

    `reason` is one of: missing | unreadable | corrupt | schema | version.
    """

    def __init__(self, reason: str, msg: str):
        super().__init__(msg)
        self.reason = reason


@dataclass(frozen=True)
class KernelConfig:
    """Typed kernel-routing choice: what the tuner, the env overrides and
    the callers all resolve into. Fields and defaults are the reference's.
    """

    msm: bool = True  # Straus joint windowed mul in threshold recombine
    mxu_mont: bool = False  # int8 tensor-core Montgomery products (K4-K6)
    fp2_fusion: bool = True  # fused Fp2 kernels K2/K3 (K5/K6), else the unfused route
    pallas: bool | None = None  # hand-written kernels (the port's one path)
    ceremony_straus: bool = True  # Straus vs per-lane in commitment eval
    ceremony_msm_w8: bool = True  # Pippenger window 8 (else 4) in g1_msm

    # the axes resolve()/micro_bench() may tune (bool-valued)
    TUNABLE = (
        "msm",
        "mxu_mont",
        "fp2_fusion",
        "ceremony_straus",
        "ceremony_msm_w8",
    )
    # axis -> the values the port can route today; any other raises
    ROUTABLE = {
        "fp2_fusion": (True, False),
        "pallas": (None, True),
        "ceremony_straus": (True, False),
        "ceremony_msm_w8": (True, False),
    }

    def apply(self) -> bool:
        """Push this config into the call-time dispatch flags. Raises
        UnroutableConfigError, before changing anything, for a value the
        port cannot route. Returns True (the reference returns False on
        hosts without its device stack; torch is always there)."""
        bad = {f: getattr(self, f) for f, ok in self.ROUTABLE.items() if getattr(self, f) not in ok}
        if bad:
            raise UnroutableConfigError(f"the port has no kernel route for {bad}")
        from charon_tpu_torch.ops import fptower, limb
        from charon_tpu_torch.ops import msm as MSM

        MSM.set_msm(self.msm)
        MSM.set_ceremony_straus(self.ceremony_straus)
        MSM.set_ceremony_window(8 if self.ceremony_msm_w8 else 4)
        limb.set_mxu(self.mxu_mont)
        fptower.set_fp2_fusion(self.fp2_fusion)
        return True

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclass(frozen=True)
class Candidate:
    """One tunable axis: whether it applies to the port and how to
    micro-bench a value for it. `builder(lanes, device)` returns a zero-arg
    closure that runs one dispatch of a kernel dominated by this axis and
    waits for the device."""

    field: str
    doc: str
    applicable: Callable[[], bool]
    builder: Callable[[int, torch.device], Callable[[], None]]
    values: tuple = (True, False)
    # benched by a boot's resolve() and prewarmed by aot_prewarm() when the
    # caller names no candidates; an axis that is not is benched only on
    # request (candidates={field: ...}) and keeps its default otherwise
    at_boot: bool = True


@dataclass(frozen=True)
class TuneResult:
    """What `resolve()` decided and why."""

    config: KernelConfig
    outcome: str  # hit | tuned | off | skipped
    applied: bool
    bench_runs: int  # 0 on a pure profile load
    sources: dict  # axis -> profile|tuned|env|default|inapplicable
    timings: dict  # axis -> {"on"/"off": best seconds, "spread": seconds}
    overrides: dict  # env-derived field overrides in force
    profile_path: str | None


def env_overrides(environ=None) -> dict:
    """Explicit KernelConfig overrides from the deploy pins, ranked above
    the tuned profile: an operator's pin must not be undone by the tuner."""
    env = os.environ if environ is None else environ
    out = {}
    for var, field, decode in _ENV_TOGGLES:
        if var in env:
            out[field] = decode(env[var])
    return out


def apply_env(environ=None) -> KernelConfig:
    """Defaults + env overrides, applied: the entry point for harnesses
    that pin kernels by env instead of running the tuner."""
    cfg = dataclasses.replace(KernelConfig(), **env_overrides(environ))
    cfg.apply()
    return cfg


# ---------------------------------------------------------------------------
# Candidate axes and their micro-bench kernels
# ---------------------------------------------------------------------------


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _recombine_builder(lanes: int, device: torch.device, t: int = 3) -> Callable[[], None]:
    """Threshold recombination burst: the kernel whose routing the msm
    axis decides (blsops.threshold_recombine: Straus joint windowed mul vs
    per-lane double-and-add)."""
    from charon_tpu_torch.crypto.g1g2 import G2_GEN
    from charon_tpu_torch.ops import blsops, limb
    from charon_tpu_torch.ops import curve as C

    n = blsops.bucket_lanes(lanes)
    sig = C.g2_pack(limb.FP, [G2_GEN] * (n * t), device)
    sig = C.map_point(lambda a: a.reshape(n, t, *a.shape[1:]), sig)
    idx = torch.arange(1, t + 1, device=device).repeat(n, 1)

    def run() -> None:
        with torch.inference_mode():
            blsops.threshold_recombine(limb.FP, limb.FR, t, sig, idx)
        _sync(device)

    return run


def _ladder_step_builder(lanes: int, device: torch.device) -> Callable[[], None]:
    """One step of the duty's subgroup-check ladders over `lanes` G2 and
    `lanes` G1 points: the loop bodies whose stacked Montgomery products
    the mxu_mont axis reroutes (K1-K3 vs K4-K6), so the kernels see the
    row counts a duty of `lanes` partials sends them."""
    from charon_tpu_torch.crypto.g1g2 import G1_GEN, G2_GEN
    from charon_tpu_torch.ops import blsops, limb
    from charon_tpu_torch.ops import curve as C

    n = blsops.bucket_lanes(lanes)
    steps = []
    for ops, pack, gen in ((C.g2_ops, C.g2_pack, G2_GEN), (C.g1_ops, C.g1_pack, G1_GEN)):
        f = ops(limb.FP)
        steps.append((f, C.affine_to_point(f, pack(limb.FP, [gen] * n, device))))
    bit = torch.ones(n, dtype=torch.bool, device=device)

    def run() -> None:
        with torch.inference_mode():
            for f, p in steps:
                acc = C.point_double(f, p)
                C.point_select(f, bit, C.point_add(f, acc, p), acc)
        _sync(device)

    return run


def _fp2_batch_builder(lanes: int, device: torch.device) -> Callable[[], None]:
    """One stacked Fp2 level (two muls and two squares) at `lanes`: the
    level the fp2_fusion axis routes (fptower.fp2_batch: the fused K2/K3
    kernels, or the unfused route's stacked normalizes around one K1
    product), as the reference's _fp2_batch_builder."""
    from charon_tpu_torch.ops import blsops, fptower, limb

    n = blsops.bucket_lanes(lanes)
    a = limb.to_device(limb.pack_mont_host(limb.FP, [i + 1 for i in range(n)]), device)
    e = (a, a)

    def run() -> None:
        with torch.inference_mode():
            fptower.fp2_batch(limb.FP, [("mul", e, e), ("sqr", e), ("mul", e, e), ("sqr", e)])
        _sync(device)

    return run


def _ceremony_eval_builder(lanes: int, device: torch.device, t: int = 3) -> Callable[[], None]:
    """DKG commitment-polynomial evaluation wave: the program the
    ceremony_straus axis routes (blsops.commitment_eval: Straus joint
    windowed mul vs per-lane double-and-add and a fold)."""
    from charon_tpu_torch.crypto.g1g2 import G1_GEN
    from charon_tpu_torch.ops import blsops, limb
    from charon_tpu_torch.ops import curve as C

    n = blsops.bucket_lanes(lanes)
    commits = C.map_point(lambda a: a.reshape(n, t, -1), C.g1_pack(limb.FP, [G1_GEN] * (n * t), device))
    xs = torch.arange(1, n + 1, device=device)

    def run() -> None:
        with torch.inference_mode():
            blsops.commitment_eval(limb.FP, limb.FR, 1, t, 32, commits, xs)
        _sync(device)

    return run


def _ceremony_msm_builder(lanes: int, device: torch.device) -> Callable[[], None]:
    """Segmented G1 MSM burst: the program whose Pippenger window the
    ceremony_msm_w8 axis sizes (blsops.g1_msm, window 8 vs 4)."""
    from charon_tpu_torch.crypto.g1g2 import G1_GEN
    from charon_tpu_torch.ops import blsops, limb
    from charon_tpu_torch.ops import curve as C

    n = blsops.bucket_lanes(lanes)
    pts = C.g1_pack(limb.FP, [G1_GEN] * n, device)
    scalars = limb.to_device(limb.ctx_pack(limb.FR, [i + 1 for i in range(n)]), device)
    seg = torch.zeros(n, dtype=torch.int64, device=device)

    def run() -> None:
        with torch.inference_mode():
            blsops.g1_msm(limb.FP, limb.FR, 1, 255, pts, scalars, seg)
        _sync(device)

    return run


def _always() -> bool:
    return True


CANDIDATES: dict[str, Candidate] = {}


def boot_candidates() -> dict[str, Candidate]:
    """The axes a boot benches and prewarms: CANDIDATES less those
    registered with at_boot=False."""
    return {f: c for f, c in CANDIDATES.items() if c.at_boot}


def register_candidate(cand: Candidate) -> None:
    """Register a tunable axis (idempotent by field name)."""
    if cand.field not in KernelConfig.TUNABLE:
        raise ValueError(
            f"candidate field {cand.field!r} is not a tunable "
            f"KernelConfig axis {KernelConfig.TUNABLE}"
        )
    CANDIDATES[cand.field] = cand


register_candidate(Candidate(
    field="msm",
    doc="Straus joint windowed mul vs per-lane double-and-add",
    applicable=_always,
    builder=_recombine_builder,
))
register_candidate(Candidate(
    field="mxu_mont",
    doc="int8 tensor-core Montgomery product (K4) vs K1",
    applicable=_always,
    builder=_ladder_step_builder,
))
# Applicable wherever the kernels run: on the card always; on the CPU the
# two routes' plain versions stand in, as for mxu_mont. Not benched at a
# boot: on the H100 the fused level won at every size measured, by 5-13x
# (PERF.md section 6), so a boot keeps fusion on without paying the bench.
register_candidate(Candidate(
    field="fp2_fusion",
    doc="fused Fp2 kernels (K2/K3) vs the unfused stacked level around K1",
    applicable=_always,
    builder=_fp2_batch_builder,
    at_boot=False,
))
register_candidate(Candidate(
    field="ceremony_straus",
    doc="Straus joint mul vs per-lane in DKG commitment eval",
    applicable=_always,
    builder=_ceremony_eval_builder,
))
register_candidate(Candidate(
    field="ceremony_msm_w8",
    doc="Pippenger window 8 vs 4 in the ceremony segmented G1 MSM",
    applicable=_always,
    builder=_ceremony_msm_builder,
))


def _label(value) -> str:
    if value is True:
        return "on"
    if value is False:
        return "off"
    return str(value)


def _resolve_device(device) -> torch.device:
    """None means the card; a CPU tune must be asked for explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise PlaneConfigError("no CUDA device: the kernel tuner benches on the card")
    return dev


def micro_bench(
    candidates=None,
    lanes: int = TUNE_LANES,
    reps: int = TUNE_REPS,
    base: KernelConfig | None = None,
    observer=None,
    device=None,
):
    """Greedily tune each applicable candidate axis: apply the value, build
    the axis's bench kernel at `lanes`, time `reps` dispatches, carry the
    winner into the next axis's baseline. Another value replaces the
    axis's baseline value only when its best time beats the baseline's by
    more than the spread (slowest minus fastest run) of any value: a
    smaller win is noise, and the tuner must not persist noise.

    Returns (choices, timings, bench_runs) where choices maps field ->
    (winning value, source), source is "tuned" or "inapplicable", and
    timings maps field -> {value label: best seconds, "spread": seconds}.
    """
    obs = observer or (lambda kind, **fields: None)
    dev = _resolve_device(device)
    cfg = base or KernelConfig()
    choices: dict = {}
    timings: dict = {}
    bench_runs = 0
    for field, cand in (candidates or boot_candidates()).items():
        if not cand.applicable():
            choices[field] = (getattr(cfg, field), "inapplicable")
            continue
        per_value: dict = {}
        spread = 0.0
        for value in cand.values:
            trial = dataclasses.replace(cfg, **{field: value})
            trial.apply()
            run = cand.builder(lanes, dev)
            run()  # build the kernels and warm up
            runs = [_timed(run) for _ in range(max(1, reps))]
            per_value[_label(value)] = min(runs)
            spread = max(spread, max(runs) - min(runs))
            bench_runs += 1
            obs("bench", axis=field, choice=_label(value), seconds=min(runs))
        base_value = getattr(cfg, field)
        fastest = min(cand.values, key=lambda v: per_value[_label(v)])
        win = fastest if per_value[_label(base_value)] - per_value[_label(fastest)] > spread else base_value
        cfg = dataclasses.replace(cfg, **{field: win})
        choices[field] = (win, "tuned")
        timings[field] = {**per_value, "spread": spread}
    return choices, timings, bench_runs


def _timed(run: Callable[[], None]) -> float:
    t0 = time.perf_counter()
    run()
    return time.perf_counter() - t0


def aot_prewarm(
    config: KernelConfig | None = None,
    lanes=PREWARM_LANES,
    candidates=None,
    observer=None,
    device=None,
) -> list[tuple[str, int, float]]:
    """Build the kernels (nvcc, on the card) and launch the chosen variants
    across the prewarm lane ladder. Returns [(axis, bucket_lanes, seconds)]."""
    from charon_tpu_torch.ops import blsops
    from charon_tpu_torch.ops import mont_kernels as MK

    obs = observer or (lambda kind, **fields: None)
    dev = _resolve_device(device)
    if config is not None:
        config.apply()
    if dev.type == "cuda":
        MK.build()
    report = []
    for field, cand in (candidates or boot_candidates()).items():
        if not cand.applicable():
            continue
        for n in lanes:
            t0 = time.perf_counter()
            cand.builder(n, dev)()
            dt = time.perf_counter() - t0
            bucket = blsops.bucket_lanes(n)
            report.append((field, bucket, dt))
            obs("prewarm", axis=field, lanes=bucket, seconds=dt)
    return report


# ---------------------------------------------------------------------------
# Profile persistence
# ---------------------------------------------------------------------------


def profile_schema() -> dict:
    """Current profile schema snapshot (compare_profile_schema gates it
    against the blessed copy)."""
    return {
        "version": PROFILE_VERSION,
        "fields": list(PROFILE_FIELDS),
        "required": list(PROFILE_REQUIRED),
    }


def compare_profile_schema(golden: dict, current: dict) -> list[str]:
    """Append-only contract between profile writers and readers: a
    non-empty return is the failure message."""
    errs: list[str] = []
    gv, cv = int(golden["version"]), int(current["version"])
    if cv < gv:
        errs.append(f"profile schema version regressed: {gv} -> {cv}")
    gf, cf = list(golden["fields"]), list(current["fields"])
    if cf[: len(gf)] != gf:
        errs.append(f"profile fields removed or reordered (append-only): {gf} -> {cf}")
    added_req = set(current["required"]) - set(golden["required"])
    if added_req and cv == gv:
        errs.append(
            f"new required field(s) {sorted(added_req)} need a schema "
            "version bump (old writers omit them)"
        )
    return errs


def source_digest() -> str:
    """sha256 over the port's ops/*.py and csrc/* (names and bytes): a
    change to any kernel or its routing re-tunes."""
    h = hashlib.sha256()
    for path in sorted((_PKG / "ops").glob("*.py")) + sorted((_PKG / "csrc").glob("*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def fingerprint(device=None) -> dict:
    """The profile staleness key (platform, torch and CUDA versions, the
    device's compute capability, the source digest), plus the
    informational host."""
    dev = _resolve_device(device)
    if dev.type == "cuda":
        major, minor = torch.cuda.get_device_capability(dev)
        capability, host = f"sm_{major}{minor}", torch.cuda.get_device_name(dev)
    else:
        capability, host = None, platform.machine()
    return {
        "platform": dev.type,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "capability": capability,
        "source_digest": source_digest(),
        "host": host,
    }


def default_profile_path() -> Path:
    """Beside the kernel build, in the package's gitignored _build/."""
    return _PKG / "_build" / PROFILE_BASENAME


def load_profile(path) -> dict:
    """Read and validate a persisted profile. Raises ProfileError (typed;
    `reason` attribute), never returns a half-usable dict."""
    p = Path(path)
    try:
        raw = p.read_text()
    except FileNotFoundError:
        raise ProfileError("missing", f"no kernel profile at {p}") from None
    except OSError as e:
        raise ProfileError("unreadable", f"kernel profile {p}: {e}") from e
    try:
        prof = json.loads(raw)
    except ValueError as e:
        raise ProfileError("corrupt", f"kernel profile {p} is not valid JSON: {e}") from e
    if not isinstance(prof, dict):
        raise ProfileError("corrupt", f"kernel profile {p}: not an object")
    missing = [f for f in PROFILE_REQUIRED if f not in prof]
    if missing:
        raise ProfileError("schema", f"kernel profile {p} missing fields {missing}")
    if not isinstance(prof["version"], int) or prof["version"] < 1:
        raise ProfileError("schema", f"kernel profile {p}: bad version {prof['version']!r}")
    if prof["version"] > PROFILE_VERSION:
        raise ProfileError(
            "version",
            f"kernel profile {p} is v{prof['version']} (this build reads <= v{PROFILE_VERSION})",
        )
    cfg = prof["config"]
    known = {f.name for f in dataclasses.fields(KernelConfig)}
    if not isinstance(cfg, dict) or not set(cfg) <= known:
        raise ProfileError("schema", f"kernel profile {p}: bad config block {cfg!r}")
    for k, v in cfg.items():
        if v is not None and not isinstance(v, bool):
            raise ProfileError("schema", f"kernel profile {p}: config.{k}={v!r} not bool")
    return prof


def save_profile(prof: dict, path) -> None:
    """Atomic write (per-writer tmp + rename): a crash mid-save leaves the
    old profile or none, and two writers never share a tmp file."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
    try:
        tmp.write_text(json.dumps(prof, indent=1, sort_keys=True) + "\n")
        os.replace(tmp, p)
    except BaseException:
        try:
            tmp.unlink()
        except OSError:
            pass
        raise


def staleness(prof: dict, fp: dict | None = None) -> str | None:
    """The first fingerprint key a loaded profile disagrees on (None =
    fresh). The host is informational only."""
    fp = fp or fingerprint()
    for key in _STALENESS_KEYS:
        if prof.get(key) != fp[key]:
            return key
    return None


def prewarm_marker_path(path=None) -> Path:
    """The prewarm-completion marker lives beside the profile."""
    p = Path(path) if path else default_profile_path()
    return p.with_name(PREWARM_MARKER_BASENAME)


def mark_prewarmed(path=None, device=None) -> Path:
    """Record that a prewarm completed under the current fingerprint: the
    evidence warm_boot_ready needs beside a fresh profile."""
    m = prewarm_marker_path(path)
    save_profile({"version": PROFILE_VERSION, **fingerprint(device)}, m)
    return m


def _read_marker(m: Path) -> dict | None:
    try:
        d = json.loads(m.read_text())
    except (OSError, ValueError):
        return None
    return d if isinstance(d, dict) else None


def warm_boot_ready(path=None, device=None) -> bool:
    """True when a fresh tuned profile AND a same-fingerprint prewarm
    marker exist. A profile alone is not enough: it proves the tuner ran,
    not that the kernels were built and launched."""
    try:
        fp = fingerprint(device)
        p = Path(path) if path else default_profile_path()
        if staleness(load_profile(p), fp) is not None:
            return False
        mark = _read_marker(prewarm_marker_path(path))
        return mark is not None and staleness(mark, fp) is None
    except (PlaneConfigError, ProfileError, OSError):
        return False


# ---------------------------------------------------------------------------
# The startup resolver
# ---------------------------------------------------------------------------


def resolve(
    mode: str = "auto",
    path=None,
    *,
    observer=None,
    lanes: int = TUNE_LANES,
    reps: int = TUNE_REPS,
    candidates=None,
    bench=None,
    environ=None,
    device=None,
) -> TuneResult:
    """Resolve the kernel config for this boot and APPLY it.

    mode: "off" = defaults + env overrides, no profile IO, no bench;
    "auto"/"on" = load a fresh profile (pure load, zero bench runs) or
    micro-bench and persist one; "force" = always re-tune. Without a card
    (and device not "cpu"), "auto" skips loudly and "on"/"force" raise
    PlaneConfigError.

    `lanes` is the lane count the benches run at: pass the duty's own
    (the partial signatures one duty verifies), so the mxu_mont bench
    sends its kernels the duty's row counts. An axis keeps its default
    unless another value wins by more than the measured spread.

    `observer(kind, **fields)` receives "profile" (event=hit|miss|stale|
    corrupt|rebuilt|off|skipped), "decision" (axis/choice/source), "bench"
    and "prewarm" events. `bench` injects a micro_bench-compatible
    callable (tests).
    """
    global _ENV_WARNED
    if mode not in ("auto", "on", "off", "force"):
        raise PlaneConfigError(f"unknown autotune mode {mode!r}")
    obs = observer or (lambda kind, **fields: None)
    overrides = env_overrides(environ)
    if overrides and not _ENV_WARNED:
        _ENV_WARNED = True
        log.warning(
            "CHARON_MSM/CHARON_MXU_MONT act as KernelConfig overrides that "
            "outrank the tuned profile: %s", dict(sorted(overrides.items())),
        )
    sources = {f: "default" for f in KernelConfig.TUNABLE}

    def untuned(outcome: str) -> TuneResult:
        cfg = dataclasses.replace(KernelConfig(), **overrides)
        applied = cfg.apply()
        sources.update({f: "env" for f in overrides})
        obs("profile", event=outcome)
        _emit_decisions(obs, cfg, sources)
        return TuneResult(
            config=cfg, outcome=outcome, applied=applied, bench_runs=0,
            sources=sources, timings={}, overrides=overrides, profile_path=None,
        )

    if mode == "off":
        return untuned("off")
    try:
        dev = _resolve_device(device)
        fp = fingerprint(dev)
    except PlaneConfigError as e:
        if mode in ("on", "force"):
            raise PlaneConfigError(f"autotune {mode} needs the card: {e}") from e
        log.warning("kernel auto-tune skipped, running KernelConfig defaults: %s", e)
        return untuned("skipped")
    families = sorted(kernel_inventory(dev))

    p = Path(path) if path else default_profile_path()
    prof = None
    if mode != "force":
        try:
            prof = load_profile(p)
        except ProfileError as e:
            if e.reason == "missing":
                obs("profile", event="miss")
            else:
                log.warning("kernel profile %s unusable (%s); re-tuning: %s", p, e.reason, e)
                obs("profile", event="corrupt")
        if prof is not None:
            stale = staleness(prof, fp)
            if stale is not None:
                log.info("kernel profile %s stale (%s); re-tuning", p, stale)
                obs("profile", event="stale")
                prof = None

    timings: dict = {}
    bench_runs = 0
    if prof is not None:
        obs("profile", event="hit")
        outcome = "hit"
        cfg = dataclasses.replace(KernelConfig(), **prof["config"])
        sources.update({f: "profile" for f in KernelConfig.TUNABLE})
        timings = prof.get("timings", {})
    else:
        run_bench = bench or micro_bench
        choices, timings, bench_runs = run_bench(
            candidates=candidates, lanes=lanes, reps=reps,
            base=KernelConfig(), observer=obs, device=dev,
        )
        cfg = dataclasses.replace(KernelConfig(), **{f: v for f, (v, _src) in choices.items()})
        sources.update({f: src for f, (_v, src) in choices.items()})
        prof = dict(
            version=PROFILE_VERSION,
            **fp,
            config=cfg.as_dict(),
            sources={f: sources[f] for f in KernelConfig.TUNABLE},
            timings=timings,
            families=families,
            tune_lanes=lanes,
            prewarm_lanes=list(PREWARM_LANES),
        )
        save_profile(prof, p)
        obs("profile", event="rebuilt")
        outcome = "tuned"

    # deploy-pinned env overrides outrank whatever won above
    cfg = dataclasses.replace(cfg, **overrides)
    sources.update({f: "env" for f in overrides})
    applied = cfg.apply()
    _emit_decisions(obs, cfg, sources)
    return TuneResult(
        config=cfg,
        outcome=outcome,
        applied=applied,
        bench_runs=bench_runs,
        sources=sources,
        timings=timings,
        overrides=overrides,
        profile_path=str(p),
    )


def _emit_decisions(obs, cfg: KernelConfig, sources: dict) -> None:
    for field in KernelConfig.TUNABLE:
        obs("decision", axis=field, choice=_label(getattr(cfg, field)), source=sources.get(field, "default"))
