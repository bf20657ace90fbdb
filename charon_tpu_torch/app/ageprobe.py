"""The main path's loop steps, and a probe of a process's host cost as it ages.

Each loop body of the main path issues hundreds of small torch ops and
kernel launches over the same shapes on every step, and the card sits idle
most of each step (PERF.md section 5), so a step's wall is the host's cost
of its launches. A process whose host cost per launch grows as it ages
shows it in these steps first. loop_steps() builds four of them over one
batch of G2 points:

  * one step of the G2 [r]P ladder of the host decode's subgroup check
    (double, add, select);
  * one step of the device decode's G2 sqrt chain (an Fp2 square, then an
    Fp2 multiply: one K3 and one K2, or K6 and K5 under the int8 route);
  * one step of its static psi ladder (a G2 double);
  * one step of the final exponentiation's x-chain over 9 lanes (an Fp12
    cyclotomic square and multiply).

AgeProbe times each step untraced, after one warm step, over at least
`reps` steps and `min_seconds`: the median of the host clock and, on a
card, of CUDA events around each step ended by a device sync, and the
calling thread's CPU clock over all of them a step (that clock may tick in
10 ms on a host, hence the long run; it counts a sync's spin too). Beside
that it reads the process: gc's counts, the collections and the seconds
spent in them since the last probe (gc.callbacks), the objects gc tracks,
the resident set, the caching allocator's allocated and reserved bytes and
its allocation retries, the live threads, and each step's kernel launches
and aligning copies (ops/mont_kernels.py's counts, as deltas). The thread's
CPU clock moves with the host work a step does, its wall also with the
load of other processes on the host's cores. profile() runs each step
under cProfile and reports its calls, the torch ops among them and the
host seconds per op and per launch.
"""

from __future__ import annotations

import cProfile
import gc
import os
import pstats
import statistics
import threading
import time

import torch

from charon_tpu_torch.ops import curve as C
from charon_tpu_torch.ops import fptower as T
from charon_tpu_torch.ops import limb
from charon_tpu_torch.ops import mont_kernels as MK

SQRT_STEP = "g2_sqrt_chain_step"


def loop_steps(engine, sigs) -> list:
    """[(name, step)] of the four loop bodies over the compressed G2
    signatures `sigs`, decompressed on `engine`; each name ends in its lane
    count."""
    f2 = C.g2_ops(engine.ctx)
    points, _ = engine.decompress_g2_batch(list(sigs))
    proj = C.affine_to_point(f2, C.g2_pack(engine.ctx, points, engine.device))
    f12 = T.fp12_one(engine.ctx, (9,), engine.device)
    live = torch.ones(len(points), dtype=torch.bool, device=engine.device)

    def ladder_step():
        acc = C.point_double(f2, proj)
        return C.point_select(f2, live, C.point_add(f2, acc, proj), acc)

    def sqrt_chain_step():
        return T.fp2_mul(engine.ctx, T.fp2_sqr(engine.ctx, proj[0]), proj[1])

    def psi_ladder_step():
        return C.point_double(f2, proj)

    def chain_step():
        return T.fp12_mul(engine.ctx, T.fp12_cyclotomic_sqr(engine.ctx, f12), f12)

    n = len(points)
    return [
        (f"g2_ladder_step_x{n}", ladder_step),
        (f"{SQRT_STEP}_x{n}", sqrt_chain_step),
        (f"psi_ladder_step_x{n}", psi_ladder_step),
        ("final_exp_chain_step_x9", chain_step),
    ]


def sqrt_step_kernels(ctx, device) -> dict:
    """The launches of one sqrt-chain step on `device` under the route in
    force: one Fp2 square and one Fp2 multiply, fused (K3 and K2, or K6 and
    K5 under the int8 route) or, with fusion off, one Montgomery product
    launch each (K1 Fp, or K4 Fp). Nothing on the CPU, where a wrapper
    takes its plain version."""
    if torch.device(device).type != "cuda":
        return {}
    mxu = limb._mxu_active(ctx)
    if not T._FP2_FUSION:
        return {f"{'mont_mul_mxu' if mxu else 'mont_mul'}_{ctx.name}": 2}
    return {"fp2_sqr_mxu": 1, "fp2_mul_mxu": 1} if mxu else {"fp2_sqr": 1, "fp2_mul": 1}


def check_step_launches(name: str, launches: dict, want: dict) -> None:
    """Raise unless a step launched exactly the kernels of `want`, as many
    times each (zero counts ignored)."""
    got = {k: v for k, v in launches.items() if v}
    if got != want:
        raise AssertionError(f"{name}: launches a step {got}, want {want}")


def _counts() -> tuple[dict, dict]:
    with MK._COUNT_LOCK:
        return dict(MK.LAUNCHES), dict(MK.ALIGN_COPIES)


def _per_step(after: dict, before: dict, reps: int) -> dict:
    return {k: (after[k] - before[k]) / reps for k in after if after[k] != before[k]}


def rss_mib() -> float:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**20


class AgeProbe:
    """Times the loop steps and reads the process at each probe() (see the
    module docstring). Holds a gc callback until close()."""

    def __init__(self, steps: list, device, ctx=None, reps: int = 20, min_seconds: float = 0.5):
        self.steps = steps
        self.device = torch.device(device)
        self.ctx = ctx or limb.FP
        self.reps = reps
        self.min_seconds = min_seconds
        self._gc_start = 0.0
        self._gc_seconds = 0.0
        self._gc_runs = [0, 0, 0]
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_start = time.perf_counter()
        else:
            self._gc_seconds += time.perf_counter() - self._gc_start
            self._gc_runs[info["generation"]] += 1

    def close(self) -> None:
        if self._on_gc in gc.callbacks:
            gc.callbacks.remove(self._on_gc)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _time_step(self, name: str, step) -> dict:
        cuda = self.device.type == "cuda"
        step()
        self._sync()
        walls, events = [], []
        before, copies_before = _counts()
        t_start, c_start = time.perf_counter(), time.thread_time()
        while len(walls) < self.reps or time.perf_counter() - t_start < self.min_seconds:
            if cuda:
                events.append((torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)))
                events[-1][0].record()
            t0 = time.perf_counter()
            step()
            if cuda:
                events[-1][1].record()
            self._sync()
            walls.append(time.perf_counter() - t0)
        cpu = time.thread_time() - c_start
        after, copies_after = _counts()
        reps = len(walls)
        launches = _per_step(after, before, reps)
        if name.startswith(SQRT_STEP):
            check_step_launches(name, launches, sqrt_step_kernels(self.ctx, self.device))
        return {
            "reps": reps,
            "wall_ms": statistics.median(walls) * 1e3,
            "cpu_ms": cpu / reps * 1e3,
            "device_ms": statistics.median(a.elapsed_time(b) for a, b in events) if cuda else None,
            "launches": launches,
            "align_copies": _per_step(copies_after, copies_before, reps),
        }

    def probe(self, label: str) -> dict:
        """Every step timed, and the process read; the gc seconds and
        collections are those since the last probe (or since the probe was
        made)."""
        with torch.inference_mode():
            steps = {name: self._time_step(name, step) for name, step in self.steps}
        gc_seconds, self._gc_seconds = self._gc_seconds, 0.0
        gc_runs, self._gc_runs = self._gc_runs, [0, 0, 0]
        out = {
            "label": label,
            "steps": steps,
            "gc_count": list(gc.get_count()),
            "gc_collections": gc_runs,
            "gc_seconds": gc_seconds,
            "gc_objects": len(gc.get_objects()),
            "rss_mib": rss_mib(),
            "threads": threading.active_count(),
            "allocated_mib": None,
            "reserved_mib": None,
            "alloc_retries": None,
        }
        if self.device.type == "cuda":
            stats = torch.cuda.memory_stats(self.device)
            out["allocated_mib"] = stats.get("allocated_bytes.all.current", 0) / 2**20
            out["reserved_mib"] = stats.get("reserved_bytes.all.current", 0) / 2**20
            out["alloc_retries"] = stats.get("num_alloc_retries", 0)
        return out

    def profile(self, reps: int = 5, top: int = 8) -> dict:
        """Each step under cProfile, `reps` steps after one warm step: per
        step its Python-level calls, the torch ops among them (the
        functions of torch's C extension), the seconds under the profiler,
        the host seconds per torch op and per launch, and the `top`
        functions by their own time ([name, calls a step, ms a step])."""
        out = {}
        with torch.inference_mode():
            for name, step in self.steps:
                step()
                self._sync()
                before, _ = _counts()
                prof = cProfile.Profile()
                prof.enable()
                for _ in range(reps):
                    step()
                self._sync()
                prof.disable()
                after, _ = _counts()
                launches = sum(_per_step(after, before, reps).values())
                stats = pstats.Stats(prof).stats
                calls = sum(nc for _, nc, _, _, _ in stats.values()) / reps
                ops = {k: v for k, v in stats.items() if k[0] == "~" and "torch" in k[2]}
                op_calls = sum(nc for _, nc, _, _, _ in ops.values()) / reps
                seconds = sum(tt for _, _, tt, _, _ in stats.values()) / reps
                rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
                out[name] = {
                    "calls": calls,
                    "torch_ops": op_calls,
                    "ms": seconds * 1e3,
                    "us_per_op": seconds / op_calls * 1e6 if op_calls else None,
                    "us_per_launch": seconds / launches * 1e6 if launches else None,
                    "top": [[f"{k[0].rsplit('/', 1)[-1]}:{k[1]}:{k[2]}"[:80], v[1] / reps, v[2] / reps * 1e3]
                            for k, v in rows],
                }
        return out
