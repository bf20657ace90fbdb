#!/usr/bin/env python3
"""Drive the PyTorch port (charon_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--validators 1024] [--seed 1] [--workers 8]

Phases, in order; any failure exits non-zero and prints no result:

  1. the card (nvidia-smi name and power limit), torch/CUDA/nvcc versions;
  2. the kernel build from charon_tpu_torch/csrc, one nvcc per source, all
     at once (nvcc -Xptxas -v report: registers, spills), and the count of
     int8 tensor-core (IMMA) instructions in K4-K6's SASS;
  3. every kernel (K1 Fp, K1 Fr, K2, K3, and the int8 tensor-core K4 Fp,
     K4 Fr, K5, K6) against its plain PyTorch version on the same CUDA
     tensors at 8192, 65533 and 65536 rows, on seeded reduced inputs plus
     edge values — exactly equal — and K4-K6 against K1-K3 on the same
     operands; every kernel (all are tiled) also at the edges of its
     tiles and waves (1, 2, 3, 31, 32, 33, a large launch's tile less one,
     the tile and one more, an odd count above one wave of resident
     blocks); each kernel's time (alone: 200 queued launches of its C
     entry point; through its wrapper; plain) beside its bound;
  4. the host setup of the duty (keys, 4-of-7 splits, partials), then the
     startup tuner on the card: autotune.resolve("force") over the
     mxu_mont axis (K1-K3 vs K4-K6) at the duty's lane count, its timings,
     spread and choice;
  5. the int8 configuration's duty at full width: KernelConfig(mxu_mont=
     True).apply(), then a 1k-validator 4-of-7 attestation duty through
     TorchImpl (verify 4096 partials by grouped RLC, a forged lane found by
     the per-lane re-check, Lagrange recombination of 1024 group
     signatures checked against host recombination, verification of the
     group signatures), with each stage's wall time, each kernel's
     launches and the operands copied onto 16-byte words before a launch
     — K4 Fp, K4 Fr, K5 and K6 must launch, K1-K3 never;
  6. the default configuration's duty (KernelConfig()) on the same
     validators — K1-K3 must launch, K4-K6 never;
  7. a torch.profiler trace of two main-path loop bodies under each
     configuration (kernel time, idle share, top kernels);
  8. every kernel timed at the four row counts its duty launched it at
     most often (from mont_kernels.ROWS, the rows-per-launch map filled
     during phases 5-6), each beside its bound;
  9. the kernels JSON line, then the result line.

The script runs only on a CUDA card: without one it exits 2 before doing
anything.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import multiprocessing
import os
import random
import subprocess
import sys
import time

# Peaks of the NVIDIA H100 80GB HBM3 (SXM) at its 700 W power limit
# (NVIDIA's data sheet, dense): HBM rate; the int32
# multiply-add rate, half the 67 TFLOP/s non-tensor fp32 rate, since Hopper
# issues IMAD at half the FFMA rate, a multiply-add counted as two
# operations; and the int8 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
INT8_TC_OPS_PER_S = 1979e12


def _cios(n: int) -> int:
    """Multiply-adds of a CIOS product over n limbs or words: a b, q p,
    and q. K1-K3 take it over Fp's 12 32-bit words, K1 over Fr's 11
    24-bit limbs."""
    return 2 * n * n + n


def _tc(n: int) -> int:
    """int8 multiply-adds of K4's two constant convolutions: four piece
    products over 2n 12-bit halves, into 2n and 4n columns."""
    return 4 * (2 * n) * (2 * n + 4 * n)


# name -> (replaces, source, C function, operands in, operands out, limb
# multiply-adds per element on the CUDA cores, int8 multiply-adds per
# element on the tensor cores)
KERNELS = {
    "mont_mul_fp": ("charon_tpu/ops/pallas_mont.py:482", "mont_mul.cu", "charon_mont_mul", 2, 1, _cios(12), 0),
    "mont_mul_fr": ("charon_tpu/ops/pallas_mont.py:482", "mont_mul.cu", "charon_mont_mul", 2, 1, _cios(11), 0),
    "fp2_mul": ("charon_tpu/ops/pallas_mont.py:466", "fp2.cu", "charon_fp2_mul", 4, 2, 3 * _cios(12), 0),
    "fp2_sqr": ("charon_tpu/ops/pallas_mont.py:475", "fp2.cu", "charon_fp2_sqr", 2, 2, 2 * _cios(12), 0),
    "mont_mul_mxu_fp": ("charon_tpu/ops/pallas_mont.py:264", "mont_mxu.cu", "charon_mont_mul_mxu", 2, 1, 16 * 16, _tc(16)),
    "mont_mul_mxu_fr": ("charon_tpu/ops/pallas_mont.py:264", "mont_mxu.cu", "charon_mont_mul_mxu", 2, 1, 11 * 11, _tc(11)),
    "fp2_mul_mxu": ("charon_tpu/ops/pallas_mont.py:289", "fp2_mxu.cu", "charon_fp2_mul_mxu", 4, 2, 3 * 16 * 16, 3 * _tc(16)),
    "fp2_sqr_mxu": ("charon_tpu/ops/pallas_mont.py:324", "fp2_mxu.cu", "charon_fp2_sqr_mxu", 2, 2, 2 * 16 * 16, 2 * _tc(16)),
}
INT8_KERNELS = tuple(k for k in KERNELS if "_mxu" in k)
DEFAULT_KERNELS = tuple(k for k in KERNELS if "_mxu" not in k)
CHECK_ROWS = (8192, 65533, 65536)
TIMED_ROWS = 65536
DUTY_SHAPES = 4  # row counts a kernel is timed at beyond TIMED_ROWS
DUTY_MESSAGES = 8


_T0 = time.perf_counter()


def log(*parts) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f}s]", *parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0]


# ---------------------------------------------------------------------------
# Phase 3: kernels against plain versions
# ---------------------------------------------------------------------------


def _operands(name, rows, seed, device):
    """Seeded reduced Montgomery operands with edge values in the first
    rows: 0, 1, m - 1, m - 2, R mod m, m // 2 in every operand slot."""
    import torch
    from charon_tpu_torch.ops import limb

    ctx = limb.FR if name.endswith("_fr") else limb.FP
    n_in = KERNELS[name][3]
    m = ctx.modulus
    edge = [0, 1, m - 1, m - 2, ctx.r_mont, m // 2]
    gen = torch.Generator().manual_seed(seed)
    ops = []
    for k in range(n_in):
        raw = torch.randint(0, 1 << 24, (rows, ctx.n_limbs), generator=gen, dtype=torch.int64)
        raw[:, -1] = torch.randint(0, m >> (24 * (ctx.n_limbs - 1)), (rows,), generator=gen)
        rolled = edge[k % len(edge):] + edge[: k % len(edge)]
        head = limb.pack_mont_host(ctx, [v * pow(ctx.r_mont, -1, m) % m for v in rolled * 8])
        raw[: len(head)] = torch.as_tensor(head[:rows])
        ops.append(raw.to(device))
    return ctx, ops


def _run(name, ctx, ops, plain: bool):
    """One call of kernel `name`'s wrapper (or its plain version)."""
    from charon_tpu_torch.ops import mont_kernels as MK

    base = name.removesuffix("_fp").removesuffix("_fr")
    if plain:
        if base.startswith("mont_mul"):
            return (getattr(MK, base + "_plain")(ctx, ops[0], ops[1]),)
        return getattr(MK, base + "_plain")(ctx, *ops)
    fn = getattr(MK, base)
    if base.startswith("mont_mul"):
        return (fn(ctx, ops[0], ops[1]),)
    if base.startswith("fp2_mul"):
        return fn(ctx, (ops[0], ops[1]), (ops[2], ops[3]))
    return fn(ctx, (ops[0], ops[1]))


def _time_ms(fn, iters: int, queued: bool = False) -> float:
    """CUDA events around `iters` calls of fn, in ms a call. With `queued`
    the stream first sleeps long enough for the host to enqueue every call,
    so the events hold the launches back to back: the card's time, not the
    host's rate of launching (which sets the pace below ~10 us a kernel)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(iters * 100_000)  # ~50 us of host time a call at ~2 GHz
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _raw_launcher(name, ctx, ops):
    """A closure that launches the kernel alone — the C entry point with
    fixed pointers and the wrapper's geometry — so the timed loop holds no
    wrapper overhead."""
    import torch
    from charon_tpu_torch.ops import limb_mxu
    from charon_tpu_torch.ops import mont_kernels as MK

    _, source, fn_name, _, n_out, _, _ = KERNELS[name]
    outs = [torch.empty_like(ops[0]) for _ in range(n_out)]
    fn = getattr(MK.library(source), fn_name)
    ptrs = [t.data_ptr() for t in (*ops, *outs)]
    if name in INT8_KERNELS:
        ptrs.append(limb_mxu.device_tables(ctx, ops[0].device).data_ptr())
    rows = ops[0].numel() // ctx.n_limbs
    g = MK.geometry(name, rows, MK.sm_count(ops[0].device))
    geom = (g.elems, g.threads, g.grid, g.smem)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        if fn(*ptrs, rows, *geom, ctx.n_limbs, ctx.limbs.ctypes.data, ctx.pinv, stream) != 0:
            raise RuntimeError(f"{name} launch failed")

    return launch


def _bound_ms(name, rows) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes term
    (int64 limbs, each input read once, each output written once; the 6 KB
    of int8 tables are negligible) and the operations term (limb
    multiply-adds on the CUDA cores plus int8 multiply-adds on the tensor
    cores, two operations each)."""
    _, _, _, n_in, n_out, imad, tc = KERNELS[name]
    n = 11 if name.endswith("_fr") else 16
    t_bytes = rows * (n_in + n_out) * n * 8 / HBM_BYTES_PER_S * 1e3
    t_ops = (rows * imad * 2 / INT32_OPS_PER_S + rows * tc * 2 / INT8_TC_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# SASS opcode classes counted per kernel, first match wins
SASS_OPS = ("IMAD.WIDE", "IMAD", "IMMA", "LDSM", "LDS", "STS", "LDGSTS", "LDG", "STG", "LDL", "STL", "BAR")


def sass_mix(sass: str) -> dict:
    """{kernel function: (instructions, {opcode class: count})} of a
    cuobjdump -sass listing."""
    import collections
    import re

    out = {}
    for fn, body in re.findall(r"Function : (\S+)(.*?)(?=Function : |\Z)", sass, re.S):
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body)
        mix = collections.Counter(
            c for op in ops for c in [next((c for c in SASS_OPS if op == c or op.startswith(c + ".")), None)] if c
        )
        out[fn] = (len(ops), dict(mix))
    return out


def count_imma() -> None:
    """K4-K6 must issue their constant convolutions on the int8 tensor
    cores: count IMMA instructions in each int8 library's SASS. Also
    print every kernel's instruction mix (static counts: the kernels'
    loops are unrolled, so a tile's work is close to its count)."""
    from pathlib import Path

    from charon_tpu_torch.ops import mont_kernels as MK

    cuobjdump = str(Path(MK.nvcc_path()).with_name("cuobjdump"))
    int8_sources = {KERNELS[name][1] for name in INT8_KERNELS}
    for source in dict.fromkeys(v[1] for v in KERNELS.values()):
        sass = subprocess.run([cuobjdump, "-sass", str(MK._lib_path(source))], check=True, capture_output=True, text=True).stdout
        if source in int8_sources:
            imma = sum("IMMA" in line for line in sass.splitlines())
            if imma == 0:
                raise AssertionError(f"{source}: no int8 tensor-core (IMMA) instruction in its SASS")
            log(f"{source}: {imma} IMMA instructions in the SASS")
        for fn, (n, mix) in sass_mix(sass).items():
            log(f"sass {source} {fn[:60]}: {n} instructions; " + ", ".join(f"{k} {v}" for k, v in mix.items()))


def edge_rows(name: str) -> tuple:
    """Row counts at the edges of a kernel's tiles and waves: a warp's rows
    (K1's and K4's one-warp launches), a large launch's tile (K4: 128
    rows; the others: 32), and one wave of resident blocks."""
    import torch
    from charon_tpu_torch.ops import mont_kernels as MK

    sms = MK.sm_count(torch.device("cuda"))
    e = MK.geometry(name, 1 << 30, sms).elems
    wave = sms * MK._RESIDENT[name] * e
    return tuple(sorted({1, 2, 3, 31, 32, 33, e - 1, e, e + 1, wave + 2 * e + 1}))


def check_kernels(seed: int) -> dict:
    """Each kernel == its plain version at main-path row counts and at its
    tile edges (K4-K6 == K1-K3 on the same operands); times."""
    import torch
    from charon_tpu_torch.ops import mont_kernels as MK

    results = {}
    for name in KERNELS:
        worst = 0
        rows_checked = CHECK_ROWS + edge_rows(name)
        for rows in rows_checked:
            ctx, ops = _operands(name, rows, seed + rows, "cuda")
            got = _run(name, ctx, ops, plain=False)
            want = _run(name, ctx, ops, plain=True)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                err = int((g - w).abs().max())
                worst = max(worst, err)
                if err != 0:
                    raise AssertionError(f"{name} differs from its plain version at {rows} rows")
            if name in INT8_KERNELS:
                twin = _run(name.replace("_mxu", ""), ctx, ops, plain=False)
                if not all(torch.equal(g, w) for g, w in zip(got, twin)):
                    raise AssertionError(f"{name} differs from {name.replace('_mxu', '')} at {rows} rows")
        ctx, ops = _operands(name, TIMED_ROWS, seed, "cuda")
        ms = _time_ms(_raw_launcher(name, ctx, ops), 200, queued=True)
        wrapper_ms = _time_ms(lambda: _run(name, ctx, ops, plain=False), 200)
        plain_ms = _time_ms(lambda: _run(name, ctx, ops, plain=True), 5)
        bound, bound_by = _bound_ms(name, TIMED_ROWS)
        results[name] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by}
        twin = f" and == {name.replace('_mxu', '')}" if name in INT8_KERNELS else ""
        log(f"kernel {name}: == plain{twin} at rows {rows_checked}; {TIMED_ROWS} rows: kernel {ms:.4f} ms, "
            f"through the wrapper {wrapper_ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound:.4f} ms by {bound_by}")
    MK.reset_launches()
    return results


def time_duty_shapes(results: dict, rows: dict, seed: int) -> None:
    """Phase 8: each kernel's time (C entry point alone, CUDA events over
    200 queued launches) at the DUTY_SHAPES row counts its duty launched it at
    most often, beside the bound. The operands stay in L2 across the
    launches, as on the duty, where each kernel's operands were written by
    the op just before it. Adds to `results` each shape's numbers and the
    launch-weighted sums over those shapes."""
    for name in KERNELS:
        top = sorted(rows[name].items(), key=lambda kv: (-kv[1], -kv[0]))[:DUTY_SHAPES]
        shapes = []
        for n_rows, launches in top:
            ctx, ops = _operands(name, n_rows, seed + n_rows, "cuda")
            ms = _time_ms(_raw_launcher(name, ctx, ops), 200, queued=True)
            bound, _ = _bound_ms(name, n_rows)
            shapes.append({"rows": n_rows, "launches": launches, "ms": ms, "bound_ms": bound})
        total = sum(rows[name].values())
        results[name].update(
            duty_shapes=shapes,
            duty_shapes_ms=sum(s["launches"] * s["ms"] for s in shapes),
            duty_shapes_bound_ms=sum(s["launches"] * s["bound_ms"] for s in shapes),
            duty_shapes_cover=sum(s["launches"] for s in shapes) / total if total else 0.0,
        )
        log(f"kernel {name} at its duty's shapes: " + "; ".join(
            f"{s['rows']} rows x{s['launches']}: {s['ms']:.4f} ms (bound {s['bound_ms']:.4f})" for s in shapes
        ) + f"; launch-weighted {results[name]['duty_shapes_ms']:.1f} ms (bound "
            f"{results[name]['duty_shapes_bound_ms']:.1f}) over {results[name]['duty_shapes_cover']:.3f} of its launches")


# ---------------------------------------------------------------------------
# Phase 4: the startup tuner
# ---------------------------------------------------------------------------


def run_tuner(lanes: int) -> None:
    """autotune.resolve on the card over the mxu_mont axis at the duty's
    lane count, with its profile in a scratch directory under the build
    directory. Its choice is printed; the duties below set their
    configurations themselves."""
    import tempfile
    from pathlib import Path

    from charon_tpu_torch.core import autotune
    from charon_tpu_torch.ops import mont_kernels as MK

    MK.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=MK.BUILD_DIR) as tmp:
        res = autotune.resolve(
            "force", Path(tmp) / autotune.PROFILE_BASENAME,
            lanes=lanes, candidates={"mxu_mont": autotune.CANDIDATES["mxu_mont"]},
        )
        prof = autotune.load_profile(Path(tmp) / autotune.PROFILE_BASENAME)
    on, off, spread = (res.timings["mxu_mont"][k] * 1e3 for k in ("on", "off", "spread"))
    log(f"tuner: outcome {res.outcome}, {res.bench_runs} bench runs at {lanes} lanes "
        f"(min of {autotune.TUNE_REPS}): mxu_mont on (K4-K6) {on:.3f} ms, off (K1-K3) {off:.3f} ms, "
        f"spread {spread:.3f} ms; choice mxu_mont={res.config.mxu_mont}; "
        f"profile {prof['platform']} {prof['capability']} torch {prof['torch_version']} CUDA {prof['cuda_version']}")
    MK.reset_launches()


# ---------------------------------------------------------------------------
# Phases 5 and 6: the 1k-validator 4-of-7 attestation duty
# ---------------------------------------------------------------------------


def duty_message(v: int) -> bytes:
    return hashlib.sha256(b"attestation data root %d" % (v % DUTY_MESSAGES)).digest()


def make_validator(args):
    """One validator's key, 4-of-7 split, and the partials of a seeded
    4-subset of its shares over its duty message (host bigints)."""
    seed, v = args
    from charon_tpu_torch.crypto import bls, g1g2, shamir

    rng = random.Random(f"{seed}/{v}")
    sk = bls.keygen(rng.randbytes(32))
    shares = shamir.split(sk, 7, 4, rand=lambda: rng.randrange(1, shamir.R))
    signers = sorted(rng.sample(range(1, 8), 4))
    msg = duty_message(v)
    h = _hashed(msg)  # bls.sign(share, msg) == g2_mul(hash_to_g2(msg), share)
    return (
        g1g2.g1_to_bytes(bls.sk_to_pk(sk)),
        msg,
        {i: g1g2.g1_to_bytes(bls.sk_to_pk(shares[i])) for i in signers},
        {i: g1g2.g2_to_bytes(g1g2.g2_mul(h, shares[i])) for i in signers},
        shares[signers[0]],
    )


@functools.lru_cache(maxsize=DUTY_MESSAGES)
def _hashed(msg: bytes):
    from charon_tpu_torch.crypto import h2c

    return h2c.hash_to_g2(msg)


def stage(name, fn, timings):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    timings[name] = time.perf_counter() - t0
    log(f"stage {name}: {timings[name]:.3f} s")
    return out


def host_setup(n_validators: int, seed: int, workers: int) -> list:
    """Keys, splits and partial signatures of n validators (host bigints,
    in a process pool)."""
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        vals = pool.map(make_validator, [(seed, v) for v in range(n_validators)], chunksize=8)
    log(f"host setup: {n_validators} validators, {4 * n_validators} partials, {time.perf_counter() - t0:.1f} s")
    return vals


def run_duty(vals: list, seed: int, label: str, launched: tuple, idle: tuple):
    """The duty of validators `vals` through TorchImpl on the card, under
    the configuration already applied; returns (stage timings, launches
    per kernel, launches per row count per kernel, the impl, the threshold
    batch). Every kernel in `launched` must launch during the duty, and
    none in `idle`."""
    from charon_tpu_torch.crypto import bls, g1g2, shamir
    from charon_tpu_torch.ops import mont_kernels as MK
    from charon_tpu_torch.tbls.python_impl import sig_to_point
    from charon_tpu_torch.tbls.torch_impl import TorchImpl

    n_validators = len(vals)
    lanes = [(vals[v][2][i], vals[v][1], vals[v][3][i]) for v in range(n_validators) for i in vals[v][3]]
    impl = TorchImpl()
    grouped = []
    inner = impl.engine.verify_batch_grouped_rlc

    def counting(groups, rng=None):
        grouped.append(len(groups))
        return inner(groups, rng)

    impl.engine.verify_batch_grouped_rlc = counting

    # forged lane: a validator's first signer signs another duty's message
    forged = list(lanes[:64])
    k = 4 * random.Random(seed).randrange(16)
    pk, msg, _ = forged[k]
    forged[k] = (pk, msg, g1g2.g2_to_bytes(bls.sign(vals[k // 4][4], duty_message(k // 4 + 1))))

    log(f"duty {label}: {n_validators} validators, {len(lanes)} partials")
    timings: dict = {}
    MK.reset_launches()
    got = stage("verify_partials", lambda: impl.verify_batch(lanes), timings)
    if not all(got) or grouped != [min(DUTY_MESSAGES, n_validators)]:
        raise AssertionError(f"partials: {got.count(False)} False, grouped calls {grouped}")
    got = stage("verify_forged_64", lambda: impl.verify_batch(forged), timings)
    if [i for i, ok in enumerate(got) if not ok] != [k]:
        raise AssertionError(f"forged batch: False lanes {[i for i, ok in enumerate(got) if not ok]}, want [{k}]")
    batch = [vals[v][3] for v in range(n_validators)]
    group_sigs = stage("threshold_aggregate", lambda: impl.threshold_aggregate_batch(batch), timings)
    got = stage(
        "verify_group",
        lambda: impl.verify_batch([(vals[v][0], vals[v][1], group_sigs[v]) for v in range(n_validators)]),
        timings,
    )
    if not all(got):
        raise AssertionError(f"group signatures: {got.count(False)} False")
    launches = dict(MK.LAUNCHES)
    rows = {name: dict(counts) for name, counts in MK.ROWS.items()}
    copies = {name: MK.ALIGN_COPIES[name] for name in launched}
    timings["duty_total"] = sum(timings.values())

    sample = random.Random(seed + 1).sample(range(n_validators), min(16, n_validators))
    for v in sample:
        want = g1g2.g2_to_bytes(shamir.threshold_aggregate_g2({i: sig_to_point(s) for i, s in batch[v].items()}))
        if group_sigs[v] != want:
            raise AssertionError(f"validator {v}: group signature differs from host recombination")
    log(f"group signatures of {len(sample)} sampled validators equal host recombination")
    log(f"launches over the duty {label}:", json.dumps(launches))
    log(f"operands copied onto 16-byte words before a launch, duty {label}:", json.dumps(copies))
    for name in launched:
        top = sorted(rows[name].items(), key=lambda kv: (-kv[1], -kv[0]))
        covered = sum(n for _, n in top[:DUTY_SHAPES]) / launches[name]
        log(f"rows per launch of {name} ({len(top)} row counts; the top {DUTY_SHAPES} cover "
            f"{covered:.3f} of its launches): " + ", ".join(f"{r} x{n}" for r, n in top[:8]))
    log(f"stage times {label} (s):", json.dumps(timings))
    if not all(launches[name] > 0 for name in launched):
        raise AssertionError(f"a kernel of the {label} path never launched: {launches}")
    if any(launches[name] for name in idle):
        raise AssertionError(f"a kernel outside the {label} path launched: {launches}")
    return timings, launches, rows, impl, batch


def profile_device(impl, batch, label: str) -> None:
    """Where the device time goes in the loop bodies that make up the
    main path: one step of the 255-bit G2 subgroup-check ladder over every
    partial (point arithmetic), and one step of the final exponentiation's
    x-chain over 9 lanes (tower arithmetic). Per step: wall time untraced,
    kernel time traced by torch.profiler, the idle share of the wall (one
    stream, so kernels never overlap), and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from charon_tpu_torch.ops import curve as C
    from charon_tpu_torch.ops import fptower as T
    from charon_tpu_torch.tbls.python_impl import sig_to_point

    eng = impl.engine
    f2 = C.g2_ops(eng.ctx)
    points = [sig_to_point(s, subgroup_check=False) for p in batch for s in p.values()]
    proj = C.affine_to_point(f2, C.g2_pack(eng.ctx, points, eng.device))
    f12 = T.fp12_one(eng.ctx, (9,), eng.device)

    def ladder_step():
        acc = C.point_double(f2, proj)
        return C.point_select(f2, torch.ones(len(points), dtype=torch.bool, device=eng.device), C.point_add(f2, acc, proj), acc)

    def chain_step():
        return T.fp12_mul(eng.ctx, T.fp12_cyclotomic_sqr(eng.ctx, f12), f12)

    with torch.inference_mode():
        for name, step in ((f"g2_ladder_step_x{len(points)}", ladder_step), ("final_exp_chain_step_x9", chain_step)):
            step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 5
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                step()
                torch.cuda.synchronize()
            kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0]
            busy = sum(e.self_device_time_total for e in kernels) / 1e6
            launches = sum(e.count for e in kernels)
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
            log(f"profile {label} {name}: {wall * 1e3:.2f} ms a step, {launches} kernel launches, kernels busy "
                f"{busy * 1e3:.3f} ms, idle share {1 - busy / wall:.3f}")
            for e in top:
                log(f"  {e.self_device_time_total / 1e3:8.3f} ms {e.count:5d}x  {e.key[:70]}")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--validators", type=int, default=1024, help="each duty's validators")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--workers", type=int, default=min(8, os.cpu_count() or 1))
    args = ap.parse_args(argv)
    if args.validators < 16:
        ap.error("each duty needs at least 16 validators (the forged batch takes 64 partials)")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    from charon_tpu_torch.core.autotune import KernelConfig
    from charon_tpu_torch.ops import mont_kernels as MK

    card = card_line()
    print(card, flush=True)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(subprocess.run([MK.nvcc_path(), "--version"], check=True, capture_output=True, text=True).stdout.strip().splitlines()[-1])

    t0 = time.perf_counter()
    for source, report in MK.build(force=True).items():
        log(f"nvcc {source}:")
        for line in report.splitlines():
            if "ptxas info" in line or "spill" in line:
                log("  " + line.strip())
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    count_imma()

    results = check_kernels(args.seed)
    vals = host_setup(args.validators, args.seed, args.workers)
    run_tuner(sum(len(v[3]) for v in vals))

    KernelConfig(mxu_mont=True).apply()
    _, int8_launches, int8_rows, impl, batch = run_duty(vals, args.seed, "int8", INT8_KERNELS, DEFAULT_KERNELS)
    profile_device(impl, batch, "int8")
    KernelConfig().apply()
    _, default_launches, default_rows, _, _ = run_duty(vals, args.seed, "default", DEFAULT_KERNELS, INT8_KERNELS)
    profile_device(impl, batch, "default")
    duty_rows = {name: (int8_rows if name in INT8_KERNELS else default_rows)[name] for name in KERNELS}
    time_duty_shapes(results, duty_rows, args.seed)

    kernels = []
    for name, (replaces, source, *_rest) in KERNELS.items():
        launches = int8_launches if name in INT8_KERNELS else default_launches
        kernels.append({
            "name": name, "route": "cuda", "source": f"charon_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": launches[name], **results[name], "library_ms": None,
            "status": "ported",
        })
    print(json.dumps({"kernels": kernels, "card": card}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
