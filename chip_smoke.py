#!/usr/bin/env python3
"""Drive the PyTorch port (charon_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--validators 1024] [--seed 1] [--workers 8] [--python-decode] [--node-slot 48]
    python3 chip_smoke.py --node-sweep 12,24,36   # the kernel build and the node phase alone, at each slot
    python3 chip_smoke.py --int8                  # the kernel build and phase 5 (int8) alone
    python3 chip_smoke.py --dkg                   # the kernel build and phase 9 alone
    python3 chip_smoke.py --ceremony              # the kernel build and phase 9's cluster ceremony alone
    python3 chip_smoke.py --adversarial           # the kernel build and phase 11 alone, on a plane of its own
    python3 chip_smoke.py --shards                # the kernel build and phase 8b alone (its own host setup)
    python3 chip_smoke.py --shards 1 --vals F     # phase 8b on mesh 1 alone, the host setup from pickle F
    python3 chip_smoke.py --shards 1 --shard-part attribution  # and only its attribution and trace
    python3 chip_smoke.py --exit-check [TRIES]    # the kernel build and the exit check alone
    python3 chip_smoke.py --stop-check            # the node phase stopped mid-slot, then this process's exit
    python3 chip_smoke.py --profile F             # phase 7's default half alone, the host setup from pickle F
    python3 chip_smoke.py --age-fresh F           # a fresh process's age probe, a label a line on stdin
    python3 chip_smoke.py --age-ab idle|trace [--vals F]  # the age A/B: a trace or a sleep, then age turns

Phases; any failure exits non-zero and prints no result. Phases 1-4, 6,
7, 8, 11 and 12 run in order in this process; phase 5 with phase 7's int8
half (`--int8`), phase 8b (`--shards`), phase 9 (`--dkg`) and phase 10
(`--node-sweep`) run in processes of their own, started after phase 4 and
run on the same card beside phases 6-8 (each phase is bound by the host,
the card idle most of the time), as does the exit check (`--exit-check`),
and this process waits for all five after phase 8. The age probe
(app/ageprobe.py) reads this process after phase 4, before any of them
starts, after phases 6, 7 and 8 and after phase 11 (and the int8
process after its decode batteries and at its end): each loop step's
wall, thread CPU and CUDA-event time, its launches (the sqrt-chain step
exactly one K3 and one K2, or K6 and K5 under int8, or the script
fails), gc, RSS, the allocator and the threads; cProfile at the first and
last probe; the last against the first ("age drift"); then this process
against a fresh one over the same partials, in turns ("age turns").

The exit check: six children (testutil/exitcheck.py), each holding a plane
over ["cuda:0"] * 2 with its h2c program in flight, or an open coalescer
over it with a verify flush in flight, end by returning from main, by
sys.exit(1) and by an uncaught exception, without close(); each must exit
with its own code, never a signal, within 120 s, its work ended or raised
and no shard thread alive at exit.

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
     entry point; through its wrapper; plain) beside its bound; then the
     unfused Fp2 route: one mixed fptower.fp2_batch level (mul, sqr,
     mul_fp) at 8,192 and 65,536 rows under each configuration, unfused
     (KernelConfig(fp2_fusion=False)) exactly equal to fused, launching
     one K1 Fp (K4 Fp under int8) and no K2, K3, K5 or K6;
  4. the host setup of the duty (keys, 4-of-7 splits, partials), then the
     startup tuner on the card: autotune.resolve("force") over the
     mxu_mont axis (K1-K3 vs K4-K6) at the duty's lane count, its timings,
     spread and choice, then the same over the fp2_fusion axis (one
     stacked Fp2 level, fused K2/K3 vs unfused around K1);
  5. in a process of its own (`--int8`, with its own host setup from the
     same seed), the int8 configuration (KernelConfig(mxu_mont=True).apply()): first
     the device decode batteries: decompress_g2_batch and
     decompress_g1_batch, with and without the subgroup check, on every
     edge class of the mask contract (both signs, infinity, bad flags,
     x >= p, non-residue x, on-curve off the subgroup, wrong length) with
     zero mask or point mismatches against the host oracle
     g1g2.g*_from_bytes, and hash_to_g2_batch on the five RFC 9380
     J.10.1 vectors and the duty's messages against h2c.hash_to_g2, each
     call's wall time and the path's launches; then the boot warm-up of a
     fresh TorchImpl (warm_point_caches over the duty's group pubkeys,
     signer pubshares and messages, every unique lane decoded on the
     device); then a 1k-validator 4-of-7 attestation duty through that
     TorchImpl, signatures decoded on the device (decode_mode "auto";
     decompress_g2_batch must run, the [r]P subgroup check and the host
     sig_to_point never): verify 4096 partials by grouped RLC, a forged
     lane found by the per-lane re-check, Lagrange recombination of 1024
     group signatures checked against host recombination, verification of
     the group signatures; each stage's wall time, each kernel's launches
     and the operands copied onto 16-byte words before a launch — K4 Fp,
     K4 Fr, K5 and K6 must launch, K1-K3 never; with --python-decode the
     same warm-up and duty follow with decode_mode "python", for the host
     decode's stage times from the same machine;
  6. the default configuration (KernelConfig()): the decode batteries, the
     warm-up and the duty again — K1-K3 must launch, K4-K6 never;
  7. a torch.profiler trace of four main-path loop bodies under each
     configuration (kernel time, idle share, top kernels), each the last
     work of its process: the default half in a process of its own
     (`--profile`, awaited after phase 6), the int8 half at the end of the
     int8 process (a process that has traced stays slower at every launch);
  8. the slot crypto plane (parallel/mesh.SlotCryptoPlane on the card)
     under its coalescer (core/cryptoplane.SlotCoalescer, the device
     decode): the boot warm-up through the plane's g1dec and h2c programs,
     prewarm (one verify bucket, both tiers, the decode-fused programs
     too; the recombine programs first run in the slot's flush), then the 1k-validator slot coalesced (every partial as 8
     verify calls and every validator as 2 recombine duties, t = 4) into
     ONE flush of verify_rlc_dec and step_rlc_dec, every verdict True and
     each group signature's bytes equal to phase 6's; a forged partial
     attributed (step_dec, verify_dec) and the point-input programs
     (step_rlc, step, verify_rlc, verify) on 64 validators; a 64-validator
     flush under the int8 configuration and one under the unfused Fp2
     route (K1 Fp and K1 Fr, never K2 or K3). All ten programs must run,
     each part launching its configuration's kernels only; each flush's
     stats and each program's walls and lanes;
 8b. in processes of their own, one a mesh (`--shards K --vals F`, each
     reading phase 4's host setup from a pickle; two for a mesh of four
     or more shards, `--shard-part slot` and `attribution`), the plane's shards at
     once (one host thread and one CUDA stream a shard, the threads taking
     turns at the host) on two meshes sharing the one card, ["cuda:0"] * 2
     and make_mesh_2d(2, ["cuda:0"] * 4), and over every card where there
     are more: the mesh's own warm-up programs (g1dec, h2c) over one bucket
     of the slot's keys (64 validators' keys and messages, every shard's
     device interval recorded), the rest of the point caches warmed
     through a one-shard plane (no prewarm), the full-width slot as ONE
     flush, every verdict True and each group
     signature's bytes the host signature of the group secret; each
     shard's device interval of each program (CUDA events) and their
     overlap; a forged partial on the last shard attributed by step_dec
     and verify_dec on 64 validators, with step_dec's count the live rows
     less the forged one; a verify flush of those 64 validators' lanes
     traced by torch.profiler: K1-K3 on at least as many streams as
     shards, and the card's idle share; K1-K3 launched, K4-K6 never; each
     mesh's flush wall beside phase 8's one-shard wall;
  9. in a process of its own (`--dkg`), the DKG and resharing ceremonies (dkg/frost.py, dkg/reshare.py and
     the engine's ceremony calls): one node's round-2 verification waves
     of a 4-of-7 FROST DKG over 2,000 validators (BASELINE config 4's
     10,000, cut for time), 14,000 lanes each: the proof-of-knowledge wave ([mu]G by the
     fixed-base table against R + [c]A0 by the ladder and a G1 sum), the
     share wave ([f_i(me)]G against the Straus commitment evaluation) and
     the pubshare wave (width 28 against [s_j]G), every commitment and nonce
     point built on the card, 64 seeded lanes of each held against the host
     oracle, one forged share and one forged proof the only lanes flagged;
     the G2 ladder and the Lagrange rows against the host; the cluster
     ceremony (dkg/ceremony.run_dkg, the `charon dkg` path): a cluster
     definition signed by 3 operators' k1 keys (t = 2, 1 validator,
     mainnet's fork version), every node's run_dkg in one event loop with
     the card engine for FROST and TorchImpl() on the card in the tbls
     registry for the deposit, builder-registration and lock signature
     rounds (threshold_aggregate_batch, verify, aggregate,
     verify_aggregate), then ClusterLock.verify of node 0's
     cluster-lock.json through that TorchImpl: equal locks on every node,
     t shares recover each group key, the pubshares match, the keystores
     decrypt to the shares, the lock and each deposit signature accepted
     by the port's PythonImpl on the host, a flipped byte of the aggregate
     signature and a changed deposit amount refused by both backends, K1
     Fp, K1 Fr, K2 and K3 launched and K4-K6 not; the walls of FROST, of
     the three signature rounds and of the lock verify, and the tbls calls
     by kind (--ceremony runs the kernel build and this ceremony alone); a
     reshare rotation (16 validators) end to end with the card engine on
     every node, its group keys recovered from t shares; a 1,024-lane
     share wave under the int8
     configuration (K4 Fp and Fr, never K1-K3; the default waves the
     reverse); the tuner's ceremony axes at the waves' lanes. Each wave's
     wall, lanes, launches and peak device memory;
 10. the node binary, in a process of its own (`--node-sweep <slot>`): a
     4-of-7, 16-validator cluster as seven `charon run` nodes. Its
     directories come from testutil/compose.generate through the port's
     `create-cluster` (written by a process of its own,
     `--make-node-cluster`, started after phase 4's tuner; the phase's
     process starts when it has ended); its ports are picked as the nodes launch. Node 0 runs in the
     phase's process through app/run.run with the Config `cmd/cli` builds
     from its line, serving the card's plane (TorchImpl, SlotCryptoPlane
     and coalescer behind the tenant service) over TCP; its boot loads
     phase 4's tuner profile, prewarms (one verify bucket) and warms the
     point caches. Nodes 1-6 are `python -m charon_tpu_torch.cmd.cli run`
     processes whose RemotePlane dials node 0 (their own planes only the
     local rung; no tuner, prewarm or warm-up). k1 TCP p2p, QBFT, each
     node's validator mock and flight recorder as build_node wires them.
     Genesis is NODE_BOOT s after the launch. Before it a wrong-token
     client is refused and each remote node's probe settles on one
     verify. By slot 0's deadline, at --node-slot seconds a slot: node 0's
     attestations and block equal the host signature of the group secret
     (t keystore shares); every node broadcasts the attester duty (16
     validators), randao and block (its /debug/traces and /metrics); node
     0's tracker reports no miss, no inline tbls call, nothing shed, the
     kernels of the configuration its tuner profile chose (K1-K3 or
     K4-K6, not both); every remote node without failover, shed or
     disconnect and with no program on its own plane; every node's flight
     dump merged by `cli flight merge`. Each node's boot, the card's
     processes, node 0's flushes with its device memory and RSS, slot
     start to broadcast per duty (node 0, remote), QBFT rounds, planeprof,
     the event loop's stalls;
 11. adversarial input on the card, in the main process after phases 8-10,
     under the default configuration (K1 Fp, K1 Fr, K2 and K3 must launch,
     K4-K6 never): (a) a seeded battery (adversarial_battery: ADV_LANES
     verify_batch lanes from two 4-of-7 splits: valid partials,
     chaos.forged_signatures, partials against another share's pubkey,
     off-subgroup G2 points, the infinity encoding, 95- and 97-byte
     signatures; per-lane verify; threshold sets with a repeated signer, a
     forged member and index 0; aggregate and verify_aggregate) through
     testutil/byzantine.differential_backend() over a TorchImpl on the
     card in the tbls registry: every verdict the battery's, zero
     mismatches against the port's PythonImpl on the host, every lane
     checked, each call's wall (card and oracle, and the card's share);
     (b) a CryptoPlaneService over phase 8's coalescer and plane (caches
     warm, no new prewarm) with two tenants: the abuser sends bursts of
     ADV_BURST forged lanes and cancels every second one in flight, the victim
     runs ADV_VICTIM_DUTIES duties of valid partials under ADV_BUDGET s
     deadlines (K1 Fp, K2 and K3: the flood only verifies); the victim
     misses nothing and every verdict of it is True,
     every abuser lane is False, the abuser's breaker opens and a
     quarantined flush of its lanes alone runs the plane's programs on the
     card, every damage counter names the abuser only; each flush's lanes
     by tenant and wall, the programs' walls;
 12. every kernel timed at the four row counts its duty launched it at
     most often (from mont_kernels.ROWS, the rows-per-launch map filled
     during phases 5-6), each beside its bound;
 13. the kernels JSON line (with each kernel's launches in the full-width
     plane slot, or in the int8 plane flush for K4-K6, in the three
     full-width DKG waves, or the int8 share wave for K4-K6, in the node
     phase, in phase 11, in phase 8b's slot flushes and in phase 8's
     unfused flush), then the result line.

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
import pickle
import random
import re
import statistics
import subprocess
import sys
import threading
import time
import warnings

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
# the unfused Fp2 route's kernels, and the fused Fp2 kernels it never reaches
UNFUSED_KERNELS = ("mont_mul_fp", "mont_mul_fr")
FP2_KERNELS = ("fp2_mul", "fp2_sqr")
# decode and hash-to-curve do no Fr product
INT8_DECODE_KERNELS = tuple(k for k in INT8_KERNELS if not k.endswith("_fr"))
DEFAULT_DECODE_KERNELS = tuple(k for k in DEFAULT_KERNELS if not k.endswith("_fr"))
CHECK_ROWS = (8192, 65533, 65536)
TIMED_ROWS = 65536
DUTY_SHAPES = 4  # row counts a kernel is timed at beyond TIMED_ROWS
DUTY_MESSAGES = 8


_T0 = time.perf_counter()


def _emit(line: str) -> None:
    """One whole line to stdout in one write: the phase processes' lines are
    passed through by threads while this process logs."""
    sys.stdout.write(line if line.endswith("\n") else line + "\n")
    sys.stdout.flush()


def log(*parts) -> None:
    _emit(" ".join([f"[{time.perf_counter() - _T0:7.1f}s]", *map(str, parts)]))


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


FP2_ROUTE_ROWS = (8192, 65536)


def check_fp2_route(seed: int) -> None:
    """Phase 3's unfused Fp2 route: one mixed fptower.fp2_batch level (mul,
    sqr, mul_fp) at FP2_ROUTE_ROWS rows under each configuration, the
    unfused route (KernelConfig(fp2_fusion=False)) exactly equal to the
    fused one and launching only K1 Fp (K4 Fp under int8): never K2, K3,
    K5 or K6. Each route's time (CUDA events over 20 levels) beside it."""
    import torch

    from charon_tpu_torch.core.autotune import KernelConfig
    from charon_tpu_torch.ops import fptower as T
    from charon_tpu_torch.ops import limb
    from charon_tpu_torch.ops import mont_kernels as MK

    for rows in FP2_ROUTE_ROWS:
        _, (a0, a1, b0, b1) = _operands("fp2_mul", rows, seed + rows, "cuda")
        level = [("mul", (a0, a1), (b0, b1)), ("sqr", (b0, a1)), ("mul_fp", (a1, b1), a0)]
        for label, mxu in (("default", False), ("int8", True)):
            only = "mont_mul_mxu_fp" if mxu else "mont_mul_fp"
            try:
                KernelConfig(mxu_mont=mxu).apply()
                fused = T.fp2_batch(limb.FP, level)
                fused_ms = _time_ms(lambda: T.fp2_batch(limb.FP, level), 20)
                KernelConfig(mxu_mont=mxu, fp2_fusion=False).apply()
                MK.reset_launches()
                unfused = T.fp2_batch(limb.FP, level)
                torch.cuda.synchronize()
                launches = dict(MK.LAUNCHES)
                unfused_ms = _time_ms(lambda: T.fp2_batch(limb.FP, level), 20)
            finally:
                KernelConfig().apply()
            if not all(torch.equal(x, y) for f, u in zip(fused, unfused) for x, y in zip(f, u)):
                raise AssertionError(f"fp2 route {label}: the unfused level differs from the fused one at {rows} rows")
            if launches[only] != 1 or any(n for k, n in launches.items() if k != only):
                raise AssertionError(f"fp2 route {label}: the unfused level launched {launches}, want {only} once")
            log(f"fp2 route {label} at {rows} rows: unfused == fused, one {only} launch; a level fused "
                f"{fused_ms:.4f} ms, unfused {unfused_ms:.4f} ms")
    MK.reset_launches()


def time_duty_shapes(results: dict, rows: dict, seed: int) -> None:
    """Phase 12: each kernel's time (C entry point alone, CUDA events over
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


# what "on" and "off" run on each axis the script tunes
TUNER_VALUES = {
    "mxu_mont": ("K4-K6", "K1-K3"),
    "fp2_fusion": ("fused K2/K3", "unfused around K1"),
    "ceremony_straus": ("Straus", "per-lane ladder"),
    "ceremony_msm_w8": ("window 8", "window 4"),
}


# the tuner's benches a value, cut from autotune.TUNE_REPS (5) to make
# room for the node phase; the ceremony axes, whose values differ 1.7-2.7x,
# take one (their spread is then 0), to keep the script under 1,000 s
TUNER_REPS = 2
TUNER_CEREMONY_REPS = 1


def run_tuner(lanes: int, axis: str = "mxu_mont", reps: int = TUNER_REPS, persist: bool = False) -> None:
    """autotune.resolve on the card over one axis at `lanes` (the duty's or
    the wave's lane count), `reps` benches a value, with its profile in
    a scratch directory under the build directory, or, with `persist`, at
    node_profile_path(), where the node phase's node 0 loads it at boot.
    Its timings, spread and choice are printed; the phases set their
    configurations themselves."""
    import tempfile
    from pathlib import Path

    from charon_tpu_torch.core import autotune
    from charon_tpu_torch.ops import mont_kernels as MK

    MK.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=MK.BUILD_DIR) as tmp:
        path = node_profile_path() if persist else Path(tmp) / autotune.PROFILE_BASENAME
        path.parent.mkdir(parents=True, exist_ok=True)
        res = autotune.resolve(
            "force", path, lanes=lanes, reps=reps, candidates={axis: autotune.CANDIDATES[axis]},
        )
        prof = autotune.load_profile(path)
    on, off, spread = (res.timings[axis][k] * 1e3 for k in ("on", "off", "spread"))
    on_name, off_name = TUNER_VALUES[axis]
    log(f"tuner: outcome {res.outcome}, {res.bench_runs} bench runs at {lanes} lanes "
        f"(min of {reps}): {axis} on ({on_name}) {on:.3f} ms, off ({off_name}) {off:.3f} ms, "
        f"spread {spread:.3f} ms; choice {axis}={getattr(res.config, axis)}; "
        f"profile {prof['platform']} {prof['capability']} torch {prof['torch_version']} CUDA {prof['cuda_version']}")
    MK.reset_launches()


# ---------------------------------------------------------------------------
# Phases 5 and 6: the device decode batteries
# ---------------------------------------------------------------------------

# RFC 9380 appendix J.10.1, BLS12381G2_XMD:SHA-256_SSWU_RO_: (msg, P.x =
# (c0, c1), P.y = (c0, c1)), the affine hash_to_curve outputs verbatim.
RFC_DST = b"QUUX-V01-CS02-with-BLS12381G2_XMD:SHA-256_SSWU_RO_"
RFC_VECTORS = [
    (
        b"",
        (
            0x0141EBFBDCA40EB85B87142E130AB689C673CF60F1A3E98D69335266F30D9B8D4AC44C1038E9DCDD5393FAF5C41FB78A,
            0x05CB8437535E20ECFFAEF7752BADDF98034139C38452458BAEEFAB379BA13DFF5BF5DD71B72418717047F5B0F37DA03D,
        ),
        (
            0x0503921D7F6A12805E72940B963C0CF3471C7B2A524950CA195D11062EE75EC076DAF2D4BC358C4B190C0C98064FDD92,
            0x12424AC32561493F3FE3C260708A12B7C620E7BE00099A974E259DDC7D1F6395C3C811CDD19F1E8DBF3E9ECFDCBAB8D6,
        ),
    ),
    (
        b"abc",
        (
            0x02C2D18E033B960562AAE3CAB37A27CE00D80CCD5BA4B7FE0E7A210245129DBEC7780CCC7954725F4168AFF2787776E6,
            0x139CDDBCCDC5E91B9623EFD38C49F81A6F83F175E80B06FC374DE9EB4B41DFE4CA3A230ED250FBE3A2ACF73A41177FD8,
        ),
        (
            0x1787327B68159716A37440985269CF584BCB1E621D3A7202BE6EA05C4CFE244AEB197642555A0645FB87BF7466B2BA48,
            0x00AA65DAE3C8D732D10ECD2C50F8A1BAF3001578F71C694E03866E9F3D49AC1E1CE70DD94A733534F106D4CEC0EDDD16,
        ),
    ),
    (
        b"abcdef0123456789",
        (
            0x121982811D2491FDE9BA7ED31EF9CA474F0E1501297F68C298E9F4C0028ADD35AEA8BB83D53C08CFC007C1E005723CD0,
            0x190D119345B94FBD15497BCBA94ECF7DB2CBFD1E1FE7DA034D26CBBA169FB3968288B3FAFB265F9EBD380512A71C3F2C,
        ),
        (
            0x05571A0F8D3C08D094576981F4A3B8EDA0A8E771FCDCC8ECCEAF1356A6ACF17574518ACB506E435B639353C2E14827C8,
            0x0BB5E7572275C567462D91807DE765611490205A941A5A6AF3B1691BFE596C31225D3AABDF15FAFF860CB4EF17C7C3BE,
        ),
    ),
    (
        b"q128_" + b"q" * 128,
        (
            0x19A84DD7248A1066F737CC34502EE5555BD3C19F2ECDB3C7D9E24DC65D4E25E50D83F0F77105E955D78F4762D33C17DA,
            0x0934ABA516A52D8AE479939A91998299C76D39CC0C035CD18813BEC433F587E2D7A4FEF038260EEF0CEF4D02AAE3EB91,
        ),
        (
            0x14F81CD421617428BC3B9FE25AFBB751D934A00493524BC4E065635B0555084DD54679DF1536101B2C979C0152D09192,
            0x09BCCCFA036B4847C9950780733633F13619994394C23FF0B32FA6B795844F4A0673E20282D07BC69641CEE04F5E5662,
        ),
    ),
    (
        b"a512_" + b"a" * 512,
        (
            0x01A6BA2F9A11FA5598B2D8ACE0FBE0A0EACB65DECEB476FBBCB64FD24557C2F4B18ECFC5663E54AE16A84F5AB7F62534,
            0x11FCA2FF525572795A801EED17EB12785887C7B63FB77A42BE46CE4A34131D71F7A73E95FEE3F812AEA3DE78B4D01569,
        ),
        (
            0x0B6798718C8AED24BC19CB27F866F1C9EFFCDBF92397AD6448B5C9DB90D2B9DA6CBABF48ADC1ADF59A1A28344E79D57E,
            0x03A47F8E6D1763BA0CAD63D6114C0ACCBEF65707825A511B251A660A9B3994249AE4E63FAC38B23DA0C398689EE2AB52,
        ),
    ),
]


def _encode(x: int, nbytes: int) -> bytes:
    out = bytearray(x.to_bytes(nbytes, "big"))
    out[0] |= 0x80
    return bytes(out)


def decode_batteries(seed: int):
    """Every edge class of the decode mask contract, labelled: the G2 and
    the G1 battery (host ints, seeded)."""
    from charon_tpu_torch.crypto import fields as F
    from charon_tpu_torch.crypto import g1g2

    rng = random.Random(f"decode/{seed}")
    P = F.P

    def off_subgroup(curve):
        if curve == "g2":
            return _off_subgroup_g2(rng)
        while True:
            x = rng.randrange(P)
            y = F.fp_sqrt((x * x * x + g1g2.B1) % P)
            if y is not None and not g1g2.g1_in_subgroup((x, y)):
                return g1g2.g1_to_bytes((x, y))

    def non_residue(curve):
        while True:
            if curve == "g2":
                x = (rng.randrange(P), rng.randrange(P))
                if F.fp2_sqrt(F.fp2_add(F.fp2_mul(F.fp2_sqr(x), x), g1g2.B2)) is None:
                    return _encode((x[1] << 384) | x[0], 96)
            else:
                x = rng.randrange(P)
                if F.fp_sqrt((x * x * x + g1g2.B1) % P) is None:
                    return _encode(x, 48)

    def flip(enc, bit=0x20):
        return bytes([enc[0] ^ bit]) + enc[1:]

    batteries = {}
    for curve, nbytes, gen, mul, to_bytes, rounds in (
        ("g2", 96, g1g2.G2_GEN, g1g2.g2_mul_raw, g1g2.g2_to_bytes, 6),
        ("g1", 48, g1g2.G1_GEN, g1g2.g1_mul_raw, g1g2.g1_to_bytes, 3),
    ):
        lanes = []
        for i in range(rounds):
            enc = to_bytes(mul(gen, rng.randrange(1, F.R)))
            lanes.append((f"roundtrip-{i}", enc))
            if i < 2:  # both sign bits for the same x
                lanes.append((f"signflip-{i}", flip(enc)))
        inf = to_bytes(None)
        lanes += [
            ("infinity", inf),
            ("bad-infinity-payload", inf[:20] + b"\x07" + inf[21:]),
            ("bad-infinity-sign", flip(inf)),
            ("no-compressed-flag", flip(to_bytes(mul(gen, rng.randrange(1, F.R))), 0x80)),
            ("x-ge-p", _encode((P << 384) | 1, 96) if curve == "g2" else _encode(P, 48)),
            ("non-residue-x", non_residue(curve)),
            ("non-subgroup", off_subgroup(curve)),
            ("wrong-length", b"\x80" + bytes(nbytes // 2)),
            ("empty", b""),
        ]
        batteries[curve] = lanes
    return batteries


def _oracle(decode, data: bytes, subgroup: bool):
    try:
        return True, decode(data, subgroup_check=subgroup)
    except ValueError:
        return False, None


def run_decode_batteries(engine, batteries, label: str, launched: tuple, idle: tuple) -> dict:
    """The engine's decode and hash-to-curve calls on the card against the
    host oracles, with zero mismatches; each call's wall time and the
    path's launches (counts reset just before and read just after)."""
    import torch

    from charon_tpu_torch.crypto import g1g2, h2c
    from charon_tpu_torch.ops import mont_kernels as MK
    from charon_tpu_torch.ops import sswu

    walls = {}
    MK.reset_launches()
    for curve, decode in (("g2", g1g2.g2_from_bytes), ("g1", g1g2.g1_from_bytes)):
        lanes = batteries[curve]
        for subgroup in (True, False):
            call = getattr(engine, f"decompress_{curve}_batch")
            pts, valid = stage(
                f"decompress_{curve}_x{len(lanes)}_subgroup_{'on' if subgroup else 'off'}",
                lambda: call([enc for _, enc in lanes], subgroup_check=subgroup), walls,
            )
            bad = [name for (name, enc), pt, ok in zip(lanes, pts, valid) if (ok, pt) != _oracle(decode, enc, subgroup)]
            if bad:
                raise AssertionError(f"decode {label}: {curve} (subgroup {subgroup}) mismatches the oracle on {bad}")
            if valid[[name for name, _ in lanes].index("non-subgroup")] == subgroup:
                raise AssertionError(f"decode {label}: {curve} off-subgroup lane with subgroup check {subgroup}")
    msgs = [duty_message(v) for v in range(DUTY_MESSAGES)]
    lanes = [sswu.hash_to_field_lane(m, RFC_DST) for m, _, _ in RFC_VECTORS] + msgs
    pts, valid = stage(f"hash_to_g2_x{len(lanes)}", lambda: engine.hash_to_g2_batch(lanes), walls)
    want = [(x, y) for _, x, y in RFC_VECTORS] + [_hashed(m) for m in msgs]
    if not all(valid) or pts != want:
        raise AssertionError(f"decode {label}: hash_to_g2 differs from the RFC vectors or h2c.hash_to_g2")
    torch.cuda.synchronize()
    launches = dict(MK.LAUNCHES)
    log(f"decode batteries {label}: zero mismatches; launches", json.dumps(launches))
    _check_launches(launches, f"decode {label}", launched, idle)
    MK.reset_launches()
    return walls


def _check_launches(launches: dict, path: str, launched: tuple, idle: tuple) -> None:
    if not all(launches[name] > 0 for name in launched):
        raise AssertionError(f"a kernel of the {path} path never launched: {launches}")
    if any(launches[name] for name in idle):
        raise AssertionError(f"a kernel outside the {path} path launched: {launches}")


# ---------------------------------------------------------------------------
# Phases 5 and 6: the 1k-validator 4-of-7 attestation duty
# ---------------------------------------------------------------------------


def duty_message(v: int) -> bytes:
    return hashlib.sha256(b"attestation data root %d" % (v % DUTY_MESSAGES)).digest()


def make_validator(args):
    """One validator's key, 4-of-7 split, the partials of a seeded 4-subset
    of its shares over its duty message, its first signer's share, and the
    host signature of the group secret over the message."""
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
        g1g2.g2_to_bytes(g1g2.g2_mul(h, sk)),
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


def boot_warm_up(impl, vals: list, label: str) -> dict:
    """A node's boot: warm_point_caches over the duty's group pubkeys,
    signer pubshares and messages, as impl's decode_mode resolves it. On
    the device every unique lane must decode there, none on the host and
    none invalid. Returns the stats."""
    from charon_tpu_torch.ops import mont_kernels as MK
    from charon_tpu_torch.tbls.torch_impl import warm_point_caches

    pubkeys = [v[0] for v in vals] + [pk for v in vals for pk in v[2].values()]
    messages = [v[1] for v in vals]
    source = "device" if impl._device_decode() else "python"
    MK.reset_launches()
    stats = stage(f"warm_up_{source}", lambda: warm_point_caches(impl, pubkeys, messages), {})
    launches = dict(MK.LAUNCHES)
    for name, keys in (("pubkey", pubkeys), ("message", messages)):
        want = {"device": 0, "python": 0, "cached": 0, "invalid": 0, source: len(set(keys))}
        if stats[name] != want:
            raise AssertionError(f"warm-up {label}: {name} lanes {stats[name]}, want {want}")
    log(f"warm-up {label}: {json.dumps(stats)}; launches {json.dumps(launches)}")
    MK.reset_launches()
    return stats


def run_duty(vals: list, seed: int, label: str, launched: tuple, idle: tuple, decode_mode: str = "auto"):
    """The duty of validators `vals` through a fresh TorchImpl on the card,
    under the configuration already applied, after the boot warm-up of its
    caches; returns (stage timings, launches per kernel, launches per row
    count per kernel, the impl, the threshold batch, the group signatures'
    bytes). Every kernel in
    `launched` must launch during the duty, and none in `idle`. With the
    device decode (decode_mode "auto" on the card) decompress_g2_batch must
    run and neither the [r]P subgroup check nor the host sig_to_point."""
    from charon_tpu_torch.crypto import bls, g1g2, shamir
    from charon_tpu_torch.ops import mont_kernels as MK
    from charon_tpu_torch.tbls import torch_impl
    from charon_tpu_torch.tbls.python_impl import sig_to_point

    n_validators = len(vals)
    lanes = [(vals[v][2][i], vals[v][1], vals[v][3][i]) for v in range(n_validators) for i in vals[v][3]]
    impl = torch_impl.TorchImpl(decode_mode=decode_mode)
    device_decode = impl._device_decode()
    warm = boot_warm_up(impl, vals, label)
    calls = {"verify_batch_grouped_rlc": [], "decompress_g2_batch": 0, "subgroup_check_g2_batch": 0, "sig_to_point": 0}
    inner = {name: getattr(impl.engine, name) for name in ("verify_batch_grouped_rlc", "decompress_g2_batch", "subgroup_check_g2_batch")}

    def grouped(groups, rng=None):
        calls["verify_batch_grouped_rlc"].append(len(groups))
        return inner["verify_batch_grouped_rlc"](groups, rng)

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)

        return call

    impl.engine.verify_batch_grouped_rlc = grouped
    impl.engine.decompress_g2_batch = counted("decompress_g2_batch", inner["decompress_g2_batch"])
    impl.engine.subgroup_check_g2_batch = counted("subgroup_check_g2_batch", inner["subgroup_check_g2_batch"])
    torch_impl.sig_to_point = counted("sig_to_point", sig_to_point)

    # forged lane: a validator's first signer signs another duty's message
    forged = list(lanes[:64])
    k = 4 * random.Random(seed).randrange(16)
    pk, msg, _ = forged[k]
    forged[k] = (pk, msg, g1g2.g2_to_bytes(bls.sign(vals[k // 4][4], duty_message(k // 4 + 1))))

    log(f"duty {label}: {n_validators} validators, {len(lanes)} partials, decode {'device' if device_decode else 'python'}")
    timings: dict = {}
    MK.reset_launches()
    try:
        got = stage("verify_partials", lambda: impl.verify_batch(lanes), timings)
        if not all(got) or calls["verify_batch_grouped_rlc"] != [min(DUTY_MESSAGES, n_validators)]:
            raise AssertionError(f"partials: {got.count(False)} False, grouped calls {calls['verify_batch_grouped_rlc']}")
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
    finally:
        torch_impl.sig_to_point = sig_to_point
    if not all(got):
        raise AssertionError(f"group signatures: {got.count(False)} False")
    launches = dict(MK.LAUNCHES)
    rows = {name: dict(counts) for name, counts in MK.ROWS.items()}
    copies = {name: MK.ALIGN_COPIES[name] for name in launched}
    timings["duty_total"] = sum(timings.values())
    timings["warm_up"] = warm["seconds"]
    log(f"decode calls over the duty {label}:", json.dumps({n: c for n, c in calls.items() if n != "verify_batch_grouped_rlc"}))
    if device_decode and (not calls["decompress_g2_batch"] or calls["subgroup_check_g2_batch"] or calls["sig_to_point"]):
        raise AssertionError(f"duty {label}: signatures were not decoded on the device alone: {calls}")
    if not device_decode and (calls["decompress_g2_batch"] or not calls["sig_to_point"]):
        raise AssertionError(f"duty {label}: signatures were not decoded on the host: {calls}")

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
    _check_launches(launches, f"duty {label}", launched, idle)
    return timings, launches, rows, impl, batch, group_sigs


PROFILE_RESULT = "profile"  # the key of the --profile process's result line


def duty_steps(vals: list) -> tuple:
    """(engine, app/ageprobe.loop_steps over every partial of `vals`), on
    an engine of its own under the configuration in force."""
    from charon_tpu_torch.app.ageprobe import loop_steps
    from charon_tpu_torch.ops.blsops import BlsEngine

    engine = BlsEngine()
    return engine, loop_steps(engine, [s for v in vals for s in v[3].values()])


def profile_device(steps: list, label: str) -> dict:
    """Where the device time goes in the loop bodies that make up the
    main path (duty_steps), over every partial (4096 lanes at full width):
    one step of the 255-bit G2 [r]P ladder of the host decode's subgroup
    check, one step of the G2 sqrt chain of the device decode, one step of
    its static psi ladder, and one step of the final exponentiation's
    x-chain over 9 lanes. Per step: wall time untraced, kernel time traced
    by torch.profiler, the idle share of the wall (one stream, so kernels
    never overlap), and the top kernels; returns {step: [wall ms, kernel
    launches, kernels busy ms, idle share]}. A process that has traced with
    torch.profiler stays slower at every launch after it (PERF.md section
    6, PR 16), so the profile is the last work of its process."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    with torch.inference_mode():
        for name, step in steps:
            step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 5
            # several steps a trace: a trace of one sub-millisecond step
            # can come back empty
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    step()
                torch.cuda.synchronize()
            kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0]
            busy = sum(e.self_device_time_total for e in kernels) / 1e6 / 5
            launches = sum(e.count for e in kernels) / 5
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
            log(f"profile {label} {name}: {wall * 1e3:.2f} ms a step, {launches:.0f} kernel launches, kernels busy "
                f"{busy * 1e3:.3f} ms, idle share {1 - busy / wall:.3f} (a step, mean of 5)")
            for e in top:
                log(f"  {e.self_device_time_total / 1e3 / 5:8.3f} ms {e.count / 5:7.1f}x  {e.key[:70]}")
            out[name] = [wall * 1e3, launches, busy * 1e3, 1 - busy / wall]
    return out


def profile_process(vals_path: str) -> int:
    """The --profile process: phase 7's default half, profile_device over
    the partials pickled at `vals_path` under the default configuration;
    prints its result as one JSON line."""
    from charon_tpu_torch.core.autotune import KernelConfig

    KernelConfig().apply()
    with open(vals_path, "rb") as f:
        _, steps = duty_steps(pickle.load(f))
    print(json.dumps({PROFILE_RESULT: profile_device(steps, "default")}), flush=True)
    return 0


def make_age_probe(vals: list):
    """The age probe (app/ageprobe.AgeProbe) over duty_steps(vals)."""
    from charon_tpu_torch.app.ageprobe import AgeProbe

    engine, steps = duty_steps(vals)
    return AgeProbe(steps, engine.device, engine.ctx)


def age_probe(probe, label: str, profiled: bool = False) -> dict:
    """One probe, logged as one line ("age probe <label>: {...}"), and with
    `profiled` each step's cProfile summary ("age profile <label>: ...")."""
    got = probe.probe(label)
    log(f"age probe {label}:", json.dumps(got))
    if profiled:
        log(f"age profile {label}:", json.dumps(probe.profile()))
    return got


AGE_FRESH = "age_fresh"  # the key of the --age-fresh process's probe lines
AGE_TURNS = 3  # probes of each process in age_turns


def age_fresh(vals_path: str) -> int:
    """The --age-fresh process: the age probe over the partials pickled at
    `vals_path`, under the default configuration, one probe for each label
    read from stdin, each printed as one JSON line; 0 once stdin ends."""
    from charon_tpu_torch.core.autotune import KernelConfig

    KernelConfig().apply()
    with open(vals_path, "rb") as f:
        probe = make_age_probe(pickle.load(f))
    try:
        for label in sys.stdin:
            print(json.dumps({AGE_FRESH: probe.probe(label.strip())}), flush=True)
    finally:
        probe.close()
    return 0


def age_turns(probe, vals_path) -> None:
    """This process's loop steps against a fresh process's (--age-fresh)
    over the same partials, in turns on the same card and host (this,
    fresh, fresh, this, ...), AGE_TURNS probes each: a process slowed by
    its age shows a ratio above 1 here, while the host's own drift moves
    both sides of a turn alike. Logs each step's medians and their ratio."""
    proc = subprocess.Popen(phase_command("--age-fresh", vals_path), stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, text=True)

    def fresh(label: str) -> dict:
        proc.stdin.write(label + "\n")
        proc.stdin.flush()
        for line in proc.stdout:
            if line.startswith("{" + json.dumps(AGE_FRESH)):
                got = json.loads(line)[AGE_FRESH]
                log(f"age probe {label}:", json.dumps(got))
                return got
            _emit(f"  fresh process {line}")
        raise AssertionError(f"age turns: the fresh process ended with {proc.wait()}")

    sides: dict = {"aged": [], "fresh": []}
    try:
        for turn in range(AGE_TURNS):
            for side in ("aged", "fresh") if turn % 2 == 0 else ("fresh", "aged"):
                label = f"{side} turn {turn}"
                sides[side].append(age_probe(probe, label) if side == "aged" else fresh(label))
        proc.stdin.close()
        if proc.wait(timeout=60) != 0:
            raise AssertionError(f"age turns: the fresh process exited {proc.returncode}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    for name in sides["aged"][0]["steps"]:
        aged, young = (statistics.median(p["steps"][name]["wall_ms"] for p in sides[k]) for k in ("aged", "fresh"))
        log(f"age turns {name}: this process {aged:.3f} ms, a fresh one {young:.3f} ms, ratio {aged / young:.3f} "
            f"(medians of {AGE_TURNS} turns)")


AGE_AB_SLEEP = 15.0  # s the idle side of age_ab waits, about as long as a trace of the four steps


def age_ab(mode: str, vals: list) -> int:
    """The age A/B (`--age-ab idle|trace`): in this process, a probe, then
    a torch.profiler trace of the loop steps (profile_device) or a sleep as
    long, a second probe, and age_turns against a fresh process. Run idle,
    trace, trace, idle in one call: a trace that slows the process shows
    in the trace runs' turns alone."""
    from charon_tpu_torch.core.autotune import KernelConfig
    from charon_tpu_torch.ops import mont_kernels as MK

    KernelConfig().apply()
    MK.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = MK.BUILD_DIR / f"age-ab-vals-{os.getpid()}.pickle"
    with open(path, "wb") as f:
        pickle.dump(vals, f)
    probe = make_age_probe(vals)
    try:
        before = age_probe(probe, f"{mode} before")
        if mode == "trace":
            profile_device(probe.steps, "age-ab")
        else:
            time.sleep(AGE_AB_SLEEP)
        age_drift(before, age_probe(probe, f"{mode} after"))
        age_turns(probe, path)
    finally:
        probe.close()
        path.unlink(missing_ok=True)
    return 0


def age_drift(first: dict, last: dict) -> None:
    """Each step's last probe against its first: median wall and thread CPU
    ms a step, and their ratios."""

    def ratio(a, b):
        return f"{b / a:.3f}x" if a else "no ratio"

    for name, a in first["steps"].items():
        b = last["steps"][name]
        log(f"age drift {name}, {first['label']} -> {last['label']}: wall {a['wall_ms']:.3f} -> {b['wall_ms']:.3f} ms "
            f"({ratio(a['wall_ms'], b['wall_ms'])}), thread CPU {a['cpu_ms']:.3f} -> {b['cpu_ms']:.3f} ms "
            f"({ratio(a['cpu_ms'], b['cpu_ms'])})")


# ---------------------------------------------------------------------------
# Phase 8: the slot crypto plane and its coalescer
# ---------------------------------------------------------------------------

PLANE_VERIFY_CALLS = 8
PLANE_SMALL = 64  # validators of the attribution, point-input and int8 flushes
# prewarm's buckets: one verify bucket (the smallest), not the plane's
# default ladders: the port has no per-shape compile, so a bucket buys only
# its first launches; the recombine buckets (70 s of the script's time) were
# cut to keep it under 1,000 s (PERF.md section 4)
PLANE_PREWARM_LANES = (1,)
PLANE_PREWARM_RECOMBINE_LANES = ()


def _rows(vals: list):
    """recombine() arguments of validators `vals`: pubshares, roots,
    partials, group pubkeys and indices, signers in index order."""
    idx = [sorted(v[3]) for v in vals]
    return (
        [[v[2][i] for i in ix] for v, ix in zip(vals, idx)],
        [v[1] for v in vals],
        [[v[3][i] for i in ix] for v, ix in zip(vals, idx)],
        [v[0] for v in vals],
        idx,
    )


def _verify_lanes(vals: list) -> list:
    return [(v[2][i], v[1], v[3][i]) for v in vals for i in sorted(v[3])]


def slot_calls(vals: list) -> tuple[list, list]:
    """The full-width slot of validators `vals`: (every partial as
    PLANE_VERIFY_CALLS verify calls, every validator as two recombine
    duties), the submissions of one coalesced flush."""
    lanes = _verify_lanes(vals)
    per = -(-len(lanes) // PLANE_VERIFY_CALLS)
    half = len(vals) // 2
    return [lanes[i : i + per] for i in range(0, len(lanes), per)], [_rows(vals[:half]), _rows(vals[half:])]


def check_slot(label: str, vals: list, vres: list, rres: list, want_sigs: list | None = None) -> None:
    """Raise unless every verdict of a slot flush (coalesced_flush of
    slot_calls(vals)) is True and each group signature's bytes equal
    `want_sigs` (None: the host signature of each group secret)."""
    want = [v[5] for v in vals] if want_sigs is None else want_sigs
    if not all(all(r) for r in vres) or not all(all(ok) for _, ok in rres):
        raise AssertionError(f"{label}: a verdict is False")
    sigs = [s for r_sigs, _ in rres for s in r_sigs]
    if sigs != want:
        bad = [v for v in range(len(vals)) if sigs[v] != want[v]]
        raise AssertionError(f"{label}: group signatures of validators {bad[:8]} differ from the wanted ones")


def _forged(vals: list, seed: int, r: int | None = None):
    """(lanes, rows, forged lane, forged row) of validators `vals` with one
    partial forged: validator r's (seeded if None) first signer signs
    another duty's message, in its verify lane and in its recombine row."""
    from charon_tpu_torch.crypto import bls, g1g2

    if r is None:
        r = random.Random(f"plane/{seed}").randrange(len(vals))
    bad = g1g2.g2_to_bytes(bls.sign(vals[r][4], duty_message(r + 1)))
    lanes = _verify_lanes(vals)
    k = 4 * r  # the first signer's lane of validator r
    lanes[k] = (lanes[k][0], lanes[k][1], bad)
    rows = _rows(vals)
    rows[2][r] = [bad, *rows[2][r][1:]]
    return lanes, rows, k, r


def coalesced_flush(coal, verify_calls: list, recombine_calls: list, walls: dict, label: str) -> tuple:
    """One concurrent burst of verify and recombine submissions through the
    coalescer: (verify results, recombine results, flush wall s, launches,
    families dispatched). The counts are set to 0 just before and read
    just after."""
    import asyncio

    import torch

    from charon_tpu_torch.ops import mont_kernels as MK

    async def burst():
        return await asyncio.gather(
            *(coal.verify(lanes) for lanes in verify_calls), *(coal.recombine(*rows) for rows in recombine_calls)
        )

    walls.clear()
    flushes = coal.flushes
    MK.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = asyncio.run(burst())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(MK.LAUNCHES)
    fams = sorted(fam for fam, runs in walls.items() for _ in runs)
    if coal.flushes - flushes != 1:
        raise AssertionError(f"plane {label}: {coal.flushes - flushes} flushes, want one")
    log(f"plane {label}: one flush in {wall:.3f} s; programs " + "; ".join(
        f"{fam} {s:.3f} s over {n} lanes" for fam, runs in sorted(walls.items()) for s, n in runs
    ))
    log(f"plane {label} launches:", json.dumps(launches))
    return out[: len(verify_calls)], out[len(verify_calls) :], wall, launches, fams


def run_plane(vals: list, duty_sigs: list, seed: int) -> tuple:
    """The slot crypto plane (parallel/mesh.SlotCryptoPlane, one card) under
    its coalescer (core/cryptoplane.SlotCoalescer, decode_mode "auto", i.e.
    the device decode), under the default configuration: the boot warm-up
    through the plane's g1dec and h2c programs, prewarm, the coalesced slot
    at full width (every partial as PLANE_VERIFY_CALLS verify calls, every
    validator as two recombine duties, ONE flush: verify_rlc_dec and
    step_rlc_dec, every verdict True, each group signature's bytes those of
    the duty's threshold_aggregate_batch), forged attribution (step_dec,
    verify_dec), the point-input programs through a decode_mode "python"
    coalescer (step_rlc, step, verify_rlc, verify), then a flush under the
    int8 configuration. All ten programs must run; each part launches its
    configuration's kernels and none of the other's; then a flush under the
    unfused Fp2 route (KernelConfig(fp2_fusion=False): K1 Fp and K1 Fr,
    never K2 or K3). Returns the full-width slot's launches (default
    kernels) and the int8 flush's (int8 ones), the unfused flush's
    launches, the slot's flush wall, and the coalescer, still open with its
    caches warm, and its program walls, for phase 11; the caller closes
    it."""
    import asyncio
    import dataclasses

    from charon_tpu_torch.core.autotune import KernelConfig
    from charon_tpu_torch.core.cryptoplane import SlotCoalescer
    from charon_tpu_torch.ops import mont_kernels as MK
    from charon_tpu_torch.parallel import SlotCryptoPlane
    from charon_tpu_torch.parallel import mesh as M
    from charon_tpu_torch.tbls.torch_impl import TorchImpl

    n = len(vals)
    plane = SlotCryptoPlane(None, t=4)
    walls: dict = {}
    ran: set = set()

    def on_program(fam, seconds, lanes):
        walls.setdefault(fam, []).append((seconds, lanes))
        ran.add(fam)

    plane.on_program = on_program
    stats: list = []
    coal = SlotCoalescer(plane, impl=TorchImpl(), stats_hook=stats.append)
    try:
        # the boot warm-up, through the plane's warm-up programs
        pubkeys = [v[0] for v in vals] + [pk for v in vals for pk in v[2].values()]
        messages = [v[1] for v in vals]
        MK.reset_launches()
        warm = stage("plane_warm_up", lambda: asyncio.run(coal.warm_caches(pubkeys, messages)), {})
        for name, keys in (("pubkey", pubkeys), ("message", messages)):
            want = {"device": len(set(keys)), "python": 0, "cached": 0, "invalid": 0}
            if warm[name] != want:
                raise AssertionError(f"plane warm-up: {name} lanes {warm[name]}, want {want}")
        log("plane warm-up:", json.dumps(warm), "programs", json.dumps(
            {fam: [len(runs), sum(s for s, _ in runs), sum(k for _, k in runs)] for fam, runs in walls.items()}
        ))
        _check_launches(dict(MK.LAUNCHES), "plane warm-up", DEFAULT_DECODE_KERNELS, INT8_KERNELS)

        report = stage(
            "plane_prewarm", lambda: asyncio.run(coal.prewarm(PLANE_PREWARM_LANES, PLANE_PREWARM_RECOMBINE_LANES)), {}
        )
        log(f"plane prewarm cut to verify lanes {PLANE_PREWARM_LANES} and recombine lanes "
            f"{PLANE_PREWARM_RECOMBINE_LANES} (the plane's default ladder: "
            f"{plane.PREWARM_VERIFY_LANES} and {plane.PREWARM_RECOMBINE_LANES}); (kind, bucket lanes, s):",
            json.dumps(report))

        # the coalesced slot at full width
        calls, duties = slot_calls(vals)
        lanes = [lane for call in calls for lane in call]
        stats.clear()
        vres, rres, slot_wall, slot_launches, fams = coalesced_flush(coal, calls, duties, walls, "slot")
        if fams != ["mesh/step_rlc_dec", "mesh/verify_rlc_dec"]:
            raise AssertionError(f"plane slot: programs {fams}")
        check_slot("plane slot", vals, vres, rres, duty_sigs)
        [slot_stats] = stats
        if slot_stats.decode_mode != "device" or slot_stats.lanes != len(lanes) + n:
            raise AssertionError(f"plane slot: {slot_stats}")
        log(f"plane slot: {len(calls)} verify calls ({len(lanes)} lanes) and {len(duties)} recombine duties "
            f"({n} validators) in one flush, every verdict True, {n} group signatures equal to the duty's")
        _check_launches(slot_launches, "plane slot", DEFAULT_KERNELS, INT8_KERNELS)

        # attribution: one forged partial in a verify lane and a recombine row
        small = vals[:PLANE_SMALL]
        f_lanes, f_rows, k, r = _forged(small, seed)
        vres, rres, _, launches, fams = coalesced_flush(coal, [f_lanes], [f_rows], walls, "attribution")
        if fams != ["mesh/step_dec", "mesh/step_rlc_dec", "mesh/verify_dec", "mesh/verify_rlc_dec"]:
            raise AssertionError(f"plane attribution: programs {fams}")
        if [i for i, ok in enumerate(vres[0]) if not ok] != [k]:
            raise AssertionError(f"plane attribution: False lanes {[i for i, ok in enumerate(vres[0]) if not ok]}, want [{k}]")
        [(a_sigs, a_oks)] = rres
        if [i for i, ok in enumerate(a_oks) if not ok] != [r]:
            raise AssertionError(f"plane attribution: False rows {[i for i, ok in enumerate(a_oks) if not ok]}, want [{r}]")
        if any(a_sigs[v] != duty_sigs[v] for v in range(len(small)) if v != r):
            raise AssertionError("plane attribution: a valid row's group signature differs from the duty's")
        _check_launches(launches, "plane attribution", DEFAULT_KERNELS, INT8_KERNELS)

        # the point-input programs: the host decode of the signatures
        host = SlotCoalescer(plane, impl=coal.impl, decode_mode="python", stats_hook=stats.append)
        try:
            vres, rres, _, launches, fams = coalesced_flush(host, [f_lanes], [f_rows], walls, "point inputs")
        finally:
            host.close()
        if fams != ["mesh/step", "mesh/step_rlc", "mesh/verify", "mesh/verify_rlc"]:
            raise AssertionError(f"plane point inputs: programs {fams}")
        if [i for i, ok in enumerate(vres[0]) if not ok] != [k] or [i for i, ok in enumerate(rres[0][1]) if not ok] != [r]:
            raise AssertionError("plane point inputs: the forged lane and row were not the only False ones")
        if rres[0][0] != a_sigs:
            raise AssertionError("plane point inputs: group signatures differ from the decode-fused programs'")
        _check_launches(launches, "plane point inputs", DEFAULT_KERNELS, INT8_KERNELS)

        # the int8 configuration
        KernelConfig(mxu_mont=True).apply()
        try:
            vres, rres, _, int8_launches, fams = coalesced_flush(
                coal, [_verify_lanes(small)], [_rows(small)], walls, "int8"
            )
        finally:
            KernelConfig().apply()
        if fams != ["mesh/step_rlc_dec", "mesh/verify_rlc_dec"] or not all(vres[0]) or not all(rres[0][1]):
            raise AssertionError(f"plane int8: programs {fams} or a False verdict")
        if rres[0][0] != duty_sigs[: len(small)]:
            raise AssertionError("plane int8: group signatures differ from the duty's")
        _check_launches(int8_launches, "plane int8", INT8_KERNELS, DEFAULT_KERNELS)

        # the unfused Fp2 route: Fp2 levels around K1's product, no K2/K3
        KernelConfig(fp2_fusion=False).apply()
        try:
            vres, rres, _, unfused_launches, fams = coalesced_flush(
                coal, [_verify_lanes(small)], [_rows(small)], walls, "unfused fp2"
            )
        finally:
            KernelConfig().apply()
        if fams != ["mesh/step_rlc_dec", "mesh/verify_rlc_dec"] or not all(vres[0]) or not all(rres[0][1]):
            raise AssertionError(f"plane unfused fp2: programs {fams} or a False verdict")
        if rres[0][0] != duty_sigs[: len(small)]:
            raise AssertionError("plane unfused fp2: group signatures differ from the duty's")
        _check_launches(unfused_launches, "plane unfused fp2", UNFUSED_KERNELS, FP2_KERNELS + INT8_KERNELS)

        if ran != {f"mesh/{name}" for name in M.FAMILIES}:
            raise AssertionError(f"plane: programs that never ran: {sorted({f'mesh/{x}' for x in M.FAMILIES} - ran)}")
        for st in stats:
            log("plane flush stats:", json.dumps({
                k: v for k, v in dataclasses.asdict(st).items() if k not in ("decode_spans", "parents", "decode_queue_seconds")
            }))
        log(f"plane: all {len(ran)} programs ran; flushes {coal.flushes}, coalesced {coal.coalesced_flushes}, "
            f"lanes {coal.lanes_flushed}, padding lanes {coal.pad_lanes_flushed}, failed {coal.failed_flushes}")
    except BaseException:
        coal.close()
        raise
    finally:
        MK.reset_launches()
    launches = {name: (int8_launches if name in INT8_KERNELS else slot_launches)[name] for name in KERNELS}
    return launches, unfused_launches, slot_wall, coal, walls


# ---------------------------------------------------------------------------
# Phase 8b: the plane's shards at once
# ---------------------------------------------------------------------------

SHARDS_RESULT = "shards_result"  # the key of the --shards process's result line
# the parts of a mesh's phase: the slot (after the rest of the warm-up), and
# the attribution with the traced flush; a mesh of SPLIT_SHARDS or more
# runs them in two processes, each on its own GIL (their walls grow with
# the shard count: on 2 x 2 of one H100 the slot took 126 s and the
# attribution with its trace 409 s, PERF.md section 6)
SHARD_PARTS = ("slot", "attribution")
SPLIT_SHARDS = 4
# the K1-K3 kernels' names in a profiler trace
_TRACE_KERNELS = ("charon::mont_mul", "charon::fp2_mul_kernel", "charon::fp2_sqr_kernel")


def shard_meshes() -> list:
    """(label, mesh) of the shard phase: two shards sharing cuda:0, a 2 x 2
    make_mesh_2d layout on it, and, where there is more than one card,
    every card."""
    import torch

    from charon_tpu_torch.parallel import make_mesh, make_mesh_2d

    meshes = [("2 shards", ["cuda:0"] * 2), ("2x2", make_mesh_2d(2, ["cuda:0"] * 4))]
    if torch.cuda.device_count() > 1:
        meshes.append((f"{torch.cuda.device_count()} cards", make_mesh()))
    return meshes


def _overlap(spans: list) -> dict:
    """Per-shard device intervals [(start, end) ms] of one program: their
    union, their sum, and the concurrency sum / union (1 in turn, the
    shard count at full overlap)."""
    union, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            union += e - max(s, end)
            end = e
    busy = sum(e - s for s, e in spans)
    return {"union_ms": union, "sum_ms": busy, "concurrency": busy / union if union else 0.0}


def _trace_streams(prof, wall_s: float) -> tuple[set, float]:
    """The streams a torch.profiler trace shows K1-K3 kernels on, and the
    card's idle share over `wall_s`: 1 - the union of every device
    interval / the wall."""
    from torch.autograd import DeviceType

    streams, spans = set(), []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        spans.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        rid = e.device_resource_id()
        if rid not in streams and any(k in e.name() for k in _TRACE_KERNELS):
            streams.add(rid)
    busy = _overlap([(s / 1e6, e / 1e6) for s, e in spans])["union_ms"] / 1e3
    return streams, 1 - busy / wall_s


def run_shards(vals: list, seed: int, which=None, parts=SHARD_PARTS) -> dict:
    """The slot crypto plane with its shards at once, on each of
    shard_meshes() (those of index in `which`, None: all), with a
    SlotCoalescer over SlotCryptoPlane(mesh) and the device decode: the
    mesh's own warm-up programs (g1dec, h2c) into a fresh TorchImpl's
    point caches over one bucket of the slot's keys, the keys and messages
    of the first PLANE_SMALL validators, each shard's device interval
    recorded for both programs; the rest of its caches warmed through a
    one-shard plane (no prewarm); then the full-width slot as ONE flush of
    verify_rlc_dec and step_rlc_dec (every verdict True, each group
    signature's bytes the host signature of the group secret), each
    shard's device interval of each program (CUDA events) and their
    overlap; then a forged partial on the last shard attributed by step_dec
    and verify_dec on PLANE_SMALL validators, the count step_dec returns
    the live rows less the forged one; then a flush of their valid verify
    lanes (verify_rlc_dec alone) under torch.profiler: K1-K3 on at least as
    many streams as the mesh has shards, and the card's idle share. K1 Fp,
    K1 Fr, K2 and K3 launch in the slot and the attribution, K4-K6 never.
    Returns {label: {"wall": s, "launches": {...}}}."""
    import asyncio

    import torch

    from charon_tpu_torch.core.autotune import KernelConfig
    from charon_tpu_torch.core.cryptoplane import SlotCoalescer
    from charon_tpu_torch.ops import mont_kernels as MK
    from charon_tpu_torch.parallel import SlotCryptoPlane
    from charon_tpu_torch.tbls.torch_impl import TorchImpl

    KernelConfig().apply()
    n = len(vals)
    want_sigs = [v[5] for v in vals]

    def keys(vs):
        return [v[0] for v in vs] + [pk for v in vs for pk in v[2].values()], [v[1] for v in vs]

    def warm_up(coal, vs, what):
        pubkeys, messages = keys(vs)
        warm = stage(what, lambda: asyncio.run(coal.warm_caches(pubkeys, messages)), {})
        if any(warm[name]["invalid"] or warm[name]["python"] for name in ("pubkey", "message")):
            raise AssertionError(f"{what}: {warm}")
        log(f"{what}:", json.dumps(warm))

    out = {}
    for i, (label, mesh) in enumerate(shard_meshes()):
        if which is not None and i not in which:
            continue
        impl = TorchImpl()  # point caches of the mesh's own, filled by its warm-up
        plane = SlotCryptoPlane(mesh, t=4)
        shards = plane.shard_count()
        walls: dict = {}
        spans: dict = {}
        plane.on_program = lambda fam, seconds, lanes: walls.setdefault(fam, []).append((seconds, lanes))
        plane.on_shards = lambda fam, s: spans.setdefault(fam, []).append(s)
        coal = SlotCoalescer(plane, impl=impl)
        res = out[label] = {"shards": shards}
        try:
            # the mesh's warm-up programs on one bucket, on the shards' streams
            warm_up(coal, vals[:PLANE_SMALL], f"shards {label} warm-up ({PLANE_SMALL} validators on the mesh)")
            for fam in ("mesh/g1dec", "mesh/h2c"):
                if len(spans.get(fam, [[]])[0]) != shards:
                    raise AssertionError(f"shards {label} warm-up: {fam} ran on shards {spans.get(fam)}, want {shards}")
                for s in spans[fam]:
                    o = _overlap(s)
                    log(f"shards {label} warm-up {fam}: shard device intervals (ms) "
                        + ", ".join(f"[{a:.1f}, {b:.1f}]" for a, b in s)
                        + f"; concurrency {o['concurrency']:.3f} of {shards}")
            if "slot" in parts:
                # the rest through a one-shard plane (cached keys are skipped)
                warm_coal = SlotCoalescer(SlotCryptoPlane(["cuda:0"], t=4), impl=impl)
                try:
                    warm_up(warm_coal, vals[PLANE_SMALL:], f"shards {label} warm-up (the rest, one shard)")
                finally:
                    warm_coal.close()
                spans.clear()
                calls, duties = slot_calls(vals)
                lanes = [lane for call in calls for lane in call]
                vres, rres, wall, launches, fams = coalesced_flush(coal, calls, duties, walls, f"shards {label} slot")
                if fams != ["mesh/step_rlc_dec", "mesh/verify_rlc_dec"]:
                    raise AssertionError(f"shards {label} slot: programs {fams}")
                check_slot(f"shards {label} slot", vals, vres, rres, want_sigs)
                _check_launches(launches, f"shards {label} slot", DEFAULT_KERNELS, INT8_KERNELS)
                overlap = {}
                for fam, runs in sorted(spans.items()):
                    for s in runs:
                        overlap[fam] = _overlap(s)
                        log(f"shards {label} {fam}: shard device intervals (ms from the inputs' ready event) "
                            + ", ".join(f"[{a:.1f}, {b:.1f}]" for a, b in s)
                            + f"; union {overlap[fam]['union_ms']:.1f} ms, sum {overlap[fam]['sum_ms']:.1f} ms, "
                            f"concurrency {overlap[fam]['concurrency']:.3f} of {shards}")
                log(f"shards {label} slot: {len(lanes)} verify lanes and {n} validators in one flush of {wall:.3f} s "
                    f"over {shards} shards, every verdict True, {n} group signatures equal to the host's")
                res.update(wall=wall, launches=launches, overlap=overlap)

            if "attribution" in parts:
                # attribution: a forged partial in the last shard
                small = vals[:PLANE_SMALL]
                f_lanes, f_rows, k, r = _forged(small, seed, r=len(small) - 1 - seed % 4)
                counts = []
                step_dec = plane._step_dec

                def counted(*args):
                    res = step_dec(*args)
                    counts.append(res[2])
                    return res

                plane._step_dec = counted
                try:
                    vres, rres, a_wall, a_launches, fams = coalesced_flush(coal, [f_lanes], [f_rows], walls, f"shards {label} attribution")
                finally:
                    plane._step_dec = step_dec
                if fams != ["mesh/step_dec", "mesh/step_rlc_dec", "mesh/verify_dec", "mesh/verify_rlc_dec"]:
                    raise AssertionError(f"shards {label} attribution: programs {fams}")
                if [i for i, ok in enumerate(vres[0]) if not ok] != [k]:
                    raise AssertionError(f"shards {label} attribution: False lanes {[i for i, ok in enumerate(vres[0]) if not ok]}, want [{k}]")
                [(a_sigs, a_oks)] = rres
                if [i for i, ok in enumerate(a_oks) if not ok] != [r]:
                    raise AssertionError(f"shards {label} attribution: False rows {[i for i, ok in enumerate(a_oks) if not ok]}, want [{r}]")
                if any(a_sigs[v] != want_sigs[v] for v in range(len(small)) if v != r):
                    raise AssertionError(f"shards {label} attribution: a valid row's group signature differs from the host's")
                if counts != [len(small) - 1]:
                    raise AssertionError(f"shards {label} attribution: step_dec counted {counts}, want [{len(small) - 1}]")
                _check_launches(a_launches, f"shards {label} attribution", DEFAULT_KERNELS, INT8_KERNELS)
                log(f"shards {label} attribution: forged lane {k} and row {r} (the last shard's) the only False ones, "
                    f"step_dec count {counts[0]}, one flush of {a_wall:.3f} s")

                # a traced flush of one program (the trace holds some 330,000
                # device events a program a shard): the valid verify lanes of
                # PLANE_SMALL validators, verify_rlc_dec alone
                with warnings.catch_warnings():
                    # the profiler warns for each kernel launched off its thread
                    warnings.simplefilter("ignore")
                    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                        vres, _, t_wall, t_launches, fams = coalesced_flush(coal, [_verify_lanes(small)], [], walls, f"shards {label} traced")
                        t_read = time.perf_counter()
                    streams, idle = _trace_streams(prof, t_wall)
                    t_read = time.perf_counter() - t_read
                if fams != ["mesh/verify_rlc_dec"] or not all(vres[0]):
                    raise AssertionError(f"shards {label} traced: programs {fams} or a False verdict")
                _check_launches(t_launches, f"shards {label} traced", DEFAULT_DECODE_KERNELS, INT8_KERNELS)
                if len(streams) < shards:
                    raise AssertionError(f"shards {label}: K1-K3 ran on streams {sorted(streams)}, fewer than {shards} shards")
                log(f"shards {label} traced: one verify_rlc_dec flush of {t_wall:.3f} s (the trace read in {t_read:.1f} s), "
                    f"K1-K3 on {len(streams)} streams {sorted(streams)}, the card's idle share {idle:.3f}")
                res.update(attribution_wall=a_wall, traced_wall=t_wall, streams=len(streams), idle=idle)
        finally:
            coal.close()
            plane.close()
            MK.reset_launches()
    return out


# ---------------------------------------------------------------------------
# Phase 9: the DKG and resharing ceremonies
# ---------------------------------------------------------------------------

DKG_N, DKG_T = 7, 4  # the 4-of-7 split of BASELINE configs 1-2
# BASELINE config 4 has 10,000; the waves' walls follow their lanes, and a
# fifth of them makes room for phase 11 in the 1,100 s aim (PERF.md section 4)
DKG_VALIDATORS = 2_000
DKG_ME = 1  # the node whose round 2 the phase runs
DKG_SAMPLE = 64  # lanes of each wave held against the host oracle
DKG_INT8_LANES = 1024
DKG_LAUNCHES = "dkg_launches"  # the key of the --dkg process's launch line
INT8_RESULT = "int8_duty"  # the key of the --int8 process's line: the duty's launches and rows per launch
# the rotation: n, t, validators; cut from bench_dkg.py's accelerator shape
# (4, 3, 16) to three nodes, the fewest `create-dkg` accepts, to make room
# for the node phase (each node's round 2 is a few launch-bound ladders
# whatever its lanes)
DKG_RESHARE = (3, 2, 16)
# the cluster ceremony (dkg/ceremony.run_dkg): n, t, validators. Three
# operators, the fewest `create-dkg` accepts (cmd/cli.py). Every tbls call on
# the card is a few launch-bound programs whatever its lanes; with 2
# validators (the fewest that make the lock's signature an aggregate across
# validators) the whole script ran 907-1047 s against its 950 s aim, so the
# ceremony is cut to 1 (each node's verifies go from 4 to 2)
DKG_CEREMONY = (3, 2, 1)
MAINNET_FORK = "0x00000000"
TBLS_CALLS = ("sign", "verify", "threshold_aggregate_batch", "aggregate", "verify_aggregate")
DKG_CTX = b"chip-smoke cluster definition"
G1_ONLY_IDLE = INT8_KERNELS + ("fp2_mul", "fp2_sqr")  # a G1 wave of the default configuration


def _horner(poly, x: int) -> int:
    from charon_tpu_torch.crypto.fields import R

    acc = 0
    for c in reversed(poly):
        acc = (acc * x + c) % R
    return acc


def _host_eval(row, x: int, t: int):
    """sum over row's t-vectors of sum_k C_k x^k, frost's host loop."""
    from charon_tpu_torch.crypto import g1g2
    from charon_tpu_torch.crypto.fields import R

    acc = None
    for v in range(len(row) // t):
        xpow = 1
        for c in row[v * t : (v + 1) * t]:
            acc = g1g2.g1_add(acc, g1g2.g1_mul(c, xpow))
            xpow = xpow * x % R
    return acc


def _wave(name: str, fn, lanes: int, launched: tuple, idle: tuple, walls: dict):
    """One DKG wave on the card: the counts set to 0 just before and read
    just after, its wall, lanes, launches and peak device memory."""
    import torch

    from charon_tpu_torch.ops import mont_kernels as MK

    torch.cuda.reset_peak_memory_stats()
    MK.reset_launches()
    out = stage(f"dkg_{name}", fn, walls)
    launches = dict(MK.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"dkg wave {name}: {lanes} lanes in {walls[f'dkg_{name}']:.3f} s, peak memory {peak:.2f} GiB, launches",
        json.dumps({k: c for k, c in launches.items() if c}))
    _check_launches(launches, f"DKG {name}", launched, idle)
    MK.reset_launches()
    return out, launches


def _flagged(name: str, lhs: list, rhs: list, want: list) -> None:
    bad = [i for i, (a, b) in enumerate(zip(lhs, rhs)) if a != b]
    if len(lhs) != len(rhs) or bad != want:
        raise AssertionError(f"DKG {name}: lanes {bad[:8]} disagree, want exactly {want}")


def run_dkg(seed: int, validators: int = DKG_VALIDATORS) -> dict:
    """One node's round-2 verification waves of a 4-of-7 FROST DKG over
    `validators` validators (BASELINE config 4) on the card, then the
    cluster ceremony (run_ceremony) and a reshare rotation end to end
    through the port's dkg/ modules, an int8 share wave and the tuner's
    ceremony axes. Returns each kernel's launches over the three full-width
    waves and the ceremony (the int8 wave's for K4-K6)."""
    import asyncio

    from charon_tpu_torch.core.autotune import KernelConfig
    from charon_tpu_torch.crypto import g1g2, shamir
    from charon_tpu_torch.crypto.fields import R
    from charon_tpu_torch.dkg import frost, reshare
    from charon_tpu_torch.ops.blsops import BlsEngine

    n, t, v, me = DKG_N, DKG_T, validators, DKG_ME
    G = g1g2.G1_GEN
    engine = BlsEngine()
    walls: dict = {}
    rng = random.Random(f"dkg/{seed}")
    lanes = n * v  # lane (i - 1) * v + val: peer i's ceremony of validator val, frost's order
    t0 = time.perf_counter()
    polys = [[rng.randrange(1, R) for _ in range(t)] for _ in range(lanes)]
    nonces = [rng.randrange(1, R) for _ in range(lanes)]
    log(f"dkg: {n} parties, t = {t}, {v} validators, node {me}: {lanes} lanes a wave; "
        f"host secrets in {time.perf_counter() - t0:.1f} s")

    # round 1 of every peer: the commitments C_ik = [a_ik] G and nonce points
    # R = [k] G, built on the card
    scalars = [c for poly in polys for c in poly] + nonces
    pts, _ = _wave("commitments", lambda: engine.g1_gen_mul_batch(scalars), len(scalars),
                   ("mont_mul_fp",), G1_ONLY_IDLE + ("mont_mul_fr",), walls)
    commits = [pts[lane * t : (lane + 1) * t] for lane in range(lanes)]
    r_pts = pts[lanes * t :]
    for k in random.Random(f"dkg/{seed}/c").sample(range(len(scalars)), min(DKG_SAMPLE, len(scalars))):
        if pts[k] != g1g2.g1_mul(G, scalars[k]):
            raise AssertionError(f"DKG commitments: point {k} differs from g1_mul")
    t0 = time.perf_counter()
    shares = [_horner(poly, me) for poly in polys]
    chal = [frost._pok_challenge(DKG_CTX, lane // v + 1, commits[lane][0], r_pts[lane]) for lane in range(lanes)]
    mus = [(k + poly[0] * c) % R for k, poly, c in zip(nonces, polys, chal)]
    forged_share, forged_pok = rng.randrange(lanes), rng.randrange(lanes)
    shares[forged_share] = (shares[forged_share] + 1) % R
    mus[forged_pok] = (mus[forged_pok] + 1) % R
    sample = sorted(rng.sample(range(lanes), min(DKG_SAMPLE, lanes)))
    log(f"dkg: round-1 shares, challenges and responses on the host in {time.perf_counter() - t0:.1f} s; "
        f"forged share lane {forged_share}, forged proof lane {forged_pok}")
    default_waves: dict = {}

    # the proof-of-knowledge wave: [mu] G (fixed-base table) against R + [c] A0
    # (ladder, then the sum on the card where frost adds on the host)
    def pok_wave():
        a0c = engine.g1_scalar_mul_batch([c[0] for c in commits], chal)
        return engine.g1_gen_mul_batch(mus), a0c, engine.aggregate_pks_batch([[r, ac] for r, ac in zip(r_pts, a0c)])

    (lhs, a0c, rhs), default_waves["pok"] = _wave(
        "pok", pok_wave, lanes, ("mont_mul_fp",), G1_ONLY_IDLE + ("mont_mul_fr",), walls
    )
    _flagged("pok", lhs, rhs, [forged_pok])
    for k in sample:
        if lhs[k] != g1g2.g1_mul(G, mus[k]) or rhs[k] != g1g2.g1_add(r_pts[k], g1g2.g1_mul(commits[k][0], chal[k])):
            raise AssertionError(f"DKG pok: lane {k} differs from the host oracle")
    log(f"dkg pok: only lane {forged_pok} flagged")

    # the share wave: [f_i(me)] G (fixed-base table) against sum_k C_ik me^k (Straus)
    (lhs, rhs), default_waves["share"] = _wave(
        "share", lambda: (engine.g1_gen_mul_batch(shares), engine.commitment_eval_batch(commits, [me] * lanes, t)),
        lanes, ("mont_mul_fp", "mont_mul_fr"), G1_ONLY_IDLE, walls,
    )
    _flagged("share", lhs, rhs, [forged_share])
    for k in sample:
        if lhs[k] != g1g2.g1_mul(G, shares[k]) or rhs[k] != _host_eval(commits[k], me, t):
            raise AssertionError(f"DKG share: lane {k} differs from the host oracle")
    log(f"dkg share: only lane {forged_share} flagged")

    # the pubshare wave: every (validator, j) lane evaluates the n
    # concatenated commitment vectors at j (width n t), against [s_j] G
    # through the fixed-base table, s_j = sum_i f_i(j) (every share is known here)
    rows = [[c for i in range(n) for c in commits[i * v + val]] for val in range(v) for _ in range(n)]
    xs = [j for _ in range(v) for j in range(1, n + 1)]
    pub, default_waves["pubshare"] = _wave(
        "pubshare", lambda: engine.commitment_eval_batch(rows, xs, t), len(rows),
        ("mont_mul_fp", "mont_mul_fr"), G1_ONLY_IDLE, walls,
    )
    sj = [sum(_horner(polys[i * v + val], j) for i in range(n)) % R for val in range(v) for j in range(1, n + 1)]
    table, _ = _wave("pubshare_table", lambda: engine.g1_gen_mul_batch(sj), len(sj),
                     ("mont_mul_fp",), G1_ONLY_IDLE + ("mont_mul_fr",), walls)
    _flagged("pubshare", pub, table, [])
    for k in sample:
        if pub[k] != _host_eval(rows[k], xs[k], t):
            raise AssertionError(f"DKG pubshare: lane {k} differs from the host oracle")
    log(f"dkg pubshare: {len(pub)} lanes equal through Straus and the fixed-base table")

    # the engine calls no wave above makes: G2 ladders and Lagrange rows
    g2b = [g1g2.g2_mul(g1g2.G2_GEN, rng.randrange(1, R)) for _ in range(DKG_SAMPLE)]
    ks = [rng.randrange(R) for _ in range(DKG_SAMPLE)]
    got, _ = _wave("g2_scalar_mul", lambda: engine.g2_scalar_mul_batch(g2b, ks), DKG_SAMPLE,
                   ("fp2_mul", "fp2_sqr"), INT8_KERNELS, walls)
    if got != [g1g2.g2_mul(p, k) for p, k in zip(g2b, ks)]:
        raise AssertionError("DKG g2_scalar_mul_batch differs from g2_mul")
    idx = [sorted(rng.sample(range(1, n + 1), t)) for _ in range(DKG_SAMPLE)]
    at = [rng.randrange(n + 2) for _ in range(DKG_SAMPLE)]
    got, _ = _wave("lagrange", lambda: engine.lagrange_coeffs_batch(idx, at), DKG_SAMPLE,
                   ("mont_mul_fr",), G1_ONLY_IDLE + ("mont_mul_fp",), walls)
    for row, x, coeffs in zip(idx, at, got):
        for j, xj in enumerate(row):
            num = den = 1
            for xm in row[:j] + row[j + 1 :]:
                num, den = num * (x - xm) % R, den * (xj - xm) % R
            if coeffs[j] != num * pow(den, -1, R) % R:
                raise AssertionError(f"DKG lagrange_coeffs_batch: row {row} at {x} differs")

    # the cluster ceremony end to end: FROST, the signature rounds and the lock
    ceremony_launches = run_ceremony(engine, seed, walls)

    # a reshare rotation end to end (bench_dkg.py's accelerator shape)
    rn_, rt_, rv_ = DKG_RESHARE
    old_shares, old_pubs, gpks = {}, [], []
    for _ in range(rv_):
        secret = rng.randrange(1, R)
        split = shamir.split(secret, rn_, rt_, rand=lambda: rng.randrange(1, R))
        for i, s_ in split.items():
            old_shares.setdefault(i, []).append(s_)
        old_pubs.append({i: g1g2.g1_mul(G, s_) for i, s_ in split.items()})
        gpks.append(g1g2.g1_mul(G, secret))
    cfg = reshare.ReshareConfig(tuple(range(1, rn_ + 1)), tuple(range(1, rn_ + 1)), rt_, rt_, rv_, DKG_CTX)

    async def rotation():
        net = reshare.MemReshareTransport(cfg.old_indices, timeout=600.0)
        return await asyncio.gather(*(
            reshare.run_reshare_parallel(net.participant(i), i, cfg, old_pubs, gpks, share_secrets=old_shares[i],
                                         engine=engine)
            for i in cfg.old_indices
        ))

    res, _ = _wave("reshare", lambda: asyncio.run(rotation()), rv_ * (rn_ + 1) * rn_ * rt_,
                   ("mont_mul_fp", "mont_mul_fr"), G1_ONLY_IDLE, walls)
    for val in range(rv_):
        rec = shamir.recover_secret({j: res[j - 1][val].secret_share for j in range(1, rt_ + 1)})
        if g1g2.g1_mul(G, rec) != gpks[val] or any(r[val].group_pubkey != gpks[val] for r in res):
            raise AssertionError(f"DKG reshare moved validator {val}'s group key")
        if any(res[j - 1][val].secret_share == old_shares[j][val] for j in range(1, rn_ + 1)):
            raise AssertionError(f"DKG reshare left a share of validator {val} unrotated")
    log(f"dkg reshare: {rn_} nodes, t = {rt_}, {rv_} validators rotated, every group key recovered unchanged")

    # the int8 configuration: a share wave on the first DKG_INT8_LANES lanes
    k8 = min(DKG_INT8_LANES, lanes)
    KernelConfig(mxu_mont=True).apply()
    try:
        (l8, r8), int8_launches = _wave(
            "share_int8",
            lambda: (engine.g1_gen_mul_batch(shares[:k8]), engine.commitment_eval_batch(commits[:k8], [me] * k8, t)),
            k8, ("mont_mul_mxu_fp", "mont_mul_mxu_fr"), DEFAULT_KERNELS + ("fp2_mul_mxu", "fp2_sqr_mxu"), walls,
        )
    finally:
        KernelConfig().apply()
    if l8 != lhs[:k8] or r8 != rhs[:k8]:
        raise AssertionError("DKG int8 share wave differs from the default one")

    # the tuner's ceremony axes at the waves' lanes
    run_tuner(lanes, "ceremony_straus", TUNER_CEREMONY_REPS)
    run_tuner(rv_ * (rn_ + 1) * rn_ * rt_, "ceremony_msm_w8", TUNER_CEREMONY_REPS)
    KernelConfig().apply()

    log("dkg walls (s):", json.dumps(walls))
    return {
        name: (
            int8_launches[name] if name in INT8_KERNELS
            else sum(w[name] for w in default_waves.values()) + ceremony_launches[name]
        )
        for name in KERNELS
    }


class _TimedPort:
    """A ceremony exchange port that records when each exchange round
    completes (the first node to return from it: every node had sent)."""

    def __init__(self, port, marks: dict):
        self.port, self.marks = port, marks

    async def exchange(self, tag: str, payload):
        out = await self.port.exchange(tag, payload)
        self.marks.setdefault(tag, time.perf_counter())
        return out


def _counted(impl, calls: dict):
    """Count the tbls calls the ceremony makes of `impl`, by kind."""
    for name in TBLS_CALLS:
        fn = getattr(impl, name)

        def wrapper(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        setattr(impl, name, wrapper)
    return impl


def _refused(lock_cls, data: dict, pubs: list, what: str) -> None:
    from charon_tpu_torch.tbls import TblsError

    try:
        lock_cls.from_json(data).verify(pubs)
    except (TblsError, ValueError) as e:
        log(f"dkg ceremony: {what} refused: {e}")
        return
    raise AssertionError(f"DKG ceremony: {what} accepted")


def run_ceremony(engine, seed: int, walls: dict) -> dict:
    """The cluster ceremony (dkg/ceremony.run_dkg) on the card: a signed
    cluster definition of DKG_CEREMONY's operators, then every node's
    run_dkg in one event loop with the card engine for FROST's waves and
    TorchImpl() on the card in the tbls registry for the signature rounds,
    then ClusterLock.verify of node 0's lock file through that TorchImpl.
    The lock, its tamperings, the deposits and the keystores are held
    against the port's host PythonImpl. Returns each kernel's launches."""
    import asyncio
    import collections
    import tempfile
    from pathlib import Path

    from charon_tpu_torch import tbls
    from charon_tpu_torch.app import k1util
    from charon_tpu_torch.cluster import ClusterDefinition, ClusterLock, Operator
    from charon_tpu_torch.crypto import g1g2, shamir
    from charon_tpu_torch.dkg import ceremony, frost  # the module: this script has a run_dkg of its own
    from charon_tpu_torch.eth2util import deposit, keystore
    from charon_tpu_torch.tbls.python_impl import PythonImpl
    from charon_tpu_torch.tbls.torch_impl import TorchImpl

    n, t, v = DKG_CEREMONY
    rng = random.Random(f"ceremony/{seed}")
    keys = [k1util.private_key_from_bytes(rng.randbytes(32)) for _ in range(n)]
    pubs = [k1util.public_key_to_bytes(k.public_key()) for k in keys]
    defn = ClusterDefinition(
        name="chip-smoke", num_validators=v, threshold=t, fork_version=MAINNET_FORK,
        operators=tuple(Operator(address=f"0xop{i}", enr=f"enr:-node-{i}") for i in range(n)),
    )
    for i, key in enumerate(keys):
        defn = defn.sign_operator(i, key)
    defn.verify_signatures(pubs)
    calls: collections.Counter = collections.Counter()
    impl = _counted(TorchImpl(), calls)
    tbls.set_implementation(impl)
    marks: dict = {}

    async def all_nodes(data: Path):
        fnet, xnet = frost.MemFrostTransport(n), ceremony.MemExchangeNet(n)
        return await asyncio.gather(*(
            ceremony.run_dkg(defn, i, keys[i], fnet.participant(i + 1), _TimedPort(xnet.port(i), marks),
                             engine=engine, data_dir=data / f"node{i}")
            for i in range(n)
        ))

    def the_ceremony(data: Path):
        t0 = time.perf_counter()
        res = asyncio.run(all_nodes(data))
        bounds = [t0] + [marks[tag] for tag in ("deposit-sig", "registration-sig", "lock-sig", "node-sig")]
        for name, a, b in zip(("frost", "deposit_round", "registration_round", "lock_round"), bounds, bounds[1:]):
            walls[f"ceremony_{name}"] = b - a
        walls["ceremony_outputs"] = time.perf_counter() - bounds[-1]
        t0 = time.perf_counter()
        ClusterLock.load(str(data / "node0" / "cluster-lock.json")).verify(pubs)
        walls["ceremony_lock_verify"] = time.perf_counter() - t0
        return res

    try:
        with tempfile.TemporaryDirectory(prefix="chip-smoke-dkg-") as tmp:
            data = Path(tmp)
            res, launches = _wave("ceremony", lambda: the_ceremony(data), n * v,
                                  DEFAULT_KERNELS, INT8_KERNELS, walls)
            log("dkg ceremony walls (s):", json.dumps({k: round(w, 3) for k, w in walls.items()
                                                       if k.startswith("ceremony_")}))
            log("dkg ceremony tbls calls on the card:", json.dumps(dict(calls)))

            # FROST: every node derived the same keys, t shares recover each group key
            lock = res[0].lock
            if any(r.lock.lock_hash() != lock.lock_hash() or r.lock.signature_aggregate != lock.signature_aggregate
                   for r in res):
                raise AssertionError("DKG ceremony: the nodes' locks differ")
            for val, dv in enumerate(lock.validators):
                shares = [int.from_bytes(r.share_secrets[val], "big") for r in res]
                secret = shamir.recover_secret({i + 1: shares[i] for i in range(t)})
                if g1g2.g1_to_bytes(g1g2.g1_mul(g1g2.G1_GEN, secret)) != bytes.fromhex(dv.distributed_public_key[2:]):
                    raise AssertionError(f"DKG ceremony: t shares do not recover validator {val}'s group key")
                if any("0x" + g1g2.g1_to_bytes(g1g2.g1_mul(g1g2.G1_GEN, s)).hex() != dv.public_shares[i]
                       for i, s in enumerate(shares)):
                    raise AssertionError(f"DKG ceremony: validator {val}'s shares do not match its pubshares")
            for i, r in enumerate(res):
                if keystore.load_keys(data / f"node{i}" / "validator_keys") != r.share_secrets:
                    raise AssertionError(f"DKG ceremony: node {i}'s keystores do not decrypt to its shares")
            log(f"dkg ceremony: {n} nodes, t = {t}, {v} validators: equal locks, t shares recover each group "
                f"key, the pubshares match, every node's keystores decrypt to its shares")

            # the same lock on the host backend, and its tamperings on both backends
            lock_json = json.loads((data / "node0" / "cluster-lock.json").read_text())
            flipped = bytearray(bytes.fromhex(lock_json["signature_aggregate"][2:]))
            flipped[40] ^= 1
            amount = json.loads(json.dumps(lock_json))
            amount["distributed_validators"][0]["deposit_data"]["amount"] = str(deposit.DEFAULT_AMOUNT_GWEI - 1)
            # resealed, as a forger would: the lock hash then passes and the aggregate signature is what refuses it
            del amount["lock_hash"]
            amount["lock_hash"] = "0x" + ClusterLock.from_json(amount).lock_hash().hex()
            tampered = {"a flipped byte of signature_aggregate": dict(lock_json, signature_aggregate="0x" + flipped.hex()),
                        "a changed deposit amount": amount}
            for backend, label in ((impl, "TorchImpl on the card"), (PythonImpl(), "PythonImpl on the host")):
                tbls.set_implementation(backend)
                for what, bad in tampered.items():
                    _refused(ClusterLock, bad, pubs, f"{what} ({label})")
            host = PythonImpl()
            tbls.set_implementation(host)
            ClusterLock.from_json(lock_json).verify(pubs)
            fork = bytes.fromhex(MAINNET_FORK[2:])
            for d in json.loads((data / "node0" / "deposit-data.json").read_text()):
                pubkey = bytes.fromhex(d["pubkey"])
                msg = deposit.DepositMessage(pubkey, bytes.fromhex(d["withdrawal_credentials"]), int(d["amount"]))
                host.verify(pubkey, deposit.signing_root(msg, fork), bytes.fromhex(d["signature"]))
            log("dkg ceremony: the lock verified through TorchImpl on the card and by PythonImpl on the host, "
                "each deposit signature under its group key on the host, both tamperings refused by both")
    finally:
        tbls.set_implementation(None)
    return launches


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Phase 10: the node binary on the card
# ---------------------------------------------------------------------------

NODE_N, NODE_T = 7, 4  # BASELINE config 2's 4-of-7 split
NODE_VALIDATORS = 16  # a common DV cluster's size; the nodes' validator clients sign on the host
# the default --node-slot, s: slot 0's duties missed their deadline at 12
# (mainnet) and 24 s and met it at 36 s with the block broadcast 88-142 s
# into the 180 s window; 48 s (deadline 240 s) keeps a margin against that
# spread between runs (PERF.md section 4)
NODE_SLOT = 48.0
NODE_SLOTS_PER_EPOCH = 32
NODE_LIMIT = 4.0  # PERF.md section 2: slot start to broadcast, s
NODE_HOST = "127.0.0.1"
NODE_DUTIES = ("attester", "randao", "proposer")  # a slot's, in the broadcast spans' and counter's labels
# genesis this long after the nodes are launched: node 0's boot (the tuner's
# profile load, prewarm, the point-cache warm-up), the remote nodes' boots
# and their probes run first. They took 36.0-58.0 s in node sweeps and
# whole runs on the card with the card to themselves (PERF.md section 4);
# beside phases 5-9 they share it and the host's cores, and a cluster not
# ready by genesis fails the phase. Genesis at the launch, with the first slot after the
# cluster is ready measured, missed that slot's deadline: the card does not
# keep up with a slot every 48 s, so the slots of the boot pile up
NODE_BOOT = 120.0
# the remote nodes' own planes only back their RemotePlane up: no tuner,
# prewarm or warm-up of their own
NODE_REMOTE_FLAGS = ("--crypto-plane", "on", "--crypto-autotune", "off", "--crypto-plane-prewarm", "off",
                     "--crypto-plane-warmup", "off")


def node_profile_path():
    """Where phase 4 persists the tuner's profile, which node 0 loads at boot."""
    from charon_tpu_torch.core import autotune
    from charon_tpu_torch.ops import mont_kernels as MK

    return MK.BUILD_DIR / "node" / autotune.PROFILE_BASENAME


def make_node_cluster(out_dir: str, slot_duration: float) -> dict:
    """The node cell's cluster on disk: testutil/compose.generate through
    the port's `create-cluster` (the host tbls backend: an in-memory
    ceremony, FROST on the host) and every node's `cli run` line."""
    from charon_tpu_torch.testutil import compose

    t0 = time.perf_counter()
    cfg = compose.generate(out_dir, n=NODE_N, threshold=NODE_T, validators=NODE_VALIDATORS,
                           slot_duration=slot_duration, slots_per_epoch=NODE_SLOTS_PER_EPOCH)
    log(f"node cluster: create-cluster ({NODE_N} nodes, {NODE_T}-of-{NODE_N}, {NODE_VALIDATORS} validators) "
        f"in {time.perf_counter() - t0:.1f} s")
    return cfg


def _arg(argv: list, flag: str, value=None) -> list:
    """argv with `flag`'s value replaced (or the flag dropped, value None)."""
    i = argv.index(flag)
    if value is None:
        return argv[:i] + argv[i + 2:]
    return argv[:i + 1] + [str(value)] + argv[i + 2:]


def _launch_ports(nodes: list) -> tuple[list, int]:
    """The nodes with fresh p2p, validator-API and monitoring ports in their
    command lines, picked as they launch (compose.generate picked its own
    when it wrote the cluster), and a port for node 0's crypto service."""
    from charon_tpu_torch.testutil import compose

    n = len(nodes)
    ports = compose._free_ports(3 * n + 1)
    p2p, vapi, mon = ports[:n], ports[n:2 * n], ports[2 * n:3 * n]
    peers = ",".join(f"{NODE_HOST}:{p}" for p in p2p)
    out = []
    for i, node in enumerate(nodes):
        argv = node["argv"]
        for flag, value in (("--peers", peers), ("--p2p-port", p2p[i]), ("--validator-api-port", vapi[i]),
                            ("--monitoring-port", mon[i])):
            argv = _arg(argv, flag, value)
        out.append({**node, "p2p_port": p2p[i], "validator_api_port": vapi[i], "monitoring_port": mon[i],
                    "argv": argv})
    return out, ports[-1]


def _metric(text: str, name: str, **labels) -> float:
    """The sum of a family's samples whose labels include `labels`."""
    total = 0.0
    for line in text.splitlines():
        if not line.startswith(name + "{") and not line.startswith(name + " "):
            continue
        head, value = line.rsplit(" ", 1)
        if all(f'{k}="{v}"' in head for k, v in labels.items()):
            total += float(value)
    return total


def _samples(text: str, name: str) -> dict:
    """{label string: value} of one family's samples."""
    out = {}
    for line in text.splitlines():
        if line.startswith(name + "{"):
            head, value = line.rsplit(" ", 1)
            out[head[len(name):]] = float(value)
    return out


def _by(samples: dict, label: str) -> dict:
    """{value of `label`: sample} of _samples' output."""
    import re

    out = {}
    for head, value in samples.items():
        m = re.search(rf'{label}="([^"]*)"', head)
        out[m.group(1) if m else head] = value
    return out


def _get(url: str, timeout: float = 5.0):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post(url: str, body, timeout: float = 30.0):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _rss_mib() -> float:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**20


def _compute_apps() -> str:
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return "; ".join(line.strip() for line in out.stdout.splitlines()) or out.stderr.strip()


def run_node(seed: int, slot_duration: float, cluster_dir: str | None = None) -> dict:
    """A 4-of-7, 16-validator cluster as seven `charon run` nodes on the
    card, through the node's entry points: `testutil/compose.generate`
    writes the cluster with the port's `create-cluster` (or it was written
    beforehand into `cluster_dir`) and each node's `cli run` line; the
    ports are picked as the nodes launch, and genesis is NODE_BOOT s after
    the launch. Node 0 runs in this process through `app.run.run(config,
    stop)` with the Config that `cmd/cli.run_config` builds from its line,
    `--no-tpu` replaced by `--crypto-plane on --crypto-serve <port>`: the
    card's TorchImpl, its SlotCryptoPlane and coalescer behind the
    tenant service, served over TCP to tokens for node1..node6; its boot
    loads phase 4's tuner profile, prewarms (one verify bucket) and warms
    the point caches. Nodes 1-6 are `python -m charon_tpu_torch.cmd.cli
    run` processes with `--crypto-plane on --crypto-remote <node 0>` and
    no tuner, prewarm or warm-up of their own: a RemotePlane each, its
    own plane only the local rung. p2p is k1 TCP, consensus QBFT, each
    node with its validator mock and flight recorder, as build_node wires
    them. Before genesis a client with a wrong token is refused and each
    remote node's RemotePlane settles its probe on one verify (a partial
    exit signed with another node's share, refused with 400 by its
    validator API). Fails unless, by slot 0's deadline: node 0's
    attestations and block are the host signatures of the group secret
    (recovered from t shares read from the keystores); every node
    broadcasts the attester duty (16 validators), randao and block (its
    /metrics and /debug/traces); node 0's tracker reports no missed duty;
    no inline tbls call and nothing shed; node 0's process launches the
    kernels of the configuration its tuner profile chose (K1-K3 and not
    K4-K6, or the reverse); every remote node's
    jobs ran remote (no failover, shed or disconnect) with its lanes in
    node 0's flushes and no flush of its own coalescer; and after the stop
    (SIGTERM to nodes 1-6, `stop` for node 0) every node's flight dump
    merges (`cli flight merge`) into one timeline. Returns the kernels'
    launches in node 0's process from genesis to the last broadcast.
    On a missed deadline each node's slot-0 waterfall, consensus sniffer,
    flight ring, metrics and log land in the cluster's diagnostics/."""
    import asyncio
    import signal
    import statistics
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from charon_tpu_torch.app import run as app_run
    from charon_tpu_torch.cmd import cli
    from charon_tpu_torch.core import autotune
    from charon_tpu_torch.core.cryptosvc_client import RemotePlane
    from charon_tpu_torch.core.deadline import SlotClock
    from charon_tpu_torch.core.eth2data import SignedData, VoluntaryExit
    from charon_tpu_torch.core.types import Duty, DutyType
    from charon_tpu_torch.crypto import shamir
    from charon_tpu_torch.eth2util import keystore
    from charon_tpu_torch.ops import mont_kernels as MK
    from charon_tpu_torch.parallel import SlotCryptoPlane
    from charon_tpu_torch.tbls.python_impl import PythonImpl, int_to_sk, sk_to_int
    from charon_tpu_torch.tbls.torch_impl import TorchImpl
    from charon_tpu_torch.testutil import compose

    work = cluster_dir or tempfile.mkdtemp(prefix="node-cluster-", dir=MK.BUILD_DIR)
    cfg_path = os.path.join(work, "compose.json")
    cfg = json.load(open(cfg_path)) if os.path.exists(cfg_path) else make_node_cluster(work, slot_duration)
    nodes, serve_port = _launch_ports(cfg["nodes"])
    tokens = {f"node{i}": f"node{i}-token-{seed}-{random.Random(seed).getrandbits(64):x}" for i in range(1, NODE_N)}
    profile = node_profile_path()
    # node 0 boots on the profile's kernels, as a node on this card would
    int8 = bool(autotune.load_profile(profile)["config"].get("mxu_mont"))
    launched, idle = (INT8_KERNELS, DEFAULT_KERNELS) if int8 else (DEFAULT_KERNELS, INT8_KERNELS)
    host = PythonImpl()

    # the cluster's keys: t shares a validator recover its group secret
    with ThreadPoolExecutor(NODE_N) as pool:  # each keystore's pbkdf2 releases the GIL
        shares = list(pool.map(lambda n: keystore.load_keys(os.path.join(n["data_dir"], "validator_keys")), nodes))
    lock = json.load(open(os.path.join(nodes[0]["data_dir"], "cluster-lock.json")))
    group_pks = [bytes.fromhex(v["distributed_public_key"][2:]) for v in lock["distributed_validators"]]

    def group_secret(v: int) -> bytes:
        return int_to_sk(shamir.recover_secret({i + 1: sk_to_int(shares[i][v]) for i in range(NODE_T)}))

    # node 0: the Config that `cli run` builds from its compose line
    genesis = time.time() + NODE_BOOT
    argv0 = nodes[0]["argv"][3:]  # past `python -m charon_tpu_torch.cmd.cli`
    argv0 = _arg(argv0, "--genesis-time", genesis)
    argv0 = [a for a in argv0 if a != "--no-tpu"] + [
        "--crypto-plane", "on", "--crypto-serve", str(serve_port), "--crypto-serve-host", NODE_HOST,
        "--crypto-tenant", "node0", "--crypto-autotune", "auto", "--crypto-autotune-profile", str(profile),
    ]
    os.environ["CHARON_TPU_CRYPTO_SERVE_TOKENS"] = ",".join(f"{k}={v}" for k, v in tokens.items())
    rc, config = cli.run_config(cli.build_parser().parse_args(argv0))
    del os.environ["CHARON_TPU_CRYPTO_SERVE_TOKENS"]
    if rc:
        raise AssertionError(f"node 0: `cli run` refused its flags ({rc})")
    clock = SlotClock(genesis, slot_duration)
    slot = 0
    start = clock.slot_start(slot)
    deadline = clock.duty_deadline(Duty(slot, DutyType.ATTESTER))

    # node 0's components, for the checks: the node that app.run.run builds
    built: dict = {}
    build_node = app_run.build_node

    async def capture(config):
        node = await build_node(config)
        built["node"] = node
        return node

    inline: dict[str, int] = {}
    inline_calls = ("verify", "verify_batch", "verify_aggregate", "threshold_aggregate_batch", "aggregate_batch")
    originals = {name: getattr(TorchImpl, name) for name in inline_calls}

    def counted(name):
        def call(self, *args, **kwargs):
            inline[name] = inline.get(name, 0) + 1
            return originals[name](self, *args, **kwargs)

        return call

    prewarm = (SlotCryptoPlane.PREWARM_VERIFY_LANES, SlotCryptoPlane.PREWARM_RECOMBINE_LANES)
    SlotCryptoPlane.PREWARM_VERIFY_LANES = PLANE_PREWARM_LANES  # the cut of phase 8 (PERF.md section 4)
    SlotCryptoPlane.PREWARM_RECOMBINE_LANES = PLANE_PREWARM_RECOMBINE_LANES
    app_run.build_node = capture
    for name in inline_calls:
        setattr(TorchImpl, name, counted(name))

    flushes: list = []
    lags: list = []
    remote = {}  # node index -> Popen
    boot: dict = {}  # node index -> seconds from launch to ready
    scraped: dict = {}  # node index -> (metrics text, traces)
    result: dict = {}
    stop = asyncio.Event()

    def on_flush(st):  # node 0's device thread, as each flush ends
        stats = torch.cuda.memory_stats()
        flushes.append(st)
        log(f"node 0 flush {len(flushes)}: {st.jobs} jobs, {st.lanes} lanes, {st.flush_seconds:.3f} s, ended "
            f"{time.time() - start:.1f} s into slot 0, tenants {dict(st.tenant_lanes)}; allocated "
            f"{stats.get('allocated_bytes.all.current', 0) / 2**20:.1f} MiB, reserved "
            f"{stats.get('reserved_bytes.all.current', 0) / 2**20:.1f} MiB, RSS {_rss_mib():.1f} MiB")

    async def loop_lag():
        """Node 0's event-loop stalls, as the lateness of a 0.1 s tick: the
        crypto server's heartbeat echoes share this loop with node 0's
        workflow and validator client."""
        while True:
            t0 = time.perf_counter()
            await asyncio.sleep(0.1)
            late = time.perf_counter() - t0 - 0.1
            if late > 0.25:
                lags.append((round(late, 3), round(time.time() - start, 1)))

    async def fetch(i: int, path: str, post=None):
        node = nodes[i]
        port = node["monitoring_port"] if path.startswith(("/metrics", "/debug")) else node["validator_api_port"]
        url = f"http://{NODE_HOST}:{port}{path}"
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, (lambda: _get(url)) if post is None else (lambda: _post(url, post)))

    def spawn(i: int):
        argv = _arg(nodes[i]["argv"], "--genesis-time", genesis)
        argv = [a for a in argv if a != "--no-tpu"] + list(NODE_REMOTE_FLAGS) + [
            "--crypto-remote", f"{NODE_HOST}:{serve_port}", "--crypto-tenant", f"node{i}"]
        env = {**os.environ, "CHARON_TPU_CRYPTO_TOKEN": tokens[f"node{i}"],
               "PYTHONPATH": str(compose.REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")}
        log_file = open(os.path.join(nodes[i]["data_dir"], "node.log"), "w")
        proc = subprocess.Popen(argv, env=env, cwd=str(compose.REPO), stdout=log_file, stderr=subprocess.STDOUT)
        log_file.close()
        return proc

    def node_log(i: int) -> str:
        try:
            return open(os.path.join(nodes[i]["data_dir"], "node.log")).read()[-3000:]
        except OSError:
            return ""

    async def wait_for(what: str, cond, until: float):
        while not await cond():
            for i, proc in remote.items():
                if proc.poll() is not None:
                    raise AssertionError(f"node {i} exited {proc.returncode}:\n{node_log(i)}")
            if time.time() > until:
                raise AssertionError(f"node: {what} not by {until - start:.1f} s into slot 0")
            await asyncio.sleep(0.2)

    async def diagnose():
        """Each node's slot-0 waterfall, consensus sniffer, flight ring,
        metrics and log under the cluster's diagnostics/, and a line a node
        of what it did."""
        out = os.path.join(work, "diagnostics")
        os.makedirs(out, exist_ok=True)
        for i in range(NODE_N):
            for name, path in (("duty0.txt", "/debug/duty/0?format=text"), ("consensus.json", "/debug/consensus"),
                               ("flight.txt", "/debug/flight?format=text"), ("metrics.txt", "/metrics")):
                try:
                    status, body = await fetch(i, path)
                except OSError as e:
                    status, body = 0, str(e).encode()
                with open(os.path.join(out, f"node{i}-{name}"), "wb") as f:
                    f.write(body)
            text = open(os.path.join(out, f"node{i}-metrics.txt")).read()
            log(f"node {i} at the deadline: broadcasts {json.dumps(_by(_samples(text, 'core_bcast_broadcast_total'), 'duty'))}"
                f"; decided {json.dumps(_by(_samples(text, 'core_consensus_decided_total'), 'duty'))}; rounds "
                f"{json.dumps(_by(_samples(text, 'core_consensus_decided_rounds'), 'duty'))}")
        for i in range(1, NODE_N):
            with open(os.path.join(out, f"node{i}.log"), "w") as f:
                f.write(node_log(i))
        log(f"node: diagnostics in {out}")

    async def drive(t_launch: float):
        node0 = None

        def task(name):
            return next((t for t in node0.life._tasks if t.get_name() == name), None)

        async def node0_ready():
            nonlocal node0
            node0 = built.get("node")
            return node0 is not None and task("crypto-serve") is not None and task("crypto-serve").done()

        await wait_for("node 0's crypto service", node0_ready, genesis)
        if task("crypto-serve").exception() is not None:
            raise AssertionError(f"node 0: its crypto service did not start: {task('crypto-serve').exception()!r}")
        coal = node0.crypto_plane
        inner = coal.stats_hook

        def chained(st):
            on_flush(st)
            inner(st)

        coal.stats_hook = chained
        for i in range(1, NODE_N):
            remote[i] = spawn(i)
        log(f"node: node 0 serves the card's plane on {NODE_HOST}:{serve_port} "
            f"({time.time() - t_launch:.1f} s after the launch); nodes 1-{NODE_N - 1} launched")
        async def node0_booted():
            return all(task(n) is not None and task(n).done() for n in ("crypto-prewarm", "crypto-cache-warmup"))

        await wait_for("node 0's prewarm and warm-up", node0_booted, genesis)
        for n in ("crypto-prewarm", "crypto-cache-warmup"):
            if task(n).exception() is not None:
                raise AssertionError(f"node 0: {n} failed: {task(n).exception()!r}")
        boot[0] = time.time() - t_launch

        # a client with a wrong token is refused at the handshake
        server = node0.crypto_server
        refused = server.auth_failures
        bad = RemotePlane(NODE_HOST, serve_port, "node1", "not-the-token", local=node0.vapi.plane)
        await bad.start()
        t0 = time.time()
        while server.auth_failures == refused and time.time() < t0 + 30:
            await asyncio.sleep(0.01)
        await bad.close()
        if server.auth_failures == refused or bad.connects or bad.remote_jobs:
            raise AssertionError(f"node: the wrong-token client was not refused ({server.auth_failures})")
        log(f"node: a client with a wrong token refused at the handshake ({server.auth_failures} refusal(s))")

        async def remote_ready(i):
            async def ready():
                try:
                    status, body = await fetch(i, "/metrics")
                except OSError:
                    return False
                return status == 200 and _metric(body.decode(), "tpu_plane_remote_state") >= 1

            await wait_for(f"node {i}'s connection", ready, genesis)
            boot[i] = time.time() - t_launch

        await asyncio.gather(*(remote_ready(i) for i in range(1, NODE_N)))

        async def probe(i):
            """One verify over node i's RemotePlane, its probe: a partial
            exit of validator 0 signed with another node's share, which
            node i's validator API refuses after the verify."""
            exit_msg = VoluntaryExit(epoch=0, validator_index=0)
            fork = node0.lock.fork_info()
            root = SignedData("exit", exit_msg).signing_root(fork, 0)
            sig = host.sign(shares[(i + 1) % NODE_N][0], root)
            status, body = await fetch(i, "/eth/v1/beacon/pool/voluntary_exits", post={
                "message": {"epoch": "0", "validator_index": "0"}, "signature": "0x" + sig.hex()})
            text = (await fetch(i, "/metrics"))[1].decode()
            if status != 400 or b"verification" not in body or _metric(text, "tpu_plane_remote_state") != 2:
                raise AssertionError(f"node {i}: the probe did not settle remote: {status} {body[:200]}")

        t0 = time.perf_counter()
        await asyncio.gather(*(probe(i) for i in range(1, NODE_N)))
        log(f"node: boot, s from the launch to ready: " + json.dumps({f"node{i}": round(s, 1) for i, s in
            sorted(boot.items())}) + f"; remote nodes probed in {time.perf_counter() - t0:.2f} s; genesis in "
            f"{genesis - time.time():.1f} s")
        log(f"node: the card's processes (pid, memory): {_compute_apps()}")
        if time.time() > genesis:
            raise AssertionError(f"node: the cluster was ready {time.time() - genesis:.1f} s after genesis")
        # from here on, the slot's work
        MK.reset_launches()
        inline.clear()
        flushes.clear()
        lag_task = asyncio.create_task(loop_lag())
        beacon = node0.beacon

        async def done():
            atts = sum(1 for a in beacon.attestations if a.data.slot == slot)
            props = sum(1 for p, _ in beacon.proposals if p.slot == slot)
            if atts < NODE_VALIDATORS or props < 1:
                return False
            for i in range(1, NODE_N):
                text = (await fetch(i, "/metrics"))[1].decode()
                if any(_metric(text, "core_bcast_broadcast_total", duty=d) < 1 for d in NODE_DUTIES):
                    return False
            return True

        beat = time.time()

        async def broadcasts() -> dict:
            out = {}
            for i in range(NODE_N):
                text = (await fetch(i, "/metrics"))[1].decode()
                out[i] = [int(_metric(text, "core_bcast_broadcast_total", duty=d)) for d in NODE_DUTIES]
            return out

        async def progress():
            nonlocal beat
            if time.time() > beat + 15:
                beat = time.time()
                log(f"node: {beat - start:.1f} s into slot 0: node 0 broadcast "
                    f"{sum(1 for a in beacon.attestations if a.data.slot == slot)} attestations and "
                    f"{sum(1 for p, _ in beacon.proposals if p.slot == slot)} blocks; broadcasts "
                    f"{list(NODE_DUTIES)} a node: {json.dumps(await broadcasts())}")
            return await done()

        try:
            await wait_for("slot 0's broadcasts on every node", progress, deadline)
        except AssertionError:
            await diagnose()
            raise
        finally:
            lag_task.cancel()
        result["launches"] = dict(MK.LAUNCHES)
        result["inline"] = dict(inline)
        result["reports"] = {d.type.name: await node0.tracker.duty_expired(d) for d in (
            Duty(slot, DutyType.ATTESTER), Duty(slot, DutyType.RANDAO), Duty(slot, DutyType.PROPOSER))}
        result["tenants"] = {tid: (node0.crypto_svc.tenant(tid).admitted_jobs,
                                   node0.crypto_svc.tenant(tid).completed_lanes,
                                   node0.crypto_svc.tenant(tid).shed)
                             for tid in ["node0"] + sorted(tokens)}
        result["node0_metrics"] = (await fetch(0, "/metrics"))[1].decode()
        for i in range(NODE_N):
            scraped[i] = ((await fetch(i, "/metrics"))[1].decode(), json.loads((await fetch(i, "/debug/traces"))[1]))
        result["beacon"] = beacon
        result["server_jobs"] = server.served_jobs
        log(f"node: the card's processes at the last broadcast (pid, memory): {_compute_apps()}")

    async def main():
        t_launch = time.time()
        runner = asyncio.create_task(app_run.run(config, stop))
        checks = asyncio.create_task(drive(t_launch))
        try:
            done, _ = await asyncio.wait({runner, checks}, return_when=asyncio.FIRST_COMPLETED)
            if runner in done:
                runner.result()  # a failed boot hook raises here
                raise AssertionError("node 0 stopped before the slot's duties")
            checks.result()
        finally:
            for i, proc in remote.items():  # SIGTERM: each dumps its flight ring
                if proc.poll() is None:
                    proc.send_signal(signal.SIGTERM)
            stop.set()
            if not checks.done():
                checks.cancel()
            await asyncio.gather(runner, checks, return_exceptions=True)
            for i, proc in remote.items():
                try:
                    proc.wait(timeout=20)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()

    t0 = time.perf_counter()
    try:
        asyncio.run(main())
    finally:
        app_run.build_node = build_node
        for name, fn in originals.items():
            setattr(TorchImpl, name, fn)
        SlotCryptoPlane.PREWARM_VERIFY_LANES, SlotCryptoPlane.PREWARM_RECOMBINE_LANES = prewarm
    log(f"node: slot 0's duties broadcast by all {NODE_N} nodes; the phase's run {time.perf_counter() - t0:.1f} s")

    # node 0's broadcasts: the host signature of the group secret
    beacon = result["beacon"]
    fork = built["node"].lock.fork_info()
    epoch = slot // NODE_SLOTS_PER_EPOCH
    committee = sorted(beacon.validators.items())  # committee index i: the i-th validator by pubkey
    index_of = {bytes(pk) if isinstance(pk, bytes) else bytes.fromhex(str(pk)[2:]): v for v, pk in
                enumerate(group_pks)}
    atts = [a for a in beacon.attestations if a.data.slot == slot]
    if len({a.data.index for a in atts}) != NODE_VALIDATORS:
        raise AssertionError(f"node 0: {len(atts)} attestations for {len({a.data.index for a in atts})} validators")

    def secret_of(pk) -> bytes:
        key = bytes.fromhex(str(pk)[2:]) if not isinstance(pk, (bytes, bytearray)) else bytes(pk)
        return group_secret(index_of[key])

    for att in atts:
        pk = committee[att.data.index][0]
        if att.signature != host.sign(secret_of(pk), SignedData("attestation", att).signing_root(fork, epoch)):
            raise AssertionError(f"node 0: validator {att.data.index}'s attestation is not the group secret's")
    proposal, psig = next((p, s) for p, s in beacon.proposals if p.slot == slot)
    proposer = committee[slot % NODE_VALIDATORS][0]
    if psig != host.sign(secret_of(proposer), SignedData("block", proposal).signing_root(fork, epoch)):
        raise AssertionError("node 0: the block's signature is not the group secret's")
    if proposal.block.body.randao_reveal != host.sign(secret_of(proposer), SignedData("randao", epoch).signing_root(
            fork, epoch)):
        raise AssertionError("node 0: the block's randao reveal is not the group secret's")
    missed = {k: (r.failed_step, r.reason, len(r.failed_pubkeys)) for k, r in result["reports"].items()
              if not r.success or r.failed_pubkeys}
    if missed:
        raise AssertionError(f"node 0: its tracker reports missed duties {missed}")
    if any(result["inline"].values()):
        raise AssertionError(f"node 0: inline tbls calls ran: {result['inline']}")
    shed = {tid: s for tid, (_, _, s) in result["tenants"].items() if s}
    if shed:
        raise AssertionError(f"node 0: the service shed submissions: {shed}")
    launches = result["launches"]
    _check_launches(launches, "node", launched, idle)
    log(f"node 0: its tuner profile chose mxu_mont={int8}, so {'K4-K6' if int8 else 'K1-K3'} ran and "
        f"{'K1-K3' if int8 else 'K4-K6'} did not")

    # every node: slot 0's duties broadcast, from its traces and metrics
    lat: dict = {}
    for i in range(NODE_N):
        text, spans = scraped[i]
        where = "node 0" if i == 0 else "remote"
        for duty in NODE_DUTIES:
            ends = [(s["start_us"] + s["duration_us"]) / 1e6 - start for s in spans
                    if s["name"] == "broadcaster.broadcast" and s["attrs"].get("slot") == slot
                    and s["attrs"].get("duty_type", "").lower().endswith(duty)]
            width = sum(s["attrs"].get("pubkeys", 0) for s in spans if s["name"] == "broadcaster.broadcast"
                        and s["attrs"].get("slot") == slot and s["attrs"].get("duty_type", "").lower().endswith(duty))
            if not ends or (duty == "attester" and width != NODE_VALIDATORS):
                raise AssertionError(f"node {i}: slot 0's {duty} duty not broadcast ({width} validators)")
            if max(ends) > deadline - start:
                raise AssertionError(f"node {i}: slot 0's {duty} duty broadcast after its deadline")
            lat.setdefault((duty, "all"), []).append(max(ends))
            lat.setdefault((duty, where), []).append(max(ends))
        for fam in ("tpu_plane_tenant_shed_total", "tpu_plane_remote_shed_total",
                    "tpu_plane_remote_failovers_total", "tpu_plane_remote_disconnects_total",
                    "core_tracker_failed_duties_total"):
            if _metric(text, fam):
                raise AssertionError(f"node {i}: {fam} {_samples(text, fam)}")
        if i:
            # no failover: every job went over the wire, so the node's own
            # coalescer took none; its plane ran no program (planeprof
            # files the remote flush briefs, which carry no program
            # samples, under the fallback family "device")
            own = {k: v for k, v in _samples(text, "tpu_plane_kernel_seconds_total").items()
                   if 'family="device"' not in k}
            if own or _metric(text, "tpu_plane_remote_connects_total") < 1:
                raise AssertionError(f"node {i}: programs on its own plane {own}, "
                                     f"{_metric(text, 'tpu_plane_remote_connects_total')} connects")
        rounds = _by(_samples(text, "core_consensus_decided_rounds"), "duty")
        log(f"node {i}: QBFT decided round, the last instance of each duty type: {json.dumps(rounds)}")
        if i:
            # a partial set's verify and a recombine, each a round trip over
            # the node's RemotePlane, beside the server's flush brief
            steps = {}
            for step in ("parsigex.receive", "sigagg.aggregate", "cryptoplane.flush"):
                n = _metric(text, "core_step_latency_seconds_count", step=step)
                steps[step] = [int(n), round(_metric(text, "core_step_latency_seconds_sum", step=step) / n, 3)
                               if n else None]
            log(f"node {i} remote: (count, mean s) a step: {json.dumps(steps)}")
    for (duty, where), xs in sorted(lat.items()):
        log(f"node {duty}: slot start to broadcast over {len(xs)} nodes ({where}): min {min(xs):.3f} s, median "
            f"{statistics.median(xs):.3f} s, max {max(xs):.3f} s (limit {NODE_LIMIT} s; slot {slot_duration} s, "
            f"deadline {deadline - start:.0f} s)")

    # the flight dumps of every node, merged by the CLI
    dumps = [os.path.join(nodes[0]["data_dir"], "flightrec", "node0.stop.jsonl")] + [
        os.path.join(nodes[i]["data_dir"], "flightrec", f"node{i}.crash.jsonl") for i in range(1, NODE_N)]
    missing = [d for d in dumps if not os.path.exists(d)]
    if missing:
        raise AssertionError(f"node: no flight dump at {missing}")
    merged = os.path.join(work, "flight-merged.jsonl")
    if cli.main(["flight", "merge", *dumps, "--format", "jsonl", "--output", merged]) != 0:
        raise AssertionError("node: `cli flight merge` failed")
    events = [json.loads(line) for line in open(merged)]
    timeline = os.path.join(work, "flight-timeline.txt")
    cli.main(["flight", "merge", *dumps, "--output", timeline])
    by_node: dict = {}
    for e in events:
        by_node.setdefault(e.get("node"), []).append(e)
    for i in range(NODE_N):
        mine = by_node.get(f"node{i}", [])
        flushes_i = [e for e in mine if e.get("category") == "flush"]
        faults = [e for e in mine if e.get("category") == "remote" and e.get("kind") in
                  ("failover", "shed", "remote_shed", "disconnect")]
        if i == 0:
            oks = [e for e in mine if e.get("kind") == "duty_ok" and e.get("slot") == slot]
            if len(oks) < len(NODE_DUTIES):
                raise AssertionError(f"node 0: its flight ring holds {len(oks)} duty outcomes of slot 0")
        elif not flushes_i or faults:
            # each remote result's flush brief lands in the ring as a flush
            raise AssertionError(f"node {i}: {len(flushes_i)} flush briefs in its flight ring, faults {faults[:3]}")
        log(f"node {i}: flight ring {len(mine)} events ({len(flushes_i)} flushes)")
    log(f"node: `cli flight merge` of {len(dumps)} dumps: {len(events)} events, {sum(1 for _ in open(timeline))} "
        f"timeline lines ({timeline})")

    # the remote tenants' lanes in node 0's flushes, and node 0's profile
    flushed: dict = {}
    for st in flushes:
        for tid, lanes in st.tenant_lanes:
            flushed[tid] = flushed.get(tid, 0) + lanes
    for tid in sorted(tokens):
        if not flushed.get(tid):
            raise AssertionError(f"node: tenant {tid} has no lanes in node 0's flushes: {flushed}")
    text0 = result["node0_metrics"]
    log("node: tenants (jobs, lanes, shed) at node 0's service: " + json.dumps(result["tenants"])
        + f"; the server served {result['server_jobs']} remote jobs; lanes in this run's flushes {json.dumps(flushed)}")
    log("node: a remote tenant's job at node 0's service (admission to result), s: " + json.dumps({
        tid: [round(_metric(text0, "tpu_plane_tenant_submit_seconds_count", tenant=tid)),
              round(_metric(text0, "tpu_plane_tenant_submit_seconds_sum", tenant=tid), 3)]
        for tid in sorted(tokens)}) + " (count, sum)")
    log("node 0 planeprof: device seconds by family " + json.dumps(
        {k: round(v, 3) for k, v in _by(_samples(text0, "tpu_plane_kernel_seconds_total"), "family").items()})
        + f"; device utilization {_metric(text0, 'tpu_plane_device_utilization'):.3f}")
    log(f"node 0: event loop stalls over 0.25 s (s late, s into slot 0), the worst first: "
        f"{sorted(lags, reverse=True)[:12]}; {sum(1 for x, _ in lags if x > 1)} over 1 s, "
        f"{sum(1 for x, _ in lags if x > 2)} over 2 s")
    log(f"node 0: {len(flushes)} flushes in the run; launches {json.dumps(launches)}")
    MK.reset_launches()
    return {name: launches[name] for name in KERNELS}


NODE_LAUNCHES = "node_launches"  # the key of the sweep's launch line


def node_sweep(seed: int, slots: list, cluster_dir: str | None = None) -> int:
    """The node phase alone at each slot duration in turn; a missed
    deadline is logged and the next duration runs. Each pass prints its
    launches as one JSON line. 0 if any passed. Without phase 4's profile
    (a sweep alone), the tuner runs here first, as phase 4 does."""
    if not node_profile_path().exists():
        run_tuner(1024 * NODE_T, persist=True)  # as phase 4: the 1k-validator duty's partials
    passed = []
    for slot in slots:
        t0 = time.perf_counter()
        try:
            launches = run_node(seed, slot, cluster_dir if len(slots) == 1 else None)
        except AssertionError as e:
            log(f"node sweep: slot {slot} s FAILED in {time.perf_counter() - t0:.1f} s: {e}")
            continue
        passed.append(slot)
        print(json.dumps({NODE_LAUNCHES: launches}), flush=True)
        log(f"node sweep: slot {slot} s passed in {time.perf_counter() - t0:.1f} s")
    log(f"node sweep: passed at {passed} of {slots}")
    return 0 if passed else 1


class PhaseProcess:
    """A phase in a process of its own, started at once, or as soon as the
    process `after` has exited 0, and run beside this process's phases on
    the same card. A thread passes its stdout through line by line under
    `label` and keeps the one line that starts with {"<key>": as the
    phase's result. It stays in this process's group, so that what ends the
    script's group ends it too; stop() ends it and every process it started
    (the node phase's nodes 1-6)."""

    def __init__(self, label: str, cmd: list, key: str, after=None, after_log: str | None = None,
                 watch: str | None = None):
        self.label, self.cmd, self.key, self.after, self.after_log = label, cmd, key, after, after_log
        self.proc, self.result, self.error = None, None, None
        # set once a line matching the regular expression `watch` has passed through
        self.watch, self.watched = watch, threading.Event()
        self._lock = threading.Lock()
        self._stopped = False
        self._thread = threading.Thread(target=self._run, name=label, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            if self.after is not None:
                rc = self.after.wait()
                tail = open(self.after_log).read() if self.after_log else ""
                for line in tail.splitlines():
                    _emit(f"  {self.label} {line}")
                if rc != 0:
                    self.error = f"{self.label}: the process it waits for exited {rc}"
                    return
            with self._lock:
                if self._stopped:
                    return
                self.proc = subprocess.Popen(self.cmd, stdout=subprocess.PIPE, text=True)
            for line in self.proc.stdout:
                if line.startswith("{" + json.dumps(self.key)):
                    self.result = json.loads(line)[self.key]
                else:
                    _emit(f"  {self.label} {line}")
                    if self.watch is not None and re.search(self.watch, line):
                        self.watched.set()
            rc = self.proc.wait()
            if rc != 0 or self.result is None:
                self.error = f"{self.label}: exited {rc}" + ("" if self.result is not None else " with no result line")
        except Exception as e:  # noqa: BLE001 — reported by wait()
            self.error = f"{self.label}: {e!r}"

    def wait(self):
        """The phase's result, once its process has ended; raises if it failed."""
        self._thread.join()
        if self.error:
            raise AssertionError(self.error)
        return self.result

    def stop(self) -> None:
        """End the process and every process it started, if it still runs."""
        import signal

        with self._lock:
            self._stopped = True
            proc = self.proc
        if proc is not None and proc.poll() is None:
            for pid in [proc.pid, *_descendants(proc.pid)]:
                try:
                    os.kill(pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
            proc.wait()
        self._thread.join(timeout=30)


def _descendants(pid: int) -> list:
    """The processes below `pid`, from /proc's parent links."""
    children: dict = {}
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                stat = open(f"/proc/{entry}/stat").read()
            except OSError:
                continue
            ppid = int(stat.rsplit(")", 1)[1].split()[1])
            children.setdefault(ppid, []).append(int(entry))
    out, todo = [], [pid]
    while todo:
        for child in children.get(todo.pop(), []):
            out.append(child)
            todo.append(child)
    return out


def phase_command(*flags) -> list:
    """This script, run again with `flags`, as a phase's process."""
    return [sys.executable, os.path.abspath(__file__), *map(str, flags)]


# ---------------------------------------------------------------------------
# The exit checks: a process ending with a plane's shard threads live
# ---------------------------------------------------------------------------

EXIT_RESULT = "exit_check"  # the key of the --exit-check process's result line
EXIT_PARALLEL = 2  # children at a time, beside phases 6-8


def exit_check(tries: int) -> int:
    """Reproductions 1 and 2 (testutil/exitcheck) on the card, `tries` times
    each: a child holding a plane over ["cuda:0"] * 2, its h2c program in
    flight, or an open coalescer over it, its verify flush in flight, ends
    by returning from main, by sys.exit(1) and by an uncaught exception,
    without close(). Each child's exit code, signal, seconds and exit
    report are logged; 1 unless every child ended with its own code, never
    a signal, within exitcheck.TIME_BOUND s, its work ended or raised and
    no shard thread alive."""
    from charon_tpu_torch.testutil import exitcheck

    t0 = time.perf_counter()
    results = exitcheck.run_checks("cuda:0", tries=tries, parallel=EXIT_PARALLEL)
    for r in results:
        log("exit check:", json.dumps({k: v for k, v in r.items() if k != "stderr"}))
    bad = exitcheck.failures(results)
    for line in bad:
        log("exit check FAILED:", line)
    print(json.dumps({EXIT_RESULT: {
        "children": len(results), "failures": len(bad), "seconds": round(time.perf_counter() - t0, 1),
        "max_child_seconds": max(r["seconds"] for r in results),
    }}), flush=True)
    return 1 if bad else 0


def stop_check(seed: int, slot: float) -> int:
    """Reproduction 3: the node phase in a PhaseProcess on a cluster of its
    own, stopped (stop(): every node SIGKILLed, the reader thread joined)
    as soon as node 0 has ended a flush in slot 0, the next of the slot's
    dependent flushes in flight; then this process returns 0 from main.
    Logs stop()'s seconds and the threads still alive; the caller reads
    this process's exit code."""
    from charon_tpu_torch.ops import mont_kernels as MK

    cluster_dir = str(MK.BUILD_DIR / f"stop-cluster-{os.getpid()}")
    make_node_cluster(cluster_dir, slot)
    phase = PhaseProcess(
        "node process", phase_command("--node-sweep", slot, "--seed", seed, "--node-cluster", cluster_dir),
        NODE_LAUNCHES, watch=r"node 0 flush \d+: .* ended \d",
    )
    if not phase.watched.wait(NODE_BOOT + 10 * slot):
        phase.stop()
        raise AssertionError("stop check: node 0 ended no flush in slot 0")
    t0 = time.perf_counter()
    phase.stop()
    log(f"stop check: stop() took {time.perf_counter() - t0:.1f} s; threads alive "
        f"{sorted(t.name for t in threading.enumerate())}")
    return 0


# ---------------------------------------------------------------------------
# Phase 11: adversarial input on the card
# ---------------------------------------------------------------------------

ADV_LANES = 56  # verify_batch lanes of the differential battery, 65 lanes with its other calls
ADV_VALIDATORS = 2  # group keys of the battery, each split 4-of-7
ADV_N, ADV_T = 7, 4
ADV_VICTIM_DUTIES = 2  # the victim tenant's duties, one after another: beside a shared flush, then a quarantined one
ADV_VICTIM_LANES = 4  # valid partials a victim duty verifies
ADV_BUDGET = 120.0  # s: a victim duty's deadline, above a flush's 4.7-23 s on the card (PERF.md section 5)
ADV_BURST = 24  # forged lanes of one abuser burst
ADV_BURSTS = 4  # the abuser's bursts: the first shares a flush with the victim, every second one is cancelled
ADV_ABUSER_QUOTA = dict(breaker_window=64, breaker_min_lanes=16, breaker_threshold=0.5, breaker_cooldown=3600.0)
# the kind whose first lane also goes through verify: a decodable partial that
# fails only at the pairing (verify_batch holds every kind)
ADV_VERIFY_KINDS = ("wrong-share",)


def _off_subgroup_g2(rng) -> bytes:
    """The compressed encoding of a point on the G2 curve outside the
    r-torsion subgroup."""
    from charon_tpu_torch.crypto import fields as F
    from charon_tpu_torch.crypto import g1g2

    while True:
        x = (rng.randrange(F.P), rng.randrange(F.P))
        y = F.fp2_sqrt(F.fp2_add(F.fp2_mul(F.fp2_sqr(x), x), g1g2.B2))
        if y is not None and not g1g2.g2_in_subgroup((x, y)):
            return g1g2.g2_to_bytes((x, y))


def adversarial_battery(seed: int, lanes: int = ADV_LANES) -> dict:
    """Phase 11's differential battery, host only, seeded: ADV_VALIDATORS
    group keys split ADV_T-of-ADV_N, and for each tbls call its lanes with
    the verdict every backend must give. verify_batch: `lanes` lanes of
    valid partials, `chaos.forged_signatures` (well-formed flags, garbage
    field bytes), partials checked against another share's pubkey, points
    on the curve off the subgroup, the infinity encoding and signatures of
    95 and 97 bytes; verify: the first lane of each ADV_VERIFY_KINDS kind; threshold
    aggregation: each key's t-subset (the group signature), a set whose
    signer repeats under a second index (a wrong group signature), a set
    with a forged member, a set with index 0 (both raise); aggregate over
    one key's partials and over the group signatures, and verify_aggregate
    with a wrong-share member."""
    from charon_tpu_torch.crypto import bls, g1g2, shamir
    from charon_tpu_torch.tbls.python_impl import PythonImpl
    from charon_tpu_torch.testutil.chaos import forged_signatures

    rng = random.Random(f"adversarial/{seed}")
    host = PythonImpl()
    keys = []
    for v in range(ADV_VALIDATORS):
        sk = bls.keygen(rng.randbytes(32))
        shares = shamir.split(sk, ADV_N, ADV_T, rand=lambda: rng.randrange(1, shamir.R))
        msg = hashlib.sha256(f"adversarial/{seed}/{v}".encode()).digest()
        keys.append({
            "pk": g1g2.g1_to_bytes(bls.sk_to_pk(sk)),
            "msg": msg,
            "sig": g1g2.g2_to_bytes(bls.sign(sk, msg)),
            "pubshares": {i: g1g2.g1_to_bytes(bls.sk_to_pk(s)) for i, s in shares.items()},
            "partials": {i: g1g2.g2_to_bytes(bls.sign(s, msg)) for i, s in shares.items()},
        })

    def pick():
        return keys[rng.randrange(len(keys))], rng.randrange(1, ADV_N + 1)

    rare = max(1, lanes // 16)
    counts = {"forged": max(1, lanes // 8), "wrong-share": max(1, lanes // 8), "off-subgroup": rare,
              "infinity": rare, "wrong-length": rare}
    counts["valid"] = lanes - sum(counts.values())
    batch = []
    for kind, count in counts.items():
        forged = forged_signatures(count, rng) if kind == "forged" else None
        for c in range(count):
            key, i = pick()
            sig = {
                "valid": lambda: key["partials"][i],
                "forged": lambda: forged[c],
                "wrong-share": lambda: key["partials"][i % ADV_N + 1],
                "off-subgroup": lambda: _off_subgroup_g2(rng),
                "infinity": lambda: g1g2.g2_to_bytes(None),
                "wrong-length": lambda: key["partials"][i][:95] if c % 2 == 0 else key["partials"][i] + b"\x00",
            }[kind]()
            batch.append((kind, (key["pubshares"][i], key["msg"], sig), kind == "valid"))
    rng.shuffle(batch)
    first = {}
    for kind, lane, want in batch:
        if kind in ADV_VERIFY_KINDS:
            first.setdefault(kind, (kind, lane, want))

    sets, raising = [], []
    for v, key in enumerate(keys):
        idx = sorted(rng.sample(range(1, ADV_N + 1), ADV_T))
        sets.append((f"valid-{v}", {i: key["partials"][i] for i in idx}, key["sig"]))
    key, idx = keys[0], sorted(rng.sample(range(1, ADV_N + 1), ADV_T))
    repeated = {i: key["partials"][i] for i in idx}
    repeated[idx[1]] = key["partials"][idx[0]]
    sets.append(("repeated-signer", repeated, None))  # any signature but the group's
    forged_member = {i: key["partials"][i] for i in idx}
    forged_member[idx[-1]] = forged_signatures(1, rng)[0]
    raising.append(("forged-member", forged_member))
    raising.append(("index-0", {0: key["partials"][idx[0]], **{i: key["partials"][i] for i in idx[1:]}}))

    signers = list(range(1, ADV_T + 1))
    pubs = [key["pubshares"][i] for i in signers]
    parts = [key["partials"][i] for i in signers]
    wrong = parts[:-1] + [key["partials"][ADV_T + 1]]
    aggregates = [("partials", parts), ("group-signatures", [k["sig"] for k in keys])]
    agg = {name: host.aggregate(sigs) for name, sigs in aggregates + [("wrong-share", wrong)]}
    # a valid aggregate verifies on the card in phase 9 (the lock and the
    # deposits): here the one with a wrong-share member
    verify_aggregates = [("wrong-share", pubs, key["msg"], agg["wrong-share"], False)]
    return {
        "keys": keys, "verify_batch": batch, "verify": list(first.values()), "threshold": sets,
        "threshold_raising": raising, "aggregate": aggregates, "aggregate_want": agg,
        "verify_aggregate": verify_aggregates, "counts": counts,
    }


def battery_lanes(battery: dict) -> int:
    """The lanes DifferentialTbls checks over one drive of the battery."""
    return sum(len(battery[k]) for k in
               ("verify_batch", "verify", "threshold", "threshold_raising", "aggregate", "verify_aggregate"))


def drive_battery(battery: dict, sync=lambda: None) -> dict:
    """Every call of the battery through the tbls registry (the caller has
    installed the backend, e.g. inside byzantine.differential_backend()),
    each outcome held to the battery's verdicts; returns each call's wall
    time, s. `sync` waits for the device before a clock is read."""
    from charon_tpu_torch import tbls

    walls = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        walls[name] = walls.get(name, 0.0) + time.perf_counter() - t0
        return out

    def outcome(fn):
        try:
            fn()
            return True
        except tbls.TblsError:
            return False

    lanes = battery["verify_batch"]
    got = timed("verify_batch", lambda: tbls.verify_batch([lane for _, lane, _ in lanes]))
    bad = [kind for (kind, _, want), ok in zip(lanes, got) if bool(ok) != want]
    if bad:
        raise AssertionError(f"adversarial verify_batch: wrong verdicts on {bad}")
    for kind, lane, want in battery["verify"]:
        if timed("verify", lambda: outcome(lambda: tbls.verify(*lane))) != want:
            raise AssertionError(f"adversarial verify: wrong verdict on {kind}")
    sets = battery["threshold"]
    sigs = timed("threshold_aggregate_batch", lambda: tbls.threshold_aggregate_batch([p for _, p, _ in sets]))
    for (name, _, want), sig in zip(sets, sigs):
        if (sig != want) if want is not None else (sig == battery["keys"][0]["sig"]):
            raise AssertionError(f"adversarial threshold_aggregate_batch: wrong signature for {name}")
    for name, partials in battery["threshold_raising"]:
        if timed("threshold_aggregate", lambda: outcome(lambda: tbls.threshold_aggregate(partials))):
            raise AssertionError(f"adversarial threshold_aggregate: {name} did not raise")
    for name, group in battery["aggregate"]:
        if timed("aggregate", lambda: tbls.aggregate(group)) != battery["aggregate_want"][name]:
            raise AssertionError(f"adversarial aggregate: wrong aggregate of {name}")
    for name, pubs, msg, sig, want in battery["verify_aggregate"]:
        if timed("verify_aggregate", lambda: outcome(lambda: tbls.verify_aggregate(pubs, msg, sig))) != want:
            raise AssertionError(f"adversarial verify_aggregate: wrong verdict on {name}")
    return walls


def run_differential(seed: int) -> dict:
    """Phase 11 (a): the battery through byzantine.differential_backend()
    over a TorchImpl on the card in the tbls registry, every verdict held
    lane by lane against the port's PythonImpl on the host; zero
    mismatches, every lane checked. Returns the launches."""
    import torch

    from charon_tpu_torch import tbls
    from charon_tpu_torch.ops import mont_kernels as MK
    from charon_tpu_torch.tbls.torch_impl import TorchImpl
    from charon_tpu_torch.testutil import byzantine

    t0 = time.perf_counter()
    battery = adversarial_battery(seed)
    log(f"adversarial battery: {json.dumps(battery['counts'])} verify_batch lanes, {battery_lanes(battery)} lanes "
        f"in all, built on the host in {time.perf_counter() - t0:.1f} s")
    prev = tbls._current
    tbls.set_implementation(TorchImpl())
    inner_s = {}
    depth = [0]  # TorchImpl's calls nest (a False batch re-checks lane by lane): time the outer one
    try:
        with byzantine.differential_backend() as diff:
            # time the card's calls apart from the oracle's
            for name in ("verify", "verify_batch", "threshold_aggregate", "threshold_aggregate_batch", "aggregate",
                         "verify_aggregate"):
                fn = getattr(diff.inner, name)

                def card_call(*args, _fn=fn, _name=name, **kw):
                    if depth[0]:
                        return _fn(*args, **kw)
                    depth[0] += 1
                    t = time.perf_counter()
                    try:
                        return _fn(*args, **kw)
                    finally:
                        torch.cuda.synchronize()
                        inner_s[_name] = inner_s.get(_name, 0.0) + time.perf_counter() - t
                        depth[0] -= 1

                setattr(diff.inner, name, card_call)
            MK.reset_launches()
            walls = drive_battery(battery, torch.cuda.synchronize)
            launches = dict(MK.LAUNCHES)
        byzantine.assert_no_mismatches(diff)
        if diff.lanes_checked != battery_lanes(battery):
            raise AssertionError(f"adversarial: {diff.lanes_checked} lanes checked, the battery has {battery_lanes(battery)}")
    finally:
        tbls._current = prev
    log(f"adversarial differential: zero mismatches over {diff.lanes_checked} lanes; walls (card + oracle) s: "
        + json.dumps({k: round(v, 3) for k, v in walls.items()}) + "; the card's share s: "
        + json.dumps({k: round(v, 3) for k, v in inner_s.items()}))
    log("adversarial differential launches:", json.dumps(launches))
    _check_launches(launches, "adversarial differential", DEFAULT_KERNELS, INT8_KERNELS)
    MK.reset_launches()
    return launches


def run_tenant_flood(coal, walls: dict, seed: int) -> dict:
    """Phase 11 (b): a CryptoPlaneService over phase 8's coalescer and
    plane (caches warm, no new prewarm) with two tenants. The abuser sends
    bursts of forged lanes and cancels every second one in flight; the
    victim runs ADV_VICTIM_DUTIES duties of valid partials under
    ADV_BUDGET deadlines, while the abuser's ADV_BURSTS bursts last. The
    victim misses nothing and every verdict of
    it is True, every abuser lane is False, the abuser's breaker opens and
    its quarantined flushes run the plane's programs on the card, and
    every damage counter names the abuser only. Returns the launches."""
    import asyncio

    from charon_tpu_torch.core.cryptosvc import CryptoPlaneService, PlaneOverloadError, TenantQuota
    from charon_tpu_torch.ops import mont_kernels as MK
    from charon_tpu_torch.testutil.chaos import ChaosConfig, forged_signatures

    key = adversarial_battery(seed, lanes=16)["keys"][0]
    items = [(key["pubshares"][i], key["msg"], key["partials"][i]) for i in range(1, ADV_VICTIM_LANES + 1)]
    rng = ChaosConfig(seed=seed).stream("tenant:forged")
    stats: list = []
    shared_hook = coal.stats_hook
    coal.stats_hook = stats.append
    walls.clear()

    async def flood():
        svc = CryptoPlaneService(coal, round_lanes=64, round_interval=0.01)
        victim = svc.register("tenant-b")
        abuser = svc.register("tenant-a", TenantQuota(**ADV_ABUSER_QUOTA))
        stop = asyncio.Event()
        abuser_verdicts, cancelled, victim_walls = [], [0], []

        async def one_burst():
            forged = [(key["pubshares"][1], key["msg"], s) for s in forged_signatures(ADV_BURST, rng)]
            try:
                abuser_verdicts.extend(await abuser.verify(forged, deadline=time.time() + ADV_BUDGET))
            except PlaneOverloadError:
                pass

        async def crash_looping_flood():
            for burst in range(1, ADV_BURSTS + 1):
                if stop.is_set():
                    break
                task = asyncio.create_task(one_burst())
                await asyncio.sleep(rng.uniform(0.0, 0.01))
                if burst % 2 == 0:
                    task.cancel()  # every second burst: the abuser's node crashes mid-flight
                    cancelled[0] += 1
                try:
                    await task
                except asyncio.CancelledError:
                    pass
                await asyncio.sleep(rng.uniform(0.0, 0.005))

        flooding = asyncio.create_task(crash_looping_flood())
        missed = 0
        try:
            for _ in range(ADV_VICTIM_DUTIES):
                t0 = time.monotonic()
                try:
                    res = await asyncio.wait_for(
                        victim.verify(list(items), deadline=time.time() + ADV_BUDGET), timeout=ADV_BUDGET
                    )
                    ok = res == [True] * len(items)
                except Exception as e:  # noqa: BLE001 — any failure is a missed duty
                    log(f"adversarial tenant flood: a victim duty failed: {type(e).__name__}: {e}")
                    ok = False
                victim_walls.append(time.monotonic() - t0)
                missed += not ok
        finally:
            stop.set()
            await flooding
            svc.close()
        return svc, missed, abuser_verdicts, cancelled[0], victim_walls

    MK.reset_launches()
    t0 = time.perf_counter()
    try:
        svc, missed, abuser_verdicts, cancelled, victim_walls = asyncio.run(flood())
    finally:
        coal.stats_hook = shared_hook
    wall = time.perf_counter() - t0
    launches = dict(MK.LAUNCHES)
    a, b = svc.tenant("tenant-a"), svc.tenant("tenant-b")
    quarantined = [st for st in stats if dict(st.tenant_lanes).keys() == {"tenant-a"} and st.device_span]
    for st in stats:
        log(f"adversarial flush: {st.lanes} lanes {json.dumps(dict(st.tenant_lanes))} in {st.flush_seconds:.3f} s, "
            f"decode {st.decode_mode}")
    log(f"adversarial tenant flood: {wall:.3f} s; victim duties {[round(w, 3) for w in victim_walls]} s, missed "
        f"{missed}; abuser {len(abuser_verdicts)} lanes answered, {cancelled} bursts cancelled, breaker "
        f"{json.dumps(a.breaker.transitions)}, quarantined flushes {a.quarantined_flushes}, failed lanes "
        f"{a.failed_lanes}; programs " + json.dumps(
            {fam: [len(runs), round(sum(s for s, _ in runs), 3), sum(k for _, k in runs)] for fam, runs in walls.items()}
        ))
    log("adversarial tenant flood launches:", json.dumps(launches))
    if missed:
        raise AssertionError(f"adversarial tenant flood: the victim missed {missed} duties")
    if not cancelled:
        raise AssertionError("adversarial tenant flood: no abuser burst was cancelled in flight")
    if not abuser_verdicts or any(abuser_verdicts):
        raise AssertionError(f"adversarial tenant flood: abuser verdicts {abuser_verdicts}, want every lane False")
    if a.breaker.transitions.get("open", 0) < 1 or a.quarantined_flushes < 1 or not quarantined:
        raise AssertionError("adversarial tenant flood: the abuser's breaker never opened or no quarantined flush "
                             "ran on the card")
    if a.quarantine_coal is None or a.quarantine_coal.flushes < 1 or not walls:
        raise AssertionError("adversarial tenant flood: the quarantine coalescer ran no program")
    if b.breaker.state != "closed" or b.breaker.transitions or b.shed or b.shed_lanes:
        raise AssertionError(f"adversarial tenant flood: damage attributed to the victim: {b.breaker.transitions}")
    if b.quarantined_flushes or b.failed_lanes:
        raise AssertionError("adversarial tenant flood: the victim was quarantined or failed lanes")
    # the flood verifies only: no Fr product (K1 Fr runs in recombination)
    _check_launches(launches, "adversarial tenant flood", DEFAULT_DECODE_KERNELS, INT8_KERNELS)
    MK.reset_launches()
    return launches


def run_adversarial(coal, walls: dict, seed: int) -> dict:
    """Phase 11, under the default configuration: the differential
    battery, then the tenant flood; returns the launches of both, summed."""
    import gc

    import torch

    from charon_tpu_torch.core.autotune import KernelConfig

    KernelConfig().apply()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"adversarial phase: the process's device memory {torch.cuda.memory_allocated() / 2**20:.1f} MiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**20:.1f} MiB reserved; RSS {_rss_mib():.1f} MiB")
    t0 = time.perf_counter()
    diff = run_differential(seed)
    flood = run_tenant_flood(coal, walls, seed)
    log(f"adversarial phase: {time.perf_counter() - t0:.1f} s")
    launches = {name: diff[name] + flood[name] for name in KERNELS}
    _check_launches(launches, "adversarial", DEFAULT_KERNELS, INT8_KERNELS)
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--validators", type=int, default=1024, help="each duty's validators")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--workers", type=int, default=min(8, os.cpu_count() or 1))
    ap.add_argument(
        "--python-decode", action="store_true",
        help="after the int8 duty, run it again with the host decode (decode_mode python) for its stage times",
    )
    ap.add_argument("--node-slot", type=float, default=NODE_SLOT, help="the node phase's slot duration, s")
    ap.add_argument(
        "--node-sweep", type=lambda v: [float(x) for x in v.split(",")], default=None, metavar="S1,S2,...",
        help="build the kernels and run only the node phase, once at each slot duration (s), reporting each "
             "pass or missed deadline; prints no result line",
    )
    ap.add_argument(
        "--node-cluster", default=None, metavar="DIR",
        help="the node phase's cluster on disk (compose.json and the node directories), written beforehand by "
             "--make-node-cluster; without it the node phase writes its own",
    )
    ap.add_argument(
        "--make-node-cluster", default=None, metavar="DIR",
        help="write the node phase's cluster (testutil/compose.generate) into DIR and exit; prints no result line",
    )
    ap.add_argument(
        "--adversarial", action="store_true",
        help="build the kernels and run only phase 11 (the differential battery and the tenant flood), over a "
             "plane and coalescer of its own, prewarmed at one verify bucket; prints no result line",
    )
    ap.add_argument(
        "--int8", action="store_true",
        help="build the kernels (or reuse a parent run's) and run only phase 5 and phase 7's int8 half (the "
             "decode batteries, the warm-up, the duty and the profile under K4-K6); prints the duty's launches "
             "and rows per launch as one JSON line and no result line",
    )
    ap.add_argument(
        "--dkg", action="store_true",
        help="build the kernels (or reuse a parent run's) and run only phase 9 (the DKG waves, the cluster "
             "ceremony, the reshare rotation, the int8 share wave and the tuner's ceremony axes); prints its "
             "launches as one JSON line and no result line",
    )
    ap.add_argument(
        "--shards", nargs="?", const="all", default=None, metavar="K1,K2,...",
        help="build the kernels (or reuse a parent run's) and run only phase 8b (its own host setup, or --vals', "
             "then the plane's shards at once on each of shard_meshes(), or on those of the given indexes); prints "
             "its result as one JSON line and no result line",
    )
    ap.add_argument(
        "--shard-part", choices=SHARD_PARTS, default=None,
        help="with --shards: run only this part of each mesh's phase (default: both)",
    )
    ap.add_argument(
        "--vals", default=None, metavar="PICKLE",
        help="with --shards or --age-ab: a pickled host setup (the run that starts the process writes it), "
             "instead of its own",
    )
    ap.add_argument(
        "--exit-check", nargs="?", type=int, const=1, default=None, metavar="TRIES",
        help="build the kernels (or reuse a parent run's) and run only the exit check (testutil/exitcheck: a "
             "process ending with a two-shard plane's program in flight, alone and under an open coalescer, by "
             "return, sys.exit and an uncaught exception), TRIES times each; prints its result as one JSON line "
             "and no result line",
    )
    ap.add_argument(
        "--profile", default=None, metavar="PICKLE",
        help="phase 7's default half alone (profile_device over the partials pickled in PICKLE); prints its "
             "result as one JSON line and no result line",
    )
    ap.add_argument(
        "--age-fresh", default=None, metavar="PICKLE",
        help="the age probe in a fresh process over the partials pickled in PICKLE, one probe for each label "
             "read from stdin (age_turns); prints no result line",
    )
    ap.add_argument(
        "--age-ab", choices=("idle", "trace"), default=None,
        help="the age A/B alone (its own host setup, or --vals'): probe, a torch.profiler trace of the loop steps "
             "or a sleep, probe, then turns against a fresh process; prints no result line",
    )
    ap.add_argument(
        "--stop-check", action="store_true",
        help="the node phase's process stopped (PhaseProcess.stop) once node 0 has ended a flush in slot 0, the "
             "next in flight, then this process's own exit; prints no result line",
    )
    ap.add_argument(
        "--ceremony", action="store_true",
        help="build the kernels and run only phase 9's cluster ceremony (dkg/ceremony.run_dkg on the card); "
             "prints no result line",
    )
    args = ap.parse_args(argv)
    if args.validators < 16:
        ap.error("each duty needs at least 16 validators (the forged batch takes 64 partials)")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    if args.make_node_cluster:
        make_node_cluster(args.make_node_cluster, args.node_slot)
        return 0
    from charon_tpu_torch.core.autotune import KernelConfig
    from charon_tpu_torch.ops import mont_kernels as MK

    card = card_line()
    print(card, flush=True)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(subprocess.run([MK.nvcc_path(), "--version"], check=True, capture_output=True, text=True).stdout.strip().splitlines()[-1])

    t0 = time.perf_counter()
    # the phase processes reuse the libraries their parent run built (same sources)
    for source, report in MK.build(force=not (args.node_sweep or args.dkg or args.int8 or args.shards
                                              or args.exit_check or args.stop_check or args.age_fresh
                                              or args.profile or args.age_ab)).items():
        log(f"nvcc {source}:")
        for line in report.splitlines():
            if "ptxas info" in line or "spill" in line:
                log("  " + line.strip())
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    if args.node_sweep:
        rc = node_sweep(args.seed, args.node_sweep, args.node_cluster)
        # exit now: the coalescer's device thread may still run the next
        # slot's flush (20 s on the card), whose jobs nobody awaits any more
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(rc)
    if args.int8:
        from charon_tpu_torch.ops.blsops import BlsEngine

        KernelConfig(mxu_mont=True).apply()
        vals = host_setup(args.validators, args.seed, args.workers)
        run_decode_batteries(BlsEngine(), decode_batteries(args.seed), "int8", INT8_DECODE_KERNELS, DEFAULT_KERNELS)
        probe = make_age_probe(vals)
        first = age_probe(probe, "int8 after its warm-up", profiled=True)
        _, launches, rows, _, _, _ = run_duty(vals, args.seed, "int8", INT8_KERNELS, DEFAULT_KERNELS)
        if args.python_decode:
            run_duty(vals, args.seed, "int8-python-decode", INT8_KERNELS, DEFAULT_KERNELS, decode_mode="python")
        age_drift(first, age_probe(probe, "int8 at its end", profiled=True))
        profile_device(probe.steps, "int8")
        print(json.dumps({INT8_RESULT: {"launches": launches, "rows": rows}}), flush=True)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)
    if args.shards:
        if args.vals:
            with open(args.vals, "rb") as f:
                vals = pickle.load(f)
        else:
            vals = host_setup(args.validators, args.seed, args.workers)
        which = None if args.shards == "all" else [int(k) for k in args.shards.split(",")]
        parts = SHARD_PARTS if args.shard_part is None else (args.shard_part,)
        print(json.dumps({SHARDS_RESULT: run_shards(vals, args.seed, which, parts)}), flush=True)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)
    if args.exit_check:
        return exit_check(args.exit_check)
    if args.age_fresh:
        return age_fresh(args.age_fresh)
    if args.profile:
        return profile_process(args.profile)
    if args.age_ab:
        if args.vals:
            with open(args.vals, "rb") as f:
                return age_ab(args.age_ab, pickle.load(f))
        return age_ab(args.age_ab, host_setup(args.validators, args.seed, args.workers))
    if args.stop_check:
        return stop_check(args.seed, args.node_slot)
    if args.dkg:
        KernelConfig().apply()
        launches = run_dkg(args.seed)
        print(json.dumps({DKG_LAUNCHES: launches}), flush=True)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)  # as the node sweep: no thread of the engine's outlives the phase
    if args.adversarial:
        import asyncio

        from charon_tpu_torch.core.cryptoplane import SlotCoalescer
        from charon_tpu_torch.parallel import SlotCryptoPlane
        from charon_tpu_torch.tbls.torch_impl import TorchImpl

        walls: dict = {}
        plane = SlotCryptoPlane(None, t=4)
        plane.on_program = lambda fam, seconds, lanes: walls.setdefault(fam, []).append((seconds, lanes))
        coal = SlotCoalescer(plane, impl=TorchImpl())
        try:
            stage("plane_prewarm", lambda: asyncio.run(coal.prewarm(PLANE_PREWARM_LANES, PLANE_PREWARM_RECOMBINE_LANES)), {})
            log("adversarial launches:", json.dumps(run_adversarial(coal, walls, args.seed)))
        finally:
            coal.close()
        return 0
    if args.ceremony:
        from charon_tpu_torch.ops.blsops import BlsEngine

        walls: dict = {}
        launches = run_ceremony(BlsEngine(), args.seed, walls)
        log("ceremony launches:", json.dumps(launches))
        return 0
    count_imma()

    results = check_kernels(args.seed)
    check_fp2_route(args.seed)
    vals = host_setup(args.validators, args.seed, args.workers)
    run_tuner(sum(len(v[3]) for v in vals), persist=True)
    run_tuner(sum(len(v[3]) for v in vals), axis="fp2_fusion")
    # the age probe's first reading, before any phase process starts
    KernelConfig().apply()
    probe = make_age_probe(vals)
    first_probe = age_probe(probe, "main after phase 4", profiled=True)
    # phase 5 (with phase 7's int8 half), 9 and 10 run from here on in
    # processes of their own, on the same card beside phases 6-8 of this
    # one: every phase is host-bound
    # and the card idle most of each (PERF.md section 5), so the script's
    # wall is this process's phases. The node phase's cluster comes first
    # from create-cluster's host ceremony (FROST on the host, about a
    # minute), in a process of its own; the node phase waits for it, and for
    # phase 4's profile, which node 0 loads.
    cluster_dir = str(MK.BUILD_DIR / f"node-cluster-{os.getpid()}")
    os.makedirs(cluster_dir)
    cluster_log_path = os.path.join(cluster_dir, "make.log")
    with open(cluster_log_path, "w") as cluster_log:
        cluster_proc = subprocess.Popen(
            phase_command("--make-node-cluster", cluster_dir, "--node-slot", args.node_slot),
            stdout=cluster_log, stderr=subprocess.STDOUT,
        )
    node_phase = PhaseProcess(
        "node process", phase_command("--node-sweep", args.node_slot, "--seed", args.seed, "--node-cluster", cluster_dir),
        NODE_LAUNCHES, after=cluster_proc, after_log=cluster_log_path,
    )
    dkg_phase = PhaseProcess("dkg process", phase_command("--dkg", "--seed", args.seed), DKG_LAUNCHES)
    # one process a mesh, two for a mesh of SPLIT_SHARDS or more (one a
    # part): the shards of a mesh share the process's GIL; each reads this
    # process's host setup from a pickle
    vals_path = MK.BUILD_DIR / f"shards-vals-{os.getpid()}.pickle"
    with open(vals_path, "wb") as f:
        pickle.dump(vals, f)
    shards_phases = []
    for k, (_, mesh) in enumerate(shard_meshes()):
        n_shards = sum(len(row) for row in mesh) if isinstance(mesh[0], (list, tuple)) else len(mesh)
        split = n_shards >= SPLIT_SHARDS
        for part in SHARD_PARTS if split else (None,):
            shards_phases.append(PhaseProcess(
                f"shards process {k}" + (f" {part}" if part else ""),
                phase_command("--shards", k, "--seed", args.seed, "--vals", vals_path,
                              *(["--shard-part", part] if part else [])),
                SHARDS_RESULT,
            ))
    exit_phase = PhaseProcess("exit-check process", phase_command("--exit-check"), EXIT_RESULT)
    int8_phase = PhaseProcess(
        "int8 process",
        phase_command("--int8", "--seed", args.seed, "--validators", args.validators, "--workers",
                      max(1, args.workers // 2), *(["--python-decode"] if args.python_decode else [])),
        INT8_RESULT,
    )

    try:
        from charon_tpu_torch.ops.blsops import BlsEngine

        KernelConfig().apply()
        run_decode_batteries(BlsEngine(), decode_batteries(args.seed), "default", DEFAULT_DECODE_KERNELS, INT8_KERNELS)
        _, default_launches, default_rows, _, _, duty_sigs = run_duty(
            vals, args.seed, "default", DEFAULT_KERNELS, INT8_KERNELS
        )
        age_probe(probe, "main after phase 6")
        # phase 7's default half, in a process of its own that ends with it
        PhaseProcess("profile process", phase_command("--profile", vals_path), PROFILE_RESULT).wait()
        age_probe(probe, "main after phase 7")
        # phase 8's coalescer stays open, caches warm, for phase 11
        plane_launches, unfused_launches, slot_wall, plane_coal, plane_walls = run_plane(vals, duty_sigs, args.seed)
        age_probe(probe, "main after phase 8")
        try:
            # phase 11 follows phases 5 and 7's int8 half, 9 and 10, with the card to itself
            t_wait = time.perf_counter()
            int8 = int8_phase.wait()
            int8_launches = int8["launches"]
            int8_rows = {name: {int(r): n for r, n in counts.items()} for name, counts in int8["rows"].items()}
            dkg_launches = dkg_phase.wait()
            node_launches = node_phase.wait()
            log("exit check (a process of its own):", json.dumps(exit_phase.wait()))
            shards: dict = {}
            for phase in shards_phases:
                for label, r in phase.wait().items():
                    shards.setdefault(label, {}).update(r)
            log(f"phases 5, 8b, 9 and 10 and the exit check (processes of their own): waited {time.perf_counter() - t_wait:.1f} s "
                "after phase 8")
            log(f"slot flush walls ({args.validators} validators, one flush): 1 shard (phase 8) {slot_wall:.3f} s; "
                + "; ".join(f"{label} ({r['shards']} shards) {r['wall']:.3f} s" for label, r in shards.items()))
            adversarial_launches = run_adversarial(plane_coal, plane_walls, args.seed)
        finally:
            plane_coal.close()
        # a flush of a cancelled burst may still run on a closed coalescer's
        # device lane; the probe counts its own steps' launches alone
        for thread in threading.enumerate():
            if thread.name.startswith(("crypto-plane", "crypto-decode")):
                thread.join()
        age_drift(first_probe, age_probe(probe, "main after phase 11", profiled=True))
        age_turns(probe, vals_path)
    finally:
        probe.close()
        exit_phase.stop()
        int8_phase.stop()
        for phase in shards_phases:
            phase.stop()
        vals_path.unlink(missing_ok=True)
        node_phase.stop()
        dkg_phase.stop()
        if cluster_proc.poll() is None:
            cluster_proc.kill()
            cluster_proc.wait()
    duty_rows = {name: (int8_rows if name in INT8_KERNELS else default_rows)[name] for name in KERNELS}
    time_duty_shapes(results, duty_rows, args.seed)

    kernels = []
    for name, (replaces, source, *_rest) in KERNELS.items():
        launches = int8_launches if name in INT8_KERNELS else default_launches
        kernels.append({
            "name": name, "route": "cuda", "source": f"charon_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": launches[name], **results[name], "library_ms": None,
            "plane_launches": plane_launches[name], "dkg_launches": dkg_launches[name],
            "node_launches": node_launches[name], "adversarial_launches": adversarial_launches[name],
            "shard_launches": sum(r["launches"][name] for r in shards.values()),
            "unfused_launches": unfused_launches[name],
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
