#!/usr/bin/env python3
"""The benchmark of charon_tpu_torch, the PyTorch and CUDA port, one cell
a run:

    python3 portbench/run.py --workload att1k.burst --seed 7 --seconds 51 --trace 0

run from the root of a checkout on a machine with the card(s) the cell
asks for. The cell (BENCHMARK.json `workloads`) names a configuration
(portbench/configs) and a traffic mix (portbench/traffic); the metrics
are read by portbench/metrics/<name>.py. A run generates its inputs from
the seed, boots the program and warms it (set-up), answers whole slots
for --seconds (the window), then answers one more slot, untimed, that
holds a partial signed over a stale root (the check slot, profiled up to
the end of its first program in every run: the device's busy time there
is an end-to-end metric, and with --trace 1 the profile also gives the
per-layer metrics and the breakdown), then checks every answer of the
window's slots and the check slot against the plain reference. It
prints the compared numbers beside their limits as the last lines of
standard error and one JSON line, the result, as the last line of
standard output. It exits non-zero without a result where there is no
card, and where jax, jaxlib, flax or the JAX package was loaded.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# import the harness as the package portbench from the checkout's root,
# never its modules from the script's directory, where they would shadow
# standard modules (trace)
sys.path[:] = [str(ROOT)] + [p for p in sys.path if Path(p or ".").resolve() != ROOT / "portbench"]

from portbench import gen, reference, spec, system  # noqa: E402
from portbench import trace as tracing  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "charon_tpu")  # top-level module names, compared whole


def log(*parts) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f}s]", *parts, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi unavailable"
    return out[0] if out else "nvidia-smi gave nothing"


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def run_cell(bench: dict, cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float, traced: bool,
             device: str, t0: float = _T0) -> tuple:
    """One run of a cell on `device`: (result without the compared numbers,
    compared numbers {name: (value, limit)}). Nothing is printed to
    standard output but log lines."""
    g0 = time.perf_counter()
    inputs = gen.generate(cfg, traffic, seed)
    gen_s = time.perf_counter() - g0
    untimed = list(range(traffic["untimed_slots"]))
    check = gen.check_slot(traffic)
    ring = list(range(len(untimed), check))
    subs = {s: gen.submissions(inputs, inputs.slots[s], cfg, traffic, seed, s) for s in untimed + ring + [check]}
    lanes = sum(len(k) for _, k in subs[ring[0]].verify)
    rows = sum(len(r) for _, r in subs[ring[0]].recombine)
    log(f"generation: {gen_s:.3f} s for {len(inputs.group_pks)} validators and {len(inputs.slots)} slots "
        f"({lanes} partials to verify and {rows} rows to recombine a slot)")

    b0 = time.perf_counter()
    prog = system.Program(cfg["threshold"], device)
    pubkeys = list(inputs.group_pks) + [pk for shares in inputs.pubshares for pk in shares.values()]
    warm = prog.warm(pubkeys)
    log(f"boot: build, plane and point-cache warm-up {time.perf_counter() - b0:.3f} s; warm-up {json.dumps(warm)}")
    for s in untimed:
        u0 = time.perf_counter()
        prog.slot(subs[s])
        log(f"untimed slot: {time.perf_counter() - u0:.3f} s")
    boot_s = time.perf_counter() - b0

    setup_s = time.perf_counter() - t0
    win = prog.window((subs[s] for s in ring), seconds)
    done = ring[: len(win["walls"])]
    log(f"window: {len(done)} slots in {win['seconds']:.3f} s, walls " + ", ".join(f"{w:.3f}" for w in win["walls"])
        + f"; flushes {win['flushes']}, pack {win['pack_s']:.3f} s, programs {win['programs_s']:.3f} s "
        + json.dumps(win["families"]) + f", launches {win['launches']}")
    if win["ran_out"]:
        log(f"ring ran out: the window ended after all {len(done)} slots of the ring before {seconds} s; "
            "raise ring_slots in the traffic file")
    checked = [(s, win["answers"][k]) for k, s in enumerate(done)]
    # the check slot: outside the window, profiled up to the end of its
    # first program, the process's last work on the card
    c0 = time.perf_counter()
    tr = prog.traced_slot(subs[check])
    answers = tr["answers"]
    r0 = time.perf_counter()
    summary = tracing.summarize(tr)
    log(f"traced slot: its first program ended {summary['window_s']:.3f} s after its submission; "
        f"device busy {summary['busy_s']!r} s; {summary['events']} device events read in "
        f"{time.perf_counter() - r0:.3f} s; classes {json.dumps(summary['classes'])}; "
        f"programs {json.dumps(tr['programs'])}")
    checked.append((check, answers))
    log(f"check slot ({len(inputs.slots[check].forged)} forged partials): {time.perf_counter() - c0:.3f} s, "
        "programs " + json.dumps([(fam, round(secs, 3), lanes) for fam, secs, lanes, _ in prog.programs]))
    peak = prog.memory_peak()
    log(f"device memory peak: {peak} bytes")
    prog.close()
    del prog

    r0 = time.perf_counter()
    exps = reference.expected(inputs, [s for s, _ in checked], cfg)
    counts = dict.fromkeys(reference.LIMITS, 0)
    attempted = failed = 0
    for (s, answers), exp in zip(checked, exps):
        got = reference.compare(subs[s], answers, exp)
        attempted += got["attempted"]
        failed += got["failed"]
        for k, v in got["counts"].items():
            counts[k] += v
    log(f"reference: {len(checked)} slots checked in {time.perf_counter() - r0:.3f} s")

    record = {
        "setup_s": setup_s,
        "boot_s": boot_s,
        "window": {"slots": len(done), **{k: win[k] for k in ("seconds", "flushes", "pack_s", "programs_s", "launches")}},
        "trace": summary,
    }
    dev = {"platform": "gpu" if device != "cpu" else "cpu", "kind": device_kind(device), "count": cell["chips"],
           "memory_peak_bytes": peak}
    if traced:
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    result = {
        "correct": failed == 0 and all(counts[k] <= lim for k, lim in reference.LIMITS.items()),
        "attempted": attempted,
        "failed": failed,
        "metrics": spec.read_metrics(bench, cell["name"], traced, record),
        "device": dev,
    }
    if traced:
        result["breakdown"] = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    return result, {k: (counts[k], lim) for k, lim in reference.LIMITS.items()}


def device_kind(device: str) -> str:
    if device == "cpu":
        return "cpu"
    import torch

    return torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s), this machine has {n}", file=sys.stderr)
        return 3
    log(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"{args.workload} seed {args.seed} seconds {args.seconds} trace {args.trace}")
    cfg = spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    result, compared = run_cell(bench, cell, cfg, traffic, args.seed, args.seconds, bool(args.trace), "cuda:0")
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules loaded that the benchmark must not load: {bad}", file=sys.stderr)
        return 4
    result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    for k, (v, lim) in compared.items():
        print(f"compared {k}: {v} (limit {lim})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
