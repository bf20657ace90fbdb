"""Process exit with a slot plane's shard threads mid-program.

A SlotCryptoPlane on two or more shards owns one worker thread a shard
(parallel/mesh.py), and on a card each of them launches kernels on a CUDA
stream of its own, taking turns at the host. A process may end while a
program runs on them: its main function returns, it calls sys.exit, or an
exception escapes it. Such an end must let the program end or raise from
it, and the process must then exit with its own code, never a signal, and
leave no shard thread alive.

Each check runs one child process:

    python -m charon_tpu_torch.testutil.exitcheck --device cuda:0 --end return [--coalescer] [--work spin]

The child builds a plane over [device, device] (t = 4) and starts work on
it from an executor thread, as a node calls its plane:

  * without --coalescer, the plane's h2c program over --lanes messages
    (--work real) or a program that squares in Fp2 (K3 on a card, its
    plain version on the CPU) on every shard for --seconds (--work spin);
  * with --coalescer, a SlotCoalescer over the plane, open and never
    closed, running a verify flush of --lanes host-signed partials
    (--work real) or the spin program on its device lane (--work spin).

As soon as the work is in flight (a kernel launched, or the spin body
entered on a shard) the child ends as --end says, with neither close().
At exit (atexit, after the interpreter has joined its threads) it prints
one line {"exit_report": {...}}: the work's outcome ("ended", "raised:
...", or "pending"), the threads still alive, and the launches made.

run_checks() runs every (coalescer, end) pair `tries` times and returns
each child's exit code, signal, seconds and report; failures() names each
child that ended on a signal, with another code than its end's, past the
time bound, with its work pending, or with a shard thread alive.
"""

from __future__ import annotations

import argparse
import asyncio
import atexit
import concurrent.futures
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

REPORT = "exit_report"
ENDS = {"return": 0, "exit": 1, "raise": 1}  # each end and the exit code it must give
LIVE_PREFIXES = ("plane-shard", "crypto-plane", "crypto-decode", "exit-check")
TIME_BOUND = 120.0  # s a child may take, from its start to its exit


def _signed_lanes(n: int) -> list:
    """n (pubkey, message, signature) lanes signed on the host."""
    from charon_tpu_torch.crypto import bls, g1g2

    lanes = []
    for i in range(n):
        sk = bls.keygen(bytes([i + 1]) * 32)
        msg = b"exit check %d" % i
        lanes.append((g1g2.g1_to_bytes(bls.sk_to_pk(sk)), msg, g1g2.g2_to_bytes(bls.sign(sk, msg))))
    return lanes


def _spin_program(plane, seconds: float, entered: threading.Event):
    """A plane program whose body squares an Fp2 element over and over for
    `seconds` on every shard (K3 on a card)."""
    import torch

    from charon_tpu_torch.ops import limb
    from charon_tpu_torch.ops import mont_kernels as MK

    def body(x):
        entered.set()
        a = (limb.const(limb.FP, 3, (x.shape[0],), x.device), limb.const(limb.FP, 5, (x.shape[0],), x.device))
        end = time.monotonic() + seconds
        while time.monotonic() < end:
            a = MK.fp2_sqr(limb.FP, a)
        return (x,)

    run = plane._program("spin", body, ("cat",))
    return lambda: run(torch.arange(2 * plane.shard_count(), device=plane.device))


def child(device: str, end: str, coalescer: bool, work: str, lanes: int, seconds: float) -> int:
    from charon_tpu_torch.ops import mont_kernels as MK
    from charon_tpu_torch.parallel import SlotCryptoPlane

    plane = SlotCryptoPlane([device, device], t=4)
    entered = threading.Event()
    spin = _spin_program(plane, seconds, entered) if work == "spin" else None
    if coalescer:
        from charon_tpu_torch.core.cryptoplane import SlotCoalescer
        from charon_tpu_torch.tbls.torch_impl import TorchImpl

        coal = SlotCoalescer(plane, impl=TorchImpl(device=device))
        if spin is not None:
            fut = coal._executor.submit(spin)  # the coalescer's device lane
        else:
            items = _signed_lanes(lanes)
            fut = concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix="exit-check").submit(
                lambda: asyncio.run(coal.verify(items))
            )
    else:
        caller = concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix="exit-check")
        fut = caller.submit(spin if spin is not None else lambda: plane.hash_to_g2_host([b"m%d" % i for i in range(lanes)]))

    def report() -> None:
        if not fut.done():
            outcome = "pending"
        elif fut.exception() is not None:
            outcome = f"raised: {fut.exception()!r}"[:300]
        else:
            outcome = "ended"
        live = sorted(t.name for t in threading.enumerate() if t.name.startswith(LIVE_PREFIXES))
        line = {"outcome": outcome, "threads": live, "launches": sum(MK.LAUNCHES.values())}
        sys.stdout.write(json.dumps({REPORT: line}) + "\n")
        sys.stdout.flush()

    atexit.register(report)
    deadline = time.monotonic() + 60
    while not (entered.is_set() or sum(MK.LAUNCHES.values())):
        if fut.done() or time.monotonic() > deadline:
            fut.result()  # raises what the work raised
            raise RuntimeError("the work ended before it was seen in flight")
        time.sleep(0.005)
    if end == "exit":
        sys.exit(ENDS[end])
    if end == "raise":
        raise RuntimeError("the process ends with the plane's program in flight")
    return ENDS[end]


def _command(device: str, end: str, coalescer: bool, work: str, lanes: int, seconds: float) -> list:
    return [sys.executable, "-m", __name__, "--device", device, "--end", end, "--work", work,
            "--lanes", str(lanes), "--seconds", str(seconds), *(["--coalescer"] if coalescer else [])]


def run_one(device: str, end: str, coalescer: bool, work: str = "real", lanes: int = 8,
            seconds: float = 2.0, bound: float = TIME_BOUND) -> dict:
    """One child: its exit code, the signal that ended it (or None), its
    seconds, its exit report (None if it printed none) and its stderr's
    tail. A child past `bound` is killed with its process group."""
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    t0 = time.monotonic()
    proc = subprocess.Popen(_command(device, end, coalescer, work, lanes, seconds), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=root, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=bound)
        timed_out = False
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        timed_out = True
    report = None
    for line in out.splitlines():
        if line.startswith("{" + json.dumps(REPORT)):
            report = json.loads(line)[REPORT]
    rc = proc.returncode
    return {
        "device": device, "end": end, "coalescer": coalescer, "work": work, "rc": rc,
        "signal": signal.Signals(-rc).name if rc < 0 else None, "timed_out": timed_out,
        "seconds": round(time.monotonic() - t0, 3), "report": report, "stderr": err[-600:],
    }


def run_checks(device: str, tries: int = 1, work: str = "real", lanes: int = 8, seconds: float = 2.0,
               parallel: int = 3, bound: float = TIME_BOUND) -> list[dict]:
    """Every (coalescer, end) pair `tries` times, `parallel` children at a
    time; one result dict a child (run_one)."""
    cases = [(c, e) for _ in range(tries) for c in (False, True) for e in ENDS]
    with concurrent.futures.ThreadPoolExecutor(parallel) as pool:
        return list(pool.map(lambda ce: run_one(device, ce[1], ce[0], work, lanes, seconds, bound), cases))


def failures(results: list[dict], bound: float = TIME_BOUND) -> list[str]:
    """What is wrong with each child, one line a fault."""
    out = []
    for r in results:
        what = f"{'coalescer' if r['coalescer'] else 'plane'}/{r['end']}"
        rep = r["report"]
        if r["signal"] or r["timed_out"] or r["rc"] != ENDS[r["end"]] or r["seconds"] > bound:
            out.append(f"{what}: exit code {r['rc']} (signal {r['signal']}, timed out {r['timed_out']}) "
                       f"after {r['seconds']} s, want {ENDS[r['end']]}; stderr: {r['stderr'][-300:]!r}")
        elif rep is None:
            out.append(f"{what}: no exit report; stderr: {r['stderr'][-300:]!r}")
        elif rep["outcome"] == "pending" or any(t.startswith("plane-shard") for t in rep["threads"]):
            out.append(f"{what}: work {rep['outcome']}, threads alive at exit {rep['threads']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--end", choices=sorted(ENDS), required=True)
    ap.add_argument("--coalescer", action="store_true")
    ap.add_argument("--work", choices=("real", "spin"), default="real")
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    return child(args.device, args.end, args.coalescer, args.work, args.lanes, args.seconds)


if __name__ == "__main__":
    sys.exit(main())
