"""Point arithmetic of the generator, the reference and the control, spread
over worker processes that talk over pipes (no shared memory, no files).

    python3 -m portbench.work     # a worker: pickled tasks on stdin, results on stdout

A task is ("g1", scalars): the public keys of the scalars; ("g2", root,
scalars): the signatures of one signing root under each scalar; or
("combine", rows): for each (signatures, scalars) row the sum of the
scalar multiples of the decoded signatures, compressed.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

from portbench import bls381

ROOT = Path(__file__).resolve().parent.parent
CHUNK = 512  # scalars of one piece: a piece builds its own table
WORKERS = 8


def _combine(rows: list) -> list:
    out = []
    for sigs, scalars in rows:
        acc = None
        for sig, k in zip(sigs, scalars):
            acc = bls381.add_affine(acc, bls381.mul_affine(bls381.g2_from_bytes(sig), k, bls381.FP2), bls381.FP2)
        out.append(bls381.g2_to_bytes(acc))
    return out


def run_task(task) -> list:
    kind = task[0]
    if kind == "g1":
        return bls381.public_keys(task[1])
    if kind == "g2":
        return bls381.sign_root(task[1], task[2])
    if kind == "combine":
        return _combine(task[1])
    raise ValueError(f"unknown task {kind!r}")


def _pieces(tasks: list) -> list:
    """(task index, piece, cost): tasks cut into pieces of at most CHUNK
    scalars or rows, in order."""
    out = []
    for k, task in enumerate(tasks):
        items = task[-1]
        for s in range(0, max(len(items), 1), CHUNK):
            part = (*task[:-1], items[s : s + CHUNK])
            cost = len(part[-1]) * (40 if task[0] == "combine" else 1) + 60
            out.append((k, part, cost))
    return out


def run_tasks(tasks: list, workers: int | None = None) -> list:
    """The results of `tasks`, in order, from up to `workers` worker
    processes (each piece's results do not depend on which worker ran it)."""
    pieces = _pieces(tasks)
    n = max(1, min(workers or min(WORKERS, os.cpu_count() or 1), len(pieces)))
    loads = [[0, []] for _ in range(n)]
    for j in sorted(range(len(pieces)), key=lambda j: -pieces[j][2]):
        least = min(loads, key=lambda w: w[0])
        least[0] += pieces[j][2]
        least[1].append(j)
    procs = []
    try:
        for _, mine in loads:
            proc = subprocess.Popen(
                [sys.executable, "-m", "portbench.work"], cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE
            )
            procs.append(proc)
            proc.stdin.write(pickle.dumps([pieces[j][1] for j in mine]))
            proc.stdin.close()
        got = {}
        for proc, (_, mine) in zip(procs, loads):
            results = pickle.load(proc.stdout)
            proc.stdout.close()
            if proc.wait() != 0:
                raise RuntimeError(f"worker exited with {proc.returncode}")
            got.update(zip(mine, results))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = [[] for _ in tasks]
    for j, (k, _, _) in enumerate(pieces):
        out[k].extend(got[j])
    return out


def main() -> int:
    tasks = pickle.load(sys.stdin.buffer)
    pickle.dump([run_task(t) for t in tasks], sys.stdout.buffer)
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
