#!/usr/bin/env python3
"""Time the slot crypto plane's full-width slot flush on several meshes of
one card, for this tree and another checkout, in turns: the A/B of a
change to the plane against its parent, both in one call on one card.

    python3 plane_ab.py --base DIR [--validators 1024] [--seed 1] [--order base,this,this,base]

DIR holds another checkout's charon_tpu_torch (for example `git archive
<commit> charon_tpu_torch` unpacked under the gitignored _checkout/). The
host setup (keys, 4-of-7 splits, partials and the group signatures, from
chip_smoke.make_validator) runs once; then each turn is a process of its
own that imports one tree's package, builds its kernels, warms a
TorchImpl's point caches through a one-shard plane, and times ONE
coalesced flush of the whole slot (every partial as verify calls, every
validator as two recombine duties: verify_rlc_dec and step_rlc_dec) on
each mesh: one shard, two shards on cuda:0, and four shards on cuda:0 (a
make_mesh_2d(2, ...) layout where the tree has make_mesh_2d). Every
verdict must be True and every group signature the host signature of the
group secret. Prints a line for each flush and a table of the walls; the
card's name and power limit head the output. It drives the slot through
chip_smoke's slot_calls, coalesced_flush and check_slot, the helpers of
that script's phases 8 and 8b.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
RESULT = "plane_ab"


def meshes(mod) -> list:
    """(label, mesh) of a tree's parallel module."""
    four = mod.make_mesh_2d(2, ["cuda:0"] * 4) if hasattr(mod, "make_mesh_2d") else ["cuda:0"] * 4
    return [("1 shard", ["cuda:0"]), ("2 shards", ["cuda:0"] * 2), ("4 shards", four)]


def run_turn(root: str, vals_path: str) -> None:
    """One turn: `root`'s package on sys.path first, chip_smoke's helpers
    from this tree."""
    sys.path.insert(0, root)
    import asyncio

    sys.path.insert(1, HERE)
    import chip_smoke as S
    from charon_tpu_torch import parallel
    from charon_tpu_torch.core.cryptoplane import SlotCoalescer
    from charon_tpu_torch.ops import mont_kernels as MK
    from charon_tpu_torch.tbls.torch_impl import TorchImpl

    with open(vals_path, "rb") as f:
        vals = pickle.load(f)
    MK.build()
    impl = TorchImpl()
    pubkeys = [v[0] for v in vals] + [pk for v in vals for pk in v[2].values()]
    warm = SlotCoalescer(parallel.SlotCryptoPlane(["cuda:0"], t=4), impl=impl)
    try:
        asyncio.run(warm.warm_caches(pubkeys, [v[1] for v in vals]))
    finally:
        warm.close()
    calls, duties = S.slot_calls(vals)
    walls = {}
    for label, mesh in meshes(parallel):
        plane = parallel.SlotCryptoPlane(mesh, t=4)
        programs: dict = {}
        plane.on_program = lambda fam, seconds, k: programs.setdefault(fam, []).append((seconds, k))
        coal = SlotCoalescer(plane, impl=impl)
        try:
            vres, rres, wall, _, _ = S.coalesced_flush(coal, calls, duties, programs, f"{root} {label}")
        finally:
            coal.close()
            if hasattr(plane, "close"):
                plane.close()
        S.check_slot(f"{root} {label}", vals, vres, rres)
        walls[label] = wall
    print(json.dumps({RESULT: {"root": root, "walls": walls}}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", help="the other checkout's root (holding charon_tpu_torch)")
    ap.add_argument("--validators", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--workers", type=int, default=min(8, os.cpu_count() or 1))
    ap.add_argument("--order", default="base,this,this,base", help="the turns, in order")
    ap.add_argument("--run", help=argparse.SUPPRESS)
    ap.add_argument("--vals", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.run:
        run_turn(args.run, args.vals)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("plane_ab: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    if not args.base:
        ap.error("--base is required")
    sys.path.insert(0, HERE)
    import chip_smoke as S

    print(S.card_line(), flush=True)
    roots = {"base": os.path.abspath(args.base), "this": HERE}
    vals = S.host_setup(args.validators, args.seed, args.workers)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        vals_path = os.path.join(tmp, "vals.pickle")
        with open(vals_path, "wb") as f:
            pickle.dump(vals, f)
        for turn in args.order.split(","):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--run", roots[turn], "--vals", vals_path],
                stdout=subprocess.PIPE, text=True,
            )
            result = None
            for line in proc.stdout.splitlines():
                if line.startswith("{" + json.dumps(RESULT)):
                    result = json.loads(line)[RESULT]
                else:
                    print(f"  {turn} {line}", flush=True)
            if proc.returncode != 0 or result is None:
                print(f"plane_ab: the {turn} turn exited {proc.returncode}", file=sys.stderr)
                return 1
            rows.append((turn, result["walls"]))
            S.log(f"{turn} turn ({roots[turn]}): {time.perf_counter() - t0:.1f} s")
    labels = list(rows[0][1])
    print("turn  " + "  ".join(f"{label:>10}" for label in labels))
    for turn, walls in rows:
        print(f"{turn:5} " + "  ".join(f"{walls[label]:10.3f}" for label in labels))
    print(json.dumps({"plane_ab": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
