#!/usr/bin/env python3
"""Time the fused Fp2 multiply kernels of two checkouts on one card.

    python3 kernel_ab.py --base DIR [--rows 65536,48,24576,6144,384]

DIR is another checkout of the repository (for example an earlier commit
unpacked with `git archive`). The script builds K2 (`charon_fp2_mul`,
csrc/fp2.cu) and K5 (`charon_fp2_mul_mxu`, csrc/fp2_mxu.cu) from DIR's
charon_tpu_torch/csrc and from this tree's with nvcc, holds both versions
against this tree's plain version on the same operands (exactly equal),
and times them in turns (base, this, this, base) at each row count with
chip_smoke's timer (CUDA events over 200 queued launches of the C entry
point alone). Each version's C entry point is called by its own parameter
names, so a base whose kernels take no launch geometry works as well.
Prints the card, one line per (kernel, rows), then one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

KERNELS = {"fp2_mul": ("fp2.cu", "charon_fp2_mul"), "fp2_mul_mxu": ("fp2_mxu.cu", "charon_fp2_mul_mxu")}
_TYPES = {"int64_t": ctypes.c_int64, "int": ctypes.c_int}


def c_params(source: Path, fn: str) -> list[tuple[str, str]]:
    """(type, name) of each parameter of extern "C" function `fn`."""
    params = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", source.read_text()).group(1)
    out = []
    for p in params.split(","):
        typ, name = " ".join(p.split()).rsplit(" ", 1)
        out.append((typ, name))
    return out


def build(csrc: Path, out_dir: Path) -> dict[str, ctypes.CDLL]:
    """One nvcc per source, all at once, with the port's flags."""
    from charon_tpu_torch.ops import mont_kernels as MK

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for source, _ in KERNELS.values():
        lib = out_dir / f"lib{Path(source).stem}.so"
        procs[source] = (subprocess.Popen(
            [MK.nvcc_path(), *MK.NVCC_FLAGS, "-o", str(lib), str(csrc / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), lib)
    libs = {}
    for source, (proc, lib) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {csrc / source} failed:\n{text}")
        libs[source] = ctypes.CDLL(str(lib))
    return libs


def launcher(lib, csrc: Path, name: str, ctx, ops, outs):
    """A closure launching `name` from `lib` on fixed operands, its
    arguments taken by the C parameter names."""
    import torch
    from charon_tpu_torch.ops import limb_mxu
    from charon_tpu_torch.ops import mont_kernels as MK

    source, fn_name = KERNELS[name]
    params = c_params(csrc / source, fn_name)
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_void_p if "*" in t else _TYPES[t.removeprefix("const ")] for t, _ in params]
    fn.restype = ctypes.c_int
    rows = ops[0].shape[0]
    g = MK.fp2_geometry(name, rows, MK.sm_count(ops[0].device))
    value = {
        **{k: t.data_ptr() for k, t in zip(("a0", "a1", "b0", "b1"), ops)},
        **{k: t.data_ptr() for k, t in zip(("c0", "c1"), outs)},
        "tables": limb_mxu.device_tables(ctx, ops[0].device).data_ptr(),
        "rows": rows, "elems": g.elems, "threads": g.threads, "grid": g.grid, "smem": g.smem,
        "n_limbs": ctx.n_limbs, "mod_limbs": ctx.limbs.ctypes.data, "pinv": ctx.pinv,
        "stream": torch.cuda.current_stream().cuda_stream,
    }
    args = [value[n] for _, n in params]

    def launch():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{name} ({csrc}) launch failed: {rc}")

    return launch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, type=Path, help="root of the other checkout")
    ap.add_argument("--rows", default="65536,48,24576,6144,384")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    from charon_tpu_torch.ops import mont_kernels as MK

    card = cs.card_line()
    print(card, flush=True)
    versions = {
        "base": args.base.resolve() / "charon_tpu_torch" / "csrc",
        "this": MK.CSRC,
    }
    libs = {v: build(csrc, MK.BUILD_DIR / "ab" / v) for v, csrc in versions.items()}
    results = []
    for name, (source, _) in KERNELS.items():
        plain = MK.fp2_mul_plain if name == "fp2_mul" else MK.fp2_mul_mxu_plain
        for rows in (int(r) for r in args.rows.split(",")):
            ctx, ops = cs._operands(name, rows, 1 + rows, "cuda")
            want = plain(ctx, *ops)
            runs = {}
            for v, csrc in versions.items():
                outs = [torch.empty_like(ops[0]) for _ in range(2)]
                launch = launcher(libs[v][source], csrc, name, ctx, ops, outs)
                launch()
                torch.cuda.synchronize()
                if not all(torch.equal(o, w) for o, w in zip(outs, want)):
                    raise AssertionError(f"{name} ({v}) differs from the plain version at {rows} rows")
                runs[v] = launch
            ms = {"base": [], "this": []}
            for v in ("base", "this", "this", "base"):
                ms[v].append(cs._time_ms(runs[v], 200, queued=True))
            bound, _ = cs._bound_ms(name, rows)
            row = {"kernel": name, "rows": rows, "base_ms": ms["base"], "this_ms": ms["this"], "bound_ms": bound}
            results.append(row)
            print(f"{name} {rows} rows: base {ms['base'][0]:.4f} / {ms['base'][1]:.4f} ms, "
                  f"this {ms['this'][0]:.4f} / {ms['this'][1]:.4f} ms, bound {bound:.4f} ms", flush=True)
    print(json.dumps({"card": card, "ab": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
