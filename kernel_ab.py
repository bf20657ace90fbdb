#!/usr/bin/env python3
"""Time the kernels of two checkouts on one card.

    python3 kernel_ab.py --base DIR [--kernels K,...] [--rows 65536,...]

DIR is another checkout of the repository (for example an earlier commit
unpacked with `git archive`). The script builds, from DIR's
charon_tpu_torch/csrc and from this tree's with nvcc, K1 over Fp and Fr
(`charon_mont_mul`, csrc/mont_mul.cu), K2 and K3 (`charon_fp2_mul`,
`charon_fp2_sqr`, csrc/fp2.cu), K4 over Fp and Fr (`charon_mont_mul_mxu`,
csrc/mont_mxu.cu), K5 and K6 (`charon_fp2_mul_mxu`, `charon_fp2_sqr_mxu`,
csrc/fp2_mxu.cu), holds both versions against this tree's plain version
on the same operands (exactly equal), and times them in turns (base, this,
this, base) with chip_smoke's timer (CUDA events over 200 queued launches
of the C entry point alone). By default each kernel is timed at 65,536
rows and at the four row counts its duty launches it at most often
(chip_smoke.py's rows-per-launch map; K1 Fr and K4 Fr have two); --rows
replaces those for every kernel. Each version's C entry point is called
by its own parameter names, with the launch geometry of its own
ops/mont_kernels.py (none where that gives none: an untiled K1 or K3 of
an earlier tree takes no geometry) and the int8 table block of its own
ops/limb_mxu.py, in the layout its kernels read. Prints the card, one line
per (kernel, rows), then one JSON object.
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

# kernel -> (source, C function, the duty's most frequent row counts)
KERNELS = {
    "mont_mul_fp": ("mont_mul.cu", "charon_mont_mul", (1, 384, 8, 1024)),
    "mont_mul_fr": ("mont_mul.cu", "charon_mont_mul", (4096, 1024)),
    "fp2_mul": ("fp2.cu", "charon_fp2_mul", (48, 24576, 6144, 384)),
    "fp2_sqr": ("fp2.cu", "charon_fp2_sqr", (9, 2048, 8192, 18)),
    "fp2_mul_mxu": ("fp2_mxu.cu", "charon_fp2_mul_mxu", (48, 24576, 6144, 384)),
    "mont_mul_mxu_fp": ("mont_mxu.cu", "charon_mont_mul_mxu", (1, 384, 8, 1024)),
    "mont_mul_mxu_fr": ("mont_mxu.cu", "charon_mont_mul_mxu", (4096, 1024)),
    "fp2_sqr_mxu": ("fp2_mxu.cu", "charon_fp2_sqr_mxu", (9, 2048, 8192, 18)),
}
TIMED_ROWS = 65536
_TYPES = {"int64_t": ctypes.c_int64, "int": ctypes.c_int}


def c_params(source: Path, fn: str) -> list[tuple[str, str]]:
    """(type, name) of each parameter of extern "C" function `fn`."""
    params = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", source.read_text()).group(1)
    out = []
    for p in params.split(","):
        typ, name = " ".join(p.split()).rsplit(" ", 1)
        out.append((typ, name))
    return out


def build(csrc: Path, out_dir: Path, sources) -> dict[str, ctypes.CDLL]:
    """One nvcc per source, all at once, with the port's flags."""
    from charon_tpu_torch.ops import mont_kernels as MK

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for source in sources:
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


def ops_module_of(root: Path, module: str, tag: str):
    """The ops/<module>.py of the checkout at `root`, loaded under its own
    name (limb_mxu and mont_kernels import only this tree's limb and
    limb_mxu modules, whose interfaces they share)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"_{module}_{tag}", root / "charon_tpu_torch" / "ops" / f"{module}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # a dataclass looks its module up while it is made
    spec.loader.exec_module(mod)
    return mod


def launcher(lib, csrc: Path, limb_mxu, mont_kernels, name: str, ctx, ops, outs):
    """A closure launching `name` from `lib` on fixed operands, its
    arguments taken by the C parameter names, its geometry from the
    version's own `mont_kernels`, its tables from its own `limb_mxu`."""
    import torch

    source, fn_name, _ = KERNELS[name]
    params = c_params(csrc / source, fn_name)
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_void_p if "*" in t else _TYPES[t.removeprefix("const ")] for t, _ in params]
    fn.restype = ctypes.c_int
    rows = ops[0].shape[0]
    g = mont_kernels.geometry(name, rows, mont_kernels.sm_count(ops[0].device))
    geom = {} if g is None else {"elems": g.elems, "threads": g.threads, "grid": g.grid, "smem": g.smem}
    names = (("a", "b"), ("out",)) if name.startswith("mont_mul") else (("a0", "a1", "b0", "b1"), ("c0", "c1"))
    value = {
        **{k: t.data_ptr() for k, t in zip(names[0], ops)},
        **{k: t.data_ptr() for k, t in zip(names[1], outs)},
        "tables": limb_mxu.device_tables(ctx, ops[0].device).data_ptr(),
        "rows": rows, **geom,
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
    ap.add_argument("--kernels", default=",".join(KERNELS), help="comma-separated names of KERNELS")
    ap.add_argument("--rows", default=None, help="row counts for every kernel (default: 65,536 and its duty's)")
    args = ap.parse_args(argv)
    names = args.kernels.split(",")
    if not set(names) <= set(KERNELS):
        ap.error(f"--kernels: choose from {', '.join(KERNELS)}")

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    from charon_tpu_torch.ops import mont_kernels as MK

    card = cs.card_line()
    print(card, flush=True)
    roots = {"base": args.base.resolve(), "this": MK.CSRC.parent.parent}
    versions = {v: root / "charon_tpu_torch" / "csrc" for v, root in roots.items()}
    tables = {v: ops_module_of(root, "limb_mxu", v) for v, root in roots.items()}
    geometry = {v: ops_module_of(root, "mont_kernels", v) for v, root in roots.items()}
    sources = sorted({KERNELS[n][0] for n in names})
    libs = {v: build(csrc, MK.BUILD_DIR / "ab" / v, sources) for v, csrc in versions.items()}
    results = []
    for name in names:
        source, _, duty_rows = KERNELS[name]
        plain = getattr(MK, name.removesuffix("_fp").removesuffix("_fr") + "_plain")
        rows_list = [int(r) for r in args.rows.split(",")] if args.rows else [TIMED_ROWS, *duty_rows]
        for rows in rows_list:
            ctx, ops = cs._operands(name, rows, 1 + rows, "cuda")
            want = plain(ctx, *ops)
            want = (want,) if isinstance(want, torch.Tensor) else want
            runs = {}
            for v, csrc in versions.items():
                outs = [torch.empty_like(ops[0]) for _ in want]
                launch = launcher(libs[v][source], csrc, tables[v], geometry[v], name, ctx, ops, outs)
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
