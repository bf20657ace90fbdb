"""Hand-written CUDA kernels K1-K6 for Hopper: wrappers, plain versions,
launch counts, and the nvcc build.

The counterpart of charon_tpu/ops/pallas_mont.py. Each TPU kernel there
has one kernel here, written in CUDA C++ for sm_90a (charon_tpu_torch/csrc):

  K1 mont_mul (Fp and Fr)      <- mont_mul_pallas             (csrc/mont_mul.cu)
  K2 fp2_mul                   <- fp2_mul_pallas              (csrc/fp2.cu)
  K3 fp2_sqr                   <- fp2_sqr_pallas              (csrc/fp2.cu)
  K4 mont_mul_mxu (Fp and Fr)  <- mont_mul_pallas(mxu=True)   (csrc/mont_mxu.cu)
  K5 fp2_mul_mxu               <- fp2_mul_pallas(mxu=True)    (csrc/fp2_mxu.cu)
  K6 fp2_sqr_mxu               <- fp2_sqr_pallas(mxu=True)    (csrc/fp2_mxu.cu)

K4-K6 run the two constant convolutions of every Montgomery product on the
int8 tensor cores (ops/limb_mxu.py); limb.set_mxu, owned by
core/autotune.KernelConfig, routes the products to them.

Every kernel is tiled (csrc/tile.cuh): operands fetched into shared
memory a tile at a time, one Montgomery product a thread, persistent
blocks. mont_geometry (K1, K4) and fp2_geometry (K2, K3, K5, K6) compute
the launch geometry from the row count and the card's SM count, and the
wrapper passes it to the C entry point, which checks it. K1-K3 share one
CUDA-core product for Fp on 32-bit words (csrc/mont_field.cuh), K4-K6 one
int8 tensor-core product (csrc/mont_mxu.cuh); K3 and K6 one two-role
square, K2 and K5 one three-role multiply (csrc/tile.cuh).

Beside each wrapper is its plain PyTorch version: the int64 limb algorithm
of limb.mont_mul (K4: limb_mxu.mont_mul_mxu) and the Fp2 formulas. A
wrapper takes the plain version only for a tensor that lies on the CPU; for
a CUDA tensor it launches the kernel or raises — there is no fallback. Every launch adds one to its
kernel's entry in LAUNCHES, so a run can show which kernels it went
through.

Build: every csrc/*.cu compiles with nvcc into its own shared library with
a plain C interface (loaded with ctypes), all sources at once, at the first
launch or by calling build(). Libraries land in charon_tpu_torch/_build,
named by a digest of their sources and flags, so a changed source is
rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from charon_tpu_torch.ops import limb, limb_mxu
from charon_tpu_torch.ops.limb import ModCtx

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_PTR, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# After the operand pointers (and, for K4-K6, the int8 piece tables on the
# device): rows, the geometry (elements a tile, threads, grid, dynamic
# shared bytes), n_limbs, modulus limbs (host), pinv, stream.
_TAIL = [_I64] + [_INT] * 4 + [_INT, _PTR, _I64, _PTR]
# source file -> {exported kernel function: its C signature}
_SOURCES = {
    "mont_mul.cu": {"charon_mont_mul": [_PTR] * 3 + _TAIL},
    "fp2.cu": {"charon_fp2_mul": [_PTR] * 6 + _TAIL, "charon_fp2_sqr": [_PTR] * 4 + _TAIL},
    "mont_mxu.cu": {"charon_mont_mul_mxu": [_PTR] * 4 + _TAIL},
    "fp2_mxu.cu": {"charon_fp2_mul_mxu": [_PTR] * 7 + _TAIL, "charon_fp2_sqr_mxu": [_PTR] * 5 + _TAIL},
}

# The kernels' constants, mirrored from csrc: Fp2 elements a tile of K2,
# K3, K5, K6 (tile.cuh kTileElems) and their roles (threads a tile over
# TILE_ELEMS); K1's and K4's tile, a warp's rows for a launch of at most a
# warp's rows (tile.cuh kWarpRows), else MONT_TILE_ROWS (mont_mul.cu
# kMontTileRows, mont_mxu.cu kMontMxuThreads); blocks resident on an SM
# (the second argument of each kernel's __launch_bounds__).
TILE_ELEMS = 32
WARP_ROWS = 32
MONT_TILE_ROWS = {"mont_mul_fp": 32, "mont_mul_fr": 32, "mont_mul_mxu_fp": 128, "mont_mul_mxu_fr": 128}
# K1 takes a launch of at most a warp's rows straight into registers
_UNSTAGED = ("mont_mul_fp", "mont_mul_fr")
_ROLES = {"fp2_mul": 3, "fp2_sqr": 2, "fp2_mul_mxu": 3, "fp2_sqr_mxu": 2}
_RESIDENT = {
    "mont_mul_fp": 8, "mont_mul_fr": 8, "fp2_mul": 4, "fp2_sqr": 8,
    "mont_mul_mxu_fp": 3, "mont_mul_mxu_fr": 3, "fp2_mul_mxu": 4, "fp2_sqr_mxu": 6,
}


def _tile_smem(n: int, elems: int, ins: int, outs: int, prods: int = 0, conv: int = 0) -> int:
    """sizeof a tiled kernel's shared struct: the staged operand rows (an
    even limb count padded by two int64 words), the product and output
    limb planes of 32-bit words (elems + 1 a plane), and for the int8
    kernels, 32-byte aligned after them, mont_mxu.cuh's MxuConv of `conv`
    rows: 16-byte piece rows, one 32-column pass of column sums at a
    stride of conv + 4 words, and the 6,144-byte table block."""
    row = n + 2 if n % 2 == 0 else n
    size = -(-(ins * elems * row * 8 + (outs + prods) * n * (elems + 1) * 4) // 16) * 16
    if conv:
        size = -(-size // 32) * 32 + 2 * 2 * conv * 16 + 32 * (conv + 4) * 4 + 6144
    return size


# (kernel, elements a tile) -> dynamic shared bytes a block
_SMEM = {
    **{(f"mont_mul_{name}", MONT_TILE_ROWS[f"mont_mul_{name}"]): _tile_smem(n, MONT_TILE_ROWS[f"mont_mul_{name}"], 2, 1)
       for name, n in (("fp", 16), ("fr", 11))},
    ("fp2_mul", TILE_ELEMS): _tile_smem(16, TILE_ELEMS, 4, 2, prods=3),
    ("fp2_sqr", TILE_ELEMS): _tile_smem(16, TILE_ELEMS, 2, 2),
    ("fp2_mul_mxu", TILE_ELEMS): _tile_smem(16, TILE_ELEMS, 4, 2, prods=3, conv=3 * TILE_ELEMS),
    ("fp2_sqr_mxu", TILE_ELEMS): _tile_smem(16, TILE_ELEMS, 2, 2, conv=2 * TILE_ELEMS),
    **{(f"mont_mul_mxu_{name}", e): _tile_smem(n, e, 2, 1, conv=e)
       for name, n in (("fp", 16), ("fr", 11)) for e in (WARP_ROWS, MONT_TILE_ROWS[f"mont_mul_mxu_{name}"])},
}


@dataclass(frozen=True)
class Geometry:
    """A tiled launch: block b takes tiles b, b + grid, b + 2 grid, ...;
    tile t is rows [t elems, min(rows, (t + 1) elems))."""

    rows: int
    elems: int  # elements a tile
    threads: int  # a block's threads: one Montgomery product each
    grid: int  # blocks
    smem: int  # dynamic shared bytes a block


def fp2_geometry(kernel: str, rows: int, sm_count: int) -> Geometry:
    """The launch of Fp2 kernel `kernel` (K2, K3, K5, K6: "fp2_mul",
    "fp2_sqr", "fp2_mul_mxu", "fp2_sqr_mxu") over rows > 0 on a card of
    sm_count SMs: one block a tile up to the blocks the card holds at once,
    then that many persistent blocks, so a large launch runs in whole waves
    and the int8 kernels load their tables once a block."""
    tiles = -(-rows // TILE_ELEMS)
    grid = min(tiles, sm_count * _RESIDENT[kernel])
    return Geometry(rows, TILE_ELEMS, _ROLES[kernel] * TILE_ELEMS, grid, _SMEM[kernel, TILE_ELEMS])


def mont_geometry(kernel: str, rows: int, sm_count: int) -> Geometry:
    """The launch of K1 or K4 (`kernel` "mont_mul_fp", "mont_mul_fr",
    "mont_mul_mxu_fp" or "mont_mul_mxu_fr") over rows > 0: one one-warp
    block for at most a warp's rows, so a launch of 1-32 rows runs no dead
    warps (through K4's table copy; K1 stages nothing there and takes no
    shared memory); above that, tiles of the kernel's MONT_TILE_ROWS rows
    (K1: a warp's, K4: 128), one block a tile up to the blocks the card
    holds at once, then that many persistent blocks."""
    if rows <= WARP_ROWS and kernel in _UNSTAGED:
        return Geometry(rows, WARP_ROWS, WARP_ROWS, 1, 0)
    elems = WARP_ROWS if rows <= WARP_ROWS else MONT_TILE_ROWS[kernel]
    tiles = -(-rows // elems)
    grid = min(tiles, sm_count * _RESIDENT[kernel])
    return Geometry(rows, elems, elems, grid, _SMEM[kernel, elems])


def geometry(kernel: str, rows: int, sm_count: int) -> Geometry:
    """The launch of `kernel` (a LAUNCHES name)."""
    if kernel in _ROLES:
        return fp2_geometry(kernel, rows, sm_count)
    return mont_geometry(kernel, rows, sm_count)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count

# Launches per kernel since the last reset_launches(), per kernel the
# launches at each row count ({rows: launches}), and the operands _aligned
# copied because they started off a 16-byte word.
LAUNCHES = {
    "mont_mul_fp": 0, "mont_mul_fr": 0, "fp2_mul": 0, "fp2_sqr": 0,
    "mont_mul_mxu_fp": 0, "mont_mul_mxu_fr": 0, "fp2_mul_mxu": 0, "fp2_sqr_mxu": 0,
}
ROWS: dict[str, dict[int, int]] = {name: {} for name in LAUNCHES}
ALIGN_COPIES = dict.fromkeys(LAUNCHES, 0)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        ROWS[name].clear()
        ALIGN_COPIES[name] = 0


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc (default /usr/local/cuda),
    else nvcc on PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to a CUDA toolkit")
    return found


def _lib_path(source: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(dep.read_bytes())
    return BUILD_DIR / f"lib{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> dict[str, str]:
    """Compile every kernel source, one nvcc process per source, all
    started together. Returns {source: nvcc's report} (register, shared
    memory and spill counts from -Xptxas -v); "cached" for a library that
    was already built from the same sources."""
    nvcc = None
    procs = {}
    reports = {}
    for source in _SOURCES:
        out = _lib_path(source)
        if out.exists() and not force:
            reports[source] = "cached"
            continue
        if nvcc is None:
            nvcc = nvcc_path()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        procs[source] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    failed = []
    for source, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        reports[source] = text
        if proc.returncode != 0:
            failed.append(f"{source} (nvcc exit {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return reports


_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}


def library(source: str) -> ctypes.CDLL:
    """The loaded shared library of one kernel source (built on first use),
    with its C signatures declared."""
    with _LOCK:
        lib = _LOADED.get(source)
        if lib is None:
            path = _lib_path(source)
            if not path.exists():
                build()
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in _SOURCES[source].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            err = getattr(lib, f"charon_{Path(source).stem}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _LOADED[source] = lib
        return lib


def _launch(source: str, fn: str, ctx: ModCtx, kernel: str, tensors, tables: bool = False) -> None:
    """Check the CUDA operands (inputs then outputs, one shape), launch on
    the current stream with the kernel's geometry, and raise on a refused
    launch. `tables` passes the int8 piece tables of ctx on the operands'
    device (K4-K6)."""
    ref = tensors[0]
    for t in tensors:
        if t.device != ref.device or t.device.type != "cuda":
            raise ValueError(f"{kernel}: operands must share one CUDA device")
        if t.dtype != limb.DTYPE:
            raise TypeError(f"{kernel}: limbs must be int64, got {t.dtype}")
        if t.shape != ref.shape or t.shape[-1] != ctx.n_limbs:
            raise ValueError(f"{kernel}: bad operand shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: operands must be contiguous")
    rows = ref.numel() // ctx.n_limbs
    if rows == 0:
        return
    lib = library(source)
    extra = (limb_mxu.device_tables(ctx, ref.device).data_ptr(),) if tables else ()
    g = geometry(kernel, rows, sm_count(ref.device))
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream(ref.device).cuda_stream
        rc = getattr(lib, fn)(
            *(t.data_ptr() for t in tensors), *extra, rows, g.elems, g.threads, g.grid, g.smem, ctx.n_limbs,
            ctx.limbs.ctypes.data, ctx.pinv, stream,
        )
    if rc != 0:
        msg = getattr(lib, f"charon_{Path(source).stem}_error_string")(rc)
        raise RuntimeError(f"{kernel} launch failed: {msg.decode()} ({rc})")
    LAUNCHES[kernel] += 1
    ROWS[kernel][rows] = ROWS[kernel].get(rows, 0) + 1


def _aligned(kernel: str, tensors):
    """Contiguous operands, and a copy of any view that starts off a 16-byte
    word (the tiles move in 16-byte words), counted in ALIGN_COPIES."""
    out = []
    for x in tensors:
        x = x.contiguous()
        if x.data_ptr() % 16:
            x = x.clone()
            ALIGN_COPIES[kernel] += 1
        out.append(x)
    return out


def _operands(tensors):
    """Broadcast operands to one shape on one device."""
    tensors = torch.broadcast_tensors(*tensors)
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("operands lie on different devices")
    return tensors, dev.type == "cpu"


# ---------------------------------------------------------------------------
# K1: Montgomery product
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _band(n: int, out_cols: int, device: torch.device):
    """idx[i, k] = k - i clipped into range, valid[i, k] = 0 <= k-i < n:
    the schoolbook product as one gather + broadcast-multiply + sum."""
    i = np.arange(n)[:, None]
    k = np.arange(out_cols)[None, :]
    j = k - i
    valid = (j >= 0) & (j < n)
    idx = np.where(valid, j, 0)
    return (
        torch.as_tensor(idx, dtype=torch.long, device=device),
        torch.as_tensor(valid, device=device),
    )


@functools.lru_cache(maxsize=None)
def _const_band(ctx: ModCtx, what: str, out_cols: int, device: torch.device):
    """Banded matrix B[i, k] = c[k - i] of a constant operand c."""
    idx, valid = _band(ctx.n_limbs, out_cols, device)
    c = limb.ctx_const(ctx, what, device)
    return torch.where(valid, c[idx], 0)


def _conv(ctx: ModCtx, a, b, out_cols: int):
    """t[..., k] = sum_{i+j=k} a_i * b_j over out_cols columns, as a
    broadcast multiply and a sum (CUDA has no int64 matmul)."""
    idx, valid = _band(ctx.n_limbs, out_cols, a.device)
    b_shift = torch.where(valid, b[..., idx], 0)  # (..., n, out_cols)
    return (a.unsqueeze(-1) * b_shift).sum(-2)


def _conv_const(ctx: ModCtx, a, what: str, out_cols: int):
    band = _const_band(ctx, what, out_cols, a.device)
    return (a.unsqueeze(-1) * band).sum(-2)


def mont_mul_plain(ctx: ModCtx, a, b):
    """a * b * R^-1 mod m, the separated-operand algorithm of the JAX
    package's limb.mont_mul, step for step:

        t = a * b                      (conv, 2n columns)
        m = (t mod R) * (-m^-1 mod R)  (low conv, n columns)
        s = t + m * p                  (conv + add; s = 0 mod R)
        result = s / R  (high half)    (< 2m, one conditional subtract,
                                        fused into the last normalize)
    """
    n = ctx.n_limbs
    t = _conv(ctx, a, b, 2 * n)
    t, _ = limb._normalize(ctx, t)
    m = _conv_const(ctx, t[..., :n], "ninv", n)
    m, _ = limb._normalize(ctx, m)  # mod R: top carry intentionally dropped
    s = t + _conv_const(ctx, m, "p", 2 * n)
    return _mont_tail(ctx, s)


def _mont_tail(ctx: ModCtx, s):
    """s = 0 mod R in accumulator range -> the reduced high half s / R,
    with the conditional subtract fused into the last normalize: the twin
    lane adds (R - m) into the high columns, and its carry says s/R >= m."""
    n = ctx.n_limbs
    rm_hi = limb.ctx_const(ctx, "r_minus_m_hi", s.device)
    out, carry = limb._normalize(ctx, torch.stack([s, s + rm_hi]))
    return torch.where((carry[1] == 1).unsqueeze(-1), out[1, ..., n:], out[0, ..., n:])


def _mont_kernel(source: str, fn: str, kernel: str, plain, ctx: ModCtx, a, b, tables: bool):
    """One Montgomery-product launch over broadcast operands: the plain
    version on the CPU, else the kernel writing a fresh output."""
    (a, b), on_cpu = _operands((a, b))
    if on_cpu:
        return plain(ctx, a, b)
    if not limb.has_kernel_instance(ctx):
        raise ValueError(f"{kernel} has no instance for {ctx.name}")
    name = f"{kernel}_{ctx.name}"
    a, b = _aligned(name, (a, b))
    out = torch.empty_like(a)
    _launch(source, fn, ctx, name, (a, b, out), tables=tables)
    return out


def mont_mul(ctx: ModCtx, a, b):
    """a * b * R^-1 mod m for reduced Montgomery-form limb tensors (K1)."""
    return _mont_kernel("mont_mul.cu", "charon_mont_mul", "mont_mul", mont_mul_plain, ctx, a, b, False)


# ---------------------------------------------------------------------------
# K4: Montgomery product with the constant convolutions on int8 tensor cores
# ---------------------------------------------------------------------------

mont_mul_mxu_plain = limb_mxu.mont_mul_mxu


def mont_mul_mxu(ctx: ModCtx, a, b):
    """a * b * R^-1 mod m for reduced Montgomery-form limb tensors (K4)."""
    return _mont_kernel("mont_mxu.cu", "charon_mont_mul_mxu", "mont_mul_mxu", mont_mul_mxu_plain, ctx, a, b, True)


# ---------------------------------------------------------------------------
# K2 / K3 and K5 / K6: fused Fp2 multiply and square
# ---------------------------------------------------------------------------


def _fp2_mul_math(ctx: ModCtx, mont, a0, a1, b0, b1):
    """Karatsuba: c0 = a0 b0 - a1 b1, c1 = (a0 + a1)(b0 + b1) - (a0 b0 +
    a1 b1), with `mont` the Montgomery product's plain version."""
    ta, tb = limb.add_mod_many(ctx, [(a0, a1), (b0, b1)])
    v0, v1, s = mont(ctx, torch.stack([a0, a1, ta]), torch.stack([b0, b1, tb]))
    v01 = limb.add_mod(ctx, v0, v1)
    c0, c1 = limb.sub_mod_many(ctx, [(v0, v1), (s, v01)])
    return c0, c1


def _fp2_sqr_math(ctx: ModCtx, mont, a0, a1):
    """c0 = (a0 + a1)(a0 - a1), c1 = 2 a0 a1."""
    [ta], [ts] = limb.addsub_mod_many(ctx, [(a0, a1)], [(a0, a1)])
    c0, w = mont(ctx, torch.stack([ta, a0]), torch.stack([ts, a1]))
    return c0, limb.add_mod(ctx, w, w)


def fp2_mul_plain(ctx: ModCtx, a0, a1, b0, b1):
    """Plain version of K2."""
    return _fp2_mul_math(ctx, mont_mul_plain, a0, a1, b0, b1)


def fp2_sqr_plain(ctx: ModCtx, a0, a1):
    """Plain version of K3."""
    return _fp2_sqr_math(ctx, mont_mul_plain, a0, a1)


def fp2_mul_mxu_plain(ctx: ModCtx, a0, a1, b0, b1):
    """Plain version of K5: K2's formula over K4's product."""
    return _fp2_mul_math(ctx, mont_mul_mxu_plain, a0, a1, b0, b1)


def fp2_sqr_mxu_plain(ctx: ModCtx, a0, a1):
    """Plain version of K6: K3's formula over K4's product."""
    return _fp2_sqr_math(ctx, mont_mul_mxu_plain, a0, a1)


def _check_fp2_ctx(ctx: ModCtx, kernel: str) -> None:
    if ctx.limb_bits != limb.LIMB_BITS or ctx.n_limbs != 16:
        raise ValueError(f"{kernel} has no instance for {ctx.name}")


def _fp2_kernel(source: str, fn: str, kernel: str, plain, ctx: ModCtx, operands, tables: bool):
    """One fused Fp2 launch over broadcast operands: the plain version on
    the CPU, else the kernel writing two fresh outputs."""
    operands, on_cpu = _operands(operands)
    if on_cpu:
        return plain(ctx, *operands)
    _check_fp2_ctx(ctx, kernel)
    ins = _aligned(kernel, operands)
    c0, c1 = torch.empty_like(ins[0]), torch.empty_like(ins[0])
    _launch(source, fn, ctx, kernel, (*ins, c0, c1), tables=tables)
    return c0, c1


def fp2_mul(ctx: ModCtx, a, b):
    """Fused Fp2 product of (c0, c1) limb-tensor pairs (K2)."""
    return _fp2_kernel("fp2.cu", "charon_fp2_mul", "fp2_mul", fp2_mul_plain, ctx, (*a, *b), False)


def fp2_sqr(ctx: ModCtx, a):
    """Fused Fp2 square of a (c0, c1) limb-tensor pair (K3)."""
    return _fp2_kernel("fp2.cu", "charon_fp2_sqr", "fp2_sqr", fp2_sqr_plain, ctx, tuple(a), False)


def fp2_mul_mxu(ctx: ModCtx, a, b):
    """Fused Fp2 product with int8 tensor-core Montgomery products (K5)."""
    return _fp2_kernel("fp2_mxu.cu", "charon_fp2_mul_mxu", "fp2_mul_mxu", fp2_mul_mxu_plain, ctx, (*a, *b), True)


def fp2_sqr_mxu(ctx: ModCtx, a):
    """Fused Fp2 square with int8 tensor-core Montgomery products (K6)."""
    return _fp2_kernel("fp2_mxu.cu", "charon_fp2_sqr_mxu", "fp2_sqr_mxu", fp2_sqr_mxu_plain, ctx, tuple(a), True)
