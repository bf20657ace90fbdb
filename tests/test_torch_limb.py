"""PyTorch port: limb engine, K1 (Montgomery product), convert.py, and the
port's import boundary.

K1's plain version (the path a CPU tensor takes) is held exactly against
the JAX package's limb.mont_mul on XLA:CPU and against the TPU kernel
itself, mont_mul_pallas in interpret mode; the CUDA kernels against their
plain versions are in tests/test_torch_cuda.py (marker `cuda`).
"""

from __future__ import annotations

import ast
import functools
import os
import pathlib
import random
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from charon_tpu.ops import limb as JL
from charon_tpu.ops.pallas_mont import mont_mul_pallas
from charon_tpu_torch import convert
from charon_tpu_torch.ops import limb as L
from charon_tpu_torch.ops import mont_kernels as MK

torch.set_num_threads(1)  # tiny tensors: more intra-op threads only spin

ROOT = pathlib.Path(__file__).resolve().parent.parent
CTXS = {"fp": (L.FP, JL.FP, JL.FP32), "fr": (L.FR, JL.FR, JL.FR32)}


def _values(ctx, n, seed):
    """Edge values (0, 1, m-1, m-2, R mod m, m//2) then seeded randoms."""
    m = ctx.modulus
    rng = random.Random(seed)
    edge = [0, 1, m - 1, m - 2, ctx.r_mont, m // 2]
    return edge + [rng.randrange(m) for _ in range(n - len(edge))]


def _port_modules():
    pkg = ROOT / "charon_tpu_torch"
    return sorted(
        "charon_tpu_torch." + ".".join(p.relative_to(pkg).with_suffix("").parts)
        for p in pkg.rglob("*.py")
        if p.name != "__init__.py"
    )


# -- import boundary ---------------------------------------------------------


def test_port_imports_without_jax_or_reference_package():
    """Every module of the port, chip_smoke, kernel_ab and plane_ab import with jax
    and charon_tpu made unimportable."""
    mods = _port_modules() + ["charon_tpu_torch", "chip_smoke", "kernel_ab", "plane_ab"]
    assert {"charon_tpu_torch.cmd.cli", "charon_tpu_torch.app.run"} <= set(mods)  # the node binary
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['charon_tpu'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' and sys.modules[m] is not None"
        " or m.startswith(('jax.', 'charon_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('IMPORT-OK')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "IMPORT-OK" in out.stdout


def test_port_sources_name_no_jax_or_reference_import():
    files = sorted((ROOT / "charon_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "kernel_ab.py", ROOT / "plane_ab.py"]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "charon_tpu"):
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} {name}")
    assert not bad, bad


# -- K1: Montgomery product ---------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_mont_mul(name):
    return jax.jit(functools.partial(JL.mont_mul, CTXS[name][1]))


@pytest.mark.parametrize("name", ["fp", "fr"])
def test_k1_plain_matches_jax_limb_engine(name):
    """More than 256 rows (one TPU tile) of edge and random values; the
    port's int64 limbs equal the JAX CPU geometry's uint64 limbs element
    for element."""
    ctx, jctx, _ = CTXS[name]
    va, vb = _values(ctx, 300, 1), _values(ctx, 300, 2)[::-1]
    a, b = JL.pack_mont_host(jctx, va), JL.pack_mont_host(jctx, vb)
    want = np.asarray(_jax_mont_mul(name)(jnp.asarray(a), jnp.asarray(b)))
    got = MK.mont_mul(ctx, convert.limbs_from_jax(a, name), convert.limbs_from_jax(b, name))
    assert np.array_equal(convert.limbs_to_jax(got, name), want)
    assert L.unpack_mont_host(ctx, got) == [x * y % ctx.modulus for x, y in zip(va, vb)]


@pytest.mark.parametrize("name", ["fp", "fr"])
def test_k1_plain_matches_pallas_kernel_interpret(name):
    """The TPU kernel itself (12-bit uint32 geometry, interpret mode) on the
    same Montgomery values, converted through convert.py: 300 rows, so two
    256-row TPU tiles, edge values first."""
    ctx, _, jctx32 = CTXS[name]
    va, vb = _values(ctx, 300, 3), _values(ctx, 300, 4)[::-1]
    a32, b32 = JL.pack_mont_host(jctx32, va), JL.pack_mont_host(jctx32, vb)
    want = np.asarray(mont_mul_pallas(jctx32, jnp.asarray(a32), jnp.asarray(b32), interpret=True))
    got = MK.mont_mul(ctx, convert.limbs_from_jax(a32, name + "32"), convert.limbs_from_jax(b32, name + "32"))
    assert np.array_equal(convert.limbs_to_jax(got, name + "32"), want)


# -- K1-K3's 32-bit Fp product (csrc/mont_field.cuh mont_mul32), transcribed --

W32 = 1 << 32
M32 = W32 - 1


def _limbs_to_words(x):
    """16 24-bit limbs (rows, 16) -> 12 32-bit words (rows, 12) of the same
    integer: limbs 4g..4g+3 make words 3g..3g+2 (limbs_to_words)."""
    x = x.astype(np.uint64)
    w = np.empty(x.shape[:-1] + (12,), np.uint64)
    for g in range(4):
        l0, l1, l2, l3 = (x[..., 4 * g + k] for k in range(4))
        w[..., 3 * g] = (l0 | l1 << 24) & M32
        w[..., 3 * g + 1] = (l1 >> 8 | l2 << 16) & M32
        w[..., 3 * g + 2] = (l2 >> 16 | l3 << 8) & M32
    return w


def _words_to_limbs(w):
    x = np.empty(w.shape[:-1] + (16,), np.int64)
    mask = np.uint64(0xFFFFFF)
    for g in range(4):
        w0, w1, w2 = (w[..., 3 * g + k] for k in range(3))
        x[..., 4 * g] = w0 & mask
        x[..., 4 * g + 1] = (w0 >> 24 | w1 << 8) & mask
        x[..., 4 * g + 2] = (w1 >> 16 | w2 << 16) & mask
        x[..., 4 * g + 3] = w2 >> 8
    return x


def _pinv32(p0):
    """-p^-1 mod 2^32 as make_modulus computes it: Newton's iteration from
    p0, which is its own inverse mod 2^3."""
    inv = p0
    for _ in range(4):
        inv = inv * (2 - p0 * inv) % W32
    return -inv % W32


def _mont_mul32(a, b, p):
    """The kernels' 12-word CIOS with no carry word above the top one, on
    numpy uint64 (every multiply-add of two 32-bit addends fits 64 bits),
    asserting its bounds: the top word's two carries never carry out, and
    t stays below 2p after every step."""
    x, y = _limbs_to_words(a), _limbs_to_words(b)
    pw = [np.uint64((p >> (32 * j)) & M32) for j in range(12)]
    assert int(pw[11]) < (1 << 31) - 1  # the no-carry condition
    pinv = np.uint64(_pinv32(int(pw[0])))
    t = np.zeros_like(x)
    sh, m32 = np.uint64(32), np.uint64(M32)
    for i in range(12):
        s = x[:, 0] * y[:, i] + t[:, 0]
        A = s >> sh
        q = ((s & m32) * pinv) & m32
        C = (q * pw[0] + (s & m32)) >> sh
        for j in range(1, 12):
            s = x[:, j] * y[:, i] + t[:, j] + A
            A = s >> sh
            c = q * pw[j] + (s & m32) + C
            C = c >> sh
            t[:, j - 1] = c & m32
        assert ((A + C) >> sh == 0).all()
        t[:, 11] = A + C
        assert all(_words_int(row) < 2 * p for row in t)
    # one conditional subtraction
    d, borrow = np.empty_like(t), np.zeros(len(t), np.uint64)
    for j in range(12):
        v = t[:, j] - pw[j] - borrow  # wraps mod 2^64 where it borrows
        d[:, j] = v & m32
        borrow = v >> np.uint64(63)
    return _words_to_limbs(np.where(borrow[:, None] == 1, t, d))


def _words_int(row):
    return sum(int(w) << (32 * j) for j, w in enumerate(row))


def test_k1_fp_32bit_words_and_pinv():
    """The regrouping is the same integer both ways, and the Newton inverse
    is -p^-1 mod 2^32; BLS12-381's top word of p is 0x1a0111ea."""
    ctx = L.FP
    vals = _values(ctx, 40, 9) + [(1 << 384) - 1]
    limbs = np.array([L.int_to_limbs(v, 16) for v in vals])
    words = _limbs_to_words(limbs)
    assert [_words_int(w) for w in words] == vals
    assert np.array_equal(_words_to_limbs(words), limbs)
    p = ctx.modulus
    assert _pinv32(p % W32) == -pow(p, -1, W32) % W32
    assert p >> 352 == 0x1A0111EA


def test_k1_fp_32bit_product_matches_plain_and_pallas_interpret():
    """The transcription on edge values (0, 1, p - 1, p - 2, R mod p, p // 2
    in every pairing) and seeded ones equals mont_mul_plain and the TPU
    kernel, mont_mul_pallas in interpret mode, limb for limb."""
    ctx, _, jctx32 = CTXS["fp"]
    edge = _values(ctx, 6, 0)
    va = [x for x in edge for _ in edge] + _values(ctx, 300, 11)[6:]
    vb = [y for _ in edge for y in edge] + _values(ctx, 300, 12)[6:][::-1]
    a, b = L.pack_mont_host(ctx, va), L.pack_mont_host(ctx, vb)
    got = _mont_mul32(a, b, ctx.modulus)
    assert np.array_equal(got, MK.mont_mul_plain(ctx, torch.as_tensor(a), torch.as_tensor(b)).numpy())
    assert L.unpack_mont_host(ctx, torch.as_tensor(got)) == [x * y % ctx.modulus for x, y in zip(va, vb)]
    a32 = convert.limbs_to_jax(torch.as_tensor(a), "fp32")
    b32 = convert.limbs_to_jax(torch.as_tensor(b), "fp32")
    want = np.asarray(mont_mul_pallas(jctx32, jnp.asarray(a32), jnp.asarray(b32), interpret=True))
    assert np.array_equal(convert.limbs_to_jax(torch.as_tensor(got), "fp32"), want)


def test_k1_wrapper_broadcasts_batch_dims():
    ctx = L.FP
    a = torch.as_tensor(L.pack_mont_host(ctx, _values(ctx, 6, 5))).reshape(2, 3, 16)
    b = torch.as_tensor(L.pack_mont_host(ctx, [7]))[0]
    got = MK.mont_mul(ctx, a, b)
    assert got.shape == (2, 3, 16)
    assert L.unpack_mont_host(ctx, got) == [x * 7 % ctx.modulus for x in _values(ctx, 6, 5)]


@pytest.mark.parametrize(
    "kernel", ["mont_mul", "fp2_mul", "fp2_sqr", "mont_mul_mxu", "fp2_mul_mxu", "fp2_sqr_mxu"]
)
def test_wrappers_raise_off_cpu_without_fallback(kernel):
    """A tensor that is not on the CPU never takes the plain version: off
    a CUDA device the wrapper refuses instead of computing anything."""
    x = torch.zeros(4, 16, dtype=torch.int64, device="meta")
    before = dict(MK.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        if kernel.startswith("mont_mul"):
            getattr(MK, kernel)(L.FP, x, x)
        elif kernel.startswith("fp2_mul"):
            getattr(MK, kernel)(L.FP, (x, x), (x, x))
        else:
            getattr(MK, kernel)(L.FP, (x, x))
    assert MK.LAUNCHES == before


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(MK, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        MK.build(force=True)


# -- limb engine --------------------------------------------------------------


@pytest.mark.parametrize("name", ["fp", "fr"])
def test_addsub_inv_match_jax_and_oracle(name):
    ctx, jctx, _ = CTXS[name]
    m = ctx.modulus
    va, vb = _values(ctx, 40, 8), _values(ctx, 40, 9)[::-1]
    a, b = L.pack_mont_host(ctx, va), L.pack_mont_host(ctx, vb)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    [s], [d] = L.addsub_mod_many(ctx, [(ta, tb)], [(ta, tb)])
    ja, jb = jnp.asarray(a.astype(np.uint64)), jnp.asarray(b.astype(np.uint64))
    assert np.array_equal(convert.limbs_to_jax(s, name), np.asarray(JL.add_mod(jctx, ja, jb)))
    assert np.array_equal(convert.limbs_to_jax(d, name), np.asarray(JL.sub_mod(jctx, ja, jb)))
    assert L.unpack_mont_host(ctx, L.neg_mod(ctx, ta)) == [-x % m for x in va]
    inv = L.inv_mod(ctx, ta[:8])
    assert L.unpack_mont_host(ctx, inv) == [pow(x, -1, m) if x else 0 for x in va[:8]]
    assert L.unpack_mont_host(ctx, L.mont_pow(ctx, ta[:8], 5)) == [pow(x, 5, m) for x in va[:8]]


@pytest.mark.parametrize("name", ["fp", "fr"])
def test_to_from_mont_round_trip(name):
    ctx = CTXS[name][0]
    vals = _values(ctx, 12, 10)
    raw = torch.as_tensor(L.ctx_pack(ctx, vals))
    mont = L.to_mont(ctx, raw)
    assert torch.equal(mont, torch.as_tensor(L.pack_mont_host(ctx, vals)))
    assert torch.equal(L.from_mont(ctx, mont), raw)


def test_bytes_to_limbs_matches_int_packing():
    rng = random.Random(11)
    vals = [rng.randrange(L.FP.modulus) for _ in range(9)]
    data = b"".join(v.to_bytes(48, "big") for v in vals)
    assert np.array_equal(L.bytes_to_limbs_batch(data, 16, item_bytes=48), L.pack(vals, 16))
    assert L.unpack(L.pack(vals, 16)) == vals


# -- convert.py ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["fp", "fr", "fp32", "fr32"])
def test_convert_round_trips_every_jax_geometry(name):
    jctx = {"fp": JL.FP, "fr": JL.FR, "fp32": JL.FP32, "fr32": JL.FR32}[name]
    vals = _values(L.FP if name.startswith("fp") else L.FR, 10, 12)
    arr = JL.pack_mont_host(jctx, vals)
    t = convert.limbs_from_jax(arr, name)
    assert t.dtype == torch.int64 and t.shape[-1] == (16 if name.startswith("fp") else 11)
    back = convert.limbs_to_jax(t, name)
    assert back.dtype == arr.dtype and np.array_equal(back, arr)
    port_ctx = L.FP if name.startswith("fp") else L.FR
    assert L.unpack_mont_host(port_ctx, t) == [v % port_ctx.modulus for v in vals]


def test_convert_points_and_bad_geometry():
    from charon_tpu.crypto import g1g2
    from charon_tpu.ops import curve as JC

    pts = [g1g2.G2_GEN, None]
    packed = JC.g2_pack(JL.FP32, pts)
    t = convert.point_from_jax(jax.tree_util.tree_map(np.asarray, packed), "fp32")
    from charon_tpu_torch.ops import curve as C

    assert C.g2_unpack(L.FP, t) == pts
    back = convert.point_to_jax(t, "fp32")
    assert all(np.array_equal(x, np.asarray(y)) for x, y in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(packed)))
    with pytest.raises(ValueError):
        convert.limbs_from_jax(np.zeros((2, 16), np.uint64), "fp64")
    with pytest.raises(ValueError):
        convert.limbs_from_jax(np.zeros((2, 11), np.uint64), "fp")
