"""PyTorch port: the unfused Fp2 route of fptower.fp2_batch (the
reference's stacked level: Karatsuba sums in one normalize, ONE stacked
Montgomery product, two post levels) behind set_fp2_fusion and the
tuner's fp2_fusion axis.

The JAX package's fp2_batch takes its unfused route on the CPU (Pallas is
inactive there), so it is the direct oracle: the same seeded levels go
through both, mixed mul / sqr / mul_fp, at batch shapes (4,) and (2, 3).
The port's unfused route is also held against its fused route (K2/K3 and
K5/K6 plain versions) with broadcast operands, against the pure-Python
field oracle, through an Fp12 product and a G2 point double, and its
product is checked to be one K1 (K4 under int8) call a level, never
K2/K3/K5/K6. Tolerance: exact.
"""

from __future__ import annotations

import random

import jax
import numpy as np
import pytest
import torch

from charon_tpu.ops import fptower as JT
from charon_tpu.ops import limb as JL
from charon_tpu_torch import convert
from charon_tpu_torch.core.autotune import KernelConfig
from charon_tpu_torch.crypto import fields as F
from charon_tpu_torch.crypto import g1g2
from charon_tpu_torch.ops import curve as C
from charon_tpu_torch.ops import fptower as T
from charon_tpu_torch.ops import limb as L
from charon_tpu_torch.ops import mont_kernels as MK

torch.set_num_threads(1)  # tiny tensors: more intra-op threads only spin

CTX, JCTX = L.FP, JL.FP
P = F.P
EDGES = [(0, 0), (1, 0), (P - 1, P - 1), (0, P - 1), (P - 2, 1)]


@pytest.fixture(autouse=True)
def _default_route():
    yield
    KernelConfig().apply()


def _values(n: int, seed: int) -> list:
    rng = random.Random(seed)
    return (EDGES + [(rng.randrange(P), rng.randrange(P)) for _ in range(n)])[:n] if seed % 2 else [
        (rng.randrange(P), rng.randrange(P)) for _ in range(n)
    ]


def _jax(values, shape):
    """Fp2 values -> the JAX package's pair of Montgomery limb arrays of
    `shape` + (limbs,)."""
    return tuple(np.asarray(x).reshape(*shape, -1) for x in JT.fp2_pack(JCTX, values))


LEVELS = {
    "mixed": lambda a, b, s: [("sqr", a), ("mul", a, b), ("mul_fp", b, s), ("mul", b, a), ("sqr", b)],
    "muls": lambda a, b, s: [("mul", a, b), ("mul", b, b), ("mul", a, a)],
    "sqrs_and_mul_fp": lambda a, b, s: [("sqr", a), ("mul_fp", a, s), ("sqr", b), ("mul_fp", b, s)],
}


@pytest.mark.parametrize("shape", [(4,), (2, 3)])
@pytest.mark.parametrize("level", sorted(LEVELS))
def test_unfused_fp2_batch_equals_the_reference(level, shape):
    """The port's unfused level equals charon_tpu.ops.fptower.fp2_batch
    (unfused on the CPU) limb for limb, and the field oracle."""
    n = int(np.prod(shape))
    va, vb, vs = _values(n, 1), _values(n, 2), _values(n, 3)
    a, b = _jax(va, shape), _jax(vb, shape)
    s = _jax(vs, shape)[0]
    want = jax.jit(lambda x, y, z: JT.fp2_batch(JCTX, LEVELS[level](x, y, z)))(a, b, s)
    port = [convert.point_from_jax(x, "fp") for x in (a, b, s)]
    T.set_fp2_fusion(False)
    got = T.fp2_batch(CTX, LEVELS[level](*port))
    T.set_fp2_fusion(True)
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            assert np.array_equal(convert.limbs_to_jax(x, "fp"), np.asarray(y))
    # the field oracle, lane by lane
    s_vals = [x for x, _ in vs]
    oracle = {
        "sqr": lambda x, *_: F.fp2_sqr(x),
        "mul": lambda x, y: F.fp2_mul(x, y),
        "mul_fp": lambda x, k: F.fp2_mul(x, (k, 0)),
    }
    ops = LEVELS[level]("a", "b", "s")
    lanes = {"a": va, "b": vb, "s": s_vals}
    for op, g in zip(ops, got):
        flat = [x.reshape(-1, CTX.n_limbs) for x in g]
        want_lanes = [oracle[op[0]](*(lanes[name][i] for name in op[1:])) for i in range(n)]
        assert T.fp2_unpack(CTX, tuple(flat)) == want_lanes


@pytest.mark.parametrize("mxu", [False, True])
def test_unfused_equals_fused_with_broadcast_operands(mxu):
    """Unfused against fused on the port (K2/K3 plain versions by default,
    K5/K6 under int8): operands broadcast, a (1,) b against a (4,) a and
    an Fp scalar against a batch."""
    a = T.fp2_pack(CTX, _values(4, 5))
    b = T.fp2_pack(CTX, _values(1, 6))
    s = T.fp2_pack(CTX, _values(1, 7))[0][0]  # one Fp element, no batch axis
    ops = [("mul", a, b), ("sqr", b), ("mul_fp", a, s), ("mul", b, a), ("sqr", a), ("mul_fp", b, a[1])]
    KernelConfig(mxu_mont=mxu).apply()
    fused = T.fp2_batch(CTX, ops)
    KernelConfig(mxu_mont=mxu, fp2_fusion=False).apply()
    unfused = T.fp2_batch(CTX, ops)
    for f, u in zip(fused, unfused):
        for x, y in zip(f, u):
            x, y = torch.broadcast_tensors(x, y)
            assert torch.equal(x, y)


@pytest.mark.parametrize("mxu", [False, True])
def test_unfused_level_is_one_montgomery_product(monkeypatch, mxu):
    """A whole unfused level takes ONE stacked product through K1's
    wrapper (K4's under int8) and never reaches K2/K3/K5/K6; the fused
    level reaches the Fp2 kernels instead."""
    calls = []
    for name in ("mont_mul", "mont_mul_mxu", "fp2_mul", "fp2_sqr", "fp2_mul_mxu", "fp2_sqr_mxu"):
        def spy(*args, _fn=getattr(MK, name), _name=name):
            calls.append(_name)
            return _fn(*args)

        monkeypatch.setattr(MK, name, spy)
    a = T.fp2_pack(CTX, _values(4, 8))
    ops = [("mul", a, a), ("sqr", a), ("mul_fp", a, a[0]), ("sqr", a)]
    KernelConfig(mxu_mont=mxu, fp2_fusion=False).apply()
    T.fp2_batch(CTX, ops)
    assert calls == ["mont_mul_mxu" if mxu else "mont_mul"]
    calls.clear()
    KernelConfig(mxu_mont=mxu).apply()
    T.fp2_batch(CTX, ops)
    suffix = "_mxu" if mxu else ""
    assert calls == [f"fp2_mul{suffix}", f"fp2_sqr{suffix}", f"mont_mul{suffix}"]


def test_kernel_config_routes_fp2_fusion_and_flips_back():
    """KernelConfig(fp2_fusion=False).apply() turns the unfused route on
    instead of raising; the default config turns it off again."""
    assert T._FP2_FUSION is True
    assert KernelConfig(fp2_fusion=False).apply() is True
    assert T._FP2_FUSION is False
    KernelConfig().apply()
    assert T._FP2_FUSION is True


def test_unfused_route_through_the_tower_and_the_curve():
    """An Fp12 product and a G2 point double (levels of fp2_batch calls all
    the way down) give the same limbs on both routes, and the oracle's."""
    rng = random.Random(9)
    f12 = [tuple(tuple((rng.randrange(P), rng.randrange(P)) for _ in range(3)) for _ in range(2)) for _ in range(2)]
    x, y = T.fp12_pack(CTX, f12), T.fp12_pack(CTX, f12[::-1])
    g2f = C.g2_ops(CTX)
    pts = [g1g2.g2_mul(g1g2.G2_GEN, k) for k in (3, 11)]
    proj = C.affine_to_point(g2f, C.g2_pack(CTX, pts, "cpu"))
    outs = {}
    for fusion in (True, False):
        KernelConfig(fp2_fusion=fusion).apply()
        outs[fusion] = (T.fp12_mul(CTX, x, y), C.point_to_affine(g2f, C.point_double(g2f, proj)))
    fused, unfused = [], []
    C.map_point(fused.append, outs[True])
    C.map_point(unfused.append, outs[False])
    assert len(fused) == len(unfused) and all(torch.equal(p, q) for p, q in zip(fused, unfused))
    assert T.fp12_unpack(CTX, outs[False][0]) == [F.fp12_mul(p, q) for p, q in zip(f12, f12[::-1])]
    assert C.g2_unpack(CTX, outs[False][1]) == [g1g2.g2_add(p, p) for p in pts]
