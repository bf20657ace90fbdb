"""PyTorch port: K2/K3 (fused Fp2 multiply and square), the Fp2/Fp6/Fp12
tower and the G1/G2 curve ops, held exactly against the JAX package on
XLA:CPU and its pure-Python specification (charon_tpu/crypto), at a batch
of 4."""

from __future__ import annotations

import functools
import random

import jax
import numpy as np
import pytest
import torch

from charon_tpu.crypto import fields as F
from charon_tpu.crypto import g1g2
from charon_tpu.ops import curve as JC
from charon_tpu.ops import fptower as JT
from charon_tpu.ops import limb as JL
from charon_tpu_torch import convert
from charon_tpu_torch.ops import curve as C
from charon_tpu_torch.ops import fptower as T
from charon_tpu_torch.ops import limb as L
from charon_tpu_torch.ops import mont_kernels as MK

torch.set_num_threads(1)  # tiny tensors: more intra-op threads only spin

CTX, JCTX = L.FP, JL.FP
P = F.P


def _fp2s(n, seed):
    rng = random.Random(seed)
    m = [(0, 0), (1, 0), (P - 1, P - 1), (0, P - 1)]
    return (m + [(rng.randrange(P), rng.randrange(P)) for _ in range(n)])[:n]


def _fp12s(n, seed):
    rng = random.Random(seed)
    return [
        tuple(tuple((rng.randrange(P), rng.randrange(P)) for _ in range(3)) for _ in range(2))
        for _ in range(n)
    ]


def _unitary(f):
    """f^((p^6 - 1)(p^2 + 1)): the cyclotomic subgroup the hard part of the
    final exponentiation works in."""
    f = F.fp12_mul(F.fp12_conj(f), F.fp12_inv(f))
    return F.fp12_mul(F.fp12_frobenius_n(f, 2), f)


def _to_port(jax_tree):
    return convert.point_from_jax(jax.tree_util.tree_map(np.asarray, jax_tree), "fp")


def _equal(port_tree, jax_tree):
    a = jax.tree_util.tree_leaves(convert.point_to_jax(port_tree, "fp"))
    b = [np.asarray(x) for x in jax.tree_util.tree_leaves(jax_tree)]
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


@functools.lru_cache(maxsize=None)
def _jit(fn):
    return jax.jit(functools.partial(fn, JCTX))


# -- K2 / K3 plain versions ----------------------------------------------------


def test_k2_plain_matches_jax_fp2_mul_and_oracle():
    xs, ys = _fp2s(4, 1), _fp2s(4, 2)[::-1]
    ja, jb = JT.fp2_pack(JCTX, xs), JT.fp2_pack(JCTX, ys)
    want = _jit(JT.fp2_mul)(ja, jb)
    got = MK.fp2_mul_plain(CTX, *_to_port(ja), *_to_port(jb))
    assert _equal(got, want)
    assert T.fp2_unpack(CTX, got) == [F.fp2_mul(x, y) for x, y in zip(xs, ys)]


def test_k3_plain_matches_jax_fp2_sqr_and_oracle():
    xs = _fp2s(4, 3)
    ja = JT.fp2_pack(JCTX, xs)
    want = _jit(JT.fp2_sqr)(ja)
    got = MK.fp2_sqr_plain(CTX, *_to_port(ja))
    assert _equal(got, want)
    assert T.fp2_unpack(CTX, got) == [F.fp2_sqr(x) for x in xs]


def test_fp2_batch_mixed_kinds_match_jax():
    """fp2_batch stacks each kind into one K1/K2/K3 call and restores the
    caller's order."""
    a, b, s = _fp2s(4, 4), _fp2s(4, 5), _fp2s(4, 6)
    ja, jb, js = JT.fp2_pack(JCTX, a), JT.fp2_pack(JCTX, b), JT.fp2_pack(JCTX, s)[0]

    def ops(pa, pb, ps):
        return [("sqr", pa), ("mul", pa, pb), ("mul_fp", pb, ps), ("mul", pb, pa), ("sqr", pb)]

    want = jax.jit(lambda x, y, z: JT.fp2_batch(JCTX, ops(x, y, z)))(ja, jb, js)
    got = T.fp2_batch(CTX, ops(_to_port(ja), _to_port(jb), _to_port(js)))
    assert _equal(got, want)


def test_fp2_inv_matches_oracle():
    xs = _fp2s(4, 7)
    got = T.fp2_inv(CTX, T.fp2_pack(CTX, xs))
    assert T.fp2_unpack(CTX, got) == [F.fp2_inv(x) if x != (0, 0) else (0, 0) for x in xs]


# -- Fp12 -----------------------------------------------------------------------


@pytest.mark.parametrize("op", ["mul", "sqr", "frobenius", "cyclotomic_sqr"])
def test_fp12_ops_match_jax_and_oracle(op):
    xs = _fp12s(4, 8)
    if op == "cyclotomic_sqr":
        xs = [_unitary(x) for x in xs]
    ys = _fp12s(4, 9)
    ja, jb = JT.fp12_pack(JCTX, xs), JT.fp12_pack(JCTX, ys)
    pa, pb = _to_port(ja), _to_port(jb)
    if op == "mul":
        want, got = _jit(JT.fp12_mul)(ja, jb), T.fp12_mul(CTX, pa, pb)
        oracle = [F.fp12_mul(x, y) for x, y in zip(xs, ys)]
    elif op == "sqr":  # the reference's fp12_sqr is fp12_mul(a, a): share its program
        want, got = _jit(JT.fp12_mul)(ja, ja), T.fp12_sqr(CTX, pa)
        oracle = [F.fp12_sqr(x) for x in xs]
    elif op == "frobenius":
        want, got = _jit(JT.fp12_frobenius)(ja), T.fp12_frobenius(CTX, pa)
        oracle = [F.fp12_frobenius(x) for x in xs]
    else:
        want, got = _jit(JT.fp12_cyclotomic_sqr)(ja), T.fp12_cyclotomic_sqr(CTX, pa)
        oracle = [F.fp12_sqr(x) for x in xs]
    assert _equal(got, want)
    assert T.fp12_unpack(CTX, got) == oracle


def test_fp12_inv_conj_is_one_match_oracle():
    xs = _fp12s(3, 10)
    pa = T.fp12_pack(CTX, xs)
    assert T.fp12_unpack(CTX, T.fp12_inv(CTX, pa)) == [F.fp12_inv(x) for x in xs]
    assert T.fp12_unpack(CTX, T.fp12_conj(CTX, pa)) == [F.fp12_conj(x) for x in xs]
    one = T.fp12_pack(CTX, [F.FP12_ONE, xs[0]])
    assert T.fp12_is_one(CTX, one).tolist() == [True, False]


# -- G1 / G2 --------------------------------------------------------------------


def _points(group, n, seed):
    rng = random.Random(seed)
    if group == "g1":
        pts = [g1g2.g1_mul(g1g2.G1_GEN, rng.randrange(1, F.R)) for _ in range(n - 1)]
    else:
        pts = [g1g2.g2_mul(g1g2.G2_GEN, rng.randrange(1, F.R)) for _ in range(n - 1)]
    return pts + [None]


def _group(group):
    if group == "g1":
        return C.g1_ops(CTX), JC.g1_ops(JCTX), C.g1_pack, JC.g1_pack, C.g1_unpack, g1g2.g1_add, g1g2.g1_mul
    return C.g2_ops(CTX), JC.g2_ops(JCTX), C.g2_pack, JC.g2_pack, C.g2_unpack, g1g2.g2_add, g1g2.g2_mul


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("op", ["add", "double"])
def test_point_ops_match_jax_and_oracle(group, op):
    """Complete projective add/double: the projective limbs equal the JAX
    package's (same formulas), the affine results the oracle's — identity
    and doubling-through-add lanes included."""
    f, jf, pack, jpack, unpack, add, _ = _group(group)
    ps, qs = _points(group, 4, 11), _points(group, 4, 12)
    qs[1] = ps[1]  # P + P through the addition formula
    jp = JC.affine_to_point(jf, jpack(JCTX, ps))
    jq = JC.affine_to_point(jf, jpack(JCTX, qs))
    pp, pq = _to_port(jp), _to_port(jq)
    if op == "add":
        want = jax.jit(lambda a, b: JC.point_add(jf, a, b))(jp, jq)
        got = C.point_add(f, pp, pq)
        oracle = [add(p, q) for p, q in zip(ps, qs)]
    else:
        want = jax.jit(lambda a: JC.point_double(jf, a))(jp)
        got = C.point_double(f, pp)
        oracle = [add(p, p) for p in ps]
    assert _equal(got, want)
    assert unpack(CTX, C.point_to_affine(f, got)) == oracle


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_point_scalar_mul_and_sum_match_jax_and_oracle(group):
    """32-bit double-and-add: projective limbs equal the JAX package's,
    affine results the oracle's; then a fold over the batch axis."""
    f, jf, pack, jpack, unpack, add, mul = _group(group)
    ps = _points(group, 4, 13)
    rng = random.Random(14)
    ks = [rng.randrange(1 << 32) for _ in range(3)] + [0]
    jproj = JC.affine_to_point(jf, jpack(JCTX, ps))
    jks = JC.fr_pack(JL.FR, ks)
    want_proj = jax.jit(lambda q, k: JC.point_scalar_mul(jf, JL.FR, q, k, nbits=32))(jproj, jks)
    proj = _to_port(jproj)
    got = C.point_scalar_mul(f, L.FR, proj, convert.limbs_from_jax(jks, "fr"), nbits=32)
    assert _equal(got, want_proj)
    want = [None if p is None or k == 0 else mul(p, k) for p, k in zip(ps, ks)]
    assert unpack(CTX, C.point_to_affine(f, got)) == want
    total = C.point_sum(f, C.map_point(lambda a: a.reshape(1, 4, a.shape[-1]), proj), axis=-1)
    oracle = None
    for p in ps:
        oracle = add(oracle, p)
    assert unpack(CTX, C.point_to_affine(f, total)) == [oracle]


def test_fp2_batch_routes_cpu_tensors_to_plain_versions():
    """On CPU tensors no kernel launches: the wrappers compute the plain
    versions, and the launch counts stay put."""
    before = dict(MK.LAUNCHES)
    a = T.fp2_pack(CTX, _fp2s(4, 15))
    T.fp2_batch(CTX, [("mul", a, a), ("sqr", a), ("mul_fp", a, a[0])])
    assert MK.LAUNCHES == before
    assert a[0].device == torch.device("cpu")
    # JAX and port agree that the packs are the same Montgomery limbs
    assert np.array_equal(convert.limbs_to_jax(a[0], "fp"), np.asarray(JT.fp2_pack(JCTX, _fp2s(4, 15))[0]))
