"""PyTorch port: device point decode (ops/decompress.py), the static ladder
and the engine's decompress_g*_batch, held against the JAX package (XLA:CPU,
exact integers) and the host oracle g1g2.g*_from_bytes.

The JAX engine's decode programs run at the 4-lane bucket only (the
batteries go through it four lanes a call), so the file pays one compile
for each program it compares with."""

from __future__ import annotations

import dataclasses
import functools
import random

import jax
import numpy as np
import pytest
import torch
from test_decompress import _g1_battery, _g1_on_curve_not_in_subgroup, _g2_battery, _g2_on_curve_not_in_subgroup

from charon_tpu.crypto import fields as F
from charon_tpu.crypto import g1g2
from charon_tpu.ops import blsops as JB
from charon_tpu.ops import curve as JC
from charon_tpu.ops import decompress as JDEC
from charon_tpu.ops import fptower as JT
from charon_tpu.ops import limb as JL
from charon_tpu_torch import convert
from charon_tpu_torch.ops import curve as C
from charon_tpu_torch.ops import decompress as DEC
from charon_tpu_torch.ops import fptower as TW
from charon_tpu_torch.ops import limb as L
from charon_tpu_torch.ops.blsops import BlsEngine

torch.set_num_threads(1)  # tiny tensors: more intra-op threads only spin

CTX, JCTX = L.FP, JL.FP
P = F.P


def _to_port(jax_tree):
    return convert.point_from_jax(jax.tree_util.tree_map(np.asarray, jax_tree), "fp")


def _equal(port_tree, jax_tree):
    a = jax.tree_util.tree_leaves(convert.point_to_jax(port_tree, "fp"))
    b = [np.asarray(x) for x in jax.tree_util.tree_leaves(jax_tree)]
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def _mask(t):
    return [bool(b) for b in t.tolist()]


def _fp2s(n, seed):
    rng = random.Random(seed)
    edge = [(0, 0), (1, 0), (0, 1), (P - 1, P - 1), (5, 0)]
    return (edge + [(rng.randrange(P), rng.randrange(P)) for _ in range(n)])[:n]


def _rand_g2(rng):
    return g1g2.g2_mul_raw(g1g2.G2_GEN, rng.randrange(1, F.R))


def _rand_g1(rng):
    return g1g2.g1_mul_raw(g1g2.G1_GEN, rng.randrange(1, F.R))


@functools.lru_cache(maxsize=None)
def _batteries():
    return _g2_battery(), _g1_battery()


def _oracle(decode, data, subgroup=True):
    try:
        return True, decode(bytes(data), subgroup_check=subgroup)
    except ValueError:
        return False, None


# -- host parse ------------------------------------------------------------------


def _fields(p):
    return dataclasses.astuple(p)


def test_parse_lanes_equal_the_reference_field_by_field():
    g2, g1 = _batteries()
    for label, enc in g2:
        assert _fields(DEC.parse_g2_lane(enc)) == _fields(JDEC.parse_g2_lane(enc)), label
    for label, enc in g1:
        assert _fields(DEC.parse_g1_lane(enc)) == _fields(JDEC.parse_g1_lane(enc)), label
    rng = random.Random(11)
    for _ in range(300):
        blob = bytes(rng.randrange(256) for _ in range(rng.choice((0, 1, 47, 48, 95, 96, 97))))
        if blob and rng.random() < 0.5:
            blob = bytes([blob[0] | 0x80]) + blob[1:]  # reach past the flag check
        assert _fields(DEC.parse_g2_lane(blob)) == _fields(JDEC.parse_g2_lane(blob))
        assert _fields(DEC.parse_g1_lane(blob)) == _fields(JDEC.parse_g1_lane(blob))


def test_pack_parsed_equals_the_reference():
    g2, g1 = _batteries()
    parsed = [DEC.parse_g2_lane(enc) for _, enc in g2]
    want = JDEC.pack_parsed_g2(JCTX, [JDEC.parse_g2_lane(enc) for _, enc in g2])
    got = DEC.pack_parsed_g2(CTX, parsed)
    assert _equal(got[:2], want[:2])
    assert all(_mask(g) == np.asarray(w).tolist() for g, w in zip(got[2:], want[2:]))
    parsed = [DEC.parse_g1_lane(enc) for _, enc in g1]
    want = JDEC.pack_parsed_g1(JCTX, [JDEC.parse_g1_lane(enc) for _, enc in g1])
    got = DEC.pack_parsed_g1(CTX, parsed)
    assert _equal(got[0], want[0])
    assert all(_mask(g) == np.asarray(w).tolist() for g, w in zip(got[1:], want[1:]))


# -- device pieces against the jitted JAX functions ------------------------------


def test_fp2_pow_const_sqrt_chain_equals_jax():
    xs = _fp2s(6, 1)
    ja = JT.fp2_pack(JCTX, xs)
    want = jax.jit(lambda a: JDEC.fp2_pow_const(JCTX, a, JDEC.SQRT_EXP_G2))(ja)
    got = DEC.fp2_pow_const(CTX, _to_port(ja), DEC.SQRT_EXP_G2)
    assert _equal(got, want)
    assert TW.fp2_unpack(CTX, got) == [F.fp2_pow(x, DEC.SQRT_EXP_G2) for x in xs]


def test_lex_largest_and_psi_equal_jax():
    xs, ys = _fp2s(6, 2), _fp2s(6, 3)[::-1]
    ja, jb = JT.fp2_pack(JCTX, xs), JT.fp2_pack(JCTX, ys)
    want = jax.jit(lambda a: JDEC.fp2_is_lex_largest_graph(JCTX, a))(ja)
    got = DEC.fp2_is_lex_largest_graph(CTX, _to_port(ja))
    assert _mask(got) == np.asarray(want).tolist() == [F.fp2_is_lex_largest(x) for x in xs]
    want = jax.jit(lambda a, b: JDEC.g2_psi_graph(JCTX, (a, b)))(ja, jb)
    got = DEC.g2_psi_graph(CTX, (_to_port(ja), _to_port(jb)))
    assert _equal(got, want)


def test_static_ladder_equals_the_bit_schedule_ladder():
    """point_mul_static and point_scalar_mul give one group element (affine
    forms equal) for the psi check's scalar, on both curves and the
    identity (the G1 check's scalar is held through the phi graph below)."""
    rng = random.Random(4)
    for f, pack, unpack, pts in (
        (C.g2_ops(CTX), C.g2_pack, C.g2_unpack, [_rand_g2(rng), None, _rand_g2(rng), g1g2.G2_GEN]),
        (C.g1_ops(CTX), C.g1_pack, C.g1_unpack, [_rand_g1(rng), None, _rand_g1(rng), g1g2.G1_GEN]),
    ):
        k = F.X_ABS
        proj = C.affine_to_point(f, pack(CTX, pts))
        ks = C.fr_pack(L.FR, [k] * len(pts))
        want = C.point_to_affine(f, C.point_scalar_mul(f, L.FR, proj, ks, nbits=k.bit_length()))
        got = C.point_to_affine(f, C.point_mul_static(f, proj, k))
        assert unpack(CTX, got) == unpack(CTX, want)
    with pytest.raises(ValueError):
        C.point_mul_static(f, proj, 0)


def test_subgroup_graphs_equal_jax_and_the_oracle():
    rng = random.Random(5)
    g2 = [_rand_g2(rng), _g2_on_curve_not_in_subgroup(), None, _rand_g2(rng), _g2_on_curve_not_in_subgroup()]
    ja = JC.g2_pack(JCTX, g2)
    want = jax.jit(lambda a: JDEC.g2_subgroup_psi_graph(JCTX, JL.FR, a))(ja)
    got = DEC.g2_subgroup_psi_graph(CTX, _to_port(ja))
    assert _mask(got) == np.asarray(want).tolist() == [True, False, True, True, False]
    g1 = [_rand_g1(rng), _g1_on_curve_not_in_subgroup(), _rand_g1(rng), _g1_on_curve_not_in_subgroup()]
    ja = JC.g1_pack(JCTX, g1)
    want = jax.jit(lambda a: JDEC.g1_subgroup_phi_graph(JCTX, JL.FR, a))(ja)
    got = DEC.g1_subgroup_phi_graph(CTX, _to_port(ja))
    assert _mask(got) == np.asarray(want).tolist() == [True, False, True, False]


# -- the engine calls against the JAX engine and the oracle -----------------------


def _jax_engine_in_fours(call, encs):
    """The JAX engine's answer lane by lane, four lanes a call (its 4-lane
    program, compiled once)."""
    pts, valid = [], []
    for i in range(0, len(encs), 4):
        p, v = call(encs[i : i + 4])
        pts += p
        valid += v
    return pts, valid


@pytest.mark.parametrize("group", ["g2", "g1"])
def test_decompress_batch_equals_the_jax_engine_and_the_oracle(group):
    g2, g1 = _batteries()
    battery, decode = (g2, g1g2.g2_from_bytes) if group == "g2" else (g1, g1g2.g1_from_bytes)
    encs = [enc for _, enc in battery]
    eng = BlsEngine("cpu")
    call = eng.decompress_g2_batch if group == "g2" else eng.decompress_g1_batch
    jcall = getattr(JB.default_engine(), f"decompress_{group}_batch")
    pts, valid = call(encs)
    assert (pts, valid) == _jax_engine_in_fours(jcall, encs)
    for (label, enc), pt, ok in zip(battery, pts, valid):
        want_ok, want_pt = _oracle(decode, enc)
        assert ok == want_ok, f"{label}: mask mismatch"
        assert pt == want_pt, f"{label}: point mismatch"
    # without the subgroup check the torsion lane decodes, the rest as before
    pts, valid = call(encs, subgroup_check=False)
    for (label, enc), pt, ok in zip(battery, pts, valid):
        assert (ok, pt) == _oracle(decode, enc, subgroup=False), label
    assert valid[[label for label, _ in battery].index("non-subgroup")]


def test_decompress_batch_takes_parsed_lanes_and_pads_with_lane_0():
    g2, _ = _batteries()
    encs = [enc for _, enc in g2][:5]
    eng = BlsEngine("cpu")
    assert eng.decompress_g2_batch([DEC.parse_g2_lane(e) for e in encs]) == eng.decompress_g2_batch(encs)
    assert eng.decompress_g2_batch([]) == ([], [])
