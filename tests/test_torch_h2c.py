"""PyTorch port: device hash-to-curve (ops/sswu.py) and the engine's
hash_to_g2_batch, held against the JAX package (XLA:CPU, exact integers),
the crypto/h2c.py oracle and the RFC 9380 appendix J.10.1 vectors."""

from __future__ import annotations

import dataclasses
import random

import jax
import numpy as np
import pytest
import torch
from test_sswu import RFC_DST, RFC_VECTORS

from charon_tpu.crypto import fields as F
from charon_tpu.crypto import g1g2, h2c
from charon_tpu.ops import curve as JC
from charon_tpu.ops import fptower as JT
from charon_tpu.ops import limb as JL
from charon_tpu.ops import sswu as JSSWU
from charon_tpu_torch import convert
from charon_tpu_torch.ops import curve as C
from charon_tpu_torch.ops import fptower as TW
from charon_tpu_torch.ops import limb as L
from charon_tpu_torch.ops import sswu as SSWU
from charon_tpu_torch.ops.blsops import BlsEngine

torch.set_num_threads(1)  # tiny tensors: more intra-op threads only spin

CTX, JCTX = L.FP, JL.FP
P = F.P
POP_MSGS = [b"\x00" * 32, b"duty-root-1", b"duty-root-2"]


def _to_port(jax_tree):
    return convert.point_from_jax(jax.tree_util.tree_map(np.asarray, jax_tree), "fp")


def _equal(port_tree, jax_tree):
    a = jax.tree_util.tree_leaves(convert.point_to_jax(port_tree, "fp"))
    b = [np.asarray(x) for x in jax.tree_util.tree_leaves(jax_tree)]
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def _mask(t):
    return [bool(b) for b in t.tolist()]


def _us():
    """hash_to_field outputs of a few messages, plus u = 0 (the exceptional
    SSWU case) and edge values of sgn0."""
    us = [u for m in (b"", b"abc", b"duty") for u in h2c.hash_to_field_fp2(m, 2)]
    return us + [(0, 0), (0, 1), (P - 1, 0)]


def test_hash_to_field_lane_equals_the_reference():
    for msg in (b"", b"abc", b"\x00" * 32, b"duty-root"):
        for dst in (RFC_DST, h2c.DST_POP):
            got = SSWU.hash_to_field_lane(msg, dst)
            assert dataclasses.astuple(got) == dataclasses.astuple(JSSWU.hash_to_field_lane(msg, dst))
    assert SSWU.hash_to_field_lane(b"abc") == SSWU.hash_to_field_lane(b"abc", SSWU.DST_POP)


def test_pack_hashed_equals_the_reference():
    msgs = [b"", b"abc", b"duty"]
    got = SSWU.pack_hashed(CTX, [SSWU.hash_to_field_lane(m) for m in msgs])
    want = JSSWU.pack_hashed(JCTX, [JSSWU.hash_to_field_lane(m) for m in msgs])
    assert _equal(got[:4], want[:4])
    assert all(_mask(g) == np.asarray(w).tolist() for g, w in zip(got[4:], want[4:]))


def test_sgn0_equals_jax_and_the_oracle():
    us = _us()
    ja = JT.fp2_pack(JCTX, us)
    want = jax.jit(lambda a: JSSWU.fp2_sgn0_graph(JCTX, a))(ja)
    got = SSWU.fp2_sgn0_graph(CTX, _to_port(ja))
    assert _mask(got) == np.asarray(want).tolist() == [bool(F.fp2_sgn0(u)) for u in us]


def test_sswu_and_iso_map_equal_jax_and_the_oracle():
    us = _us()
    ja = JT.fp2_pack(JCTX, us)
    sgn = np.asarray([bool(F.fp2_sgn0(u)) for u in us])
    (wx, wy), wok = jax.jit(lambda a, s: JSSWU.sswu_graph(JCTX, a, s))(ja, sgn)
    (gx, gy), gok = SSWU.sswu_graph(CTX, _to_port(ja), torch.as_tensor(sgn))
    assert _equal((gx, gy), (wx, wy))
    assert _mask(gok) == np.asarray(wok).tolist() == [True] * len(us)
    assert list(zip(TW.fp2_unpack(CTX, gx), TW.fp2_unpack(CTX, gy))) == [h2c.sswu_fp2(u) for u in us]
    want = jax.jit(lambda x, y: JSSWU.iso_map_graph(JCTX, (x, y)))(wx, wy)
    got = SSWU.iso_map_graph(CTX, (gx, gy))
    assert _equal(got, want)
    assert C.g2_unpack(CTX, got) == [h2c.map_to_curve_g2(u) for u in us]


def test_clear_cofactor_psi_equals_jax_and_the_oracle():
    """Both sides' projective outputs are compared in affine form: the port's
    static ladders reach the same points in another representation."""
    rng = random.Random(7)
    pts = [h2c.map_to_curve_g2((rng.randrange(P), rng.randrange(P))) for _ in range(3)] + [None]
    jf = JC.g2_ops(JCTX)
    want = jax.jit(
        lambda a: JC.point_to_affine(jf, JSSWU.clear_cofactor_psi_graph(JCTX, JL.FR, JC.affine_to_point(jf, a)))
    )(JC.g2_pack(JCTX, pts))
    f = C.g2_ops(CTX)
    got = C.point_to_affine(f, SSWU.clear_cofactor_psi_graph(CTX, C.affine_to_point(f, C.g2_pack(CTX, pts))))
    assert _equal(got, want)
    assert C.g2_unpack(CTX, got) == [g1g2.g2_clear_cofactor_psi(p) for p in pts]


def test_hash_to_g2_batch_reproduces_the_rfc_vectors_and_the_oracle():
    """One batch of pre-hashed lanes under two DSTs: the five RFC points and
    the oracle on POP-DST roots; then raw messages hashed in the engine."""
    eng = BlsEngine("cpu")
    lanes = [SSWU.hash_to_field_lane(msg, RFC_DST) for msg, _, _ in RFC_VECTORS]
    lanes += [SSWU.hash_to_field_lane(m) for m in POP_MSGS]
    pts, valid = eng.hash_to_g2_batch(lanes)
    assert valid == [True] * len(lanes)
    assert pts[: len(RFC_VECTORS)] == [(x, y) for _, x, y in RFC_VECTORS]
    assert pts[len(RFC_VECTORS):] == [h2c.hash_to_g2(m) for m in POP_MSGS]
    msgs = [b"rot-%d" % i for i in range(3)]
    assert eng.hash_to_g2_batch(msgs) == ([h2c.hash_to_g2(m) for m in msgs], [True] * 3)
    assert eng.hash_to_g2_batch([]) == ([], [])


_JAX_ENGINE_SCRIPT = """
from test_sswu import RFC_DST, RFC_VECTORS
from test_torch_h2c import POP_MSGS
from charon_tpu.ops import blsops, sswu as jsswu
from charon_tpu_torch.ops import sswu
from charon_tpu_torch.ops.blsops import BlsEngine

msgs = [m for m, _, _ in RFC_VECTORS]
want = blsops.default_engine().hash_to_g2_batch([jsswu.hash_to_field_lane(m, RFC_DST) for m in msgs] + POP_MSGS)
got = BlsEngine("cpu").hash_to_g2_batch([sswu.hash_to_field_lane(m, RFC_DST) for m in msgs] + POP_MSGS)
assert got == want, "port != JAX engine"
print("TORCH-H2C-OK")
"""


@pytest.mark.slow
def test_hash_to_g2_batch_equals_the_jax_engine():
    """The whole device hash_to_g2 program against the JAX engine's, lane by
    lane. A fresh process, as tests/test_sswu.py runs that compile."""
    from isolation_util import ISOLATED_HEADER, run_isolated

    run_isolated(ISOLATED_HEADER + _JAX_ENGINE_SCRIPT, "TORCH-H2C-OK", timeout=3000)
